"""Delta-lobe vertex gradients: RR branch flips + direction-sweep edges.

Dielectric and perfect-mirror vertices scatter along DETERMINISTIC
directions (delta lobes), so the lobe-density edge sampling of
ops/silhouette.py does not apply there; this module supplies the two
gradient terms such vertices carry, both estimated with the same
vertex-walk machinery (the integrator's own bounce step, the attached
final hop) and both invisible to interior AD:

1. The RUSSIAN-ROULETTE BRANCH-FLIP term (dielectric only), and
2. the DIRECTION-SWEEP edge term: the reflected/refracted continuation
   direction w(theta) moves with ior (Snell) and with geometry (the
   attached hit normal/vertex), sweeping across scene silhouettes --
   every crossing flips the continuation radiance. Measured on the
   simple scene's glass sphere this sweep term is the DOMINANT part of
   the true ior gradient.

The reference's dielectric decides reflect vs refract by Russian roulette
on the Schlick probability (raytracer.hxx:182-191, cuda_impl.cu:252-259):
``scattered = ru < p_reflect ? reflected : refracted``. Interior AD at
fixed RNG differentiates the radiance of the TAKEN branch only -- the
dependence of the DECISION on theta is invisible (the select is piecewise
constant in the uniform draw) -- yet the expected pixel value
I = E[p L_reflect + (1 - p) L_refract] carries

    dI/dtheta  (superset)  E[ dp/dtheta * (L_reflect - L_refract) ].

Measured on the simple scene's glass sphere this term is ~99% of the true
ior gradient: interior AD reports +0.0007 where central finite
differences give +0.066 +- 0.002 (spp 64, eps 0.01-0.02, 3 FD keys).

``branch_probability_surrogate`` estimates it with the same vertex
machinery as the edge-sampled boundary terms (ops/silhouette.py): one
jittered path vertex per batch pixel walked with the integrator's own
bounce step, the Schlick probability evaluated ATTACHED (ior via the
material gather; geometry via the attached final-hop normal), and both
branch continuations probed with common random numbers on the detached
scene. The surrogate scalar's gradient is the estimator; its value is
irrelevant (callers add ``s - stop_gradient(s)`` to the loss).

The TIR set boundary needs special care and turns out to DOMINATE on
glass with internal transport: as ior moves, the total-internal-
reflection cone sweeps the population of internal-bounce incidence
angles, and every crossing flips p from schlick(<1) to 1 -- a delta
term in the expected gradient (measured: the smooth-schlick part alone
is ~ -0.013 on the simple scene's glass where FD says +0.066). The
surrogate estimates it by KERNEL SMOOTHING the step *inside the
surrogate only* (the forward render is untouched): with
k = 1 - ri^2 (1 - cos^2) the refraction discriminant (TIR <=> k < 0),

    p_surrogate = schlick + (1 - schlick) * sigmoid(-k / h)

whose ior/geometry gradient spreads the crossing delta over a width-h
band of vertices (consistent as h -> 0; O(h) bias from probing L at the
band's actual directions, O(1/h) variance -- h defaults to 0.02,
validated against FD on the glass configs). TIR-band lanes probe the
refract branch along the grazing k=0 direction (the physical limit), so
no NaNs enter.

The DIRECTION-SWEEP term uses the same kernel idea on the direction
sphere: for each delta branch w(theta) (reflect: weight p; refract:
weight 1-p; a mirror metal's reflect: weight 1), the branch is first
FOLLOWED through the deterministic dielectric chain -- refracting at
every dielectric interface with the ATTACHED Snell map, falling back to
the (also deterministic) internal reflection under TIR, accumulating
the renderer's probability of that arm -- until it reaches air:
straight-line edge geometry is only valid there (from inside glass the
hollow sphere acts as a lens and even INVERTS the image; evaluated
naively the term came out sign-flipped). On the final air segment the
nearest sphere-silhouette cone edge is found (g = angle(w, axis_j) -
beta_j, analytic like ops/silhouette.py), the radiance jump across that
edge is probed with a common-random-number pair straddling the cone at
the point nearest w, and the crossing delta is kernel-smoothed over a
width-h angular band:

    surrogate -= detach(cot . thru (f_in - f_out) K_h(g) p_branch) * g(theta)

with g(theta) attached through w(theta) (normal + ior), the candidate
sphere's center/radius, AND the vertex y(theta) -- so occluder motion,
receiver motion, Snell bending, and normal rotation all flow. Vertices
on materials with non-delta lobes contribute exactly zero here (their
edge term lives in ops/silhouette.py -- disjoint by material, no double
counting).

INTERNAL-RR REFLECTION ARMS (round 3): at every internal dielectric
interface the renderer Russian-roulettes between refracting onward
(probability 1-p, the chain's main line) and reflecting back inside
(probability p = schlick). The refract chain alone misses the
reflection arms' sweep crossings entirely -- measured 47% of the true
occluder-radius gradient on a glass sphere whose internally-reflected
exits see a black occluder placed behind the camera
(tests/test_branchprob.py::
test_internal_rr_reflection_arm_matches_finite_differences). With
``chain_rr_arms=K``, the first K interfaces of each main chain spawn
their dropped reflection arm as a SIDE CHAIN (own deterministic
refract walk to air, no further side arms -- second order), each
contributing the same final-air-segment edge term weighted by
prob_before * schlick; the measured estimate lands within 2.5% of FD.
Deeper vertex_depth walks whose draws actually TAKE an internal
reflection are sweep-suppressed via prefix_delta, so arms never double
count.

PREFIX-HOP MOTION (round 4): the vertex walk runs on the ATTACHED
scene (matching silhouette.secondary_boundary_surrogate), so at
vertex_depth >= 1 the arrival direction d(theta) carries the
prefix-motion channel of dp/dtheta -- a mirror steering the view onto
glass contributes the incidence-angle dependence of Schlick/TIR.
Measured on the mirror->glass->occluder reproducer
(tests/test_branchprob.py::
test_mirror_chain_prefix_attachment_reduces_bias): the channel is
-0.07 +- 0.02 on the mirror-center gradient and HALVES that config's
total bias (below).

DIELECTRIC-RIM DEEP PROBE (round 4): the per-lane diagnostic on the
mirror-chain reproducer proved the attached dg/dtheta itself is CORRECT
(AD == chain-FD to 1e-3 on every crossing lane) -- the bias was missing
NEGATIVE crossing mass. Its largest family: lanes grazing the glass
sphere's own rim, whose true radiance step (sky -> lensed occluder,
raw-dI mass -176 on the reproducer) sits ~0.04 rad INSIDE the rim,
past a grazing band (Fresnel ~ 1) where a 2e-3-deep probe still reads
sky (measured profile: f = 2.43 at 0.002 in, 0.0 by 0.04 in). The
``probe_delta_diel`` deep inner probe (dielectric candidates only)
captures that family at -217/-173 (fixed/adaptive kernel) and cuts the
reproducer's net attached bias 0.059 -> 0.031 (FD truth 0.002).

RESIDUAL OUT-OF-SCOPE TERMS, each with its measured bound on the
reproducer configs:
  * MIRROR-PREFIX CHAIN SWEEP BIAS (round-5 corrected bound: residual
    -0.065 +- 0.038 at 16 keys vs FD truth +0.003 -- the r4 "+0.031"
    was a 3-key mean of an estimator with ~0.15 per-key SE; was +0.13
    detached-r3): the two remaining channels, measured per-family on
    the reproducer:
    (a) through-lens lanes whose exit-cone dg/dtheta is lens-MAGNIFIED
    (|dg| 5-27 at g in [-0.56, -0.11]) -- sparse in g, so kernel mass
    rarely lands on them; attacked in round 5 with exit-cone re-jitter
    sampling (``sweep_redraws``) and measured INSENSITIVE (M=8 moves
    the 16-key mean by ~+0.013, within one SE --
    docs/CHAIN_SWEEP_r05.json), so (a) is not the binding residual;
    and (b) lanes whose true flip happens through RR-threshold
    crossings and reflection arms, not the deterministic chain's own
    edge (their exit-cone dg has the OPPOSITE sign of the true dI) --
    what remains, needs specular-manifold-style boundary sampling.
    The same term WITHOUT the occluder under-claims (-0.005 vs FD
    -0.018). Pinned by the reproducer test.
  * GLASS-RIM / SWEEP OVERLAP -- RESOLVED (round 5): the round-4
    suspicion of a partial rim-band double count when BOTH rr_grad and
    boundary_samples are on (a noise-limited 0.39 +- 0.18 SE claim) was
    decided by the CRN-paired ownership study
    (docs/RIM_OWNERSHIP_r05.json, final run 96 keys): on the rim
    reproducer interior AD is 0, the boundary term is +0.125 +- 0.005
    (~= FD truth 0.114 alone), and the delta-lobe pair largely CANCELS
    (rr +0.54 / sweep -0.40); ceding the rim band leaves the total
    16 SE above FD vs z = 3.8 ungated. Ownership map: the boundary term
    owns the rim's geometric motion; the RR + sweep pair jointly own
    the Schlick/TIR branch mass and must always run TOGETHER, ungated
    (raytracer.hxx:179-191). The pair's imperfect cancellation on this
    all-rim-band adversarial frame was then bounded by a three-step
    elimination: flat in BOTH smoothing bandwidths, bit-flat in
    probe_delta_diel, and BRACKETING the ~0 truth across vertex-depth
    coverage (vd0-only +0.110 +- 0.040, designed
    depth-0..1 sum -0.133 +- 0.041, the internal interface's channel
    alone ~ -0.24). Honest bound: the per-interface channels are
    individually large here and their sum misses the small truth by
    ~|0.12| either way -- grazing-incidence estimator structure, the
    specular-manifold family. Ordinary frames hold rim pixels as a
    small fraction; every shipped FD-parity test passes at tolerance.
  * reflect-of-reflect arms (second-order internal RR): unmeasured on
    shipped scenes (no failing config found; the first-order arms are
    within 2.5% of FD on the config built to expose them).
  * air-gap edge crossings that change the CHAIN'S OWN topology
    mid-walk (hollow-glass air gap, main.cxx:128-129): no measurable
    failing config on shipped scenes -- hollow-glass ior FD parity is
    full (test_hollow_glass_ior_matches_finite_differences); the
    mirror-chain reproducer above is the nearest measured relative of
    this family.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from .silhouette import PROBE_RR_QCAP, _probe_options

def _refract_dir_clamped(u, outward, ri, cos_o, k, phys: bool):
    """Refraction direction with the discriminant clamped at 0.

    Matches the renderer's SELECTED expression -- "physical" Snell
    (math3.refract) or the reference's scalar-broadcast form
    (math3.refract_reference, math.hxx:300-309) -- so probes and the
    deterministic chain follow the directions the renderer actually
    takes under every compat mode. k <= 0 yields the grazing limit
    (sq = 0) instead of NaN/zero, which is what the TIR-band smoothing
    crosses through.
    """
    kp = k > 0.0
    sq = jnp.where(kp, jnp.sqrt(jnp.where(kp, k, 1.0)), 0.0)
    if phys:
        return ri[:, None] * u - (ri * cos_o + sq)[:, None] * outward
    # reference: i*eta - (n*sq + cos_i*eta) with cos_i*eta broadcast
    # per component (cos_i = dot(outward, u) = cos_o).
    return u * ri[:, None] - (outward * sq[:, None]
                              + (cos_o * ri)[:, None])


TAG_RR_VERTEX = 120  # fold_in tags (disjoint from silhouette.py's 101-108)
TAG_RR_PROBE = 121
TAG_RR_DEPTH = 122
TAG_SWEEP_PROBE = 123  # + branch index
TAG_SWEEP_REDRAW = 140  # + br * 16 + redraw index (sweep_redraws)


def branch_probability_surrogate(scene: Scene, cam: Camera,
                                 camera_mode: str, cot, pixel_ids,
                                 width: int, height: int, base_key,
                                 max_depth: int, options: TraceOptions,
                                 vertex_depth: int = 0,
                                 tir_bandwidth: float = 0.02,
                                 sweep_bandwidth: float = 0.03,
                                 probe_delta: float = 2e-3,
                                 probe_delta_diel: float = 0.05,
                                 chain_rr_arms: int = 2,
                                 sweep_redraws: int = 0,
                                 rr_probe_splits: int = 1,
                                 boundary_rim_frac: float | None = None,
                                 _detach_prefix: bool = False,
                                 _rr_term: bool = True,
                                 _sweep_term: bool = True):
    """Surrogate scalar for BOTH delta-lobe terms (module docstring).

    Args:
      cot: (P, 3) dL/dI for exactly the ``pixel_ids`` batch (detached).
      vertex_depth: walk the vertex this many bounces of the renderer's
        own contract first (any prefix materials), like the secondary
        boundary term.
      tir_bandwidth: kernel width h (in refraction-discriminant units)
        smoothing the TIR step inside the RR surrogate.
      sweep_bandwidth: angular kernel width (radians) of the
        direction-sweep edge term.
      probe_delta: angular half-offset (radians) of the sweep probe
        pair, clamped to half the candidate's cone half-angle.
      probe_delta_diel: inner-probe depth when the nearest-edge
        candidate is a DIELECTRIC sphere -- glass rims carry a grazing
        band (Fresnel ~ 1) the tight probe cannot see past; the deep
        probe reads the post-band radiance so the rim's true step is
        captured (sweep_term comment; measured on the mirror-chain
        reproducer).
      chain_rr_arms: how many of the refract chain's internal-RR
        REFLECTION arms get their own (side-chain) edge term -- the
        round-3 scope extension; 0 restores the refract-chain-only
        estimator. Arms beyond the first reflection per interface
        (reflect-of-reflect) remain out of scope.
      rr_probe_splits: number of INDEPENDENT CRN probe pairs averaged
        inside the RR term (default 1 = the historical single pair;
        split 0 keeps the historical key stream, so splits=1 is
        bit-identical to before). Expectation unchanged; splits x
        probe-trace cost. Diagnostic finding (round 5): the rim
        reproducer's RR-term heavy tail across step keys (raw mean
        0.547 vs 10%-trimmed 0.484 at 48 keys,
        docs/RIM_OWNERSHIP_r05.json) is NOT probe noise -- splits=4
        leaves the across-key SE unchanged (240 vs 317 units at 24
        keys, measured), so the tail lives in the vertex-jitter
        dimension (which lanes graze the rim), where only more pixels/
        samples help.
      sweep_redraws: number M of fresh uniform pixel-jitter re-walks per
        lane for the MAIN branches' sweep term (0 = the lane's own
        single jitter, the pre-round-5 estimator). Each redraw re-runs
        camera ray -> prefix walk (same per-ray keys, so the re-walk is
        the same smooth function of theta) -> branch -> refract chain
        EXACTLY, evaluates the triangular kernel at the redrawn exit's
        cone distance against the lane's ORIGINAL candidate edge, and
        reuses the original probe pair's radiance step (the step is a
        property of the edge, locally constant along it). The M draws
        average to the same expectation over the pixel's jitter measure
        -- an M-fold variance cut on exactly the kernel factor whose
        undersampling drives the magnified-exit-cone residual. Side-chain
        RR arms keep the single-sample kernel. Measured on the
        mirror-chain reproducer: docs/CHAIN_SWEEP_r05.json.
      boundary_rim_frac: ABLATION ONLY -- a float drops vertex_depth-0
        dielectric sweep lanes whose entry grazes the rim (impact
        parameter within that fraction of the radius). The late-r4
        "grazing-entry ownership gate" hypothesis (the camera boundary
        term's deep probe owns that band, so the sweep should cede it)
        was REFUTED by the CRN-paired ownership study
        (docs/RIM_OWNERSHIP_r05.json, 48 keys):
        on the rim reproducer the band's sweep mass (-0.42 +- 0.03) is a
        canceling pair with the RR term (+0.49 +- 0.03) -- gating it
        leaves the total 17 SE above FD truth while the ungated total
        matches within 2 SE. Production callers (render_loss) always
        pass None (no gate); the unconditional r4 gate additionally
        collapsed rr_grad-only glass-ior gradients.
      _detach_prefix: ablation switch for tests -- walk the prefix on
        the detached scene (the round-3 behavior), dropping the
        prefix-motion channel of dp/dtheta.
      _rr_term/_sweep_term: test-only isolation of the two terms.
    Returns a scalar; add ``s - stop_gradient(s)`` to the loss.
    """
    from . import math3
    from .integrate import _bounce_step, trace_fast
    from .intersect import closest_hit, hit_surface
    from ..models.camera import camera_ray
    from ..models.scene import DIELECTRIC, METAL
    from ..render import make_primary_rays

    p_count = pixel_ids.shape[0]
    scene_det = jax.lax.stop_gradient(scene)

    # 1. One vertex per batch pixel, walked with the integrator's step.
    vkey = jax.random.fold_in(base_key, TAG_RR_VERTEX)
    o, d, ray_keys = make_primary_rays(cam, pixel_ids,
                                       jnp.zeros_like(pixel_ids), vkey,
                                       width, height, camera_mode)
    state = (o, d, jnp.ones((p_count, 3), jnp.float32),
             jnp.zeros((p_count, 3), jnp.float32),
             jnp.ones((p_count,), bool), ray_keys)
    # Track whether the prefix already visited a delta vertex: the sweep
    # term (step 5) follows the WHOLE deterministic chain from the first
    # delta vertex, so firing it again at deeper chain vertices would
    # double-count the same crossings (measured: it cancelled the vd=0
    # term almost exactly). RR terms are per-interface and stay at every
    # depth.
    prefix_delta = jnp.zeros((p_count,), bool)
    # The walk runs on the ATTACHED scene (round 4; same rationale as
    # silhouette.secondary_boundary_surrogate's prefix): with draws
    # fixed, each prefix hop's position/normal/scattered direction is a
    # smooth function of theta, so the vertex position AND the arrival
    # direction d(theta) carry the PREFIX-MOTION component of dp/dtheta
    # (a mirror steering the view onto glass: tilting the mirror changes
    # the incidence angle, hence Schlick/TIR). All WEIGHTS stay
    # detached (path_alb below); discrete outcomes in the step carry no
    # tangent.
    walk_scene = scene_det if _detach_prefix else scene
    for b in range(vertex_depth):
        state, (idx_b, hit_b) = _bounce_step(walk_scene, options, state, b,
                                             return_hit=True)
        mb = scene_det.material_index[idx_b]
        prefix_delta = prefix_delta | (
            hit_b & ((scene_det.mtype[mb] == DIELECTRIC)
                     | ((scene_det.mtype[mb] == METAL)
                        & (scene_det.fuzz[mb] <= 1e-3))))
    o, d, path_alb, _, alive, _ = state
    path_alb = jax.lax.stop_gradient(path_alb)

    # Final hop ATTACHED (cf. silhouette.py receiver motion): the normal
    # at y(theta) carries the geometry dependence of cos/Schlick.
    t_a, idx, hit = closest_hit(o, d, scene.centers, scene.radii,
                                options.t_min, options.sphere_block)
    y_att, n_att = hit_surface(o, d, t_a, idx, hit, scene.centers,
                               scene.radii)
    y = jax.lax.stop_gradient(y_att)
    mi = scene_det.material_index[idx]
    is_diel = scene_det.mtype[mi] == DIELECTRIC
    is_mirror = ((scene_det.mtype[mi] == METAL)
                 & (scene_det.fuzz[mi] <= 1e-3))
    active = alive & hit & is_diel

    # 2. Attached reflection probability, TIR step kernel-smoothed
    # (ops/scatter.py semantics: entering by sign of cos; both refract
    # expressions share this discriminant, so k < 0 <=> TIR in the
    # "physical" and the bug-compatible reference mode alike).
    ior_att = scene.ior[mi]  # ATTACHED gather
    # d is the walk's arrival direction: ATTACHED by default (round 4,
    # the prefix-motion channel of dp/dtheta); detached only under the
    # _detach_prefix ablation.
    unit_dir = math3.normalize(d)
    cos_theta = jnp.sum(unit_dir * n_att, axis=-1)
    entering = cos_theta <= 0.0
    outward = jnp.where(entering[:, None], n_att, -n_att)
    ri = jnp.where(entering, 1.0 / ior_att, ior_att)
    cos_abs = jnp.abs(cos_theta)
    cos_o = jnp.sum(outward * unit_dir, axis=-1)
    k_att = 1.0 - ri * ri * (1.0 - cos_o * cos_o)
    schlick_att = math3.schlick(ri, cos_abs)
    p_att = schlick_att + (1.0 - schlick_att) * jax.nn.sigmoid(
        -k_att / tir_bandwidth)

    # 3. ATTACHED branch directions. The refract direction clamps the
    # discriminant at 0 (double-where: sqrt's backward is inf there) --
    # the k <= 0 limit IS the grazing direction the TIR band crosses
    # through, so probes stay NaN-free everywhere.
    det = jax.lax.stop_gradient
    phys = options.refract == "physical"
    reflected_att = math3.reflect(unit_dir, n_att)
    refracted_att = _refract_dir_clamped(unit_dir, outward, ri, cos_o,
                                         k_att, phys)
    probe_depth = max(max_depth - 1 - vertex_depth, 0)

    # RR term: both continuations with common random numbers.
    # rr_probe_splits > 1 averages that many INDEPENDENT probe pairs
    # (each pair still CRN within itself) -- a variance/heavy-tail knob
    # for the probe difference at rr_probe_splits x trace cost; the
    # expectation is unchanged.
    l_reflect = jnp.zeros((p_count, 3), jnp.float32)
    l_refract = jnp.zeros((p_count, 3), jnp.float32)
    o_all = jnp.concatenate([y, y])
    d_all = det(jnp.concatenate([reflected_att, refracted_att]))
    for j in range(rr_probe_splits):
        kj = jax.random.fold_in(base_key, TAG_RR_PROBE)
        if j > 0:  # split 0 keeps the historical key stream
            kj = jax.random.fold_in(kj, j)
        pkeys = jax.vmap(jax.random.fold_in, (None, 0))(
            kj, jnp.arange(p_count, dtype=jnp.int32))
        k_all = jnp.concatenate([pkeys, pkeys])
        f_all = trace_fast(scene_det, o_all, d_all, k_all, probe_depth,
                           _probe_options(options),
                           rr_qcap=PROBE_RR_QCAP)
        l_reflect = l_reflect + f_all[:p_count]
        l_refract = l_refract + f_all[p_count:]
    l_reflect = l_reflect / rr_probe_splits
    l_refract = l_refract / rr_probe_splits

    # 4. Detached RR weight; the only attached factor is p(theta). The
    # vertex attenuation is the material albedo (material.hxx:33-38).
    thru = cot * path_alb * scene_det.albedo[mi]
    w = jnp.sum(thru * (l_reflect - l_refract), axis=-1)
    w = det(jnp.where(active, w, 0.0))
    surrogate = jnp.sum(w * p_att) if _rr_term else jnp.float32(0.0)

    # 5. DIRECTION-SWEEP edge term per delta branch (module docstring).
    # True branch probability (step TIR, detached) weights each branch;
    # mirrors have a single reflect branch of weight 1.
    p_step = det(jnp.where(k_att < 0.0, 1.0, schlick_att))
    active_delta = alive & hit & (is_diel | is_mirror)
    # GRAZING-ENTRY GATE (late round 4; REFUTED and demoted to an
    # ablation in round 5): the r4 hypothesis -- the camera boundary
    # term's dielectric deep probe owns the vertex_depth-0 rim band
    # (impact parameter within boundary_rim_frac of the radius,
    # |cos| < sqrt(1 - (1 - frac)^2)), so the sweep should cede those
    # lanes -- was decided AGAINST by the CRN-paired ownership study
    # (docs/RIM_OWNERSHIP_r05.json, 48 keys
    # with gated/ungated sharing every probe key): on the rim-zoom
    # reproducer the band's sweep mass is -0.42 +- 0.03 against the RR
    # term's +0.49 +- 0.03 -- a canceling PAIR, not a double count of
    # the boundary term's 0.125. Gating one leg leaves the total 17 SE
    # above FD truth (0.61 vs 0.11); ungated matches within 2 SE. The
    # r4 2.2-sigma "0.39 +- 0.18" claim does not reproduce under CRN.
    # Production callers never gate (inverse.py passes None); the knob
    # remains for the reproducer test and future ownership studies. The
    # unconditional r4 gate also collapsed rr_grad-only glass-ior
    # gradients to 58% of FD.
    if vertex_depth == 0 and boundary_rim_frac is not None:
        grazing_cos = (1.0 - (1.0 - boundary_rim_frac) ** 2) ** 0.5
        active_delta = active_delta & (
            is_mirror | (cos_abs >= grazing_cos))
    prob_reflect = jnp.where(is_mirror, 1.0, p_step)
    prob_refract = jnp.where(is_diel, 1.0 - p_step, 0.0)
    h = sweep_bandwidth
    n_chain = 5  # refract-chain unroll: hollow glass exits in <= 4 hits

    def chain_step(y_c, w_c, done, prob, alb):
        """Follow the deterministic dielectric chain one interface.

        Straight-line cone geometry is WRONG from inside glass (the
        hollow sphere acts as a lens -- it even inverts the image, which
        flipped the term's sign when measured naively), so the edge term
        must be evaluated on the FINAL AIR SEGMENT: whenever the current
        segment's hit is a dielectric, refract through it (ATTACHED
        Snell; TIR falls back to the deterministic internal reflection)
        and keep walking; any other hit or a miss means (y_c, w_c)
        already is the air segment. ``prob`` accumulates the renderer's
        probability of this deterministic arm (1-p per refraction, 1
        under TIR) and ``alb`` its per-channel attenuation -- the
        renderer multiplies attenuation by albedo[mi] at EVERY
        dielectric interface visit (refract or internal reflect,
        material.hxx:33-38), so a tinted glass attenuates each chain
        hop; detached like every other weight. The dropped internal-RR
        *reflection* arm's data is returned so the caller can spawn it
        as a side chain (chain_rr_arms):
        (yh, refl, p_reflect, alb_arm, spawnable).
        """
        t_c, idx_c, hit_c = closest_hit(y_c, w_c, scene.centers,
                                        scene.radii, options.t_min,
                                        options.sphere_block)
        yh, nh = hit_surface(y_c, w_c, t_c, idx_c, hit_c, scene.centers,
                             scene.radii)
        mic = scene_det.material_index[idx_c]
        is_d = hit_c & (scene_det.mtype[mic] == DIELECTRIC) & ~done
        u = math3.normalize(w_c)
        cosn = jnp.sum(u * nh, axis=-1)
        ent = cosn <= 0.0
        ior_c = scene.ior[mic]  # attached
        outw = jnp.where(ent[:, None], nh, -nh)
        rif = jnp.where(ent, 1.0 / ior_c, ior_c)
        cos_oc = jnp.sum(outw * u, axis=-1)
        kc = 1.0 - rif * rif * (1.0 - cos_oc * cos_oc)
        refr = _refract_dir_clamped(u, outw, rif, cos_oc, kc, phys)
        refl = math3.reflect(u, nh)
        tir_c = kc < 0.0
        w_new = jnp.where(tir_c[:, None], refl, refr)
        p_refl = math3.schlick(rif, jnp.abs(cosn))
        p_cont = jnp.where(tir_c, 1.0, 1.0 - p_refl)
        prob_out = prob * jnp.where(is_d, det(p_cont), 1.0)
        alb_c = det(scene_det.albedo[mic])
        alb_vis = alb * alb_c  # one albedo factor per interface visit
        alb_out = jnp.where(is_d[:, None], alb_vis, alb)
        y_out = jnp.where(is_d[:, None], yh, y_c)
        w_out = jnp.where(is_d[:, None], w_new, w_c)
        # Internal-RR reflection arm (renderer prob p_refl) at a non-TIR
        # dielectric interface: the arm the refract-chain drops. The
        # reflection is an interface visit too -> carries alb_vis.
        spawn = is_d & ~tir_c
        return (y_out, w_out, done | ~is_d, prob_out, alb_out, is_d,
                (yh, refl, prob * det(p_refl), alb_vis, spawn))

    def follow_chain(y0, w0, prob0, alb0, steps0, n_steps, collect_arms):
        """Run the refract chain; optionally collect reflection arms."""
        y_f, w_f = y0, w0
        done = jnp.zeros((p_count,), bool)
        prob = prob0
        alb = alb0
        steps = steps0
        arms = []
        for j in range(n_steps):
            y_f, w_f, done, prob, alb, stepped, arm = chain_step(
                y_f, w_f, done, prob, alb)
            steps = steps + stepped.astype(jnp.int32)
            if j < collect_arms:
                # The arm consumed this interface too: steps + 1.
                arms.append((arm, steps))
        return y_f, w_f, done, prob, alb, steps, arms

    def rewalk_branch(rjkey, br):
        """Re-run camera ray -> prefix walk -> final hop -> branch ->
        refract chain at a FRESH uniform pixel jitter (sweep_redraws).

        The per-ray keys are UNCHANGED, so every discrete draw (scatter
        vectors, RR words) matches the lane's own walk -- the re-walk is
        the same smooth function of theta evaluated at a new point of
        the pixel's jitter measure. The vertex/branch math duplicates
        steps 1-3 and the gate of the main path above (source of truth;
        keep in sync). Known inefficiency (acceptable for a diagnostic
        knob): the branch-INDEPENDENT prefix walk re-runs per branch
        because the redraw jitter key carries br; sharing M walks across
        both branches would halve the redraw trace cost if this is ever
        promoted beyond diagnostics."""
        ju = jax.random.uniform(jax.random.fold_in(rjkey, 0), (p_count,))
        jv = jax.random.uniform(jax.random.fold_in(rjkey, 1), (p_count,))
        yp = pixel_ids // width
        xp = pixel_ids - yp * width
        u2 = (xp.astype(jnp.float32) + ju) / width
        v2 = (yp.astype(jnp.float32) + jv) / height
        o2, d2 = jax.vmap(
            lambda uu, vv, rk: camera_ray(cam, uu, vv, rk, camera_mode)
        )(u2, v2, ray_keys)
        st = (o2, d2, jnp.ones((p_count, 3), jnp.float32),
              jnp.zeros((p_count, 3), jnp.float32),
              jnp.ones((p_count,), bool), ray_keys)
        pdelta2 = jnp.zeros((p_count,), bool)
        for b in range(vertex_depth):
            st, (ib, hb) = _bounce_step(walk_scene, options, st, b,
                                        return_hit=True)
            mb = scene_det.material_index[ib]
            pdelta2 = pdelta2 | (
                hb & ((scene_det.mtype[mb] == DIELECTRIC)
                      | ((scene_det.mtype[mb] == METAL)
                         & (scene_det.fuzz[mb] <= 1e-3))))
        o2, d2, palb2, _, alive2, _ = st
        palb2 = jax.lax.stop_gradient(palb2)
        t2, idx2, hit2 = closest_hit(o2, d2, scene.centers, scene.radii,
                                     options.t_min, options.sphere_block)
        y2_att, n2_att = hit_surface(o2, d2, t2, idx2, hit2,
                                     scene.centers, scene.radii)
        mi2 = scene_det.material_index[idx2]
        isd2 = scene_det.mtype[mi2] == DIELECTRIC
        ismir2 = ((scene_det.mtype[mi2] == METAL)
                  & (scene_det.fuzz[mi2] <= 1e-3))
        ud2 = math3.normalize(d2)
        cth2 = jnp.sum(ud2 * n2_att, axis=-1)
        ent2 = cth2 <= 0.0
        outw2 = jnp.where(ent2[:, None], n2_att, -n2_att)
        ior2 = scene.ior[mi2]
        ri2 = jnp.where(ent2, 1.0 / ior2, ior2)
        cabs2 = jnp.abs(cth2)
        cos_o2 = jnp.sum(outw2 * ud2, axis=-1)
        k2 = 1.0 - ri2 * ri2 * (1.0 - cos_o2 * cos_o2)
        sch2 = math3.schlick(ri2, cabs2)
        p_step2 = det(jnp.where(k2 < 0.0, 1.0, sch2))
        if br == 0:
            w_br2 = math3.reflect(ud2, n2_att)
            prob_br2 = jnp.where(ismir2, 1.0, p_step2)
        else:
            w_br2 = _refract_dir_clamped(ud2, outw2, ri2, cos_o2, k2,
                                         phys)
            prob_br2 = jnp.where(isd2, 1.0 - p_step2, 0.0)
        active2 = alive2 & hit2 & (isd2 | ismir2)
        if vertex_depth == 0 and boundary_rim_frac is not None:
            gcos = (1.0 - (1.0 - boundary_rim_frac) ** 2) ** 0.5
            active2 = active2 & (ismir2 | (cabs2 >= gcos))
        gate2 = active2 & ~pdelta2
        thru2 = cot * palb2 * scene_det.albedo[mi2]
        y_f2, w_f2, done2, prob2, alb2, steps2, _ = follow_chain(
            y2_att, w_br2, det(prob_br2),
            jnp.ones((p_count, 3), jnp.float32),
            jnp.zeros((p_count,), jnp.int32), n_chain, 0)
        return dict(y_f=y_f2, w_f=w_f2, done=done2, prob=prob2,
                    alb=alb2, steps=steps2, gate=gate2, thru=thru2)

    def sweep_term(y_f, w_f_att, done, prob, alb, steps, gate, br,
                   redraw: bool = False):
        """The final-air-segment cone-edge crossing term (docstring)."""
        # The chain consumes renderer bounces: the final air segment must
        # still fit the continuation budget or the true I(theta) has no
        # crossing to differentiate (the probes would otherwise inject a
        # spurious over-budget term). Residual: in-budget lanes' probes
        # still trace the full probe_depth rather than the per-lane
        # remainder -- second-order at the tested depths.
        budget_ok = steps <= max_depth - 2 - vertex_depth

        w_hat_att = math3.normalize(w_f_att)
        w_hat = det(w_hat_att)
        y_fd = det(y_f)

        # Nearest cone edge over all spheres from the final air vertex
        # (detached selection; own/enclosing spheres excluded).
        m_all = scene_det.centers[None] - y_fd[:, None]
        dist = jnp.linalg.norm(m_all, axis=-1)
        rho = jnp.abs(scene_det.radii)[None]
        sil_ok = dist > rho * (1.0 + 1e-5)
        dist_s = jnp.where(sil_ok, dist, 1.0)
        m_hat = m_all / dist_s[..., None]
        beta_all = jnp.arcsin(jnp.clip(rho / dist_s, 0.0, 1.0 - 1e-7))
        cosang = jnp.sum(w_hat[:, None, :] * m_hat, axis=-1)
        ang = jnp.arccos(jnp.clip(cosang, -1.0 + 1e-7, 1.0 - 1e-7))
        g_all = jnp.where(sil_ok, jnp.abs(ang - beta_all), jnp.inf)
        j_star = jnp.argmin(g_all, axis=-1).astype(jnp.int32)
        any_ok = jnp.isfinite(jnp.min(g_all, axis=-1))

        # Attached edge distance through w(theta), y(theta), c_j, r_j.
        c_s = scene.centers[j_star]
        r_s = scene.radii[j_star]
        mv = c_s - y_f
        dist_a = jnp.maximum(jnp.linalg.norm(mv, axis=-1), 1e-6)
        beta_a = jnp.arcsin(jnp.clip(jnp.abs(r_s) / dist_a,
                                     0.0, 1.0 - 1e-7))
        cos_a = jnp.sum(w_hat_att * mv / dist_a[:, None], axis=-1)
        g_att = jnp.arccos(jnp.clip(cos_a, -1.0 + 1e-7, 1.0 - 1e-7)
                           ) - beta_a
        g_det = det(g_att)

        # Probe pair straddling the cone at the point nearest w.
        a_hat = det(mv / dist_a[:, None])
        t_raw = w_hat - jnp.sum(w_hat * a_hat, axis=-1, keepdims=True
                                ) * a_hat
        t_norm = jnp.linalg.norm(t_raw, axis=-1)
        ok_t = t_norm > 1e-6  # w parallel to the axis: deep inside, K=0
        t_hat = t_raw / jnp.maximum(t_norm, 1e-6)[:, None]
        beta_d = det(beta_a)
        delta = jnp.minimum(probe_delta, 0.49 * beta_d)
        # DIELECTRIC candidates get a DEEP inner probe (round 4): just
        # inside a glass rim sits a grazing band (Fresnel ~ 1, huge
        # deflection) whose radiance still matches the outside -- a
        # probe_delta-deep probe reads "no jump" across an edge whose
        # true step (the lensed image of whatever lies behind the glass)
        # sits a few hundredths of a radian further in. Measured on the
        # mirror->glass->occluder reproducer: f just
        # inside the rim = 2.43 (sky) at 0.002, 0.0 (occluder) by 0.04;
        # the deep probe captures the rim family's true -176 raw-dI mass
        # at -217/-173 where the shallow probe claimed ~0. Non-delta
        # candidates keep the tight probe (no band to clear).
        mt_c = scene_det.mtype[scene_det.material_index[j_star]]
        delta_in = jnp.where(mt_c == DIELECTRIC,
                             jnp.minimum(probe_delta_diel, 0.49 * beta_d),
                             delta)
        w_in = (jnp.cos(beta_d - delta_in)[:, None] * a_hat
                + jnp.sin(beta_d - delta_in)[:, None] * t_hat)
        w_out = (jnp.cos(beta_d + delta)[:, None] * a_hat
                 + jnp.sin(beta_d + delta)[:, None] * t_hat)
        skeys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.fold_in(base_key, TAG_SWEEP_PROBE + br),
            jnp.arange(p_count, dtype=jnp.int32))
        f_sw = trace_fast(scene_det, jnp.concatenate([y_fd, y_fd]),
                          jnp.concatenate([w_in, w_out]),
                          jnp.concatenate([skeys, skeys]), probe_depth,
                          _probe_options(options),
                          rr_qcap=PROBE_RR_QCAP)
        f_in = f_sw[:p_count]
        f_out = f_sw[p_count:]

        # Triangular kernel on the angular distance; I(g) steps from f_in
        # (inside, g < 0) to f_out, so dI/dtheta = -(f_in - f_out) K dg.
        # alb: the chain's per-channel interface attenuation (tinted
        # glass; ones on the shipped scenes).
        if redraw and sweep_redraws > 0:
            if sweep_redraws > 16:
                raise ValueError(
                    "sweep_redraws > 16 would collide redraw fold_in "
                    "tags across branches (TAG_SWEEP_REDRAW + br*16 + m)")
            # M fresh uniform re-jitters of THIS pixel replace the
            # lane's own single kernel sample (sweep_redraws docstring):
            # the chain re-runs EXACTLY per redraw; the candidate edge
            # (j_star) and its probe pair's radiance step are reused --
            # the step is a property of the edge, locally constant
            # along it. Same expectation over the jitter measure, M-fold
            # variance cut on the kernel factor.
            fstep = det(f_in - f_out)
            c_r = scene.centers[j_star]
            r_r = scene.radii[j_star]
            # The redrawn kernel reuses the ORIGINAL lane's candidate
            # edge (j_star) and probe step (fstep), so redraw
            # contributions are only meaningful where the original
            # chain was itself valid -- a pixel whose own jitter never
            # reached a gated air segment has a j_star/fstep built from
            # meaningless geometry, and the single-sample estimator
            # contributed 0 there too (review r5: without this mask,
            # rim-straddling pixels could inject spurious mass).
            orig_ok = gate & done & budget_ok & any_ok & ok_t
            acc = jnp.float32(0.0)
            for m in range(sweep_redraws):
                rw = rewalk_branch(
                    jax.random.fold_in(base_key,
                                       TAG_SWEEP_REDRAW + br * 16 + m),
                    br)
                wv2 = math3.normalize(rw["w_f"])
                mv2 = c_r - rw["y_f"]
                dist2 = jnp.maximum(jnp.linalg.norm(mv2, axis=-1), 1e-6)
                beta2 = jnp.arcsin(jnp.clip(jnp.abs(r_r) / dist2,
                                            0.0, 1.0 - 1e-7))
                cosw2 = jnp.sum(wv2 * mv2 / dist2[:, None], axis=-1)
                g2 = jnp.arccos(jnp.clip(cosw2, -1.0 + 1e-7, 1.0 - 1e-7)
                                ) - beta2
                a2 = det(mv2 / dist2[:, None])
                wv2d = det(wv2)
                tr2 = wv2d - jnp.sum(wv2d * a2, axis=-1,
                                     keepdims=True) * a2
                okt2 = jnp.linalg.norm(tr2, axis=-1) > 1e-6
                budget2 = rw["steps"] <= max_depth - 2 - vertex_depth
                kern2 = jnp.maximum(0.0, 1.0 - jnp.abs(det(g2)) / h) / h
                w2 = (jnp.sum(rw["thru"] * rw["alb"] * fstep, axis=-1)
                      * rw["prob"] * kern2)
                w2 = jnp.where(orig_ok & rw["gate"] & rw["done"]
                               & budget2 & okt2, w2, 0.0)
                acc = acc - jnp.sum(det(w2) * g2)
            return acc / sweep_redraws

        kern = jnp.maximum(0.0, 1.0 - jnp.abs(g_det) / h) / h
        w_sw = (jnp.sum(thru * alb * (f_in - f_out), axis=-1)
                * prob * kern)
        w_sw = jnp.where(gate & done & budget_ok & any_ok & ok_t,
                         w_sw, 0.0)
        return -jnp.sum(det(w_sw) * g_att)

    if not _sweep_term:
        return surrogate
    gate0 = active_delta & ~prefix_delta
    zero_steps = jnp.zeros((p_count,), jnp.int32)
    ones_alb = jnp.ones((p_count, 3), jnp.float32)
    for br, (w_br_att, prob_br) in enumerate(
            [(reflected_att, prob_reflect), (refracted_att, prob_refract)]):
        y_f, w_f, done, prob, alb_f, steps, arms = follow_chain(
            y_att, w_br_att, det(prob_br), ones_alb, zero_steps, n_chain,
            chain_rr_arms)
        surrogate = surrogate + sweep_term(y_f, w_f, done, prob, alb_f,
                                           steps, gate0, br, redraw=True)
        # Internal-RR REFLECTION arms (round-3 scope extension): the
        # refract chain drops the reflect side of every internal RR; each
        # collected arm follows its OWN refract chain (no further side
        # arms -- second order) to air and contributes the same edge
        # term, weighted by the arm's renderer probability
        # prob_before * schlick. Crossings are disjoint from the main
        # chain's (different final air segment), and deeper vertex_depth
        # walks that actually DRAW the reflection are sweep-suppressed
        # via prefix_delta, so nothing double counts.
        for a, ((yh_a, refl_a, prob_a, alb_a, spawn_a), steps_a) in \
                enumerate(arms):
            ya, wa, da, pa, aa, sa, _ = follow_chain(
                yh_a, refl_a, prob_a, alb_a, steps_a, n_chain - 1 - a, 0)
            surrogate = surrogate + sweep_term(
                ya, wa, da, pa, aa, sa, gate0 & spawn_a,
                2 + br * n_chain + a)

    return surrogate
