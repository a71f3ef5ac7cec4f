"""Edge-sampled silhouette gradients: the visibility boundary term.

The rendered image is discontinuous in sphere centers/radii at silhouettes
(the hit/miss flip of ``raytracer::intersect``'s discriminant,
raytracer.hxx:52-92): interior automatic differentiation of the integrator
sees only the smooth shading term and misses the boundary term entirely,
so gradients w.r.t. geometry cannot move a silhouette (the classic
differentiable-rendering limitation; cf. Li et al. 2018 "Differentiable
Monte Carlo Ray Tracing through Edge Sampling" and Bangaru et al. 2020
warped-area reparameterization -- see PAPERS.md).

For sphere scenes the silhouette is ANALYTIC, so edge sampling needs no
edge-search data structure at all. For sphere (c, r) seen from the camera
origin o, the silhouette points are

    p(phi) = c + rho * n(phi),         rho = |r|
    n(phi) = (rho/D) m_hat + sqrt(1 - rho^2/D^2) (cos(phi) e1 + sin(phi) e2)

with m = o - c, D = |m| (the tangency condition n . m = rho: the viewing
ray at p grazes the sphere). Projecting p(phi) to the film gives the exact
screen-space silhouette curve x(phi; c, r), differentiable in (c, r).

The pixel-area integral's boundary term is then

    dI_pix/dtheta |_edge = W*H * oint_{edge in pix} (f_in - f_out)
                                                    (dx/dtheta . n_s) ds

(x in [0,1]^2 screen coordinates, pixel area 1/(W*H), n_s the screen-space
outward normal of the sphere's projected region, f_in/f_out the radiance
just inside/outside -- probed by tracing two rays offset +/-delta along
n_s, which also makes OCCLUDED edges contribute ~zero automatically: both
probes see the occluder, so f_in - f_out vanishes).

The term is delivered as a SURROGATE scalar whose jax.grad equals the
Monte-Carlo boundary estimate while its value is irrelevant (callers add
``surrogate - stop_gradient(surrogate)`` to the loss):

    surrogate = sum_e  w_e_detached * (x_e(theta) . n_e_detached)
    w_e = cot_pix(x_e) . (f_in - f_out) * |dx/dphi| * (2*pi/E) * W * H

Everything except ``x_e(theta)`` is detached, so d surrogate/d theta is
exactly the estimator above; the probe traces run on a stop_gradient'ed
scene (forward only).

Scope: ``boundary_surrogate`` samples the boundary from the CAMERA
viewpoint (primary visibility -- the dominant silhouette term).
``secondary_boundary_surrogate`` extends it one bounce: from each
first-hit LAMBERT or FUZZY-METAL vertex, the scatter-lobe continuation
integral picks up boundary contributions where sphere silhouettes (as
seen from the vertex) sweep the direction sphere -- the shadow /
ambient-occlusion term (lambert) and the rough-reflection term (metal)
that move when an occluder moves, invisible to both interior AD and
the primary term. Both lobes share one analytic direction density
(``lobe_direction_density``): the reference draws dir' = axis + f*s
with s in/on the unit ball (axis = normal, f = 1 for lambert,
raytracer.hxx:131-141; axis = reflect, f = roughness for metal,
raytracer.hxx:143-156), whose direction law has the closed form
integrated along the ray through the offset ball. The same machinery
applies at DEEPER path vertices (``vertex_depth`` > 0): the vertex is
walked that many scatter steps of the renderer's own draw contract --
any materials in the prefix, including specular chains -- and summing
depths 0..D-2 covers the path-space boundary term at diffuse/glossy
vertices (final-hop vertex motion included; prefix-hop motion at
depth >= 1 is a detached residual approximation). Out of scope (still interior-only): edge
contributions AT delta-lobe vertices themselves -- PERFECT mirrors
(fuzz = 0) and dielectric refractions need the curved-surface path
reparameterization.
Defocus: "pinhole"/"cuda" are exact;
"thinlens" integrates
the boundary term over the APERTURE as well -- each edge sample draws
its own lens point l, samples the silhouette as seen FROM l, projects
through l (the thin-lens map: p is seen through l at the (u, v) whose
film direction is parallel to p - l), and probes along rays through l.
The estimator is then unbiased for the lens-averaged pixel integral
E_l[I(l)] the renderer actually computes. The quirky "cpu" mode
(SURVEY Q2: world-axis offset scaled by the screen coordinate itself,
camera.hxx:51-56) integrates its own lens measure too (round 5): the
offset depends on the screen point being solved for, so the edge
position is found as a two-iteration Picard fixed point from the
central projection (O(aperture^2) residual), with a final
attached-scene pass keeping the screen-scaling feedback channel in the
gradient. FD-validated on a defocus-dominated config
(test_boundary_grad_cpu_mode_aperture_integration).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene

TAG_EDGE_PHI = 101  # fold_in tags (disjoint from ops/rng.py's 0/1/2+b)
TAG_EDGE_PROBE = 102
TAG_EDGE_LENS = 103
TAG_EDGE2_VERTEX = 104  # secondary (one-bounce) boundary term
TAG_EDGE2_SPHERE = 105
TAG_EDGE2_PHI = 106
TAG_EDGE2_PROBE = 107
TAG_EDGE2_DEPTH = 108  # + vertex_depth: per-depth key split (render_loss)

# Default deep-inside-probe depth (fraction of the projected radius) for
# DIELECTRIC rim probes (one constant so the two surrogate modules and
# branchprob's ablation-only grazing gate can never silently diverge).
# NOTE: the "ownership gate" once built on this band was
# refuted by the CRN study (docs/RIM_OWNERSHIP_r05.json); render_loss
# never gates, and this constant only sets the probe depth default.
PROBE_DIEL_FRAC = 0.15


def _probe_options(options: TraceOptions) -> TraceOptions:
    """Options for the surrogates' DETACHED probe traces: Russian-
    roulette termination forced ON.

    The probe radiance enters every surrogate LINEARLY (an f_in - f_out
    step times detached weights), so any unbiased estimator of it leaves
    the surrogate's expectation unchanged -- and RR is exactly the shared
    unbiased-termination contract (rng.rr_terminate_update) the forward
    engines already use. What it buys here: at flagship scale the probe
    batches (e.g. 489 spheres x 512 edges x 2 probes at depth 50) always
    carry at least one live lane to full depth, so trace_fast's
    any-alive exit never fires and the probe traces dominate the
    full-surrogate train step. With RR the whole batch drains in
    ~rr_start + O(log N) bounces. Each probe PAIR shares its key, so RR
    decisions stay common-random-number paired like every other draw.
    """
    import dataclasses

    return (options if options.rr_terminate
            else dataclasses.replace(options, rr_terminate=True))


# Probe-trace survival ceiling (rng.rr_terminate_update rr_qcap): with
# the shipped q-rule alone, bright paths keep q = 1 and a 500k-probe
# batch still carries a live lane to depth 50 (measured: rr probes cut
# the flagship full-surrogate step by 0%). q <= 0.5 past rr_start
# forces all-dead by ~rr_start + log2(N) bounces; unbiased (1/q boost).
PROBE_RR_QCAP = 0.5


def silhouette_frame(centers, radii, eye, phis):
    """Silhouette points of each sphere from ``eye`` plus the cone frame.

    Returns (p, valid, frame) where frame = (m_hat, e1, e2, cos_a, sin_a)
    with m = eye - center and m_hat its unit vector, so the silhouette
    normal is n(phi) = cos_a*m_hat + sin_a*(cos(phi)*e1 + sin(phi)*e2)
    and p = center + |r|*n. Frame entries are (S, E, 3) / (S, E) shaped.
    """
    e_count = phis.shape[1]
    rho = jnp.abs(radii)[:, None]  # (S, 1)
    eye = jnp.broadcast_to(eye, (centers.shape[0], e_count, 3))
    m = eye - centers[:, None, :]  # (S, E, 3)
    d = jnp.sqrt(jnp.sum(m * m, axis=-1))  # (S, E)
    valid = d > rho * (1.0 + 1e-6)
    d_safe = jnp.where(valid, d, 1.0)
    m_hat = m / d_safe[..., None]

    # Orthonormal frame (e1, e2) perpendicular to m_hat; the helper axis
    # switches to Y where m_hat is nearly X-aligned.
    near_x = jnp.abs(m_hat[..., 0]) > 0.9
    helper = jnp.where(near_x[..., None],
                       jnp.array([0.0, 1.0, 0.0]),
                       jnp.array([1.0, 0.0, 0.0]))
    e1 = jnp.cross(m_hat, helper)
    e1 = e1 / jnp.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = jnp.cross(m_hat, e1)

    cos_a = jnp.clip(rho / d_safe, 0.0, 1.0 - 1e-7)  # n . m_hat at tangency
    sin_a = jnp.sqrt(1.0 - cos_a * cos_a)
    n = (cos_a[..., None] * m_hat
         + sin_a[..., None] * (jnp.cos(phis)[..., None] * e1
                               + jnp.sin(phis)[..., None] * e2))
    p = centers[:, None, :] + rho[..., None] * n
    return p, valid, (m_hat, e1, e2, cos_a, sin_a)


def silhouette_points(centers, radii, eye, phis):
    """Exact silhouette points of each sphere from viewpoint ``eye``.

    Args:
      centers: (S, 3) f32 (differentiable).
      radii:   (S,) f32 (differentiable; sign ignored -- a negative-radius
               shell, quirk Q10, has the same silhouette as its mirror).
      eye:     (3,) shared camera viewpoint, or (S, E, 3) per-sample
               viewpoints (lens integration).
      phis:    (S, E) angles parameterizing each silhouette circle.

    Returns (p, valid): p (S, E, 3) world-space silhouette points;
    valid (S, E) False where the viewpoint is inside the sphere (no
    silhouette).
    """
    p, valid, _ = silhouette_frame(centers, radii, eye, phis)
    return p, valid


def project_to_screen(cam: Camera, p, camera_mode: str, lens_offset=None):
    """World points -> (u, v) in [0,1]^2 screen space (+ validity).

    Inverts the reference's film mapping (camera.hxx:56): the ray for
    (u, v) from lens point origin+off has direction A + horizontal*u +
    vertical*(1-v) with A = lower_left - origin - off for the corrected
    modes and A = lower_left for the "cuda"/"cpu" quirk-Q11 modes (no
    -origin, no lens here). A point p projects to the (u, v) whose
    direction is parallel to p - (origin + off): a 3x3 solve done with
    the dual basis of (horizontal, vertical, film normal).

    Args:
      p: (..., 3) world points.
      lens_offset: optional (..., 3) thin-lens offsets from the origin.
    Returns (uv (..., 2), valid (...,)): valid is False behind the camera
    or at grazing film angles.
    """
    if camera_mode == "cpu" and lens_offset is not None:
        # Quirk Q2 + Q11 (camera.hxx:51-56): the CPU path's defocus ray
        # for (u, v) from offset off is origin+off ->
        # lower_left + u*hor + (1-v)*ver - off (no -origin).
        a_vec = cam.lower_left - lens_offset
        eye = cam.origin + lens_offset
    elif camera_mode in ("cuda", "cpu"):
        a_vec = cam.lower_left  # quirk Q11: direction never subtracts origin
        eye = jnp.asarray(cam.origin)
    elif lens_offset is None:
        a_vec = cam.lower_left - cam.origin
        eye = jnp.asarray(cam.origin)
    else:
        a_vec = cam.lower_left - cam.origin - lens_offset  # (..., 3)
        eye = cam.origin + lens_offset
    hor, ver = cam.horizontal, cam.vertical
    n_f = jnp.cross(hor, ver)

    g = p - eye
    g_nf = jnp.sum(g * n_f, axis=-1)
    ok = jnp.abs(g_nf) > 1e-12
    s = jnp.sum(a_vec * n_f, axis=-1) / jnp.where(ok, g_nf, 1.0)
    # s > 0: p is on the forward side of the film direction.
    valid = ok & (s > 0.0)
    w = s[..., None] * g - a_vec

    h_star = jnp.cross(ver, n_f)
    h_star = h_star / jnp.sum(hor * h_star)
    v_star = jnp.cross(hor, n_f)
    v_star = v_star / jnp.sum(ver * v_star)
    u = jnp.sum(w * h_star, axis=-1)
    b = jnp.sum(w * v_star, axis=-1)
    return jnp.stack([u, 1.0 - b], axis=-1), valid


def _probe_directions(cam: Camera, uv, camera_mode: str, lens_offset=None):
    """Probe-ray origin/direction for screen points (..., 2).

    Central (no-lens) rays by default; through the given thin-lens
    offsets when ``lens_offset`` (..., 3) is passed.
    """
    u, v = uv[..., 0], uv[..., 1]
    film = (cam.lower_left[None, :] + cam.horizontal[None, :] * u[..., None]
            + cam.vertical[None, :] * (1.0 - v)[..., None])
    if camera_mode == "cpu" and lens_offset is not None:
        # Quirk Q2 defocus probes (camera.hxx:51-56).
        o = jnp.broadcast_to(cam.origin + lens_offset, film.shape)
        return o, film - lens_offset
    if camera_mode in ("cuda", "cpu"):
        o = jnp.broadcast_to(cam.origin, film.shape)
        return o, film  # quirk Q11
    if lens_offset is None:
        o = jnp.broadcast_to(cam.origin, film.shape)
        return o, film - cam.origin[None, :]
    o = jnp.broadcast_to(cam.origin + lens_offset, film.shape)
    return o, film - o


def lobe_direction_density(w, axis, f, sample_mode: str, eps: float = 1e-4):
    """Solid-angle density of the reference's scatter draw dir' = axis+f*s.

    ``s`` is uniform in the unit ball under sample_mode == "ball"
    (raytracer.hxx:134/147, quirk Q3) or uniform ON the unit sphere under
    "unit" (cuda_impl.cu:206/220); the scattered DIRECTION is the
    normalization of axis + f*s. Integrating the ball/sphere measure along
    the ray t*w (chord roots t+- = cos +- sqrt(f^2 - sin^2), cos = w.axis):

        ball:  p(w) = (t+^3 - t-^3) / (4 pi f^3)      (roots clamped to 0)
        unit:  p(w) = (t+^2 [t+>0] + t-^2 [t->0]) / (4 pi f sqrt(f^2-sin^2))

    Lambert is the f = 1, axis = normal special case: (2/pi) cos^3 and
    cos/pi respectively. The "unit" density diverges (integrably) at the
    lobe-cone boundary sin = f; ``eps`` floors the sqrt (bias confined to
    directions where the density itself vanishes like the floored factor).

    Args:
      w: (..., 3) unit query directions.
      axis: (..., 3) unit lobe axis; f: (...,) lobe radius (> 0).
    Returns (...,) density (zero outside the support cone).
    """
    c = jnp.sum(w * axis, axis=-1)
    disc = f * f - (1.0 - c * c)
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    tp = jnp.maximum(c + s, 0.0)
    tm = jnp.maximum(c - s, 0.0)
    if sample_mode == "unit":
        num = tp * tp * (tp > 0.0) + tm * tm * (tm > 0.0)
        dens = num / (4.0 * jnp.pi * f * jnp.maximum(s, eps))
    else:  # "ball"
        dens = (tp ** 3 - tm ** 3) / (4.0 * jnp.pi * f ** 3)
    return jnp.where(disc > 0.0, dens, 0.0)


def boundary_surrogate(scene: Scene, cam: Camera, camera_mode: str,
                       cot_image, width: int, height: int, base_key,
                       max_depth: int, options: TraceOptions,
                       n_angles: int = 256, probe_delta: float | None = None,
                       probe_diel_frac: float = PROBE_DIEL_FRAC,
                       _cpu_central_ablation: bool = False):
    """Surrogate scalar whose gradient w.r.t. scene.centers/scene.radii is
    the edge-sampled visibility boundary term of the pixel loss.

    Args:
      scene: the ATTACHED scene (centers/radii carry tangents).
      cot_image: (width*height, 3) dL/dI per pixel (detached) -- zero for
        pixels outside the loss batch.
      base_key: PRNG key for angle stratification jitter + probe paths.
      n_angles: edge samples per sphere (E).
      probe_delta: screen-space half-offset of the two probe rays;
        default 0.3 pixels.
      _cpu_central_ablation: test-only -- restore the pre-round-5
        central-viewpoint approximation for camera_mode="cpu" (the
        measured-error baseline of quirk Q2's aperture integration).
    Returns a scalar; add ``s - stop_gradient(s)`` to the loss.
    """
    from . import rng
    from .integrate import trace_fast  # local: avoid an import cycle

    s_count = scene.num_spheres
    e = n_angles
    if probe_delta is None:
        probe_delta = 0.3 / max(width, height)

    # Stratified, jittered angles (unbiased over the circle; one jitter per
    # sphere so samples decorrelate across spheres).
    jit = jax.random.uniform(jax.random.fold_in(base_key, TAG_EDGE_PHI),
                             (s_count, 1))
    phis = (jnp.arange(e)[None, :] + jit) * (2.0 * jnp.pi / e)

    # Thin-lens aperture integration: each edge sample draws its own lens
    # point and the whole chain (silhouette viewpoint, projection, probe
    # rays) runs through it -- the MC average over samples is then the
    # lens-averaged boundary term. Other modes use the central viewpoint.
    # (static branch on the mode only: cam may be traced under jit, and a
    # zero aperture just draws zero offsets -- the central viewpoint.)
    if camera_mode == "thinlens":
        lu = jax.random.uniform(jax.random.fold_in(base_key, TAG_EDGE_LENS),
                                (s_count, e, 2))
        l0, l1 = rng.disk_from_uv(lu[..., 0], lu[..., 1])
        l0, l1 = l0 * cam.lens_radius, l1 * cam.lens_radius
        lens_off = (cam.basis_u[None, None, :] * l0[..., None]
                    + cam.basis_v[None, None, :] * l1[..., None])
        eye = cam.origin + lens_off
        cpu_rd = None
    elif camera_mode == "cpu" and not _cpu_central_ablation:
        # Quirk-Q2 aperture integration: the CPU path's defocus draws a
        # unit-BALL sample rd and
        # scales the WORLD-axis offset by the ray's own screen coords
        # (camera.hxx:51-56): off(u, v) = (u*rd.x, v*rd.y, 0) *
        # lens_radius, origin += off, direction = film(u, v) - off. The
        # offset depends on the screen point being solved for, so the
        # lens-sampled edge position is a FIXED POINT in (u, v): two
        # Picard iterations from the central projection (detached)
        # leave an O(aperture^2) residual, and a final pass through the
        # ATTACHED scene keeps the screen-scaling feedback channel of
        # d(off)/d(theta) in the gradient. FD-validated:
        # test_boundary_grad_cpu_mode_aperture_integration.
        lu = jax.random.uniform(jax.random.fold_in(base_key, TAG_EDGE_LENS),
                                (s_count, e, 3))
        bx, by, _bz = rng.unit_from_uv(lu[..., 0], lu[..., 1])
        rcube = lu[..., 2] ** (1.0 / 3.0)
        cpu_rd = (bx * rcube * cam.lens_radius,
                  by * rcube * cam.lens_radius)  # (S, E) each

        def cpu_off(uv):
            return jnp.stack(
                [uv[..., 0] * cpu_rd[0], uv[..., 1] * cpu_rd[1],
                 jnp.zeros_like(cpu_rd[0])], axis=-1)

        cen_det = jax.lax.stop_gradient(scene.centers)
        rad_det = jax.lax.stop_gradient(scene.radii)
        p_fp, _ = silhouette_points(cen_det, rad_det, cam.origin, phis)
        x_fp, _ = project_to_screen(cam, p_fp, "cpu", None)
        for _ in range(2):
            off_det = cpu_off(jax.lax.stop_gradient(x_fp))
            p_fp, _ = silhouette_points(cen_det, rad_det,
                                        cam.origin + off_det, phis)
            x_fp, _ = project_to_screen(cam, p_fp, "cpu", off_det)
        off_det = cpu_off(jax.lax.stop_gradient(x_fp))
        p_pre, _ = silhouette_points(scene.centers, scene.radii,
                                     cam.origin + off_det, phis)
        x_pre, _ = project_to_screen(cam, p_pre, "cpu", off_det)
        lens_off = cpu_off(x_pre)  # attached through x_pre
        eye = cam.origin + lens_off
    else:
        lens_off = None
        eye = cam.origin
        cpu_rd = None

    # Silhouette curve and its screen projection, attached to theta.
    p, sphere_ok = silhouette_points(scene.centers, scene.radii, eye, phis)
    x, proj_ok = project_to_screen(cam, p, camera_mode, lens_off)  # (S,E,2)

    # Curve tangent dx/dphi via one jvp through the same chain (detached).
    def x_of_phi(ph):
        pp, _ = silhouette_points(jax.lax.stop_gradient(scene.centers),
                                  jax.lax.stop_gradient(scene.radii),
                                  eye, ph)
        xx, _ = project_to_screen(cam, pp, camera_mode, lens_off)
        return xx

    _, tau = jax.jvp(x_of_phi, (phis,), (jnp.ones_like(phis),))
    x_det = jax.lax.stop_gradient(x)

    # Screen normal: rotate the tangent 90 degrees, oriented OUTWARD (away
    # from the projected center -- the projected region is convex).
    n_raw = jnp.stack([tau[..., 1], -tau[..., 0]], axis=-1)
    x_c, _ = project_to_screen(
        cam,
        jnp.broadcast_to(jax.lax.stop_gradient(scene.centers)[:, None, :],
                         (s_count, e, 3)),
        camera_mode, lens_off)  # (S, E, 2)
    outward = jnp.sum(n_raw * (x_det - x_c), axis=-1)
    sign = jnp.where(outward >= 0.0, 1.0, -1.0)
    tau_norm = jnp.linalg.norm(n_raw, axis=-1)
    n_unit = (n_raw * sign[..., None]
              / jnp.maximum(tau_norm, 1e-12)[..., None])

    # Pixel lookup + on-screen mask.
    u, v = x_det[..., 0], x_det[..., 1]
    on_screen = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    valid = sphere_ok & proj_ok & on_screen & (tau_norm > 1e-12)
    ix = jnp.clip((u * width).astype(jnp.int32), 0, width - 1)
    iy = jnp.clip((v * height).astype(jnp.int32), 0, height - 1)
    pid = iy * width + ix
    cot = cot_image[pid.reshape(-1)].reshape(s_count, e, 3)

    # Probe radiance just inside/outside the edge. Common random numbers
    # (one key per edge sample, shared by both probes) cancel the path
    # noise wherever the two sides see the same geometry.
    # DIELECTRIC spheres get a DEEP inside probe (round 4, the same
    # failure family as branchprob's dielectric-rim deep probe): just
    # inside a glass silhouette sits a grazing band (Fresnel -> 1,
    # extreme deflection) whose radiance reads like the outside, so a
    # 0.3-px probe measures jump ~ 0 -- on a glass-on-black-field
    # reproducer the rim's true step (black field -> bright deflection
    # annulus) is invisible to the tight probe. Probing
    # probe_diel_frac of the projected radius inside (capped at 49%)
    # clears the band; the band translates rigidly with the rim, so the
    # step model stays consistent. Note the lensed INTERIOR edges of a
    # glass projection (the image of whatever sits behind it) are NOT
    # this term's job -- they are chain crossings, handled by
    # branchprob's direction-sweep (rr_grad).
    scene_det = jax.lax.stop_gradient(scene)
    from ..models.scene import DIELECTRIC
    is_diel_s = (scene_det.mtype[scene_det.material_index]
                 == DIELECTRIC)  # (S,)
    r_proj = jnp.linalg.norm(x_det - x_c, axis=-1)  # (S, E) screen radius
    delta_in = jnp.where(
        is_diel_s[:, None],
        jnp.minimum(jnp.maximum(probe_delta, probe_diel_frac * r_proj),
                    0.49 * r_proj),
        probe_delta)
    uv_in = x_det - delta_in[..., None] * n_unit
    uv_out = x_det + probe_delta * n_unit
    if cpu_rd is not None:
        # Each probe ray re-derives its own quirk-Q2 offset from ITS
        # screen point (the renderer scales by the sampled pixel's
        # coords); O(probe_delta * aperture) from the edge sample's.
        o_in, d_in = _probe_directions(cam, uv_in, camera_mode,
                                       cpu_off(uv_in))
        o_out, d_out = _probe_directions(cam, uv_out, camera_mode,
                                         cpu_off(uv_out))
    else:
        o_in, d_in = _probe_directions(cam, uv_in, camera_mode, lens_off)
        o_out, d_out = _probe_directions(cam, uv_out, camera_mode,
                                         lens_off)
    flat_idx = jnp.arange(s_count * e, dtype=jnp.int32)
    pkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(base_key, TAG_EDGE_PROBE), flat_idx)
    o_all = jnp.concatenate([o_in.reshape(-1, 3), o_out.reshape(-1, 3)])
    d_all = jnp.concatenate([d_in.reshape(-1, 3), d_out.reshape(-1, 3)])
    k_all = jnp.concatenate([pkeys, pkeys])
    f_all = trace_fast(scene_det, jax.lax.stop_gradient(o_all),
                       jax.lax.stop_gradient(d_all), k_all, max_depth,
                       _probe_options(options), rr_qcap=PROBE_RR_QCAP)
    f_in = f_all[:s_count * e].reshape(s_count, e, 3)
    f_out = f_all[s_count * e:].reshape(s_count, e, 3)

    # Per-sample detached weight; the only attached factor is x(theta).
    w = (jnp.sum(cot * (f_in - f_out), axis=-1)
         * tau_norm * (2.0 * jnp.pi / e) * (width * height))
    w = jnp.where(valid, w, 0.0)
    w = jax.lax.stop_gradient(w)
    return jnp.sum(w * jnp.sum(x * jax.lax.stop_gradient(n_unit), axis=-1))


def secondary_boundary_surrogate(scene: Scene, cam: Camera,
                                 camera_mode: str, cot, pixel_ids,
                                 width: int, height: int, base_key,
                                 max_depth: int, options: TraceOptions,
                                 n_angles: int = 8, n_spheres: int = 2,
                                 probe_delta: float = 2e-3,
                                 vertex_depth: int = 0,
                                 probe_diel_frac: float = PROBE_DIEL_FRAC):
    """Surrogate scalar for the ONE-BOUNCE visibility boundary term.

    The continuation integral at a lambert or fuzzy-metal vertex y is
    I(y) = integral over directions of p(w) L(y, w) dw with p the
    analytic scatter-lobe density (``lobe_direction_density``: axis = the
    shading normal, radius 1 for lambert; axis = the mirror direction,
    radius = roughness for metal, times the below-surface absorption
    indicator of raytracer.hxx:152-155). L(y, w) flips discontinuously
    across sphere silhouettes AS SEEN FROM y (raytracer.hxx:52-92's
    hit/miss flip one bounce deep), contributing

        dI/dtheta |_edge = oint_{C_j(y)} p(w) (L_in - L_out)
                                        (dw/dtheta . n_perp) dsigma(w)

    over each sphere j's silhouette circle C_j(y) mapped onto the unit
    direction sphere (dsigma arc length, n_perp the outward in-tangent-
    plane curve normal). This is the gradient that moves a SHADOW (the
    sky-occlusion dimming under a sphere) when its caster moves --
    invisible to interior AD and to the primary boundary term alike.

    Estimator: one jittered primary vertex per batch pixel (the pixel-
    footprint/lens average, sampled with the renderer's own key
    contract on a dedicated branch), ``n_spheres`` candidate spheres per
    vertex drawn proportional to subtended solid angle (unbiased via
    1/(K q)), ``n_angles`` stratified silhouette angles per candidate,
    two probe continuation rays per angle straddling the edge with
    common random numbers (continuation depth max_depth-1-vertex_depth,
    detached scene). Vertices whose ray misses, lands on a dielectric or
    a perfect mirror (fuzz <= 1e-3: delta lobe), or sees no candidate
    sphere contribute zero.

    vertex_depth > 0 places the vertex DEEPER along the path: the
    jittered camera ray is walked ``vertex_depth`` scatter steps with
    the renderer's own draw contract (rng.bounce_draws -> ops/scatter,
    any material in the prefix -- including specular chains -- with the
    albedo product and metal-absorb/miss liveness folded into the
    throughput), and the edge term is evaluated at the resulting vertex.
    Summing depths 0..D-2 covers the path-space boundary term at
    diffuse/glossy vertices, including the final hop's vertex-motion
    (receiver) component AND the prefix hops' motion (the walk runs on
    the attached scene -- see the step-1 note below); the residual
    approximation is delta-lobe (mirror/dielectric) VERTICES, whose
    terms live in ops/branchprob.py (module docstring).

    Args:
      cot: (P, 3) dL/dI for exactly the ``pixel_ids`` batch (detached).
      probe_delta: angular half-offset (radians) of the probe pair;
        clamped per candidate to half its cone half-angle so thin/far
        spheres keep an inside probe that actually hits.
      probe_diel_frac: deep-inside-probe fraction for DIELECTRIC
        candidates (the grazing-band treatment shared with
        boundary_surrogate, where it is FD-validated on the glass-rim
        reproducer). Honest status HERE: on a glass-shadow reproducer
        (gray ground, glass overhead, black occluder above it) the
        term's isolated contribution could not be FD-separated -- the
        config's truth (-0.017 +- 0.005 d/d r_glass) is dominated by
        the depth-1 delta-lobe channels of rays entering the glass
        directly (branchprob territory), and both probe depths read a
        small positive rim term (tight +0.009, deep +0.007). The deep
        probe ships for consistency with the validated camera-level
        treatment; the glass-shadow family stays on the measured
        residual list (ops/branchprob.py docstring).
    Returns a scalar; add ``s - stop_gradient(s)`` to the loss.
    """
    from . import math3
    from .integrate import _bounce_step, trace_fast
    from .intersect import closest_hit, hit_surface
    from ..models.scene import LAMBERT, METAL
    from ..render import make_primary_rays

    p_count = pixel_ids.shape[0]
    k, e = n_spheres, n_angles
    pk = p_count * k
    scene_det = jax.lax.stop_gradient(scene)

    # 1. One vertex per batch pixel: jittered primary ray, walked
    # ``vertex_depth`` bounces of the INTEGRATOR'S OWN step
    # (integrate._bounce_step: same gather path, draw contract, and
    # liveness rule as the renderer -- one source of truth; the radiance
    # accumulator it carries is simply unused here). The walk runs on
    # the ATTACHED scene: with the random draws fixed, each prefix hop's
    # position/normal/scattered direction is a smooth function of theta
    # (the reparameterized path), so the resulting vertex y(theta) and
    # edge directions carry the PREFIX-MOTION boundary component -- a
    # shadow sweeping because the surface the path bounced off EARLIER
    # moved (e.g. a mirror steering the view). Discrete outcomes inside
    # the step (hit/miss flips, RR branch picks, metal absorb) are
    # comparisons and carry no tangent, and every sampling DECISION
    # downstream (candidate probabilities, lobe density, probe rays)
    # still uses the stop_gradient'ed copies below.
    vkey = jax.random.fold_in(base_key, TAG_EDGE2_VERTEX)
    o, d, ray_keys = make_primary_rays(cam, pixel_ids,
                                       jnp.zeros_like(pixel_ids), vkey,
                                       width, height, camera_mode)
    state = (o, d, jnp.ones((p_count, 3), jnp.float32),
             jnp.zeros((p_count, 3), jnp.float32),
             jnp.ones((p_count,), bool), ray_keys)
    for b in range(vertex_depth):
        state = _bounce_step(scene, options, state, b)
    o, d, path_alb, _, alive, _ = state
    path_alb = jax.lax.stop_gradient(path_alb)
    # The FINAL hop runs on the ATTACHED scene: the vertex position
    # y(theta) rides the receiver sphere it lands on (closest_hit's t and
    # hit_surface's gathered center/radius are differentiable), so the
    # edge direction w_e = normalize(p_sil(theta) - y(theta)) carries the
    # RECEIVER-MOTION boundary component -- the shadow sweeping because
    # its receiver moves -- not just the occluder-motion one. (Measured
    # without this: AD undershoots FD by ~17% on the shadow scene's
    # ground c_y/radius.) Prefix-hop motion (vertex_depth >= 1) rides
    # the attached walk above.
    t_a, idx, hit = closest_hit(o, d, scene.centers, scene.radii,
                                options.t_min, options.sphere_block)
    y_att, n_att = hit_surface(o, d, t_a, idx, hit, scene.centers,
                               scene.radii)
    y, n_y = (jax.lax.stop_gradient(y_att), jax.lax.stop_gradient(n_att))
    mi = scene_det.material_index[idx]
    mt_v = scene_det.mtype[mi]
    fuzz_v = scene_det.fuzz[mi]
    is_metal_v = mt_v == METAL
    # Lobe of the continuation draw at the vertex (ops/scatter.py): axis =
    # normal with radius 1 for lambert, mirror direction with radius =
    # roughness for metal. Perfect mirrors (delta lobe) stay out of scope.
    axis_lobe = jnp.where(is_metal_v[:, None],
                          math3.reflect(math3.normalize(d), n_y), n_y)
    f_lobe = jnp.where(is_metal_v, jnp.maximum(fuzz_v, 1e-3), 1.0)
    active = (alive & hit
              & ((mt_v == LAMBERT) | (is_metal_v & (fuzz_v > 1e-3))))
    # Camera->continuation throughput at the vertex: the prefix albedo
    # product times the vertex material's albedo, folded with the pixel
    # cotangent.
    thru = cot * path_alb * scene_det.albedo[mi]  # (P, 3)

    # 2. Candidate spheres per vertex ~ solid angle, dropping spheres the
    # vertex sits on/inside (no silhouette) and caps entirely below the
    # hemisphere (gamma - beta > pi/2 <=> mu < -sin beta: every edge
    # direction then has cos <= 0 and the integrand vanishes).
    m = scene_det.centers[None] - y[:, None]  # (P, S, 3) vertex->center
    dist = jnp.linalg.norm(m, axis=-1)
    rho = jnp.abs(scene_det.radii)[None]
    sil_ok = dist > rho * (1.0 + 1e-5)
    dist_safe = jnp.where(sil_ok, dist, 1.0)
    sin_b = jnp.clip(rho / dist_safe, 0.0, 1.0)  # cone half-angle sine
    cos_b = jnp.sqrt(1.0 - sin_b * sin_b)
    mu = jnp.sum(m * n_y[:, None], axis=-1) / dist_safe
    q = jnp.where(sil_ok & (mu > -sin_b), 1.0 - cos_b, 0.0)
    q_sum = jnp.sum(q, axis=-1, keepdims=True)
    has_any = q_sum[:, 0] > 0.0
    q = q / jnp.where(q_sum > 0.0, q_sum, 1.0)

    logits = jnp.where(q > 0.0, jnp.log(jnp.maximum(q, 1e-30)), -jnp.inf)
    # All--inf rows would NaN categorical; flatten them (masked by has_any).
    logits = jnp.where(has_any[:, None], logits, 0.0)
    j_sel = jax.random.categorical(
        jax.random.fold_in(base_key, TAG_EDGE2_SPHERE),
        logits[:, None, :], axis=-1, shape=(p_count, k))
    q_sel = jnp.take_along_axis(q, j_sel, axis=-1)  # (P, K)
    sin_b_sel = jnp.take_along_axis(sin_b, j_sel, axis=-1)
    j_flat = j_sel.reshape(-1)

    # 3. Silhouette of each candidate from its vertex: the same analytic
    # frame as the primary term with eye = the vertex (ATTACHED gathers
    # of the candidate centers/radii carry the theta dependence).
    c_sel = scene.centers[j_flat]  # (P*K, 3) attached
    r_sel = scene.radii[j_flat]
    y_rep = jnp.repeat(y, k, axis=0)  # (P*K, 3) detached
    eye = jnp.broadcast_to(y_rep[:, None, :], (pk, e, 3))
    # Attached viewpoint for the edge-direction chain only (see the
    # final-hop note above): w_e(theta) moves with candidate AND vertex.
    eye_att = jnp.broadcast_to(jnp.repeat(y_att, k, axis=0)[:, None, :],
                               (pk, e, 3))
    ajit = jax.random.uniform(jax.random.fold_in(base_key, TAG_EDGE2_PHI),
                              (pk, 1))
    phis = (jnp.arange(e)[None, :] + ajit) * (2.0 * jnp.pi / e)
    p_sil, val_sil, _ = silhouette_frame(c_sel, r_sel, eye_att, phis)
    w_att = math3.normalize(p_sil - eye_att)  # (P*K, E, 3) attached

    # Curve tangent dw/dphi on the direction sphere (detached chain).
    def w_of_phi(ph):
        pp, _, _ = silhouette_frame(jax.lax.stop_gradient(c_sel),
                                    jax.lax.stop_gradient(r_sel), eye, ph)
        return math3.normalize(pp - eye)

    _, tau = jax.jvp(w_of_phi, (phis,), (jnp.ones_like(phis),))
    w_dir = jax.lax.stop_gradient(w_att)
    tau_norm = jnp.linalg.norm(tau, axis=-1)

    # Outward in-tangent-plane curve normal: perpendicular to tangent and
    # direction, oriented away from the cap axis.
    axis = math3.normalize(jax.lax.stop_gradient(c_sel) - y_rep)
    n_perp = jnp.cross(tau, w_dir)
    outward = jnp.sum(n_perp * (w_dir - axis[:, None, :]), axis=-1)
    sign = jnp.where(outward >= 0.0, 1.0, -1.0)
    n_perp = (n_perp * sign[..., None]
              / jnp.maximum(tau_norm, 1e-12)[..., None])

    # Scatter-lobe density at the edge directions. For lambert (axis = n,
    # f = 1) this is the classic cos/pi ("unit") or (2/pi)cos^3 ("ball")
    # and already vanishes below the horizon; metal additionally zeroes
    # below-surface directions (the absorb of raytracer.hxx:152-155 --
    # those continuations contribute black, so no edge flip either).
    n_y_rep = jnp.repeat(n_y, k, axis=0)
    axis_rep = jnp.repeat(axis_lobe, k, axis=0)
    f_rep = jnp.repeat(f_lobe, k, axis=0)[:, None]
    dens = lobe_direction_density(w_dir, axis_rep[:, None, :], f_rep,
                                  options.scatter_sample)
    cos_i = jnp.sum(w_dir * n_y_rep[:, None, :], axis=-1)
    dens = dens * (cos_i > 0.0)

    # 4. Probe radiance just inside/outside the edge (common random
    # numbers; depth max_depth-1-vertex_depth = the continuation budget).
    # DIELECTRIC candidates get the deep inside probe (the grazing-band
    # treatment shared with boundary_surrogate and branchprob's chain
    # probes): just inside a glass cone edge the band's radiance reads
    # like the outside, so the tight probe misses the step.
    beta_sel = jnp.arcsin(sin_b_sel).reshape(pk)[:, None, None]
    delta = jnp.minimum(probe_delta, 0.5 * beta_sel)
    from ..models.scene import DIELECTRIC as _DIEL
    cand_diel = (scene_det.mtype[scene_det.material_index[j_flat]]
                 == _DIEL).reshape(pk)[:, None, None]
    delta_in = jnp.where(
        cand_diel,
        jnp.minimum(jnp.maximum(delta, probe_diel_frac * beta_sel),
                    0.49 * beta_sel),
        delta)
    w_in = math3.normalize(w_dir - delta_in * n_perp)
    w_out = math3.normalize(w_dir + delta * n_perp)
    o_rep = jnp.broadcast_to(y_rep[:, None, :], (pk, e, 3)).reshape(-1, 3)
    pkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(base_key, TAG_EDGE2_PROBE),
        jnp.arange(pk * e, dtype=jnp.int32))
    o_all = jnp.concatenate([o_rep, o_rep])
    d_all = jnp.concatenate([w_in.reshape(-1, 3), w_out.reshape(-1, 3)])
    k_all = jnp.concatenate([pkeys, pkeys])
    f_all = trace_fast(scene_det, o_all, d_all, k_all,
                       max(max_depth - 1 - vertex_depth, 0),
                       _probe_options(options), rr_qcap=PROBE_RR_QCAP)
    f_in = f_all[:pk * e].reshape(pk, e, 3)
    f_out = f_all[pk * e:].reshape(pk, e, 3)

    # 5. Detached weight; the only attached factor is w(theta).
    thru_rep = jnp.repeat(thru * active[:, None].astype(thru.dtype),
                          k, axis=0)  # (P*K, 3)
    inv_kq = jnp.where(q_sel > 0.0,
                       1.0 / (k * jnp.where(q_sel > 0.0, q_sel, 1.0)),
                       0.0).reshape(pk)
    w = (jnp.sum(thru_rep[:, None, :] * (f_in - f_out), axis=-1)
         * dens * tau_norm * (2.0 * jnp.pi / e) * inv_kq[:, None])
    valid = val_sil & (tau_norm > 1e-12)
    w = jax.lax.stop_gradient(jnp.where(valid, w, 0.0))
    return jnp.sum(w * jnp.sum(w_att * jax.lax.stop_gradient(n_perp),
                               axis=-1))
