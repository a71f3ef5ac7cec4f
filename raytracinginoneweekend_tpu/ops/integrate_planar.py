"""Planar (R, 128) differentiable integrator: the fast AD engine.

The tiled AD path (ops/integrate.trace over (N, 3) arrays) works on
(N, 3) arrays with strided component extraction. This module is the
wavefront engine's PLANAR formulation made reverse-mode differentiable:

  * ray state is (R, 128) planes end to end (camera generation included,
    ops/planar.py);
  * closest-hit runs the forward-only ops/pallas_segment.closest_hit
    (the Triton kernel on the GPU) wrapped in a custom VJP whose
    backward pass is the same analytic implicit-function formula as
    ops/intersect.closest_hit_diff -- O(N) elementwise plus one
    one-hot product, no (N, S) candidate transpose, and the
    non-differentiable kernel becomes legal under reverse-mode AD;
  * per-ray sphere/material parameters come from ONE one-hot matmul
    against a differentiable (S, 10) table at HIGHEST precision (an
    exact gather; its transpose -- the table gradient -- is another
    matmul);
  * the scatter/material math is the wavefront segment's planar code with
    AD-safe double-where guards (sqrt/normalize never see values whose
    backward would be inf on masked lanes);
  * bounces run under lax.scan with per-step rematerialization
    (jax.checkpoint): backward memory O(R*128), not O(R*128*depth).

RNG discipline is EXACTLY ops/rng.py's contract v3 (the planar helpers
run the same threefry blocks on raw (R, 128) key-word planes), so
radiance agrees per-ray with the tiled engine, the wavefront engine and
the scalar oracle.

Semantics parity (reference): same bounce-loop contract as
ops/integrate.py -- hit -> scatter -> attenuation *= albedo; metal absorb
-> black; miss -> sky * attenuation; depth exhausted -> black
(main.cxx:52-75, cuda_impl.cu:265-297).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import DIELECTRIC, METAL, Scene
from . import planar, rng
from .pallas_segment import BLOCK, closest_hit

LANES = 128
# Planar layouts are padded to whole kernel blocks of rows.
ROW_MULTIPLE = max(1, BLOCK // LANES)
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)  # main.cxx:49; cuda_impl.cu:125


# ---------------------------------------------------------------------------
# Planar closest hit with analytic backward (custom VJP around the kernel)
# ---------------------------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def closest_hit_planar(rays, geom, t_min):
    """Differentiable closest hit over planar rays.

    Args:
      rays: 6-tuple of (R, 128) f32 planes (ox oy oz dx dy dz).
      geom: (centers (S, 3), radii (S,)) -- the differentiable leaves.
      t_min: static.
    Returns (t, sphere_idx, hit_i): (R, 128) planes (f32, i32, i32).

    Backward: implicit differentiation of the winning sphere's quadratic
    F = |o + t d - c|^2 - r^2 = 0 (see ops/intersect.closest_hit_diff) --
    dt = [(p-c).dc + r dr - (p-c).do - t (p-c).dd] / ((p-c).d).
    """
    return _chp_fwd_impl(rays, geom, t_min)


def _chp_fwd_impl(rays, geom, t_min):
    centers, radii = geom
    hit_i, t, sb = closest_hit(
        rays, centers[:, 0], centers[:, 1], centers[:, 2], radii, t_min)
    return t, sb, hit_i


def _chp_fwd(rays, geom, t_min):
    out = _chp_fwd_impl(rays, geom, t_min)
    t, sb, hit_i = out
    return out, (rays, geom, t, sb, hit_i)


def _chp_bwd(t_min, res, g):
    rays, (centers, radii), t, sb, hit_i = res
    g_t = g[0]  # idx/hit are integer outputs: zero cotangent
    ox, oy, oz, dx, dy, dz = rays
    hit = hit_i > 0
    s = centers.shape[0]
    r_total = ox.shape[0]

    # Winning sphere's center/radius: exact one-hot gather.
    oh = (sb.reshape(-1, 1) == jnp.arange(s, dtype=sb.dtype)[None, :]
          ).astype(jnp.float32)
    ctab = jnp.concatenate([centers, radii[:, None]], axis=1)  # (S, 4)
    p4 = jnp.dot(oh, ctab.astype(jnp.float32), precision=_HI,
                 preferred_element_type=jnp.float32)

    def col(i):
        return p4[:, i].reshape(r_total, LANES)

    chx, chy, chz, rh = col(0), col(1), col(2), col(3)
    t_safe = jnp.where(hit, t, 1.0)
    pcx = ox + t_safe * dx - chx
    pcy = oy + t_safe * dy - chy
    pcz = oz + t_safe * dz - chz
    denom = pcx * dx + pcy * dy + pcz * dz  # (p-c).d
    # Grazing hits (denom -> 0) have unbounded dt; zero them like the
    # sanitized no-hit lanes (standard for silhouette-adjacent samples).
    good = hit & (jnp.abs(denom) > 1e-12)
    scale = jnp.where(good, g_t / jnp.where(good, denom, 1.0), 0.0)

    gcx, gcy, gcz = scale * pcx, scale * pcy, scale * pcz  # dt/dc rows
    g_r_rows = scale * rh  # dt/dr = r/denom
    # Per-sphere accumulation as a transposed one-hot matmul (reusing
    # oh): the same masked sum as a scatter-add -- rows with scale = 0
    # (no hit / grazing) contribute nothing regardless of their sb.
    g4 = jnp.stack([gcx.reshape(-1), gcy.reshape(-1), gcz.reshape(-1),
                    g_r_rows.reshape(-1)], axis=-1)  # (N, 4)
    acc = jnp.dot(oh.T, g4, precision=_HI,
                  preferred_element_type=jnp.float32)  # (S, 4)
    g_centers = acc[:, :3]
    g_radii = acc[:, 3]
    g_rays = (-gcx, -gcy, -gcz,
              -t_safe * gcx, -t_safe * gcy, -t_safe * gcz)
    return g_rays, (g_centers, g_radii)


closest_hit_planar.defvjp(_chp_fwd, _chp_bwd)


# ---------------------------------------------------------------------------
# One differentiable planar bounce
# ---------------------------------------------------------------------------

def _material_table(scene: Scene):
    """Differentiable per-sphere (S, 10) parameter table:
    [cx cy cz r mtype ar ag ab fuzz ior] (only (S,)-sized gathers)."""
    mi = scene.material_index
    alb = scene.albedo[mi]
    return jnp.concatenate([
        scene.centers,
        scene.radii[:, None],
        scene.mtype[mi].astype(jnp.float32)[:, None],
        alb,
        scene.fuzz[mi][:, None],
        scene.ior[mi][:, None],
    ], axis=1)


@jax.custom_vjp
def _onehot_gather(sb_flat, table):
    """params[i] = table[sb_flat[i]] via an exact one-hot matmul.

    The custom VJP builds one one-hot per direction and saves only the
    winner indices (plain AD of the product would keep the (N, S)
    one-hot alive for the rematerialized forward and the transpose).
    Entries are 0/1 with one nonzero per row and both products run at
    HIGHEST precision, so the forward is the table entry bit for bit.
    """
    oh = (sb_flat[:, None] == jnp.arange(table.shape[0],
                                         dtype=sb_flat.dtype)[None, :]
          ).astype(jnp.float32)
    return jnp.dot(oh, table, precision=_HI,
                   preferred_element_type=jnp.float32)


def _ohg_fwd(sb_flat, table):
    return _onehot_gather(sb_flat, table), (sb_flat, table.shape[0])


def _ohg_bwd(res, d_out):
    import numpy as np

    sb_flat, s = res
    oh = (sb_flat[:, None] == jnp.arange(s, dtype=sb_flat.dtype)[None, :]
          ).astype(jnp.float32)
    d_table = jnp.dot(oh.T, d_out, precision=_HI,
                      preferred_element_type=jnp.float32)
    return np.zeros(sb_flat.shape, dtype=jax.dtypes.float0), d_table


_onehot_gather.defvjp(_ohg_fwd, _ohg_bwd)


def shade_geometry_planar(state6, khit, params_cols):
    """Hit position + outward normal from the one-hot-gathered winner.

    state6: (ox..dz) planes; params_cols: (chx, chy, chz, rh) winner
    geometry columns. Shared by the fixed-depth and regenerative AD
    engines (ops/wavefront_ad.py) so per-ray values stay bit-equal."""
    ox, oy, oz, dx, dy, dz = state6
    t, sb, hit_i = khit
    hit = hit_i > 0
    chx, chy, chz, rh = params_cols
    t_safe = jnp.where(hit, t, 1.0)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    r_safe = jnp.where(hit, rh, 1.0)
    inv_r = 1.0 / jnp.where(r_safe != 0.0, r_safe, 1.0)
    nx = (px - chx) * inv_r
    ny = (py - chy) * inv_r
    nz = (pz - chz) * inv_r
    return hit, px, py, pz, nx, ny, nz


def scatter_planar_ad(dirs, normals, mats, draws, options: TraceOptions):
    """The per-material scatter math with AD-safe double-where guards.

    dirs: (dx, dy, dz); normals: (nx, ny, nz); mats: (mt, fz, io);
    draws: (rvx, rvy, rvz, ru) from planar.bounce_draws. Returns
    (ndx, ndy, ndz, valid, uy) with uy the unit-direction y (for the
    sky term). Identical op sequence for every reverse-mode engine
    (fixed-depth scan and the regenerative pool), so per-ray radiance
    is bit-equal across them. Semantics: lambert cuda_impl.cu:204-213,
    metal :216-229, dielectric :232-262 (Schlick + TIR)."""
    dx, dy, dz = dirs
    nx, ny, nz = normals
    mt, fz, io = mats
    rvx, rvy, rvz, ru = draws

    ux, uy, uz = planar.normalize3(dx, dy, dz)

    # lambert (cuda_impl.cu:204-213)
    ldx, ldy, ldz = nx + rvx, ny + rvy, nz + rvz
    # metal (cuda_impl.cu:216-229)
    du = ux * nx + uy * ny + uz * nz
    rfx = ux - 2.0 * du * nx
    rfy = uy - 2.0 * du * ny
    rfz = uz - 2.0 * du * nz
    mdx, mdy, mdz = rfx + rvx * fz, rfy + rvy * fz, rfz + rvz * fz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
    # dielectric (cuda_impl.cu:232-262) with AD-safe sqrt guards
    cos = du
    entering = cos <= 0.0
    sgn = jnp.where(entering, 1.0, -1.0)
    owx, owy, owz = nx * sgn, ny * sgn, nz * sgn
    ri = jnp.where(entering, 1.0 / jnp.where(io != 0.0, io, 1.0), io)
    cosab = jnp.abs(cos)
    cos_i = owx * ux + owy * uy + owz * uz
    kk = 1.0 - ri * ri * (1.0 - cos_i * cos_i)
    pos = kk > 0.0
    # double-where: sqrt never sees <=0, so its backward never sees inf
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, kk, 1.0)), 0.0)
    tir = kk < 0.0
    if options.refract == "physical":
        tx = ri * ux - (ri * cos_i + sq) * owx
        ty = ri * uy - (ri * cos_i + sq) * owy
        tz = ri * uz - (ri * cos_i + sq) * owz
    else:
        # math.hxx:304-308: dot*eta broadcast-added per component.
        tx = ux * ri - (owx * sq + cos_i * ri)
        ty = uy * ri - (owy * sq + cos_i * ri)
        tz = uz * ri - (owz * sq + cos_i * ri)
    tx = jnp.where(tir, 0.0, tx)
    ty = jnp.where(tir, 0.0, ty)
    tz = jnp.where(tir, 0.0, tz)
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cosab) ** 5
    prob = jnp.where(tir, 1.0, schlick)
    refl = ru < prob
    gdx = jnp.where(refl, rfx, tx)
    gdy = jnp.where(refl, rfy, ty)
    gdz = jnp.where(refl, rfz, tz)

    is_metal = mt == METAL
    is_diel = mt == DIELECTRIC
    ndx = jnp.where(is_diel, gdx, jnp.where(is_metal, mdx, ldx))
    ndy = jnp.where(is_diel, gdy, jnp.where(is_metal, mdy, ldy))
    ndz = jnp.where(is_diel, gdz, jnp.where(is_metal, mdz, ldz))
    valid = jnp.where(is_metal, metal_ok, True)
    return ndx, ndy, ndz, valid, uy


def _shade_step_planar(scene: Scene, options: TraceOptions,
                       state, khit, bounce, strat0=None):
    """Everything in a bounce downstream of the closest-hit kernel.

    strat0: optional (svx, svy, svz) replacement planes
    (planar.strat0_scatter_planes) substituted at bounce == 0 -- the
    first-bounce half of sampling="stratified". Loop-invariant (the
    rays are fixed), so callers compute them once outside the scan.
    """
    (ox, oy, oz, dx, dy, dz, ax, ay, az, resr, resg, resb, alive,
     rk0, rk1) = state
    r_total = ox.shape[0]

    t, sb, hit_i = khit

    # One-hot gather of the winning sphere's geometry + material. The
    # one-hot matrix is a piecewise-constant function of sb (no gradient);
    # the TABLE carries the scene-leaf gradients through the matmul
    # transpose (custom VJP: one one-hot per direction).
    table = _material_table(scene)
    params = _onehot_gather(sb.reshape(-1), table)

    def col(i):
        return params[:, i].reshape(r_total, LANES)

    mt = col(4).astype(jnp.int32)
    alr, alg, alb_ = col(5), col(6), col(7)
    fz, io = col(8), col(9)

    hit, px, py, pz, nx, ny, nz = shade_geometry_planar(
        (ox, oy, oz, dx, dy, dz), khit, (col(0), col(1), col(2), col(3)))

    # Per-bounce randomness (ops/rng.py draw-order contract v3);
    # ``bounce`` may be a traced scalar.
    rvx, rvy, rvz, ru = planar.bounce_draws(
        rk0, rk1, bounce, options.scatter_sample == "unit")
    if strat0 is not None:
        m0 = jnp.asarray(bounce, jnp.int32) == 0
        rvx = jnp.where(m0, strat0[0], rvx)
        rvy = jnp.where(m0, strat0[1], rvy)
        rvz = jnp.where(m0, strat0[2], rvz)

    ndx, ndy, ndz, valid, uy = scatter_planar_ad(
        (dx, dy, dz), (nx, ny, nz), (mt, fz, io), (rvx, rvy, rvz, ru),
        options)

    miss_now = alive & ~hit
    scatter_now = alive & hit & valid

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix
    sky_bias = 0.5 if options.sky == "cuda" else 1.0
    tsky = 0.5 * uy + sky_bias
    miss_f = miss_now.astype(jnp.float32)
    resr = resr + miss_f * ax * (SKY_WHITE[0] * (1.0 - tsky)
                                 + SKY_BLUE[0] * tsky)
    resg = resg + miss_f * ay * (SKY_WHITE[1] * (1.0 - tsky)
                                 + SKY_BLUE[1] * tsky)
    resb = resb + miss_f * az * (SKY_WHITE[2] * (1.0 - tsky)
                                 + SKY_BLUE[2] * tsky)

    ox = jnp.where(scatter_now, px, ox)
    oy = jnp.where(scatter_now, py, oy)
    oz = jnp.where(scatter_now, pz, oz)
    dx = jnp.where(scatter_now, ndx, dx)
    dy = jnp.where(scatter_now, ndy, dy)
    dz = jnp.where(scatter_now, ndz, dz)
    ax = jnp.where(scatter_now, ax * alr, ax)
    ay = jnp.where(scatter_now, ay * alg, ay)
    az = jnp.where(scatter_now, az * alb_, az)
    keep = scatter_now
    if options.rr_terminate:
        # RR path termination under AD: the shared contract with
        # stop-gradiented survival weights (rng.rr_terminate_update;
        # here a killed lane saves no time -- fixed trip count -- the
        # point is estimator parity with the wavefront engines).
        from . import rng as _rng
        ax, ay, az, keep = _rng.rr_terminate_update(
            rk0, rk1, jnp.asarray(bounce, jnp.int32), ax, ay, az, keep,
            rr_start=options.rr_start, rr_qmin=options.rr_qmin,
            rr_scale=options.rr_scale)
    return (ox, oy, oz, dx, dy, dz, ax, ay, az, resr, resg, resb,
            keep, rk0, rk1)


def trace_planar(scene: Scene, rays, rkey_words, max_depth: int,
                 options: TraceOptions, strat0=None):
    """Differentiable fixed-depth planar trace -> (resr, resg, resb) planes.

    rays: 6-tuple of (R, 128) planes; rkey_words: (k0, k1) per-ray
    uint32 key-word planes (ops/planar.camera_rays).
    """
    r_total = rays[0].shape[0]
    zero = jnp.zeros((r_total, LANES), jnp.float32)
    one = zero + 1.0
    state = (*rays, one, one, one, zero, zero, zero,
             jnp.ones((r_total, LANES), bool), *rkey_words)

    # Rematerialize the shading glue for backward, but keep the
    # closest hit OUTSIDE the checkpoint boundary: its three (R, 128)
    # output planes per bounce are then saved by scan's AD as inputs of
    # the rematted shade step, so the backward pass never re-runs the
    # kernel (a custom_vjp call is a remat-opaque primitive -- naming its
    # outputs with checkpoint_name cannot spare the replay, because the
    # custom VJP's residuals are the raw pre-name jaxpr vars).
    shade = jax.checkpoint(
        functools.partial(_shade_step_planar, scene, options,
                          strat0=strat0))

    def body(st, bounce):
        t, sb, hit_i = closest_hit_planar(
            st[:6], (scene.centers, scene.radii), options.t_min)
        return shade(st, (t, sb, hit_i), bounce), None

    state, _ = jax.lax.scan(body, state, jnp.arange(max_depth))
    return state[9], state[10], state[11]


# ---------------------------------------------------------------------------
# Pixel-chunk renderer (the planar drop-in for render.render_pixels_impl)
# ---------------------------------------------------------------------------

def render_pixels_planar_impl(scene: Scene, cam: Camera, pixel_ids,
                              base_key, *, width: int, height: int,
                              spp: int, max_depth: int, camera_mode: str,
                              options: TraceOptions,
                              differentiable: bool = True,
                              sample_offset: int = 0,
                              spp_strata: int = 0):
    """Render a flat chunk of pixels -> (P, 3) linear radiance means.

    Signature-compatible with render.render_pixels_impl (wave_spp is
    implicit: the whole P*spp wavefront is one planar wave). Rays are
    laid out ray-major (pixel*spp + sample), padded to the (rows*128)
    layout multiple, and masked out of the pixel reduction.

    sample_offset: render sample ids [offset, offset+spp) instead of
    [0, spp) -- the RNG contract keys on (pixel, sample), so offset
    ranges draw fresh, reproducible samples (adaptive.py's second
    stage).

    spp_strata (stratified only; 0 = spp): the STRATA DENOMINATOR when
    this call renders a sub-window of a larger stratified sample set --
    the remaps (rng.stratify_uv/stratify_lens_uv/strat0) derive each
    sample's stratum from its absolute sid against this total, so
    rendering windows [0, h) and [h, 2h) with spp_strata=2h yields
    exactly the union's stratified draws (adaptive.py stage 1). The
    window must lie inside the strata set; with sampling="iid" it is
    ignored. Offset windows BEYOND the strata set require
    sampling="iid" (a stratum outside [0, spp_strata) is undefined).
    """
    del differentiable  # the planar engine is always the AD-safe scan
    strata = spp_strata or spp
    if options.sampling != "iid" and sample_offset + spp > strata:
        raise ValueError(
            "stratified sample window [%d, %d) exceeds the strata set "
            "[0, %d); pass spp_strata or sampling='iid'"
            % (sample_offset, sample_offset + spp, strata))
    p = pixel_ids.shape[0]
    n = p * spp
    blk = ROW_MULTIPLE * LANES
    n_pad = -(-n // blk) * blk
    r_total = n_pad // LANES

    pid_flat = jnp.repeat(pixel_ids.astype(jnp.int32), spp)
    sid_flat = jnp.tile(
        jnp.arange(sample_offset, sample_offset + spp, dtype=jnp.int32), p)
    pad = n_pad - n
    if pad:
        pid_flat = jnp.concatenate(
            [pid_flat, jnp.zeros((pad,), jnp.int32)])
        sid_flat = jnp.concatenate(
            [sid_flat, jnp.zeros((pad,), jnp.int32)])
    pid = pid_flat.reshape(r_total, LANES)
    sid = sid_flat.reshape(r_total, LANES)

    ox, oy, oz, dx, dy, dz, rk0, rk1 = planar.camera_rays(
        cam, pid, sid, base_key, width, height, camera_mode,
        sampling=options.sampling, spp=strata)
    strat0 = None
    if options.sampling == "stratified":
        # First-bounce stratified scatter: the rays are fixed, so the
        # replacement planes are loop-invariant -- computed once here.
        from .threefry import key_words as _kw
        b0, b1 = _kw(base_key)
        strat0 = planar.strat0_scatter_planes(
            rk0, rk1, pid, sid, b0, b1, strata,
            options.scatter_sample == "unit")
    resr, resg, resb = trace_planar(
        scene, (ox, oy, oz, dx, dy, dz), (rk0, rk1), max_depth, options,
        strat0=strat0)

    def reduce(plane):
        flat = plane.reshape(-1)[:n]
        return flat.reshape(p, spp).sum(axis=1) / spp

    return jnp.stack([reduce(resr), reduce(resg), reduce(resb)], axis=-1)


render_pixels_planar = jax.jit(
    render_pixels_planar_impl,
    static_argnames=("width", "height", "spp", "max_depth", "camera_mode",
                     "options", "differentiable", "sample_offset",
                     "spp_strata"))
