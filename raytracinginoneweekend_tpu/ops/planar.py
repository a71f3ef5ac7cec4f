"""Planar (R, 128) primitives shared by the wavefront and planar-AD engines.

PLANAR layout is the engines' ray-state representation (see
ops/wavefront.py): every per-ray quantity is its own (R, 128) f32/i32
plane, so every op is a full-width elementwise op and nothing ever does a
strided (N, 3) component extraction or a per-ray gather.

Two layers live here:
  * planar draws over the raw-counter contract of ops/rng.py -- the
    threefry blocks run directly on (R, 128) uint32 KEY-WORD planes
    (ops/threefry.py), so the engines carry (k0, k1) planes instead of
    typed key arrays (key_data extraction is a strided relayout; raw
    words make every draw a full-width elementwise op). Draws are
    bit-identical to the scalar ops/rng.py API, which the oracle uses;
  * planar camera-ray generation for all four camera modes (the planar
    re-expression of models/camera.camera_ray, quirks Q1/Q2/Q11 included).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.camera import Camera
from . import rng
from . import threefry as tf
from .math3 import FLT_MIN

LANES = 128


def ray_key_words(base_key, pid, sid):
    """The ops/rng.py ray_key chain on planes: fold base by pid, then sid."""
    b0, b1 = tf.key_words(base_key)
    k0, k1 = tf.fold_in_words(jnp.broadcast_to(b0, pid.shape),
                              jnp.broadcast_to(b1, pid.shape), pid)
    return tf.fold_in_words(k0, k1, sid)


def bounce_draws(k0, k1, bounce, unit_sample: bool):
    """Planar rng.bounce_draws: (vec planes, rr plane) from key-word planes.

    ``bounce`` may be an i32 plane (the wavefront engines' per-lane depth).
    """
    tag = jnp.uint32(rng.TAG_BOUNCE) + jnp.asarray(bounce, jnp.uint32)
    u0, u1 = tf.draw_uniform2(k0, k1, tag, 0)
    u2, u3 = tf.draw_uniform2(k0, k1, tag, 1)
    x, y, z = rng.unit_from_uv(u0, u1)
    if not unit_sample:
        r = u2 ** (1.0 / 3.0)
        x, y, z = x * r, y * r, z * r
    return x, y, z, u3


def strat0_scatter_planes(k0, k1, pid, sid, b0, b1, spp: int,
                          unit_sample: bool):
    """Stratified FIRST-BOUNCE scatter vector replacement planes.

    The bounce-0 direction dims are the last sampled dims the
    stratified estimator covers (after the pixel jitter and the lens
    pair): the bounce-0 (u0, u1) pair is remapped through the same
    rotated-stratified/vdc scheme (rng.stratify_lens_uv) with per-PIXEL
    rotations drawn at the unconsumed ((pid, 0), TAG_BOUNCE + 0, j=3)
    counter, then mapped through the same polar map (and ball radius
    u2, which stays iid) as the shipped draw. Marginals stay U[0,1)
    (Cranley-Patterson) -> unbiased; measured potential 0.87x variance
    on simple/thinlens d8 via oracle draw-injection (round 4).

    k0, k1: CURRENT per-ray key-word planes; pid/sid: the rays'
    (pixel, sample) planes; b0, b1: the base-key words (scalars or
    same-shape planes). Pure elementwise u32/f32 ops -- safe inside
    Pallas kernels (same op set as ops/threefry.py).

    Callers substitute the result for (rvx, rvy, rvz) on depth==0
    lanes only; deeper bounces stay iid by contract.
    """
    pk0, pk1 = tf.fold_in_words(jnp.broadcast_to(b0, pid.shape),
                                jnp.broadcast_to(b1, pid.shape), pid)
    zk0, zk1 = tf.fold_in_words(pk0, pk1, jnp.zeros_like(pid))
    ru_, rv_ = tf.draw_uniform2(zk0, zk1, jnp.uint32(rng.TAG_BOUNCE), 3)
    u0, _ = tf.draw_uniform2(k0, k1, jnp.uint32(rng.TAG_BOUNCE), 0)
    su, sv = rng.stratify_lens_uv(u0, ru_, rv_, sid, spp)
    x, y, z = rng.unit_from_uv(su, sv)
    if not unit_sample:
        u2, _ = tf.draw_uniform2(k0, k1, jnp.uint32(rng.TAG_BOUNCE), 1)
        r = u2 ** (1.0 / 3.0)
        x, y, z = x * r, y * r, z * r
    return x, y, z


def normalize3(x, y, z):
    """Planar math3.normalize (FLT_MIN guard, math.hxx:226-233)."""
    l = jnp.sqrt(x * x + y * y + z * z)
    good = l > FLT_MIN
    inv = 1.0 / jnp.where(good, l, 1.0)
    return (jnp.where(good, x * inv, x), jnp.where(good, y * inv, y),
            jnp.where(good, z * inv, z))


SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)  # main.cxx:49; cuda_impl.cu:125


def bounce_planar(seg, dirs, k0, k1, depth, *, unit_sample: bool,
                  phys_refract: bool, sky_bias: float, strat0=None):
    """One bounce of material scatter + sky, on planar ray state.

    The single shared implementation of the per-segment shading math for
    every wavefront-style engine (single-pool ops/wavefront.py and both
    pools of ops/wavefront_dual.py). Semantics per material mirror the
    reference exactly: lambert cuda_impl.cu:204-213, metal :216-229
    (absorb -> valid False), dielectric :232-262 (Schlick + TIR), sky
    mix main.cxx:47-50 / cuda_impl.cu:123-126 (unclamped).

    seg: trace_segment output dict; dirs: (dx, dy, dz) planes; k0, k1:
    per-ray key-word planes; depth: i32 plane. Statics come from
    TraceOptions. Returns (ndx, ndy, ndz, valid, sky_r, sky_g, sky_b):
    the scattered direction, whether the scatter survives (metal absorb
    kills), and the UNATTENUATED sky radiance for miss lanes.

    strat0: optional (svx, svy, svz) replacement planes
    (strat0_scatter_planes) substituted on depth==0 lanes -- the
    first-bounce half of sampling="stratified".
    """
    from ..models.scene import DIELECTRIC, METAL

    dx, dy, dz = dirs
    nx, ny, nz = seg["nx"], seg["ny"], seg["nz"]
    mt = seg["mt"]
    fz, io = seg["fz"], seg["io"]

    # Per-bounce randomness (ops/rng.py draw-order contract v3): two raw
    # counter blocks under the ray key, tag TAG_BOUNCE + depth.
    rvx, rvy, rvz, ru = bounce_draws(k0, k1, depth, unit_sample)
    if strat0 is not None:
        m0 = depth == 0
        svx, svy, svz = strat0
        rvx = jnp.where(m0, svx, rvx)
        rvy = jnp.where(m0, svy, rvy)
        rvz = jnp.where(m0, svz, rvz)

    ux, uy, uz = normalize3(dx, dy, dz)

    # lambert (cuda_impl.cu:204-213)
    ldx, ldy, ldz = nx + rvx, ny + rvy, nz + rvz
    # metal (cuda_impl.cu:216-229)
    du = ux * nx + uy * ny + uz * nz
    rfx = ux - 2.0 * du * nx
    rfy = uy - 2.0 * du * ny
    rfz = uz - 2.0 * du * nz
    mdx, mdy, mdz = rfx + rvx * fz, rfy + rvy * fz, rfz + rvz * fz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
    # dielectric (cuda_impl.cu:232-262)
    cos = du  # dot(unit_dir, normal)
    entering = cos <= 0.0
    sgn = jnp.where(entering, 1.0, -1.0)
    owx, owy, owz = nx * sgn, ny * sgn, nz * sgn
    ri = jnp.where(entering, 1.0 / io, io)
    cosab = jnp.abs(cos)
    cos_i = owx * ux + owy * uy + owz * uz  # dot(outward, unit_dir)
    kk = 1.0 - ri * ri * (1.0 - cos_i * cos_i)
    tir = kk < 0.0
    sq = jnp.sqrt(jnp.maximum(kk, 0.0))
    if phys_refract:
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

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix.
    tsky = 0.5 * uy + sky_bias
    sky_r = SKY_WHITE[0] * (1.0 - tsky) + SKY_BLUE[0] * tsky
    sky_g = SKY_WHITE[1] * (1.0 - tsky) + SKY_BLUE[1] * tsky
    sky_b = SKY_WHITE[2] * (1.0 - tsky) + SKY_BLUE[2] * tsky
    return ndx, ndy, ndz, valid, sky_r, sky_g, sky_b


def camera_rays(cam: Camera, pid, sid, base_key, width: int, height: int,
                camera_mode: str, sampling: str = "iid", spp: int = 0):
    """Planar camera-ray generation for (pixel, sample) planes.

    pid, sid: (R, 128) i32 planes. Returns (ox, oy, oz, dx, dy, dz, k0,
    k1) with k0/k1 the per-ray KEY-WORD planes (the ops/rng.py ray_key
    contract -- draws are bit-identical to the scalar path).
    sampling="stratified" remaps the jitter per rng.stratify_uv and, in
    thinlens mode, the lens pair per rng.stratify_lens_uv.

    Modes mirror models/camera.camera_ray exactly: "cuda" (no defocus +
    quirk Q11 direction), "pinhole", "cpu" (quirks Q2+Q11), "thinlens".
    """
    origin = cam.origin
    ll, hor, ver = cam.lower_left, cam.horizontal, cam.vertical
    bu, bv = cam.basis_u, cam.basis_v
    lens_r = cam.lens_radius

    k0, k1 = ray_key_words(base_key, pid, sid)
    jux, juy = tf.draw_uniform2(k0, k1, rng.TAG_JITTER, 0)
    if sampling == "stratified":
        # Per-PIXEL rotation from the (pid, sid=0) key (rng.stratify_uv).
        k0z, k1z = ray_key_words(base_key, pid, jnp.zeros_like(sid))
        _, rot_v = tf.draw_uniform2(k0z, k1z, rng.TAG_JITTER, 0)
        jux, juy = rng.stratify_uv(jux, rot_v, sid, spp)
    y = pid // width
    x = pid - y * width
    u = (x.astype(jnp.float32) + jux) / width
    v = (y.astype(jnp.float32) + juy) / height

    def film(k):
        return ll[k] + hor[k] * u + ver[k] * (1.0 - v)

    fx, fy, fz_ = film(0), film(1), film(2)
    if camera_mode == "cuda":
        ox, oy, oz = (jnp.broadcast_to(origin[k], u.shape)
                      for k in range(3))
        dx, dy, dz = fx, fy, fz_  # quirk Q11: no -origin
    elif camera_mode == "pinhole":
        ox, oy, oz = (jnp.broadcast_to(origin[k], u.shape)
                      for k in range(3))
        dx, dy, dz = fx - origin[0], fy - origin[1], fz_ - origin[2]
    elif camera_mode == "cpu":
        # camera.hxx:51-56 (quirks Q2 + Q11): unit-SPHERE lens sample,
        # world-axis offset scaled by screen (u, v).
        lu0, lu1 = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 0)
        lu2, _ = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 1)
        sx, sy, _sz = rng.unit_from_uv(lu0, lu1)
        sr = lu2 ** (1.0 / 3.0)
        rdx, rdy = sx * sr, sy * sr
        offx = u * rdx * lens_r
        offy = v * rdy * lens_r
        ox, oy = origin[0] + offx, origin[1] + offy
        oz = jnp.broadcast_to(origin[2], u.shape)
        dx, dy, dz = fx - offx, fy - offy, fz_
    elif camera_mode == "thinlens":
        lu0, lu1 = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 0)
        if sampling == "stratified":
            # Per-PIXEL lens rotations from the unconsumed (pid, sid=0)
            # (TAG_LENS, j=2) counter -- see rng.stratify_lens_uv.
            lr_u, lr_v = tf.draw_uniform2(k0z, k1z, rng.TAG_LENS, 2)
            lu0, lu1 = rng.stratify_lens_uv(lu0, lr_u, lr_v, sid, spp)
        r0, r1 = rng.disk_from_uv(lu0, lu1)
        r0, r1 = r0 * lens_r, r1 * lens_r
        offx = bu[0] * r0 + bv[0] * r1
        offy = bu[1] * r0 + bv[1] * r1
        offz = bu[2] * r0 + bv[2] * r1
        ox = origin[0] + offx
        oy = origin[1] + offy
        oz = origin[2] + offz
        dx = fx - origin[0] - offx
        dy = fy - origin[1] - offy
        dz = fz_ - origin[2] - offz
    else:
        raise ValueError(f"unknown camera mode: {camera_mode!r}")
    return ox, oy, oz, dx, dy, dz, k0, k1
