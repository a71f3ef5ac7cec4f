"""One trace segment over planar ray state: closest hit + winner resolve.

Closest hit has two implementations with one contract, (hit_i, t,
sphere_idx) planes for (R, 128) ray planes:

  * ``closest_hit_triton`` -- a Pallas kernel through Triton. One ray per
    lane; each lane walks the whole sphere list keeping its running
    (q, index) minimum in registers, the loop the reference's CUDA
    renderer runs per thread (cuda_impl.cu:176-188). A block whose rays
    are all inactive skips its sphere loop, so drained blocks cost
    almost nothing while stragglers finish.
  * ``closest_hit_xla`` -- ops/intersect.closest_hit (the (N, S)
    candidate matrix that XLA fuses into a min/argmin reduction) behind
    the planar interface.

``closest_hit`` picks by platform and call size: the kernel, compiled,
on the GPU for calls of at least KERNEL_MIN_RAYS rays; the XLA version
for smaller calls and on every other platform. With one ray per thread
the kernel needs many rays to fill the card; XLA's reduction spreads
each ray's spheres over threads and wins on small calls (PERF.md). The
kernel runs in the Pallas interpreter only when a caller passes
``interpret=True`` (the tests do).

Candidate semantics match ops/intersect.py: near root preferred, far
root as fallback, the (t_min, inf) window, strict '<' running minimum
keeping the earliest sphere. The kernel compares in q = t*a space
(a = |d|^2 > 0 per ray), which moves the rounding of t but not which
sphere wins except on knife-edge rays whose two best candidates agree to
f32 precision, and takes sqrt unguarded: a negative discriminant gives
NaN, every NaN comparison is false, so misses fall through to the _BIG
sentinel (an exact disc == 0 graze counts as a hit there).

The winner's parameters come from ``resolve_params``: a one-hot matmul
against the per-sphere table at HIGHEST precision, so every resolved
value is the table entry bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import intersect

LANES = 128
_BIG = 1e30
UNROLL = 4      # spheres per kernel loop iteration
BLOCK = 256     # rays per kernel program (a power of two)
NUM_WARPS = 4
# Smallest call the kernel takes on the GPU: on an H100 the XLA version
# won the flagship frame at 2^15 and 2^16 rays per call and the kernel
# won from 2^17 (PERF.md).
KERNEL_MIN_RAYS = 1 << 17


def default_impl(n_rays: int) -> str:
    """The closest-hit implementation for a call of ``n_rays`` rays."""
    if jax.default_backend() == "gpu" and n_rays >= KERNEL_MIN_RAYS:
        return "triton"
    return "xla"


def _hit_kernel(sph_ref, trips_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
                dz_ref, hit_ref, t_ref, sb_ref, *, t_min: float):
    """Closest hit for one block of rays against every sphere.

    sph_ref rows are (cx, cy, cz, r*r); pad rows carry rr = -1, so their
    discriminant b^2 - a(|oc|^2 + 1) < 0 and they can never win.
    trips_ref holds this block's loop trip count: 0 when none of its
    rays is active, so a drained block runs no sphere iterations.
    """
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    a = dx * dx + dy * dy + dz * dz
    q_min = t_min * a
    n = trips_ref[0]

    def body(i, carry):
        q_b, s_b = carry
        for k in range(UNROLL):
            s = i * UNROLL + k
            ocx = ox - sph_ref[s, 0]
            ocy = oy - sph_ref[s, 1]
            ocz = oz - sph_ref[s, 2]
            b = ocx * dx + ocy * dy + ocz * dz
            c = ocx * ocx + ocy * ocy + ocz * ocz - sph_ref[s, 3]
            sq = jnp.sqrt(b * b - a * c)  # NaN when disc < 0 (see above)
            q0 = -b - sq
            q1 = -b + sq
            q = jnp.where(q0 > q_min, q0, jnp.where(q1 > q_min, q1, _BIG))
            w = q < q_b
            q_b = jnp.where(w, q, q_b)
            s_b = jnp.where(w, s, s_b)
        return q_b, s_b

    q_b = jnp.full(ox.shape, _BIG, jnp.float32)
    s_b = jnp.zeros(ox.shape, jnp.int32)
    q_b, s_b = jax.lax.fori_loop(0, n, body, (q_b, s_b))
    hit = q_b < _BIG
    hit_ref[...] = hit.astype(jnp.int32)
    t_ref[...] = jnp.where(hit, q_b / a, _BIG)
    sb_ref[...] = s_b


def closest_hit_triton(rays, cx, cy, cz, r, t_min, active=None, *,
                       block: int = BLOCK, num_warps: int = NUM_WARPS,
                       interpret: bool = False):
    """Closest hit by the Triton kernel -> (hit_i, t, sphere_idx) planes.

    rays: 6-tuple of equal-shape f32 planes; cx/cy/cz/r: (S,) geometry;
    active: optional bool/int plane (inactive rays report hit = 0).
    block: rays per program, a power of two.
    """
    shape = rays[0].shape
    n = rays[0].size
    s = cx.shape[0]
    n_pad = -(-n // block) * block
    s_loop = -(-s // UNROLL) * UNROLL
    s_tab = max(1 << (s_loop - 1).bit_length(), UNROLL)
    pad_s = s_tab - s
    zf = jnp.zeros((pad_s,), jnp.float32)
    table = jnp.stack([
        jnp.concatenate([cx.astype(jnp.float32), zf]),
        jnp.concatenate([cy.astype(jnp.float32), zf]),
        jnp.concatenate([cz.astype(jnp.float32), zf]),
        jnp.concatenate([(r * r).astype(jnp.float32), zf - 1.0]),
    ], axis=1)

    def flat(p, fill=0):
        p = p.reshape(-1)
        if n_pad > n:
            p = jnp.concatenate([p, jnp.full((n_pad - n,), fill, p.dtype)])
        return p

    n_iter = s_loop // UNROLL
    if active is None:
        trips = jnp.full((n_pad // block,), n_iter, jnp.int32)
    else:
        live = flat(active.astype(jnp.int32)).reshape(-1, block).max(1)
        trips = jnp.where(live > 0, n_iter, 0).astype(jnp.int32)
    ray_planes = [flat(p) for p in rays[:3]]
    # Padded rays get a non-degenerate direction (a = |d|^2 > 0).
    ray_planes += [flat(rays[3], 1.0), flat(rays[4]), flat(rays[5])]
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    tab_spec = pl.BlockSpec((s_tab, 4), lambda i: (0, 0))
    trip_spec = pl.BlockSpec((1,), lambda i: (i,))
    out = pl.pallas_call(
        functools.partial(_hit_kernel, t_min=float(t_min)),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in
                   (jnp.int32, jnp.float32, jnp.int32)],
        grid=(n_pad // block,),
        in_specs=[tab_spec, trip_spec] + [ray_spec] * 6,
        out_specs=[ray_spec] * 3,
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rtw_closest_hit",
    )(table, trips, *ray_planes)
    return tuple(o[:n].reshape(shape) for o in out)


def closest_hit_xla(rays, cx, cy, cz, r, t_min, active=None):
    """ops/intersect.closest_hit on planar rays -> (hit_i, t, sphere_idx)."""
    shape = rays[0].shape
    o = jnp.stack([p.reshape(-1) for p in rays[:3]], axis=-1)
    d = jnp.stack([p.reshape(-1) for p in rays[3:]], axis=-1)
    centers = jnp.stack([cx, cy, cz], axis=-1)
    t, idx, hit = intersect.closest_hit(o, d, centers, r, t_min)
    if active is not None:
        hit = hit & (active.reshape(-1) > 0)
    return (hit.astype(jnp.int32).reshape(shape), t.reshape(shape),
            idx.reshape(shape))


def closest_hit(rays, cx, cy, cz, r, t_min, active=None):
    """Closest hit over planar rays -> (hit_i, t, sphere_idx) planes,
    by the implementation default_impl picks for this call.

    ``t`` and ``sphere_idx`` are unspecified where hit_i == 0.
    """
    if default_impl(rays[0].size) == "triton":
        return closest_hit_triton(rays, cx, cy, cz, r, t_min, active)
    return closest_hit_xla(rays, cx, cy, cz, r, t_min, active)


def sphere_table(sphere_params):
    """The 10 per-sphere (S,) params -> (S, 10) f32 table."""
    return jnp.stack([p.astype(jnp.float32) for p in sphere_params], axis=1)


def resolve_params(s_b, sphere_params):
    """Winning sphere index plane -> 10 per-ray param planes.

    params = one_hot(s_b) @ table. Each one-hot row has one 1.0, and the
    product runs at HIGHEST precision (no TF32 rounding on the GPU), so
    every value equals its table entry bit for bit.

    Returns (cx, cy, cz, r, mt_i32, ar, ag, ab, fz, io) planes.
    """
    shape = s_b.shape
    s = sphere_params[0].shape[0]
    oh = (s_b.reshape(-1, 1) == jnp.arange(s, dtype=jnp.int32)[None, :]
          ).astype(jnp.float32)
    params = jnp.dot(oh, sphere_table(sphere_params),
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    cols = [params[:, i].reshape(shape) for i in range(10)]
    cols[4] = cols[4].astype(jnp.int32)
    return tuple(cols)


def resolve_segment(rays, sphere_params, hit_i, t_b, s_b):
    """Winning (hit, t, idx) -> full surface/material planes."""
    cx_b, cy_b, cz_b, r_b, mt, ar, ag, ab, fz, io = resolve_params(
        s_b, sphere_params)
    ox, oy, oz, dx, dy, dz = rays
    hit = hit_i > 0
    t_safe = jnp.where(hit, t_b, 1.0)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    inv_r = 1.0 / jnp.where(r_b != 0.0, r_b, 1.0)
    return {
        "hit": hit_i, "t": t_b, "px": px, "py": py, "pz": pz,
        "nx": (px - cx_b) * inv_r, "ny": (py - cy_b) * inv_r,
        "nz": (pz - cz_b) * inv_r,
        "mt": mt, "ar": ar, "ag": ag,
        "ab": ab, "fz": fz, "io": io,
    }


def trace_segment(rays, sphere_params, t_min, active=None):
    """One trace segment over planar ray state.

    rays: 6 planar f32 planes (ox oy oz dx dy dz); sphere_params: the 10
    per-sphere (S,) arrays of sphere_params_from_scene; active: optional
    bool plane. Returns a dict of planes: hit (i32 0/1), t, px py pz,
    nx ny nz, mt (i32), ar ag ab, fz, io.
    """
    cx, cy, cz, r = sphere_params[:4]
    hit_i, t_b, s_b = closest_hit(rays, cx, cy, cz, r, t_min, active)
    return resolve_segment(rays, sphere_params, hit_i, t_b, s_b)


def sphere_params_from_scene(scene):
    """Pre-gather per-sphere material params: 10 (S,) arrays.

    The only gather is (S,)-sized (materials indexed by
    scene.material_index), done once per trace -- never per ray.
    """
    mi = scene.material_index
    alb = scene.albedo[mi]
    return (scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2],
            scene.radii, scene.mtype[mi].astype(jnp.int32),
            alb[:, 0], alb[:, 1], alb[:, 2],
            scene.fuzz[mi], scene.ior[mi])
