"""Closest-hit over the sphere list: a streamed masked argmin.

Reference semantics being re-expressed (SURVEY #8/#15):
  - per-sphere quadratic with near root preferred, far root as fallback,
    both tested against the (t_min, t_max) window
    (raytracer.hxx:52-92; cuda_impl.cu:128-170);
  - closest hit = minimum valid t over all spheres; ties keep the earliest
    sphere index (CPU stable min_element, raytracer.hxx:108-113; CUDA strict
    `<` running min, cuda_impl.cu:183-188).

The CUDA path's shrinking-t_max running min is mathematically identical to
a global argmin over per-sphere candidates computed with t_max = +inf
(the far root can never rescue a sphere whose near root lost, since
far >= near), so this formulation is one masked argmin -- perfectly
parallel, no sequential dependence.

Shape strategy: NO (N, S, 3) tensor is ever built. All intermediates are
2-D (N, B) arrays produced by (N,1) x (1,B) broadcasts of the
*components* -- elementwise code that XLA fuses into a single loop nest
ending in the min/argmin reduction, streamed over sphere blocks of size B
with a running (t, idx) accumulator (`lax.scan`), which keeps the working
set at O(N * sphere_block) regardless of scene size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BIG = 1e30  # "no hit" sentinel (python float: a jnp constant here would
# initialize the XLA backend at import time, breaking jax.distributed)


def _block_candidates(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, rad, valid,
                      t_min):
    """Per-sphere candidate t for one block. All args broadcast to (N, B).

    Mirrors raytracer.hxx:55-91 exactly: oc = origin - center;
    b = oc . dir; c = oc . oc - r^2; disc = b^2 - a*c; roots
    (-b -/+ sqrt(disc)) / a, near preferred.
    """
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - a * c
    pos = disc > 0.0
    # "double where" so sqrt never sees negatives (keeps grads NaN-free).
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    inv_a = 1.0 / a
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    v0 = pos & (t0 > t_min) & valid
    v1 = pos & (t1 > t_min) & valid
    return jnp.where(v0, t0, jnp.where(v1, t1, BIG))


def closest_hit(origin, direction, centers, radii, t_min, sphere_block=512):
    """Vectorized closest-hit.

    Args:
      origin, direction: (N, 3) f32 ray wavefront.
      centers: (S, 3) f32; radii: (S,) f32 (negative radii allowed, Q10).
      t_min: scalar epsilon (0.008 in the reference).
      sphere_block: streaming block size over the sphere axis.

    Returns:
      t:   (N,) f32, BIG where no hit (differentiable w.r.t. scene where hit)
      idx: (N,) i32 index of the closest sphere (arbitrary where no hit)
      hit: (N,) bool
    """
    n = origin.shape[0]
    s = centers.shape[0]

    ox, oy, oz = (origin[:, i:i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i:i + 1] for i in range(3))
    a = dx * dx + dy * dy + dz * dz  # (N, 1); dot(dir, dir), raytracer.hxx:57

    if s <= sphere_block:
        # Single block, no scan.
        pad = -s % 8 if s < 8 else 0
        cx = centers[:, 0][None, :]
        cy = centers[:, 1][None, :]
        cz = centers[:, 2][None, :]
        rad = radii[None, :]
        if pad:
            cx = jnp.pad(cx, ((0, 0), (0, pad)))
            cy = jnp.pad(cy, ((0, 0), (0, pad)))
            cz = jnp.pad(cz, ((0, 0), (0, pad)))
            rad = jnp.pad(rad, ((0, 0), (0, pad)))
        valid = (jnp.arange(s + pad) < s)[None, :]
        tc = _block_candidates(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, rad,
                               valid, t_min)
        t = jnp.min(tc, axis=1)
        idx = jnp.argmin(tc, axis=1).astype(jnp.int32)
        return t, idx, t < BIG

    # Stream over sphere blocks with a running (t, idx) min.
    nb = -(-s // sphere_block)
    s_pad = nb * sphere_block
    cxp = jnp.pad(centers[:, 0], (0, s_pad - s)).reshape(nb, sphere_block)
    cyp = jnp.pad(centers[:, 1], (0, s_pad - s)).reshape(nb, sphere_block)
    czp = jnp.pad(centers[:, 2], (0, s_pad - s)).reshape(nb, sphere_block)
    radp = jnp.pad(radii, (0, s_pad - s)).reshape(nb, sphere_block)
    validp = (jnp.arange(s_pad) < s).reshape(nb, sphere_block)

    def body(carry, block):
        t_best, i_best = carry
        cx, cy, cz, rad, valid, base = block
        tc = _block_candidates(ox, oy, oz, dx, dy, dz, a,
                               cx[None, :], cy[None, :], cz[None, :],
                               rad[None, :], valid[None, :], t_min)
        tb = jnp.min(tc, axis=1)
        ib = jnp.argmin(tc, axis=1).astype(jnp.int32) + base
        better = tb < t_best  # strict: ties keep the earlier sphere index
        return (jnp.where(better, tb, t_best),
                jnp.where(better, ib, i_best)), None

    init = (jnp.full((n,), BIG), jnp.zeros((n,), jnp.int32))
    bases = (jnp.arange(nb) * sphere_block).astype(jnp.int32)
    (t, idx), _ = jax.lax.scan(
        body, init, (cxp, cyp, czp, radp, validp, bases))
    return t, idx, t < BIG


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def closest_hit_diff(origin, direction, centers, radii, t_min,
                     sphere_block=512):
    """closest_hit with an analytic O(N) backward pass.

    XLA's transpose of the (N, S) candidate broadcast materializes the
    whole candidate tensor again; but t locally depends only on the
    WINNING sphere (argmin is piecewise constant), so implicit
    differentiation of F = |o + t d - c|^2 - r^2 = 0 gives

        dt = [ (p-c)·dc + r dr - (p-c)·do - t (p-c)·dd ] / ((p-c)·d)

    with p = o + t d -- all O(N) elementwise plus one (N,)->(S,)
    scatter-add for the sphere cotangents.
    """
    return closest_hit(origin, direction, centers, radii, t_min,
                       sphere_block)


def _closest_hit_fwd(origin, direction, centers, radii, t_min,
                     sphere_block):
    out = closest_hit(origin, direction, centers, radii, t_min,
                      sphere_block)
    t, idx, hit = out
    return out, (origin, direction, centers, radii, t, idx, hit)


def _closest_hit_bwd(t_min, sphere_block, res, g):
    origin, direction, centers, radii, t, idx, hit = res
    g_t = g[0]  # idx/hit are integer/bool outputs: zero cotangent
    s = centers.shape[0]

    t_safe = jnp.where(hit, t, 1.0)
    c_hit = centers[idx]
    r_hit = radii[idx]
    p = origin + t_safe[:, None] * direction
    pc = p - c_hit  # (N, 3)
    denom = jnp.sum(pc * direction, axis=-1)  # (p-c)·d
    # Grazing hits (denom -> 0) have unbounded dt; zero them like the
    # sanitized no-hit lanes (standard for silhouette-adjacent samples).
    good = hit & (jnp.abs(denom) > 1e-12)
    scale = jnp.where(good, g_t / jnp.where(good, denom, 1.0), 0.0)

    g_c_rows = scale[:, None] * pc  # dt/dc = (p-c)/denom
    g_r_rows = scale * r_hit  # dt/dr = r/denom
    idx_dep = jnp.where(good, idx, s)
    g_centers = jnp.zeros_like(centers).at[idx_dep].add(
        g_c_rows, mode="drop")
    g_radii = jnp.zeros_like(radii).at[idx_dep].add(g_r_rows, mode="drop")
    g_origin = -g_c_rows  # dt/do = -(p-c)/denom
    g_direction = -t_safe[:, None] * g_c_rows  # dt/dd = -t (p-c)/denom
    return g_origin, g_direction, g_centers, g_radii


closest_hit_diff.defvjp(_closest_hit_fwd, _closest_hit_bwd)


def hit_surface(origin, direction, t, idx, hit, centers, radii,
                c_hit=None, r_hit=None):
    """Position and normal at the hit point (gathered per ray).

    p = o + t*d (math.hxx:349-352 point_at); n = (p - c)/r
    (raytracer.hxx:71; negative r flips the normal inward -- hollow glass,
    quirk Q10). ``t`` and the gathered radius are sanitized where no hit so
    dead lanes never produce inf/NaN that would poison reverse-mode AD.
    Pass precomputed per-ray ``c_hit``/``r_hit`` to skip the index gathers
    (see ops/integrate.py's one-hot path).
    """
    t_safe = jnp.where(hit, t, 1.0)
    if c_hit is None:
        c_hit = centers[idx]
    if r_hit is None:
        r_hit = radii[idx]
    r_safe = jnp.where(hit, r_hit, 1.0)
    p = origin + t_safe[:, None] * direction
    nrm = (p - c_hit) / r_safe[:, None]
    return p, nrm
