"""Counter-based RNG discipline shared by the vectorized renderer and the
scalar oracle.

The reference uses a shared (racy) ``std::mt19937`` on CPU (main.cxx:33-36,
SURVEY R1) and a per-pixel xorshift32 on CUDA (cuda_impl.cu:13-56, with the
pixel-0-seed-0 degeneracy, SURVEY Q5). Neither maps to ``jit``:
data-dependent rejection loops and mutable generator state break it. The
replacement here is counter-based threefry (ops/threefry.py): every random draw
is a pure function of ``(base_key, pixel_id, sample_id, tag, word)``.

This gives us, for free, the properties the reference lacks:
  - determinism and reproducibility at fixed key,
  - *shard invariance*: the key depends only on global pixel/sample ids,
    never on device index, so a 1-chip and an N-chip render are bitwise
    identical (the honest basis for scaling numbers, SURVEY section 7),
  - no cross-thread races (R1 cannot exist).

Draw-order contract v3 (the wavefront renderer, the planar engines, the
in-kernel RNG and ``oracle/`` all follow it):
  ray_key  = fold_in(fold_in(base, pixel_id), sample_id)
  draw site (tag, j): BOTH uint32 words of threefry2x32(ray_key, (tag, j))
    jitter   : tag TAG_JITTER, j=0            -> (u, v) pixel jitter
    lens     : tag TAG_LENS,   j=0 (+ j=1 for the cpu-mode 3rd uniform)
    bounce b : tag TAG_BOUNCE+b, j=0 -> scatter u0,u1; j=1 -> u2, rr
               (j=2 word0 -> the Russian-roulette termination uniform,
               drawn ONLY when TraceOptions.rr_terminate -- the default
               contract never consumes it)
  per-PIXEL sites (key = fold_in(fold_in(base, pixel_id), 0), consumed
  ONLY under sampling="stratified"; no per-sample draw touches them):
    jitter rotation : tag TAG_JITTER, j=0 word1 (stratify_uv rot_v --
               deliberately sample 0's own jv: vdc(0)=0 keeps it exact)
    lens rotations  : tag TAG_LENS, j=2 -> (rot_u, rot_v) for
               stratify_lens_uv (j=2 is consumed by NO sample draw;
               see stratify_lens_uv on why reuse would bias sample 0)
    bounce-0 rotations : tag TAG_BOUNCE+0, j=3 -> (rot_u, rot_v) for
               the first-bounce scatter stratification
               (strat0_scatter / planar.strat0_scatter_planes)

COST is a first-class property of this contract (regen/shade RNG is the
wavefront engine's per-iteration elementwise tax): raw
counter mode uses both output words of every hash, so a bounce costs 2
threefry blocks (fold-then-uniform cost 5: one fold + one XORed hash
per word, jax.random's partitionable counter). The samplers map
uniforms analytically (polar maps below) -- no key splits, no Gaussian
erfinv, no normalization. Per-ray radiance stays engine-invariant
because every engine and the oracle share these functions, and the
draws remain pure functions of (pixel, sample, tag, word) -- shard
invariance is untouched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import threefry as tf

TAG_JITTER = 0
TAG_LENS = 1
TAG_BOUNCE = 2  # bounce b uses tag TAG_BOUNCE + b

TWO_PI = 6.283185307179586


def ray_key(base_key, pixel_id, sample_id):
    """Per-(pixel, sample) key; pixel_id/sample_id may be arrays (vmapped)."""
    return jax.random.fold_in(jax.random.fold_in(base_key, pixel_id), sample_id)


def jitter_uv(rkey):
    """Sub-pixel jitter in [0,1)^2 (main.cxx:199-200; cuda_impl.cu:370-371)."""
    k0, k1 = tf.key_words(rkey)
    return jnp.stack(tf.draw_uniform2(k0, k1, TAG_JITTER, 0))


def lens_disk(rkey):
    """Thin-lens defocus sample: uniform point in the unit disk."""
    k0, k1 = tf.key_words(rkey)
    u0, u1 = tf.draw_uniform2(k0, k1, TAG_LENS, 0)
    return jnp.stack(disk_from_uv(u0, u1))


def lens_sphere(rkey):
    """CPU-mode (quirk Q2) defocus sample: uniform point in the unit ball.

    Same distribution as the reference's rejection sampler
    (raytracer.hxx:32-43) without the data-dependent loop: a uniform
    unit direction scaled by U^(1/3).
    """
    k0, k1 = tf.key_words(rkey)
    u0, u1 = tf.draw_uniform2(k0, k1, TAG_LENS, 0)
    u2, _ = tf.draw_uniform2(k0, k1, TAG_LENS, 1)
    x, y, z = unit_from_uv(u0, u1)
    r = u2 ** (1.0 / 3.0)
    return jnp.stack((x, y, z)) * r


def rr_terminate_update(k0, k1, depth, ax, ay, az, keep, *, rr_start: int,
                        rr_qmin: float, rr_scale: float,
                        rr_qcap: float = 1.0,
                        stop_grad: bool = True):
    """Shared Russian-roulette path-termination update -> (ax, ay, az, keep).

    THE one definition of the rr_terminate contract (TraceOptions.rr_*):
    draw word 0 of (TAG_BOUNCE + depth, j=2) under the ray key;
    continuations with >= rr_start completed bounces survive with
    q = clip(rr_scale * max-channel(attenuation), rr_qmin, 1); survivors
    boost attenuation by 1/q, casualties die like absorb. Used by the
    forward wavefront step, the fixed-depth planar AD scan and the
    regenerative AD pool; the scalar oracle re-expresses the same
    draw.

    k0/k1: per-ray key-word planes; depth: completed-bounce count
    (plane or traced scalar); keep: the continuation mask BEFORE rr.
    rr_qcap (probe traces only): survival ceiling < 1 forces
    GEOMETRIC drain even on bright paths (the default rule gives q = 1
    whenever a channel's attenuation >= 1/rr_scale, so a batch of N
    probes always carries some lane to full depth and trace_fast's
    any-alive exit never fires). Still the same unbiased RR (survivors
    boost 1/q); the forward engines keep the 1.0 default.
    stop_grad (AD callers): hold q constant so the weighted estimator's
    gradient is RR applied to the gradient integrand -- E[1{surv}
    grad f / q] = grad E[f] for any measurable q -- while a
    differentiable q would add spurious d(1/q)/dtheta terms. Primal
    values are identical either way.
    """
    tag = jnp.uint32(TAG_BOUNCE) + jnp.asarray(depth).astype(jnp.uint32)
    u_rr, _ = tf.draw_uniform2(k0, k1, tag, 2)
    q = jnp.clip(rr_scale * jnp.maximum(ax, jnp.maximum(ay, az)),
                 rr_qmin, rr_qcap)
    if stop_grad:
        q = jax.lax.stop_gradient(q)
    consider = keep & (jnp.asarray(depth) + 1 >= rr_start)
    surv = consider & (u_rr < q)
    boost = jnp.where(surv, 1.0 / q, 1.0)
    return (ax * boost, ay * boost, az * boost,
            keep & (~consider | surv))


def bounce_draws(rkey, bounce, sample: str):
    """All per-bounce randomness: (scatter vec (3,), rr uniform).

    sample: "unit" (normalized direction, CUDA semantics,
    cuda_impl.cu:42-56 + :206) or "ball" (unnormalized point in the unit
    sphere, CPU semantics, raytracer.hxx:32-43). Both cost exactly two
    threefry blocks; the ball variant spends u2 on the radius.
    """
    k0, k1 = tf.key_words(rkey)
    tag = jnp.uint32(TAG_BOUNCE) + jnp.asarray(bounce, jnp.uint32)
    u0, u1 = tf.draw_uniform2(k0, k1, tag, 0)
    u2, u3 = tf.draw_uniform2(k0, k1, tag, 1)
    x, y, z = unit_from_uv(u0, u1)
    vec = jnp.stack((x, y, z))
    if sample != "unit":
        vec = vec * u2 ** (1.0 / 3.0)
    return vec, u3


def bitrev32(x):
    """Bit-reversed uint32: the base-2 radical inverse scaled by 2^32.

    Pure u32 shift/mask ladder -- usable elementwise on (R, 128) planes
    inside Pallas kernels (same ops as ops/threefry.py).
    """
    x = x.astype(jnp.uint32)
    x = ((x & jnp.uint32(0x55555555)) << 1) | (
        (x >> 1) & jnp.uint32(0x55555555))
    x = ((x & jnp.uint32(0x33333333)) << 2) | (
        (x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | (
        (x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | (
        (x >> 8) & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def stratify_uv(ju, rot_v, sid, spp: int):
    """Remap an iid sub-pixel jitter pair to a STRATIFIED one (opt-in
    TraceOptions.sampling="stratified"; an estimator change, so the
    reference-faithful default never calls this).

    u: exactly stratified -- sample sid jitters (with its own iid draw
    ju) within stratum [sid/spp, (sid+1)/spp); deterministic sid covers
    every stratum once, so the pixel-area integral stays exactly
    unbiased.
    v: base-2 van der Corput radical inverse of sid plus a PER-PIXEL
    Cranley-Patterson rotation rot_v. The rotation MUST be shared by
    every sample of the pixel (callers pass the pixel's sid=0 jitter
    word: one extra fold+hash per camera ray) -- a per-sample rotation
    would make v exactly iid again and erase the low-discrepancy
    structure. The marginal stays U[0,1) (unbiased); sample 0's v
    equals its iid value (vdc(0) = 0). The (pixel, sample, tag, word)
    contract is untouched, so every engine implements the remap
    identically (bit-equal images).
    """
    if spp <= 0:
        # Entry points default spp=0 for the iid path; a stratified call
        # that forgot to thread spp through would silently produce NaN u.
        raise ValueError("sampling='stratified' requires spp > 0 "
                         f"(got spp={spp})")
    u = (jnp.asarray(sid).astype(jnp.float32) + ju) / spp
    # Top 24 bits via i32: Mosaic has no u32->f32 cast, and f32 holds
    # only 24 mantissa bits anyway (values < 2^24 convert exactly).
    rv = (bitrev32(jnp.asarray(sid)) >> 8).astype(jnp.int32).astype(
        jnp.float32) * (1.0 / 16777216.0)
    v = rv + rot_v
    return u, v - jnp.floor(v)


def stratify_lens_uv(lu0, rot_u, rot_v, sid, spp: int):
    """Remap the iid thin-lens disk pair to a rotated stratified pair
    (the lens half of TraceOptions.sampling="stratified"; thinlens
    mode only -- the "cpu" quirk lens stays iid).

    theta-dim u: sample sid's stratum with its own iid jitter lu0, then
    a per-pixel TOROIDAL rotation rot_u. The rotation is what
    decorrelates the lens theta from the equally-sid-stratified pixel
    jitter u -- without it every sample would probe the same stratum
    index in both dimensions at every pixel (padded-stratification
    artifacts). A toroidal shift preserves the equidistribution of the
    stratified set, and with rot_u uniform each sample's marginal stays
    exactly U[0,1) (Cranley-Patterson).
    r-dim v: base-2 van der Corput of sid under rot_v, exactly as
    stratify_uv's v.

    BOTH rotations must be per-PIXEL (shared by every sample of the
    pixel) and must come from counter words no sample consumes itself:
    callers draw them at (pixel, sid=0) / (TAG_LENS, j=2) -- reusing
    sample 0's own lens words would fold the same uniform into u twice
    (frac(c*U) is non-uniform for non-integer c) and bias sample 0.
    """
    if spp <= 0:
        raise ValueError("sampling='stratified' requires spp > 0 "
                         f"(got spp={spp})")
    u = (jnp.asarray(sid).astype(jnp.float32) + lu0) / spp + rot_u
    rv = (bitrev32(jnp.asarray(sid)) >> 8).astype(jnp.int32).astype(
        jnp.float32) * (1.0 / 16777216.0)
    v = rv + rot_v
    return u - jnp.floor(u), v - jnp.floor(v)


def strat0_scatter(rkey, pid, sid, base_key, spp: int, sample: str):
    """Stratified FIRST-BOUNCE scatter vector, key-array form.

    The tiled engine's counterpart of planar.strat0_scatter_planes
    (bit-identical values: same fold chain, same stratify_lens_uv, same
    polar map): the bounce-0 (u0, u1) pair remapped through the rotated
    stratified/vdc scheme with per-pixel rotations at the unconsumed
    ((pid, 0), TAG_BOUNCE + 0, j=3) counter; ball radius u2 stays iid.
    vmap over (rkey, pid, sid) for batches. Part of
    TraceOptions.sampling="stratified".
    """
    k0, k1 = tf.key_words(rkey)
    z0, z1 = tf.key_words(ray_key(base_key, pid, 0))
    ru, rv = tf.draw_uniform2(z0, z1, jnp.uint32(TAG_BOUNCE), 3)
    u0, _ = tf.draw_uniform2(k0, k1, jnp.uint32(TAG_BOUNCE), 0)
    su, sv = stratify_lens_uv(u0, ru, rv, sid, spp)
    x, y, z = unit_from_uv(su, sv)
    if sample != "unit":
        u2, _ = tf.draw_uniform2(k0, k1, jnp.uint32(TAG_BOUNCE), 1)
        r = u2 ** (1.0 / 3.0)
        x, y, z = x * r, y * r, z * r
    return jnp.stack((x, y, z))


def unit_from_uv(u0, u1):
    """Uniform unit direction from two uniforms (polar/Archimedes map).

    z uniform on [-1, 1), azimuth uniform: distributionally identical to
    a normalized Gaussian triple, with no erfinv and no normalization.
    Works elementwise on scalars or (R, 128) planes alike. Returns a
    tuple (x, y, z) of components.
    """
    z = 2.0 * u0 - 1.0
    rho = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u1
    return rho * jnp.cos(phi), rho * jnp.sin(phi), z


def disk_from_uv(u0, u1):
    """Uniform point in the unit disk from two uniforms (componentwise)."""
    theta = TWO_PI * u0
    r = jnp.sqrt(u1)
    return jnp.cos(theta) * r, jnp.sin(theta) * r
