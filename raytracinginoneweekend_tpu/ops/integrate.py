"""Wavefront integrator: the bounce loop as fixed-trip masked iteration.

The reference's integrator is a per-thread loop with data-dependent early
returns (app::color, main.cxx:52-75; cuda::color, cuda_impl.cu:265-297):
  hit -> scatter -> attenuation *= albedo, continue
  metal absorb   -> return black
  miss           -> return sky(t) * attenuation
  depth exhausted-> return black

Data-dependent control flow does not exist under XLA tracing, so the loop
becomes a `lax.scan` over a *fixed* bounce count with an explicit live-ray
mask (the wavefront reformulation from the BASELINE north star). Per-ray
state lives in HBM as SoA arrays; each bounce is one fused intersect pass +
one fused scatter pass over the whole wavefront:

  state: origin (N,3), dir (N,3), attenuation (N,3), result (N,3), alive (N,)
  per bounce:
    t, idx, hit = closest_hit(...)                # ops/intersect.py
    result += (alive & ~hit) ? attenuation * sky(dir) : 0
    new_dir, alb, valid = scatter(...)            # ops/scatter.py
    attenuation *= alb   where scattering
    alive = alive & hit & valid

Rays still alive after max_depth contribute black, exactly like the
reference's loop falling through (main.cxx:74, cuda_impl.cu:296).

Two drivers over the same step function:
  - ``trace(...)``:       `lax.scan`, reverse-mode differentiable (used by
                          inverse rendering; each step is rematerialized via
                          jax.checkpoint to keep memory O(N) not O(N*depth)).
  - ``trace_fast(...)``:  `lax.while_loop` with an any-alive early exit --
                          forward-only, skips tail bounces once the
                          wavefront dies out (big win on sky-dominated
                          scenes at depth 50).

RNG: bounce b draws the two raw counter blocks (TAG_BOUNCE + b, j) under
the ray key (ops/rng.py contract v3) -- a pure function of (pixel,
sample, bounce), so results are independent of wavefront chunking and
device sharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import TraceOptions
from ..models.scene import Scene
from . import math3, rng
from . import threefry as tf
from .intersect import closest_hit_diff, hit_surface
from .scatter import scatter

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)  # main.cxx:49; cuda_impl.cu:125


def background_color(direction, options: TraceOptions):
    """Vertical sky gradient mix(white, blue, t) (SURVEY #18).

    t = .5*unit_y + .5 under "cuda" (cuda_impl.cu:293, correct) or
    t = .5*unit_y + 1  under "cpu"  (main.cxx:71, quirk Q6). ``mix`` is
    unclamped in both, as in math.hxx:325-335.
    """
    unit_y = math3.normalize(direction)[..., 1]
    t = 0.5 * unit_y + (0.5 if options.sky == "cuda" else 1.0)
    white = jnp.asarray(SKY_WHITE)
    blue = jnp.asarray(SKY_BLUE)
    return math3.mix(white, blue, t[..., None])



def _bounce_step(scene: Scene, options: TraceOptions, state, bounce,
                 return_hit: bool = False, strat0=None,
                 rr_qcap: float = 1.0):
    """One wavefront bounce. ``bounce`` may be a traced scalar.

    strat0: optional (N, 3) replacement scatter vectors substituted at
    bounce == 0 (rng.strat0_scatter -- the first-bounce half of
    sampling="stratified"). Loop-invariant; None for probe traces
    (ops/silhouette.py, ops/branchprob.py keep their own draw
    discipline).

    return_hit=True also returns this bounce's (idx, hit) so callers
    walking a vertex prefix (ops/branchprob.py) can classify the visited
    materials without paying a second closest_hit.
    """
    origin, direction, atten, result, alive, ray_keys = state

    t, idx, hit = closest_hit_diff(origin, direction, scene.centers,
                                   scene.radii, options.t_min,
                                   options.sphere_block)

    if options.gather == "onehot":
        # Per-SPHERE table (differentiable: built from the scene leaves
        # with only (S,)-sized gathers), then an exact one-hot matmul per
        # ray; its transpose (the gradient) is another matmul. One
        # nonzero per row and HIGHEST precision keep it bit-exact (an
        # f32 product may otherwise run in TF32 on the GPU).
        mi_s = scene.material_index
        alb_s = scene.albedo[mi_s]
        table = jnp.concatenate([
            scene.centers,
            scene.radii[:, None],
            scene.mtype[mi_s].astype(jnp.float32)[:, None],
            alb_s,
            scene.fuzz[mi_s][:, None],
            scene.ior[mi_s][:, None],
        ], axis=1)  # (S, 10)
        oh = (idx[:, None] == jnp.arange(scene.num_spheres)[None, :]
              ).astype(jnp.float32)
        params = jnp.dot(oh, table, precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        c_hit = params[:, 0:3]
        r_hit = params[:, 3]
        mtype = params[:, 4].astype(jnp.int32)
        albedo = params[:, 5:8]
        fuzz = params[:, 8]
        ior = params[:, 9]
        pos, normal = hit_surface(origin, direction, t, idx, hit,
                                  scene.centers, scene.radii,
                                  c_hit=c_hit, r_hit=r_hit)
    else:
        pos, normal = hit_surface(origin, direction, t, idx, hit,
                                  scene.centers, scene.radii)
        mi = scene.material_index[idx]
        mtype = scene.mtype[mi]
        albedo = scene.albedo[mi]
        fuzz = scene.fuzz[mi]
        ior = scene.ior[mi]

    # Per-bounce randomness (ops/rng.py draw-order contract v3): two raw
    # counter blocks under the ray key, tag TAG_BOUNCE + bounce.
    rand_vec, ru = jax.vmap(
        lambda k: rng.bounce_draws(k, bounce, options.scatter_sample)
    )(ray_keys)
    if strat0 is not None:
        rand_vec = jnp.where(jnp.asarray(bounce, jnp.int32) == 0,
                             strat0, rand_vec)

    new_dir, alb, valid = scatter(direction, normal, mtype, albedo, fuzz,
                                  ior, rand_vec, ru, options)

    sky = background_color(direction, options)
    miss_now = alive & ~hit
    scatter_now = alive & hit & valid

    result = result + jnp.where(miss_now[:, None], atten * sky, 0.0)
    atten = jnp.where(scatter_now[:, None], atten * alb, atten)
    origin = jnp.where(scatter_now[:, None], pos, origin)
    direction = jnp.where(scatter_now[:, None], new_dir, direction)

    keep = scatter_now
    if options.rr_terminate:
        # RR path termination: the shared contract -- same draw words
        # and update order as the planar AD scan (integrate_planar.py),
        # so the engines stay bit-compatible. Beyond estimator parity
        # this is what makes trace_fast's any-alive exit fire on deep
        # probe batches: the boundary/delta-lobe surrogates' probe
        # traces at depth 50 otherwise always carry one live lane to
        # the end.
        k0w, k1w = tf.key_words(ray_keys)
        ax, ay, az, keep = rng.rr_terminate_update(
            k0w, k1w, jnp.asarray(bounce, jnp.int32),
            atten[:, 0], atten[:, 1], atten[:, 2], keep,
            rr_start=options.rr_start, rr_qmin=options.rr_qmin,
            rr_scale=options.rr_scale, rr_qcap=rr_qcap)
        atten = jnp.stack([ax, ay, az], axis=-1)

    out = (origin, direction, atten, result, keep, ray_keys)
    if return_hit:
        return out, (idx, hit)
    return out


def _init_state(origins, directions, ray_keys):
    n = origins.shape[0]
    return (
        origins,
        directions,
        jnp.ones((n, 3), jnp.float32),  # attenuation (main.cxx:56)
        jnp.zeros((n, 3), jnp.float32),  # accumulated radiance
        jnp.ones((n,), bool),  # alive
        ray_keys,
    )


def trace(scene: Scene, origins, directions, ray_keys, max_depth: int,
          options: TraceOptions, strat0=None):
    """Differentiable fixed-depth trace -> radiance (N, 3).

    `lax.scan` over bounces with per-step rematerialization
    (jax.checkpoint): backward pass memory stays O(N) instead of
    O(N * max_depth) -- device memory traded for recomputed FLOPs.
    """
    step = functools.partial(_bounce_step, scene, options,
                             strat0=strat0)

    @jax.checkpoint
    def body(state, bounce):
        return step(state, bounce), None

    state, _ = jax.lax.scan(body, _init_state(origins, directions, ray_keys),
                            jnp.arange(max_depth))
    return state[3]


def trace_fast(scene: Scene, origins, directions, ray_keys, max_depth: int,
               options: TraceOptions, strat0=None, rr_qcap: float = 1.0):
    """Forward-only trace with any-alive early exit (`lax.while_loop`).

    Bitwise-identical radiance to ``trace`` (same per-step math and RNG),
    but stops as soon as every ray has terminated -- the wavefront analogue
    of the reference threads' early returns. rr_qcap < 1 (probe traces):
    see rng.rr_terminate_update.
    """
    step = functools.partial(_bounce_step, scene, options,
                             strat0=strat0, rr_qcap=rr_qcap)

    def cond(carry):
        bounce, state = carry
        return (bounce < max_depth) & jnp.any(state[4])

    def body(carry):
        bounce, state = carry
        return bounce + 1, step(state, bounce)

    _, state = jax.lax.while_loop(
        cond, body, (jnp.int32(0), _init_state(origins, directions,
                                               ray_keys)))
    return state[3]
