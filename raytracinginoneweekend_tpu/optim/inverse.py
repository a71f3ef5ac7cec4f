"""Differentiable inverse rendering (BASELINE config 5).

Pipeline: pick the differentiable subset of scene leaves (centers, radii,
albedo, fuzz, ior), render a random pixel minibatch with the scan-based
(reverse-mode safe) integrator, L2 against the target pixels, optax update.

Monte-Carlo gradient discipline: each step re-renders the *same* pixels with
the *same* keys as the target comparison, so the stochastic estimator is
consistent (the loss is exactly differentiable at fixed RNG; sphere
silhouettes are discontinuous only on a measure-zero set, SURVEY section 7
"hard parts").

Sharding: pass a Mesh to ``make_train_step`` and the minibatch renders via
``parallel.render_sharded``; shard_map's AD transpose then all-reduces the
replicated-parameter gradients with a single psum -- the north-star
communication pattern -- with zero code here.
"""

from __future__ import annotations

import functools
from typing import Iterable

import jax
import jax.numpy as jnp
import optax

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..render import render_pixels_impl

DIFFERENTIABLE_LEAVES = ("centers", "radii", "albedo", "fuzz", "ior")


def params_from_scene(scene: Scene,
                      which: Iterable[str] = DIFFERENTIABLE_LEAVES) -> dict:
    """Extract the optimizable parameter pytree (a {name: array} dict)."""
    bad = set(which) - set(DIFFERENTIABLE_LEAVES)
    if bad:
        raise ValueError(f"non-differentiable scene leaves: {sorted(bad)}")
    return {name: getattr(scene, name) for name in which}


def scene_with_params(scene: Scene, params: dict) -> Scene:
    """Rebuild a Scene with the optimized leaves substituted in."""
    return scene._replace(**params)


def render_loss(params: dict, scene: Scene, cam: Camera, target_pixels,
                pixel_ids, base_key, *, width: int, height: int, spp: int,
                max_depth: int, camera_mode: str, options, mesh=None,
                boundary_samples: int = 0, secondary_samples: int = 0,
                secondary_spheres: int = 2,
                secondary_vertex_depths: int = 1, rr_grad: bool = False,
                rr_grad_arms: int = 2, engine: str = "auto",
                engine_opts: dict | None = None):
    """Mean-squared error between rendered and target pixel radiance.

    target_pixels: (P, 3) linear radiance for the same pixel_ids.

    boundary_samples > 0 adds the edge-sampled silhouette boundary term
    (ops/silhouette.py) to the loss GRADIENT (the loss value is
    unchanged): interior AD alone cannot move a silhouette, so gradients
    w.r.t. centers/radii would otherwise miss the visibility term the
    BASELINE finite-difference metric measures.

    secondary_samples > 0 additionally adds the ONE-BOUNCE boundary term
    (shadow/occlusion edges as seen from first-hit lambert vertices and
    rough-reflection edges as seen from first-hit fuzzy-metal vertices,
    ops/silhouette.secondary_boundary_surrogate) with that many
    silhouette angles per candidate sphere and ``secondary_spheres``
    solid-angle-sampled candidates per vertex.
    ``secondary_vertex_depths`` > 1 sums the same term at DEEPER path
    vertices (vertex_depth 0..n-1: the vertex is walked that many
    scatter steps of the renderer's own draw contract first), picking up
    boundary gradients of multi-bounce occlusion -- e.g. a shadow seen
    via an extra diffuse bounce, or through a specular prefix chain.
    0 disables the secondary term entirely; depths whose probe
    continuation budget is exhausted (b >= max_depth - 1) are skipped.

    rr_grad=True adds the dielectric Russian-roulette BRANCH-FLIP term
    (ops/branchprob.py) at the same vertex depths: interior AD misses
    ~99% of the true ior gradient without it (the reflect/refract
    decision's probability dependence). Two probe traces per batch pixel
    per depth. rr_grad_arms (-> branchprob.chain_rr_arms) is its COST
    POLICY knob: how many internal-RR reflection arms of the refract
    chain get their own side-chain edge term. The delta-lobe term is the
    costliest surrogate phase and each arm adds its own probe traces;
    drop to 1 or 0 on scenes without internally-reflected visible
    content (the arms' accuracy ground:
    test_internal_rr_reflection_arm_matches_finite_differences).

    engine: "auto" (default -- resolve_ad_engine picks by max_depth:
    the fixed-depth planar scan up to AD_ENGINE_AUTO_DEPTH, the
    regenerative wavefront pool above it), "planar" ((R, 128) planes +
    the closest-hit kernel with the analytic custom VJP,
    ops/integrate_planar.py), "wavefront" (ops/wavefront_ad.py), or
    "tiled" (the (N, 3) scan engine). Same RNG contract, radiance
    agrees to f32 reassociation.
    """
    full_scene = scene_with_params(scene, params)
    rendered = _render_batch(full_scene, cam, pixel_ids, base_key,
                             width=width, height=height, spp=spp,
                             max_depth=max_depth, camera_mode=camera_mode,
                             options=options, mesh=mesh, engine=engine,
                             engine_opts=engine_opts)
    diff = rendered - target_pixels
    loss = jnp.mean(diff * diff)
    cot = 2.0 * jax.lax.stop_gradient(diff) / diff.size
    return _attach_surrogates(
        loss, cot, full_scene, cam, camera_mode, pixel_ids, base_key,
        width=width, height=height, max_depth=max_depth, options=options,
        boundary_samples=boundary_samples,
        secondary_samples=secondary_samples,
        secondary_spheres=secondary_spheres,
        secondary_vertex_depths=secondary_vertex_depths, rr_grad=rr_grad,
        rr_grad_arms=rr_grad_arms)


AD_ENGINE_AUTO_DEPTH = 32
"""max_depth above which 'auto' picks the regenerative wavefront engine.

Measured on an H100 (power limit 400 W; huge scene, 1200x800 camera,
16384 px x 8 spp, interior step, each engine with the closest hit it
selects; PERF.md): planar / regenerative 21.9 / 36.9 ms at depth 16,
41.8 / 48.0 ms at 32, 64.0 / 60.5 ms at 50 -- the crossover lies
between 32 and 50. The fixed-depth planar scan pays every bounce for
every lane; the regenerative pool pays a fixed structure cost (ledger,
epoch cond, wave one-hot regen) and then only live lanes."""

AD_ENGINE_AUTO_DEPTH_RR = 28
"""The same crossover with rr_terminate=True: RR shortens the POOL's
drain but saves the fixed-trip scan nothing, so the pool wins earlier.
Not measured on the GPU (ROADMAP queues it)."""


def resolve_ad_engine(max_depth: int, rr_terminate: bool = False) -> str:
    """'auto' policy: planar scan at low depth, regenerative pool past
    the crossover (AD_ENGINE_AUTO_DEPTH, or the lower
    AD_ENGINE_AUTO_DEPTH_RR when the estimator terminates paths)."""
    cut = AD_ENGINE_AUTO_DEPTH_RR if rr_terminate else AD_ENGINE_AUTO_DEPTH
    return "wavefront" if max_depth > cut else "planar"


def _render_batch(full_scene, cam, pixel_ids, base_key, *, width, height,
                  spp, max_depth, camera_mode, options, mesh, engine,
                  engine_opts=None):
    """Differentiable (P, 3) pixel batch via the chosen AD engine."""
    if engine == "auto":
        engine = resolve_ad_engine(max_depth, options.rr_terminate)
    if engine == "planar":
        from ..ops.integrate_planar import render_pixels_planar_impl
        impl = render_pixels_planar_impl
    elif engine == "wavefront":
        # Regenerative pool (ops/wavefront_ad.py): wavefront-class
        # occupancy under reverse-mode AD -- the depth-50 train-step
        # engine (fixed-depth scans waste ~93% of lanes there).
        from ..ops.wavefront_ad import render_pixels_wavefront_ad_impl
        impl = render_pixels_wavefront_ad_impl
    elif engine == "tiled":
        impl = render_pixels_impl
    else:
        raise ValueError(f"unknown AD engine: {engine!r}")
    kwargs = dict(width=width, height=height, spp=spp,
                  max_depth=max_depth, camera_mode=camera_mode,
                  options=options, differentiable=True)
    if engine_opts:
        # Engine-specific static knobs (e.g. the regenerative pool's
        # pool_size / iters budget / remat mode -- see
        # ops/wavefront_ad.trace_wavefront_ad).
        kwargs.update(engine_opts)
    if engine == "tiled":
        kwargs["wave_spp"] = spp
    if mesh is None:
        return impl(full_scene, cam, pixel_ids, base_key, **kwargs)
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import AXIS, shard_map

    f = functools.partial(impl, **kwargs)
    return shard_map(
        f, mesh=mesh, in_specs=(P(), P(), P(AXIS), P()),
        out_specs=P(AXIS))(full_scene, cam, pixel_ids, base_key)


def _attach_surrogates(value, cot, full_scene, cam, camera_mode, pixel_ids,
                       base_key, *, width, height, max_depth, options,
                       boundary_samples, secondary_samples,
                       secondary_spheres, secondary_vertex_depths, rr_grad,
                       rr_grad_arms=2):
    """Add the zero-valued surrogate terms whose GRADIENTS carry the
    boundary (silhouette/shadow/rough-reflection) and delta-lobe
    (RR branch-flip) contributions interior AD cannot see.

    cot: (P, 3) stop-gradiented d(value)/d(pixel) weights for pixel_ids.
    Each surrogate enters as `sur - stop_gradient(sur)`, so the value is
    unchanged and only the gradient is augmented.
    """
    if boundary_samples:
        from ..ops.silhouette import boundary_surrogate

        # d(value)/dI for each batch pixel, scattered into a dense image
        # so edge samples can look their pixel up (pixels outside the
        # batch contribute nothing). pixel_ids must be unique.
        cot_image = jnp.zeros((width * height, 3), cot.dtype
                              ).at[pixel_ids].set(cot)
        sur = boundary_surrogate(
            full_scene, cam, camera_mode, cot_image, width, height,
            jax.random.fold_in(base_key, 0x51170), max_depth, options,
            n_angles=boundary_samples)
        value = value + sur - jax.lax.stop_gradient(sur)
    if secondary_samples:
        from ..ops.silhouette import (TAG_EDGE2_DEPTH,
                                      secondary_boundary_surrogate)

        k2 = jax.random.fold_in(base_key, 0x51171)
        for b in range(secondary_vertex_depths):
            if max_depth - 1 - b <= 0:
                break  # no continuation budget left: the term is 0
            sur2 = secondary_boundary_surrogate(
                full_scene, cam, camera_mode, cot, pixel_ids, width,
                height, jax.random.fold_in(k2, TAG_EDGE2_DEPTH + b),
                max_depth, options, n_angles=secondary_samples,
                n_spheres=secondary_spheres, vertex_depth=b)
            value = value + sur2 - jax.lax.stop_gradient(sur2)
    if rr_grad:
        from ..ops.branchprob import (TAG_RR_DEPTH,
                                      branch_probability_surrogate)

        # The grazing-entry gate is NEVER threaded here: the CRN-paired
        # ownership study (docs/RIM_OWNERSHIP_r05.json, 48 keys) showed
        # the rim-band sweep mass is a canceling PAIR with the RR term
        # (-0.42 vs +0.49 on the rim reproducer), not a double count of
        # the boundary term -- gating it leaves the total 17 SE above FD
        # truth, even with boundary_samples > 0. boundary_rim_frac stays
        # a branchprob parameter for ablation only.
        k3 = jax.random.fold_in(base_key, 0x51172)
        for b in range(max(secondary_vertex_depths, 1)):
            if max_depth - 1 - b <= 0:
                break
            sur3 = branch_probability_surrogate(
                full_scene, cam, camera_mode, cot, pixel_ids, width,
                height, jax.random.fold_in(k3, TAG_RR_DEPTH + b),
                max_depth, options, vertex_depth=b,
                chain_rr_arms=rr_grad_arms)
            value = value + sur3 - jax.lax.stop_gradient(sur3)
    return value


def render_pixels_vjp(params: dict, scene: Scene, cam: Camera, cotangent,
                      pixel_ids, base_key, *, width: int, height: int,
                      spp: int, max_depth: int, camera_mode: str, options,
                      mesh=None, boundary_samples: int = 0,
                      secondary_samples: int = 0, secondary_spheres: int = 2,
                      secondary_vertex_depths: int = 1,
                      rr_grad: bool = False, rr_grad_arms: int = 2,
                      engine: str = "auto",
                      engine_opts: dict | None = None):
    """Direct pixel-Jacobian VJP: d<cotangent, I(params)>/d(params).

    THE literal BASELINE pixel-gradient metric (BASELINE.md: "pixel-
    gradient max abs err vs reference"): for an ARBITRARY per-pixel
    cotangent u (P, 3) -- a one-hot u selects a single d(pixel)/d(param)
    row -- returns (grads, pixels) where grads is the parameter pytree
    gradient of sum(u * I) and pixels the rendered (P, 3) batch. Unlike
    render_loss, no target/MSE is involved; the same boundary
    (silhouette, shadow, rough-reflection -- ops/silhouette.py, matching
    the discontinuity of raytracer.hxx:52-92's hit window) and
    delta-lobe (RR branch-flip, ops/branchprob.py) surrogate terms are
    folded in, weighted by the caller's cotangent.

    All keyword knobs mean exactly what they mean in render_loss.
    """
    cot = jax.lax.stop_gradient(jnp.asarray(cotangent, jnp.float32))

    def scalar(p):
        full_scene = scene_with_params(scene, p)
        rendered = _render_batch(
            full_scene, cam, pixel_ids, base_key, width=width,
            height=height, spp=spp, max_depth=max_depth,
            camera_mode=camera_mode, options=options, mesh=mesh,
            engine=engine, engine_opts=engine_opts)
        value = jnp.sum(rendered * cot)
        value = _attach_surrogates(
            value, cot, full_scene, cam, camera_mode, pixel_ids, base_key,
            width=width, height=height, max_depth=max_depth,
            options=options, boundary_samples=boundary_samples,
            secondary_samples=secondary_samples,
            secondary_spheres=secondary_spheres,
            secondary_vertex_depths=secondary_vertex_depths,
            rr_grad=rr_grad, rr_grad_arms=rr_grad_arms)
        return value, rendered

    grads, pixels = jax.grad(scalar, has_aux=True)(params)
    return grads, pixels


def make_train_step(optimizer: optax.GradientTransformation, *, width: int,
                    height: int, spp: int, max_depth: int, camera_mode: str,
                    options, mesh=None, boundary_samples: int = 0,
                    secondary_samples: int = 0, secondary_spheres: int = 2,
                    secondary_vertex_depths: int = 1, rr_grad: bool = False,
                    rr_grad_arms: int = 2, engine: str = "auto",
                    engine_opts: dict | None = None):
    """Build a jitted (params, opt_state, ...) -> (params, opt_state, loss).

    The returned step is a single compiled program: forward render, backward
    pass (rematerialized per bounce via jax.checkpoint inside ``trace``),
    parameter all-reduce (when mesh is given), optax update.
    """

    def step(params, opt_state, scene, cam, target_pixels, pixel_ids,
             base_key):
        loss, grads = jax.value_and_grad(render_loss)(
            params, scene, cam, target_pixels, pixel_ids, base_key,
            width=width, height=height, spp=spp, max_depth=max_depth,
            camera_mode=camera_mode, options=options, mesh=mesh,
            boundary_samples=boundary_samples,
            secondary_samples=secondary_samples,
            secondary_spheres=secondary_spheres,
            secondary_vertex_depths=secondary_vertex_depths,
            rr_grad=rr_grad, rr_grad_arms=rr_grad_arms, engine=engine,
            engine_opts=engine_opts)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def fit(scene: Scene, cam: Camera, target_image, cfg: RenderConfig, *,
        which: Iterable[str] = DIFFERENTIABLE_LEAVES, steps: int = 200,
        learning_rate: float = 1e-2, batch_pixels: int = 4096,
        spp: int | None = None, base_key=None, mesh=None,
        optimizer: optax.GradientTransformation | None = None,
        callback=None, init_params: dict | None = None,
        init_opt_state=None, start_step: int = 0,
        boundary_samples: int = 0, secondary_samples: int = 0,
        secondary_spheres: int = 2, secondary_vertex_depths: int = 1,
        rr_grad: bool = False, rr_grad_arms: int = 2, engine: str = "auto",
        engine_opts: dict | None = None):
    """Optimize scene params toward a target image.

    target_image: (H, W, 3) linear radiance (as produced by render.render).
    Returns (optimized_scene, params, opt_state, losses).
    ``init_params``/``init_opt_state``/``start_step`` resume from a
    checkpoint (optim.checkpoint). ``boundary_samples`` > 0 enables
    edge-sampled silhouette gradients for centers/radii;
    ``secondary_samples`` > 0 adds the one-bounce (shadow) boundary term
    (see render_loss).
    """
    if base_key is None:
        base_key = jax.random.key(7)
    spp = spp or cfg.spp
    optimizer = optimizer or optax.adam(learning_rate)
    params = (dict(init_params) if init_params is not None
              else params_from_scene(scene, which))
    opt_state = (init_opt_state if init_opt_state is not None
                 else optimizer.init(params))

    target_flat = jnp.asarray(target_image).reshape(-1, 3)
    n_pixels = cfg.width * cfg.height
    # choice(replace=False) requires batch_pixels <= n_pixels; clamp for
    # small images, and round DOWN to the mesh multiple when clamped (up
    # would overflow again).
    batch_pixels = min(batch_pixels, n_pixels)
    if mesh is not None:
        up = -(-batch_pixels // mesh.size) * mesh.size
        batch_pixels = up if up <= n_pixels else (
            (batch_pixels // mesh.size) * mesh.size)
        if batch_pixels <= 0:
            raise ValueError(
                f"image of {n_pixels} pixels is smaller than the "
                f"{mesh.size}-device mesh batch granularity")

    step_fn = make_train_step(
        optimizer, width=cfg.width, height=cfg.height, spp=spp,
        max_depth=cfg.max_depth, camera_mode=cfg.camera_mode,
        options=cfg.options, mesh=mesh,
        boundary_samples=boundary_samples,
        secondary_samples=secondary_samples,
        secondary_spheres=secondary_spheres,
        secondary_vertex_depths=secondary_vertex_depths,
        rr_grad=rr_grad, rr_grad_arms=rr_grad_arms, engine=engine,
        engine_opts=engine_opts)

    losses = []
    for i in range(start_step, start_step + steps):
        kstep = jax.random.fold_in(base_key, i)
        pixel_ids = jax.random.choice(
            jax.random.fold_in(kstep, 0), n_pixels, (batch_pixels,),
            replace=False).astype(jnp.int32)
        target_batch = target_flat[pixel_ids]
        # Render key matches the target render's base key so the MC
        # estimator compares like with like at high spp; jitter per step.
        render_key = jax.random.fold_in(kstep, 1)
        params, opt_state, loss = step_fn(
            params, opt_state, scene, cam, target_batch, pixel_ids,
            render_key)
        losses.append(float(loss))
        if callback is not None:
            callback(i, params, opt_state, losses[-1])
    return scene_with_params(scene, params), params, opt_state, losses
