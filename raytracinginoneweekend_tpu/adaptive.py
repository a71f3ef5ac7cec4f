"""Two-stage adaptive sampling: spend extra samples where the noise is.

The reference renders a fixed spp everywhere (main.cxx:23,
cuda_impl.cu:59). Monte-Carlo noise is wildly non-uniform across the
image (defocus edges, glass, silhouettes), so a fixed budget wastes most
of its samples on already-converged pixels. This module adds the classic
two-stage scheme, shaped for static shapes under jit:

  Stage 1  render every pixel twice at spp_base/2 (sample-id halves
           [0, h) and [h, spp_base) -- the RNG contract keys on
           (pixel, sample), so under iid the halves are independent),
           giving the base mean AND a per-pixel noise score
           |half_a - half_b|. Under sampling="stratified" the halves
           are complementary sub-windows of one stratified pattern --
           correlated, so the score is a proxy for the residual
           post-stratification noise rather than an unbiased variance
           estimate; the allocation it drives measures better MSE than
           either reducer alone (docs/ADAPTIVE_r04.json).
  Tiering  rank pixels by score; STATIC tier fractions of the pixel
           count get STATIC extra sample counts (argsort + slice --
           no dynamic shapes, every stage-2 render is a fixed-shape
           pixel-subset call).
  Stage 2  render each tier's pixels at its extra spp with
           sample_offset=spp_base (fresh ids under the same contract),
           and combine by total sample count.

Estimator note (the honest caveat every production adaptive sampler
shares): the allocation depends on stage-1's own samples, so the
combined mean is not exactly unbiased -- the correlation between a
pixel's stage-1 mean and its half-difference decays as O(1/spp_base)
and is measured below MC noise on the shipped configs
(tests/test_adaptive.py asserts the global mean matches uniform
sampling within noise; docs/ADAPTIVE_r04.json records the equal-budget
MSE win). The parity defaults never enable this.

Runs on the planar engine (pixel-subset API + sample_offset). The TWO
VARIANCE REDUCERS COMPOSE (round 4): with sampling="stratified", stage
1's half-windows [0, h) and [h, spp_base) are rendered against the FULL
strata set (spp_strata=spp_base), so their union is exactly the
complete stratified sample pattern -- the half-difference noise score
and the base mean both get stratification's variance cut. Stage-2 tier
windows sit beyond the strata set and fall back to iid draws (each
tier is an independent unbiased mean; mixing estimators across stages
changes nothing about unbiasedness).

Measured (docs/ADAPTIVE_r04.json, equal average budget, MSE against a
512-spp reference, ratios vs uniform-iid): **0.73x where the noise is
spatially concentrated** (wide-aperture defocus; 0.46x with
stratification composed -- the best arm), but level-to-slightly-
negative (1.03-1.06x) on the huge cover, whose noise is uniform across
the frame -- there is nothing to concentrate on. Pick per workload;
the parity defaults keep it off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import TraceOptions
from .models.camera import Camera
from .models.scene import Scene
from .ops.integrate_planar import render_pixels_planar

# (fraction of pixels, extra spp as a multiple of spp_base), noisiest
# first. Default: top 6.25% get +4x, next 25% get +1x -- average extra
# 0.5x spp_base, i.e. a 1.5x total budget.
DEFAULT_TIERS = ((0.0625, 4.0), (0.25, 1.0))


def render_adaptive(scene: Scene, cam: Camera, base_key, *, width: int,
                    height: int, spp_base: int, max_depth: int,
                    camera_mode: str, options: TraceOptions,
                    tiers=DEFAULT_TIERS, pixel_ids=None,
                    return_stats: bool = False):
    """Adaptive render -> (P, 3) radiance means (P = all pixels unless
    pixel_ids is given). spp_base must be even (half-buffer split)."""
    if spp_base < 2 or spp_base % 2:
        raise ValueError(f"spp_base must be even >= 2 (got {spp_base})")
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    p = int(pixel_ids.shape[0])
    h = spp_base // 2
    kw = dict(width=width, height=height, max_depth=max_depth,
              camera_mode=camera_mode)
    # Stage-2 tiers draw beyond the strata set -> iid (module docstring).
    import dataclasses

    tier_options = (dataclasses.replace(options, sampling="iid")
                    if options.sampling != "iid" else options)

    # Stage 1: two independent half-buffers over every pixel. Under
    # sampling="stratified" the halves are the two complementary
    # sub-windows of the FULL spp_base stratified pattern.
    m_a = render_pixels_planar(scene, cam, pixel_ids, base_key, spp=h,
                               sample_offset=0, spp_strata=spp_base,
                               options=options, **kw)
    m_b = render_pixels_planar(scene, cam, pixel_ids, base_key, spp=h,
                               sample_offset=h, spp_strata=spp_base,
                               options=options, **kw)
    score = jnp.abs(m_a - m_b).sum(axis=-1)
    order = jnp.argsort(-score)  # noisiest first

    total = jnp.float32(spp_base) * jnp.ones((p,), jnp.float32)
    acc = (m_a + m_b) * (0.5 * spp_base)

    offset = spp_base
    start = 0
    tier_sizes = []
    for frac, mult in tiers:
        # Clamp to the pixels left in the ranking: tiny batches would
        # otherwise slice past `order` (an empty render) while the
        # returned stats still claimed the full tier budget.
        n_t = min(max(1, int(p * frac)), p - start)
        if n_t <= 0:
            break
        e_t = max(1, int(round(mult * spp_base)))
        ids_t = pixel_ids[order[start:start + n_t]]
        m_t = render_pixels_planar(scene, cam, ids_t, base_key, spp=e_t,
                                   sample_offset=offset,
                                   options=tier_options, **kw)
        acc = acc.at[order[start:start + n_t]].add(m_t * e_t)
        total = total.at[order[start:start + n_t]].add(float(e_t))
        tier_sizes.append((n_t, e_t))
        start += n_t
        # Tiers draw from disjoint sample-id windows so a pixel landing
        # in multiple tiers (never, by construction) could not reuse ids;
        # the window also keeps tier renders reproducible in isolation.
        offset += e_t

    out = acc / total[:, None]
    if not return_stats:
        return out
    extra_rays = sum(n_t * e_t for n_t, e_t in tier_sizes)
    stats = {
        "spp_base": spp_base,
        "tiers": tuple(tier_sizes),
        "rays_stage1": p * spp_base,
        "rays_stage2": extra_rays,
        "avg_spp": (p * spp_base + extra_rays) / p,
    }
    return out, stats
