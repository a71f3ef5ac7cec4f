"""High-level renderer: camera-ray generation + wavefront trace + tiling.

This replaces both of the reference's launchers (SURVEY #19/#20/#21):
  - CPU nested pixel loops + per-pixel sample buffer (main.cxx:185-215)
  - CUDA host launcher + thrust::transform over pixels (cuda_impl.cu:384-453)

Structure:
  * The unit of device work is ``render_pixels``: a jitted function over a
    flat chunk of P pixel ids that scans over spp *waves* -- each wave
    traces P*wave_spp rays through the wavefront integrator and accumulates
    into a (P, 3) framebuffer chunk. Memory is O(P * wave_spp) rays,
    independent of total spp.
  * ``render`` tiles the full image over pixel chunks (host loop over jit
    calls, one compiled program reused for every chunk).

Every random draw is keyed by (global pixel id, global sample id) only
(ops/rng.py), so the image is invariant to chunk size, wave size, and
device sharding.

Pixel addressing matches the reference exactly: pixel_index = x + y*width,
row 0 at the top (cuda_impl.cu:363-364), u = (x + U01)/width,
v = (y + U01)/height (cuda_impl.cu:370-371).
"""

from __future__ import annotations

import functools
import math as _math

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig, TraceOptions
from .models.camera import Camera, camera_ray
from .models.scene import Scene
from .ops import rng
from .ops.integrate import trace, trace_fast


def make_primary_rays(cam: Camera, pixel_ids, sample_ids, base_key,
                      width: int, height: int, camera_mode: str,
                      sampling: str = "iid", spp: int = 0):
    """Generate jittered camera rays for (pixel, sample) pairs.

    pixel_ids, sample_ids: equal-shape (R,) i32 arrays.
    sampling="stratified" remaps the jitter per rng.stratify_uv and, in
    thinlens mode, the lens pair per rng.stratify_lens_uv (needs spp,
    the total samples per pixel).
    Returns (origins (R,3), directions (R,3), ray_keys (R,) key array).
    """

    def one(pid, sid):
        rkey = rng.ray_key(base_key, pid, sid)
        ju, jv = rng.jitter_uv(rkey)
        lens_uv = None
        if sampling == "stratified":
            # Per-PIXEL rotation: the pixel's sid=0 jitter word (shared
            # across samples -- see rng.stratify_uv).
            zkey = rng.ray_key(base_key, pid, 0)
            rot_v = rng.jitter_uv(zkey)[1]
            ju, jv = rng.stratify_uv(ju, rot_v, sid, spp)
            if camera_mode == "thinlens":
                # Stratified lens pair (rng.stratify_lens_uv): rotations
                # from the unconsumed (pid, 0) (TAG_LENS, j=2) counter.
                from .ops import threefry as tf
                k0, k1 = tf.key_words(rkey)
                lu0, _ = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 0)
                zk0, zk1 = tf.key_words(zkey)
                lr_u, lr_v = tf.draw_uniform2(zk0, zk1, rng.TAG_LENS, 2)
                lens_uv = rng.stratify_lens_uv(lu0, lr_u, lr_v, sid, spp)
        y = pid // width
        x = pid - y * width
        u = (x.astype(jnp.float32) + ju) / width
        v = (y.astype(jnp.float32) + jv) / height
        o, d = camera_ray(cam, u, v, rkey, camera_mode, lens_uv=lens_uv)
        return o, d, rkey

    return jax.vmap(one)(pixel_ids, sample_ids)


def render_pixels_impl(scene: Scene, cam: Camera, pixel_ids, base_key, *,
                       width: int, height: int, spp: int, wave_spp: int,
                       max_depth: int, camera_mode: str,
                       options: TraceOptions, differentiable: bool = False):
    """Render a flat chunk of pixels -> (P, 3) linear radiance means.

    spp is split into ceil(spp/wave_spp) waves executed by lax.scan; each
    wave is a full wavefront trace of P*wave_spp rays. ``differentiable``
    selects the scan-based integrator (reverse-mode safe) instead of the
    early-exit while_loop one.

    Unjitted: this is the function ``parallel.mesh`` wraps in shard_map.
    Use ``render_pixels`` (the jitted alias) for direct single-device calls.
    """
    p = pixel_ids.shape[0]
    n_waves = -(-spp // wave_spp)
    tracer = trace if differentiable else trace_fast

    def wave(acc, wave_idx):
        sample_ids = wave_idx * wave_spp + jnp.arange(wave_spp)
        pids = jnp.repeat(pixel_ids, wave_spp)
        sids = jnp.tile(sample_ids, p)
        o, d, rkeys = make_primary_rays(cam, pids, sids, base_key, width,
                                        height, camera_mode,
                                        sampling=options.sampling, spp=spp)
        strat0 = None
        if options.sampling == "stratified":
            # First-bounce stratified scatter (rng.strat0_scatter):
            # loop-invariant per wave, computed once here.
            strat0 = jax.vmap(
                lambda k, pi, si: rng.strat0_scatter(
                    k, pi, si, base_key, spp, options.scatter_sample)
            )(rkeys, pids, sids)
        colors = tracer(scene, o, d, rkeys, max_depth, options,
                        strat0=strat0)
        # Mask samples beyond spp (when spp % wave_spp != 0).
        live = (sids < spp).astype(colors.dtype)[:, None]
        contrib = (colors * live).reshape(p, wave_spp, 3).sum(axis=1)
        return acc + contrib, None

    acc, _ = jax.lax.scan(wave, jnp.zeros((p, 3), jnp.float32),
                          jnp.arange(n_waves))
    return acc / spp


render_pixels = jax.jit(
    render_pixels_impl,
    static_argnames=("width", "height", "spp", "wave_spp", "max_depth",
                     "camera_mode", "options", "differentiable"))


def render(scene: Scene, cam: Camera, cfg: RenderConfig, base_key=None,
           differentiable: bool = False):
    """Render a full image -> (H, W, 3) float32 linear radiance (device).

    Tiles pixels into chunks sized so each device program traces at most
    cfg.rays_per_chunk rays per wave.
    """
    if base_key is None:
        base_key = jax.random.key(0)
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_pixels = w * h

    wave_spp = max(1, min(spp, cfg.rays_per_chunk // max(1, n_pixels)))
    if wave_spp > 1:
        chunk = n_pixels  # whole image fits one chunk
    else:
        chunk = min(n_pixels, cfg.rays_per_chunk)
    n_chunks = -(-n_pixels // chunk)

    out = np.empty((n_pixels, 3), np.float32)
    all_ids = jnp.arange(n_chunks * chunk, dtype=jnp.int32)
    for i in range(n_chunks):
        ids = all_ids[i * chunk:(i + 1) * chunk]
        res = render_pixels(
            scene, cam, ids, base_key, width=w, height=h, spp=spp,
            wave_spp=wave_spp, max_depth=cfg.max_depth,
            camera_mode=cfg.camera_mode, options=cfg.options,
            differentiable=differentiable)
        n_valid = min(chunk, n_pixels - i * chunk)
        out[i * chunk:i * chunk + n_valid] = np.asarray(res)[:n_valid]
    return jnp.asarray(out.reshape(h, w, 3))


def render_rays_count(cfg: RenderConfig) -> int:
    """Camera rays for a config (the rays/s denominator, BASELINE metric)."""
    return cfg.width * cfg.height * cfg.spp
