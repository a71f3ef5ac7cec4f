"""Device-mesh sharding of the ray wavefront.

The multi-device counterpart of the reference's single-GPU
`thrust::transform` launch (cuda_impl.cu:437-440, SURVEY #21): the
flattened pixel axis is sharded over a 1-D `jax.sharding.Mesh` spanning
every device (and every host, when `jax.distributed` is initialized),
scene/camera parameters are replicated, and each device traces its pixel
shard with the exact same wavefront program a single device runs.

Why shard_map (not just jit-with-sharding): the render is embarrassingly
parallel over pixels, so we want XLA to see the *per-shard* program with no
cross-device dataflow to reason about -- guaranteed zero collectives in the
forward pass. In the backward pass (inverse rendering) the replicated scene
parameters transpose into a `psum` all-reduce of the parameter gradients,
which is exactly the BASELINE north-star communication pattern, and it is
inserted automatically by shard_map's AD transpose.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import POOL_SIZE, RenderConfig, TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.wavefront import wavefront_fb
from ..render import render_pixels_impl


def shard_map(f, *, mesh, in_specs, out_specs):
    """shard_map with the varying-manual-axes check disabled.

    The integrator's while_loop/scan carries mix shard-varying ray state
    with freshly-initialized constants (attenuation=ones, alive=True),
    which the vma checker rejects even though the program is correct (the
    constants are per-shard locals). check_vma=False keeps AD correct --
    the transpose conservatively psums replicated-input cotangents, which
    is exactly the parameter all-reduce we want.
    """
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


AXIS = "rays"


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over all (global) devices.

    Rendering needs only one logical axis -- the flattened pixel/ray axis.
    The GPUs of one host are joined all to all (NVLink), so no device
    order is better than another, and the forward pass has no
    communication to lay out anyway.
    """
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "spp", "wave_spp",
                     "max_depth", "camera_mode", "options", "differentiable"))
def render_sharded(scene: Scene, cam: Camera, pixel_ids, base_key, *,
                   mesh: Mesh, width: int, height: int, spp: int,
                   wave_spp: int, max_depth: int, camera_mode: str,
                   options: TraceOptions, differentiable: bool = False):
    """Render a chunk of pixels sharded over the mesh -> (P, 3).

    ``pixel_ids`` length must be divisible by the mesh size (pad with
    sentinel ids and drop the tail on the host; every pixel id produces a
    valid trace, padding just renders junk pixels that get sliced off).
    Scene/camera/base_key are replicated; output is sharded over pixels.
    """
    f = functools.partial(
        render_pixels_impl, width=width, height=height, spp=spp,
        wave_spp=wave_spp, max_depth=max_depth, camera_mode=camera_mode,
        options=options, differentiable=differentiable)
    sharded = shard_map(
        f, mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P()),
        out_specs=P(AXIS))
    return sharded(scene, cam, pixel_ids, base_key)


def render_image_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                         base_key=None, mesh: Mesh | None = None,
                         differentiable: bool = False):
    """Render a full image over the mesh -> (H, W, 3) linear float32.

    Host-side tiling mirrors ``render.render``: pixels x spp are chunked so
    each *device* traces at most cfg.rays_per_chunk rays per wave. The pixel
    count is padded up to a multiple of the mesh size (the padded tail is
    computed -- wasted lanes, bounded by n_devices-1 -- and dropped).
    """
    if base_key is None:
        base_key = jax.random.key(0)
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_pixels = w * h

    # Per-device wave sizing (same policy as the single-chip path, but the
    # budget applies to each device's shard).
    per_dev_pixels = -(-n_pixels // n_dev)
    wave_spp = max(1, min(spp, cfg.rays_per_chunk // max(1, per_dev_pixels)))
    if wave_spp > 1:
        chunk = n_dev * per_dev_pixels  # whole image in one sharded call
    else:
        chunk = min(n_pixels, cfg.rays_per_chunk * n_dev)
        chunk = -(-chunk // n_dev) * n_dev
    n_chunks = -(-n_pixels // chunk)

    out = np.empty((n_pixels, 3), np.float32)
    all_ids = jnp.arange(n_chunks * chunk, dtype=jnp.int32)
    for i in range(n_chunks):
        ids = all_ids[i * chunk:(i + 1) * chunk]
        res = render_sharded(
            scene, cam, ids, base_key, mesh=mesh, width=w, height=h,
            spp=spp, wave_spp=wave_spp, max_depth=cfg.max_depth,
            camera_mode=cfg.camera_mode, options=cfg.options,
            differentiable=differentiable)
        n_valid = min(chunk, n_pixels - i * chunk)
        out[i * chunk:i * chunk + n_valid] = np.asarray(res)[:n_valid]
    return jnp.asarray(out.reshape(h, w, 3))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "spp", "max_depth",
                     "camera_mode", "options", "pool_size",
                     "reserve_frac"))
def render_wavefront_sharded(scene: Scene, cam: Camera, base_key, *,
                             mesh: Mesh, width: int, height: int, spp: int,
                             max_depth: int, camera_mode: str,
                             options: TraceOptions,
                             pool_size: int = POOL_SIZE,
                             reserve_frac: float | None = None):
    """Multi-chip wavefront render -> (H*W, 3) linear radiance means.

    Each device runs an independent persistent-wavefront loop over a
    strided subset of the pixel tasks (device d's local lane l owns tasks
    d*pool + l, + n_dev*pool, ...), so the forward pass needs NO
    communication until the single psum that sums the per-device partial
    framebuffers at the end. Task ownership is balanced by striding and
    the RNG contract keys only on (pixel, sample, bounce), so the result
    is invariant to mesh size up to float accumulation order.

    pool_size is PER DEVICE: total in-flight lanes = pool * n_devices.
    """
    n_dev = mesh.size

    def shard_fn(scene, cam, key):
        d = jax.lax.axis_index(AXIS)
        fb = wavefront_fb(
            scene, cam, key, width=width, height=height, spp=spp,
            max_depth=max_depth, camera_mode=camera_mode, options=options,
            pool_size=pool_size, worker_index=d, n_workers=n_dev,
            reserve_frac=reserve_frac)
        return jax.lax.psum(fb, AXIS)

    sharded = shard_map(shard_fn, mesh=mesh, in_specs=(P(), P(), P()),
                        out_specs=P())
    return sharded(scene, cam, base_key) / spp
