"""Sharding tests on the virtual 8-device CPU mesh.

Validates the SURVEY section 7 "multi-host determinism" contract: RNG keys
depend only on global (pixel, sample) ids, so sharded and single-device
renders are bitwise identical, and parameter gradients survive shard_map's
psum transpose unchanged.
"""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from raytracinginoneweekend_tpu.config import DEFAULT, RenderConfig
from raytracinginoneweekend_tpu.models.camera import reference_cuda_camera
from raytracinginoneweekend_tpu.models.scene import simple_scene_cuda
from raytracinginoneweekend_tpu.optim import params_from_scene, render_loss
from raytracinginoneweekend_tpu.parallel import (make_mesh, render_sharded,
                                                 render_image_sharded)
from raytracinginoneweekend_tpu.render import render, render_pixels

W, H, SPP, DEPTH = 16, 8, 2, 4


def _setup():
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(W, H)
    key = jax.random.key(3)
    return scene, cam, key


def test_mesh_uses_all_devices():
    mesh = make_mesh()
    assert mesh.size == 8  # conftest forces 8 virtual CPU devices


def test_sharded_render_matches_single_device():
    scene, cam, key = _setup()
    ids = jnp.arange(W * H, dtype=jnp.int32)
    mesh = make_mesh()
    kwargs = dict(width=W, height=H, spp=SPP, wave_spp=SPP, max_depth=DEPTH,
                  camera_mode="thinlens", options=DEFAULT)
    got = render_sharded(scene, cam, ids, key, mesh=mesh, **kwargs)
    want = render_pixels(scene, cam, ids, key, **kwargs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_image_matches_host_tiled_render():
    scene, cam, key = _setup()
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                       camera_mode="thinlens", options=DEFAULT)
    got = render_image_sharded(scene, cam, cfg, key)
    want = render(scene, cam, cfg, key)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_image_nondivisible_pixel_count():
    # 9x5 = 45 pixels does not divide the 8-device mesh: pad-and-drop path.
    scene, cam, key = _setup()
    cfg = RenderConfig(width=9, height=5, spp=SPP, max_depth=DEPTH,
                       camera_mode="thinlens", options=DEFAULT)
    got = render_image_sharded(scene, cam, cfg, key)
    want = render(scene, cam, cfg, key)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.slow
def test_param_grads_match_through_shard_map():
    """shard_map AD transpose (psum) must reproduce single-device grads."""
    scene, cam, key = _setup()
    mesh = make_mesh()
    params = params_from_scene(scene, ("centers", "albedo"))
    ids = jnp.arange(W * H, dtype=jnp.int32)
    target = jnp.zeros((W * H, 3), jnp.float32)
    kwargs = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
                  camera_mode="thinlens", options=DEFAULT)

    g_single = jax.grad(render_loss)(params, scene, cam, target, ids, key,
                                     **kwargs, mesh=None)
    g_shard = jax.grad(render_loss)(params, scene, cam, target, ids, key,
                                    **kwargs, mesh=mesh)
    for name in params:
        np.testing.assert_allclose(np.asarray(g_single[name]),
                                   np.asarray(g_shard[name]),
                                   rtol=2e-5, atol=1e-7)
        assert np.isfinite(np.asarray(g_shard[name])).all()


def test_sharded_wavefront_matches_single_device():
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
    from raytracinginoneweekend_tpu.parallel.mesh import (
        render_wavefront_sharded)

    scene, cam, key = _setup()
    mesh = make_mesh()
    kwargs = dict(width=W, height=H, spp=4, max_depth=DEPTH,
                  camera_mode="thinlens", options=DEFAULT, pool_size=128)
    got = render_wavefront_sharded(scene, cam, key, mesh=mesh, **kwargs)
    want = render_wavefront(scene, cam, key, **kwargs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_tile_ownership_shard_invariant():
    """ownership='tile' under an 8-device mesh: the tile fold's
    dynamic_update_slice runs at a TRACED worker offset inside
    shard_map; the sharded image must be BIT-identical to the
    single-device engine (shard-invariant RNG + disjoint per-worker
    block ranges + one psum of partial frames)."""
    import dataclasses

    from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
    from raytracinginoneweekend_tpu.models.scene import huge_scene
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
    from raytracinginoneweekend_tpu.parallel.mesh import (
        render_wavefront_sharded)

    o = dataclasses.replace(DEFAULT, ownership="tile")
    scene = huge_scene(0)
    w, h = 36, 20
    cam = reference_cpu_camera(w, h)
    mesh = make_mesh()
    kw = dict(width=w, height=h, spp=4, max_depth=6,
              camera_mode="thinlens", pool_size=2048)
    a = np.asarray(render_wavefront_sharded(
        scene, cam, jax.random.key(0), mesh=mesh, options=o, **kw))
    b = np.asarray(render_wavefront(scene, cam, jax.random.key(0),
                                    options=o, **kw))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.max() > 0.05


def test_sharded_reserve_stealing_matches():
    """Per-worker reserve slices (round 4): reserve grants under the
    mesh must reproduce the reserve-off sharded render exactly (each
    worker grants only from its own slice; deposits route per worker)."""
    from raytracinginoneweekend_tpu.models.scene import huge_scene
    from raytracinginoneweekend_tpu.parallel.mesh import (
        render_wavefront_sharded)

    from raytracinginoneweekend_tpu.models.camera import (
        reference_cpu_camera)

    scene = huge_scene(0)
    w, h = 36, 20
    cam = reference_cpu_camera(w, h)
    mesh = make_mesh()
    kw = dict(mesh=mesh, width=w, height=h, spp=4, max_depth=4,
              camera_mode="thinlens", options=DEFAULT, pool_size=1024)
    a = np.asarray(render_wavefront_sharded(scene, cam, jax.random.key(2),
                                            **kw))
    b = np.asarray(render_wavefront_sharded(scene, cam, jax.random.key(2),
                                            reserve_frac=0.15, **kw))
    np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
