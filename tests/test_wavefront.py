"""Regenerative wavefront renderer vs the fixed-wave tiled renderer.

Same RNG contract per (pixel, sample, bounce) -> same sampled radiance;
only the framebuffer accumulation order differs (float reassociation), so
agreement is ~1e-5, not bitwise.
"""

import jax
import numpy as np
import pytest

from raytracinginoneweekend_tpu.config import (DEFAULT, REFERENCE_CUDA,
                                               RenderConfig)
from raytracinginoneweekend_tpu.models.camera import (reference_cpu_camera,
                                                      reference_cuda_camera)
from raytracinginoneweekend_tpu.models.scene import (huge_scene,
                                                     simple_scene_cuda)
from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
from raytracinginoneweekend_tpu.render import render


@pytest.mark.parametrize("camera_mode", ["cuda", "thinlens"])
def test_wavefront_matches_tiled_simple(camera_mode):
    w, h, spp, depth = 24, 16, 4, 6
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    key = jax.random.key(5)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                       camera_mode=camera_mode, options=DEFAULT)
    want = np.asarray(render(scene, cam, cfg, key)).reshape(-1, 3)
    got = np.asarray(render_wavefront(
        scene, cam, key, width=w, height=h, spp=spp, max_depth=depth,
        camera_mode=camera_mode, options=DEFAULT, pool_size=64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_wavefront_tiny_pool_matches_big_pool():
    """Result must be invariant to pool size (regeneration order)."""
    w, h, spp, depth = 16, 8, 2, 4
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    key = jax.random.key(9)
    kwargs = dict(width=w, height=h, spp=spp, max_depth=depth,
                  camera_mode="thinlens", options=DEFAULT)
    a = np.asarray(render_wavefront(scene, cam, key, **kwargs, pool_size=32))
    b = np.asarray(render_wavefront(scene, cam, key, **kwargs,
                                    pool_size=1 << 14))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_wavefront_deposit_modes_and_slots_match():
    """The framebuffer deposit mechanism (task-indexed ledger vs pixel
    scatter-add) and the pending-slot count are pure accumulation-layout
    choices: same per-ray radiance, so images must agree to float
    reassociation. Also pins the ledger's frame-end static-reshape fold
    against the scatter path's direct pixel indexing."""
    w, h, spp, depth = 24, 16, 4, 6
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    key = jax.random.key(5)
    kwargs = dict(width=w, height=h, spp=spp, max_depth=depth,
                  camera_mode="thinlens", options=DEFAULT, pool_size=256)
    a = np.asarray(render_wavefront(scene, cam, key, **kwargs,
                                    deposit="ledger"))
    b = np.asarray(render_wavefront(scene, cam, key, **kwargs,
                                    deposit="scatter"))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    c = np.asarray(render_wavefront(scene, cam, key, **kwargs,
                                    deposit="ledger", pending_slots=1))
    d = np.asarray(render_wavefront(scene, cam, key, **kwargs,
                                    deposit="ledger", pending_slots=3))
    np.testing.assert_allclose(c, d, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)


def test_rr_termination_unbiased_and_saves_segments():
    """Opt-in Russian-roulette path termination (TraceOptions.rr_*):
    (a) the engine with and without its occupancy counters draws/acts
    identically,
    (b) traced segments drop materially, (c) the estimator stays
    unbiased -- global image mean within MC noise of the baseline
    (measured: 23.6% fewer segments, mean delta 0.0007 at spp 128)."""
    import dataclasses

    w, h, spp, depth = 32, 24, 128, 12
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    key = jax.random.key(5)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth,
              camera_mode="thinlens", pool_size=4096)
    # rr_scale pinned at 1.0: this test measures the AGGRESSIVE
    # q = attenuation ablation (the 23.6%-fewer-segments figure); the
    # shipped default rr_scale=4.0 trades most of that saving for
    # near-zero variance inflation.
    rr = dataclasses.replace(DEFAULT, rr_terminate=True, rr_start=2,
                             rr_qmin=0.05, rr_scale=1.0)

    base, sb = render_wavefront(scene, cam, key, options=DEFAULT,
                                return_stats=True, **kw)
    img_rr, sr = render_wavefront(scene, cam, key, options=rr,
                                  return_stats=True, **kw)
    img_plain = render_wavefront(scene, cam, key, options=rr, **kw)
    base, img_rr, img_plain = map(np.asarray, (base, img_rr, img_plain))
    np.testing.assert_allclose(img_rr, img_plain, rtol=2e-4, atol=2e-5)
    assert int(sr["segments"]) < 0.9 * int(sb["segments"])
    assert np.isfinite(img_rr).all()
    assert abs(float(img_rr.mean()) - float(base.mean())) < 5e-3
    assert np.abs(img_rr - base).mean() < 0.02


def test_rr_tiled_engine_matches_planar():
    """Round 5: the tiled engine (ops/integrate.py) honors rr_terminate
    via the shared contract too -- cross-engine agreement at the usual
    accumulation-order tolerance, and the scan/while drivers are
    bitwise equal under rr."""
    import dataclasses

    from raytracinginoneweekend_tpu.ops.integrate_planar import (
        render_pixels_planar)
    from raytracinginoneweekend_tpu.render import render_pixels_impl

    import jax.numpy as jnp

    w, h, spp, depth = 48, 27, 8, 12
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    ids = jnp.arange(w * h, dtype=jnp.int32)
    key = jax.random.key(5)
    rr = dataclasses.replace(DEFAULT, rr_terminate=True)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth,
              camera_mode="cuda")
    t = np.asarray(render_pixels_impl(scene, cam, ids, key, wave_spp=spp,
                                      options=rr, **kw))
    p = np.asarray(render_pixels_planar(scene, cam, ids, key, options=rr,
                                        **kw))
    np.testing.assert_allclose(t, p, rtol=2e-4, atol=2e-5)
    ts = np.asarray(render_pixels_impl(scene, cam, ids, key,
                                       wave_spp=spp, options=rr,
                                       differentiable=True, **kw))
    assert (t == ts).all()


def test_wavefront_huge_scene_finite():
    w, h = 32, 21
    scene = huge_scene(0)
    cam = reference_cpu_camera(w, h)
    out = np.asarray(render_wavefront(
        scene, cam, jax.random.key(0), width=w, height=h, spp=2,
        max_depth=8, camera_mode="thinlens", options=DEFAULT,
        pool_size=1 << 12))
    assert np.isfinite(out).all()
    assert out.max() > 0.1  # sky is visible


def test_wavefront_reference_compat_options():
    w, h, spp, depth = 16, 12, 2, 4
    scene = simple_scene_cuda()
    cam = reference_cuda_camera(w, h)
    key = jax.random.key(2)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                       camera_mode="cuda", options=REFERENCE_CUDA)
    want = np.asarray(render(scene, cam, cfg, key)).reshape(-1, 3)
    got = np.asarray(render_wavefront(
        scene, cam, key, width=w, height=h, spp=spp, max_depth=depth,
        camera_mode="cuda", options=REFERENCE_CUDA, pool_size=128))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_wavefront_edge_shapes():
    """spp=1, single-pixel-ish images, pool far larger than the work."""
    scene = simple_scene_cuda()
    for w, h, spp in ((1, 1, 1), (3, 2, 1), (2, 2, 5)):
        cam = reference_cuda_camera(w, h)
        out = np.asarray(render_wavefront(
            scene, cam, jax.random.key(1), width=w, height=h, spp=spp,
            max_depth=3, camera_mode="pinhole", options=DEFAULT,
            pool_size=1 << 16))
        assert out.shape == (w * h, 3)
        assert np.isfinite(out).all()


@pytest.mark.parametrize("camera_mode", ["cuda", "pinhole", "cpu",
                                         "thinlens"])
def test_wavefront_mega_modes_match(camera_mode):
    """Every camera mode through the wavefront engine matches the tiled
    engine: same RNG contract and shade math, so images agree to float
    reassociation (the engines accumulate samples in another order, and
    build camera rays in separate planar / (N, 3) programs). A path
    through the huge scene's glass can magnify that last-bit difference,
    so -- like the stratified cross-engine check in test_render.py --
    the tight tolerance holds on 99% of the values and the image means
    agree."""
    key = jax.random.key(7)
    for scene, cam, w, h in (
            (simple_scene_cuda(), reference_cuda_camera(20, 12), 20, 12),
            (huge_scene(0), reference_cpu_camera(16, 10), 16, 10)):
        cfg = RenderConfig(width=w, height=h, spp=2, max_depth=6,
                           camera_mode=camera_mode, options=DEFAULT)
        want = np.asarray(render(scene, cam, cfg, key)).reshape(-1, 3)
        got = np.asarray(render_wavefront(
            scene, cam, key, width=w, height=h, spp=2, max_depth=6,
            camera_mode=camera_mode, options=DEFAULT, pool_size=1 << 12))
        close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
        assert close.mean() >= 0.99, close.mean()
        assert abs(got.mean() - want.mean()) < 1e-4


def test_wavefront_reference_cpu_compat_matches_tiled():
    """REFERENCE_CPU semantics (ball scatter's cube root, cpu sky bias,
    reference refract) + the quirky "cpu" camera mode, through the
    wavefront engine, vs the tiled renderer."""
    from raytracinginoneweekend_tpu.config import REFERENCE_CPU

    w, h, spp, depth = 16, 12, 2, 4
    scene = simple_scene_cuda()
    cam = reference_cpu_camera(w, h)
    key = jax.random.key(3)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                       camera_mode="cpu", options=REFERENCE_CPU)
    want = np.asarray(render(scene, cam, cfg, key)).reshape(-1, 3)
    got = np.asarray(render_wavefront(
        scene, cam, key, width=w, height=h, spp=spp, max_depth=depth,
        camera_mode="cpu", options=REFERENCE_CPU, pool_size=256))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_wavefront_ray_id_overflow_guard():
    import pytest

    scene = simple_scene_cuda()
    cam = reference_cuda_camera(4, 4)
    with pytest.raises(ValueError, match="overflows"):
        render_wavefront(scene, cam, jax.random.key(0), width=40000,
                         height=40000, spp=4096, max_depth=2,
                         camera_mode="pinhole", options=DEFAULT)


def test_tile_ownership_images_bit_identical():
    """ownership='tile' (block-contiguous tile-swizzled task ownership)
    must reproduce the strided engine's image BIT-exactly on both
    scenes, through the ledger, the scatter-deposit fallback and the
    stats path -- the RNG contract keys by (pixel, sample), so only the
    task->lane mapping moves, and the ledger fold sums each pixel's
    tasks in the same order."""
    import dataclasses

    from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
    from raytracinginoneweekend_tpu.models.scene import (huge_scene,
                                                         simple_scene_cuda)

    for scene, w, h in ((simple_scene_cuda(), 40, 24), (huge_scene(0), 36,
                                                        20)):
        cam = reference_cpu_camera(w, h)
        key = jax.random.key(0)
        kw = dict(width=w, height=h, spp=4, max_depth=6,
                  camera_mode="thinlens", pool_size=2048)
        base = np.asarray(render_wavefront(scene, cam, key, options=DEFAULT,
                                           **kw))
        assert np.isfinite(base).all() and base.max() > 0.05
        o = dataclasses.replace(DEFAULT, ownership="tile")
        got = np.asarray(render_wavefront(scene, cam, key, options=o,
                                          **kw))
        np.testing.assert_array_equal(base, got, err_msg="ledger")
        got = np.asarray(render_wavefront(scene, cam, key, options=o,
                                          deposit="scatter", **kw))
        np.testing.assert_array_equal(base, got, err_msg="scatter")
        got2, st = render_wavefront(scene, cam, key, options=o,
                                    return_stats=True, **kw)
        np.testing.assert_array_equal(base, np.asarray(got2))
        assert int(st["segments"]) > 0


def test_reserve_tail_stealing_matches_default():
    """reserve_frac withholds the task-space tail and grants it to
    exhausted-idle lanes at epoch boundaries (round 4): images must
    match the reserve-off engine to accumulation order, with every
    reserve task rendered exactly once (the mean over a bright scene
    catches drops/doubles), across deposit modes, rr, stratified
    sampling, and multi-sample tasks (spp > task_samples exercises per-pixel
    fold ordering with the scatter-accumulated reserve)."""
    import dataclasses

    scene = huge_scene(0)
    w, h = 48, 32
    cam = reference_cpu_camera(w, h)
    key = jax.random.key(0)
    kw = dict(width=w, height=h, spp=24, max_depth=6,
              camera_mode="thinlens", pool_size=1024, task_samples=8)
    base = np.asarray(render_wavefront(scene, cam, key, options=DEFAULT,
                                       **kw))
    for label, extra in [
            ("rf.1", dict(reserve_frac=0.1)),
            ("rf.3", dict(reserve_frac=0.3)),
            ("rf.1+scatter", dict(reserve_frac=0.1, deposit="scatter")),
    ]:
        got = np.asarray(render_wavefront(scene, cam, key, options=DEFAULT,
                                          **kw, **extra))
        np.testing.assert_allclose(base, got, rtol=2e-6, atol=2e-6,
                                   err_msg=label)
    for opts in (dataclasses.replace(DEFAULT, sampling="stratified"),
                 dataclasses.replace(DEFAULT, rr_terminate=True)):
        a = np.asarray(render_wavefront(scene, cam, key, options=opts,
                                        **kw))
        b = np.asarray(render_wavefront(scene, cam, key, options=opts,
                                        reserve_frac=0.15, **kw))
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
    # tile ownership has its own fold; reserve is silently inert there
    o = dataclasses.replace(DEFAULT, ownership="tile")
    a = np.asarray(render_wavefront(scene, cam, key, options=o, **kw))
    b = np.asarray(render_wavefront(scene, cam, key, options=o,
                                    reserve_frac=0.2, **kw))
    np.testing.assert_array_equal(a, b)


def test_wall_scene_engines_agree():
    """models/scene.wall_scene (a depth-bounded wall of spheres seen
    head-on): tile ownership must reproduce the strided image
    bit-exactly on it, same gate as the huge/simple parity tests."""
    import dataclasses

    from raytracinginoneweekend_tpu.models.camera import make_camera
    from raytracinginoneweekend_tpu.models.scene import (validate_scene,
                                                         wall_scene)

    scene = validate_scene(wall_scene(0))
    assert int(scene.num_spheres) == 484
    w, h = 36, 24
    cam = make_camera((0.0, 11.0, 4.0), (0.0, 11.0, 0.0), (0, 1, 0),
                      w / h, 60.0, 0.0, 4.0)
    key = jax.random.key(1)
    kw = dict(width=w, height=h, spp=4, max_depth=4,
              camera_mode="pinhole", pool_size=2048)
    base = np.asarray(render_wavefront(scene, cam, key, options=DEFAULT,
                                       **kw))
    assert np.isfinite(base).all() and base.max() > 0.05
    o = dataclasses.replace(DEFAULT, ownership="tile")
    got = np.asarray(render_wavefront(scene, cam, key, options=o, **kw))
    np.testing.assert_array_equal(base, got)
