"""Closest hit over planar rays: the Triton kernel (in the Pallas
interpreter), the XLA version, and how the engines choose between them.

The kernel runs compiled only on a GPU; here it runs with interpret=True
against ops/intersect.closest_hit and the scalar oracle. Rays whose two
best candidates agree to f32 precision may legitimately pick another
winner in another evaluation order; none occur at these seeds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinginoneweekend_tpu.models.camera import (make_camera,
                                                      reference_cpu_camera)
from raytracinginoneweekend_tpu.models.scene import (huge_scene,
                                                     simple_scene_cuda,
                                                     wall_scene)
from raytracinginoneweekend_tpu.oracle.scalar import _hit_world
from raytracinginoneweekend_tpu.ops import pallas_segment as ps
from raytracinginoneweekend_tpu.ops import planar
from raytracinginoneweekend_tpu.ops.intersect import closest_hit

T_MIN = 0.008

SCENES = {"simple": simple_scene_cuda, "huge": lambda: huge_scene(0),
          "wall": lambda: wall_scene(0)}


def _geom(scene):
    c = scene.centers
    return c[:, 0], c[:, 1], c[:, 2], scene.radii


def _random_rays(shape, seed):
    rng = np.random.default_rng(seed)
    o = [rng.uniform(-12, 12, shape), rng.uniform(0.05, 4, shape),
         rng.uniform(-12, 12, shape)]
    d = [rng.normal(size=shape) for _ in range(3)]
    return tuple(jnp.asarray(p.astype(np.float32)) for p in o + d)


def _camera_rays(name, shape, seed):
    w, h = 64, 40
    if name == "wall":
        cam = make_camera((0.0, 11.0, 4.0), (0.0, 11.0, 0.0), (0, 1, 0),
                          w / h, 60.0, 0.0, 4.0)
    else:
        cam = reference_cpu_camera(w, h)
    n = shape[0] * shape[1]
    pid = (jnp.arange(n, dtype=jnp.int32) * 37 % (w * h)).reshape(shape)
    sid = (jnp.arange(n, dtype=jnp.int32) % 4).reshape(shape)
    rays = planar.camera_rays(cam, pid, sid, jax.random.key(seed), w, h,
                              "thinlens", spp=4)
    return rays[:6]


def _reference(rays, geom):
    o = jnp.stack([p.reshape(-1) for p in rays[:3]], -1)
    d = jnp.stack([p.reshape(-1) for p in rays[3:]], -1)
    c = jnp.stack(geom[:3], -1)
    t, idx, hit = closest_hit(o, d, c, geom[3], T_MIN)
    return np.asarray(hit), np.asarray(t), np.asarray(idx)


def _check(got, want):
    h1, t1, s1 = (np.asarray(a).reshape(-1) for a in got)
    h2, t2, s2 = want
    np.testing.assert_array_equal(h1 > 0, h2)
    np.testing.assert_array_equal(s1[h2], s2[h2])
    np.testing.assert_allclose(t1[h2], t2[h2], rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["random", "camera"])
@pytest.mark.parametrize("scene_name", ["simple", "huge", "wall"])
def test_triton_kernel_matches_reference(scene_name, kind):
    scene = SCENES[scene_name]()
    geom = _geom(scene)
    shape = (4, 128)
    rays = (_random_rays(shape, 3) if kind == "random"
            else _camera_rays(scene_name, shape, 3))
    got = ps.closest_hit_triton(rays, *geom, T_MIN, interpret=True)
    want = _reference(rays, geom)
    assert 0.05 < want[0].mean()  # the rays actually hit something
    _check(got, want)
    # The scalar oracle's sequential shrinking-t_max scan, on a sample.
    cn = np.asarray(scene.centers, np.float64)
    rn = np.asarray(scene.radii, np.float64)
    h1, t1, s1 = (np.asarray(a).reshape(-1) for a in got)
    flat = [np.asarray(p, np.float64).reshape(-1) for p in rays]
    for i in range(0, flat[0].size, 16):
        o = np.array([flat[0][i], flat[1][i], flat[2][i]])
        d = np.array([flat[3][i], flat[4][i], flat[5][i]])
        res = _hit_world((cn, rn, None), o, d, T_MIN)
        assert (res is not None) == (h1[i] > 0), i
        if res is not None:
            assert res[0] == s1[i], i
            np.testing.assert_allclose(t1[i], res[1], rtol=2e-4, atol=1e-3)


def test_triton_kernel_hollow_glass():
    """Negative radius (quirk Q10): the hollow sphere is hit from inside."""
    scene = simple_scene_cuda()  # its last sphere has a negative radius
    geom = _geom(scene)
    o = [jnp.full((1, 128), v, jnp.float32) for v in (-1.0, 0.0, -1.0)]
    d = [jnp.full((1, 128), v, jnp.float32) for v in (0.3, 0.1, 1.0)]
    got = ps.closest_hit_triton(tuple(o + d), *geom, T_MIN, interpret=True)
    want = _reference(tuple(o + d), geom)
    assert want[0].all()
    _check(got, want)


def test_triton_kernel_inactive_blocks_report_no_hit():
    """A block with no active ray runs no sphere iterations and reports
    hit = 0; active rays in other blocks are unaffected."""
    scene = huge_scene(0)
    geom = _geom(scene)
    shape = (8, 128)  # four blocks of 256 rays
    rays = _random_rays(shape, 5)
    act = np.zeros(shape, bool)
    act[:2] = True  # only the first block
    got = ps.closest_hit_triton(rays, *geom, T_MIN, jnp.asarray(act),
                                interpret=True)
    h = np.asarray(got[0])
    assert h[2:].sum() == 0
    want = _reference(rays, geom)
    np.testing.assert_array_equal(h[:2].reshape(-1) > 0,
                                  want[0].reshape(shape)[:2].reshape(-1))
    none = ps.closest_hit_triton(rays, *geom, T_MIN,
                                 jnp.zeros(shape, bool), interpret=True)
    assert np.asarray(none[0]).sum() == 0


def test_triton_kernel_pads_spheres_and_rays():
    """Sphere counts that are not a multiple of the unroll or a power of
    two (pad spheres carry rr = -1 and never win), and a ray count that
    is not a multiple of the block (padded and sliced off)."""
    scene = huge_scene(0)
    for s in (1, 3, 5, 37, 130):
        geom = tuple(g[:s] for g in _geom(scene))
        rays = tuple(p.reshape(-1)[:1000] for p in _random_rays((8, 128),
                                                                 s))
        got = ps.closest_hit_triton(rays, *geom, T_MIN, interpret=True)
        assert got[0].shape == (1000,)
        _check(got, _reference(rays, geom))
        assert int(np.asarray(got[2]).max()) < s


def test_triton_kernel_several_blocks_and_sizes():
    """Many programs, and every supported block size."""
    scene = huge_scene(0)
    geom = _geom(scene)
    rays = _random_rays((16, 128), 9)
    want = _reference(rays, geom)
    for block, warps in ((128, 4), (256, 2), (512, 8)):
        got = ps.closest_hit_triton(rays, *geom, T_MIN, block=block,
                                    num_warps=warps, interpret=True)
        _check(got, want)


def test_xla_closest_hit_shapes_and_active_mask():
    scene = huge_scene(0)
    geom = _geom(scene)
    rays = _random_rays((4, 128), 2)
    hit, t, idx = ps.closest_hit_xla(rays, *geom, T_MIN)
    assert hit.shape == t.shape == idx.shape == (4, 128)
    assert hit.dtype == jnp.int32 and idx.dtype == jnp.int32
    _check((hit, t, idx), _reference(rays, geom))
    act = np.random.default_rng(0).random((4, 128)) < 0.5
    hit2, _, _ = ps.closest_hit_xla(rays, *geom, T_MIN, jnp.asarray(act))
    np.testing.assert_array_equal(np.asarray(hit2),
                                  np.asarray(hit) * act)


def test_implementation_choice(monkeypatch):
    """The CPU backend picks the XLA path; the kernel is chosen only on a
    GPU for large calls, and the interpreter only on request."""
    assert jax.default_backend() == "cpu"
    assert ps.default_impl(1 << 20) == "xla"
    with monkeypatch.context() as m:
        m.setattr(ps.jax, "default_backend", lambda: "gpu")
        assert ps.default_impl(ps.KERNEL_MIN_RAYS) == "triton"
        assert ps.default_impl(ps.KERNEL_MIN_RAYS - 1) == "xla"
    scene = simple_scene_cuda()
    geom = _geom(scene)
    rays = _random_rays((2, 128), 1)
    jaxpr = str(jax.make_jaxpr(
        lambda rs: ps.closest_hit(rs, *geom, T_MIN))(rays))
    assert "pallas_call" not in jaxpr
    with monkeypatch.context() as m:
        m.setattr(ps, "default_impl", lambda n_rays: "triton")
        jaxpr_k = str(jax.make_jaxpr(
            lambda rs: ps.closest_hit(rs, *geom, T_MIN))(rays))
    assert "pallas_call" in jaxpr_k
    # The kernel runs in the interpreter only on request.
    call = re.search(r"pallas_call\[.*?interpret=(\w+)", jaxpr_k, re.S)
    assert call and call.group(1) == "False"
