"""Every one-hot "exact gather" product runs at HIGHEST precision.

A float32 product may otherwise run in TF32 on the GPU (10 mantissa
bits), which would round the ground sphere's centre at y = -1000 and
every gradient accumulated through the transposed products. The CPU
cannot show that rounding, so these tests read the precision off the
traced programs, forward and backward.
"""

import jax
import jax.numpy as jnp
import pytest

from raytracinginoneweekend_tpu.config import DEFAULT
from raytracinginoneweekend_tpu.models.scene import huge_scene
from raytracinginoneweekend_tpu.ops import integrate, integrate_planar
from raytracinginoneweekend_tpu.ops import pallas_segment as ps


def _eqns(jaxpr):
    """Every equation of a jaxpr, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    sub = sub.jaxpr  # ClosedJaxpr
                if hasattr(sub, "eqns"):
                    yield from _eqns(sub)


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]
    assert dots, "no product traced"
    return dots


def _planar_rays(n_rows=2, seed=0):
    k = jax.random.split(jax.random.key(seed), 6)
    o = [jax.random.uniform(k[i], (n_rows, 128), minval=-3, maxval=3)
         for i in range(3)]
    d = [jax.random.normal(k[3 + i], (n_rows, 128)) for i in range(3)]
    return tuple(o + d)


def _resolve():
    sp = ps.sphere_params_from_scene(huge_scene(0))
    sb = jnp.arange(256, dtype=jnp.int32).reshape(2, 128)
    return lambda s: ps.resolve_params(s, sp), (sb,)


def _tiled_grad():
    scene = huge_scene(0)
    rays = _planar_rays()
    o = jnp.stack([p.reshape(-1) for p in rays[:3]], -1)
    d = jnp.stack([p.reshape(-1) for p in rays[3:]], -1)
    keys = jax.random.split(jax.random.key(1), o.shape[0])

    def loss(centers):
        s = scene._replace(centers=centers)
        return integrate.trace(s, o, d, keys, 2, DEFAULT).sum()

    return jax.grad(loss), (scene.centers,)


def _planar_hit_grad():
    scene = huge_scene(0)
    rays = _planar_rays()

    def loss(centers):
        t, _, hit = integrate_planar.closest_hit_planar(
            rays, (centers, scene.radii), DEFAULT.t_min)
        return jnp.where(hit > 0, t, 0.0).sum()

    return jax.grad(loss), (scene.centers,)


def _planar_gather_grad():
    sb = jnp.arange(512, dtype=jnp.int32) % 489
    table = integrate_planar._material_table(huge_scene(0))
    return (jax.grad(lambda tb: integrate_planar._onehot_gather(sb, tb)
                     .sum()), (table,))


CASES = {"resolve_params": _resolve, "tiled_onehot_and_transpose":
         _tiled_grad, "planar_hit_vjp": _planar_hit_grad,
         "planar_gather_and_transpose": _planar_gather_grad}


@pytest.mark.parametrize("case", sorted(CASES))
def test_onehot_products_run_at_highest(case):
    fn, args = CASES[case]()
    dots = _dot_precisions(fn, *args)
    for prec in dots:
        assert prec == (jax.lax.Precision.HIGHEST,) * 2, prec
    if case != "resolve_params":
        assert len(dots) >= 2  # the forward product and its transpose


def test_resolved_planes_equal_table():
    """The resolve is an exact gather: every plane equals table[s_b]."""
    sp = ps.sphere_params_from_scene(huge_scene(0))
    sb = (jnp.arange(1024, dtype=jnp.int32) * 7 % 489).reshape(8, 128)
    got = ps.resolve_params(sb, sp)
    table = ps.sphere_table(sp)
    for i, plane in enumerate(got):
        want = table[sb, i]
        if i == 4:
            want = want.astype(jnp.int32)
        assert bool(jnp.array_equal(plane, want)), i
