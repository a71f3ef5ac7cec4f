"""Scene representation and builders.

The reference stores the scene as ``std::vector<sphere>`` +
``std::vector<material::types>`` (raytracer.hxx:18-30) with materials as a
tagged union dispatched by ``std::visit`` / a custom device variant
(material.hxx:41-51, SURVEY #12). Here the scene is a *pytree of SoA
device arrays* -- these arrays ARE the differentiable parameters for inverse
rendering:

  spheres:   centers (S,3) f32, radii (S,) f32, material_index (S,) i32
  materials: mtype (M,) i32, albedo (M,3) f32, fuzz (M,) f32, ior (M,) f32

Material dispatch becomes an integer-type compare + masked select in the
scatter kernel (no variant needed; SURVEY #12 "capability yes, mechanism no").

Negative radii are first-class (hollow glass, SURVEY Q10): the normal
``(p - c)/r`` flips inward automatically, exactly as in raytracer.hxx:71.

Builders mirror the reference's three scenes:
  - simple_scene_cuda:  cuda_impl.cu:404-417 (the ACTIVE rendered scene)
  - simple_scene_cpu:   main.cxx:120-129     (dead-code CPU scene)
  - huge_scene:         main.cxx:131-177     (disabled 22x22 random grid),
    rebuilt WITHOUT quirk Q8 (the dangling material_index when the random
    material type is 3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

LAMBERT = 0
METAL = 1
DIELECTRIC = 2


class Scene(NamedTuple):
    """SoA scene pytree. All leaves are device arrays (jit/grad friendly)."""

    centers: jax.Array  # (S, 3) f32
    radii: jax.Array  # (S,)  f32
    material_index: jax.Array  # (S,)  i32
    mtype: jax.Array  # (M,)  i32  in {LAMBERT, METAL, DIELECTRIC}
    albedo: jax.Array  # (M, 3) f32
    fuzz: jax.Array  # (M,)  f32  (metal roughness; 0 elsewhere)
    ior: jax.Array  # (M,)  f32  (dielectric refraction index; 1 elsewhere)

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mtype.shape[0]


def _build(materials, spheres) -> Scene:
    """materials: list of (mtype, albedo3, fuzz, ior); spheres: list of
    (center3, radius, material_index)."""
    mt = np.array([m[0] for m in materials], np.int32)
    alb = np.array([m[1] for m in materials], np.float32)
    fz = np.array([m[2] for m in materials], np.float32)
    ior = np.array([m[3] for m in materials], np.float32)
    c = np.array([s[0] for s in spheres], np.float32)
    r = np.array([s[1] for s in spheres], np.float32)
    mi = np.array([s[2] for s in spheres], np.int32)
    return Scene(
        centers=jnp.asarray(c),
        radii=jnp.asarray(r),
        material_index=jnp.asarray(mi),
        mtype=jnp.asarray(mt),
        albedo=jnp.asarray(alb),
        fuzz=jnp.asarray(fz),
        ior=jnp.asarray(ior),
    )


def simple_scene_cuda() -> Scene:
    """The scene the reference actually renders (cuda_impl.cu:404-417).

    5 spheres / 4 materials; hollow glass via nested negative radius -0.499
    (cuda_impl.cu:416-417, quirk Q10).
    """
    materials = [
        (LAMBERT, (0.1, 0.2, 0.5), 0.0, 1.0),
        (METAL, (0.8, 0.6, 0.2), 0.0, 1.0),
        (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        (LAMBERT, (0.64, 0.8, 0.0), 0.0, 1.0),
    ]
    spheres = [
        ((0.0, 0.0, -1.0), 0.5, 0),
        ((0.0, -100.5, -1.0), 100.0, 3),
        ((+1.0, 0.0, -1.0), 0.5, 1),
        ((-1.0, 0.0, -1.0), 0.5, 2),
        ((-1.0, 0.0, -1.0), -0.499, 2),
    ]
    return _build(materials, spheres)


def simple_scene_cpu() -> Scene:
    """The dead-code CPU scene (main.cxx:120-129); hollow glass r=-0.99."""
    materials = [
        (LAMBERT, (0.1, 0.2, 0.5), 0.0, 1.0),
        (METAL, (0.8, 0.6, 0.2), 0.0, 1.0),
        (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        (LAMBERT, (0.64, 0.8, 0.0), 0.0, 1.0),
    ]
    spheres = [
        ((0.0, 1.0, 0.0), 1.0, 0),
        ((0.0, -1000.125, 0.0), 1000.0, 3),
        ((+2.0, 1.0, 0.0), 1.0, 1),
        ((-2.0, 1.0, 0.0), 1.0, 2),
        ((-2.0, 1.0, 0.0), -0.99, 2),
    ]
    return _build(materials, spheres)


def huge_scene(seed: int = 0) -> Scene:
    """The 22x22 random-sphere grid scene (main.cxx:131-177), fixed.

    Reference bugs deliberately NOT reproduced:
      - Q8: material type 3 emplaced a sphere with a dangling
        material_index (main.cxx:141-173). Here type 3 maps to a lambert
        (same 1/4 type distribution, every index valid).
    Matches the reference generator otherwise: base CPU scene (5 spheres),
    then for a,b in [-11,11)^2 a sphere of radius .2 at
    (.9*U+a, .2, .9*U+b), skipped when within distance 1 of (0,1,0)
    (main.cxx:146-151); lambert/metal/dielectric params per
    main.cxx:156-170 (metal roughness .5*U, dielectric ior 1.5).

    Deterministic via numpy Generator(seed) -- scene construction is host
    code, like the reference's std::mt19937 block (main.cxx:133-134).
    """
    rng = np.random.default_rng(seed)
    materials = [
        (LAMBERT, (0.1, 0.2, 0.5), 0.0, 1.0),
        (METAL, (0.8, 0.6, 0.2), 0.0, 1.0),
        (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        (LAMBERT, (0.64, 0.8, 0.0), 0.0, 1.0),
    ]
    spheres = [
        ((0.0, 1.0, 0.0), 1.0, 0),
        ((0.0, -1000.125, 0.0), 1000.0, 3),
        ((+2.0, 1.0, 0.0), 1.0, 1),
        ((-2.0, 1.0, 0.0), 1.0, 2),
        ((-2.0, 1.0, 0.0), -0.99, 2),
    ]
    for a in range(-11, 11):
        for b in range(-11, 11):
            mtype_draw = int(rng.integers(0, 4))  # main.cxx:137 (0..3 incl.)
            center = (
                0.9 * float(rng.random()) + a,
                0.2,
                0.9 * float(rng.random()) + b,
            )
            d = np.linalg.norm(np.array(center) - np.array([0.0, 1.0, 0.0]))
            if d < 1.0:  # main.cxx:150-151
                continue
            if mtype_draw == 0 or mtype_draw == 3:  # Q8 fix: 3 -> lambert
                materials.append(
                    (LAMBERT,
                     (float(rng.random()), float(rng.random()), float(rng.random())),
                     0.0, 1.0))
            elif mtype_draw == 1:
                materials.append(
                    (METAL,
                     (float(rng.random()), float(rng.random()), float(rng.random())),
                     0.5 * float(rng.random()), 1.0))
            else:
                materials.append(
                    (DIELECTRIC,
                     (float(rng.random()), float(rng.random()), float(rng.random())),
                     0.0, 1.5))
            spheres.append((center, 0.2, len(materials) - 1))
    return _build(materials, spheres)


def wall_scene(seed: int = 0, n: int = 22, radius: float = 0.5,
               spacing: float = 1.0) -> Scene:
    """A DEPTH-BOUNDED workload: an n x n sphere wall in the x-y plane.

    Unlike the huge scene (an open ground plane seen nearly edge-on, so
    beams have unbounded depth spread), a close-up of this dense wall
    puts every primary hit in a narrow distance band: the workload for
    coherence and early-exit work reduction. No reference counterpart
    (the reference ships two scenes, main.cxx:120-177).

    n*n spheres of the given radius on a spacing grid centered on the
    x axis (x in +-(n-1)/2*spacing, y from radius up), z = 0; ~80%
    lambert / 20% metal with seeded random albedo. Use wall_camera()
    for the close-up view.
    """
    rng = np.random.default_rng(seed)
    materials = []
    spheres = []
    half = (n - 1) / 2.0
    for i in range(n):
        for j in range(n):
            if rng.random() < 0.8:
                materials.append(
                    (LAMBERT, (0.2 + 0.8 * float(rng.random()),
                               0.2 + 0.8 * float(rng.random()),
                               0.2 + 0.8 * float(rng.random())), 0.0, 1.0))
            else:
                materials.append(
                    (METAL, (0.6 + 0.4 * float(rng.random()),
                             0.6 + 0.4 * float(rng.random()),
                             0.6 + 0.4 * float(rng.random())),
                     0.3 * float(rng.random()), 1.0))
            center = ((i - half) * spacing, radius + j * spacing, 0.0)
            spheres.append((center, radius, len(materials) - 1))
    return _build(materials, spheres)


def validate_scene(scene: Scene) -> Scene:
    """Host-side structural validation; returns the scene or raises.

    Guards the failure class the reference actually ships: its disabled
    huge-scene generator emplaces a sphere whose material_index points
    past the end of the materials vector (main.cxx:141-173, quirk Q8) --
    undefined behavior at render time. Also rejects non-finite
    parameters and zero radii (a zero radius can never be hit and its
    inverse poisons normals).
    """
    centers = np.asarray(scene.centers)
    radii = np.asarray(scene.radii)
    mi = np.asarray(scene.material_index)
    mtype = np.asarray(scene.mtype)
    s, m = centers.shape[0], mtype.shape[0]
    if radii.shape != (s,) or mi.shape != (s,):
        raise ValueError(f"ragged sphere arrays: centers {centers.shape}, "
                         f"radii {radii.shape}, material_index {mi.shape}")
    if s and (mi.min() < 0 or mi.max() >= m):
        bad = int(np.argmax((mi < 0) | (mi >= m)))
        raise ValueError(
            f"sphere {bad} has material_index {int(mi[bad])} outside "
            f"[0, {m}) -- the reference's quirk Q8 (main.cxx:141-173) "
            f"made this undefined behavior; here it is an error")
    for name in ("centers", "radii", "albedo", "fuzz", "ior"):
        a = np.asarray(getattr(scene, name))
        if not np.isfinite(a).all():
            raise ValueError(f"non-finite values in scene.{name}")
    if s and (radii == 0).any():
        raise ValueError("zero-radius sphere (unhittable; 1/r poisons "
                         "normals)")
    known = {LAMBERT, METAL, DIELECTRIC}
    if m and not set(np.unique(mtype)).issubset(known):
        raise ValueError(f"unknown material type in {np.unique(mtype)}")
    return scene
