"""Branchless material scatter: the one polymorphic site, made data-parallel.

The reference dispatches materials through a tagged union -- ``std::visit``
on CPU (raytracer.hxx:128-198) and a custom device variant on CUDA
(cuda_impl.cu:194-263, include/variant/*; SURVEY #12/#16). Here the whole
wavefront evaluates all three BSDFs and selects by the integer material
type: three cheap elementwise branches, no divergence, and -- crucially --
everything stays differentiable w.r.t. albedo/fuzz/ior.

Semantics per material (CUDA path, the active one):
  - lambert:    dir' = normal + rand_vec;            always valid
                (cuda_impl.cu:204-213; CPU raytracer.hxx:131-141 -- note the
                CPU target-minus-position simplifies to the same formula)
  - metal:      dir' = reflect(unit(dir), n) + fuzz * rand_vec;
                ABSORBED when dot(dir', n) <= 0
                (cuda_impl.cu:216-229; raytracer.hxx:143-156)
  - dielectric: entering/exiting by sign of cos = dot(unit(dir), n);
                refract vs reflect by Schlick Russian roulette; TIR forces
                reflection (reflection_probability stays 1)
                (cuda_impl.cu:232-262; raytracer.hxx:158-196)

``rand_vec`` is a *unit* vector under options.scatter_sample == "unit"
(CUDA normalizes, cuda_impl.cu:206/220) or an unnormalized point in the
unit ball under "ball" (CPU, raytracer.hxx:134/147; quirk Q3). The same
single draw serves lambert and metal -- they are mutually exclusive per
ray, matching the reference's one-draw-per-bounce RNG consumption.

Attenuation is the material albedo in all three cases (the dielectric's is
vec3{1} in the shipped scenes but is an arbitrary differentiable parameter
here, as in material.hxx:33-38).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.scene import DIELECTRIC, METAL
from . import math3
from ..config import TraceOptions


def scatter(direction, normal, mtype, albedo, fuzz, ior, rand_vec,
            rr_uniform, options: TraceOptions):
    """Evaluate the scatter decision for a wavefront.

    Args:
      direction: (N, 3) incoming ray directions (not necessarily unit).
      normal:    (N, 3) outward geometric normals at the hit (unit).
      mtype:     (N,) i32 material type per ray (gathered).
      albedo:    (N, 3); fuzz, ior: (N,) gathered material params.
      rand_vec:  (N, 3) the per-bounce sphere sample (see module docstring).
      rr_uniform:(N,) uniform in [0,1) for the dielectric Russian roulette.
      options:   static TraceOptions.

    Returns:
      (new_direction (N,3), attenuation (N,3), valid (N,) bool) where
      ``valid`` is False only for the metal below-surface absorption case.
    """
    unit_dir = math3.normalize(direction)

    # --- lambert (cuda_impl.cu:204-213) ---------------------------------
    lambert_dir = normal + rand_vec

    # --- metal (cuda_impl.cu:216-229) -----------------------------------
    reflected = math3.reflect(unit_dir, normal)
    metal_dir = reflected + rand_vec * fuzz[:, None]
    metal_ok = math3.dot(metal_dir, normal) > 0.0

    # --- dielectric (cuda_impl.cu:232-262) ------------------------------
    cos_theta = math3.dot(unit_dir, normal)
    entering = cos_theta <= 0.0
    # Reference initializes outward = -normal / ri = ior for the EXITING
    # case and flips when entering (cuda_impl.cu:234-242).
    outward = jnp.where(entering[:, None], normal, -normal)
    ri = jnp.where(entering, 1.0 / ior, ior)
    cos_abs = jnp.abs(cos_theta)
    refract_fn = (math3.refract if options.refract == "physical"
                  else math3.refract_reference)
    refracted, tir = refract_fn(unit_dir, outward, ri)
    # TIR => reflection probability stays 1 (raytracer.hxx:177-180 via the
    # length(refracted) > 0 test; NaN-free here, see ops/math3.py Q7 note).
    reflect_prob = jnp.where(tir, 1.0, math3.schlick(ri, cos_abs))
    diel_dir = jnp.where((rr_uniform < reflect_prob)[:, None],
                         reflected, refracted)

    # --- select by material type ----------------------------------------
    is_metal = mtype == METAL
    is_diel = mtype == DIELECTRIC
    new_dir = jnp.where(is_diel[:, None], diel_dir,
                        jnp.where(is_metal[:, None], metal_dir, lambert_dir))
    valid = jnp.where(is_metal, metal_ok, True)
    return new_dir, albedo, valid
