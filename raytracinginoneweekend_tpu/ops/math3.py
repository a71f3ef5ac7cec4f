"""Vector math on trailing-axis-3 arrays.

Re-expression of the reference's ``math::vec3`` / free functions
(reference: src/math.hxx:23-354). There is no vector *class*: everything is a
pure function over ``jnp`` arrays of shape ``(..., 3)`` so that XLA sees plain
elementwise graphs it can fuse.

Reference citations (for parity checking):
  - dot/cross/length/normalize      math.hxx:246-292
  - reflect                         math.hxx:295-298
  - refract                         math.hxx:300-309  (see quirk notes below)
  - pow / mix                       math.hxx:311-335
  - radians / degrees               math.hxx:7-21
  - normalize() guard vs FLT_MIN    math.hxx:221-229

Quirks handled here:
  - Q7 (SURVEY.md): reference ``refract`` multiplies by ``(k >= 0)`` but
    ``sqrt(k<0)`` is NaN and ``NaN*0 == NaN``, so TIR actually produces NaN
    vectors. We implement TIR as an explicit mask (``refract`` returns the
    refracted direction *and* a TIR flag) -- NaNs would poison gradients.
  - QR (found reading math.hxx:304-308 directly; not in SURVEY's list): the
    reference computes ``I*eta - (N*sqrt(k) + dotValue*eta)`` where
    ``N*sqrt(k) + dotValue*eta`` is *vec + scalar*, i.e. the scalar
    ``dot(N,I)*eta`` is broadcast-added to each component instead of scaling
    N (the standard formula is ``eta*I - (eta*dot + sqrt(k))*N``). We expose
    both: ``refract`` (physically standard, the default) and
    ``refract_reference`` (bug-compatible, for allclose validation against
    the reference renderer).
"""

from __future__ import annotations

import jax.numpy as jnp

# Smallest positive normal float32, the guard used by the reference's
# normalize() (math.hxx:226: `if (std::abs(length) > FLT_MIN)`).
FLT_MIN = 1.17549435e-38  # python float, not jnp: no import-time backend init

_DEG2RAD = 0.01745329251994329576923690768489  # math.hxx:12
_RAD2DEG = 57.295779513082320876798154814105  # math.hxx:20


def radians(degrees):
    return degrees * jnp.asarray(_DEG2RAD, jnp.float32)


def degrees(rad):
    return rad * jnp.asarray(_RAD2DEG, jnp.float32)


def dot(a, b):
    """Batched 3-dot product -> (...,) (math.hxx:275-279)."""
    return jnp.sum(a * b, axis=-1)


def norm2(v):
    """Squared length (math.hxx:216-219 `norm`)."""
    return dot(v, v)


def length(v):
    """Euclidean length (math.hxx:221-224)."""
    return jnp.sqrt(norm2(v))


def normalize(v):
    """Safe normalize matching the reference's FLT_MIN guard.

    Reference (math.hxx:226-233): divides only when |len| > FLT_MIN,
    otherwise returns the vector unchanged (the zero vector stays zero).
    The guard is applied UNDER the sqrt too: sqrt's backward is inf at
    exactly 0, and inf * (masked 0) = NaN would otherwise leak through
    reverse-mode even though the forward value is masked.
    """
    l2 = norm2(v)[..., None]
    good = l2 > FLT_MIN * FLT_MIN
    l = jnp.sqrt(jnp.where(good, l2, 1.0))
    return jnp.where(good, v / l, v)


def cross(a, b):
    """3D cross product (math.hxx:281-292)."""
    return jnp.cross(a, b)


def reflect(i, n):
    """Mirror reflection: I - 2*N*dot(N, I) (math.hxx:295-298)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    """Standard Snell refraction with explicit TIR handling.

    Args:
      i: incident unit direction (..., 3)
      n: outward surface normal (..., 3)
      eta: relative index ratio n_incident / n_transmit, shape (...,)

    Returns:
      (refracted, tir): refracted direction (zero vector where TIR) and a
      boolean TIR mask. Unlike the reference (math.hxx:300-309) no NaNs are
      produced on total internal reflection.
    """
    eta = jnp.asarray(eta)[..., None]
    cos_i = dot(n, i)[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k[..., 0] < 0.0
    # Double-where: sqrt's backward is inf at k == 0 (the grazing/TIR
    # boundary) and would NaN the masked branch in reverse mode.
    pos = k > 0.0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
    refracted = eta * i - (eta * cos_i + sq) * n
    return jnp.where(tir[..., None], 0.0, refracted), tir


def refract_reference(i, n, eta):
    """Bug-compatible reference refraction (math.hxx:300-309).

    The reference evaluates ``(I*eta - (N*sqrt(k) + dot*eta)) * (k>=0)``
    where ``dot*eta`` is a *scalar broadcast-added per component* (vec
    operator+(scalar), math.hxx:119-123) -- not the standard formula. TIR is
    returned as an explicit mask instead of the reference's accidental NaN
    vector (its caller treats NaN exactly like a zero/TIR result, see
    raytracer.hxx:179-180, so this is behavior-identical without the NaN).
    """
    eta = jnp.asarray(eta)[..., None]
    cos_i = dot(n, i)[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k[..., 0] < 0.0
    pos = k > 0.0  # double-where, see refract()
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
    refracted = i * eta - (n * sq + cos_i * eta)
    return jnp.where(tir[..., None], 0.0, refracted), tir


def schlick(refraction_index, cosine_theta):
    """Schlick Fresnel reflection probability.

    R0 + (1-R0)*(1-cos)^5 with R0 = ((1-n)/(1+n))^2
    (raytracer.hxx:45-50; cuda_impl.cu:116-121).
    """
    r0 = ((1.0 - refraction_index) / (1.0 + refraction_index)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine_theta) ** 5


def mix(x, y, a):
    """Linear blend x*(1-a) + y*a, *unclamped* (math.hxx:325-335)."""
    a = jnp.asarray(a)
    if a.ndim < jnp.asarray(x).ndim:
        a = a[..., None]
    return x * (1.0 - a) + y * a
