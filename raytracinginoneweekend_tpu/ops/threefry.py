"""Threefry-2x32 reimplemented as plain uint32 arithmetic.

Why this exists: the renderer's RNG contract (ops/rng.py) is built on
JAX's threefry2x32, but the planar engines draw on raw uint32 key-word
planes (no typed key arrays), and a kernel has no jax.random. Threefry
is just adds/xors/rotates, so this module provides the hash as
jnp-on-arrays code that works on scalars *and* (R, 128) planes, under
XLA or inside a Pallas kernel.

Bit-compatibility: ``threefry2x32`` here is bit-identical to JAX's
``jax._src.prng.threefry_2x32`` block function (verified in
tests/test_threefry.py against jax.random.fold_in / uniform), so keys
derived via ``fold_in_words`` interoperate with jax.random keys.

The DRAW side deliberately uses raw counter mode -- hash (tag, j) under
the ray key and use BOTH 32-bit output words -- rather than
jax.random.uniform's partitionable counter (which spends one hash per
word and XORs the pair). Both are standard Threefry usage; raw counter
mode halves the hash count. See ops/rng.py for the draw-order contract
built on top.

The reference's RNGs (racy shared mt19937, main.cxx:33-36; xorshift32,
cuda_impl.cu:13-56) are replaced wholesale -- see ops/rng.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, not jnp: a module-level jnp array would be a captured
# constant inside Pallas kernels (pallas_call rejects those).
_PARITY = np.uint32(0x1BD11BDA)
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block: hash (x0, x1) under key (k0, k1).

    All arguments uint32 arrays (broadcastable); returns two uint32
    arrays. Bit-identical to JAX's threefry2x32_p (the 20-round
    schedule with key injections every 4 rounds).
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    # 5 groups of 4 rounds; group g injects (ks[(g+1)%3], ks[(g+2)%3]+g+1).
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + jnp.uint32(g + 1)
    return x0, x1


def fold_in_words(k0, k1, data):
    """jax.random.fold_in on raw key words: new key = hash(0, data).

    ``data`` is a non-negative int32/uint32 array (jax's fold_in seeds
    the count with the 64-bit zero-extension of the data word).
    """
    zero = jnp.zeros_like(jnp.asarray(data, jnp.uint32))
    return threefry2x32(k0, k1, zero, jnp.asarray(data, jnp.uint32))


def draw_words(k0, k1, tag, j):
    """Raw counter-mode draw: both words of hash (tag, j).

    Distinct (tag, j) pairs give independent 64-bit blocks under the
    same ray key -- no fold chain needed per draw site.
    """
    tag = jnp.asarray(tag, jnp.uint32)
    j = jnp.asarray(j, jnp.uint32)
    return threefry2x32(k0, k1, jnp.broadcast_to(tag, jnp.shape(k0)),
                        jnp.broadcast_to(j, jnp.shape(k0)))


def uniform_from_bits(bits):
    """uint32 bits -> f32 uniform in [0, 1), jax.random.uniform's map.

    Mantissa-fill: (bits >> 9) | 0x3f800000 viewed as f32 is 1.xxx in
    [1, 2); subtract 1.
    """
    fb = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(fb, jnp.float32) - 1.0


def draw_uniform2(k0, k1, tag, j):
    """Two f32 uniforms from ONE hash (the raw-counter contract)."""
    b0, b1 = draw_words(k0, k1, tag, j)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def key_words(key):
    """Typed jax key (any shape) -> (k0, k1) uint32 arrays."""
    data = jax.random.key_data(key)
    return data[..., 0], data[..., 1]
