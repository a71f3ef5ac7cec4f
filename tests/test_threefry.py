"""ops/threefry.py must be bit-identical to JAX's threefry2x32 block.

The renderer's whole reproducibility story (shard invariance, engine
invariance, oracle parity) rests on every engine drawing the same bits;
the planar engines draw through this reimplementation, so these tests
pin it to jax.random exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracinginoneweekend_tpu.ops import threefry as tf


def test_fold_in_matches_jax_random():
    keys = jax.vmap(jax.random.key)(jnp.arange(64, dtype=jnp.uint32) * 7919)
    data = jnp.arange(64, dtype=jnp.int32) * 104729 + 3
    ref = jax.vmap(jax.random.fold_in)(keys, data)
    k0, k1 = tf.key_words(keys)
    o0, o1 = tf.fold_in_words(k0, k1, data)
    ref_w = jax.random.key_data(ref)
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(ref_w[..., 0]))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(ref_w[..., 1]))


def test_uniform_bit_map_matches_jax_random():
    """jax.random.uniform(key, ()) hashes (0, 0) and XORs the two output
    words (partitionable counter); our uniform_from_bits must reproduce
    it exactly from the raw block."""
    keys = jax.vmap(jax.random.key)(jnp.arange(128, dtype=jnp.uint32) * 131)
    ref = jax.vmap(lambda k: jax.random.uniform(k))(keys)
    k0, k1 = tf.key_words(keys)
    b0, b1 = tf.threefry2x32(k0, k1, jnp.zeros_like(k0), jnp.zeros_like(k0))
    ours = tf.uniform_from_bits(b0 ^ b1)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_uniform4_matches_jax_random():
    """uniform(key, (4,)) = per-element hash of (0, i), words XORed."""
    key = jax.random.key(42)
    ref = jax.random.uniform(key, (4,))
    k0, k1 = tf.key_words(key)
    ours = []
    for i in range(4):
        b0, b1 = tf.threefry2x32(k0, k1, jnp.uint32(0), jnp.uint32(i))
        ours.append(tf.uniform_from_bits(b0 ^ b1))
    np.testing.assert_array_equal(np.asarray(jnp.stack(ours)),
                                  np.asarray(ref))


def test_draw_words_distinct_and_uniform():
    """Raw counter draws: distinct (tag, j) blocks decorrelate, and the
    uniform map covers [0, 1) evenly (chi-square sanity, not bit parity
    -- raw counter mode is deliberately NOT jax.random.uniform)."""
    key = jax.random.key(7)
    k0, k1 = tf.key_words(key)
    k0 = jnp.broadcast_to(k0, (4096,))
    k1 = jnp.broadcast_to(k1, (4096,))
    lane = jnp.arange(4096, dtype=jnp.uint32)
    # Vary the key per lane like the engine does (per-ray keys).
    k0v, k1v = tf.fold_in_words(k0, k1, lane)
    u0, u1 = tf.draw_uniform2(k0v, k1v, 2, 0)
    u2, u3 = tf.draw_uniform2(k0v, k1v, 2, 1)
    us = np.stack([np.asarray(u) for u in (u0, u1, u2, u3)])
    assert us.min() >= 0.0 and us.max() < 1.0
    # Mean/var of U[0,1): 0.5 / 1/12 (tolerances ~5 sigma at n=4096).
    np.testing.assert_allclose(us.mean(axis=1), 0.5, atol=0.025)
    np.testing.assert_allclose(us.var(axis=1), 1 / 12, atol=0.01)
    # Distinct draw sites must not correlate.
    for a in range(4):
        for b in range(a + 1, 4):
            c = np.corrcoef(us[a], us[b])[0, 1]
            assert abs(c) < 0.06, (a, b, c)


def test_planar_shapes():
    """Plane-shaped (R, 128) keys work elementwise (the kernel layout)."""
    base = jax.random.key(3)
    k0, k1 = tf.key_words(base)
    pid = jnp.arange(4 * 128, dtype=jnp.int32).reshape(4, 128)
    pk0, pk1 = tf.fold_in_words(jnp.broadcast_to(k0, pid.shape),
                                jnp.broadcast_to(k1, pid.shape), pid)
    ref = jax.vmap(jax.vmap(jax.random.fold_in, (None, 0)), (None, 0))(
        base, pid)
    ref_w = jax.random.key_data(ref)
    np.testing.assert_array_equal(np.asarray(pk0), np.asarray(ref_w[..., 0]))
    np.testing.assert_array_equal(np.asarray(pk1), np.asarray(ref_w[..., 1]))
