"""The tile-order pixel swizzle behind ownership="tile"."""

import jax.numpy as jnp
import numpy as np

from raytracinginoneweekend_tpu.ops import tiles

W, H = 1200, 800


def test_tile_pixel_bijection():
    _, _, n_vp = tiles.virtual_grid(W, H)
    pid, valid = tiles.tile_pixel(jnp.arange(n_vp), W, H)
    pids = np.asarray(pid)[np.asarray(valid)]
    assert len(pids) == W * H
    assert len(np.unique(pids)) == W * H
