"""Tile-order pixel swizzle for the wavefront engine's tile ownership.

With TraceOptions.ownership="tile" the engine walks tasks over a padded
grid of TILE x TILE pixel tiles (ops/wavefront.py); these closed forms
map a virtual (tile-order) pixel index back to its row-major pixel id.
"""

from __future__ import annotations

import jax.numpy as jnp

TILE = 32  # tile edge of the pixel swizzle (power of two)


def virtual_grid(width: int, height: int, tile: int = TILE):
    """Padded tile grid: (tiles_x, tiles_y, virtual pixel count)."""
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    return tiles_x, tiles_y, tiles_x * tiles_y * tile * tile


def tile_pixel(vp, width: int, height: int, tile: int = TILE):
    """Virtual (tile-order) pixel index -> (row-major pixel id, valid).

    Tiles are row-major over a PADDED tile grid; pixels row-major inside
    each tile. Virtual pixels outside the true image return valid=False
    (their tasks resolve instantly; padding waste is < 2% for the
    shipped configs). Closed-form integer arithmetic only, so no lookup
    table is gathered per lane.
    """
    tiles_x = -(-width // tile)
    tile_sz = tile * tile
    t_id = vp // tile_sz
    o = vp - t_id * tile_sz
    ty = t_id // tiles_x
    tx = t_id - ty * tiles_x
    oy = o // tile
    oxs = o - oy * tile
    py = ty * tile + oy
    px = tx * tile + oxs
    valid = (px < width) & (py < height)
    pid = jnp.where(valid, py * width + px, 0)
    return pid, valid
