"""Multi-chip / multi-host parallelism.

The reference has NO distributed layer at all (SURVEY section 2 parallelism
table: single process, single GPU, Thrust H2D/D2H only). This package adds
it:

  - ``mesh``: 1-D device mesh over the flattened pixel/ray axis; forward
    rendering is embarrassingly parallel (zero collectives); parameter
    gradients are all-reduced by shard_map's transpose (psum) for inverse
    rendering.
  - ``distributed``: multi-host process-group bring-up
    (jax.distributed.initialize) + host-0 framebuffer gather.

Shard-invariance contract: every random draw is keyed only by global
(pixel, sample, bounce) ids (ops/rng.py), so a 1-device and an N-device
render of the same config agree up to float accumulation order.
"""

from .mesh import (make_mesh, render_sharded, render_image_sharded,  # noqa: F401
                   render_wavefront_sharded)
from .distributed import initialize_distributed  # noqa: F401
