"""Multi-host bring-up and host-0 image gather.

The reference is single-process/single-GPU (SURVEY section 5 "distributed
communication backend: absent"); this module adds it:
`jax.distributed.initialize` for the process group, a global 1-D mesh
over every device of every process, and a framebuffer gather to host 0
for image writing (the analogue of the reference's one D2H copy,
cuda_impl.cu:452 -- here it is the only cross-host data movement in the
whole forward path).
"""

from __future__ import annotations

import jax
import numpy as np


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Initialize the multi-host process group.

    Pass all three arguments: nothing on a plain GPU host tells JAX of a
    cluster (the coordinator is ``host:port`` of process 0, e.g.
    ``localhost:<free port>`` on one machine).
    Safe to call once per process, before any jax computation.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_primary_host() -> bool:
    return jax.process_index() == 0


def gather_image_to_host(image) -> np.ndarray | None:
    """Gather a (possibly cross-host sharded) rendered image to host 0.

    Returns the full (H, W, 3) numpy array on process 0, None elsewhere.
    Single-process: just a device->host copy.
    """
    if jax.process_count() == 1:
        return np.asarray(image)
    from jax.experimental import multihost_utils

    full = multihost_utils.process_allgather(image, tiled=True)
    return np.asarray(full) if is_primary_host() else None
