"""Multi-host (multi-process) smoke test on CPU via jax.distributed.

Spawns two real processes that form a jax.distributed process group over
localhost, build a global 2-device mesh, render a sharded image, and
verify (a) both processes agree and (b) the result matches a single-process
render bit-for-bit -- the shard-invariance contract that makes multi-host
scaling numbers honest (SURVEY section 7 "multi-host determinism").
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)  # exactly 1 local device per process

import jax

coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=rank)

from raytracinginoneweekend_tpu.parallel.mesh import make_mesh, render_sharded
from raytracinginoneweekend_tpu.models.scene import simple_scene_cuda
from raytracinginoneweekend_tpu.models.camera import reference_cuda_camera
from raytracinginoneweekend_tpu.config import DEFAULT
import jax.numpy as jnp
import numpy as np
assert jax.device_count() == 2, jax.device_count()
assert jax.process_count() == 2

W, H, SPP, DEPTH = 16, 8, 2, 3
scene = simple_scene_cuda()
cam = reference_cuda_camera(W, H)
ids = jnp.arange(W * H, dtype=jnp.int32)
img = render_sharded(scene, cam, ids, jax.random.key(3), mesh=make_mesh(),
                     width=W, height=H, spp=SPP, wave_spp=SPP,
                     max_depth=DEPTH, camera_mode="thinlens",
                     options=DEFAULT)
from jax.experimental import multihost_utils
full = multihost_utils.process_allgather(img, tiled=True)
np.save(out, np.asarray(full))
print("WORKER_OK", rank)
"""


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs, outs = [], []
    for rank in range(2):
        out = os.path.join(tmp_path, f"img{rank}.npy")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(rank), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{log}"
        assert f"WORKER_OK {rank}" in log

    a = np.load(outs[0])
    b = np.load(outs[1])
    np.testing.assert_array_equal(a, b)

    # Single-process ground truth (this process: 8 virtual devices, but the
    # RNG contract makes the image independent of sharding).
    import jax
    import jax.numpy as jnp

    from raytracinginoneweekend_tpu.config import DEFAULT
    from raytracinginoneweekend_tpu.models.camera import reference_cuda_camera
    from raytracinginoneweekend_tpu.models.scene import simple_scene_cuda
    from raytracinginoneweekend_tpu.render import render_pixels

    W, H, SPP, DEPTH = 16, 8, 2, 3
    want = render_pixels(
        simple_scene_cuda(), reference_cuda_camera(W, H),
        jnp.arange(W * H, dtype=jnp.int32), jax.random.key(3), width=W,
        height=H, spp=SPP, wave_spp=SPP, max_depth=DEPTH,
        camera_mode="thinlens", options=DEFAULT)
    np.testing.assert_array_equal(a, np.asarray(want))
