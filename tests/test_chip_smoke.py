"""chip_smoke.py refuses to run without a GPU, and its GPU phases."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    res = _run([], REPO)
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert '"ok"' not in res.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run([], str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("devices,four,message", [
    ([SimpleNamespace(platform="cpu")], False, "needs a GPU"),
    ([SimpleNamespace(platform="gpu")], True, "needs 4 GPUs"),
    ([SimpleNamespace(platform="gpu")] * 3, True, "needs 4 GPUs"),
])
def test_require_gpus_refuses(devices, four, message):
    with pytest.raises(SystemExit, match=message):
        chip_smoke.require_gpus(devices, 4 if four else 1)


def test_require_gpus_accepts_enough_gpus():
    chip_smoke.require_gpus([SimpleNamespace(platform="gpu")] * 4, 4)
    chip_smoke.require_gpus([SimpleNamespace(platform="gpu")], 1)


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu):
    """The compiled kernel against the reference (chip_smoke's phase)."""
    chip_smoke.kernel_phase(n_rays=1 << 14)
