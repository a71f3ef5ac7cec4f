"""Where the persistent compilation cache lives."""

import os

from raytracinginoneweekend_tpu.utils import compilecache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_environment_variable_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    for backend in ("gpu", "cpu"):
        assert compilecache.cache_dir(backend) == str(tmp_path)


def test_default_is_one_fixed_gitignored_directory(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    gpu = compilecache.cache_dir("gpu")
    assert gpu == os.path.join(REPO, ".jax_cache")
    assert gpu == compilecache.cache_dir("gpu")  # no pid, time or tmp name
    cpu = compilecache.cache_dir("cpu")
    assert os.path.dirname(cpu) == gpu  # per host-CPU subdirectory
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enabled_cache_is_in_jax_config(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilecache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == path
    assert path == compilecache.cache_dir(jax.default_backend())
