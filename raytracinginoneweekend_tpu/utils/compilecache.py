"""Persistent XLA compilation cache wiring.

Every entry point (CLI, bench.py, chip_smoke.py, the render server, the
test conftest) enables jax's on-disk compilation cache, so a second
process with the same programs skips their compiles.

Where the cache lives:
  * ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (jax reads
    it itself; nothing here sets another directory);
  * otherwise one fixed directory inside the checkout, ``.jax_cache`` at
    the repository root (listed in .gitignore). The path is part of the
    cache's key, so it is never built from a temporary name, a pid or
    the time. On the CPU backend it gets a subdirectory per host CPU
    feature set (see _host_cpu_tag).
"""

from __future__ import annotations

import hashlib
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _host_cpu_tag() -> str:
    """Hash of the host CPU feature set.

    XLA:CPU caches AOT executables compiled FOR THE CACHING MACHINE'S
    feature set; loading one on a host with different features is
    documented to 'lead to execution errors such as SIGILL'. Scoping the
    CPU cache directory by the cpuinfo flags line makes cross-machine
    reuse impossible.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return platform.machine() or "unknown"


def cache_dir(backend: str) -> str:
    """The directory the cache uses for ``backend`` ("cpu", "gpu", ...)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if backend == "cpu":
        return os.path.join(DEFAULT_DIR, _host_cpu_tag())
    return DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Enable the cache (idempotent); returns its directory."""
    import jax

    path = cache_dir(jax.default_backend())
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything: small entries and fast compiles included.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
