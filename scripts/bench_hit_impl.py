#!/usr/bin/env python
"""Closest-hit implementation study on one GPU.

    python scripts/bench_hit_impl.py kernel    # kernel check + block sweep
    python scripts/bench_hit_impl.py impl      # Triton vs XLA, flagship frame
    python scripts/bench_hit_impl.py step      # Triton vs XLA, train step
    python scripts/bench_hit_impl.py ad-depth  # planar vs regenerative AD
    python scripts/bench_hit_impl.py profile   # device time by kernel

Several studies may be named in one call (one process, one compile
cache). Every timing is a warm run (compiled beforehand), waited for on
the device; the card's name and power limit are printed first.

  kernel    chip_smoke.kernel_phase (compile + numerics), then the Triton
            kernel alone on 2^18 probe rays for each (block, num_warps),
            beside the XLA closest hit on the same rays;
  impl      the flagship frame (huge scene, 1200x800 @ 100 spp, depth 50)
            with the Triton kernel and with the XLA closest hit, at pool
            sizes 2^15 .. 2^18, alternating which runs first;
  step      the flagship interior train step (16384 px x 8 spp, depth
            50) on the regenerative AD engine (pools 2^15 and 2^17) and
            the planar one, per implementation, in the order triton,
            xla, xla, triton;
  ad-depth  the interior train step on the planar and the regenerative
            AD engines at depths 16, 32 and 50, per implementation;
  profile   one traced flagship frame per implementation and pool (2^15,
            2^17): device time by kernel and the device idle share.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

W, H, SPP, DEPTH = 1200, 800, 100, 50
BATCH, FIT_SPP = 16384, 8


def _warm_time(fn, reps: int = 1) -> float:
    """Median seconds of ``reps`` warm calls (one compile call first)."""
    import jax

    jax.block_until_ready(fn())
    return statistics.median(chip_smoke.timed(fn)[0] for _ in range(reps))


def _flagship():
    from raytracinginoneweekend_tpu import cli

    return cli._build_scene("huge", 0), cli._build_camera("cpu", W, H)


def _frame_fn(pool_size: int):
    import jax

    from raytracinginoneweekend_tpu.config import DEFAULT
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront

    scene, cam = _flagship()
    return lambda: render_wavefront(
        scene, cam, jax.random.key(0), width=W, height=H, spp=SPP,
        max_depth=DEPTH, camera_mode="thinlens", options=DEFAULT,
        pool_size=pool_size)


def _frame(pool_size: int) -> float:
    return _warm_time(_frame_fn(pool_size))


def _train_step(engine: str, depth: int, reps: int = 3,
                pool_size: int | None = None) -> float:
    import jax
    import jax.numpy as jnp
    import optax

    from raytracinginoneweekend_tpu.config import DEFAULT
    from raytracinginoneweekend_tpu.optim import (make_train_step,
                                                  params_from_scene)

    scene, cam = _flagship()
    params = params_from_scene(scene, ("albedo", "centers"))
    opt = optax.adam(1e-2)
    step = make_train_step(opt, width=W, height=H, spp=FIT_SPP,
                           max_depth=depth, camera_mode="thinlens",
                           options=DEFAULT, engine=engine,
                           engine_opts=({"pool_size": pool_size}
                                        if pool_size else None))
    ids = jax.random.choice(jax.random.key(3), W * H, (BATCH,),
                            replace=False).astype(jnp.int32)
    target = jax.random.uniform(jax.random.key(4), (BATCH, 3))
    state = opt.init(params)
    return _warm_time(lambda: step(params, state, scene, cam, target, ids,
                                   jax.random.key(5)), reps)


@contextlib.contextmanager
def _impl(name: str):
    """Route every closest hit through ``name`` ("triton" or "xla")."""
    import jax

    from raytracinginoneweekend_tpu.ops import pallas_segment as ps

    chosen = ps.default_impl
    ps.default_impl = lambda n_rays: name
    jax.clear_caches()
    try:
        yield
    finally:
        ps.default_impl = chosen
        jax.clear_caches()


def _device_time_table(trace_dir: str, top: int = 25) -> None:
    """Print device time by kernel name and the device busy share."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = ProfileData.from_file(path)
    by_name, spans = {}, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        print(f"  plane {plane.name}: lines "
              f"{[(ln.name, len(list(ln.events))) for ln in plane.lines]}")
        for line in plane.lines:
            if "Modules" in line.name or "Steps" in line.name:
                continue
            for ev in line.events:
                key = (line.name, ev.name)
                tot, cnt = by_name.get(key, (0.0, 0))
                by_name[key] = (tot + ev.duration_ns, cnt + 1)
                if "Ops" not in line.name:
                    spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    print(f"  device busy {busy / 1e6:.2f} ms of a {window / 1e6:.2f} ms "
          f"window (idle share {1 - busy / max(window, 1):.4f})")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for (line, name), (tot, cnt) in rows:
        print(f"  {tot / 1e6:10.2f} ms {cnt:7d}x  [{line[:24]}] "
              f"{name[:90]}")


def study_kernel():
    import jax

    from raytracinginoneweekend_tpu.ops import pallas_segment as ps
    from raytracinginoneweekend_tpu.utils.timing import time_fn

    chip_smoke.kernel_phase()
    rays, sp = chip_smoke.probe_rays()
    cx, cy, cz, r = sp[:4]
    n = rays[0].size
    xla = jax.jit(lambda rs: ps.closest_hit_xla(rs, cx, cy, cz, r,
                                                chip_smoke.T_MIN))
    secs, _ = time_fn(xla, rays, warmup=1, iters=20)
    print(f"kernel-sweep xla {secs * 1e3:.4f} ms ({n} rays)", flush=True)
    for block, warps in itertools.product((128, 256, 512, 1024),
                                          (2, 4, 8)):
        fn = jax.jit(lambda rs, b=block, w=warps: ps.closest_hit_triton(
            rs, cx, cy, cz, r, chip_smoke.T_MIN, block=b, num_warps=w))
        secs, _ = time_fn(fn, rays, warmup=1, iters=20)
        print(f"kernel-sweep block {block} warps {warps} "
              f"{secs * 1e3:.4f} ms", flush=True)


def study_impl():
    for k in (15, 16, 17, 18):
        order = ("triton", "xla") if k % 2 else ("xla", "triton")
        for impl in order:
            with _impl(impl):
                secs = _frame(1 << k)
            print(f"impl {impl} pool 2^{k}: flagship frame {secs:.4f} s "
                  f"({W * H * SPP / secs / 1e6:.2f} Mrays/s)", flush=True)


def study_step():
    for impl in ("triton", "xla", "xla", "triton"):
        with _impl(impl):
            for engine, pool in (("wavefront", 1 << 15),
                                 ("wavefront", 1 << 17), ("planar", None)):
                secs = _train_step(engine, DEPTH, pool_size=pool)
                print(f"step {impl} {engine} pool {pool}: interior train "
                      f"step {secs * 1e3:.2f} ms", flush=True)


def study_ad_depth():
    for impl in ("xla", "triton"):
        with _impl(impl):
            for depth in (16, 32, 50):
                for engine in ("planar", "wavefront"):
                    secs = _train_step(engine, depth)
                    print(f"ad-depth {impl} {depth} {engine}: interior "
                          f"train step {secs * 1e3:.2f} ms", flush=True)


def study_profile():
    import jax

    import tempfile

    out = tempfile.mkdtemp(prefix="rtw_traces_")
    for impl in ("triton", "xla"):
        for pool in (1 << 15, 1 << 17):
            with _impl(impl):
                fn = _frame_fn(pool)
                jax.block_until_ready(fn())  # compile and warm
                d = os.path.join(out, f"{impl}_{pool}")
                with jax.profiler.trace(d):
                    secs, _ = chip_smoke.timed(fn)
                print(f"profile {impl} pool {pool}: traced frame "
                      f"{secs:.4f} s", flush=True)
                _device_time_table(d)


STUDIES = {"kernel": study_kernel, "impl": study_impl, "step": study_step,
           "ad-depth": study_ad_depth, "profile": study_profile}


def main(argv) -> int:
    import jax

    from raytracinginoneweekend_tpu.utils.compilecache import (
        enable_persistent_cache)

    names = argv or ["kernel"]
    unknown = [n for n in names if n not in STUDIES]
    if unknown:
        sys.exit(f"unknown studies {unknown}; choose from {list(STUDIES)}")
    chip_smoke.require_gpus(jax.devices(), 1)
    enable_persistent_cache()
    dev = jax.devices()[0]
    print(f"device {dev.device_kind}; nvidia-smi: {chip_smoke.gpu_info()}",
          flush=True)
    for name in names:
        t0 = time.perf_counter()
        STUDIES[name]()
        print(f"study {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
