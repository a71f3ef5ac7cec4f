#!/usr/bin/env python
"""Headline benchmark: rays/s, huge scene 1200x800 @ 100spp, depth 50.

Runs on one GPU and exits non-zero when JAX finds none. Prints the card's
name and power limit (nvidia-smi) on stderr and ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "rays/s", "device": {...}, ...}

Usage: python bench.py [--small]   (--small: quick smoke config)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def gpu_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def main() -> None:
    small = "--small" in sys.argv

    import dataclasses

    import jax

    from raytracinginoneweekend_tpu.utils.compilecache import (
        enable_persistent_cache)

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    enable_persistent_cache()
    dev = jax.devices()[0]
    print(gpu_info(), file=sys.stderr, flush=True)

    from raytracinginoneweekend_tpu.config import DEFAULT, RenderConfig
    from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
    from raytracinginoneweekend_tpu.models.scene import huge_scene
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
    from raytracinginoneweekend_tpu.render import render_rays_count
    from raytracinginoneweekend_tpu.utils.timing import time_fn

    if small:
        cfg = RenderConfig(width=240, height=160, spp=8, max_depth=12,
                           camera_mode="thinlens", options=DEFAULT)
    else:
        cfg = RenderConfig(width=1200, height=800, spp=100, max_depth=50,
                           camera_mode="thinlens", options=DEFAULT)
    scene = huge_scene(seed=0)
    cam = reference_cpu_camera(cfg.width, cfg.height)
    key = jax.random.key(0)
    rays = render_rays_count(cfg)

    def arm(options, iters):
        """One estimator arm: timed run + one stats run (same program
        minus the counters, so the timed number carries no stats cost)."""
        def run():
            return render_wavefront(
                scene, cam, key, width=cfg.width, height=cfg.height,
                spp=cfg.spp, max_depth=cfg.max_depth,
                camera_mode=cfg.camera_mode, options=options)

        seconds, image = time_fn(run, warmup=1, iters=iters)
        _, stats = render_wavefront(
            scene, cam, key, width=cfg.width, height=cfg.height,
            spp=cfg.spp, max_depth=cfg.max_depth,
            camera_mode=cfg.camera_mode, options=options,
            return_stats=True)
        it = int(stats["iters"])
        segs = int(stats["segments"])
        lanes = int(stats["lanes"])
        slots = it * lanes
        return {
            "rays_per_s": rays / seconds,
            "seconds_per_frame": seconds,
            "segments": segs,
            "segments_per_s": segs / seconds,
            "iters": it,
            "occupancy": segs / slots,
            "ns_per_lane_slot": seconds / slots * 1e9,
        }, image

    # Arm 1 (headline): the reference-faithful estimator (no early path
    # termination -- matches main.cxx:52-75 / cuda_impl.cu:265-297
    # semantics).
    ref_arm, image = arm(cfg.options, iters=4)
    # Arm 2: Russian-roulette path termination (unbiased estimator
    # change, parity-gated vs the reference C++ harness in
    # tests/test_reference_parity.py::test_rr_terminate_matches_reference).
    rr_arm, _ = arm(dataclasses.replace(cfg.options, rr_terminate=True),
                    iters=2)
    # Arm 3: the full estimator toolbox (stratified pixel/lens/bounce-0
    # sampling + RR termination, both opt-in and unbiased).
    toolbox_arm, _ = arm(dataclasses.replace(
        cfg.options, rr_terminate=True, sampling="stratified"), iters=2)

    value = ref_arm["rays_per_s"]
    record = {
        "metric": "rays_per_s_huge_1200x800_100spp_d50"
                  if not small else "rays_per_s_small_smoke",
        "value": value,
        "unit": "rays/s",
        "seconds_per_frame": ref_arm["seconds_per_frame"],
        "camera_rays": rays,
        "spheres": int(scene.num_spheres),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
        "occupancy": ref_arm["occupancy"],
        "segments_per_s": ref_arm["segments_per_s"],
        "ns_per_lane_slot": ref_arm["ns_per_lane_slot"],
        "arms": {"reference_faithful": ref_arm, "rr_terminate": rr_arm,
                 "stratified_rr_toolbox": toolbox_arm},
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
