#!/usr/bin/env python
"""Variance A/B for sampling='stratified' vs 'iid' (+ GPU speed cost).

Per-pixel variance across independent keys. Rows cover the AA-dominated
(pinhole), the cover (huge/thinlens), and a defocus-DOMINATED
(wide-aperture) config -- the last is what the round-4 lens-pair
stratification (rng.stratify_lens_uv) targets.

Variance is an estimator property -- measured on CPU by default
(device-independent); run on a GPU for the speed-cost block only.

Usage: python scripts/bench_stratified.py [--gpu-cost]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from raytracinginoneweekend_tpu.config import DEFAULT
from raytracinginoneweekend_tpu.models.camera import (make_camera,
                                                      reference_cpu_camera)
from raytracinginoneweekend_tpu.models.scene import (huge_scene,
                                                     simple_scene_cuda)
from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront

N_KEYS = 8
SPP = 16


def row(label, scene, cam, camera_mode, w, h, depth=8):
    frames = {}
    for smp in ("iid", "stratified"):
        o = dataclasses.replace(DEFAULT, sampling=smp)
        fr = np.stack([np.asarray(render_wavefront(
            scene, cam, jax.random.key(k), width=w, height=h, spp=SPP,
            max_depth=depth, camera_mode=camera_mode, options=o,
            pool_size=2048)) for k in range(N_KEYS)])
        frames[smp] = fr
    var = {s: f.var(0, ddof=1).mean() for s, f in frames.items()}
    return {"config": label,
            "var_ratio_strat_over_iid": round(
                float(var["stratified"] / var["iid"]), 4),
            "mean_iid": round(float(frames["iid"].mean()), 5),
            "mean_stratified": round(
                float(frames["stratified"].mean()), 5)}


def main():
    if "--gpu-cost" in sys.argv:
        from raytracinginoneweekend_tpu.utils.compilecache import (
            enable_persistent_cache)
        from raytracinginoneweekend_tpu.utils.timing import time_fn

        enable_persistent_cache()
        scene = huge_scene(0)
        cam = reference_cpu_camera(1200, 800)
        out = {}
        for smp in ("iid", "stratified"):
            o = dataclasses.replace(DEFAULT, sampling=smp)
            sec, _ = time_fn(lambda: render_wavefront(
                scene, cam, jax.random.key(0), width=1200, height=800,
                spp=100, max_depth=50, camera_mode="thinlens",
                options=o), warmup=1, iters=3)
            out[smp] = 1200 * 800 * 100 / sec
        out["cost_frac"] = 1.0 - out["stratified"] / out["iid"]
        print(json.dumps({"metric": "stratified_gpu_speed_cost",
                          "rays_per_s": out,
                          "device": jax.devices()[0].device_kind}))
        return

    w, h = 48, 32
    rows = [
        row("simple/pinhole/16", simple_scene_cuda(),
            reference_cpu_camera(w, h), "pinhole", w, h),
        row("huge/thinlens/16 (cover, aperture .0625)", huge_scene(0),
            reference_cpu_camera(w, h), "thinlens", w, h),
        # Defocus-dominated: aperture 0.5 focused on the center sphere
        # (the lens integral is most of the per-pixel variance).
        row("simple/thinlens-wide/16 (aperture 0.5)", simple_scene_cuda(),
            make_camera((-4, 3.2, 5), (0, 1, 0), (0, 1, 0), w / h, 42.0,
                        0.5, float(np.linalg.norm((-4, 2.2, 5)))),
            "thinlens", w, h),
    ]
    print(json.dumps({
        "metric": "stratified_sampling_variance",
        "note": f"per-pixel variance across {N_KEYS} keys at {SPP} spp, "
                "depth 8; round 4 stratifies the LENS pair "
                "(rng.stratify_lens_uv, thinlens mode) AND the "
                "first-bounce scatter pair (rng.strat0_scatter)",
        "rows": rows}))


if __name__ == "__main__":
    main()
