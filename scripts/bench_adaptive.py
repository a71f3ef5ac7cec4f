#!/usr/bin/env python
"""Equal-budget MSE: adaptive two-stage sampling vs uniform spp.

For each config: a converged planar reference (512 spp), then across
keys render (a) adaptive (spp_base 8, default tiers -> avg ~12 spp) and
(b) uniform at the SAME average budget (rounded UP, against adaptive).
Reports the MSE ratio; < 1 means adaptive wins at equal samples.

CPU-runnable (an estimator property, the same on any device).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from raytracinginoneweekend_tpu.adaptive import render_adaptive
from raytracinginoneweekend_tpu.config import DEFAULT
from raytracinginoneweekend_tpu.models.camera import (make_camera,
                                                      reference_cpu_camera)
from raytracinginoneweekend_tpu.models.scene import (huge_scene,
                                                     simple_scene_cuda)
from raytracinginoneweekend_tpu.ops.integrate_planar import (
    render_pixels_planar)

N_KEYS = 6


def run_config(label, scene, cam, w, h, depth):
    """Equal-budget 2x2 grid: {uniform, adaptive} x {iid, stratified}
    (round 4: the two variance reducers COMPOSE -- adaptive stage 1
    renders the complementary half-windows of the full stratified
    pattern via spp_strata; tiers fall back to iid)."""
    import dataclasses

    strat = dataclasses.replace(DEFAULT, sampling="stratified")
    ids = jnp.arange(w * h, dtype=jnp.int32)
    kw = dict(width=w, height=h, max_depth=depth, camera_mode="thinlens")
    truth = np.asarray(render_pixels_planar(
        scene, cam, ids, jax.random.key(999), spp=512, options=DEFAULT,
        **kw))
    mses = {k: [] for k in ("uniform_iid", "uniform_stratified",
                            "adaptive_iid", "adaptive_stratified")}
    spp_match = None
    for k in range(N_KEYS):
        key = jax.random.key(10 + k)
        img_ad, stats = render_adaptive(scene, cam, key, spp_base=8,
                                        return_stats=True,
                                        options=DEFAULT, **kw)
        img_ast, _ = render_adaptive(scene, cam, key, spp_base=8,
                                     return_stats=True, options=strat,
                                     **kw)
        spp_match = int(np.ceil(stats["avg_spp"]))
        img_un = render_pixels_planar(scene, cam, ids, key,
                                      spp=spp_match, options=DEFAULT,
                                      **kw)
        img_ust = render_pixels_planar(scene, cam, ids, key,
                                       spp=spp_match, options=strat,
                                       **kw)
        for name, img in (("uniform_iid", img_un),
                          ("uniform_stratified", img_ust),
                          ("adaptive_iid", img_ad),
                          ("adaptive_stratified", img_ast)):
            mses[name].append(
                float(((np.asarray(img) - truth) ** 2).mean()))
    base = float(np.mean(mses["uniform_iid"]))
    return {"config": label, "avg_spp_adaptive": stats["avg_spp"],
            "spp_uniform": spp_match,
            "mse": {k: float(np.mean(v)) for k, v in mses.items()},
            "mse_ratio_vs_uniform_iid": {
                k: round(float(np.mean(v)) / base, 4)
                for k, v in mses.items()}}


def main():
    w, h = 64, 36
    wide = make_camera((-4, 3.2, 5), (0, 1, 0), (0, 1, 0), w / h, 42.0,
                       0.5, float(np.linalg.norm((-4, 2.2, 5))))
    rows = [
        run_config("simple/thinlens-wide (aperture .5) d6",
                   simple_scene_cuda(), wide, w, h, 6),
        run_config("huge/thinlens cover d8", huge_scene(0),
                   reference_cpu_camera(w, h), w, h, 8),
    ]
    print(json.dumps({
        "metric": "adaptive_sampling_equal_budget_mse",
        "note": "equal-budget 2x2 {uniform, adaptive} x {iid, "
                "stratified}: two-stage adaptive (spp_base 8, tiers top "
                "6.25% +4x / next 25% +1x) vs uniform at the same "
                "(rounded-up) average spp; MSE vs a 512-spp reference "
                f"across {N_KEYS} keys, ratios vs uniform-iid",
        "rows": rows,
        "device": str(jax.devices()[0].platform)}))


if __name__ == "__main__":
    main()
