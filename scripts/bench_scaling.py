#!/usr/bin/env python
"""Scaling-efficiency measurement: rays/s at 1..N devices.

Scaling efficiency is rays/s at N devices over N times rays/s at one.
The forward wavefront is communication-free per device
(one psum of the partial framebuffers at the end), and the RNG contract
makes every mesh size produce the same image, so efficiency is purely a
load-balance/overlap question.

Run on a multi-GPU machine:
    python scripts/bench_scaling.py [--width 1200 --height 800 --spp 100]
On a CPU host it exercises the virtual 8-device mesh (correctness of the
harness, not meaningful absolute numbers).

Prints one JSON line per mesh size plus a final efficiency summary.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--spp", type=int, default=100)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--pool-size", type=int, default=None)
    args = ap.parse_args()

    import jax

    from raytracinginoneweekend_tpu.config import DEFAULT, POOL_SIZE
    from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
    from raytracinginoneweekend_tpu.models.scene import huge_scene
    from raytracinginoneweekend_tpu.parallel.mesh import (
        make_mesh, render_wavefront_sharded)
    from raytracinginoneweekend_tpu.utils.timing import time_fn

    scene = huge_scene(0)
    cam = reference_cpu_camera(args.width, args.height)
    key = jax.random.key(0)
    rays = args.width * args.height * args.spp

    devices = jax.devices()
    virtual = devices[0].platform == "cpu"
    if virtual:
        print(json.dumps({"note": (
            "CORRECTNESS-ONLY: cpu backend means a host-simulated mesh; "
            "all devices share one machine's FLOPs, so efficiency numbers "
            "are meaningless. Real scaling needs several GPUs.")}),
            flush=True)
    sizes = sorted({n for n in (1, 2, 4, 8, 16, 32, 64)
                    if n <= len(devices)})
    results = {}
    for n in sizes:
        mesh = make_mesh(devices[:n])

        def run():
            return render_wavefront_sharded(
                scene, cam, key, mesh=mesh, width=args.width,
                height=args.height, spp=args.spp, max_depth=args.depth,
                camera_mode="thinlens", options=DEFAULT,
                pool_size=args.pool_size or POOL_SIZE)

        sec, _ = time_fn(run, warmup=1, iters=2)
        results[n] = rays / sec
        print(json.dumps({"devices": n, "rays_per_s": results[n],
                          "seconds_per_frame": sec,
                          "virtual_mesh": virtual}), flush=True)

    base = results[sizes[0]]
    for n in sizes[1:]:
        eff = results[n] / (base * n / sizes[0])
        key = ("virtual_mesh_efficiency_meaningless" if virtual
               else "scaling_efficiency")
        print(json.dumps({"devices": n, key: eff}), flush=True)


if __name__ == "__main__":
    main()
