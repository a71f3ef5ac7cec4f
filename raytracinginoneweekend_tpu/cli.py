"""Command-line driver: the app layer (SURVEY L6, #24/#25 -> runtime flags).

The reference's ``main()`` hardcodes scene/camera/resolution at compile time
(main.cxx:22-37, 104-118); here every knob is a flag. Three subcommands:

  render  -- render a scene to PPM/PNG (the reference's one behavior)
  bench   -- rays/s measurement on any config
  fit     -- inverse rendering demo: perturb the scene, recover it from the
             target image (BASELINE config 5), with checkpoint/resume

Examples:
  python -m raytracinginoneweekend_tpu render --scene simple-cuda \
      --width 1920 --height 1080 --spp 48 --out image.png
  python -m raytracinginoneweekend_tpu render --scene huge --camera cpu \
      --width 1200 --height 800 --spp 100 --depth 50 --out cover.png
  python -m raytracinginoneweekend_tpu fit --steps 100 --out-dir /tmp/fit
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_scene(name: str, seed: int):
    from .models import scene as scenes

    built = {
        "simple-cuda": lambda: scenes.simple_scene_cuda(),
        "simple-cpu": lambda: scenes.simple_scene_cpu(),
        "huge": lambda: scenes.huge_scene(seed),
        "wall": lambda: scenes.wall_scene(seed),
    }[name]()
    return scenes.validate_scene(built)


def _build_camera(name: str, width: int, height: int):
    from .models import camera as cameras

    return {
        "cuda": cameras.reference_cuda_camera,
        "cpu": cameras.reference_cpu_camera,
    }[name](width, height)


def _options(compat: str, rr_terminate: bool = False,
             ownership: str | None = None, sampling: str | None = None):
    import dataclasses

    from . import config

    opts = {
        "default": config.DEFAULT,
        "reference-cuda": config.REFERENCE_CUDA,
        "reference-cpu": config.REFERENCE_CPU,
    }[compat]
    if rr_terminate:
        opts = dataclasses.replace(opts, rr_terminate=True)
    if ownership is not None:
        opts = dataclasses.replace(opts, ownership=ownership)
    if sampling is not None:
        opts = dataclasses.replace(opts, sampling=sampling)
    return opts


def _add_render_flags(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="simple-cuda",
                   choices=["simple-cuda", "simple-cpu", "huge", "wall"])
    p.add_argument("--camera", default=None, choices=["cuda", "cpu"],
                   help="default: cuda for simple-cuda, cpu otherwise")
    p.add_argument("--mode", default="thinlens",
                   choices=["thinlens", "pinhole", "cuda", "cpu"],
                   help="camera defocus mode (models/camera.py)")
    p.add_argument("--compat", default="default",
                   choices=["default", "reference-cuda", "reference-cpu"])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=48)
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "wavefront", "wavefront-sharded",
                            "tiled"],
                   help="auto = the wavefront engine")
    from .config import POOL_SIZE

    p.add_argument("--pool-size", type=int, default=POOL_SIZE)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    p.add_argument("--ownership", default=None,
                   choices=["strided", "tile"],
                   help="wavefront task-ownership layout (TraceOptions."
                        "ownership; 'tile' = block-contiguous 32x32-"
                        "pixel tile ranges)")
    p.add_argument("--sampling", default=None,
                   choices=["iid", "stratified"],
                   help="pixel-jitter sampling (TraceOptions.sampling; "
                        "'stratified' = opt-in low-discrepancy jitter, "
                        "unbiased; measured 17%% lower variance on the "
                        "cover config, 2.1x on pinhole-AA configs)")
    p.add_argument("--adaptive", action="store_true",
                   help="two-stage adaptive sampling (adaptive.py): "
                        "--spp becomes the base; the noisiest 6.25%% of "
                        "pixels get +4x and the next 25%% +1x extra "
                        "samples (avg 1.5x budget). Opt-in estimator "
                        "change; composes with --sampling stratified "
                        "(stage 1 keeps the full stratified pattern, "
                        "tiers draw iid); runs on the planar engine")
    p.add_argument("--rr-terminate", action="store_true",
                   help="Russian-roulette path termination (unbiased "
                        "estimator change: fewer traced segments, "
                        "slightly higher MC variance; honored by every "
                        "engine -- wavefront, planar AD, tiled -- and "
                        "fit)")
    p.add_argument("--stats", action="store_true",
                   help="print the wavefront engine's occupancy counters "
                        "(iterations, traced segments, lane occupancy) as "
                        "a JSON line on stderr; wavefront engine only")
    p.add_argument("--via", default=None, metavar="SOCKET",
                   help="forward to a running render server (see the "
                        "serve subcommand); repeat configurations skip "
                        "compilation entirely")


def _render_image(args):
    import jax

    from .config import RenderConfig
    from .ops.wavefront import render_wavefront
    from .render import render

    scene = _build_scene(args.scene, args.seed)
    camera_name = args.camera or ("cuda" if args.scene == "simple-cuda"
                                  else "cpu")
    cam = _build_camera(camera_name, args.width, args.height)
    options = _options(args.compat, getattr(args, "rr_terminate", False),
                       getattr(args, "ownership", None),
                       getattr(args, "sampling", None))
    key = jax.random.key(args.seed)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, camera_mode=args.mode,
                       options=options)
    engine = "wavefront" if args.engine == "auto" else args.engine
    kw = dict(width=args.width, height=args.height, spp=args.spp,
              max_depth=args.depth, camera_mode=args.mode,
              options=options, pool_size=args.pool_size)
    if getattr(args, "adaptive", False):
        from .adaptive import render_adaptive

        img, astats = render_adaptive(
            scene, cam, key, width=args.width, height=args.height,
            spp_base=args.spp, max_depth=args.depth,
            camera_mode=args.mode, options=options, return_stats=True)
        print(json.dumps({"adaptive": astats}), file=sys.stderr)
        return img.reshape(args.height, args.width, 3), cfg
    if engine == "wavefront":
        if getattr(args, "stats", False):
            img, stats = render_wavefront(scene, cam, key,
                                          return_stats=True, **kw)
            it = int(stats["iters"])
            seg = int(stats["segments"])
            lanes = int(stats["lanes"])
            print(json.dumps({
                "iters": it, "segments": seg, "lanes": lanes,
                "occupancy": seg / max(it * lanes, 1),
                "segments_per_camera_ray":
                    seg / (args.width * args.height * args.spp),
            }), file=sys.stderr)
        else:
            img = render_wavefront(scene, cam, key, **kw)
        img = img.reshape(args.height, args.width, 3)
    elif engine == "wavefront-sharded":
        from .parallel import make_mesh, render_wavefront_sharded

        img = render_wavefront_sharded(scene, cam, key, mesh=make_mesh(),
                                       **kw)
        img = img.reshape(args.height, args.width, 3)
    else:
        img = render(scene, cam, cfg, key)
    return img, cfg


def _via_server(args, cmd: str) -> int:
    """Forward a render/bench request to a running render server."""
    from . import serve

    # Handshake BOTH ways: the request carries proto (a newer server
    # rejects us), and we check the server's ping proto first (an OLDER
    # server would otherwise drop unknown request keys -- e.g. adaptive
    # -- and silently render something else).
    info = serve.request(args.via, {"cmd": "ping"})
    if info.get("proto") != serve.PROTO_VERSION:
        print(json.dumps({
            "ok": False,
            "error": f"server at {args.via} runs protocol "
                     f"{info.get('proto')!r}, client needs "
                     f"{serve.PROTO_VERSION} -- restart the server "
                     f"from this checkout"}))
        return 1
    if getattr(args, "stats", False) or getattr(args, "profile", None):
        # Same silent-divergence class as unforwarded TraceOptions:
        # the server would render fine but never produce the counters/
        # trace the user asked for. Refuse instead.
        print(json.dumps({
            "ok": False,
            "error": "--stats/--profile are not supported with --via; "
                     "run locally for engine counters or profiler "
                     "traces"}))
        return 1
    req = {"cmd": cmd, "proto": serve.PROTO_VERSION,
           "scene": args.scene, "seed": args.seed,
           "camera": args.camera, "mode": args.mode, "compat": args.compat,
           "width": args.width, "height": args.height, "spp": args.spp,
           "depth": args.depth, "engine": args.engine,
           "pool_size": args.pool_size,
           # TraceOptions knobs must forward too, or a --via render would
           # silently differ from the local one.
           "rr_terminate": getattr(args, "rr_terminate", False),
           "ownership": getattr(args, "ownership", None),
           "sampling": getattr(args, "sampling", None),
           "adaptive": getattr(args, "adaptive", False)}
    if cmd == "render":
        req["out"] = args.out
        req["clamp"] = not args.no_clamp
    elif cmd == "bench":
        req["iters"] = args.iters
    else:  # fit
        req.update({
            "params": args.params, "perturb": args.perturb,
            "steps": args.steps, "lr": args.lr,
            "batch_pixels": args.batch_pixels, "fit_spp": args.fit_spp,
            "boundary_samples": args.boundary_samples,
            "secondary_samples": args.secondary_samples,
            "secondary_vertex_depths": args.secondary_vertex_depths,
            "rr_grad": args.rr_grad, "rr_grad_arms": args.rr_grad_arms,
            "ad_engine": args.ad_engine,
            "log_every": args.log_every, "checkpoint": args.checkpoint,
            "checkpoint_every": args.checkpoint_every,
            "resume": args.resume})
    resp = serve.request(args.via, req)
    import json as _json

    print(_json.dumps(resp))
    return 0 if resp.get("ok") else 1


def cmd_render(args) -> int:
    if args.via:
        return _via_server(args, "render")
    import jax
    import numpy as np

    from .io.image import write_png, write_ppm
    from .ops.postprocess import to_u8

    import contextlib

    from .utils.timing import profile_trace

    prof = (profile_trace(args.profile) if args.profile
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        img, cfg = _render_image(args)
        jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    u8 = np.asarray(to_u8(img, clamp=not args.no_clamp))
    writer = write_png if args.out.endswith(".png") else write_ppm
    writer(args.out, u8)
    rays = args.width * args.height * args.spp
    print(f"wrote {args.out} ({args.width}x{args.height} @ {args.spp}spp, "
          f"depth {args.depth}) in {dt:.2f}s incl. compile "
          f"({rays / dt / 1e6:.2f} Mrays/s)")
    return 0


def cmd_bench(args) -> int:
    if args.via:
        return _via_server(args, "bench")
    import jax

    from .utils.timing import time_fn

    def run():
        img, _ = _render_image(args)
        return img

    seconds, _ = time_fn(run, warmup=1, iters=args.iters)
    rays = args.width * args.height * args.spp
    print(json.dumps({
        "metric": f"rays_per_s_{args.scene}_{args.width}x{args.height}_"
                  f"{args.spp}spp_d{args.depth}_{args.engine}",
        "value": rays / seconds,
        "unit": "rays/s",
        "seconds_per_frame": seconds,
        "device": jax.devices()[0].platform,
    }))
    return 0


def _fit_impl(args, log=print) -> dict:
    """The fit pipeline (perturb -> recover); returns a result dict.

    Shared by cmd_fit (prints it) and the render server's "fit" command
    (returns it as the response), so iterative inverse rendering can run
    inside the long-lived server process and reuse its compiled steps.
    """
    import jax
    import jax.numpy as jnp

    import optax

    from .config import RenderConfig
    from .optim import (fit, load_checkpoint, params_from_scene,
                        save_checkpoint)
    from .render import render

    scene = _build_scene(args.scene, args.seed)
    camera_name = args.camera or ("cuda" if args.scene == "simple-cuda"
                                  else "cpu")
    cam = _build_camera(camera_name, args.width, args.height)
    # The estimator-toolbox knobs apply to fit too: rr_terminate cuts
    # traced segments in the regenerative AD engine (stop-gradiented
    # survival weights, ops/wavefront_ad.py) and sampling="stratified"
    # cuts gradient variance (albedo 0.63x, centers 0.54x at matching
    # means).
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, camera_mode=args.mode,
                       options=_options(
                           args.compat,
                           rr_terminate=getattr(args, "rr_terminate",
                                                False),
                           sampling=getattr(args, "sampling", None)))
    log("rendering target...")
    target = render(scene, cam, cfg, jax.random.key(args.seed))

    # Perturb the optimizable leaves, then recover them.
    k = jax.random.key(args.seed + 1)
    which = tuple(args.params.split(","))
    perturbed = scene
    for name in which:
        leaf = getattr(scene, name)
        k, sub = jax.random.split(k)
        noise = args.perturb * jax.random.normal(sub, leaf.shape)
        perturbed = perturbed._replace(**{name: leaf + noise})

    optimizer = optax.adam(args.lr)
    init = {}
    if args.resume:
        tmpl_p = params_from_scene(perturbed, which)
        p0, o0, step0 = load_checkpoint(args.resume, tmpl_p,
                                        optimizer.init(tmpl_p))
        init = dict(init_params=p0, init_opt_state=o0, start_step=step0)
        log(f"resumed from {args.resume} at step {step0}")

    ckpt_path = args.checkpoint

    def callback(i, params, opt_state, loss):
        if (i + 1) % args.log_every == 0:
            log(f"step {i + 1}: loss {loss:.6f}")
        if ckpt_path and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(ckpt_path, params, opt_state, i + 1)

    _, params, opt_state, losses = fit(
        perturbed, cam, target, cfg, which=which, steps=args.steps,
        learning_rate=args.lr, batch_pixels=args.batch_pixels,
        spp=args.fit_spp, optimizer=optimizer, callback=callback,
        boundary_samples=args.boundary_samples,
        secondary_samples=args.secondary_samples,
        secondary_vertex_depths=args.secondary_vertex_depths,
        rr_grad=args.rr_grad, rr_grad_arms=args.rr_grad_arms,
        engine=args.ad_engine, **init)
    if ckpt_path:
        save_checkpoint(ckpt_path, params, opt_state,
                        init.get("start_step", 0) + args.steps)
    truth = params_from_scene(scene, which)
    errors = {name: float(jnp.abs(params[name] - truth[name]).max())
              for name in which}
    return {"errors": errors, "loss_start": losses[0],
            "loss_end": losses[-1], "steps": len(losses)}


def cmd_fit(args) -> int:
    if args.via:
        return _via_server(args, "fit")
    res = _fit_impl(args, log=lambda s: print(s, flush=True))
    for name, err in res["errors"].items():
        print(f"{name}: max abs err vs truth = {err:.5f}")
    print(f"loss: {res['loss_start']:.6f} -> {res['loss_end']:.6f}")
    return 0


def main(argv=None) -> int:
    from .utils.compilecache import enable_persistent_cache

    enable_persistent_cache()
    parser = argparse.ArgumentParser(prog="raytracinginoneweekend_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PPM/PNG")
    _add_render_flags(p)
    p.add_argument("--out", default="image.png")
    p.add_argument("--no-clamp", action="store_true",
                   help="reference-exact raw u8 cast (can wrap, quirk Q6)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="measure rays/s")
    _add_render_flags(p)
    p.add_argument("--iters", type=int, default=2)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("serve", help="persistent render server "
                                     "(compiles amortize across requests)")
    p.add_argument("--socket", default="/tmp/rtw.sock")
    p.set_defaults(fn=lambda a: __import__(
        "raytracinginoneweekend_tpu.serve", fromlist=["serve"]
    ).serve(a.socket))

    p = sub.add_parser("fit", help="inverse rendering demo")
    _add_render_flags(p)
    p.add_argument("--params", default="albedo,centers",
                   help="comma list of centers,radii,albedo,fuzz,ior")
    p.add_argument("--perturb", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--batch-pixels", type=int, default=4096)
    p.add_argument("--fit-spp", type=int, default=4)
    p.add_argument("--boundary-samples", type=int, default=0,
                   help="edge samples/sphere for silhouette gradients "
                        "(0 = interior AD only; needed to optimize "
                        "centers/radii through visibility changes)")
    p.add_argument("--secondary-samples", type=int, default=0,
                   help="silhouette angles/candidate for the one-bounce "
                        "(shadow/rough-reflection) boundary term (0 = off)")
    p.add_argument("--secondary-vertex-depths", type=int, default=1,
                   help="path-vertex depths the secondary boundary term "
                        "covers (1 = first hit only; n sums vertex "
                        "depths 0..n-1)")
    p.add_argument("--ad-engine", default="auto",
                   choices=["auto", "wavefront", "planar", "tiled"],
                   help="reverse-mode engine: 'auto' = by depth (planar "
                        "up to optim.inverse.AD_ENGINE_AUTO_DEPTH, "
                        "wavefront above), "
                        "'wavefront' = regenerative pool "
                        "(ops/wavefront_ad.py, wavefront-class occupancy "
                        "at high depth), 'planar' = fixed-depth (R,128) "
                        "scan, 'tiled' = the (N,3) scan")
    p.add_argument("--rr-grad", action="store_true",
                   help="add the dielectric Russian-roulette branch-flip "
                        "gradient term (needed for accurate ior "
                        "gradients; ops/branchprob.py)")
    p.add_argument("--rr-grad-arms", type=int, default=2,
                   help="internal-RR reflection arms per refract chain "
                        "in the delta-lobe term -- its cost-policy knob "
                        "(each arm adds probe traces; accuracy needs "
                        ">= 1 only when internally-reflected content is "
                        "visible)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_fit)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
