#!/usr/bin/env python
"""Smoke check of the renderer on a GPU, through the entry points users call.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

Phases, all in this one process:

  device   platform, device kind and count, and the card's name and power
           limit from nvidia-smi;
  kernel   the closest-hit kernel, compiled for the card, against the
           plain reference (ops/intersect.closest_hit) on 2^18 rays: the
           flagship camera's rays on the huge scene plus one bounce of
           them; the resolved parameter planes against the sphere table;
  render   the flagship frame (huge scene, 1200x800 @ 100 spp, depth 50)
           and the reference's active config (simple-cuda, 1920x1080 @
           48 spp, depth 32) through ``cli.main``; the wavefront image
           against the tiled engine at 4 spp;
  fit      train steps at flagship scale through ``cli.main(["fit", ...])``
           (interior AD, then the full surrogates), and the regenerative
           AD engine's gradients against the planar engine's;
  serve    the render server in a thread of this process, driven through
           ``serve.request``: ping, a render, and the same render again,
           which must not compile.

``--four`` runs only what exists across cards: the flagship frame through
``render_wavefront_sharded`` on a 4-GPU mesh against the one-card image,
and one sharded train step (interior, then full surrogates) against the
same step on one card.

The script exits non-zero, without a result line, when JAX finds no GPU
(or too few for --four) or when any phase fails. On success its last
line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

T_MIN = 0.008
# Images of two engines agree per pixel to float reassociation, except
# where a knife-edge ray takes another path in one of them (its whole
# path differs); such pixels may make up at most this share of a frame.
IMAGE_RTOL, IMAGE_ATOL = 2e-4, 2e-5
IMAGE_OUTLIER_SHARE = 0.01
# Gradients of two engines (or one engine sharded and not) sum the same
# per-ray terms in another order. Both sides must trace with the same
# closest hit (it is chosen by call size,
# pallas_segment.KERNEL_MIN_RAYS): a knife-edge ray that grazes a sphere
# in one implementation and misses it in the other carries an unbounded
# implicit-function gradient into one side only.
GRAD_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


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


def require_gpus(devices, n: int) -> None:
    """Exit with a message unless ``devices`` holds at least n GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found platform "
                 f"{platform!r}")
    if len(devices) < n:
        sys.exit(f"chip_smoke.py --four needs 4 GPUs; JAX found "
                 f"{len(devices)}")


class CompileCounter:
    """Counts XLA backend compilations while active."""

    def __init__(self):
        self.count = 0

    def _listener(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.count += 1

    def __enter__(self):
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(self._listener)
        return self

    def __exit__(self, *exc):
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self._listener)


def timed(fn):
    """(seconds, result) of one call, waited for on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def image_agreement(a, b, name: str) -> None:
    """Check two images agree per IMAGE_* and print the numbers."""
    import numpy as np

    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all() and np.isfinite(b).all(), name
    bad = (np.abs(a - b) > IMAGE_ATOL + IMAGE_RTOL * np.abs(b)).any(axis=1)
    share = float(bad.mean())
    log(f"[{name}] pixels outside rtol {IMAGE_RTOL} atol {IMAGE_ATOL}: "
        f"{int(bad.sum())} of {len(bad)} ({share:.6f}); max |diff| "
        f"{np.abs(a - b).max():.3e}; mean image {a.mean():.6f} vs "
        f"{b.mean():.6f}")
    assert share <= IMAGE_OUTLIER_SHARE, (name, share)


def grad_agreement(ga: dict, gb: dict, name: str) -> None:
    """Per leaf: max |ga - gb| <= GRAD_REL_TOL * max |gb|."""
    import numpy as np

    for leaf in sorted(gb):
        a = np.asarray(ga[leaf], np.float64)
        b = np.asarray(gb[leaf], np.float64)
        assert np.isfinite(a).all() and np.isfinite(b).all(), (name, leaf)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        log(f"[{name}] {leaf}: max |diff| {err:.3e}, max |grad| "
            f"{scale:.3e}, ratio {err / max(scale, 1e-30):.2e}")
        assert err <= GRAD_REL_TOL * scale, (name, leaf, err, scale)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def probe_rays(n_rays: int = 1 << 17, width: int = 1200, height: int = 800):
    """Flagship camera rays on the huge scene plus one bounce of them.

    Returns (rays, sphere_params): rays are 6 (2*n_rays/128, 128) planes,
    the first half camera rays spread over the frame, the second half
    their first bounce (traced and shaded by the XLA path).
    """
    import jax
    import jax.numpy as jnp

    from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
    from raytracinginoneweekend_tpu.models.scene import huge_scene
    from raytracinginoneweekend_tpu.ops import pallas_segment as ps
    from raytracinginoneweekend_tpu.ops import planar

    cam = reference_cpu_camera(width, height)
    sp = ps.sphere_params_from_scene(huge_scene(0))
    cx, cy, cz, r = sp[:4]
    rows = n_rays // 128

    @jax.jit
    def make_rays(key):
        i = jnp.arange(n_rays, dtype=jnp.int32)
        pid = ((i * 7919) % (width * height)).reshape(rows, 128)
        sid = (i % 100).reshape(rows, 128)
        ox, oy, oz, dx, dy, dz, k0, k1 = planar.camera_rays(
            cam, pid, sid, key, width, height, "thinlens", spp=100)
        cam_rays = (ox, oy, oz, dx, dy, dz)
        hit_i, t, sb = ps.closest_hit_xla(cam_rays, cx, cy, cz, r, T_MIN)
        seg = ps.resolve_segment(cam_rays, sp, hit_i, t, sb)
        ndx, ndy, ndz, *_ = planar.bounce_planar(
            seg, (dx, dy, dz), k0, k1, jnp.zeros_like(pid),
            unit_sample=True, phys_refract=True, sky_bias=0.5)
        hit = hit_i > 0
        bounce = (jnp.where(hit, seg["px"], ox),
                  jnp.where(hit, seg["py"], oy),
                  jnp.where(hit, seg["pz"], oz), jnp.where(hit, ndx, dx),
                  jnp.where(hit, ndy, dy), jnp.where(hit, ndz, dz))
        return tuple(jnp.concatenate([a, b]) for a, b in
                     zip(cam_rays, bounce))

    return make_rays(jax.random.key(0)), sp


def kernel_phase(n_rays: int = 1 << 17, width: int = 1200,
                 height: int = 800):
    """The Triton closest hit against ops/intersect.closest_hit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracinginoneweekend_tpu.ops import pallas_segment as ps
    from raytracinginoneweekend_tpu.utils.timing import time_fn

    rays, sp = probe_rays(n_rays, width, height)
    cx, cy, cz, r = sp[:4]
    n = rays[0].size
    kern = jax.jit(lambda rs: ps.closest_hit_triton(rs, cx, cy, cz, r,
                                                     T_MIN))
    ref = jax.jit(lambda rs: ps.closest_hit_xla(rs, cx, cy, cz, r, T_MIN))
    t_k, (h1, t1, s1) = time_fn(kern, rays, warmup=1, iters=3)
    t_r, (h2, t2, s2) = time_fn(ref, rays, warmup=1, iters=3)

    @jax.jit
    def knife_edge(rs):
        # Two best windowed roots within 1e-4 relative, or a sphere
        # ahead whose discriminant b^2 - ac is within 1e-6 b^2 of zero
        # (a few f32 ulps of the cancelling terms): the rays on which
        # rounding may pick another winner, or hit against miss, in
        # another evaluation order.
        ox, oy, oz, dx, dy, dz = (p.reshape(-1, 1) for p in rs)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        ok = disc > 0
        t0 = (-b - sq) / a
        t1_ = (-b + sq) / a
        cand = jnp.concatenate([jnp.where(ok & (t0 > T_MIN), t0, 1e30),
                                jnp.where(ok & (t1_ > T_MIN), t1_, 1e30)],
                               axis=1)
        best2 = -jax.lax.top_k(-cand, 2)[0]
        close = ((best2[:, 0] < 1e29)
                 & (best2[:, 1] - best2[:, 0] <= 1e-4 * best2[:, 0]))
        graze = jnp.any((jnp.abs(disc) <= 1e-6 * b * b)
                        & (-b > T_MIN * a), axis=1)
        return close.reshape(rs[0].shape), graze.reshape(rs[0].shape)

    close, graze = map(np.asarray, knife_edge(rays))
    h1, t1, s1, h2, t2, s2 = map(np.asarray, (h1, t1, s1, h2, t2, s2))
    knife = close | graze
    differ = (h1 != h2) | ((h1 > 0) & (s1 != s2))
    log(f"[kernel] {n} rays ({n // 2} camera + {n // 2} bounce); hit "
        f"share {h2.mean():.4f}; knife-edge rays {int(knife.sum())} "
        f"(close roots {int(close.sum())}, grazing {int(graze.sum())}); "
        f"hit/idx differ on {int(differ.sum())} rays, of them "
        f"{int((differ & ~knife).sum())} not knife-edge")
    assert not (differ & ~knife).any()
    same = (h1 > 0) & (h2 > 0) & (s1 == s2)
    np.testing.assert_allclose(t1[same], t2[same], rtol=2e-4, atol=1e-3)
    log(f"[kernel] t max |diff| {np.abs(t1[same] - t2[same]).max():.3e} "
        f"(rtol 2e-4, atol 1e-3); kernel {t_k * 1e3:.3f} ms, XLA "
        f"{t_r * 1e3:.3f} ms for {n} rays x {cx.shape[0]} spheres")

    # Resolved planes equal table[s_b] bit for bit.
    table = ps.sphere_table(sp)
    got = jax.jit(ps.resolve_params)(jnp.asarray(s1), sp)
    want = np.asarray(jnp.take(table, jnp.asarray(s1), axis=0))
    for i, plane in enumerate(got):
        col = want[..., i]
        if i == 4:
            col = col.astype(np.int32)
        assert np.array_equal(np.asarray(plane), col), f"column {i}"
    log("[kernel] resolved parameter planes equal the table bit for bit "
        "(10 columns)")


def render_phase(tmp: str, flagship=(1200, 800, 100, 50),
                 active=(1920, 1080, 48, 32), compare_spp: int = 4):
    """The shipped render configs through cli.main, then checks."""
    import jax
    import numpy as np

    from raytracinginoneweekend_tpu import cli
    from raytracinginoneweekend_tpu.config import (DEFAULT, POOL_SIZE,
                                                   RenderConfig)
    from raytracinginoneweekend_tpu.ops.pallas_segment import default_impl
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
    from raytracinginoneweekend_tpu.render import render

    for name, scene_name, (w, h, spp, depth) in (
            ("flagship", "huge", flagship),
            ("reference-active", "simple-cuda", active)):
        out = os.path.join(tmp, f"{name}.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--scene", scene_name, "--width", str(w),
                       "--height", str(h), "--spp", str(spp), "--depth",
                       str(depth), "--out", out])
        assert rc == 0 and os.path.getsize(out) > 0, name
        t_cli = time.perf_counter() - t0
        # The same program again, warm: the steady-state frame.
        scene = cli._build_scene(scene_name, 0)
        cam = cli._build_camera("cuda" if scene_name == "simple-cuda"
                                else "cpu", w, h)
        kw = dict(width=w, height=h, spp=spp, max_depth=depth,
                  camera_mode="thinlens", options=DEFAULT,
                  pool_size=POOL_SIZE)
        with CompileCounter() as cc:
            secs, img = timed(lambda: render_wavefront(
                scene, cam, jax.random.key(0), **kw))
        img = np.asarray(img)
        assert img.shape == (w * h, 3) and np.isfinite(img).all(), name
        log(f"[render] {name} {w}x{h} @ {spp} spp depth {depth}: cli "
            f"{t_cli:.2f} s incl. compile; warm frame {secs:.4f} s "
            f"({w * h * spp / secs / 1e6:.2f} Mrays/s, {cc.count} "
            f"compiles, closest hit {default_impl(POOL_SIZE)}); mean "
            f"{img.mean():.5f}")
        assert cc.count == 0, name

    # Wavefront vs the tiled engine on the flagship camera.
    w, h, _, depth = flagship
    scene = cli._build_scene("huge", 0)
    cam = cli._build_camera("cpu", w, h)
    key = jax.random.key(0)
    wf = render_wavefront(scene, cam, key, width=w, height=h,
                          spp=compare_spp, max_depth=depth,
                          camera_mode="thinlens", options=DEFAULT)
    cfg = RenderConfig(width=w, height=h, spp=compare_spp, max_depth=depth,
                       camera_mode="thinlens", options=DEFAULT)
    tiled = render(scene, cam, cfg, key)
    image_agreement(wf, tiled, f"render wavefront vs tiled {w}x{h} @ "
                               f"{compare_spp} spp depth {depth}")


class _StampedLines(io.TextIOBase):
    """stdout stand-in that timestamps each line as it is written."""

    def __init__(self):
        self.lines = []
        self._buf = ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


def _fit_cli(argv, label: str):
    """cli.main fit run; returns (losses, ms per warm step)."""
    import math

    from raytracinginoneweekend_tpu import cli

    out = _StampedLines()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    for _, line in out.lines:
        log(f"[fit {label}] {line}")
    assert rc == 0, label
    steps = [(t, line) for t, line in out.lines if line.startswith("step ")]
    losses = [float(line.rsplit(" ", 1)[1]) for _, line in steps]
    assert losses and all(math.isfinite(v) for v in losses), losses
    errs = [line for _, line in out.lines if "max abs err" in line]
    assert errs and all(math.isfinite(float(e.rsplit(" ", 1)[1]))
                        for e in errs), errs
    gaps = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    ms = statistics.median(gaps) * 1e3 if gaps else float("nan")
    log(f"[fit {label}] {len(losses)} steps, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; {ms:.2f} ms per warm step (host clock, "
        f"first step excluded)")


def _fit_argv(w, h, depth, batch, spp, steps, extra=()):
    return ["fit", "--scene", "huge", "--width", str(w), "--height",
            str(h), "--spp", "4", "--depth", str(depth), "--batch-pixels",
            str(batch), "--fit-spp", str(spp), "--steps", str(steps),
            "--params", "albedo,centers", "--log-every", "1", *extra]


FULL_SURROGATES = ("--boundary-samples", "16", "--secondary-samples", "2",
                   "--rr-grad")


def fit_phase(w: int = 1200, h: int = 800, depth: int = 50,
              batch: int = 16384, spp: int = 8):
    """Flagship-scale train steps through the CLI, then AD engine parity."""
    import jax
    import jax.numpy as jnp

    from raytracinginoneweekend_tpu import cli
    from raytracinginoneweekend_tpu.config import DEFAULT
    from raytracinginoneweekend_tpu.optim import (params_from_scene,
                                                  render_pixels_vjp)

    _fit_cli(_fit_argv(w, h, depth, batch, spp, 4), "interior")
    _fit_cli(_fit_argv(w, h, depth, batch, spp, 3, FULL_SURROGATES),
             "full surrogates")

    # Regenerative vs planar AD gradients at the same batch, the
    # regenerative pool holding every ray (as the planar scan does), so
    # both engines trace with the same closest hit.
    scene = cli._build_scene("huge", 0)
    cam = cli._build_camera("cpu", w, h)
    params = params_from_scene(scene, ("albedo", "centers"))
    ids = jax.random.choice(jax.random.key(3), w * h, (batch,),
                            replace=False).astype(jnp.int32)
    cot = jax.random.normal(jax.random.key(4), (batch, 3)) / batch
    grads = {}
    for engine, opts in (("wavefront", {"pool_size": batch * spp}),
                         ("planar", None)):
        fn = jax.jit(lambda p, e=engine, o=opts: render_pixels_vjp(
            p, scene, cam, cot, ids, jax.random.key(5), width=w, height=h,
            spp=spp, max_depth=depth, camera_mode="thinlens",
            options=DEFAULT, engine=e, engine_opts=o))
        jax.block_until_ready(fn(params))
        secs, (g, px) = timed(lambda: fn(params))
        grads[engine] = g
        log(f"[fit] {engine} AD engine ({opts or 'defaults'}): pixel-vjp "
            f"{secs * 1e3:.2f} ms ({batch} px x {spp} spp, depth {depth})")
    grad_agreement(grads["wavefront"], grads["planar"],
                   "fit regenerative vs planar AD gradients")


def serve_phase(tmp: str, render_req: dict | None = None):
    """The render server in a thread, driven over its socket."""
    from raytracinginoneweekend_tpu import serve

    sock = os.path.join(tmp, "rtw.sock")
    thread = threading.Thread(target=serve.serve, args=(sock,),
                              daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if os.path.exists(sock):
                break
            time.sleep(0.1)
        ping = serve.request(sock, {"cmd": "ping"})
        log(f"[serve] ping: {ping}")
        assert ping["ok"] and ping["proto"] == serve.PROTO_VERSION, ping
        req = dict(render_req or {
            "scene": "huge", "width": 320, "height": 180, "spp": 16,
            "depth": 16}, cmd="render", proto=serve.PROTO_VERSION)
        times = []
        for i in range(2):
            req["out"] = os.path.join(tmp, f"served_{i}.png")
            with CompileCounter() as cc:
                t0 = time.perf_counter()
                resp = serve.request(sock, req)
                lat = time.perf_counter() - t0
            log(f"[serve] render {i + 1}: {resp}; client latency "
                f"{lat:.3f} s, {cc.count} compiles")
            assert resp["ok"] and os.path.getsize(req["out"]) > 0, resp
            times.append(cc.count)
        assert times[1] == 0, "the repeated render compiled"
    finally:
        if os.path.exists(sock):
            serve.request(sock, {"cmd": "shutdown"})
        thread.join(timeout=60)
    assert not thread.is_alive(), "server thread did not stop"


def four_phase(flagship=(1200, 800, 100, 50), batch: int = 16384,
               spp: int = 8, n_devices: int = 4):
    """Sharded flagship frame and train steps against one card."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracinginoneweekend_tpu import cli
    from raytracinginoneweekend_tpu.config import DEFAULT, POOL_SIZE
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront
    from raytracinginoneweekend_tpu.optim import (make_train_step,
                                                  params_from_scene)
    from raytracinginoneweekend_tpu.parallel import (make_mesh,
                                                     render_wavefront_sharded)

    mesh = make_mesh(jax.devices()[:n_devices])
    w, h, fspp, depth = flagship
    scene = cli._build_scene("huge", 0)
    cam = cli._build_camera("cpu", w, h)
    key = jax.random.key(0)
    kw = dict(width=w, height=h, spp=fspp, max_depth=depth,
              camera_mode="thinlens", options=DEFAULT, pool_size=POOL_SIZE)
    one = render_wavefront(scene, cam, key, **kw)
    jax.block_until_ready(one)
    t1, one = timed(lambda: render_wavefront(scene, cam, key, **kw))
    jax.block_until_ready(render_wavefront_sharded(scene, cam, key,
                                                   mesh=mesh, **kw))
    t4, four = timed(lambda: render_wavefront_sharded(scene, cam, key,
                                                      mesh=mesh, **kw))
    log(f"[four] flagship {w}x{h} @ {fspp} spp depth {depth}: one card "
        f"{t1:.4f} s, {n_devices} cards {t4:.4f} s per frame "
        f"({w * h * fspp / t4 / 1e6:.2f} Mrays/s)")
    image_agreement(four, one, "four sharded vs one-card flagship")

    params = params_from_scene(scene, ("albedo", "centers"))
    ids = jax.random.choice(jax.random.key(3), w * h, (batch,),
                            replace=False).astype(jnp.int32)
    target = jax.random.uniform(jax.random.key(4), (batch, 3))
    opt = optax.sgd(1.0)  # params - new params = the gradient
    for label, extra in (("interior", {}),
                         ("full surrogates", dict(boundary_samples=16,
                                                  secondary_samples=2,
                                                  rr_grad=True))):
        grads = {}
        for name, m in (("one card", None), ("sharded", mesh)):
            step = make_train_step(opt, width=w, height=h, spp=spp,
                                   max_depth=depth, camera_mode="thinlens",
                                   options=DEFAULT, mesh=m, **extra)
            args = (params, opt.init(params), scene, cam, target, ids,
                    jax.random.key(5))
            jax.block_until_ready(step(*args))
            secs, (new, _, loss) = timed(lambda: step(*args))
            grads[name] = {k: params[k] - new[k] for k in params}
            log(f"[four] {label} train step, {name}: {secs * 1e3:.2f} ms, "
                f"loss {float(loss):.6f}")
        grad_agreement(grads["sharded"], grads["one card"],
                       f"four {label} sharded vs one-card gradients")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU sharded checks")
    args = parser.parse_args(argv)
    try:
        import jax

        from raytracinginoneweekend_tpu.utils.compilecache import (
            enable_persistent_cache)
    except ImportError as e:
        sys.exit(f"chip_smoke.py: cannot import the renderer ({e}); run "
                 f"it from a checkout of the repository")

    devices = jax.devices()
    require_gpus(devices, 4 if args.four else 1)
    enable_persistent_cache()
    dev = devices[0]
    log(f"[device] platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(devices)}")
    log(f"[device] nvidia-smi: {gpu_info()}")

    if args.four:
        phases = [("four", four_phase)]
    else:
        tmp = tempfile.mkdtemp(prefix="rtw_smoke_")
        phases = [("kernel", kernel_phase),
                  ("render", lambda: render_phase(tmp)),
                  ("fit", fit_phase),
                  ("serve", lambda: serve_phase(tmp))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report, run the remaining phases, then fail
            traceback.print_exc()
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        else:
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"failed phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
