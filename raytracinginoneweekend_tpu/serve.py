"""Persistent render server: amortize compiles across invocations.

The reference is a run-once binary (main.cxx:103-139); this framework is
meant to serve. A fresh process pays a compile per jit configuration
(the on-disk cache, utils/compilecache.py, shortens but does not remove
it); the server keeps ONE long-lived process whose in-memory executable
cache makes every repeat configuration skip compilation.

Protocol: newline-delimited JSON over a Unix domain socket.

  {"cmd": "ping"}
  {"cmd": "render", "scene": "huge", "width": 400, ...,
   "out": "/tmp/x.png"}
  {"cmd": "bench",  "scene": "huge", ..., "iters": 3}
  {"cmd": "fit",    "scene": "simple-cuda", "params": "albedo",
   "steps": 50, ...}   (server-side inverse rendering: the train-step
                        compile amortizes across fit invocations)
  {"cmd": "shutdown"}

Responses: {"ok": true, ...} or {"ok": false, "error": "..."}. The
render/bench config keys mirror the CLI flags (cli.py); unknown scenes/
modes return an error instead of killing the server. One request is
served at a time (the device is serial anyway); requests queue on the
listening socket.

Start:  python -m raytracinginoneweekend_tpu serve --socket /tmp/rtw.sock
Client: python -m raytracinginoneweekend_tpu render --via /tmp/rtw.sock ...
        (or any client speaking the JSON protocol)
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import time

from .config import POOL_SIZE

# Wire-protocol version. Bumped on any incompatible request/response
# change; clients MAY send {"proto": N} with any request -- a mismatch is
# an error instead of a silently misinterpreted render. ping always
# reports it so clients can check before relying on newer fields.
# Version 2 dropped the "fusion" and "hit_kernel" render keys.
PROTO_VERSION = 2

_DEFAULTS = dict(scene="simple-cuda", seed=0, camera=None, mode="thinlens",
                 compat="default", width=400, height=225, spp=8, depth=16,
                 engine="auto", pool_size=POOL_SIZE, clamp=True, iters=2,
                 rr_terminate=False, ownership=None, sampling=None,
                 adaptive=False)

# Fit-request knobs (mirror the CLI fit flags; cli._fit_impl consumes the
# same Namespace either way).
_FIT_DEFAULTS = dict(params="albedo,centers", perturb=0.1, steps=100,
                     lr=1e-2, batch_pixels=4096, fit_spp=4,
                     boundary_samples=0, secondary_samples=0,
                     secondary_spheres=2, secondary_vertex_depths=1,
                     rr_grad=False, rr_grad_arms=2, ad_engine="auto", log_every=10,
                     checkpoint=None, checkpoint_every=25, resume=None)


def _render_once(req):
    """One render through the same dispatch the CLI uses."""
    import argparse

    from . import cli

    cfg = dict(_DEFAULTS)
    cfg.update({k: v for k, v in req.items() if k in _DEFAULTS})
    args = argparse.Namespace(
        scene=cfg["scene"], seed=cfg["seed"], camera=cfg["camera"],
        mode=cfg["mode"], compat=cfg["compat"], width=cfg["width"],
        height=cfg["height"], spp=cfg["spp"], depth=cfg["depth"],
        engine=cfg["engine"], pool_size=cfg["pool_size"], profile=None,
        rr_terminate=cfg["rr_terminate"], ownership=cfg["ownership"],
        sampling=cfg["sampling"], adaptive=cfg["adaptive"])
    img, _ = cli._render_image(args)
    return img, cfg


def handle_request(req):
    """Dispatch one request dict -> response dict (never raises)."""
    import jax

    try:
        proto = req.get("proto", PROTO_VERSION)
        if proto != PROTO_VERSION:
            return {"ok": False, "proto": PROTO_VERSION,
                    "error": f"protocol version mismatch: client {proto}, "
                             f"server {PROTO_VERSION}"}
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "device": str(jax.devices()[0].platform),
                    "pid": os.getpid(), "proto": PROTO_VERSION}
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}
        if cmd == "render":
            t0 = time.perf_counter()
            img, cfg = _render_once(req)
            jax.block_until_ready(img)
            dt = time.perf_counter() - t0
            out = req.get("out")
            if out:
                import numpy as np

                from .io.image import write_png, write_ppm
                from .ops.postprocess import to_u8

                u8 = np.asarray(to_u8(img, clamp=cfg["clamp"]))
                (write_png if out.endswith(".png") else write_ppm)(out, u8)
            rays = cfg["width"] * cfg["height"] * cfg["spp"]
            return {"ok": True, "seconds": dt, "rays_per_s": rays / dt,
                    "out": out}
        if cmd == "bench":
            from .utils.timing import time_fn

            cfg = dict(_DEFAULTS)
            cfg.update({k: v for k, v in req.items() if k in _DEFAULTS})
            secs, _ = time_fn(lambda: _render_once(req)[0], warmup=1,
                              iters=int(cfg["iters"]))
            rays = cfg["width"] * cfg["height"] * cfg["spp"]
            return {"ok": True, "seconds_per_frame": secs,
                    "rays_per_s": rays / secs}
        if cmd == "fit":
            # Server-side inverse rendering: the train step is the most
            # expensive compile; inside this process repeat fits reuse
            # it.
            import argparse
            import time as _time

            from . import cli

            cfg = dict(_DEFAULTS, **_FIT_DEFAULTS)
            cfg.update({k: v for k, v in req.items() if k in cfg})
            cfg["via"] = None
            args = argparse.Namespace(**cfg)
            t0 = _time.perf_counter()
            res = cli._fit_impl(args, log=lambda s: None)
            res.update(ok=True, seconds=_time.perf_counter() - t0)
            return res
        return {"ok": False, "error": f"unknown cmd: {cmd!r}"}
    except Exception as e:  # keep the server alive on bad requests
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def serve(socket_path: str) -> int:
    """Run the blocking server loop until a shutdown request."""
    from .utils.compilecache import enable_persistent_cache

    enable_persistent_cache()
    if os.path.exists(socket_path):
        os.unlink(socket_path)

    stop = {"flag": False}

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    resp = handle_request(req)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    stop["flag"] = True
                    return

    class Server(socketserver.UnixStreamServer):
        def service_actions(self):
            if stop["flag"]:
                raise KeyboardInterrupt

    # Owner-only socket: requests carry filesystem paths
    # (out/checkpoint/resume) the server will read/write with its own
    # uid, so any peer who can connect can drive those. The umask is
    # tightened BEFORE bind (a post-bind chmod would leave a window in
    # which another local user could connect and keep the established
    # connection past the chmod); the belt-and-suspenders chmod then
    # normalizes the mode regardless of inherited umask bits.
    old_umask = os.umask(0o177)
    try:
        srv = Server(socket_path, Handler)
    finally:
        os.umask(old_umask)
    os.chmod(socket_path, 0o600)
    print(f"rtw render server listening on {socket_path}", flush=True)
    try:
        srv.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
    return 0


def request(socket_path: str, req: dict, timeout: float = 3600.0) -> dict:
    """Client: send one request, return the response dict."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
