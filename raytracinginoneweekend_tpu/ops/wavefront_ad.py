"""Regenerative differentiable wavefront: the reverse-mode occupancy fix.

Both prior AD engines (ops/integrate.trace and ops/integrate_planar.
trace_planar) scan a FIXED max_depth bounce loop: at the flagship
depth-50 configs (~3.4 measured segments per camera ray) ~93% of every
bounce's lanes are dead weight, forward AND backward. The forward
wavefront engine (ops/wavefront.py) solved exactly this with a
persistent regenerating lane pool at ~90% occupancy -- but it is a
lax.while_loop and forward-only.

This module is that regeneration made reverse-mode differentiable. The
reference semantics being re-expressed are still the per-thread early
termination of the bounce loop (main.cxx:60-74, cuda_impl.cu:275-296):
a terminated thread costs nothing there; a terminated lane here hands
its slot to the next (pixel, sample) task.

Design:

  * Lane pool of L = R*128 planar lanes; lane l owns rays
    l, l+L, 2L, ... (the forward engine's strided ownership -- balanced,
    zero cross-lane communication). The (pixel, sample) ids of all N
    rays are precomputed into (W, R, 128) wave planes (W = ceil(N/L));
    regeneration reads them with a W-way one-hot select -- no gathers.
  * Radiance deposit: a WAVE-INDEXED LEDGER (W, R, 128) per channel.
    Ray (w, lane) has the statically-unique slot ledger[w, lane], so a
    deposit is a one-hot ELEMENTWISE masked add over the wave axis --
    no scatter in the forward pass, and its transpose is the same
    masked READ (no gather). Each ray deposits at most once (only a
    miss carries radiance; absorb/depth-out are black), at the
    iteration it dies.
  * Bounce iterations run as an outer lax.scan over EPOCHS of
    ``epoch_len`` inner bounces, the epoch body rematerialized with
    jax.checkpoint: backward memory is O(state * n_epochs), not
    O(state * iters). Each epoch is wrapped in lax.cond(any work left),
    so the guaranteed-termination iteration budget
    ceil(N/L) * max_depth costs ~nothing once the pool drains -- the
    differentiable analogue of the forward engine's while_loop exit.
    (A fixed-trip scan without the cond would pay FULL price for every
    budgeted iteration and lose to the fixed-depth engine.)
  * The closest hit is ops/pallas_segment.closest_hit under the
    analytic implicit-function custom VJP
    (integrate_planar.closest_hit_planar); the per-lane material fetch
    is the exact one-hot matmul (integrate_planar._onehot_gather).
    The scatter/sky math is the SHARED
    scatter_planar_ad/shade_geometry_planar code and the
    per-pixel mean reduces in the same sample order, so rendered
    pixels are BIT-invariant to pool_size (with one closest-hit
    implementation) and match
    render_pixels_planar to ~1e-6 -- the residue is instruction-level
    (XLA contracts mul+add chains into FMAs differently in the two
    program contexts), the same class of difference as the forward
    engines' documented ~1e-5 agreement.

Gradient notes: parameter gradients equal the fixed-depth engine's up
to f32 reassociation (measured ~1e-4 relative) -- the per-bounce
table-gradient matmuls group lanes by pool iteration (mixed depths)
instead of by bounce index. FD-validated in tests/test_wavefront_ad.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from . import planar
from .integrate_planar import (ROW_MULTIPLE, _material_table,
                               _onehot_gather, closest_hit_planar,
                               scatter_planar_ad, shade_geometry_planar)
# The reference sky constants live in ops/planar.py (main.cxx:49,
# cuda_impl.cu:125); imported rather than re-pinned -- the fixed-depth
# scan and this pool are documented bit-comparable.
from .planar import SKY_BLUE, SKY_WHITE

LANES = 128

EPOCH_LEN = 16  # inner bounces per rematerialized epoch
# Default lanes in flight: 2^15 beat 2^17 on the H100's flagship train
# step by 2x (PERF.md); 2^16 is unmeasured.
POOL_SIZE = 1 << 15

# Lane-state tuple layout (all (R, 128) planes):
#   0 nxtw  (i32)  next wave index this lane may acquire
#   1 wcur  (i32)  wave index of the task in flight
#   2 active (bool)
#   3..8  ox oy oz dx dy dz
#   9..11 ax ay az
#   12 depth (i32)
#   13 k0  14 k1  (u32 per-ray threefry key words)


def _regen(state, pid_waves, sid_waves, cam: Camera, base_key, *,
           width: int, height: int, n: int, lanes: int, camera_mode: str,
           options: TraceOptions, spp: int):
    """Dead lanes acquire their next strided ray; issue its camera ray."""
    (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az, depth,
     k0, k1) = state
    w = pid_waves.shape[0]
    lane = (jax.lax.broadcasted_iota(jnp.int32, nxtw.shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.int32, nxtw.shape, 1))

    idle = ~active
    can = nxtw < w
    # Only the LAST wave is padded; a lane whose next ray id falls in the
    # pad is out of work for good (later waves' ids only grow).
    in_range = nxtw * lanes + lane < n
    acquire = idle & can & in_range
    nxtw = jnp.where(idle & can & ~in_range, w, nxtw)

    # W-way one-hot read of the acquired (pixel, sample) ids: W masked
    # selects, each wave plane streamed once -- no gathers.
    pid = jnp.zeros_like(nxtw)
    sid = jnp.zeros_like(nxtw)
    for k in range(w):
        m = acquire & (nxtw == k)
        pid = jnp.where(m, pid_waves[k], pid)
        sid = jnp.where(m, sid_waves[k], sid)

    nox, noy, noz, ndx, ndy, ndz, rk0, rk1 = planar.camera_rays(
        cam, pid, sid, base_key, width, height, camera_mode,
        sampling=options.sampling, spp=spp)

    one = jnp.float32(1.0)
    ox = jnp.where(acquire, nox, ox)
    oy = jnp.where(acquire, noy, oy)
    oz = jnp.where(acquire, noz, oz)
    dx = jnp.where(acquire, ndx, dx)
    dy = jnp.where(acquire, ndy, dy)
    dz = jnp.where(acquire, ndz, dz)
    ax = jnp.where(acquire, one, ax)
    ay = jnp.where(acquire, one, ay)
    az = jnp.where(acquire, one, az)
    depth = jnp.where(acquire, 0, depth)
    k0 = jnp.where(acquire, rk0, k0)
    k1 = jnp.where(acquire, rk1, k1)
    wcur = jnp.where(acquire, nxtw, wcur)
    nxtw = jnp.where(acquire, nxtw + 1, nxtw)
    active = active | acquire
    # (pid, sid) side values: valid exactly on the acquired lanes,
    # which are exactly the lanes that shade at depth == 0 THIS
    # iteration (regen -> hit -> shade run in one body) -- the
    # first-bounce stratification consumes them without any state
    # growth or per-iteration W-way reselect.
    return (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az,
            depth, k0, k1), (pid, sid)


def _shade_deposit(scene: Scene, options: TraceOptions, max_depth: int,
                   state, khit, ledger, strat_psid=None, base_words=None,
                   spp: int = 0):
    """One bounce downstream of the kernel + ledger deposit on miss.

    strat_psid: (pid, sid) planes from this iteration's _regen (valid on
    the depth==0 lanes); with sampling="stratified" they drive the
    first-bounce scatter substitution (planar.strat0_scatter_planes).
    """
    (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az, depth,
     k0, k1) = state
    r_total = ox.shape[0]

    table = _material_table(scene)
    t, sb, hit_i = khit
    params = _onehot_gather(sb.reshape(-1), table)

    def col(i):
        return params[:, i].reshape(r_total, LANES)

    mt = col(4).astype(jnp.int32)
    alr, alg, alb_ = col(5), col(6), col(7)
    fz, io = col(8), col(9)

    hit, px, py, pz, nx, ny, nz = shade_geometry_planar(
        (ox, oy, oz, dx, dy, dz), khit, (col(0), col(1), col(2), col(3)))

    # Per-bounce randomness: per-LANE depth plane (tasks sit at mixed
    # depths), same (pixel, sample, bounce) contract as every engine.
    rvx, rvy, rvz, ru = planar.bounce_draws(
        k0, k1, depth, options.scatter_sample == "unit")
    if options.sampling == "stratified" and strat_psid is not None:
        spid, ssid = strat_psid
        svx, svy, svz = planar.strat0_scatter_planes(
            k0, k1, spid, ssid, base_words[0], base_words[1],
            spp, options.scatter_sample == "unit")
        m0 = depth == 0
        rvx = jnp.where(m0, svx, rvx)
        rvy = jnp.where(m0, svy, rvy)
        rvz = jnp.where(m0, svz, rvz)

    ndx, ndy, ndz, valid, uy = scatter_planar_ad(
        (dx, dy, dz), (nx, ny, nz), (mt, fz, io), (rvx, rvy, rvz, ru),
        options)

    miss_now = active & ~hit
    scatter_now = active & hit & valid
    keep = scatter_now & (depth + 1 < max_depth)

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix
    sky_bias = 0.5 if options.sky == "cuda" else 1.0
    tsky = 0.5 * uy + sky_bias
    miss_f = miss_now.astype(jnp.float32)
    cr = miss_f * ax * (SKY_WHITE[0] * (1.0 - tsky) + SKY_BLUE[0] * tsky)
    cg = miss_f * ay * (SKY_WHITE[1] * (1.0 - tsky) + SKY_BLUE[1] * tsky)
    cb = miss_f * az * (SKY_WHITE[2] * (1.0 - tsky) + SKY_BLUE[2] * tsky)

    # Wave-indexed ledger deposit: ray (w, lane)'s unique slot, one-hot
    # masked add over the wave axis (elementwise; transpose = masked read).
    lr, lg, lb = ledger
    w = lr.shape[0]
    kk = jnp.arange(w, dtype=wcur.dtype)[:, None, None]
    mf = ((kk == wcur[None]) & miss_now[None]).astype(jnp.float32)
    lr = lr + mf * cr[None]
    lg = lg + mf * cg[None]
    lb = lb + mf * cb[None]

    ox = jnp.where(keep, px, ox)
    oy = jnp.where(keep, py, oy)
    oz = jnp.where(keep, pz, oz)
    dx = jnp.where(keep, ndx, dx)
    dy = jnp.where(keep, ndy, dy)
    dz = jnp.where(keep, ndz, dz)
    ax = jnp.where(keep, ax * alr, ax)
    ay = jnp.where(keep, ay * alg, ay)
    az = jnp.where(keep, az * alb_, az)
    if options.rr_terminate:
        # RR path termination: the shared stop-gradiented contract
        # (rng.rr_terminate_update). Unlike the planar scan, a killed
        # lane here actually regenerates next iteration, so the segment
        # saving is real in forward AND backward.
        from . import rng as _rng
        ax, ay, az, keep = _rng.rr_terminate_update(
            k0, k1, depth, ax, ay, az, keep,
            rr_start=options.rr_start, rr_qmin=options.rr_qmin,
            rr_scale=options.rr_scale)
    depth = jnp.where(keep, depth + 1, depth)
    state = (nxtw, wcur, keep, ox, oy, oz, dx, dy, dz, ax, ay, az,
             depth, k0, k1)
    return state, (lr, lg, lb)


# Rough per-(lane, iteration) residual footprint of the un-rematerialized
# body (linearization intermediates: kernel outputs, one-hot params,
# scatter chain) -- sizes the remat="auto" memory heuristic.
_RES_BYTES_PER_LANE_ITER = 260
_NOREMAT_CAP_BYTES = 1536 << 20


def trace_wavefront_ad(scene: Scene, cam: Camera, pid_waves, sid_waves,
                       base_key, *, width: int, height: int, spp: int,
                       max_depth: int, camera_mode: str,
                       options: TraceOptions, n: int,
                       epoch_len: int = EPOCH_LEN,
                       iters: int | None = None, remat: str = "auto",
                       return_done: bool = False):
    """Run the regenerative pool -> ledger planes ((W, R, 128) rgb).

    pid_waves/sid_waves: (W, R, 128) i32 ray-id planes (wave-major flat
    ray order); n: true ray count (the tail of the last wave is pad).

    iters: bounce-iteration budget.
      * None (default) = the guaranteed-complete worst case
        W * max_depth, structured as epochs of ``epoch_len`` inner
        bounces under jax.checkpoint, each epoch wrapped in
        lax.cond(work left) -- budgeted-but-unneeded epochs are skipped.
        Safe for any scene, but the skipped tail is NOT free under AD
        (cond linearization + outer-scan carry churn per epoch).
      * an int = a TUNED budget run as ONE FLAT scan (no cond, no
        per-epoch cost). Rays not finished within the
        budget are dropped from the ledger (they contribute black);
        validate a budget with ``wavefront_ad_done`` or by image parity
        against the fixed-depth engine.

    remat (flat mode only): "step" = jax.checkpoint per bounce (memory
    O(carry * iters)); "none" = no remat -- backward saves every
    linearization residual (~_RES_BYTES_PER_LANE_ITER bytes/lane/iter)
    but skips the whole forward replay; "auto" = "none" when the
    estimated residual footprint fits _NOREMAT_CAP_BYTES, else "step".

    return_done: also return a scalar bool -- True iff every ray
    completed within the budget (drained pool).
    """
    w, r_rows, _ = pid_waves.shape
    lanes = r_rows * LANES

    regen = functools.partial(
        _regen, pid_waves=pid_waves, sid_waves=sid_waves, cam=cam,
        base_key=base_key, width=width, height=height, n=n, lanes=lanes,
        camera_mode=camera_mode, options=options, spp=spp)
    from .threefry import key_words as _kw
    _b0, _b1 = _kw(base_key)
    shade = functools.partial(_shade_deposit, scene, options, max_depth,
                              base_words=(_b0, _b1), spp=spp)

    def inner(carry, _):
        state, ledger = carry
        state, psid = regen(state)
        khit = closest_hit_planar(state[3:9], (scene.centers, scene.radii),
                                  options.t_min)
        state, ledger = shade(state, khit, ledger, strat_psid=psid)
        return (state, ledger), None

    zero = jnp.zeros((r_rows, LANES), jnp.float32)
    izero = jnp.zeros((r_rows, LANES), jnp.int32)
    uzero = jnp.zeros((r_rows, LANES), jnp.uint32)
    state0 = (izero, izero, jnp.zeros((r_rows, LANES), bool),
              zero, zero, zero, zero + 1.0, zero, zero,
              zero, zero, zero, izero, uzero, uzero)
    ledger0 = (jnp.zeros((w, r_rows, LANES), jnp.float32),) * 3

    if iters is None:
        # Guaranteed-complete worst case with the cond-skipped tail.
        n_epochs = -(-(w * max_depth) // epoch_len)

        def epoch(carry, _):
            state, ledger, n_active = carry
            # Work remains if any lane is tracing or any lane still has
            # unacquired rays (pad-exhausted lanes park nxtw at W).
            pred = jnp.any(state[2]) | jnp.any(state[0] < w)

            def work(c):
                return jax.lax.scan(inner, c, None, length=epoch_len)[0]

            out = jax.lax.cond(pred, work, lambda c: c, (state, ledger))
            # Worked epochs are a contiguous prefix (drained stays
            # drained), so this counts the exact flat-scan budget that
            # would complete this batch (wavefront_ad_budget).
            n_active = n_active + jnp.where(pred, epoch_len, 0)
            return (*out, n_active), None

        (state, ledger, n_active), _ = jax.lax.scan(
            jax.checkpoint(epoch), (state0, ledger0, jnp.int32(0)), None,
            length=n_epochs)
    else:
        if remat == "auto":
            remat = ("none" if iters * lanes * _RES_BYTES_PER_LANE_ITER
                     <= _NOREMAT_CAP_BYTES else "step")
        body = inner if remat == "none" else jax.checkpoint(inner)
        (state, ledger), _ = jax.lax.scan(body, (state0, ledger0), None,
                                          length=iters)

    if return_done:
        done = jnp.logical_not(jnp.any(state[2])) & jnp.logical_not(
            jnp.any(state[0] < w))
        if iters is None:
            return ledger, (done, n_active)
        return ledger, (done, jnp.int32(iters))
    return ledger


def _wave_layout(pixel_ids, spp: int, pool_size: int):
    """(pid_waves, sid_waves, n): the engine's wave-major ray
    layout -- the ONE definition of the ray ordering/padding invariant
    (ray-major pixel*spp + sample, pool rounded to the kernel block
    multiple and capped at the ray count, only the LAST wave padded).
    Shared by the renderer and the budget prober so they can never
    validate different layouts."""
    p = pixel_ids.shape[0]
    n = p * spp
    blk = ROW_MULTIPLE * LANES
    lanes = min(pool_size, n)
    lanes = -(-lanes // blk) * blk
    r_rows = lanes // LANES
    w = -(-n // lanes)

    pid_flat = jnp.repeat(pixel_ids.astype(jnp.int32), spp)
    sid_flat = jnp.tile(jnp.arange(spp, dtype=jnp.int32), p)
    pad = w * lanes - n
    if pad:
        pid_flat = jnp.concatenate([pid_flat, jnp.zeros((pad,), jnp.int32)])
        sid_flat = jnp.concatenate([sid_flat, jnp.zeros((pad,), jnp.int32)])
    return (pid_flat.reshape(w, r_rows, LANES),
            sid_flat.reshape(w, r_rows, LANES), n)


def render_pixels_wavefront_ad_impl(scene: Scene, cam: Camera, pixel_ids,
                                    base_key, *, width: int, height: int,
                                    spp: int, max_depth: int,
                                    camera_mode: str, options: TraceOptions,
                                    pool_size: int = POOL_SIZE,
                                    epoch_len: int = EPOCH_LEN,
                                    iters: int | None = None,
                                    remat: str = "auto",
                                    differentiable: bool = True,
                                    debug_check_complete: bool = False):
    """Render a flat pixel chunk -> (P, 3) linear radiance means.

    Drop-in for integrate_planar.render_pixels_planar_impl (same ray
    order, bit-equal pixels) with wavefront-class reverse-mode
    occupancy. pool_size: requested lane count (rounded to the kernel
    block multiple, capped at the ray count); iters/remat: see
    trace_wavefront_ad (None = guaranteed-complete worst case).

    WARNING: with a TUNED integer ``iters`` budget, rays
    not finished within the budget are silently dropped from the ledger
    and render BLACK -- a stale budget (scene/key drift, e.g. params
    moving under training) degrades images and gradients with no error.
    Validate tuned budgets with ``wavefront_ad_done`` /
    ``wavefront_ad_budget`` (pad by whole epochs, and re-validate after
    training moves the parameters), or pass
    ``debug_check_complete=True`` to run the done-flag check in
    the same compiled program and report a drop at runtime
    (forward-only probe; costs one extra budget-length scan, so it is a
    debug tool, not a production default).
    """
    del differentiable
    p = pixel_ids.shape[0]
    pid_waves, sid_waves, n = _wave_layout(pixel_ids, spp,
                                                 pool_size)

    lr, lg, lb = trace_wavefront_ad(
        scene, cam, pid_waves, sid_waves, base_key, width=width,
        height=height, spp=spp, max_depth=max_depth,
        camera_mode=camera_mode, options=options, n=n,
        epoch_len=epoch_len, iters=iters, remat=remat)

    if debug_check_complete and iters is not None:
        _, (done, _need) = trace_wavefront_ad(
            jax.tree.map(jax.lax.stop_gradient, scene), cam, pid_waves,
            sid_waves, base_key, width=width, height=height, spp=spp,
            max_depth=max_depth, camera_mode=camera_mode,
            options=options, n=n, iters=iters, remat="step",
            return_done=True)
        jax.lax.cond(
            done,
            lambda: None,
            lambda: jax.debug.print(
                "wavefront_ad: iteration budget {b} TRUNCATED rays of "
                "this batch -- dropped rays render black; re-probe with "
                "wavefront_ad_budget and pad by whole epochs", b=iters))

    def reduce(ch):
        flat = ch.reshape(-1)[:n]
        return flat.reshape(p, spp).sum(axis=1) / spp

    return jnp.stack([reduce(lr), reduce(lg), reduce(lb)], axis=-1)


render_pixels_wavefront_ad = jax.jit(
    render_pixels_wavefront_ad_impl,
    static_argnames=("width", "height", "spp", "max_depth", "camera_mode",
                     "options", "pool_size", "epoch_len", "iters", "remat",
                     "differentiable", "debug_check_complete"))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "camera_mode",
                     "options", "pool_size", "iters"))
def _probe(scene: Scene, cam: Camera, pixel_ids, base_key, *, width: int,
           height: int, spp: int, max_depth: int, camera_mode: str,
           options: TraceOptions, pool_size: int, iters: int | None):
    pid_waves, sid_waves, n = _wave_layout(pixel_ids, spp,
                                                 pool_size)
    _, aux = trace_wavefront_ad(
        scene, cam, pid_waves, sid_waves, base_key, width=width,
        height=height, spp=spp, max_depth=max_depth,
        camera_mode=camera_mode, options=options, n=n,
        iters=iters, remat="step", return_done=True)
    return aux


def wavefront_ad_done(scene, cam, pixel_ids, base_key, *, iters: int,
                      **kw):
    """Forward-only budget validator: True iff every ray of this batch
    completes within ``iters`` pool iterations (cheap -- no AD; the
    compiled program is reusable across keys/scenes of the same shape)."""
    return _probe(scene, cam, pixel_ids, base_key, iters=iters, **kw)[0]


def wavefront_ad_budget(scene, cam, pixel_ids, base_key, **kw) -> int:
    """Measure the EXACT flat-scan iteration budget for this batch: one
    guaranteed worst-case forward run, counting worked epochs (worked
    epochs are a contiguous prefix, so the count IS the budget, at
    epoch_len granularity). Pad by a couple of epochs before reusing the
    budget across step keys (per-key depths differ slightly)."""
    done, n_active = _probe(scene, cam, pixel_ids, base_key, iters=None,
                            **kw)
    assert bool(done)
    return int(n_active)
