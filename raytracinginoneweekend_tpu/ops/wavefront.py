"""Regenerative persistent-wavefront renderer: the speed-of-light forward path.

The fixed-wave integrator (ops/integrate.py) traces a batch of camera rays
for max_depth bounces with a live mask; at depth 50 nearly every lane is
dead for most of the loop (sky/absorb terminate rays after ~2-5 bounces on
the shipped scenes). This engine keeps a persistent pool of P ray lanes at
~100% occupancy: each iteration every dead lane re-seeds itself with its
next unconsumed (pixel, sample) camera ray, all lanes trace one bounce
segment together, and terminating rays deposit into the framebuffer.

Design decisions:
  * PLANAR ray state: every per-ray quantity is its own (R, 128) f32/i32
    plane, so every op is a full-width elementwise op and no (N, 3)
    component extraction is ever needed.
  * Closest hit + winner resolve is one trace segment
    (ops/pallas_segment.trace_segment: the Triton kernel on the GPU, the
    XLA version elsewhere); shading, state update and regeneration are
    plain XLA fusions around it.
  * Lane regeneration is strided, not compacted: lane l owns global ray
    ids l, l+P, l+2P, ... and advances independently -- no cumsum/prefix
    ranks and no inter-lane communication at all. (options.ownership=
    "tile" swaps in block-contiguous tile-swizzled ownership; images are
    bit-identical, see TraceOptions.)
  * Framebuffer deposit: a TASK-INDEXED LEDGER, not pixel scatter-adds.
    Because task ownership is strided, every task has a statically-known
    unique slot ledger[k, lane] (task id = k*stride + lane0), so the
    epoch flush is a one-hot ELEMENTWISE update of the (K, R, 128)
    ledger -- no scatter -- and the frame-end fold to pixels is a static
    reshape+sum (task id // tpp is a contiguous-run map). Extra pending
    slots are then nearly free, which removes the engine's pending-stall
    idle.

RNG discipline is EXACTLY ops/rng.py's (pixel, sample, tag, word)
contract -- raw threefry blocks on (R, 128) key-word planes
(ops/threefry.py) -- so this engine produces the same per-ray radiance
as render_pixels and the scalar oracle; only the
framebuffer accumulation order differs (float reassociation), so images
match to ~1e-5 rather than bitwise.

Forward-only (lax.while_loop): use ops/integrate.trace for AD.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import POOL_SIZE, TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from .pallas_segment import sphere_params_from_scene, trace_segment

LANES = 128


# Planar RNG/vector helpers, camera-ray generation and the per-bounce
# material/sky shading live in ops/planar.py (shared with the planar-AD
# engine).
from .planar import (bounce_planar as _bounce,  # noqa: E402
                     camera_rays as _planar_camera_rays,
                     strat0_scatter_planes)

# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

TASK_SAMPLES = 16  # samples of one pixel accumulated per task (in-register)
FLUSH_EVERY = 32   # inner iterations per epoch (pending->ledger cadence)
N_SLOTS = 2        # pending slots per lane (task-done buffering)

# Ledger auto-deposit cap: a frame's task count must fit 3 f32 ledger
# channels under this budget, else the engine falls back to pixel
# scatter-adds (deposit="scatter").
LEDGER_CAP_BYTES = 512 << 20


ROWS_DEFAULT = 64  # rows of 128 lanes: pools are multiples of 8192 lanes

# Lane-state layout: 19 base planes, then 4 planes per pending slot.
#   0 nxt   1 task   2 sid   3 active
#   4..9  ox oy oz dx dy dz
#   10..12 ax ay az    13 depth
#   14..16 accr accg accb
#   17 k0  18 k1  (per-ray threefry key words)
#   19+4j .. 22+4j: slot j = (pt, pr, pg, pb); pt = finished TASK id,
#                   -1 = free.
N_BASE = 19


def pool_lanes(pool_size: int, width: int, height: int, spp: int,
               rows: int = ROWS_DEFAULT,
               task_samples: int | None = None) -> int:
    """The actual (layout-rounded) lane count a pool_size request yields."""
    task_samples = min(task_samples or TASK_SAMPLES, spp)
    tpp = -(-spp // task_samples)
    n_tasks = width * height * tpp
    p = min(pool_size, n_tasks * task_samples)
    p = max(p, rows * LANES)
    return -(-p // (rows * LANES)) * (rows * LANES)


def wavefront_fb(scene: Scene, cam: Camera, base_key, *, width: int,
                 height: int, spp: int, max_depth: int, camera_mode: str,
                 options: TraceOptions, pool_size: int = POOL_SIZE,
                 worker_index=0, n_workers: int = 1,
                 task_samples: int | None = None,
                 flush_every: int | None = None,
                 pending_slots: int | None = None,
                 deposit: str | None = None,
                 reserve_frac: float | None = None,
                 return_stats: bool = False):
    """Trace this worker's task chunks -> UNNORMALIZED (H*W, 3) fb sums.

    Task ownership is strided across the global lane space: worker w's
    local lane l owns tasks w*P + l, + n_workers*P, ... Striding both
    balances load (each lane's tasks sample the whole image) and keeps a
    kernel block's in-flight tasks CONTIGUOUS at any instant (block b
    holds tasks [w*P + b*BL + k*stride, ...+BL) while its lanes stay near
    the same round k). worker_index may be a traced scalar
    (jax.lax.axis_index); n_workers must be static.

    Work decomposition:
      * a TASK = up to TASK_SAMPLES consecutive samples of ONE pixel;
        tasks are strided across lanes (lane l owns tasks l, l+P, ...), so
        load stays balanced and lanes never communicate;
      * a lane traces its task's samples back-to-back, accumulating their
        radiance into per-lane register planes (plain adds, no scatter);
      * a finished task's (task id, rgb) moves to the lane's first FREE
        pending slot (N_SLOTS of them; a lane with every slot occupied
        idles until the epoch flush);
      * once per EPOCH (an inner fori_loop of flush_every iterations
        whose carry never touches the deposit arrays -- see the epoch()
        note) pendings are flushed. deposit="ledger" writes each pending
        into its unique ledger[k, lane] cell by a one-hot elementwise
        pass (k = (task - lane0) // stride, exact by ownership); the
        frame-end fold to pixels is a static reshape (1 worker) or one
        per-frame scatter-add (sharded). deposit="scatter" is the
        legacy per-epoch pixel scatter-add (used automatically when the
        ledger would exceed LEDGER_CAP_BYTES).

    pool_size: number of persistent ray lanes (rounded to layout multiple).
    return_stats: also return {"iters", "segments", "lanes"} occupancy
      counters (a separate jit config; the default path carries none).
    """
    n_pixels = width * height
    task_samples = min(task_samples or TASK_SAMPLES, spp)
    flush_every = flush_every or FLUSH_EVERY
    n_slots = pending_slots or N_SLOTS
    tpp = -(-spp // task_samples)  # tasks per pixel
    n_tasks = n_pixels * tpp
    if n_pixels * spp >= 2 ** 31:
        raise ValueError(
            f"{width}x{height} @ {spp}spp = {n_pixels * spp} rays overflows "
            "the int32 ray-id space; render in passes (e.g. split spp and "
            "average)")
    rows = ROWS_DEFAULT
    p = pool_lanes(pool_size, width, height, spp, rows,
                   task_samples)
    r_rows = p // LANES
    tiled_own = options.ownership == "tile"
    if tiled_own:
        # Tile ownership (see TraceOptions.ownership): tasks run over the
        # 32x32-tile virtual pixel grid (ops/tiles.py closed forms); each
        # closest-hit kernel block owns a CONTIGUOUS tile-order range of
        # T_b tasks, strided by the block's lane count within it. T_b is
        # a multiple of lcm(OWN_BL, tpp) so (a) every ledger cell is
        # exact by ownership and (b) each block's (and worker's) range
        # aligns to whole virtual pixels -- the frame-end fold is pure
        # reshape/transpose, no scatter. Virtual pixels outside the true
        # image trace normally (<2% waste) and drop at the fold.
        import math as _math

        from .tiles import TILE, tile_pixel, virtual_grid
        tiles_x, tiles_y, n_vp = virtual_grid(width, height)
        own_bl = min(rows * LANES, p)
        assert p % own_bl == 0, (p, own_bl)
        nb_local = p // own_bl
        nb_global = n_workers * nb_local
        n_tasks_t = n_vp * tpp
        align = own_bl * tpp // _math.gcd(own_bl, tpp)
        own_tb = -(-n_tasks_t // (nb_global * align)) * align
        n_k = own_tb // own_bl         # ledger rounds per lane
        n_tasks = nb_global * own_tb   # padded task-id space
    else:
        stride = n_workers * p      # task-id stride between a lane's tasks

    # RESERVE-TAIL WORK STEALING (round 4, strided ownership only): the
    # ~10% occupancy shortfall is lane-total variance -- lanes finish
    # their strided queues at different iterations and idle through the
    # frame tail. Withholding the LAST reserve_frac of the task space
    # from strided ownership and granting it on demand (once per epoch,
    # after the flush: exhausted-idle lanes take consecutive reserve ids
    # by cumsum rank -- no sort, no per-lane gathers) keeps every lane
    # busy until the reserve drains. Reserve tasks deposit through a
    # per-pixel scatter accumulator (their ledger cell does not exist;
    # the flush routes pendings with pt >= owned_end there), which only
    # costs anything in tail epochs.
    use_reserve = bool(reserve_frac) and not tiled_own
    if use_reserve:
        res_per_worker = int(n_tasks * reserve_frac) // n_workers
        owned_end = n_tasks - n_workers * res_per_worker
        if owned_end <= 0 or res_per_worker == 0:
            use_reserve, owned_end = False, n_tasks
    else:
        owned_end = n_tasks
    if not tiled_own:
        n_k = -(-owned_end // stride)  # ledger rounds (max tasks per lane)

    if deposit in (None, "auto"):
        deposit = ("ledger" if 3 * 4 * n_k * p <= LEDGER_CAP_BYTES
                   else "scatter")
    if deposit not in ("ledger", "scatter"):
        raise ValueError(f"unknown deposit mode: {deposit!r}")

    sphere_params = sphere_params_from_scene(scene)
    lane = (jax.lax.broadcasted_iota(jnp.int32, (r_rows, LANES), 0) * LANES
            + jax.lax.broadcasted_iota(jnp.int32, (r_rows, LANES), 1))
    if tiled_own:
        b_global = worker_index * nb_local + lane // own_bl
        own_base = b_global * own_tb + lane % own_bl  # first task
        block_end = (b_global + 1) * own_tb
        stride = own_bl                            # within-block stride
        lane0 = own_base
    else:
        lane0 = worker_index * p + lane
        block_end = owned_end

    def task_pixel(t):
        """Task id -> (run index base pixel id, validity)."""
        if tiled_own:
            return tile_pixel(t // tpp, width, height, TILE)
        return t // tpp, None

    sky_bias = 0.5 if options.sky == "cuda" else 1.0
    unit_sample = options.scatter_sample == "unit"
    phys_refract = options.refract == "physical"

    use_sfb = use_reserve and deposit == "ledger"

    def flush(slots, dep_r, dep_g, dep_b, sfb=None):
        """Drain every pending slot into the deposit arrays; free slots."""
        new_slots = []
        if deposit == "ledger":
            kk = jnp.arange(n_k, dtype=jnp.int32)[:, None, None]
            for (pt, pr, pg, pb) in slots:
                # Exact by ownership: pt = lane0 + k*stride when pt >= 0;
                # free slots (pt = -1) map to k < 0 and match no row.
                # Reserve-granted tasks (pt >= owned_end) have no ledger
                # cell; they route to the pixel scatter accumulator.
                own = ((pt >= 0) & (pt < owned_end)) if use_reserve \
                    else (pt >= 0)
                k = jnp.where(own, (pt - lane0) // stride, -1)
                m = kk == k[None]
                dep_r = dep_r + jnp.where(m, pr[None], 0.0)
                dep_g = dep_g + jnp.where(m, pg[None], 0.0)
                dep_b = dep_b + jnp.where(m, pb[None], 0.0)
                new_slots.append((jnp.full_like(pt, -1), jnp.zeros_like(pr),
                                  jnp.zeros_like(pg), jnp.zeros_like(pb)))
            if use_sfb:
                foreign = [(pt >= owned_end) for (pt, _, _, _) in slots]

                def scatter_foreign(sfb):
                    sr, sg, sb_ = sfb
                    for fm, (pt, pr, pg, pb) in zip(foreign, slots):
                        pix = jnp.where(fm, pt // tpp, n_pixels
                                        ).reshape(-1)
                        sr = sr.at[pix].add(pr.reshape(-1), mode="drop")
                        sg = sg.at[pix].add(pg.reshape(-1), mode="drop")
                        sb_ = sb_.at[pix].add(pb.reshape(-1), mode="drop")
                    return sr, sg, sb_

                any_foreign = jnp.any(jnp.stack(
                    [jnp.any(f) for f in foreign]))
                # The scatter only runs in reserve-tail epochs.
                sfb = jax.lax.cond(any_foreign, scatter_foreign,
                                   lambda s: s, sfb)
        else:
            for (pt, pr, pg, pb) in slots:
                pid, valid = task_pixel(jnp.maximum(pt, 0))
                ok = pt >= 0 if valid is None else (pt >= 0) & valid
                pix = jnp.where(ok, pid, n_pixels).reshape(-1)
                dep_r = dep_r.at[pix].add(pr.reshape(-1), mode="drop")
                dep_g = dep_g.at[pix].add(pg.reshape(-1), mode="drop")
                dep_b = dep_b.at[pix].add(pb.reshape(-1), mode="drop")
                new_slots.append((jnp.full_like(pt, -1), jnp.zeros_like(pr),
                                  jnp.zeros_like(pg), jnp.zeros_like(pb)))
        return new_slots, dep_r, dep_g, dep_b, sfb

    def fold(dep_r, dep_g, dep_b, sfb=None):
        """Deposit arrays -> (n_pixels,) per-channel sums."""
        if deposit != "ledger":
            return dep_r, dep_g, dep_b
        if tiled_own:
            # Ledger cell (k, lane) holds task own_base + k*own_bl; block
            # ranges are contiguous and vp-aligned, so the whole fold is
            # reshape/transpose (de-swizzle the tile order), no scatter.
            def f(ch):
                x = ch.reshape(n_k, nb_local, own_bl).transpose(1, 0, 2)
                vp_local = x.reshape(nb_local * own_tb // tpp,
                                     tpp).sum(axis=1)
                full = jnp.zeros((n_tasks // tpp,), jnp.float32)
                off = worker_index * (nb_local * (own_tb // tpp))
                full = jax.lax.dynamic_update_slice(full, vp_local, (off,))
                img = full[:n_vp].reshape(tiles_y, tiles_x, TILE, TILE)
                img = img.transpose(0, 2, 1, 3).reshape(
                    tiles_y * TILE, tiles_x * TILE)
                return img[:height, :width].reshape(n_pixels)

            return f(dep_r), f(dep_g), f(dep_b)
        if n_workers == 1:
            # task id = k*p + lane exactly; pixel runs are contiguous.
            def f(ch):
                flat = ch.reshape(n_k * p)[:owned_end]
                if owned_end < n_tasks:  # reserve region: zeros (its
                    flat = jnp.concatenate([  # radiance lives in sfb)
                        flat, jnp.zeros((n_tasks - owned_end,),
                                        jnp.float32)])
                return flat.reshape(n_pixels, tpp).sum(axis=1)
        else:
            # Strided global ownership: one scatter-add per frame.
            t_ids = (lane0.reshape(-1)[None, :]
                     + jnp.arange(n_k, dtype=jnp.int32)[:, None] * stride)
            pix = jnp.where(t_ids < owned_end, t_ids // tpp,
                            n_pixels).reshape(-1)

            def f(ch):
                return jnp.zeros((n_pixels,), jnp.float32).at[pix].add(
                    ch.reshape(-1), mode="drop")
        out = (f(dep_r), f(dep_g), f(dep_b))
        if use_sfb:
            out = tuple(o + s for o, s in zip(out, sfb))
        return out

    def regen(state):
        (nxt, task, sid, active, ox, oy, oz, dx, dy, dz, ax, ay, az,
         depth, accr, accg, accb, _k0, _k1) = state[:N_BASE]
        slots = [tuple(state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)])
                 for j in range(n_slots)]

        idle = ~active
        has_task = task >= 0
        pid_old = task // tpp
        run_end_old = jnp.minimum(
            (task - pid_old * tpp) * task_samples + task_samples, spp)

        # 1. Completed tasks move their accumulator into the first free
        #    pending slot (every slot full -> the lane idles until flush).
        task_done = idle & has_task & (sid + 1 >= run_end_old)
        remaining = task_done
        new_slots = []
        for (pt, pr, pg, pb) in slots:
            mv = remaining & (pt < 0)
            new_slots.append((jnp.where(mv, task, pt),
                              jnp.where(mv, accr, pr),
                              jnp.where(mv, accg, pg),
                              jnp.where(mv, accb, pb)))
            remaining = remaining & ~mv
        moved = task_done & ~remaining
        accr = jnp.where(moved, 0.0, accr)
        accg = jnp.where(moved, 0.0, accg)
        accb = jnp.where(moved, 0.0, accb)
        task = jnp.where(moved, -1, task)

        # 2. Taskless lanes acquire their next strided task.
        acquire = idle & (task < 0) & (nxt < block_end)
        task = jnp.where(acquire, nxt, task)
        nxt = jnp.where(acquire, nxt + stride, nxt)

        # 3. Recompute pixel/run for the (possibly new) task; advance sid.
        vp = task // tpp
        pid, _valid = task_pixel(jnp.maximum(task, 0))
        run_start = (task - vp * tpp) * task_samples
        next_sample = idle & has_task & (sid + 1 < run_end_old) & ~task_done
        sid = jnp.where(acquire, run_start,
                        jnp.where(next_sample, sid + 1, sid))
        issue = acquire | next_sample

        # 4. Camera ray for issued (pixel, sample) pairs -- RNG contract
        #    identical to ops/rng.py / the tiled renderer (ops/planar.py).
        #    The key-word planes are recomputed from (pid, sid) rather
        #    than carried: unissued lanes keep their pid/sid, so their
        #    key is bit-identical either way.
        nox, noy, noz, ndx, ndy, ndz, rk0, rk1 = _planar_camera_rays(
            cam, pid, sid, base_key, width, height, camera_mode,
            sampling=options.sampling, spp=spp)

        one = jnp.float32(1.0)
        ox = jnp.where(issue, nox, ox)
        oy = jnp.where(issue, noy, oy)
        oz = jnp.where(issue, noz, oz)
        dx = jnp.where(issue, ndx, dx)
        dy = jnp.where(issue, ndy, dy)
        dz = jnp.where(issue, ndz, dz)
        ax = jnp.where(issue, one, ax)
        ay = jnp.where(issue, one, ay)
        az = jnp.where(issue, one, az)
        depth = jnp.where(issue, 0, depth)
        active = active | issue
        return (nxt, task, sid, active, ox, oy, oz, dx, dy, dz,
                ax, ay, az, depth, accr, accg, accb, rk0, rk1,
                *(pl_ for s in new_slots for pl_ in s))

    def segment(state):
        (nxt, task, sid, active, ox, oy, oz, dx, dy, dz, ax, ay, az,
         depth, accr, accg, accb, rk0, rk1) = state[:N_BASE]
        slot_planes = state[N_BASE:]

        seg = trace_segment((ox, oy, oz, dx, dy, dz), sphere_params,
                            options.t_min, active=active)
        hit = seg["hit"] > 0
        alr, alg, alb_ = seg["ar"], seg["ag"], seg["ab"]

        strat0 = None
        if options.sampling == "stratified":
            # First-bounce stratified scatter (planar.
            # strat0_scatter_planes): pid recomputed from the task plane
            # (same arithmetic as regen); inactive/garbage lanes are
            # masked by depth==0 & the active gates downstream.
            from . import threefry as _tf
            sb0, sb1 = _tf.key_words(base_key)
            pid_cur, _pv = task_pixel(jnp.maximum(task, 0))
            strat0 = strat0_scatter_planes(rk0, rk1, pid_cur, sid,
                                           sb0, sb1, spp, unit_sample)

        ndx, ndy, ndz, valid, sky_r, sky_g, sky_b = _bounce(
            seg, (dx, dy, dz), rk0, rk1, depth, unit_sample=unit_sample,
            phys_refract=phys_refract, sky_bias=sky_bias, strat0=strat0)

        miss_now = active & ~hit
        scatter_now = active & hit & valid
        depth_out = scatter_now & (depth + 1 >= max_depth)
        keep = scatter_now & ~depth_out

        # Sky accumulates into the lane's task registers -- NO scatter.
        accr = jnp.where(miss_now, accr + ax * sky_r, accr)
        accg = jnp.where(miss_now, accg + ay * sky_g, accg)
        accb = jnp.where(miss_now, accb + az * sky_b, accb)

        ox = jnp.where(keep, seg["px"], ox)
        oy = jnp.where(keep, seg["py"], oy)
        oz = jnp.where(keep, seg["pz"], oz)
        dx = jnp.where(keep, ndx, dx)
        dy = jnp.where(keep, ndy, dy)
        dz = jnp.where(keep, ndz, dz)
        ax = jnp.where(keep, ax * alr, ax)
        ay = jnp.where(keep, ay * alg, ay)
        az = jnp.where(keep, az * alb_, az)
        if options.rr_terminate:
            # Russian-roulette termination: the shared contract
            # (rng.rr_terminate_update); terminated lanes die like
            # absorb (task registers keep the radiance gathered so far).
            from . import rng as _rng
            ax, ay, az, keep = _rng.rr_terminate_update(
                rk0, rk1, depth, ax, ay, az, keep,
                rr_start=options.rr_start, rr_qmin=options.rr_qmin,
                rr_scale=options.rr_scale)
        depth = jnp.where(keep, depth + 1, depth)
        return (nxt, task, sid, keep, ox, oy, oz, dx, dy, dz,
                ax, ay, az, depth, accr, accg, accb, rk0, rk1,
                *slot_planes)

    if use_reserve:
        res_start = owned_end + worker_index * res_per_worker
        res_end_w = res_start + res_per_worker

        def grant(lane_state, res_next):
            """Exhausted-idle lanes take consecutive reserve tasks (by
            cumsum rank) and are issued their first camera ray -- the
            XLA analogue of regen() for reserve ids. Runs once per
            epoch, only while reserve work remains (cond-gated)."""
            planes = lane_state[:N_BASE]
            rest = lane_state[N_BASE:]
            (nxt, task, sid, active) = planes[:4]
            idle_ex = (~active) & (task < 0) & (nxt >= block_end)

            def do(args):
                (nxt, task, sid, active, ox, oy, oz, dx, dy, dz,
                 ax, ay, az, depth, accr, accg, accb, k0v, k1v,
                 res_next) = args
                flat = idle_ex.reshape(-1).astype(jnp.int32)
                rank = (jnp.cumsum(flat) - flat).reshape(idle_ex.shape)
                gid = res_next + rank
                take = idle_ex & (gid < res_end_w)
                t_new = jnp.where(take, gid, task)
                t_safe = jnp.maximum(t_new, 0)
                vp = t_safe // tpp
                run_start = (t_safe - vp * tpp) * task_samples
                nsid = jnp.where(take, run_start, sid)
                nox, noy, noz, ndx, ndy, ndz, rk0, rk1 = \
                    _planar_camera_rays(
                        cam, vp, nsid, base_key, width, height,
                        camera_mode, sampling=options.sampling, spp=spp)
                one = jnp.float32(1.0)
                ox = jnp.where(take, nox, ox)
                oy = jnp.where(take, noy, oy)
                oz = jnp.where(take, noz, oz)
                dx = jnp.where(take, ndx, dx)
                dy = jnp.where(take, ndy, dy)
                dz = jnp.where(take, ndz, dz)
                ax = jnp.where(take, one, ax)
                ay = jnp.where(take, one, ay)
                az = jnp.where(take, one, az)
                depth = jnp.where(take, 0, depth)
                k0v = jnp.where(take, rk0, k0v)
                k1v = jnp.where(take, rk1, k1v)
                res_next = res_next + jnp.sum(take.astype(jnp.int32))
                return (nxt, t_new, nsid, active | take, ox, oy, oz,
                        dx, dy, dz, ax, ay, az, depth, accr, accg, accb,
                        k0v, k1v, res_next)

            pred = jnp.any(idle_ex) & (res_next < res_end_w)
            out = jax.lax.cond(pred, do, lambda a: a,
                               planes + (res_next,))
            return out[:N_BASE] + rest, out[N_BASE]

    def cond(state):
        lane_state = state[0]
        nxt, task, sid, active = lane_state[:4]
        more = (jnp.any(active) | jnp.any(task >= 0)
                | jnp.any(nxt < block_end))
        if use_reserve:
            more = more | (state[-1][0] < res_end_w)
        return more

    def body(s):
        return segment(regen(s))

    def body_c(s, n):
        # Count the lanes that TRACE each iteration (uint32: fine to
        # ~4.2G segments).
        s2 = regen(s)
        return segment(s2), n + jnp.sum(s2[3].astype(jnp.uint32))

    def epoch(state):
        # EPOCH structure: the deposit arrays live ONLY in this outer
        # body, so the inner fori_loop carries lane state only (a
        # per-iteration flush would copy the deposit arrays through
        # every iteration); the flush runs once per epoch.
        lane_state, dep_r, dep_g, dep_b = state[:4]
        if return_stats:
            iters, segs = state[4:6]
            lane_state, segs = jax.lax.fori_loop(
                0, flush_every, lambda i, c: body_c(*c),
                (lane_state, segs))
            iters = iters + jnp.uint32(flush_every)
        else:
            lane_state = jax.lax.fori_loop(
                0, flush_every, lambda i, s: body(s), lane_state)
        slots = [tuple(lane_state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)])
                 for j in range(n_slots)]
        sfb = state[-1][1:] if use_sfb else None
        slots, dep_r, dep_g, dep_b, sfb = flush(slots, dep_r, dep_g,
                                                dep_b, sfb)
        lane_state = lane_state[:N_BASE] + tuple(
            pl_ for s in slots for pl_ in s)
        if use_reserve:
            res_next = state[-1][0]
            lane_state, res_next = grant(lane_state, res_next)
            res = (res_next,) + (tuple(sfb) if use_sfb else ())
        out = (lane_state, dep_r, dep_g, dep_b)
        if return_stats:
            out = out + (iters, segs)
        if use_reserve:
            out = out + (res,)
        return out

    zero = jnp.zeros((r_rows, LANES), jnp.float32)
    izero = jnp.zeros((r_rows, LANES), jnp.int32)
    uzero = jnp.zeros((r_rows, LANES), jnp.uint32)
    if deposit == "ledger":
        dep0 = jnp.zeros((n_k, r_rows, LANES), jnp.float32)
    else:
        dep0 = jnp.zeros((n_pixels,), jnp.float32)
    slot0 = (izero - 1, zero, zero, zero)  # pt = -1 sentinel: free
    lane_state0 = (
        lane0,                # per-lane next task id (strided ownership)
        izero - 1,            # task (-1 = none)
        izero,                # sid
        jnp.zeros((r_rows, LANES), bool),  # active
        zero, zero, zero,     # origin
        zero + 1.0, zero, zero,  # direction (non-degenerate dummy)
        zero, zero, zero,     # attenuation
        izero,                # depth
        zero, zero, zero,     # task accumulator
        uzero, uzero,         # per-ray key words
    ) + slot0 * n_slots
    init = (lane_state0, dep0, dep0, dep0)
    if return_stats:
        init = init + (jnp.uint32(0), jnp.uint32(0))
    if use_reserve:
        sfb0 = ((jnp.zeros((n_pixels,), jnp.float32),) * 3
                if use_sfb else ())
        init = init + ((jnp.asarray(res_start, jnp.int32),) + sfb0,)
    final = jax.lax.while_loop(cond, epoch, init)
    lane_state, dep_r, dep_g, dep_b = final[:4]
    slots = [tuple(lane_state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)])
             for j in range(n_slots)]
    sfb = final[-1][1:] if use_sfb else None
    _, dep_r, dep_g, dep_b, sfb = flush(slots, dep_r, dep_g, dep_b, sfb)
    fbr, fbg, fbb = fold(dep_r, dep_g, dep_b, sfb)
    fb = jnp.stack([fbr, fbg, fbb], axis=-1)
    if return_stats:
        stats = {"iters": final[4], "segments": final[5],
                 "lanes": jnp.uint32(p)}
        return fb, stats
    return fb


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "camera_mode",
                     "options", "pool_size", "task_samples", "flush_every",
                     "pending_slots", "deposit", "reserve_frac",
                     "return_stats"))
def render_wavefront(scene: Scene, cam: Camera, base_key, *, width: int,
                     height: int, spp: int, max_depth: int,
                     camera_mode: str, options: TraceOptions,
                     pool_size: int = POOL_SIZE,
                     task_samples: int | None = None,
                     flush_every: int | None = None,
                     pending_slots: int | None = None,
                     deposit: str | None = None,
                     reserve_frac: float | None = None,
                     return_stats: bool = False):
    """Render the full image -> (H*W, 3) linear radiance means (1 device).

    return_stats=True also returns the engine's occupancy counters
    ({"iters", "segments", "lanes"}; occupancy = segments/(iters*lanes)).
    """
    out = wavefront_fb(scene, cam, base_key, width=width, height=height,
                       spp=spp, max_depth=max_depth, camera_mode=camera_mode,
                       options=options, pool_size=pool_size,
                       task_samples=task_samples, flush_every=flush_every,
                       pending_slots=pending_slots, deposit=deposit,
                       reserve_frac=reserve_frac,
                       return_stats=return_stats)
    if return_stats:
        fb, stats = out
        return fb / spp, stats
    return out / spp
