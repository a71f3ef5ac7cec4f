"""Static render/trace configuration.

The reference has no runtime config at all -- resolution, spp and bounce
budgets are compile-time constants (main.cxx:22-37, cuda_impl.cu:59-60,
raytracer.hxx:20; SURVEY #25). Here the equivalents are explicit, hashable
dataclasses passed as *static* jit arguments, so each configuration traces
to its own specialized XLA program (the analogue of the reference's
template/constexpr specialization).

``TraceOptions`` also carries the quirk-compat switches (SURVEY section 7
"quirk policy"): defaults are the *corrected* physics; the reference's exact
behaviors are reproducible for validation via the presets below.
"""

from __future__ import annotations

import dataclasses

# Default lanes in flight per device for the forward wavefront engine;
# the best of 2^15 .. 2^18 on the H100's flagship frame (PERF.md).
POOL_SIZE = 1 << 17


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Semantics switches for the integrator (all static).

    Which engines read which switches:

      wavefront engine (ops/wavefront.py): every switch except gather and
                   sphere_block; ownership changes the task->lane mapping
                   only (images are bit-identical).
      planar AD engines (integrate_planar.render_pixels_planar and the
                   regenerative ops/wavefront_ad.py): honor rr_terminate
                   with the SAME (TAG_BOUNCE + b, counter 2) draw as the
                   forward engine; survival q and the 1/q boost are
                   stop-gradiented, so gradients are RR applied to the
                   gradient integrand (unbiased; FD-validated in
                   tests/test_wavefront_ad.py). In the regenerative
                   engine the killed lane regenerates, so the segment
                   saving is real forward AND backward; the fixed-depth
                   scan implements it for estimator parity only (fixed
                   trip count -- no time saved).
      tiled AD engine (render.render_pixels / ops/integrate.trace): reads
                   gather and sphere_block; ownership does not apply.
    """

    # Minimum hit distance epsilon (raytracer.hxx:98; cuda_impl.cu:176).
    t_min: float = 0.008
    # Random vector used by lambert/metal scatter: "unit" = normalized
    # (CUDA, cuda_impl.cu:206/220, true Lambertian) or "ball" = unnormalized
    # point in the unit sphere (CPU, raytracer.hxx:134/147; quirk Q3).
    scatter_sample: str = "unit"
    # Sky gradient parameter: "cuda" = .5*y+.5 (cuda_impl.cu:293, correct)
    # or "cpu" = .5*y+1 (main.cxx:71; quirk Q6, can overflow u8).
    sky: str = "cuda"
    # Refraction formula: "physical" (standard Snell) or "reference"
    # (math.hxx:304-308 scalar-broadcast expression; see ops/math3.py).
    refract: str = "physical"
    # Sphere-block size for the streamed closest-hit reduction.
    sphere_block: int = 512
    # Per-ray sphere/material parameter fetch in the tiled integrator:
    # "onehot" = exact one-hot matmul at HIGHEST precision
    # (differentiable; its transpose is another matmul), "take" = plain
    # index gathers.
    gather: str = "onehot"
    # Pixel-jitter sampling: "iid" (reference-faithful, the parity
    # default) or "stratified" (opt-in estimator change: the TAG_JITTER
    # words are remapped so u is exactly stratified over the spp strata
    # and v rides a van-der-Corput sequence under a full-range rotation
    # -- unbiased, lower pixel-antialiasing variance; ops/rng.py
    # stratify_uv). Round 4 extends the same rotated-stratified/vdc
    # scheme to the thin-lens pair (rng.stratify_lens_uv, thinlens
    # mode; rotations at the unconsumed (pid,0) TAG_LENS j=2 counter)
    # and to the FIRST-BOUNCE scatter pair (rng.strat0_scatter /
    # planar.strat0_scatter_planes; rotations at (pid,0) TAG_BOUNCE+0
    # j=3). Measured variance vs iid at 16 spp: 0.39x pinhole, 0.63x
    # cover, 0.44x wide-aperture. Deeper bounces and the "cpu" quirk
    # lens stay iid.
    sampling: str = "iid"
    # Wavefront task OWNERSHIP layout:
    #   "strided" = lane l owns global tasks l, l+P, ... (row-major
    #     pixels): perfect load balance, but a kernel block's in-flight
    #     rays span a full-width image row -- no origin coherence.
    #   "tile" = tasks run over a 32x32-pixel tile swizzle and each
    #     block of 8192 lanes owns a contiguous tile-order range
    #     (strided within the block): a block's rays form a compact
    #     frustum beam all frame, traded against block-level drain
    #     imbalance.
    ownership: str = "strided"
    # Russian-roulette PATH TERMINATION in the wavefront engines and the
    # planar AD engines (opt-in ESTIMATOR change; the reference never
    # terminates early).
    # After a ray has completed >= rr_start bounces it survives each
    # further bounce with q = clamp(max-channel(attenuation), rr_qmin, 1)
    # and survivors are boosted by 1/q -- unbiased in expectation, same
    # image mean at slightly higher variance, fewer traced segments.
    # Draw: one extra threefry block per bounce at (TAG_BOUNCE + b,
    # counter 2) -- existing draws are untouched, so rr_terminate=False
    # is bit-identical to the historical contract.
    rr_terminate: bool = False
    rr_start: int = 3
    rr_qmin: float = 0.05
    # Survival probability q = clip(rr_scale * max-channel(attenuation),
    # rr_qmin, 1): rr_scale > 1 kills less aggressively -- smaller speed
    # gain, much smaller variance inflation. The default (3, 4.0) keeps
    # the variance within ~1% of rr-off; the aggressive (1, scale 1)
    # kills more paths but triples the variance.
    rr_scale: float = 4.0

    def __post_init__(self):
        # Real raises (not asserts): these also validate strings arriving
        # from untrusted sources (the render server forwards request
        # options straight into TraceOptions, serve.py), and asserts
        # vanish under `python -O`.
        def _choice(name, value, allowed):
            if value not in allowed:
                raise ValueError(
                    f"TraceOptions.{name}={value!r}; must be one of "
                    f"{allowed}")

        _choice("scatter_sample", self.scatter_sample, ("unit", "ball"))
        _choice("sky", self.sky, ("cuda", "cpu"))
        _choice("refract", self.refract, ("physical", "reference"))
        _choice("gather", self.gather, ("onehot", "take"))
        _choice("ownership", self.ownership, ("strided", "tile"))
        _choice("sampling", self.sampling, ("iid", "stratified"))
        if not (self.rr_start >= 1 and 0.0 < self.rr_qmin <= 1.0
                and self.rr_scale > 0.0):
            raise ValueError(
                f"bad rr knobs: rr_start={self.rr_start} "
                f"rr_qmin={self.rr_qmin} rr_scale={self.rr_scale}")


# The semantics of the reference's ACTIVE renderer (the CUDA path).
REFERENCE_CUDA = TraceOptions(scatter_sample="unit", sky="cuda",
                              refract="reference")
# The semantics of the reference's dead CPU renderer.
REFERENCE_CPU = TraceOptions(scatter_sample="ball", sky="cpu",
                             refract="reference")
# Corrected physics (framework default).
DEFAULT = TraceOptions()


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """A full render job (the analogue of app::data + cuda::data constants).

    width/height: main.cxx:25-31; spp: main.cxx:23 (16, CPU) and
    cuda_impl.cu:59 (48, CUDA); max_depth: raytracer.hxx:20 (64, CPU) and
    cuda_impl.cu:60 (32, CUDA).
    """

    width: int = 1920
    height: int = 1080
    spp: int = 48
    max_depth: int = 32
    camera_mode: str = "thinlens"  # see models/camera.py
    options: TraceOptions = DEFAULT
    # Upper bound on rays traced per device program invocation; pixels x spp
    # are tiled to stay under this (HBM working-set control).
    rays_per_chunk: int = 1 << 20
