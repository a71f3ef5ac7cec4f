"""raytracinginoneweekend_tpu: a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Alabuta/RaytracingInOneWeekend (C++20 + CUDA/Thrust): the full Ray Tracing
in One Weekend pipeline -- thin-lens camera, brute-force ray/sphere
intersection, lambert/metal/dielectric scatter, iterative bounce integrator,
gamma + PPM/PNG output -- rebuilt as a regenerative wavefront renderer over
planar SoA ray state, differentiable end-to-end, and sharded across device
meshes. See README.md ("Design") for the design and PERF.md for the
measurements.

Public API (the "everything a reference user needs" set):
  Scenes:        Scene, simple_scene_cuda, simple_scene_cpu, huge_scene,
                 validate_scene
  Cameras:       Camera, make_camera, reference_cuda_camera,
                 reference_cpu_camera
  Rendering:     render_wavefront (fast forward), render (tiled, AD-capable),
                 RenderConfig, TraceOptions + presets
  Postprocess:   to_u8, write_ppm, write_png
  Differentiable/optimization (import raytracinginoneweekend_tpu.optim):
                 fit, render_loss, make_train_step, save/load_checkpoint
  Multi-chip     (import raytracinginoneweekend_tpu.parallel):
                 make_mesh, render_wavefront_sharded, render_image_sharded,
                 initialize_distributed
  CLI:           python -m raytracinginoneweekend_tpu {render,bench,fit}
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import DEFAULT, REFERENCE_CPU, REFERENCE_CUDA  # noqa: F401
from .config import RenderConfig, TraceOptions  # noqa: F401
from .io.image import write_png, write_ppm  # noqa: F401
from .models.camera import (Camera, make_camera,  # noqa: F401
                            reference_cpu_camera, reference_cuda_camera)
from .models.scene import (Scene, huge_scene, simple_scene_cpu,  # noqa: F401
                           simple_scene_cuda, validate_scene)
from .ops.postprocess import to_u8  # noqa: F401
from .ops.wavefront import render_wavefront  # noqa: F401
from .render import render  # noqa: F401
