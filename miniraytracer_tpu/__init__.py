"""miniraytracer_tpu — a differentiable path tracer in JAX for the GPU.

A from-scratch reimplementation of the capability set of the reference CPU
renderer Maraneshi/MiniRayTracer (see SURVEY.md / STATUS.md), designed for
data-parallel accelerators:

- SoA scene tables + tagged dispatch instead of C++ virtual classes
- iterative wavefront bounce loops with lane regeneration / a global work
  queue instead of recursion (reference: main.cpp:66-118)
- counter-based stateless RNG instead of thread-local PCG32 (pcg.cpp:40-46)
- a fused Pallas (Triton) megakernel for the forward wavefront of small
  scenes; plain XLA everywhere else
- pixel/sample sharding over a `jax.sharding.Mesh` instead of a pthread
  tile queue (work_queue.cpp)
- differentiable forward pass (XLA autodiff through a packed scan) with
  gradients w.r.t. material albedo, emission and geometry

Quick start:

    import miniraytracer_tpu as mrt
    scene = mrt.scenes.cornell_box(aspect=1.0)
    frame, stats = mrt.render(scene, 500, 500, spp=64)
"""

__version__ = "0.2.0"

from miniraytracer_tpu.scene.types import SceneData, Camera  # noqa: F401
from miniraytracer_tpu.scene.builder import SceneBuilder  # noqa: F401
from miniraytracer_tpu.models import scenes  # noqa: F401
from miniraytracer_tpu.models.integrator import (  # noqa: F401
    render_auto as render,
    render_wavefront,
    render_workqueue,
    render as render_progressive,
    pick_renderer,
)
