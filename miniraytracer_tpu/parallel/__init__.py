"""Device-parallel layer: mesh construction, sharded rendering, distributed
training step.

Data-parallel replacement for the reference's pthread work queue
(work_queue.cpp): instead of worker threads pulling Hilbert-ordered tiles off
an atomic counter, the image is *statically sharded* over a
`jax.sharding.Mesh` — pixels over the `dp` axis, progressive sample passes
over the `sp` axis — and XLA inserts the collectives (`psum` for metrics,
loss and gradient reduction). The scene/BVH tables are replicated in device
memory on every device (SURVEY.md section 2.2-2.3).
"""

from miniraytracer_tpu.parallel.mesh import (  # noqa: F401
    make_mesh, auto_mesh_shape, init_distributed,
)
from miniraytracer_tpu.parallel.render import (  # noqa: F401
    render_pass_sharded,
    render_distributed,
    render_wavefront_distributed,
    render_workqueue_distributed,
)
from miniraytracer_tpu.parallel.train import (  # noqa: F401
    TrainParams,
    extract_params,
    apply_params,
    make_train_step,
)
