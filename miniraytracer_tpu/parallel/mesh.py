"""Device mesh construction.

The renderer's two parallel axes (SURVEY.md section 2.2):
- `dp`: data-parallel over pixels (the reference's tile scheduler axis,
  work_queue.cpp:133-149)
- `sp`: sample-parallel over progressive passes (the reference's dynamic
  per-sample passes, work_queue.cpp:158-175)

Rays are embarrassingly parallel and the scene is replicated, so both axes
are pure data parallelism; `sp` additionally carries a mean-reduction
(`psum`) when averaging passes on-device.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor n_devices into (dp, sp) with sp in {1, 2} — pixels dominate."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


def make_mesh(n_dp: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh. Defaults to all devices on the dp axis."""
    if devices is None:
        devices = jax.devices()
    if n_dp is None:
        n_dp = len(devices) // n_sp
    devs = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devs, ("dp", "sp"))


def init_distributed(coordinator: str,
                     num_processes: int,
                     process_id: int) -> Mesh:
    """Multi-process initialization (the reference has no multi-process
    story; SURVEY.md section 2.3).

    Call once per process before any jax op, with the coordinator's
    `host:port`, the process count and this process's id: nothing in the
    environment describes the cluster, so all three are required. Returns
    the global (dp, sp) mesh over every device of every process. The mesh
    follows the algorithm, not the wiring: the GPUs of a host are joined
    all to all (NVLink), so any device order serves, and XLA hands the
    pass `psum`s and the gradient all-reduce (parallel/train.py) to NCCL.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    n_dp, n_sp = auto_mesh_shape(len(jax.devices()))
    return make_mesh(n_dp, n_sp)
