"""Subprocess worker for the two-process jax.distributed CPU test.

Usage: python tests/_distributed_worker.py <proc_id> <n_procs> <port> <out>

Each process owns 4 virtual CPU devices; together they form the 8-device
(dp, sp) mesh the single-process suite uses — exercising the REAL
multi-process initialization path (SURVEY 2.3: jax.distributed.initialize
across process boundaries) that `dryrun_multichip` cannot reach.
Writes one JSON line with the replicated loss/rays so the parent can
assert cross-process agreement with the single-process mesh.
"""

import json
import sys


def main():
    proc_id, n_procs, port, out = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    import jax

    # the CPU backend with 4 virtual devices, set before any backend use
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == n_procs
    assert jax.local_device_count() == 4
    assert len(jax.devices()) == 4 * n_procs

    import jax.numpy as jnp

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models.scenes import cornell_box
    from miniraytracer_tpu.parallel import (
        auto_mesh_shape, extract_params, make_mesh, make_train_step,
    )
    from miniraytracer_tpu.parallel.render import make_frame, render_pass_sharded

    n_dp, n_sp = auto_mesh_shape(len(jax.devices()))
    mesh = make_mesh(n_dp, n_sp, jax.devices())

    width = height = 16
    max_bounces = 2
    scene = cornell_box(width / height)
    offs, _ = integ.sample_offsets(4)

    # sharded forward render pass across BOTH processes
    frame = make_frame(width, height, mesh)
    frame, rays = render_pass_sharded(
        scene, frame, jnp.int32(0), offs, jnp.float32(1000.0),
        width=width, height=height, max_bounces=max_bounces, mesh=mesh,
    )

    # one full train step: fwd -> psum loss -> bwd -> gradient all-reduce
    step = make_train_step(mesh, width=width, height=height,
                           max_bounces=max_bounces)
    params = extract_params(scene)
    target = make_frame(width, height, mesh)
    _, loss, grads = step(params, scene, target, jnp.int32(0), offs,
                          jnp.float32(1e-3))
    jax.block_until_ready(loss)
    finite = all(bool(jnp.isfinite(g).all())
                 for g in jax.tree_util.tree_leaves(grads))
    with open(out, "w") as f:
        json.dump({
            "proc": proc_id,
            "rays": float(rays),
            "loss": float(loss),
            "grads_finite": finite,
            "devices": len(jax.devices()),
        }, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
