"""Differentiable-path (forward+backward) throughput for ALL nine scenes.

The north star asks for gradients w.r.t. albedo/emission/geometry as a
first-class capability — this publishes the per-scene train-step table:
one full differentiable render step (forward render of `spp_step`
samples/pixel + reverse sweep producing TrainParams gradients) through the
packed regeneration-in-scan XLA path, at the reference's Cornell headline
config (500x500, 32-bounce cap). Times end in block_until_ready; each
result names the device. Needs a GPU.

Run on the GPU:  python benchmarks/ad_scenes.py [scene ...]
Prints one result line per scene and a JSON summary line at the end.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from miniraytracer_tpu.models import integrator as integ
from miniraytracer_tpu.models import scenes as S
from miniraytracer_tpu.parallel import (
    extract_params, make_mesh, make_train_step,
)
from miniraytracer_tpu.parallel.render import make_frame, render_pass_sharded
from miniraytracer_tpu.utils.compile_cache import enable_compile_cache

BASELINE_MRAYS = 8.0  # measured reference CPU forward (see bench.py)
SCENES = ["random_spheres", "random_spheres_2", "two_spheres",
          "perlin_spheres", "earth", "cornell_box", "cornell_smoke",
          "book2_final", "triangles"]


def measure_scene(name: str, *, width=500, height=500, bounces=32,
                  pack=16, spp_step=8, steps=4, scan_steps=0):
    scene = getattr(S, name)(width / height)
    mesh = make_mesh(len(jax.devices()), 1)
    offs, _ = integ.sample_offsets(64)
    ml = jnp.float32(1000.0)
    # target frame: one progressive pass
    frame = make_frame(width, height, mesh)
    frame, _ = render_pass_sharded(
        scene, frame, jnp.int32(0), offs, ml,
        width=width, height=height, max_bounces=bounces, mesh=mesh,
        loop="while",
    )
    jax.block_until_ready(frame)

    step = make_train_step(mesh, width=width, height=height,
                           max_bounces=bounces, pack=pack,
                           spp_step=spp_step, scan_steps=scan_steps)
    params = extract_params(scene)
    lr = jnp.float32(0.0)

    # traced-ray accounting (same protocol as bench.py): the step's forward
    # trip count, measured with the exact item list the step renders
    pix_all = jnp.tile(jnp.arange(width * height, dtype=jnp.uint32),
                       spp_step)
    samp_all = jnp.repeat(jnp.arange(spp_step, dtype=jnp.int32),
                          width * height)
    off_all = offs[samp_all % offs.shape[0]]
    pad = (-pix_all.shape[0]) % pack
    if pad:
        pix_all = jnp.concatenate(
            [pix_all, jnp.full((pad,), width * height - 1, jnp.uint32)])
        samp_all = jnp.concatenate([samp_all, samp_all[-1:].repeat(pad)])
        off_all = jnp.concatenate(
            [off_all, jnp.broadcast_to(off_all[-1:], (pad, 2))])
    _, done_mask, ray_ctr = integ.sample_radiance_packed(
        scene, pix_all, samp_all, off_all, width=width, height=height,
        max_bounces=bounces, pack=pack, scan_steps=scan_steps)
    done_frac = float(done_mask.mean())
    rays = float(ray_ctr)

    # two warmups (second compiles the fed-back param shardings)
    params, loss, grads = step(params, scene, frame, jnp.int32(0), offs, lr)
    params, loss, grads = step(params, scene, frame, jnp.int32(0), offs, lr)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for i in range(steps):
        params, loss, grads = step(params, scene, frame, jnp.int32(i), offs,
                                   lr)
    jax.block_until_ready((params, loss, grads))
    dt = (time.perf_counter() - t0) / steps
    finite = all(bool(jnp.isfinite(g).all())
                 for g in jax.tree_util.tree_leaves(grads))
    mrays = rays / dt / 1e6
    return {
        "scene": name, "fwdbwd_mrays_per_s": round(mrays, 3),
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "device_kind": jax.devices()[0].device_kind,
        "step_seconds": round(dt, 3), "rays_per_step": rays,
        "done_frac": round(done_frac, 5), "grads_finite": finite,
        "loss": float(loss),
    }


def main():
    if jax.default_backend() != "gpu":
        sys.exit("ad_scenes: needs a GPU")
    enable_compile_cache()
    names = sys.argv[1:] or SCENES
    results = []
    for name in names:
        try:
            r = measure_scene(name)
        except Exception as e:  # keep sweeping; report the failure
            r = {"scene": name, "error": f"{type(e).__name__}: {e}"}
        print(r, flush=True)
        results.append(r)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
