"""Sphere-count scaling against the reference's BVH table.

The reference's one recorded scaling benchmark (scene.cpp:109-113) renders
random_scene at n = 500..1M spheres, 600x400 x 16 spp, depth 16, ONE
thread: linear list 62.57 s (n=500) / "too long" beyond; best BVH ("bvh
re") 8.55 / 10.12 / 13.91 / 18.66 / 23.24 s for n = 500/1k/10k/100k/1M.
This bench renders the same configuration class (same camera, same
material mix, grid extended to reach n) through the work queue's
per-bounce sphere sweep and reports seconds + Mrays/s per n, with the
device they were measured on.

Geometry is built with numpy RNG (a scaling bench, not a parity scene —
the bit-matched 500-sphere random_spheres parity scene lives in
models/scenes.py).

Run on the GPU: python benchmarks/scaling_spheres.py
"""
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF_SECONDS = {500: 8.55, 1000: 10.12, 10_000: 13.91, 100_000: 18.66,
               1_000_000: 23.24}  # "bvh re" row, scene.cpp:113


def random_scene_n(n: int, aspect: float = 1.5):
    """random_scene (scene.cpp:51-119) with the small-sphere grid extended
    to ~n spheres: cells of size 1 centered on a side x side grid, same
    material mix (75% moving lambertian, 20% metal, 5% glass), same ground
    sphere, three big spheres, and the reference camera."""
    import jax.numpy as jnp
    from miniraytracer_tpu.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.name = f"random_scene_{n}"
    b.set_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.1, 10.0,
                 0.0, 1.0)
    ground = b.lambertian(b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0))
    b.sphere((0, -1000, 0), 1000.0, ground)
    glass = b.dielectric(1.5)
    b.sphere((0, 1, 0), 1.0, glass)
    brown = b.lambertian(b.tex_const([0.4, 0.2, 0.1]))
    b.sphere((-4, 1, 0), 1.0, brown)
    metal_big = b.metal(b.tex_const([0.7, 0.6, 0.5]), 1.0)
    b.sphere((4, 1, 0), 1.0, metal_big)

    rng = np.random.default_rng(42)
    side = max(2, int(math.ceil(math.sqrt(n))))
    ax = np.arange(side) - side // 2
    gx, gz = np.meshgrid(ax, ax, indexing="ij")
    gx = gx.reshape(-1)[:n].astype(np.float32)
    gz = gz.reshape(-1)[:n].astype(np.float32)
    cx = gx + 0.9 * rng.uniform(size=n).astype(np.float32)
    cz = gz + 0.9 * rng.uniform(size=n).astype(np.float32)
    cy = np.full(n, 0.2, np.float32)
    centers = np.stack([cx, cy, cz], axis=1)

    choose = rng.uniform(size=n)
    # materials: per-sphere handles; one lambertian per random albedo is
    # table-heavy at 1M, so bucket albedos into 64 shared materials/kind
    lam_handles = [b.lambertian(b.tex_const(rng.uniform(size=3) ** 2))
                   for _ in range(64)]
    met_handles = [b.metal(b.tex_const(0.5 * (1 + rng.uniform(size=3))),
                           1.0 - 0.5 * rng.uniform())
                   for _ in range(64)]
    bucket = rng.integers(0, 64, n)
    mats = np.where(
        choose < 0.75, np.asarray(lam_handles, np.int32)[bucket],
        np.where(choose < 0.95, np.asarray(met_handles, np.int32)[bucket],
                 np.int32(glass)),
    ).astype(np.int32)

    # 75% bucket moves like the reference (y jitter over the shutter)
    mov = choose < 0.75
    c1 = centers.copy()
    c1[:, 1] += np.where(mov, 0.5 * rng.uniform(size=n), 0.0).astype(np.float32)
    b.spheres_bulk(centers[mov], 0.2, mats[mov], centers1=c1[mov],
                   t0=0.0, t1=1.0)
    b.spheres_bulk(centers[~mov], 0.2, mats[~mov])
    b.use_sky = True
    return b.build()


def main(ns=(500, 1000, 10_000, 100_000, 1_000_000), spp=16, width=600,
         height=400, bounces=16):
    import jax
    from miniraytracer_tpu.models import integrator as integ

    rows = []
    for n in ns:
        t0 = time.perf_counter()
        scene = random_scene_n(n)
        t_build = time.perf_counter() - t0
        f, st = integ.render_workqueue(scene, width, height, spp, bounces)
        jax.block_until_ready(f)
        t0 = time.perf_counter()
        f, st = integ.render_workqueue(scene, width, height, spp, bounces)
        jax.block_until_ready(f)
        el = time.perf_counter() - t0
        mr = st["rays"] / el / 1e6
        ref = REF_SECONDS.get(n)
        speedup = f"{ref / el:7.1f}x" if ref else "      ?"
        rows.append((n, mr, el, t_build))
        print(f"n={n:8d}  {mr:7.2f} Mrays/s  {el:7.2f}s render "
              f"(build {t_build:.1f}s)  vs ref-BVH-1thread {speedup}  "
              f"on {jax.devices()[0].device_kind}", flush=True)
    return rows


if __name__ == "__main__":
    main()
