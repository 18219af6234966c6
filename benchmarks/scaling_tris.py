"""Triangle-count scaling sanity check (the reference's BVH table,
scene.cpp:109-113, is the comparison: its per-ray cost is O(log n)).

Builds Cornell-shell scenes with 1/2/4 teapot2 instances (~26k tris each)
plus the standard triangles scene (11.3k), renders each at 500x500 and
reports Mrays/s with the device it ran on — the per-bounce triangle sweep
is O(n) per ray, so this measures how the cost grows with the 9x
primitive growth (per-ray BVH traversal is the O(log n) answer).

Run on the GPU: python benchmarks/scaling_tris.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from miniraytracer_tpu.models import integrator as integ
from miniraytracer_tpu.models.scenes import SceneBuilder, ASSET_DIR, _cornell_camera
from miniraytracer_tpu.scene.obj_loader import read_obj


def teapot_grid(n_instances: int, aspect: float = 1.0):
    """Cornell shell with n_instances teapot2 meshes on a floor grid."""
    b = SceneBuilder()
    b.name = f"teapots_x{n_instances}"
    _cornell_camera(b, aspect, aperture=0.0)
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    light = b.diffuse_light(b.tex_const([7.0, 7.0, 7.0]))
    metal = b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.2)

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(443, 113, 127, 432, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, white)

    path = os.path.join(ASSET_DIR, "obj", "teapot2.obj")
    cols = max(1, int(np.ceil(np.sqrt(n_instances))))
    for k in range(n_instances):
        cx = 120 + 320 * (k % cols) / max(1, cols - 1) if cols > 1 else 278
        cz = 120 + 320 * (k // cols) / max(1, cols - 1) if cols > 1 else 278
        va, vb, vc, na, nb_, nc = read_obj(
            path, scale=90.0 / max(1.0, cols / 2.0), rot_y_deg=25.0 * k,
            translate=(cx, 0, cz),
        )
        b.triangles_bulk(va, vb, vc, metal, an=na, bn=nb_, cn=nc)
    b.add_light(l)
    b.use_sky = False
    return b.build()


def main(spp=16, width=500, height=500, bounces=32, instances=(1, 2, 4)):
    from miniraytracer_tpu.models import scenes as S

    rows = []
    sc = S.triangles(1.0)
    cases = [("triangles_11k", sc)]
    for k in instances:
        g = teapot_grid(k)
        cases.append((f"teapots_x{k}_{g.n_tris//1000}k", g))
    for label, scene in cases:
        f, st = integ.render_workqueue(scene, width, height, spp, bounces)
        jax.block_until_ready(f)
        t0 = time.perf_counter()
        f, st = integ.render_workqueue(scene, width, height, spp, bounces)
        jax.block_until_ready(f)
        el = time.perf_counter() - t0
        mr = st["rays"] / el / 1e6
        rows.append((label, scene.n_tris, mr, el))
        print(f"{label:18s} {scene.n_tris:7d} tris  {mr:6.2f} Mrays/s "
              f"({el:.2f}s) on {jax.devices()[0].device_kind}", flush=True)
    return rows


if __name__ == "__main__":
    main()
