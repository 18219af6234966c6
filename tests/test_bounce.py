"""Fused Pallas-Triton render kernel (ops/bounce.py) vs the XLA wavefront.

The fused kernel re-implements the ENTIRE wavefront body — scene_hit,
shade, merge, regeneration (the reference trace() body, main.cpp:66-118,
plus draw2 merge semantics, main.cpp:214-231) — so these tests demand
estimator-identical output: same ray counts, frames equal to float
reassociation tolerance, against render_wavefront on the same scene.

They run the kernel in interpret mode on the CPU; the compiled kernel is
checked against the same reference on the GPU by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniraytracer_tpu.models import integrator as integ
from miniraytracer_tpu.models import scenes as S
from miniraytracer_tpu.models.scenes import SceneBuilder
from miniraytracer_tpu.ops import bounce


def _compare(scene, W=16, H=16, spp=4, bounces=6, tol=1e-5, lanes=128):
    # 128-lane blocks: the interpreter runs the grid's programs one after
    # another, so fewer, wider blocks keep the CPU test short
    f_x, st_x = integ.render_wavefront(scene, W, H, spp, max_bounces=bounces)
    f_f, st_f = bounce.render_wavefront_fused(
        scene, W, H, spp, max_bounces=bounces, interpret=True, lanes=lanes)
    assert f_f.shape == (H, W, 3)
    assert st_x["rays"] == st_f["rays"], (st_x["rays"], st_f["rays"])
    d = np.abs(np.asarray(f_x) - np.asarray(f_f)).max()
    assert d < tol, f"max frame diff {d}"


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "two_spheres", "perlin_spheres"])
def test_fused_matches_wavefront(name):
    _compare(getattr(S, name)(1.0))


def test_fused_moving_sphere_lens_camera():
    """Moving sphere + thin-lens aperture + shutter interval: exercises the
    in-kernel camera (lens disk, time sample at packed camera offsets
    18-20) and the motion-blur center lerp."""
    b = SceneBuilder()
    b.name = "moving"
    b.set_camera([0, 1, 5], [0, 0.5, 0], [0, 1, 0], 40.0, 1.0,
                 aperture=0.4, focus_dist=5.0, t0=0.0, t1=1.0)
    gray = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    red = b.lambertian(b.tex_const([0.8, 0.2, 0.2]))
    b.sphere([0, -1000, 0], 1000, gray)
    b.sphere([-0.6, 0.5, 0], 0.5, red, center1=[0.6, 0.5, 0], t0=0.0, t1=1.0)
    b.sphere([1.2, 0.4, -0.5], 0.4, b.metal(b.tex_const([0.9, 0.9, 0.9]), 0.7))
    b.sphere([-1.2, 0.4, 0.5], 0.4, b.dielectric(1.5))
    b.use_sky = True
    _compare(b.build(), W=16, H=16, spp=4, bounces=6)


def test_fused_light_mixture_scene():
    """Sphere + rect lights via the 50/50 mixture pdf path in-kernel."""
    b = SceneBuilder()
    b.name = "lights"
    b.set_camera([278, 278, -800], [278, 278, 0], [0, 1, 0], 40.0, 1.0,
                 aperture=0.0, focus_dist=10.0, t0=0.0, t1=0.0)
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    lightm = b.diffuse_light(b.tex_const([1, 1, 1]), 15.0)
    b.yz_rect(0, 555, 0, 555, 555, b.lambertian(b.tex_const([0.12, 0.45, 0.15])))
    b.yz_rect(0, 555, 0, 555, 0, b.lambertian(b.tex_const([0.65, 0.05, 0.05])))
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xz_rect(0, 555, 0, 555, 555, white)
    b.xy_rect(0, 555, 0, 555, 555, white)
    lr = b.xz_rect(213, 343, 227, 332, 554, lightm)
    ls = b.sphere([400, 90, 190], 90, lightm)
    b.add_light(lr)
    b.add_light(ls)
    _compare(b.build(), W=16, H=16, spp=4, bounces=6)


def test_fused_lane_padding_not_block_multiple():
    """15x13 = 195 pixels over 64-lane blocks: the last block holds 61
    padding lanes, which must neither trace (ray count) nor leak into the
    frame."""
    _compare(S.cornell_box(15 / 13), W=15, H=13, spp=4, bounces=4, lanes=64)


def test_fused_nonzero_sample_lo_matches_wavefront_pixels():
    """A sample block that starts past 0 (the sharded renderer's sp axis)
    keys, offsets and regenerates exactly like the XLA pixel renderer."""
    scene = S.cornell_box(1.0)
    W = H = 12
    spp, lo, cnt = 9, 3, 4
    offs, _ = integ.sample_offsets(spp)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    a_x, c_x, r_x = jax.jit(functools.partial(
        integ.render_wavefront_pixels, width=W, height=H, max_bounces=4))(
        scene, pix, offs, jnp.int32(lo), jnp.int32(cnt), jnp.float32(1000.0))
    a_f, c_f, r_f = bounce.render_wavefront_fused_pixels(
        scene, pix, jnp.int32(lo), jnp.int32(cnt), jnp.float32(1000.0),
        width=W, height=H, max_bounces=4, spp_sq=3, interpret=True)
    np.testing.assert_array_equal(np.asarray(c_x), np.asarray(c_f))
    assert float(r_x) == float(r_f)
    np.testing.assert_allclose(np.asarray(a_f.arr), np.asarray(a_x.arr),
                               atol=1e-4, rtol=1e-5)


def test_fused_distributed_matches_xla_distributed():
    """Sharded fused path ((dp, sp) mesh, traced sample blocks) must match
    the sharded XLA wavefront exactly (same per-(pixel,sample) keys)."""
    from miniraytracer_tpu.parallel import render as prender
    from miniraytracer_tpu.parallel.mesh import make_mesh

    scene = S.cornell_box(1.0)
    mesh = make_mesh(4, 2)
    f_x, st_x = prender.render_wavefront_distributed(
        scene, 16, 16, 9, mesh, max_bounces=6, fused=False)
    f_f, st_f = prender.render_wavefront_distributed(
        scene, 16, 16, 9, mesh, max_bounces=6, fused=True, interpret=True)
    assert st_f["renderer"] == "wavefront-fused"
    assert st_x["rays"] == st_f["rays"]
    d = np.abs(np.asarray(f_x) - np.asarray(f_f)).max()
    assert d < 1e-5, f"max frame diff {d}"


def test_can_fuse_gating():
    # big scenes / image scenes never fit; small scenes fit but fuse only
    # on the GPU backend (cpu here)
    assert not bounce.fits(S.random_spheres(1.0))
    sc = S.cornell_box(1.0)
    assert bounce.fits(sc) and not bounce.can_fuse(sc)
    meta, tab, ptab = bounce.pack_scene(sc)
    assert meta["S"] == sc.n_spheres and meta["R"] == sc.n_rects
    assert ptab.shape == (6 * 256,)
    # camera tail layout: lens_radius, time0, time1 at offsets 18..20
    camv = np.asarray(tab)[dict(meta["offsets"])["cam"]:]
    assert camv.shape[0] == 21
    assert camv[18] == pytest.approx(float(sc.camera.lens_radius))
    assert camv[19] == pytest.approx(float(sc.camera.time0))
    assert camv[20] == pytest.approx(float(sc.camera.time1))


# ---------------------------------------------------------------------------
# renderer choice per scene and backend
# ---------------------------------------------------------------------------


def _mesh_scene():
    """Stand-in for the `triangles` scene (whose OBJ assets are not part of
    the repository): a 2,048-triangle mesh plus a ground sphere."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    b.name = "mesh"
    b.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    a = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    b.triangles_bulk(a, a + [0.1, 0, 0], a + [0, 0.1, 0], m)
    b.sphere([0, -1000, 0], 999, m)
    b.use_sky = True
    return b.build()


# (scene, renderer on the GPU, renderer on the CPU)
PICKS = [
    ("cornell_box", "fused", "wavefront"),
    ("cornell_smoke", "fused", "wavefront"),
    ("two_spheres", "fused", "wavefront"),
    ("perlin_spheres", "fused", "wavefront"),
    ("earth", "wavefront", "wavefront"),  # image texture: XLA path
    ("random_spheres", "workqueue", "workqueue"),
    ("random_spheres_2", "workqueue", "workqueue"),
    ("book2_final", "workqueue", "workqueue"),
    ("mesh", "workqueue", "workqueue"),
]


@functools.lru_cache(maxsize=None)
def _scene(name):
    return _mesh_scene() if name == "mesh" else getattr(S, name)(1.0)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize("name,on_gpu,on_cpu", PICKS)
def test_pick_renderer_per_scene_and_backend(monkeypatch, backend, name,
                                             on_gpu, on_cpu):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    scene = _scene(name)
    want = on_gpu if backend == "gpu" else on_cpu
    assert bounce.can_fuse(scene) == (want == "fused")
    assert bounce.fits(scene) == (on_gpu == "fused")
    assert integ.pick_renderer(scene) == want


@pytest.mark.gpu
def test_fused_compiled_matches_wavefront_on_gpu(gpu_device):
    """The kernel as Triton compiles it for the card (no interpret mode)
    against the XLA wavefront on the same card."""
    scene = S.cornell_box(1.0)
    with jax.default_device(gpu_device):
        f_x, st_x = integ.render_wavefront(scene, 64, 64, 16, max_bounces=8)
        f_f, st_f = bounce.render_wavefront_fused(scene, 64, 64, 16,
                                                  max_bounces=8)
    f_x, f_f = np.asarray(f_x), np.asarray(f_f)
    assert np.isfinite(f_f).all()
    rel = np.abs(f_f.mean((0, 1)) / f_x.mean((0, 1)) - 1.0).max()
    assert rel < 5e-3, rel
    assert abs(st_f["rays"] / st_x["rays"] - 1.0) < 5e-3
