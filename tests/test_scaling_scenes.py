"""Scaling-bench scene builders: bulk sphere construction + cull builds.

The reference's only recorded benchmark is the random_scene BVH table
(scene.cpp:109-113, n = 500..1M spheres); these tests pin the vectorized
construction path (SceneBuilder.spheres_bulk) and the adaptive cluster
builds that make those scenes renderable, plus a small end-to-end render.
"""

import numpy as np
import jax.numpy as jnp

from miniraytracer_tpu.scene.builder import SceneBuilder


def _bulk_scene(n=1000):
    import benchmarks.scaling_spheres as ss

    return ss.random_scene_n(n)


def test_spheres_bulk_matches_per_call():
    """bulk and per-call construction produce identical sphere tables."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.0, 40).astype(np.float32)

    b1 = SceneBuilder()
    b1.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m = b1.lambertian(b1.tex_const([0.5, 0.5, 0.5]))
    for c, r in zip(centers, radii):
        b1.sphere(c, float(r), m)
    s1 = b1.build()

    b2 = SceneBuilder()
    b2.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m2 = b2.lambertian(b2.tex_const([0.5, 0.5, 0.5]))
    b2.spheres_bulk(centers, radii, m2)
    s2 = b2.build()

    np.testing.assert_array_equal(np.asarray(s1.sph_c0), np.asarray(s2.sph_c0))
    np.testing.assert_array_equal(np.asarray(s1.sph_radius),
                                  np.asarray(s2.sph_radius))
    np.testing.assert_array_equal(np.asarray(s1.sph_mat), np.asarray(s2.sph_mat))
    np.testing.assert_array_equal(np.asarray(s1.sph_active),
                                  np.asarray(s2.sph_active))


def test_spheres_bulk_mixed_with_per_call_and_moving():
    """bulk blocks append after per-call spheres; moving bulk spheres keep
    their motion parameters."""
    b = SceneBuilder()
    b.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    b.sphere((0, 0, 0), 1.0, m)
    c0 = np.array([[1, 0, 0], [2, 0, 0]], np.float32)
    c1 = c0 + np.array([0, 0.5, 0], np.float32)
    b.spheres_bulk(c0, 0.2, m, centers1=c1, t0=0.0, t1=1.0)
    s = b.build()
    assert s.sph_c0.shape[0] == 3
    np.testing.assert_array_equal(np.asarray(s.sph_c0[0]), [0, 0, 0])
    np.testing.assert_array_equal(np.asarray(s.sph_c1[1:]), c1)
    assert np.asarray(s.sph_moving)[1:].all()
    assert not np.asarray(s.sph_moving)[0]


def test_triangles_bulk_matches_per_call():
    """bulk and per-call triangle construction produce identical tables."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-5, 5, (30, 3)).astype(np.float32)
    b_ = a + rng.uniform(0.1, 1, (30, 3)).astype(np.float32)
    c = a + rng.uniform(0.1, 1, (30, 3)).astype(np.float32)

    b1 = SceneBuilder()
    b1.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m = b1.lambertian(b1.tex_const([0.5, 0.5, 0.5]))
    for k in range(30):
        b1.triangle(a[k], b_[k], c[k], m)
    s1 = b1.build()

    b2 = SceneBuilder()
    b2.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
    m2 = b2.lambertian(b2.tex_const([0.5, 0.5, 0.5]))
    b2.triangles_bulk(a, b_, c, m2)
    s2 = b2.build()

    for field in ("tri_m", "tri_u", "tri_v", "tri_mat", "tri_active"):
        np.testing.assert_array_equal(np.asarray(getattr(s1, field)),
                                      np.asarray(getattr(s2, field)))
    for field in ("tri_mn", "tri_un", "tri_vn"):
        # auto-computed flat normals may differ 1 ULP (np.linalg.norm's
        # vectorized reduction vs the scalar path)
        np.testing.assert_allclose(np.asarray(getattr(s1, field)),
                                   np.asarray(getattr(s2, field)),
                                   atol=1.2e-7, rtol=0)


def test_random_scene_n_builds_requested_count():
    """random_scene_n builds the requested count (+4 fixed spheres), every
    one active, with finite centers and radii."""
    s = _bulk_scene(3000)
    assert s.n_spheres == 3004
    assert int(np.asarray(s.sph_active).sum()) == 3004
    assert np.isfinite(np.asarray(s.sph_c0)).all()
    assert np.isfinite(np.asarray(s.sph_radius)).all()


def test_random_scene_n_renders():
    """Tiny end-to-end render of a bulk-built scene stays finite and lit."""
    from miniraytracer_tpu.models import integrator as integ

    s = _bulk_scene(500)
    f, st = integ.render_wavefront(s, 24, 16, 4, max_bounces=6)
    a = np.asarray(f)
    assert np.isfinite(a).all()
    assert a.mean() > 0.05  # sky-lit scene is not black
