"""Golden-render regression tests: all nine scenes (scene.cpp:25-49).

The counter-based RNG (ops/rng.py) makes renders deterministic and
schedule-independent, so tiny fixed-seed frames are exact regression
oracles — the data-parallel analogue of the reference's deterministic mode
(cmdline_parser.h:15 "use mode=0 and threads=1 for a deterministic
runtime test"). Regenerate with tests/make_goldens.py after intentional
estimator changes.
"""

import os

import numpy as np
import pytest

from miniraytracer_tpu.models import integrator as integ
from miniraytracer_tpu.models import scenes as S
# tests/ is on sys.path (pytest's rootdir-less test modules); importing
# `tests.make_goldens` would pick up any installed package named `tests`
from make_goldens import SIZE, SPP, BOUNCES

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_renders.npz")


@pytest.fixture(scope="module")
def goldens():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden archive missing — run tests/make_goldens.py")
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("sid", range(9), ids=S.SCENE_NAMES)
def test_scene_matches_golden(goldens, sid):
    name = S.SCENE_NAMES[sid]
    scene = S.select_scene(sid, 1.0)
    frame, stats = integ.render_wavefront(scene, SIZE, SIZE, SPP, max_bounces=BOUNCES)
    got = np.asarray(frame)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, goldens[name], rtol=2e-4, atol=2e-5, err_msg=name)


def test_scene_inventory_matches_reference():
    """Object counts per scene vs scene.cpp generators (boxes are prims)."""
    cb = S.cornell_box(1.0)
    assert cb.n_rects == 6 and cb.n_boxes == 1  # walls + one box
    assert sum(bool(a) for a in np.asarray(cb.sph_active)) == 1  # glass sphere
    assert cb.lights == ((1, 2),)  # only the light (count-1 quirk, scene.cpp:326-329)
    assert not cb.use_sky

    cs = S.cornell_smoke(1.0)
    assert cs.n_volumes == 2 and cs.n_rects == 6

    ts = S.two_spheres(1.0)
    assert sum(bool(a) for a in np.asarray(ts.sph_active)) == 2
    assert ts.use_sky

    tr = S.triangles(1.0)
    # bunny (4968) + teapot (6320) + wall box? no — 6 rects + meshes
    assert tr.n_tris == 4968 + 6320
    assert tr.n_rects == 6

    b2 = S.book2_final(1.0)
    # 20x20 ground boxes as box prims (scene.cpp:409-421)
    assert b2.n_boxes == 400
    # 1000 cluster + 6 feature spheres (orange moving, glass, metal, earth,
    # perlin, subsurface boundary) — scene.cpp:386-478
    assert sum(bool(a) for a in np.asarray(b2.sph_active)) == 1006
    assert b2.n_volumes == 2  # blue subsurface interior + global fog
