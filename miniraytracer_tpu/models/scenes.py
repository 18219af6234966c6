"""The nine built-in scenes (scene.cpp:25-529), compiled to SceneData tables.

Scene-gen randomness replicates the reference's deterministic main-thread
stream: PCG32 seeded with the fixed constants of main.cpp:302, so object
placement matches the reference bit-for-bit (up to C++ argument evaluation
order inside Vec3 ctor calls — we use left-to-right; verified empirically
against the patched reference build).

Assets (earthmap.jpg, obj meshes) are read from MRT_ASSETS (default
/root/reference); missing assets degrade gracefully (procedural fallback /
mesh skipped) exactly like the reference's `if (tris && bunny)` guards
(scene.cpp:504-513).
"""

from __future__ import annotations

import math
import os

import numpy as np

from miniraytracer_tpu.ops.rng import Pcg32
from miniraytracer_tpu.scene.builder import SceneBuilder, _roty_fwd
from miniraytracer_tpu.scene.obj_loader import read_obj

# scene ids (scene.h:6-17)
SCENE_RANDOM_SPHERES = 0
SCENE_RANDOM_SPHERES_2 = 1
SCENE_TWO_SPHERES = 2
SCENE_PERLIN_SPHERES = 3
SCENE_EARTH = 4
SCENE_CORNELL_BOX = 5
SCENE_CORNELL_SMOKE = 6
SCENE_BOOK2_FINAL = 7
SCENE_TRIANGLES = 8

SCENE_NAMES = [
    "random_spheres", "random_spheres_2", "two_spheres", "perlin_spheres",
    "earth", "cornell_box", "cornell_smoke", "book2_final", "triangles",
]

ASSET_DIR = os.environ.get("MRT_ASSETS", "/root/reference")


def _scene_rng() -> Pcg32:
    """Deterministic scene-gen stream (main.cpp:302)."""
    return Pcg32(11350390909718046443, 6305599193148252115)


def earthmap_available() -> bool:
    """Whether earth-textured scenes load the reference's earthmap.jpg
    (False: they use the procedural fallback of _load_earthmap)."""
    try:
        _load_earthmap_file()
        return True
    except Exception:
        return False


def _load_earthmap_file():
    from PIL import Image

    im = Image.open(os.path.join(ASSET_DIR, "earthmap.jpg")).convert("RGB")
    return np.asarray(im, np.uint8)


def _load_earthmap():
    """earthmap.jpg via PIL (stb_image equivalent); procedural fallback."""
    try:
        return _load_earthmap_file()
    except Exception:
        # procedural blue-green latitude bands so the scene still renders
        h, w = 256, 512
        y = np.linspace(0, 1, h)[:, None]
        img = np.stack(
            [np.full((h, w), 0.2), 0.3 + 0.4 * np.tile(np.abs(np.sin(6 * np.pi * y)), (1, w)), np.full((h, w), 0.6)],
            axis=-1,
        )
        return (img * 255).astype(np.uint8)


def _book1_camera(b: SceneBuilder, aspect):
    """Shared camera of the book-1 style scenes (scene.cpp:54-63)."""
    pos = np.array([11, 2.2, 2.5], np.float32)
    look = np.array([2.8, 0.5, 1.2], np.float32)
    b.set_camera(pos, look, [0, 1, 0], 27.0, aspect, 0.09,
                 float(np.linalg.norm(pos - look)), 0.0, 1.0)


def random_spheres(aspect, n=500):
    """Shirley book-1 final (scene.cpp:51-119)."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "random_spheres"
    _book1_camera(b, aspect)
    checker = b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0)
    b.sphere([0, -1000, 0], 1000, b.lambertian(checker))

    half = int(math.sqrt(float(n)) * 0.5)
    for a in range(-half, half):
        for bb in range(-half, half):
            # C++ evaluates ctor args RIGHT-TO-LEFT (MSVC/GCC): in
            # `Vec3(a + 0.9f*randf(), 0.2f, b + 0.9f*randf())` the z draw
            # comes FIRST; in `new metal(new color_tex(Vec3(r,g,b)), gloss)`
            # the gloss draw precedes the color draws, which land b,g,r
            choose = g.randf()
            cz = bb + 0.9 * g.randf()
            cx = a + 0.9 * g.randf()
            center = np.array([cx, 0.2, cz], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0], np.float32)) > 0.9:
                if choose < 0.5:
                    cb = g.randf() * g.randf()
                    cg = g.randf() * g.randf()
                    cr = g.randf() * g.randf()
                    m = b.lambertian(b.tex_const([cr, cg, cb]))
                    c1 = center + np.array([0, 0.5 * g.randf(), 0], np.float32)
                    b.sphere(center, 0.2, m, center1=c1, t0=0.0, t1=1.0)
                elif choose < 0.9:
                    gloss = g.randf()
                    cb = 0.5 * (1 + g.randf())
                    cg = 0.5 * (1 + g.randf())
                    cr = 0.5 * (1 + g.randf())
                    m = b.metal(b.tex_const([cr, cg, cb]), gloss)
                    b.sphere(center, 0.2, m)
                else:
                    m = b.dielectric(1.4 + g.randf())
                    b.sphere(center, 0.2, m)

    b.sphere([0, 1, 0], 1.0, b.dielectric(1.5))
    b.sphere([-4, 1, 0], 1.0, b.lambertian(b.tex_const([0.4, 0.2, 0.1])))
    b.sphere([4, 1, 0], 1.0, b.metal(b.tex_const([0.7, 0.6, 0.5]), 1.0))
    b.sphere([4, 1, 3], 1.0, b.dielectric(2.4))
    b.sphere([4, 1, 3], -0.95, b.dielectric(2.4))
    b.use_sky = True
    return b.build()


def random_spheres_2(aspect, n=500):
    """Textured variant (scene.cpp:122-203)."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "random_spheres_2"
    _book1_camera(b, aspect)
    earth = b.lambertian(b.tex_image(_load_earthmap()))
    checker = b.lambertian(b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0))
    perlin = b.lambertian(b.tex_perlin(1.0))
    perlin_small = b.lambertian(b.tex_perlin(4.0))

    b.sphere([0, -1000, 0], 1000, perlin)
    half = int(math.sqrt(float(n)) * 0.5)
    for a in range(-half, half):
        for bb in range(-half, half):
            # right-to-left ctor arg evaluation — see random_spheres
            choose = g.randf()
            cz = bb + 0.9 * g.randf()
            cx = a + 0.9 * g.randf()
            center = np.array([cx, 0.2, cz], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0], np.float32)) > 0.9:
                if choose < 0.3:
                    cb = g.randf() * g.randf()
                    cg = g.randf() * g.randf()
                    cr = g.randf() * g.randf()
                    m = b.lambertian(b.tex_const([cr, cg, cb]))
                    c1 = center + np.array([0, 0.5 * g.randf(), 0], np.float32)
                    b.sphere(center, 0.2, m, center1=c1, t0=0.0, t1=1.0)
                else:
                    if choose < 0.6:
                        gloss = g.randf()
                        cb = 0.5 * (1 + g.randf())
                        cg = 0.5 * (1 + g.randf())
                        cr = 0.5 * (1 + g.randf())
                        m = b.metal(b.tex_const([cr, cg, cb]), gloss)
                    elif choose < 0.7:
                        m = b.dielectric(1.4 + g.randf())
                    elif choose < 0.75:
                        m = earth
                    else:
                        m = perlin_small
                    b.sphere(center, 0.2, m)

    b.sphere([0, 1, 0], 1.0, b.dielectric(1.5))
    b.sphere([-4, 1, 0], 1.0, checker)
    b.sphere([4, 1, 0], 1.0, b.metal(b.tex_const([0.7, 0.6, 0.5]), 1.0))
    b.sphere([4, 1, 3], 1.0, b.dielectric(2.4))
    b.sphere([4, 1, 3], -0.95, b.dielectric(2.4))
    b.use_sky = True
    return b.build()


def two_spheres(aspect):
    """scene.cpp:206-229."""
    b = SceneBuilder()
    b.name = "two_spheres"
    _book1_camera(b, aspect)
    checker = b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0)
    m = b.lambertian(checker)
    b.sphere([0, -10, 0], 10, m)
    b.sphere([0, 10, 0], 10, m)
    b.use_sky = True
    return b.build()


def perlin_spheres(aspect):
    """scene.cpp:231-252."""
    b = SceneBuilder()
    b.name = "perlin_spheres"
    _book1_camera(b, aspect)
    b.sphere([0, -1001, 0], 1000, b.lambertian(b.tex_perlin(1.0)))
    b.sphere([0, 1, 0], 2, b.lambertian(b.tex_perlin(4.0)))
    b.sphere([0.5, -0.5, 2], 0.5, b.lambertian(b.tex_perlin(16.0)))
    b.use_sky = True
    return b.build()


def earth(aspect):
    """scene.cpp:255-281."""
    b = SceneBuilder()
    b.name = "earth"
    _book1_camera(b, aspect)
    em = b.lambertian(b.tex_image(_load_earthmap()))
    b.sphere([0, -1001, 0], 1000, b.lambertian(b.tex_perlin(1.0)))
    b.sphere([0, 1, 0], 2, em)
    b.sphere([0.5, -0.5, 2], 0.5, em)
    b.use_sky = True
    return b.build()


def _cornell_camera(b: SceneBuilder, aspect, pos=(278, 278, -800), look=(278, 278, 100), aperture=0.0):
    pos = np.asarray(pos, np.float32)
    look = np.asarray(look, np.float32)
    b.set_camera(pos, look, [0, 1, 0], 40.0, aspect, aperture,
                 float(np.linalg.norm(pos - look)), 0.0, 1.0)


def cornell_box(aspect):
    """scene.cpp:284-334 (light intensity 15; only the light is
    importance-sampled — the glass sphere is excluded by the reference's
    count-1 list quirk, scene.cpp:326-329)."""
    b = SceneBuilder()
    b.name = "cornell_box"
    _cornell_camera(b, aspect)
    red = b.lambertian(b.tex_const([0.65, 0.055, 0.06]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.117, 0.44, 0.115]))
    light = b.diffuse_light(b.tex_const([15.0, 15.0, 15.0]))
    glass = b.dielectric(1.5)

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(343, 213, 227, 332, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, white)
    b.box([0, 0, 0], [165, 330, 165], white, rot_y_deg=15.0, offset=[265, 0, 295])
    b.sphere([190, 90, 190], 90, glass)

    b.add_light(l)
    b.use_sky = False
    return b.build()


def cornell_smoke(aspect):
    """scene.cpp:337-383."""
    b = SceneBuilder()
    b.name = "cornell_smoke"
    _cornell_camera(b, aspect)
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    light = b.diffuse_light(b.tex_const([7.0, 7.0, 7.0]))

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(443, 113, 127, 432, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, white)
    b.volume_box([0, 0, 0], [165, 165, 165], 0.01, b.tex_const([1.0, 1.0, 1.0]),
                 rot_y_deg=-18.0, offset=[130, 0, 65])
    b.volume_box([0, 0, 0], [165, 330, 165], 0.01, b.tex_const([0.0, 0.0, 0.0]),
                 rot_y_deg=15.0, offset=[265, 0, 295])

    b.add_light(l)
    b.use_sky = False
    return b.build()


def book2_final(aspect):
    """Shirley book-2 final (scene.cpp:386-478)."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "book2_final"
    _cornell_camera(b, aspect, pos=(450, 278, -560), look=(200, 278, 300))

    earth_m = b.lambertian(b.tex_image(_load_earthmap()))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.48, 0.83, 0.53]))
    light = b.diffuse_light(b.tex_const([7.0, 7.0, 7.0]))
    orange = b.lambertian(b.tex_const([0.7, 0.3, 0.1]))
    perlin = b.lambertian(b.tex_perlin(0.05))

    # 20x20 ground boxes with random heights (scene.cpp:409-421)
    nb = 20
    for i in range(nb):
        for j in range(nb):
            w = 100.0
            x0 = -1000 + i * w
            z0 = -1000 + j * w
            y1 = 100 * (g.randf() + 0.01)
            b.box([x0, 0, z0], [x0 + w, y1, z0 + w], green)

    l = b.xz_rect(423, 123, 147, 412, 554, light)
    b.sphere([400, 400, 200], 50, orange, center1=[430, 400, 200], t0=0, t1=1)
    b.sphere([260, 150, 45], 50, b.dielectric(1.5))
    b.sphere([0, 150, 145], 50, b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.1))
    b.sphere([400, 200, 400], 100, earth_m)
    b.sphere([220, 280, 300], 80, perlin)

    # blue subsurface sphere: dielectric boundary + interior volume
    b.sphere([360, 150, 145], 70, b.dielectric(1.5))
    b.volume_sphere([360, 150, 145], 70, 0.2, b.tex_const([0.2, 0.4, 0.9]))
    # global fog
    b.volume_sphere([0, 0, 0], 5000, 0.0001, b.tex_const([1.0, 1.0, 1.0]))

    # cluster of 1000 white spheres in a rotated+translated box
    # (scene.cpp:445-449); rotation/translation baked into centers
    R = _roty_fwd(15.0)
    off = np.array([-100, 270, 395], np.float32)
    for _ in range(1000):
        # right-to-left ctor args: z, y, x draw order
        z_ = 165 * g.randf()
        y_ = 165 * g.randf()
        x_ = 165 * g.randf()
        c = np.array([x_, y_, z_], np.float32)
        b.sphere(R @ c + off, 10, white)

    b.add_light(l)
    b.use_sky = False
    return b.build()


def triangles(aspect):
    """OBJ mesh scene (scene.cpp:481-529): Cornell shell with silver back
    wall, dielectric bunny + teapot meshes, heavy depth of field."""
    b = SceneBuilder()
    b.name = "triangles"
    _cornell_camera(b, aspect, aperture=20.0)
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    light = b.diffuse_light(b.tex_const([4.0, 4.0, 4.0]))
    silver = b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.9)
    dia = b.dielectric(2.4)

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(443, 113, 127, 432, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, silver)

    def _add_mesh(fname, **kw):
        path = os.path.join(ASSET_DIR, "obj", fname)
        if not os.path.exists(path):
            return 0
        va, vb, vc, na, nb_, nc = read_obj(path, **kw)
        for t in range(va.shape[0]):
            b.triangle(va[t], vb[t], vc[t], dia, an=na[t], bn=nb_[t], cn=nc[t])
        return va.shape[0]

    _add_mesh("bunny.obj", flip=True, scale=2000.0, translate=(195, -20, 280))
    # the reference asks for lowercase teapot3_no_vt.obj which doesn't exist
    # on a case-sensitive FS (quirk SURVEY 9.6) — we load the real file
    _add_mesh("Teapot3_no_vt.obj", scale=250.0, rot_y_deg=30.0, translate=(393, 50, 108))

    b.add_light(l)
    b.use_sky = False
    return b.build()


_GENERATORS = [
    random_spheres, random_spheres_2, two_spheres, perlin_spheres, earth,
    cornell_box, cornell_smoke, book2_final, triangles,
]


def select_scene(scene_id: int, aspect: float):
    """scene.cpp:25-49."""
    return _GENERATORS[scene_id](aspect)
