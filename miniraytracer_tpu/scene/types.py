"""Scene data model: SoA tables, tagged dispatch, pytree-registered.

The reference's scene is a heap of virtual-dispatch objects (scene_object.h,
material.h, texture.h) — pointer chasing that cannot vectorize. The
data-parallel design is one fixed-size array per primitive kind plus integer
type codes:

- spheres   (sphere.h: static + moving + hollow/negative-radius)
- rects     (rect.h: xy/xz/yz one-sided planes, axis encoded as unit vectors
             so intersection is pure vector math — no gathers)
- triangles (triangle.h: edge form m, u=b-a, v=c-a + per-vertex normals)
- volumes   (volumes.h: constant-density media with sphere or rotY+translate
             box boundaries — transforms baked in at build time; covers every
             use in scene.cpp)
- materials (material.h: type code + texture id + scalar param)
- textures  (texture.h: const / sine-checker / perlin turbulence / image)

All float leaves are differentiable; renders are differentiated w.r.t. this
pytree directly (albedo, emission, geometry).

Static (non-traced) metadata lives in meta fields so a scene recompiles only
when table *shapes* or flags change, not values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field

import jax
import jax.numpy as jnp

# material type codes (material.h class hierarchy -> integer tags)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# texture type codes (texture.h)
TEX_CONST = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3

# primitive type codes for hit records / light references
PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRI = 2
PRIM_VOLUME = 3
PRIM_BOX = 4

# volume boundary type codes
VOLB_SPHERE = 0
VOLB_BOX = 1  # rotate_y + translate baked (scene_object.cpp:9-98)


def _meta(**kw):
    return field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Thin-lens, motion-blur camera (camera.h:6-46), precomputed basis."""

    origin: jnp.ndarray  # (3,)
    u: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    w: jnp.ndarray  # (3,)
    llcorner: jnp.ndarray  # (3,)
    horz: jnp.ndarray  # (3,)
    vert: jnp.ndarray  # (3,)
    lens_radius: jnp.ndarray  # ()
    time0: jnp.ndarray  # ()
    time1: jnp.ndarray  # ()


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneData:
    # --- spheres (sphere.h) ---
    sph_c0: jnp.ndarray  # (S,3) center at time0
    sph_c1: jnp.ndarray  # (S,3) center at time1
    sph_t0: jnp.ndarray  # (S,)
    sph_t1: jnp.ndarray  # (S,)
    sph_radius: jnp.ndarray  # (S,) negative = hollow shell (sphere.cpp:50)
    sph_moving: jnp.ndarray  # (S,) f32 0/1
    sph_mat: jnp.ndarray  # (S,) i32
    sph_active: jnp.ndarray  # (S,) bool

    # --- axis-aligned one-sided rects (rect.h) ---
    rect_ei: jnp.ndarray  # (R,3) first free-axis unit vector
    rect_ej: jnp.ndarray  # (R,3) second free-axis unit vector
    rect_ek: jnp.ndarray  # (R,3) fixed-axis unit vector
    rect_i0: jnp.ndarray  # (R,)
    rect_i1: jnp.ndarray  # (R,)
    rect_j0: jnp.ndarray  # (R,)
    rect_j1: jnp.ndarray  # (R,)
    rect_k: jnp.ndarray  # (R,) plane offset along ek
    rect_sign: jnp.ndarray  # (R,) normal = sign * ek (rect.cpp:6-22)
    rect_mat: jnp.ndarray  # (R,) i32
    rect_active: jnp.ndarray  # (R,) bool

    # --- triangles, edge form (triangle.h:13-42) ---
    tri_m: jnp.ndarray  # (T,3) vertex a
    tri_u: jnp.ndarray  # (T,3) b - a
    tri_v: jnp.ndarray  # (T,3) c - a
    tri_mn: jnp.ndarray  # (T,3) normal at a
    tri_un: jnp.ndarray  # (T,3) normal at b
    tri_vn: jnp.ndarray  # (T,3) normal at c
    tri_mat: jnp.ndarray  # (T,) i32
    tri_active: jnp.ndarray  # (T,) bool

    # --- boxes (box.h: 6 outward one-sided rects, as ONE primitive with
    # the rotate_y + translate wrappers baked; hit = nearest front-facing
    # face — a ray starting inside sees nothing, matching the one-sided
    # rect decomposition, rect.cpp:26) ---
    box_lo: jnp.ndarray  # (B,3) local-frame min corner
    box_hi: jnp.ndarray  # (B,3) local-frame max corner
    box_cs: jnp.ndarray  # (B,2) (sin, cos) of the baked rotate_y
    box_off: jnp.ndarray  # (B,3) baked translate
    box_mat: jnp.ndarray  # (B,) i32
    box_active: jnp.ndarray  # (B,) bool

    # --- constant-density volumes (volumes.h) ---
    vol_btype: jnp.ndarray  # (V,) i32 VOLB_*
    vol_bparams: jnp.ndarray  # (V,12) sphere: c(3),r | box: bmin(3),bmax(3),sin,cos,offset(3)
    vol_density: jnp.ndarray  # (V,)
    vol_mat: jnp.ndarray  # (V,) i32 (isotropic phase material)
    vol_active: jnp.ndarray  # (V,) bool

    # --- materials (material.h) ---
    mat_type: jnp.ndarray  # (M,) i32 MAT_*
    mat_tex: jnp.ndarray  # (M,) i32 albedo/emissive texture id
    mat_param: jnp.ndarray  # (M,) gloss (metal) | ref_index (dielectric) | emit scale (light)

    # --- textures (texture.h) ---
    tex_type: jnp.ndarray  # (X,) i32 TEX_*
    tex_c0: jnp.ndarray  # (X,3) const color / checker even
    tex_c1: jnp.ndarray  # (X,3) checker odd
    tex_scale: jnp.ndarray  # (X,) checker/perlin scale
    tex_img: jnp.ndarray  # (X,) i32 image id

    # --- image atlas (stb_image equivalent) ---
    # packed 0x00RRGGBB per texel: textures are 8-bit sources (the reference
    # samples raw stb bytes / 255, texture.cpp:221-224), and one u32 gather
    # replaces three channel gathers
    images: jnp.ndarray  # (I,IH,IW) u32

    # --- Perlin tables (texture.cpp:107-203) ---
    perlin_vec: jnp.ndarray  # (256,3)
    perlin_px: jnp.ndarray  # (256,) i32
    perlin_py: jnp.ndarray  # (256,) i32
    perlin_pz: jnp.ndarray  # (256,) i32

    camera: Camera

    # --- static metadata ---
    use_sky: bool = _meta(default=True)  # sky gradient vs black (main.cpp:110-116)
    # importance-sampled light list ("biased objects", scene.h:19-25):
    # static tuple of (PRIM_*, table index) — composition is per-scene static
    lights: tuple = _meta(default=())
    name: str = _meta(default="scene")
    has_perlin: bool = _meta(default=False)  # prune perlin gathers statically
    has_image: bool = _meta(default=False)  # prune image gathers statically
    has_boxes: bool = _meta(default=False)  # prune box sweeps statically
    # (the box table pads to >=1 row; shapes alone can't distinguish empty)
    # False (default) replicates the reference's non-normalized cosine sample
    # (pcg.cpp:87-98 quirk — needed for image parity); True uses the textbook
    # cosine lobe (consistent MIS estimator)
    exact_cosine: bool = _meta(default=False)
    # True swaps the reference's permutation-table Perlin gradients for
    # table-free hash-derived gradients: statistically equivalent noise
    # without the exact tables' 98 small lookups per shading event, but a
    # DIFFERENT field — parity renders keep the default False
    fast_perlin: bool = _meta(default=False)

    @property
    def n_lights(self):
        return len(self.lights)

    @property
    def n_spheres(self):
        return self.sph_radius.shape[0]

    @property
    def n_rects(self):
        return self.rect_k.shape[0]

    @property
    def n_tris(self):
        return self.tri_m.shape[0]

    @property
    def n_volumes(self):
        return self.vol_density.shape[0]

    @property
    def n_boxes(self):
        return self.box_mat.shape[0]
