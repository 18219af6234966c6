"""Texture sampling: constant / sine-checker / Perlin turbulence / image.

Tagged-dispatch equivalent of texture.h's virtual `sample(u, v, p)`:
all texture kinds are evaluated batched and masked-selected by type code.
Kinds not present in a scene are pruned statically (SceneData meta flags)
so e.g. Cornell never pays for Perlin gathers. Everything is componentwise
SoA (vecmath.V3) — colors and points are triples of (N,) arrays.

Formulas follow the reference exactly:
- checker: sin(s*x)*sin(s*y)*sin(s*z) < 0 -> odd else even (texture.cpp:7-14)
- perlin:  gradient noise with hermite-smoothed trilinear interp over
  permuted gradient table (texture.cpp:68-152), 7-octave turbulence with
  |acc| (texture.cpp:155-165); tables replicate the pre-main G_rng init
  (texture.cpp:167-203, see builder.perlin_tables)
- image:   nearest-neighbor, clamped, v-flipped (texture.cpp:207-225)
"""

from __future__ import annotations

import jax.numpy as jnp

from miniraytracer_tpu.ops.lookup import lookup_cols
from miniraytracer_tpu.ops.vecmath import V3, vwhere
from miniraytracer_tpu.scene import types as T


def _hash_gradient(ix, iy, iz):
    """Table-free lattice gradient: hash (i,j,k) -> uniform unit vector.

    Replaces perm_x[i]^perm_y[j]^perm_z[k] -> ranvec[...] (texture.cpp:
    118-152) with pure arithmetic — no lookups. Statistically the same
    construction (uniform random gradient per lattice point, 256-periodic
    like the reference's & 255 masks) but a different realization."""
    from miniraytracer_tpu.ops import rng as _rng

    h = _rng.pcg_hash(
        (ix & 255).astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
        ^ (iy & 255).astype(jnp.uint32) * jnp.uint32(0xD8163841)
        ^ (iz & 255).astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
    )
    h2 = _rng.pcg_hash(h)
    u1 = (h & jnp.uint32(0xFFFF)).astype(jnp.float32) * (1.0 / 65536.0)
    u2 = (h >> jnp.uint32(16)).astype(jnp.float32) * (1.0 / 65536.0)
    u3 = (h2 & jnp.uint32(0xFFFF)).astype(jnp.float32) * (1.0 / 65536.0)
    from miniraytracer_tpu.ops.rng import sample_in_ball

    # in-BALL like the reference's ranvec (random_in_sphere_g — gradients
    # are deliberately non-unit, texture.cpp:168-170)
    return sample_in_ball(u1, u2, u3)


def _perlin_noise_fast(p: V3) -> jnp.ndarray:
    """perlin_noise with hash gradients (see _hash_gradient)."""
    def prep(c):
        pf = jnp.floor(c)
        frac = c - pf
        h = frac * frac * (3.0 - 2.0 * frac)
        return pf.astype(jnp.int32), frac, h

    ix, fx, hx = prep(p.x)
    iy, fy, hy = prep(p.y)
    iz, fz, hz = prep(p.z)
    acc = jnp.zeros_like(p.x)
    for di in (0, 1):
        ax = hx if di == 1 else 1.0 - hx
        wx = fx - di
        for dj in (0, 1):
            ay = hy if dj == 1 else 1.0 - hy
            wy = fy - dj
            for dk in (0, 1):
                az = hz if dk == 1 else 1.0 - hz
                wz = fz - dk
                g = _hash_gradient(ix + di, iy + dj, iz + dk)
                d = g.x * wx + g.y * wy + g.z * wz
                acc = acc + ax * ay * az * d
    return acc


def perlin_noise(scene: T.SceneData, p: V3) -> jnp.ndarray:
    """Gradient Perlin noise at points p -> (N,). texture.cpp:118-152."""
    if scene.fast_perlin:
        return _perlin_noise_fast(p)
    gx, gy, gz = scene.perlin_vec[:, 0], scene.perlin_vec[:, 1], scene.perlin_vec[:, 2]

    def prep(c):
        pf = jnp.floor(c)
        frac = c - pf
        h = frac * frac * (3.0 - 2.0 * frac)  # hermite (texture.cpp:70-71)
        return pf.astype(jnp.int32), frac, h

    ix, fx, hx = prep(p.x)
    iy, fy, hy = prep(p.y)
    iz, fz, hz = prep(p.z)

    acc = jnp.zeros_like(p.x)
    for di in (0, 1):
        (xi,) = lookup_cols((ix + di) & 255, (scene.perlin_px,))
        ax = hx if di == 1 else 1.0 - hx
        wx = fx - di
        for dj in (0, 1):
            (yi,) = lookup_cols((iy + dj) & 255, (scene.perlin_py,))
            ay = hy if dj == 1 else 1.0 - hy
            wy = fy - dj
            for dk in (0, 1):
                (zi,) = lookup_cols((iz + dk) & 255, (scene.perlin_pz,))
                az = hz if dk == 1 else 1.0 - hz
                wz = fz - dk
                gi = xi ^ yi ^ zi
                gvx, gvy, gvz = lookup_cols(gi, (gx, gy, gz))
                d = gvx * wx + gvy * wy + gvz * wz
                acc = acc + ax * ay * az * d
    return acc


def perlin_turbulence(scene: T.SceneData, p: V3, depth: int = 7) -> jnp.ndarray:
    """7-octave |sum w_i * noise(2^i p)| (texture.cpp:155-165)."""
    acc = jnp.zeros_like(p.x)
    weight = 1.0
    pc = p
    for _ in range(depth):
        acc = acc + weight * perlin_noise(scene, pc)
        weight *= 0.5
        pc = pc * 2.0
    return jnp.abs(acc)


def image_sample(scene: T.SceneData, img_id, h, w, u, v) -> V3:
    """Nearest-neighbor, clamped, v-flipped (texture.cpp:207-225).
    h, w are float arrays (stashed in tex_c1 by the builder). Texels are
    packed 0x00RRGGBB — ONE gather + shifts instead of three gathers."""
    hi = h.astype(jnp.int32)
    wi = w.astype(jnp.int32)
    i = jnp.clip((u * w).astype(jnp.int32), 0, wi - 1)
    j = jnp.clip(((1.0 - v) * h).astype(jnp.int32), 0, hi - 1)
    texel = scene.images[img_id, j, i]
    inv255 = jnp.float32(1.0 / 255.0)
    return V3(
        ((texel >> 16) & 0xFF).astype(jnp.float32) * inv255,
        ((texel >> 8) & 0xFF).astype(jnp.float32) * inv255,
        (texel & 0xFF).astype(jnp.float32) * inv255,
    )


def sample_texture(scene: T.SceneData, tex_id: jnp.ndarray, u, v,
                   p: V3) -> V3:
    """Batched texture::sample for per-ray texture ids (N,) -> V3 color."""
    (ttype, c0x, c0y, c0z, c1x, c1y, c1z, scale, img_id) = lookup_cols(
        tex_id,
        (
            scene.tex_type,
            scene.tex_c0[:, 0], scene.tex_c0[:, 1], scene.tex_c0[:, 2],
            scene.tex_c1[:, 0], scene.tex_c1[:, 1], scene.tex_c1[:, 2],
            scene.tex_scale, scene.tex_img,
        ),
    )
    c0 = V3(c0x, c0y, c0z)
    c1 = V3(c1x, c1y, c1z)

    out = c0  # TEX_CONST

    # checker (sine product in world space)
    sines = jnp.sin(scale * p.x) * jnp.sin(scale * p.y) * jnp.sin(scale * p.z)
    out = vwhere((ttype == T.TEX_CHECKER) & (sines < 0), c1, out)

    if scene.has_perlin:
        turb = perlin_turbulence(scene, p * scale)
        out = vwhere(ttype == T.TEX_PERLIN, V3(turb, turb, turb), out)

    if scene.has_image:
        # builder stashes (h, w) in tex_c1 for image textures
        img = image_sample(scene, img_id, c1.x, c1.y, u, v)
        out = vwhere(ttype == T.TEX_IMAGE, img, out)

    return out
