"""Material shading: tagged-dispatch scatter/emission over material rows.

Replaces material.h's virtual dispatch with masked evaluation of all five
material behaviors and a select by type code — on lanes that run in
lockstep this is cheaper than any divergence scheme for 5 branches. All math is componentwise SoA
(vecmath.V3): colors and directions are triples of (N,) arrays.

Semantics (behavioral parity checklist, SURVEY.md section 8):
- lambertian: cosine-lobe sample via ONB, scattering_pdf = max(cos,0)/pi
  (material.h:34-56)
- isotropic:  uniform-sphere sample, scattering_pdf = 1/(2pi)
  (material.h:58-77; the reference's 2pi — not 4pi — is kept, quirk 9.9)
- metal:      reflect + (1-gloss) * random-in-ball fuzz; attenuation = albedo;
  specular (material.h:81-99); the new ray resets isInside (ray ctor default)
- dielectric: Schlick Fresnel with cosT for entering rays, nested-volume
  isInside counting, TIR always reflects (material.h:103-176)
- diffuse_light: no scatter; one-sided emission when dot(n, dir)<0 scaled by
  `scale` (material.h:180-201)

RNG slot map (per-bounce draw indices, stable across shardings):
  0..3  volume free-path (one per volume)
  8     mixture choice light-vs-material (pdf.h:71-79)
  9     light pick, 10-11 light surface sample
  12-13 material pdf sample (cosine phi/r2 or sphere x/phi)
  14-16 metal fuzz ball
  17    dielectric reflect probability
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from miniraytracer_tpu.ops import rng
from miniraytracer_tpu.ops.lookup import lookup_cols
from miniraytracer_tpu.ops.vecmath import (
    V3, vdot, vnormalize, vreflect, vrefract, vwhere, vonb_from_w, vonb_l2w,
)
from miniraytracer_tpu.ops.intersect import HitRecord, Rays
from miniraytracer_tpu.models import pdfs
from miniraytracer_tpu.models.textures import sample_texture
from miniraytracer_tpu.scene import types as T

PI = rng.PI

# RNG slots
SLOT_VOL = 0
SLOT_MIX = 8
SLOT_LPICK = 9
SLOT_LA, SLOT_LB = 10, 11
SLOT_MA, SLOT_MB = 12, 13
SLOT_FUZZ = 14
SLOT_FRESNEL = 17


class Scatter(NamedTuple):
    new_rd: V3  # normalized next direction
    new_inside: jnp.ndarray  # (N,) i32
    weight: V3  # throughput multiplier for this bounce
    emitted: V3  # emission to add (diffuse/no-scatter only)
    scattered: jnp.ndarray  # (N,) bool — path continues
    add_emitted: jnp.ndarray  # (N,) bool — specular branch drops emission


def fresnel_schlick(cosine, ref_index):
    """material.h:106-110."""
    r0 = (1.0 - ref_index) / (1.0 + ref_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def shade(scene: T.SceneData, rays: Rays, rec: HitRecord, keys,
          depth_ok) -> Scatter:
    """One shading event for all rays (assumes rec.hit; caller masks).

    `keys` are per-bounce ray keys; `depth_ok` is the static/per-ray
    depth < maxBounces gate (main.cpp:79).
    """
    mtype, mparam, tex_id = lookup_cols(
        rec.mat, (scene.mat_type, scene.mat_param, scene.mat_tex)
    )
    albedo = sample_texture(scene, tex_id, rec.u, rec.v, rec.p)

    n = rec.n
    rd = rays.rd

    # ---- emission (diffuse_light, one-sided) ----
    is_light = mtype == T.MAT_DIFFUSE_LIGHT
    emitted = vwhere(
        is_light & (vdot(n, rd) < 0.0),
        albedo * mparam,
        V3.zeros(rec.t.shape),
    )

    # ---- diffuse branch (lambertian / isotropic) ----
    is_iso = mtype == T.MAT_ISOTROPIC
    u_ma = rng.uniform(keys, SLOT_MA)
    u_mb = rng.uniform(keys, SLOT_MB)
    uo, vo, wo = vonb_from_w(n)
    cos_sampler = (
        rng.sample_cosine_direction_exact if scene.exact_cosine else rng.sample_cosine_direction
    )
    cos_dir = vonb_l2w(uo, vo, wo, cos_sampler(u_ma, u_mb))
    iso_dir = rng.sample_on_sphere(u_ma, u_mb)
    mat_gen = vwhere(is_iso, iso_dir, cos_dir)

    if scene.n_lights > 0:
        # 50/50 mixture with the light-object pdf (main.cpp:87-92, pdf.h:64-80)
        u_mix = rng.uniform(keys, SLOT_MIX)
        light_gen = pdfs.light_pdf_generate(
            scene,
            rec.p,
            rays.time,
            rng.uniform(keys, SLOT_LPICK),
            rng.uniform(keys, SLOT_LA),
            rng.uniform(keys, SLOT_LB),
        )
        gen = vwhere(u_mix < 0.5, light_gen, mat_gen)
        d = vnormalize(gen)
        mat_pdf_v = jnp.where(is_iso, pdfs.isotropic_pdf_value(d), pdfs.cosine_pdf_value(n, d))
        pdf_v = 0.5 * pdfs.light_pdf_value(scene, rec.p, d, rays.time) + 0.5 * mat_pdf_v
    else:
        d = vnormalize(mat_gen)
        pdf_v = jnp.where(is_iso, pdfs.isotropic_pdf_value(d), pdfs.cosine_pdf_value(n, d))

    scatter_pdf = jnp.where(
        is_iso, 1.0 / (2.0 * PI), jnp.maximum(vdot(n, d), 0.0) / PI
    )
    # eps threshold, not >0: a denormal-tiny pdf makes 1/pdf^2 in the
    # backward overflow to inf (and the sample a firefly anyway). pdf below
    # eps => zero contribution (matches 0/0 -> NaN -> NaN-guard killing the
    # sample in the reference, but without poisoning the whole pixel).
    pdf_ok = pdf_v > 1e-12
    safe_pdf = jnp.where(pdf_ok, pdf_v, 1.0)
    diffuse_w = albedo * jnp.where(pdf_ok, scatter_pdf / safe_pdf, 0.0)

    # ---- metal ----
    is_metal = mtype == T.MAT_METAL
    refl = vreflect(rd, n)
    fuzz = rng.sample_in_ball(
        rng.uniform(keys, SLOT_FUZZ),
        rng.uniform(keys, SLOT_FUZZ + 1),
        rng.uniform(keys, SLOT_FUZZ + 2),
    )
    metal_dir = vnormalize(refl + fuzz * (1.0 - mparam))

    # ---- dielectric (material.h:121-176) ----
    is_diel = mtype == T.MAT_DIELECTRIC
    # masked-branch sanitization: non-dielectric rows carry mat_param == 0
    # (gloss/scale), and 1/0 in the dead branch would poison gradients of
    # every gathered material row via where's 0-cotangent * inf
    ref_idx = jnp.where(is_diel, mparam, 1.5)
    cosI = -vdot(rd, n)
    entering = cosI >= 0  # reference: cosI < 0 means backface (exiting)
    facing_n = vwhere(entering, n, -n)
    ni_over_nt = jnp.where(entering, 1.0 / ref_idx, ref_idx)
    refracted, can_refract = vrefract(rd, facing_n, ni_over_nt)
    cs_arg = jnp.clip(1.0 - ni_over_nt * ni_over_nt * (1.0 - cosI * cosI), 0.0, 1.0)
    cs_ok = cs_arg > 1e-12  # eps margin: sqrt backward overflows below it
    cos_schlick = jnp.where(
        entering,
        cosI,
        jnp.where(cs_ok, jnp.sqrt(jnp.where(cs_ok, cs_arg, 1.0)), 0.0),
    )
    reflect_prob = jnp.where(can_refract, fresnel_schlick(cos_schlick, ref_idx), 1.0)
    u_fr = rng.uniform(keys, SLOT_FRESNEL)
    do_reflect = u_fr < reflect_prob
    diel_dir = vwhere(do_reflect, vnormalize(refl), vnormalize(refracted))
    # nested volume counter (material.h:158-173); reflect keeps it
    inside_after_refract = jnp.where(
        entering, rays.inside + 1, jnp.maximum(rays.inside - 1, 0)
    )
    diel_inside = jnp.where(do_reflect, rays.inside, inside_after_refract)

    # ---- combine by type ----
    is_specular = is_metal | is_diel
    new_rd = vwhere(is_metal, metal_dir, vwhere(is_diel, diel_dir, d))
    # reference resets isInside on metal & diffuse rays (ray ctor default)
    new_inside = jnp.where(is_diel, diel_inside, 0)
    ones = V3.fill(rec.t.shape, 1.0, 1.0, 1.0)
    weight = vwhere(is_diel, ones, vwhere(is_specular, albedo, diffuse_w))
    scattered = depth_ok & ~is_light  # lights never scatter (material.h:195)
    # specular branch drops emission (main.cpp:81-83); non-scatter keeps it
    add_emitted = ~(scattered & is_specular)

    return Scatter(
        new_rd=new_rd,
        new_inside=new_inside,
        weight=weight,
        emitted=emitted,
        scattered=scattered,
        add_emitted=add_emitted,
    )
