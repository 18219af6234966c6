"""Fused wavefront render: the whole trace() body as ONE Pallas kernel,
compiled for the GPU through Triton.

The XLA wavefront (integrator.render_wavefront_pixels) runs each bounce as
a `while_loop` iteration of many fusions, so every lane's path state makes
a device-memory round trip per bounce and the loop predicate returns to
the host once per iteration. This kernel is the classic GPU megakernel
instead: the reference's `trace()` body (main.cpp:66-118) plus the draw2
merge and lane regeneration (main.cpp:214-231) run inside one program per
block of lanes, and each program loops its own lanes until they have
exhausted their samples. Path state lives in registers for the whole
render; the only device-memory traffic is the pixel ids in and the
accumulated colours out.

Layout: 1-D lane blocks of `lanes` (a power of two) lanes, one Triton
program per block, a grid of ceil(N / lanes) programs. The scene tables
are one flat f32 vector read with scalar loads at static offsets
(python-unrolled primitive loops); the Perlin permutation and gradient
tables are one flat f32 vector read with per-lane gathers.

Applicability (can_fuse): the GPU backend, and scenes whose tables suit
the unrolled loops — every primitive count <= 64, const/checker/Perlin
textures (no image textures), at most 4 lights. Everything else keeps the
XLA path. Estimator semantics are IDENTICAL to render_wavefront_pixels
(same counter-keyed RNG slots, same masked-branch formulas, same
merge/NaN/clamp policy); floats may differ by reassociation only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from miniraytracer_tpu.ops.vecmath import V3
from miniraytracer_tpu.scene import types as T

# lanes per program, one lane per thread (lanes // 32 warps). Small blocks
# retire as soon as their own lanes finish; on an H100, cornell 500x500 x
# 64 spp took 7.7 ms at 32 lanes, 8.7 ms at 64 and 8.9 ms at 128.
LANES = 32
INF = 3.0e38
TMIN = 0.001
TRI_EPS = 1e-5
PI = 3.14159265358979323846

# RNG slots (materials.py) / camera fold tag (camera.py)
SLOT_VOL, SLOT_MIX, SLOT_LPICK, SLOT_LA, SLOT_LB = 0, 8, 9, 10, 11
SLOT_MA, SLOT_MB, SLOT_FUZZ, SLOT_FRESNEL = 12, 13, 14, 17
CAM_FOLD = 0x0C0FFEE

MAX_PRIMS = 64  # per type; static unrolled scalar loops
MAX_MATS = 24
MAX_TEXS = 24
MAX_VOLS = 4

_M1, _M2, _M3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def fits(scene: T.SceneData) -> bool:
    """Whether the scene's tables suit the kernel (a property of the scene
    alone; `can_fuse` adds the backend)."""
    return (
        scene.n_spheres <= MAX_PRIMS
        and scene.n_rects <= MAX_PRIMS
        and scene.n_tris <= MAX_PRIMS
        and (scene.n_boxes if scene.has_boxes else 0) <= MAX_PRIMS
        and scene.n_volumes <= MAX_VOLS
        and scene.mat_type.shape[0] <= MAX_MATS
        and scene.tex_type.shape[0] <= MAX_TEXS
        and not scene.has_image
        and not scene.fast_perlin  # parity tables only (the opt-in hash
        # -gradient mode stays on the XLA path)
        and len(scene.lights) <= 4
    )


def can_fuse(scene: T.SceneData) -> bool:
    """Fused-kernel eligibility: the GPU backend and a scene that fits."""
    return jax.default_backend() == "gpu" and fits(scene)


def pack_scene(scene: T.SceneData):
    """Scene tables -> (meta, tab, ptab).

    `meta` is a static dict: primitive counts, the flat offset of each
    sub-table in `tab`, and the scene's static flags. `tab` is one flat f32
    vector (integer codes ride as small exact floats); the kernel reads it
    with scalar loads at static offsets. `ptab` is the (6 * 256,) f32 Perlin
    table px | py | pz | gx | gy | gz (zeros when the scene has none)."""
    S, R, Tc, V = scene.n_spheres, scene.n_rects, scene.n_tris, scene.n_volumes
    Bx = scene.n_boxes if scene.has_boxes else 0
    f32 = lambda a: jnp.asarray(a, jnp.float32).reshape(-1)
    parts = {}
    if S:
        parts["sph"] = [scene.sph_c0, scene.sph_c1, scene.sph_t0,
                        scene.sph_t1, scene.sph_moving, scene.sph_radius,
                        scene.sph_mat, scene.sph_active]
    if R:
        parts["rect"] = [scene.rect_ei, scene.rect_ej, scene.rect_ek,
                         scene.rect_k, scene.rect_i0, scene.rect_i1,
                         scene.rect_j0, scene.rect_j1, scene.rect_sign,
                         scene.rect_mat, scene.rect_active]
    if Tc:
        parts["tri"] = [scene.tri_m, scene.tri_u, scene.tri_v, scene.tri_mn,
                        scene.tri_un, scene.tri_vn, scene.tri_mat,
                        scene.tri_active]
    if Bx:
        parts["box"] = [scene.box_lo, scene.box_hi, scene.box_cs,
                        scene.box_off, scene.box_mat, scene.box_active]
    if V:
        parts["vol"] = [scene.vol_bparams, scene.vol_btype,
                        scene.vol_density, scene.vol_mat, scene.vol_active]
    parts["mat"] = [scene.mat_type, scene.mat_param, scene.mat_tex]
    parts["tex"] = [scene.tex_type, scene.tex_c0, scene.tex_c1,
                    scene.tex_scale]
    cam = scene.camera
    parts["cam"] = [cam.origin, cam.llcorner, cam.horz, cam.vert, cam.u,
                    cam.v, jnp.stack([jnp.asarray(cam.lens_radius, jnp.float32),
                                      jnp.asarray(cam.time0, jnp.float32),
                                      jnp.asarray(cam.time1, jnp.float32)])]
    offsets = {}
    flat = []
    at = 0
    for name, cols in parts.items():
        offsets[name] = at
        for c in cols:
            v = f32(c)
            flat.append(v)
            at += v.shape[0]
    tab = jnp.concatenate(flat)
    if scene.has_perlin:
        ptab = jnp.concatenate([
            f32(scene.perlin_px), f32(scene.perlin_py), f32(scene.perlin_pz),
            f32(scene.perlin_vec[:, 0]), f32(scene.perlin_vec[:, 1]),
            f32(scene.perlin_vec[:, 2])])
    else:
        ptab = jnp.zeros((6 * 256,), jnp.float32)
    meta = dict(
        S=S, R=R, Tc=Tc, Bx=Bx, V=V,
        M=int(scene.mat_type.shape[0]), X=int(scene.tex_type.shape[0]),
        lights=tuple(tuple(int(x) for x in l) for l in scene.lights),
        use_sky=bool(scene.use_sky),
        exact_cosine=bool(scene.exact_cosine),
        perlin=bool(scene.has_perlin),
        offsets=tuple(sorted(offsets.items())),
    )
    return meta, tab, ptab


class _Sub:
    """Static-offset view of the flat table: view[k] -> tab[base + k]."""

    __slots__ = ("ref", "base")

    def __init__(self, ref, base):
        self.ref, self.base = ref, base

    def __getitem__(self, k):
        return self.ref[self.base + k]


# ---------------------------------------------------------------------------
# In-kernel helpers: everything operates on (lanes,) blocks
# ---------------------------------------------------------------------------


def _u32(x):
    return jnp.uint32(x)


def _hash(x):
    x = x * _u32(747796405) + _u32(2891336453)
    word = ((x >> ((x >> _u32(28)) + _u32(4))) ^ x) * _u32(277803737)
    return (word >> _u32(22)) ^ word


def _fold(key, data):
    return _hash(key * _u32(_M1) + data.astype(jnp.uint32) * _u32(_M2) + _u32(_M3))


def _bits(key, slot: int):
    return _hash(key + _u32(slot) * _u32(_M3))


def _uniform(key, slot: int):
    b = _bits(key, slot)
    f = (b & _u32(0x007FFFFF)) | _u32(0x3F800000)
    return jax.lax.bitcast_convert_type(f, jnp.float32) - 1.0


def _ray_key(pix, samp):
    return _hash(_hash(pix * _u32(_M1) + _u32(0x1234567)) + samp * _u32(_M2))


def _isfinite(x):
    # |x| < inf is False for +-inf and NaN (no is_finite lowering in Triton)
    return jnp.abs(x) < jnp.inf


def _dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def _normalize(a: V3) -> V3:
    n2 = _dot(a, a)
    ok = n2 > 1e-20
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)
    return a * inv


def _cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def _vwhere(m, a: V3, b: V3) -> V3:
    return V3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y),
              jnp.where(m, a.z, b.z))


def _onb_from_w(n: V3):
    big_x = jnp.abs(n.x) > 0.9
    a = V3(jnp.where(big_x, 0.0, 1.0), jnp.where(big_x, 1.0, 0.0),
           jnp.zeros_like(n.x))
    v = _normalize(_cross(n, a))
    u = _cross(n, v)
    return u, v, n


def _sample_on_sphere(r1, r2) -> V3:
    x = r1 * 2.0 - 1.0
    phi = r2 * 2.0 * PI
    s = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
    return V3(x, jnp.cos(phi) * s, jnp.sin(phi) * s)


def _sample_cosine(r1, r2, exact: bool) -> V3:
    z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = (1.0 if exact else 2.0) * jnp.sqrt(r2)
    return V3(jnp.cos(phi) * sq, jnp.sin(phi) * sq, z)


def _sample_in_ball(r1, r2, r3) -> V3:
    d = _sample_on_sphere(r1, r2)
    # cbrt via exp/log (r3 in [0,1)); guard log(0)
    r3s = jnp.maximum(r3, 1e-30)
    return d * jnp.exp(jnp.log(r3s) * (1.0 / 3.0))


def _schlick(cosine, ref_index):
    r0 = (1.0 - ref_index) / (1.0 + ref_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


PERLIN_DEPTH = 7  # turbulence octaves (texture.cpp:158)


def _plut(ptab_ref, k: int, idx):
    """Entry idx (int32 lanes in [0, 256)) of Perlin table k: one gather
    load per lane from the flat table. Values pass through bit-exactly."""
    return ptab_ref[idx + 256 * k]


def _turbulence(ptab_ref, p: V3):
    """7-octave Perlin turbulence, fully in-kernel.

    Same tables, same formula, same accumulation order as the XLA path
    (models/textures.perlin_turbulence): hermite-smoothed trilinear interp
    of permuted gradients (texture.cpp:68-165). 30 table gathers per octave
    (6 permutation + 24 gradient components). The octaves run as a loop,
    not unrolled: unrolled, they multiply the kernel's compile time."""

    def octave(_, carry):
        acc_t, weight, cx, cy, cz = carry

        def prep(c):
            pf = jnp.floor(c)
            fr = c - pf
            h = fr * fr * (3.0 - 2.0 * fr)  # hermite (texture.cpp:70-71)
            return pf.astype(jnp.int32), fr, h

        ix, fx, hx = prep(cx)
        iy, fy, hy = prep(cy)
        iz, fz, hz = prep(cz)

        # permutation values per axis for the +0/+1 lattice corners
        pv = []  # x0 x1 y0 y1 z0 z1, each int32 lanes
        for a, ic in enumerate((ix, iy, iz)):
            for d in (0, 1):
                pv.append(_plut(ptab_ref, a, (ic + d) & 255).astype(jnp.int32))

        acc = jnp.zeros_like(cx)
        for di in (0, 1):
            ax = hx if di else 1.0 - hx
            wx = fx - di
            for dj in (0, 1):
                ay = hy if dj else 1.0 - hy
                wy = fy - dj
                for dk in (0, 1):
                    az = hz if dk else 1.0 - hz
                    wz = fz - dk
                    gi = pv[di] ^ pv[2 + dj] ^ pv[4 + dk]
                    gx = _plut(ptab_ref, 3, gi)
                    gy = _plut(ptab_ref, 4, gi)
                    gz = _plut(ptab_ref, 5, gi)
                    d = gx * wx + gy * wy + gz * wz
                    acc = acc + ax * ay * az * d
        return (acc_t + weight * acc, weight * 0.5, cx * 2.0, cy * 2.0,
                cz * 2.0)

    acc_t, *_ = jax.lax.fori_loop(
        0, PERLIN_DEPTH, octave,
        (jnp.zeros_like(p.x), jnp.float32(1.0), p.x, p.y, p.z))
    return jnp.abs(acc_t)


# ---------------------------------------------------------------------------
# Bounce physics (scene_hit + shade on lane blocks)
# ---------------------------------------------------------------------------


def _sphere_center(sph, S, si, time):
    c0 = V3(sph[3 * si], sph[3 * si + 1], sph[3 * si + 2])
    o1 = 3 * S
    c1 = V3(sph[o1 + 3 * si], sph[o1 + 3 * si + 1], sph[o1 + 3 * si + 2])
    o = 6 * S
    t0s, t1s = sph[o + si], sph[o + S + si]
    mov = sph[o + 2 * S + si]
    denom = jnp.where(mov > 0, t1s - t0s, 1.0)
    fmv = jnp.where(mov > 0, (time - t0s) / denom, 0.0)
    return V3(c0.x + fmv * (c1.x - c0.x), c0.y + fmv * (c1.y - c0.y),
              c0.z + fmv * (c1.z - c0.z))


def _rect_frame(rect, R, ri):
    ei = V3(rect[3 * ri], rect[3 * ri + 1], rect[3 * ri + 2])
    o = 3 * R
    ej = V3(rect[o + 3 * ri], rect[o + 3 * ri + 1], rect[o + 3 * ri + 2])
    o = 6 * R
    ek = V3(rect[o + 3 * ri], rect[o + 3 * ri + 1], rect[o + 3 * ri + 2])
    o = 9 * R
    kk = rect[o + ri]
    i0, i1 = rect[o + R + ri], rect[o + 2 * R + ri]
    j0, j1 = rect[o + 3 * R + ri], rect[o + 4 * R + ri]
    sgn = rect[o + 5 * R + ri]
    return ei, ej, ek, kk, i0, i1, j0, j1, sgn


def bounce_physics(meta, tabs, ptab, ro, rd, time, inside, keys_b):
    """One bounce of the reference trace() body (main.cpp:66-118): inline
    scene_hit (running-winner record over all primitive types) + shade
    (material dispatch, MIS light sampling) on lane blocks.

    `tabs` = dict of static-offset table views (pack_scene layout); `ptab`
    the flat Perlin table ref. Returns (hit, p, emitted, is_light,
    is_specular, weight, new_rd, new_inside)."""
    S, R, Tc, V = meta["S"], meta["R"], meta["Tc"], meta["V"]
    Bx = meta["Bx"]
    M, X = meta["M"], meta["X"]
    lights = meta["lights"]
    exact_cos = meta["exact_cosine"]
    nL = max(len(lights), 1)
    sph, rect, tri = tabs.get("sph"), tabs.get("rect"), tabs.get("tri")
    box, vol, mat, tex = (tabs.get("box"), tabs.get("vol"), tabs["mat"],
                          tabs["tex"])

    # ---------------- scene_hit (inline, running-winner record) --------
    best_t = jnp.full_like(time, INF)
    w_n = V3(jnp.ones_like(time), jnp.zeros_like(time), jnp.zeros_like(time))
    w_mat = jnp.zeros_like(inside)

    # --- spheres (sphere.cpp:13-46) --- tie rule: sphere first, so '<'
    for si in range(S):
        o = 6 * S
        rad = sph[o + 3 * S + si]
        matid, act = sph[o + 4 * S + si], sph[o + 5 * S + si]
        cen = _sphere_center(sph, S, si, time)
        oc = ro - cen
        b = _dot(oc, rd)
        c = _dot(oc, oc) - rad * rad
        disc = b * b - c
        sqd = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
        t_front = -b - sqd
        t_back = -b + sqd
        ok = (disc > 0) & (act > 0)
        front_ok = ok & (t_front > TMIN) & (t_front < best_t)
        back_ok = ok & (inside > 0) & (t_back > TMIN) & (t_back < best_t)
        tc = jnp.where(front_ok, t_front, jnp.where(back_ok, t_back, INF))
        better = front_ok | back_ok
        tc_safe = jnp.where(better, tc, 1.0)
        p_hit = ro + rd * tc_safe
        safe_rad = jnp.where(jnp.abs(rad) > 1e-20, rad, 1.0)
        # *(1/rad) with the reciprocal hoisted to a SCALAR divide;
        # sphere_record uses the SAME expression so kernel and XLA
        # wavefront agree to the last ulp where they can — a last-ulp
        # normal difference seeds chaotic path divergence
        n_c = _normalize((p_hit - cen) * (1.0 / safe_rad))
        best_t = jnp.where(better, tc, best_t)
        w_n = _vwhere(better, n_c, w_n)
        w_mat = jnp.where(better, matid.astype(jnp.int32), w_mat)

    # --- rects (rect.cpp, one-sided) ---
    for ri in range(R):
        ei, ej, ek, kk, i0, i1, j0, j1, sgn = _rect_frame(rect, R, ri)
        matid = rect[15 * R + ri]
        act = rect[16 * R + ri]
        dk = _dot(ek, rd)
        facing = dk * sgn <= 0.0
        dk_safe = jnp.where(jnp.abs(dk) > 1e-30, dk, 1e-30)
        t = (kk - _dot(ek, ro)) / dk_safe
        iiv = _dot(ei, ro) + t * _dot(ei, rd)
        jjv = _dot(ej, ro) + t * _dot(ej, rd)
        valid = (
            facing & (t >= TMIN) & (t < best_t) & (act > 0)
            & (iiv >= i0) & (iiv <= i1) & (jjv >= j0) & (jjv <= j1)
        )
        best_t = jnp.where(valid, t, best_t)
        w_n = _vwhere(valid, ek * sgn, w_n)
        w_mat = jnp.where(valid, matid.astype(jnp.int32), w_mat)

    # --- triangles (triangle.cpp:221-264) ---
    for ti in range(Tc):
        def row(o):
            return V3(tri[o * Tc + 3 * ti], tri[o * Tc + 3 * ti + 1],
                      tri[o * Tc + 3 * ti + 2])

        mT, uT, vT, mn, un, vn = (row(0), row(3), row(6), row(9), row(12),
                                  row(15))
        matid = tri[18 * Tc + ti]
        act = tri[19 * Tc + ti]
        pv = _cross(rd, vT)
        det = _dot(uT, pv)
        sgn = jnp.where((inside > 0) & (det < 0.0), -1.0, 1.0)
        dets = det * sgn
        tv = ro - mT
        uu = _dot(tv, pv) * sgn
        qv = _cross(tv, uT)
        vv = _dot(rd, qv) * sgn
        safe_det = jnp.where(dets > TRI_EPS, dets, 1.0)
        t = _dot(vT, qv) / safe_det * sgn
        valid = (
            (dets >= TRI_EPS) & (uu >= 0) & (uu <= dets)
            & (vv >= 0) & (uu + vv <= dets)
            & (t >= TMIN) & (t < best_t) & (act > 0)
        )
        inv = 1.0 / safe_det
        uun = uu * inv
        vvn = vv * inv
        n_c = _normalize(mn * (1.0 - uun - vvn) + un * uun + vn * vvn)
        best_t = jnp.where(valid, t, best_t)
        w_n = _vwhere(valid, n_c, w_n)
        w_mat = jnp.where(valid, matid.astype(jnp.int32), w_mat)

    # --- boxes (box.h: 6 outward one-sided rects as ONE prim; the
    # rotate_y/translate wrappers baked as sin/cos/offset — hit =
    # nearest front-facing face, rays inside see nothing) ---
    for bi in range(Bx):
        blo = (box[3 * bi], box[3 * bi + 1], box[3 * bi + 2])
        o = 3 * Bx
        bhi = (box[o + 3 * bi], box[o + 3 * bi + 1], box[o + 3 * bi + 2])
        o = 6 * Bx
        sinb, cosb = box[o + 2 * bi], box[o + 2 * bi + 1]
        o = 8 * Bx
        offb = V3(box[o + 3 * bi], box[o + 3 * bi + 1], box[o + 3 * bi + 2])
        matid = box[11 * Bx + bi]
        act = box[12 * Bx + bi]
        rol = ro - offb
        bl = (cosb * rol.x - sinb * rol.z, rol.y, cosb * rol.z + sinb * rol.x)
        bd = (cosb * rd.x - sinb * rd.z, rd.y, cosb * rd.z + sinb * rd.x)
        tb = jnp.full_like(time, INF)
        nax = jnp.zeros_like(time)   # winner axis id
        nsg = jnp.zeros_like(time)   # winner face sign
        for a, bb_, cc_ in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
            da = bd[a]
            invd = 1.0 / jnp.where(
                jnp.abs(da) > 1e-12, da,
                jnp.where(da >= 0, 1e-12, -1e-12))
            for bound, face_ok, sg in ((blo[a], da > 0, -1.0),
                                       (bhi[a], da < 0, 1.0)):
                tf = (bound - bl[a]) * invd
                pb = bl[bb_] + tf * bd[bb_]
                pc = bl[cc_] + tf * bd[cc_]
                okf = (face_ok & (tf >= TMIN) & (tf < tb)
                       & (pb >= blo[bb_]) & (pb <= bhi[bb_])
                       & (pc >= blo[cc_]) & (pc <= bhi[cc_]))
                tb = jnp.where(okf, tf, tb)
                nax = jnp.where(okf, float(a), nax)
                nsg = jnp.where(okf, sg, nsg)
        valid = (tb < best_t) & (act > 0)
        nlx = jnp.where(nax == 0.0, nsg, 0.0)
        nly = jnp.where(nax == 1.0, nsg, 0.0)
        nlz = jnp.where(nax == 2.0, nsg, 0.0)
        n_c = V3(cosb * nlx + sinb * nlz, nly, cosb * nlz - sinb * nlx)
        best_t = jnp.where(valid, tb, best_t)
        w_n = _vwhere(valid, n_c, w_n)
        w_mat = jnp.where(valid, matid.astype(jnp.int32), w_mat)

    # --- volumes (volumes.cpp:5-36, one-sided quirks preserved) ---
    for vi in range(V):
        bp = [vol[12 * vi + k] for k in range(12)]
        btype = vol[12 * V + vi]
        dens = vol[13 * V + vi]
        vmat = vol[14 * V + vi]
        vact = vol[15 * V + vi]
        # sphere boundary
        cen = V3(bp[0], bp[1], bp[2])
        radv = bp[3]
        oc = ro - cen
        b = _dot(oc, rd)
        c = _dot(oc, oc) - radv * radv
        disc = b * b - c
        sqd = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
        s_ok = disc > 0
        sph_t1 = jnp.where(s_ok, -b - sqd, INF)
        sph_t2 = jnp.where(s_ok & (inside > 0), -b + sqd, INF)
        # box boundary: 6 one-sided faces in local frame
        bmin = (bp[0], bp[1], bp[2])
        bmax = (bp[3], bp[4], bp[5])
        sin_t, cos_t = bp[6], bp[7]
        rol = ro - V3(bp[8], bp[9], bp[10])
        lo = V3(cos_t * rol.x - sin_t * rol.z, rol.y,
                cos_t * rol.z + sin_t * rol.x)
        ld = V3(cos_t * rd.x - sin_t * rd.z, rd.y,
                cos_t * rd.z + sin_t * rd.x)
        axes = [
            (lo.x, ld.x, lo.y, ld.y, lo.z, ld.z,
             bmin[0], bmax[0], bmin[1], bmax[1], bmin[2], bmax[2]),
            (lo.y, ld.y, lo.x, ld.x, lo.z, ld.z,
             bmin[1], bmax[1], bmin[0], bmax[0], bmin[2], bmax[2]),
            (lo.z, ld.z, lo.x, ld.x, lo.y, ld.y,
             bmin[2], bmax[2], bmin[0], bmax[0], bmin[1], bmax[1]),
        ]
        box_cands = []
        for (la, da, lb, db, lc, dc, a0, a1, b0, b1, c0b, c1b) in axes:
            invd = 1.0 / jnp.where(
                jnp.abs(da) > 1e-12, da, jnp.where(da >= 0, 1e-12, -1e-12)
            )
            for bound, face_ok in ((a0, da > 0), (a1, da < 0)):
                tf = (bound - la) * invd
                bb = lb + tf * db
                cc = lc + tf * dc
                okf = face_ok & (bb >= b0) & (bb <= b1) & (cc >= c0b) & (cc <= c1b)
                box_cands.append(jnp.where(okf, tf, INF))
        is_sph_b = btype == float(T.VOLB_SPHERE)
        all_cands = [
            jnp.where(is_sph_b, sph_t1, box_cands[0]),
            jnp.where(is_sph_b, sph_t2, box_cands[1]),
        ] + [jnp.where(is_sph_b, INF, bc) for bc in box_cands[2:]]
        rec1 = all_cands[0]
        for ccd in all_cands[1:]:
            rec1 = jnp.minimum(rec1, ccd)
        got1 = rec1 < INF
        rec2 = jnp.full_like(rec1, INF)
        for ccd in all_cands:
            rec2 = jnp.minimum(rec2, jnp.where(ccd > rec1 + 1e-4, ccd, INF))
        got2 = rec2 < INF
        okv = got1 & got2
        rec1c = jnp.maximum(jnp.where(got1, rec1, -3.0e38), TMIN)
        rec2c = jnp.minimum(jnp.where(got2, rec2, -3.0e38), best_t)
        valid = okv & (rec1c < rec2c) & (vact > 0)
        inside_dist = rec2c - rec1c
        uv = jnp.clip(_uniform(keys_b, SLOT_VOL + vi), 1e-38, 1.0)
        hit_dist = -(1.0 / dens) * jnp.log(uv)
        scatter = valid & (hit_dist < inside_dist)
        tvol = rec1c + hit_dist
        better = scatter & (tvol < best_t)
        best_t = jnp.where(better, tvol, best_t)
        w_n = _vwhere(better, V3(jnp.ones_like(tvol), jnp.zeros_like(tvol),
                                 jnp.zeros_like(tvol)), w_n)
        w_mat = jnp.where(better, vmat.astype(jnp.int32), w_mat)

    hit = best_t < INF
    safe_t = jnp.where(hit, best_t, 1.0)
    p = ro + rd * safe_t
    zero = jnp.zeros_like(safe_t)
    # miss-lane record sanitation (scene_hit does the same)
    w_n = _vwhere(hit, w_n, V3(jnp.ones_like(safe_t), zero, zero))

    # ---------------- shade (materials.shade, exact slots) -------------
    # material row lookup (static where-chain over M)
    mtype, mparam, tex_id = zero, zero, zero
    for mi in range(M):
        selm = w_mat == mi
        mtype = jnp.where(selm, mat[mi], mtype)
        mparam = jnp.where(selm, mat[M + mi], mparam)
        tex_id = jnp.where(selm, mat[2 * M + mi], tex_id)

    # texture sample (const/checker/perlin)
    c0 = V3(zero, zero, zero)
    c1 = V3(zero, zero, zero)
    ttype, tscale = zero, zero
    for xi in range(X):
        selx = tex_id == xi
        ttype = jnp.where(selx, tex[xi], ttype)
        c0 = _vwhere(selx, V3(tex[X + 3 * xi], tex[X + 3 * xi + 1],
                              tex[X + 3 * xi + 2]), c0)
        c1 = _vwhere(selx, V3(tex[4 * X + 3 * xi], tex[4 * X + 3 * xi + 1],
                              tex[4 * X + 3 * xi + 2]), c1)
        tscale = jnp.where(selx, tex[7 * X + xi], tscale)
    sines = (jnp.sin(tscale * p.x) * jnp.sin(tscale * p.y)
             * jnp.sin(tscale * p.z))
    albedo = _vwhere((ttype == float(T.TEX_CHECKER)) & (sines < 0), c1, c0)
    if meta["perlin"]:
        turb = _turbulence(ptab, V3(p.x * tscale, p.y * tscale, p.z * tscale))
        albedo = _vwhere(ttype == float(T.TEX_PERLIN),
                         V3(turb, turb, turb), albedo)

    nrm = w_n
    is_light = mtype == float(T.MAT_DIFFUSE_LIGHT)
    emitted = _vwhere(is_light & (_dot(nrm, rd) < 0.0), albedo * mparam,
                      V3(zero, zero, zero))

    is_iso = mtype == float(T.MAT_ISOTROPIC)
    u_ma = _uniform(keys_b, SLOT_MA)
    u_mb = _uniform(keys_b, SLOT_MB)
    uo, vo, wo = _onb_from_w(nrm)
    loc = _sample_cosine(u_ma, u_mb, exact_cos)
    cos_dir = uo * loc.x + vo * loc.y + wo * loc.z
    iso_dir = _sample_on_sphere(u_ma, u_mb)
    mat_gen = _vwhere(is_iso, iso_dir, cos_dir)

    if lights:
        u_mix = _uniform(keys_b, SLOT_MIX)
        u_pick = _uniform(keys_b, SLOT_LPICK)
        u_a = _uniform(keys_b, SLOT_LA)
        u_b = _uniform(keys_b, SLOT_LB)
        pick = jnp.clip((u_pick * nL).astype(jnp.int32), 0, nL - 1)
        lgen = V3(zero, zero, zero)
        for li, (ltype, lidx) in enumerate(lights):
            if ltype == T.PRIM_SPHERE:
                radl = sph[6 * S + 3 * S + lidx]
                cenl = _sphere_center(sph, S, lidx, time)
                to_c = cenl - p
                dist_sq = _dot(to_c, to_c)
                ul, vl, wl = _onb_from_w(_normalize(to_c))
                frac = jnp.clip(
                    1.0 - radl * radl / jnp.maximum(dist_sq, 1e-30), 0.0, 1.0)
                f_ok = frac > 1e-12
                sqf = jnp.where(f_ok, jnp.sqrt(jnp.where(f_ok, frac, 1.0)), 0.0)
                z = 1.0 + u_b * (sqf - 1.0)
                phi = 2.0 * PI * u_a
                z2 = z * z
                z_ok = z2 < 1.0 - 1e-12
                sl = jnp.where(z_ok, jnp.sqrt(jnp.where(z_ok, 1.0 - z2, 1.0)), 0.0)
                locl = V3(jnp.cos(phi) * sl, jnp.sin(phi) * sl, z)
                dgen = ul * locl.x + vl * locl.y + wl * locl.z
            else:
                ei, ej, ekl, kk, i0, i1, j0, j1, _ = _rect_frame(rect, R, lidx)
                iil = i0 + u_a * (i1 - i0)
                jjl = j0 + u_b * (j1 - j0)
                point = ei * iil + ej * jjl + ekl * kk
                dgen = point - p
            lgen = _vwhere(pick == li, dgen, lgen)
        gen = _vwhere(u_mix < 0.5, lgen, mat_gen)
        d = _normalize(gen)
        # light pdf value: average over lights
        lpv = zero
        for (ltype, lidx) in lights:
            if ltype == T.PRIM_SPHERE:
                radl = sph[6 * S + 3 * S + lidx]
                cenl = _sphere_center(sph, S, lidx, time)
                oc = p - cenl
                b = _dot(oc, d)
                c = _dot(oc, oc) - radl * radl
                disc = b * b - c
                sqd = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
                t_front = -b - sqd
                hitl = (disc > 0) & (t_front > TMIN)
                to_c = cenl - p
                dist_sq = _dot(to_c, to_c)
                cm_arg = jnp.clip(
                    1.0 - radl * radl / jnp.maximum(dist_sq, 1e-30), 0.0, 1.0)
                cm_ok = cm_arg > 1e-12
                cos_max = jnp.where(
                    cm_ok, jnp.sqrt(jnp.where(cm_ok, cm_arg, 1.0)), 0.0)
                sa = 2.0 * PI * (1.0 - cos_max)
                lpv = lpv + jnp.where(
                    hitl & (sa > 0), 1.0 / jnp.maximum(sa, 1e-12), 0.0)
            else:
                ei, ej, ekl, kk, i0, i1, j0, j1, sgn = _rect_frame(
                    rect, R, lidx)
                dk = _dot(ekl, d)
                facing = dk * sgn <= 0.0
                dk_safe = jnp.where(jnp.abs(dk) > 1e-30, dk, 1e-30)
                t = (kk - _dot(ekl, p)) / dk_safe
                iiv = _dot(ei, p) + t * _dot(ei, d)
                jjv = _dot(ej, p) + t * _dot(ej, d)
                hitl = (facing & (t >= TMIN)
                        & (iiv >= i0) & (iiv <= i1) & (jjv >= j0) & (jjv <= j1))
                ts = jnp.where(hitl, t, 1.0)
                area = (i1 - i0) * (j1 - j0)
                cosine = jnp.abs(_dot(d, ekl) * sgn)
                val = ts * ts / jnp.maximum(cosine * area, 1e-12)
                lpv = lpv + jnp.where(hitl, val, 0.0)
        lpv = lpv / nL
        mat_pdf_v = jnp.where(
            is_iso, 1.0 / (2.0 * PI),
            jnp.where(_dot(nrm, d) > 0, _dot(nrm, d) / PI, 0.0))
        pdf_v = 0.5 * lpv + 0.5 * mat_pdf_v
    else:
        d = _normalize(mat_gen)
        pdf_v = jnp.where(
            is_iso, 1.0 / (2.0 * PI),
            jnp.where(_dot(nrm, d) > 0, _dot(nrm, d) / PI, 0.0))

    scatter_pdf = jnp.where(
        is_iso, 1.0 / (2.0 * PI), jnp.maximum(_dot(nrm, d), 0.0) / PI)
    pdf_ok = pdf_v > 1e-12
    safe_pdf = jnp.where(pdf_ok, pdf_v, 1.0)
    diffuse_w = albedo * jnp.where(pdf_ok, scatter_pdf / safe_pdf, 0.0)

    # metal
    is_metal = mtype == float(T.MAT_METAL)
    refl = rd - nrm * (2.0 * _dot(rd, nrm))
    fuzz = _sample_in_ball(
        _uniform(keys_b, SLOT_FUZZ), _uniform(keys_b, SLOT_FUZZ + 1),
        _uniform(keys_b, SLOT_FUZZ + 2))
    metal_dir = _normalize(refl + fuzz * (1.0 - mparam))

    # dielectric
    is_diel = mtype == float(T.MAT_DIELECTRIC)
    ref_idx = jnp.where(is_diel, mparam, 1.5)
    cosI = -_dot(rd, nrm)
    entering = cosI >= 0
    facing_n = _vwhere(entering, nrm, V3(-nrm.x, -nrm.y, -nrm.z))
    ni_over_nt = jnp.where(entering, 1.0 / ref_idx, ref_idx)
    ncosI = _dot(rd, facing_n)
    sinT2 = (ni_over_nt * ni_over_nt) * (1.0 - ncosI * ncosI)
    can_refract = sinT2 <= 1.0
    safe_r = sinT2 < 1.0 - 1e-9
    cosT = jnp.where(safe_r, jnp.sqrt(jnp.where(safe_r, 1.0 - sinT2, 1.0)), 0.0)
    refracted = rd * ni_over_nt + facing_n * (ni_over_nt * (-ncosI) - cosT)
    cs_arg = jnp.clip(1.0 - ni_over_nt * ni_over_nt * (1.0 - cosI * cosI),
                      0.0, 1.0)
    cs_ok = cs_arg > 1e-12
    cos_schlick = jnp.where(
        entering, cosI,
        jnp.where(cs_ok, jnp.sqrt(jnp.where(cs_ok, cs_arg, 1.0)), 0.0))
    reflect_prob = jnp.where(can_refract, _schlick(cos_schlick, ref_idx), 1.0)
    do_reflect = _uniform(keys_b, SLOT_FRESNEL) < reflect_prob
    diel_dir = _vwhere(do_reflect, _normalize(refl), _normalize(refracted))
    inside_after = jnp.where(entering, inside + 1, jnp.maximum(inside - 1, 0))
    diel_inside = jnp.where(do_reflect, inside, inside_after)

    is_specular = is_metal | is_diel
    new_rd = _vwhere(is_metal, metal_dir, _vwhere(is_diel, diel_dir, d))
    new_inside = jnp.where(is_diel, diel_inside, 0)
    ones3 = V3(jnp.ones_like(safe_t), jnp.ones_like(safe_t), jnp.ones_like(safe_t))
    weight = _vwhere(is_diel, ones3, _vwhere(is_specular, albedo, diffuse_w))
    return hit, p, emitted, is_light, is_specular, weight, new_rd, new_inside


def background_color(meta, rd):
    """Sky gradient or black (main.cpp:110-116)."""
    if meta["use_sky"]:
        tsky = 0.5 * (rd.y + 1.0)
        return V3((1.0 - tsky) + tsky * 0.5, (1.0 - tsky) + tsky * 0.7,
                  (1.0 - tsky) + tsky * 1.0)
    zero = jnp.zeros_like(rd.y)
    return V3(zero, zero, zero)


def camera_ray(cam, pix, samp, width, height, sq):
    """Key and thin-lens + shutter camera ray for (pixel, sample) lanes
    (camera.h:38-45 == models/camera.get_rays with the stratified offsets
    of integrator.sample_offsets, counter-keyed jitter)."""
    keys = _ray_key(pix, samp.astype(jnp.uint32))
    ci = jnp.clip(samp, 0, sq * sq - 1)
    off_x = ((ci // sq).astype(jnp.float32) + 0.5) / sq
    off_y = ((ci % sq).astype(jnp.float32) + 0.5) / sq
    # u32 -> f32 through i32 (pixel ids < 2^31)
    xpix = (pix % width).astype(jnp.int32).astype(jnp.float32)
    ypix = (pix // width).astype(jnp.int32).astype(jnp.float32)
    ss = (xpix + off_x) / width
    tt = (ypix + off_y) / height
    kc = _fold(keys, jnp.full_like(keys, CAM_FOLD))
    u1 = _uniform(kc, 0)
    u2 = _uniform(kc, 1)
    u3 = _uniform(kc, 2)
    radd = jnp.sqrt(u1)
    phid = 2.0 * PI * u2
    lens_r = cam[18]
    dx = radd * jnp.cos(phid) * lens_r
    dy = radd * jnp.sin(phid) * lens_r
    cu = V3(cam[12], cam[13], cam[14])
    cvv = V3(cam[15], cam[16], cam[17])
    offset = cu * dx + cvv * dy
    new_time = cam[19] + (cam[20] - cam[19]) * u3
    new_ro = V3(cam[0], cam[1], cam[2]) + offset
    new_dir = _normalize(V3(
        cam[3] + cam[6] * ss + cam[9] * tt - cam[0] - offset.x,
        cam[4] + cam[7] * ss + cam[10] * tt - cam[1] - offset.y,
        cam[5] + cam[8] * ss + cam[11] * tt - cam[2] - offset.z,
    ))
    return keys, new_ro, new_dir, new_time


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _make_kernel(meta, width, height, sq, max_bounces, n_valid, lanes):
    """Build the fused render kernel specialized to the scene's meta."""
    offsets = dict(meta["offsets"])

    def kernel(misc_ref, tab_ref, ptab_ref, pix_ref,
               ax_ref, ay_ref, az_ref, cnt_ref, ray_ref):
        max_lum = misc_ref[0]
        sample_lo = misc_ref[1].astype(jnp.int32)
        n_samples = misc_ref[2].astype(jnp.int32)
        tabs = {k: _Sub(tab_ref, o) for k, o in offsets.items()}
        cam = tabs["cam"]
        pix = pix_ref[...]
        lane = pl.program_id(0) * lanes + jnp.arange(lanes, dtype=jnp.int32)

        def ray_for(samp):
            return camera_ray(cam, pix, samp, width, height, sq)

        izero = jnp.zeros((lanes,), jnp.int32)
        fzero = jnp.zeros((lanes,), jnp.float32)
        fone = jnp.ones((lanes,), jnp.float32)
        keys0, ro0, rd0, time0 = ray_for(izero + sample_lo)
        alive0 = ((lane < n_valid) & (n_samples > 0)).astype(jnp.float32)
        # carry: accum3 ro3 rd3 time beta3 rad3 alive count inside depth
        # keys rays
        carry0 = (fzero, fzero, fzero, ro0.x, ro0.y, ro0.z, rd0.x, rd0.y,
                  rd0.z, time0, fone, fone, fone, fzero, fzero, fzero,
                  alive0, izero, izero, izero, keys0, fzero)

        def cond(c):
            return jnp.max(c[16]) > 0.0

        def step(c):
            accum = V3(c[0], c[1], c[2])
            ro = V3(c[3], c[4], c[5])
            rd = V3(c[6], c[7], c[8])
            time = c[9]
            beta = V3(c[10], c[11], c[12])
            radiance = V3(c[13], c[14], c[15])
            alive = c[16] > 0.0
            count, inside, depth, keys, rays_ct = c[17:]
            rays_ct = rays_ct + jnp.where(alive, 1.0, 0.0)

            keys_b = _fold(keys, depth)
            (hit, p, emitted, is_light, is_specular, weight, new_rd,
             new_inside) = bounce_physics(meta, tabs, ptab_ref, ro, rd, time,
                                          inside, keys_b)
            scattered = (depth < max_bounces) & ~is_light
            add_emitted = ~(scattered & is_specular)

            # ---------- advance + merge + regen (wavefront body) ----------
            miss = alive & ~hit
            zero3 = V3(fzero, fzero, fzero)
            radiance = radiance + _vwhere(miss, beta * background_color(meta, rd),
                                          zero3)
            emit_mask = alive & hit & add_emitted
            radiance = radiance + _vwhere(emit_mask, beta * emitted, zero3)
            cont = alive & hit & scattered
            beta = _vwhere(cont, beta * weight, beta)
            cont = cont & ((beta.x > 0.0) | (beta.y > 0.0) | (beta.z > 0.0))

            finished = alive & ~cont
            cnt_f = count.astype(jnp.float32)
            has_prev = count > 0
            inv_prev = 1.0 / jnp.maximum(cnt_f, 1.0)
            prev_avg = _vwhere(has_prev, accum * inv_prev, zero3)
            finite = (_isfinite(radiance.x) & _isfinite(radiance.y)
                      & _isfinite(radiance.z))
            color = _vwhere(finite, radiance, prev_avg)
            new_avg = _vwhere(
                has_prev, prev_avg + (color - prev_avg) * (1.0 / (cnt_f + 1.0)),
                color)
            lum = (0.212655 * new_avg.x + 0.715158 * new_avg.y
                   + 0.072187 * new_avg.z)
            lscale = jnp.where(lum > max_lum,
                               max_lum / jnp.maximum(lum, 1e-12), 1.0)
            new_avg = new_avg * lscale
            accum = _vwhere(finished, new_avg * (cnt_f + 1.0), accum)
            count = jnp.where(finished, count + 1, count)

            regen = finished & (count < n_samples)
            new_keys, cam_ro, cam_rd, cam_time = ray_for(sample_lo + count)
            out_ro = _vwhere(regen, cam_ro, _vwhere(cont, p, ro))
            out_rd = _vwhere(regen, cam_rd, _vwhere(cont, new_rd, rd))
            out_time = jnp.where(regen, cam_time, time)
            out_inside = jnp.where(regen, 0, jnp.where(cont, new_inside, inside))
            out_beta = _vwhere(regen, V3(fone, fone, fone), beta)
            out_rad = _vwhere(regen, zero3, radiance)
            out_depth = jnp.where(regen, 0, depth + 1)
            out_alive = (cont | regen).astype(jnp.float32)
            out_keys = jnp.where(regen, new_keys, keys)
            return (accum.x, accum.y, accum.z, out_ro.x, out_ro.y, out_ro.z,
                    out_rd.x, out_rd.y, out_rd.z, out_time,
                    out_beta.x, out_beta.y, out_beta.z,
                    out_rad.x, out_rad.y, out_rad.z, out_alive,
                    count, out_inside, out_depth, out_keys, rays_ct)

        c = jax.lax.while_loop(cond, step, carry0)
        ax_ref[...] = c[0]
        ay_ref[...] = c[1]
        az_ref[...] = c[2]
        cnt_ref[...] = c[17]
        ray_ref[...] = c[21]

    return kernel


@partial(jax.jit, static_argnames=(
    "meta", "width", "height", "sq", "max_bounces", "n_valid", "interpret",
    "lanes"))
def fused_render_lanes(meta, tab, ptab, pix, sample_lo, max_lum, n_samples, *,
                       width, height, sq, max_bounces, n_valid,
                       interpret=False, lanes=LANES):
    """Run every lane block's full render loop in ONE kernel launch.

    `pix` is (n_pad,) u32 with n_pad a multiple of `lanes`; lanes at index
    >= n_valid are padding and never trace. Returns per-lane (accum x, y,
    z, count, rays traced)."""
    meta_d = dict(meta)
    n_pad = pix.shape[0]
    kernel = _make_kernel(meta_d, width, height, sq, max_bounces, n_valid,
                          lanes)
    misc = jnp.stack([max_lum, sample_lo.astype(jnp.float32),
                      jnp.asarray(n_samples, jnp.int32).astype(jnp.float32)])
    whole = pl.BlockSpec()
    block = pl.BlockSpec((lanes,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // lanes,),
        in_specs=[whole, whole, whole, block],
        out_specs=[block] * 5,
        out_shape=[f32, f32, f32, jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   f32],
        compiler_params=plgpu.CompilerParams(num_warps=max(1, lanes // 32),
                                             num_stages=1),
        interpret=interpret,
        name="fused_wavefront",
    )(misc, tab, ptab, pix)


def render_wavefront_fused_pixels(scene, pix, sample_lo, n_samples, max_lum,
                                  *, width, height, max_bounces, spp_sq,
                                  interpret=False, lanes=LANES):
    """Fused-kernel equivalent of integrator.render_wavefront_pixels.

    Same estimator (counter-keyed RNG, draw2 merge, NaN/clamp policy);
    returns (accum V3, count, rays_traced)."""
    meta_d, tab, ptab = pack_scene(scene)
    meta = tuple(sorted(meta_d.items()))
    n = pix.shape[0]
    rem = (-n) % lanes
    pix_p = pix.astype(jnp.uint32)
    if rem:
        pix_p = jnp.concatenate([pix_p, jnp.zeros((rem,), jnp.uint32)])
    ax, ay, az, count, rays = fused_render_lanes(
        meta, tab, ptab, pix_p, jnp.asarray(sample_lo, jnp.int32),
        jnp.asarray(max_lum, jnp.float32), jnp.asarray(n_samples, jnp.int32),
        width=width, height=height, sq=spp_sq, max_bounces=max_bounces,
        n_valid=n, interpret=interpret, lanes=lanes)
    return V3(ax[:n], ay[:n], az[:n]), count[:n], jnp.sum(rays)


@partial(jax.jit, static_argnames=(
    "width", "height", "ns", "sq", "max_bounces", "interpret", "lanes"))
def _fused_frame_jit(scene, max_lum, *, width, height, ns, sq, max_bounces,
                     interpret, lanes):
    # module-level jit: cached across renders (a per-call closure would
    # retrace and recompile every invocation)
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    accum, count, rays = render_wavefront_fused_pixels(
        scene, pix, jnp.int32(0), ns, max_lum,
        width=width, height=height, max_bounces=max_bounces, spp_sq=sq,
        interpret=interpret, lanes=lanes,
    )
    inv = 1.0 / jnp.maximum(count.astype(jnp.float32), 1.0)
    return (accum * inv).arr, rays


def render_wavefront_fused(scene, width, height, spp, max_bounces=32,
                           max_lum=1000.0, interpret=False, lanes=LANES):
    """Full-frame fused-kernel wavefront render. Returns (frame, stats)."""
    import time as _time

    sq = int(np.sqrt(spp))
    ns = sq * sq

    t0 = _time.perf_counter()
    frame, rays = _fused_frame_jit(
        scene, jnp.float32(max_lum), width=width, height=height, ns=ns, sq=sq,
        max_bounces=max_bounces, interpret=interpret, lanes=lanes)
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total = float(rays)
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "renderer": "fused",
    }
