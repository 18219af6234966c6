"""Vectorized ray-primitive intersection (the traversal/intersection layer).

The reference dispatches `scene_object::hit` virtually per object
(scene_object.h:20-31). Here each primitive *type* is intersected as one
batched kernel over `(prims, rays)` — regular, branch-free elementwise work — and the
per-type minima are combined by masked selects. Type-level formulas:

- spheres:   sphere.cpp:13-46 (front root; back root only when ray.isInside;
             negative radius = hollow shell via normal /radius)
- rects:     rect.cpp:26-47/71-90/132-150 (one-sided plane + bounds), axis
             encoded as unit vectors so the three variants are one kernel
- triangles: triangle.cpp:221-264 Moller-Trumbore with the branchless
             combined rejection and isInside sign flip
- volumes:   volumes.cpp:5-36 boundary double-hit + exponential free path;
             boundary entry/exit computed analytically (double-sided)

Layout: everything is structure-of-arrays (vecmath.V3). Candidate grids are
(C, N) — prims on the major axis, rays on the minor (contiguous) axis — so
memory access stays coalesced for any chunk size. Scene tables stay (K, 3) on
the host side; component columns are sliced once per kernel (K-sized, cheap).

Two-phase design: phase 1 reduces min-t + argmin over prims (chunked so
(CHUNK, N) intermediates stay bounded); phase 2 gathers the winning
primitive's parameters and reconstructs the full hit record (p, n, u, v, mat)
— only O(rays) work.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from miniraytracer_tpu.ops import vecmath as vm
from miniraytracer_tpu.ops.lookup import lookup_cols
from miniraytracer_tpu.ops.vecmath import (V3, vasin, vatan2, vdot, vsdot,
                                            vnormalize, vwhere)
from miniraytracer_tpu.scene import types as T

INF = jnp.float32(3.0e38)
TMIN = 0.001  # main.cpp:71
TRI_EPS = 1e-5  # triangle.cpp:220
CHUNK = 512  # max prims per reduction step; bounds (CHUNK, N) temporaries


class Rays(NamedTuple):
    ro: V3  # (N,) components — origin
    rd: V3  # direction, normalized
    time: jnp.ndarray  # (N,)
    inside: jnp.ndarray  # (N,) int32 nested-dielectric counter (ray.h:14-15)


class Hit(NamedTuple):
    t: jnp.ndarray  # (N,) INF on miss
    ptype: jnp.ndarray  # (N,) i32 PRIM_*
    pidx: jnp.ndarray  # (N,) i32
    hit: jnp.ndarray  # (N,) bool


class HitRecord(NamedTuple):
    t: jnp.ndarray
    p: V3
    n: V3
    u: jnp.ndarray  # (N,)
    v: jnp.ndarray  # (N,)
    mat: jnp.ndarray  # (N,) i32
    hit: jnp.ndarray  # (N,) bool


def _vcol(table, start=None, count=None) -> V3:
    """V3 of the three component columns of an (K,3) table."""
    if start is None:
        return V3(table[:, 0], table[:, 1], table[:, 2])
    s = slice(start, start + count)
    return V3(table[s, 0], table[s, 1], table[s, 2])


def _chunked_min(t_fn, n_prims: int, n_rays: int):
    """Reduce (min t, argmin idx) over prims in CHUNK-sized pieces.

    `t_fn(start, count)` -> (count, N) candidate t values (INF = miss).
    Static python loop over chunks (few, unrolled into the XLA graph) keeps
    peak memory at O(CHUNK * N) while letting XLA fuse each chunk's
    elementwise work directly into the reduction.
    """
    best_t = jnp.full((n_rays,), INF)
    best_i = jnp.zeros((n_rays,), jnp.int32)
    for start in range(0, n_prims, CHUNK):
        count = min(CHUNK, n_prims - start)
        tc = t_fn(start, count)  # (count, N)
        i = jnp.argmin(tc, axis=0).astype(jnp.int32)
        tmin_c = jnp.min(tc, axis=0)
        better = tmin_c < best_t
        best_t = jnp.where(better, tmin_c, best_t)
        best_i = jnp.where(better, i + start, best_i)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------


def _sphere_center_cols(scene: T.SceneData, s: slice, time):
    """(C, N) center components for spheres in slice `s` at ray times `time`
    (N,). Lerped moving center (sphere.h:24-31)."""
    c0 = V3(scene.sph_c0[s, 0], scene.sph_c0[s, 1], scene.sph_c0[s, 2])
    c1 = V3(scene.sph_c1[s, 0], scene.sph_c1[s, 1], scene.sph_c1[s, 2])
    t0 = scene.sph_t0[s]
    t1 = scene.sph_t1[s]
    mov = scene.sph_moving[s]
    denom = jnp.where(mov > 0, t1 - t0, 1.0)
    # f: (C, N)
    f = jnp.where(mov[:, None] > 0, (time[None, :] - t0[:, None]) / denom[:, None], 0.0)
    return V3(
        c0.x[:, None] + f * (c1.x - c0.x)[:, None],
        c0.y[:, None] + f * (c1.y - c0.y)[:, None],
        c0.z[:, None] + f * (c1.z - c0.z)[:, None],
    )


def _sphere_center_static(scene: T.SceneData, si: int, time) -> V3:
    """Center of sphere row `si` (STATIC python index — no gather) at ray
    times `time` (N,). Used by light-pdf code where the row is known."""
    c0 = V3(scene.sph_c0[si, 0], scene.sph_c0[si, 1], scene.sph_c0[si, 2])
    c1 = V3(scene.sph_c1[si, 0], scene.sph_c1[si, 1], scene.sph_c1[si, 2])
    t0 = scene.sph_t0[si]
    t1 = scene.sph_t1[si]
    mov = scene.sph_moving[si]
    denom = jnp.where(mov > 0, t1 - t0, 1.0)
    f = jnp.where(mov > 0, (time - t0) / denom, 0.0)
    return c0 + (c1 - c0) * f


def sphere_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    """(count, N) candidate t's for spheres [start, start+count)."""
    s = slice(start, start + count)
    cen = _sphere_center_cols(scene, s, rays.time)  # (C,N) comps
    ocx = rays.ro.x[None, :] - cen.x
    ocy = rays.ro.y[None, :] - cen.y
    ocz = rays.ro.z[None, :] - cen.z
    b = ocx * rays.rd.x[None, :] + ocy * rays.rd.y[None, :] + ocz * rays.rd.z[None, :]
    r = scene.sph_radius[s]
    c = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[:, None]
    disc = b * b - c
    # double-where: sqrt's backward is inf at 0, and 0-cotangent * inf = NaN
    # — masked lanes must never see a non-positive sqrt argument
    sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
    t_front = -b - sq
    t_back = -b + sq
    ok = (disc > 0) & scene.sph_active[s][:, None]
    front_ok = ok & (t_front < tmax[None, :]) & (t_front > tmin)
    back_ok = (
        ok
        & (rays.inside[None, :] > 0)
        & (t_back < tmax[None, :])
        & (t_back > tmin)
    )
    return jnp.where(front_ok, t_front, jnp.where(back_ok, t_back, INF))


def sphere_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record for sphere `idx` at parameter `t` (sphere.cpp:22-45)."""
    (c0x, c0y, c0z, c1x, c1y, c1z, t0, t1, mov, rad, mat) = lookup_cols(
        idx,
        (
            scene.sph_c0[:, 0], scene.sph_c0[:, 1], scene.sph_c0[:, 2],
            scene.sph_c1[:, 0], scene.sph_c1[:, 1], scene.sph_c1[:, 2],
            scene.sph_t0, scene.sph_t1, scene.sph_moving,
            scene.sph_radius, scene.sph_mat,
        ),
    )
    denom = jnp.where(mov > 0, t1 - t0, 1.0)
    f = jnp.where(mov > 0, (rays.time - t0) / denom, 0.0)
    c0 = V3(c0x, c0y, c0z)
    cen = c0 + (V3(c1x, c1y, c1z) - c0) * f
    p = rays.ro + rays.rd * t
    # padded/inactive rows carry radius 0 — inf here becomes NaN through the
    # downstream normalize and masked selects can't scrub NaN cotangents
    safe_rad = jnp.where(jnp.abs(rad) > 1e-20, rad, 1.0)
    # *(1/rad), NOT /rad: the exact expression the fused kernel's sphere
    # sweep uses (ops/bounce.py) — the two must stay bit-identical or
    # last-ulp normal skew seeds chaotic path divergence between renderers
    n = (p - cen) * (1.0 / safe_rad)  # negative radius flips normal
    # for true hits |p-cen| == |radius| so this is an exact no-op (and keeps
    # the hollow-sphere sign flip); for masked lanes (caller selects by type)
    # it bounds the garbage magnitude so downstream masked branches can't
    # overflow to inf and poison gradients under fusion
    n = vnormalize(n)
    # spherical uv on the normal (sphere.cpp:6-11); vatan2/vasin (cephes
    # polys, ops/vecmath.py) — the ONLY inverse-trig implementation in the
    # project, so texel quantization is the same on every backend;
    # pullback-safe at the poles by construction
    phi = vatan2(n.z, n.x)
    ny = jnp.clip(n.y, -1.0, 1.0)
    at_pole = jnp.abs(ny) >= 1.0
    theta = jnp.where(
        at_pole,
        jnp.sign(ny) * (jnp.pi / 2),
        vasin(jnp.where(at_pole, 0.0, ny)),
    )
    u = 0.5 - phi / (2.0 * jnp.pi)
    v = 0.5 + theta / jnp.pi
    return p, n, u, v, mat


# ---------------------------------------------------------------------------
# Rects (one kernel for xy/xz/yz via axis unit vectors)
# ---------------------------------------------------------------------------


def rect_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    s = slice(start, start + count)
    ek = _vcol(scene.rect_ek, start, count)
    ei = _vcol(scene.rect_ei, start, count)
    ej = _vcol(scene.rect_ej, start, count)
    sign = scene.rect_sign[s]

    def proj(e: V3):  # (C, N): per-prim-axis component of a per-ray vector
        return (
            e.x[:, None] * rays.rd.x[None, :]
            + e.y[:, None] * rays.rd.y[None, :]
            + e.z[:, None] * rays.rd.z[None, :]
        )

    def projo(e: V3):
        return (
            e.x[:, None] * rays.ro.x[None, :]
            + e.y[:, None] * rays.ro.y[None, :]
            + e.z[:, None] * rays.ro.z[None, :]
        )

    dk = proj(ek)
    # one-sided: reject dot(dir, n) > 0 (rect.cpp:26-27)
    facing = dk * sign[:, None] <= 0.0
    ok_o = projo(ek)
    dk_safe = jnp.where(jnp.abs(dk) > 1e-30, dk, 1e-30)  # NaN-free backward
    t = (scene.rect_k[s][:, None] - ok_o) / dk_safe
    ii = projo(ei) + t * proj(ei)
    jj = projo(ej) + t * proj(ej)
    inb = (
        (ii >= scene.rect_i0[s][:, None])
        & (ii <= scene.rect_i1[s][:, None])
        & (jj >= scene.rect_j0[s][:, None])
        & (jj <= scene.rect_j1[s][:, None])
    )
    valid = (
        facing
        & (t >= tmin)
        & (t <= tmax[None, :])
        & inb
        & scene.rect_active[s][:, None]
    )
    return jnp.where(valid, t, INF)


def rect_record(scene: T.SceneData, rays: Rays, t, idx):
    p = rays.ro + rays.rd * t
    (eix, eiy, eiz, ejx, ejy, ejz, ekx, eky, ekz,
     i0, i1, j0, j1, sign, mat) = lookup_cols(
        idx,
        (
            scene.rect_ei[:, 0], scene.rect_ei[:, 1], scene.rect_ei[:, 2],
            scene.rect_ej[:, 0], scene.rect_ej[:, 1], scene.rect_ej[:, 2],
            scene.rect_ek[:, 0], scene.rect_ek[:, 1], scene.rect_ek[:, 2],
            scene.rect_i0, scene.rect_i1, scene.rect_j0, scene.rect_j1,
            scene.rect_sign, scene.rect_mat,
        ),
    )
    ei = V3(eix, eiy, eiz)
    ej = V3(ejx, ejy, ejz)
    ek = V3(ekx, eky, ekz)
    ii = vdot(p, ei)
    jj = vdot(p, ej)
    u = (ii - i0) / (i1 - i0)
    v = (jj - j0) / (j1 - j0)
    n = ek * sign
    return p, n, u, v, mat


# ---------------------------------------------------------------------------
# Boxes (box.h: 6 outward one-sided rects as ONE primitive; rotate_y +
# translate wrappers baked, scene_object.cpp:9-98)
# ---------------------------------------------------------------------------


def _box_local_rays(scene: T.SceneData, rays: Rays, s):
    """World->local ray transform for a box slice: inverse rotate_y about y
    after un-translating (the transpose of builder._roty_fwd)."""
    sin_t = scene.box_cs[s, 0][:, None]
    cos_t = scene.box_cs[s, 1][:, None]
    ox = rays.ro.x[None, :] - scene.box_off[s, 0][:, None]
    oy = rays.ro.y[None, :] - scene.box_off[s, 1][:, None]
    oz = rays.ro.z[None, :] - scene.box_off[s, 2][:, None]
    lox = cos_t * ox - sin_t * oz
    loz = cos_t * oz + sin_t * ox
    ldx = cos_t * rays.rd.x[None, :] - sin_t * rays.rd.z[None, :]
    ldz = cos_t * rays.rd.z[None, :] + sin_t * rays.rd.x[None, :]
    ldy = jnp.broadcast_to(rays.rd.y[None, :], ldx.shape)
    return (lox, oy, loz), (ldx, ldy, ldz)


def _box_face_ts(lo, ld, bmin, bmax):
    """Candidate t of the 6 one-sided faces -> (6, ...) stack. Front-facing
    tests per face as in the rect decomposition (rect.cpp:26: reject
    dot(dir, n) > 0); out-of-bounds or backfacing faces return INF."""
    cands = []
    axes = ((0, 1, 2), (1, 0, 2), (2, 0, 1))
    for a, b, c in axes:
        ld_a = ld[a]
        inv = 1.0 / jnp.where(
            jnp.abs(ld_a) > 1e-12, ld_a, jnp.where(ld_a >= 0, 1e-12, -1e-12)
        )
        for bound, facing in ((bmin[a], ld_a > 0), (bmax[a], ld_a < 0)):
            t = (bound - lo[a]) * inv
            bb = lo[b] + t * ld[b]
            cc = lo[c] + t * ld[c]
            okf = (facing & (bb >= bmin[b]) & (bb <= bmax[b])
                   & (cc >= bmin[c]) & (cc <= bmax[c]))
            cands.append(jnp.where(okf, t, INF))
    return jnp.stack(cands, axis=0)


def box_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    s = slice(start, start + count)
    lo, ld = _box_local_rays(scene, rays, s)
    bmin = tuple(scene.box_lo[s, k][:, None] for k in range(3))
    bmax = tuple(scene.box_hi[s, k][:, None] for k in range(3))
    t = jnp.min(_box_face_ts(lo, ld, bmin, bmax), axis=0)  # (C, N)
    valid = ((t >= tmin) & (t <= tmax[None, :])
             & scene.box_active[s][:, None])
    return jnp.where(valid, t, INF)


def box_record(scene: T.SceneData, rays: Rays, t, idx):
    """Record for box `idx` at parameter `t`: winner face re-derived by
    argmin over the 6 candidates (cheap: one box per lane). Face uv follows
    the rect ctor axis convention in the LOCAL frame (u, v over the two
    free axes) — box materials in the reference scene set are untextured,
    so the swapped-bound u/v mirroring of box.h's rect ctor args is not
    reproduced."""
    (lox, loy, loz, hix, hiy, hiz, sn, cs, ofx, ofy, ofz, mat) = lookup_cols(
        idx,
        (
            scene.box_lo[:, 0], scene.box_lo[:, 1], scene.box_lo[:, 2],
            scene.box_hi[:, 0], scene.box_hi[:, 1], scene.box_hi[:, 2],
            scene.box_cs[:, 0], scene.box_cs[:, 1],
            scene.box_off[:, 0], scene.box_off[:, 1], scene.box_off[:, 2],
            scene.box_mat,
        ),
    )
    ox = rays.ro.x - ofx
    oy = rays.ro.y - ofy
    oz = rays.ro.z - ofz
    lo = (cs * ox - sn * oz, oy, cs * oz + sn * ox)
    ld = (cs * rays.rd.x - sn * rays.rd.z, rays.rd.y,
          cs * rays.rd.z + sn * rays.rd.x)
    bmin = (lox, loy, loz)
    bmax = (hix, hiy, hiz)
    cands = _box_face_ts(lo, ld, bmin, bmax)  # (6, N)
    face = jnp.argmin(jnp.abs(cands - t[None, :]), axis=0)
    axis = face // 2
    neg = (face % 2) == 0  # min-bound face -> outward normal -axis
    sgn = jnp.where(neg, -1.0, 1.0)
    nl = (jnp.where(axis == 0, sgn, 0.0), jnp.where(axis == 1, sgn, 0.0),
          jnp.where(axis == 2, sgn, 0.0))
    # local -> world normal (builder._roty_fwd)
    n = V3(cs * nl[0] + sn * nl[2], nl[1], cs * nl[2] - sn * nl[0])
    p = rays.ro + rays.rd * t
    pl = (lo[0] + t * ld[0], lo[1] + t * ld[1], lo[2] + t * ld[2])
    ext = tuple(jnp.maximum(bmax[k] - bmin[k], 1e-20) for k in range(3))
    fu = tuple((pl[k] - bmin[k]) / ext[k] for k in range(3))
    u = jnp.where(axis == 0, fu[1], fu[0])
    v = jnp.where(axis == 2, fu[1], fu[2])
    return p, n, u, v, mat


# ---------------------------------------------------------------------------
# Triangles (Moller-Trumbore, triangle.cpp:221-264)
# ---------------------------------------------------------------------------


def tri_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    s = slice(start, start + count)
    m = _vcol(scene.tri_m, start, count)
    u = _vcol(scene.tri_u, start, count)
    v = _vcol(scene.tri_v, start, count)
    rdx, rdy, rdz = rays.rd.x[None, :], rays.rd.y[None, :], rays.rd.z[None, :]
    # pvec = cross(rd, v): (C, N) planes, componentwise
    px = rdy * v.z[:, None] - rdz * v.y[:, None]
    py = rdz * v.x[:, None] - rdx * v.z[:, None]
    pz = rdx * v.y[:, None] - rdy * v.x[:, None]
    det = u.x[:, None] * px + u.y[:, None] * py + u.z[:, None] * pz
    # hit backfaces only when inside (triangle.cpp:226-235)
    sign = jnp.where((rays.inside[None, :] > 0) & (det < 0.0), -1.0, 1.0)
    det = det * sign
    tx = rays.ro.x[None, :] - m.x[:, None]
    ty = rays.ro.y[None, :] - m.y[:, None]
    tz = rays.ro.z[None, :] - m.z[:, None]
    uu = (tx * px + ty * py + tz * pz) * sign
    # qvec = cross(tvec, u)
    qx = ty * u.z[:, None] - tz * u.y[:, None]
    qy = tz * u.x[:, None] - tx * u.z[:, None]
    qz = tx * u.y[:, None] - ty * u.x[:, None]
    vv = (rdx * qx + rdy * qy + rdz * qz) * sign
    safe_det = jnp.where(det > TRI_EPS, det, 1.0)
    t = (v.x[:, None] * qx + v.y[:, None] * qy + v.z[:, None] * qz) / safe_det * sign
    valid = (
        (det >= TRI_EPS)
        & (uu >= 0)
        & (uu <= det)
        & (vv >= 0)
        & (uu + vv <= det)
        & (t >= tmin)
        & (t <= tmax[None, :])
        & scene.tri_active[s][:, None]
    )
    return jnp.where(valid, t, INF)


def tri_record(scene: T.SceneData, rays: Rays, t, idx):
    (mx, my, mz, ux, uy, uz, vx, vy, vz,
     mnx, mny, mnz, unx, uny, unz, vnx, vny, vnz, mat) = lookup_cols(
        idx,
        (
            scene.tri_m[:, 0], scene.tri_m[:, 1], scene.tri_m[:, 2],
            scene.tri_u[:, 0], scene.tri_u[:, 1], scene.tri_u[:, 2],
            scene.tri_v[:, 0], scene.tri_v[:, 1], scene.tri_v[:, 2],
            scene.tri_mn[:, 0], scene.tri_mn[:, 1], scene.tri_mn[:, 2],
            scene.tri_un[:, 0], scene.tri_un[:, 1], scene.tri_un[:, 2],
            scene.tri_vn[:, 0], scene.tri_vn[:, 1], scene.tri_vn[:, 2],
            scene.tri_mat,
        ),
    )
    m = V3(mx, my, mz)
    u = V3(ux, uy, uz)
    v = V3(vx, vy, vz)
    pvec = vm.vcross(rays.rd, v)
    det = vdot(u, pvec)
    sign = jnp.where((rays.inside > 0) & (det < 0.0), -1.0, 1.0)
    det = det * sign
    tvec = rays.ro - m
    uu = vdot(tvec, pvec) * sign
    qvec = vm.vcross(tvec, u)
    vv = vdot(rays.rd, qvec) * sign
    # TRI_EPS guard (not just != 0): masked lanes can carry near-zero dets
    # whose 1/det overflows and poisons gradients (true hits have det > eps)
    inv = 1.0 / jnp.where(jnp.abs(det) > TRI_EPS, det, 1.0)
    uu = uu * inv
    vv = vv * inv
    p = rays.ro + rays.rd * t
    mn = V3(mnx, mny, mnz)
    un = V3(unx, uny, unz)
    vn = V3(vnx, vny, vnz)
    # smooth normal interpolation, normalized (triangle.cpp:261)
    n = vnormalize(mn * (1.0 - uu - vv) + un * uu + vn * vv)
    return p, n, uu, vv, mat


# ---------------------------------------------------------------------------
# Volumes (constant density media, volumes.cpp)
# ---------------------------------------------------------------------------


def _volume_entry_exit(scene: T.SceneData, rays: Rays, vi: int):
    """Reference-faithful double-probe of volume vi's boundary
    (volumes.cpp:11-12): rec1 = first boundary hit in (lowest, max), rec2 =
    first hit in (rec1 + 1e-4, max). CRITICAL parity detail: the boundary is
    made of ONE-SIDED primitives, so this is NOT a physical entry/exit pair:

    - box boundaries (6 outward one-sided rects, box.h:12-21 + rect.cpp
      front-face rejection): an exterior ray gets rec1 at the near face but
      the far face is backfacing -> NO rec2 -> the reference's smoke boxes
      never scatter rays that enter from outside. Rays STARTING inside see
      the entry face BEHIND them (front-facing at negative t) and nothing
      ahead -> no scatter either.
    - sphere boundaries (sphere.cpp:33-43): the far root is a backface, hit
      only when ray.isInside > 0 — so sphere volumes scatter only for rays
      inside a dielectric (book2's subsurface sphere) where both roots are
      visible.

    We reproduce these semantics exactly (quirks and all) rather than the
    physically-correct double-sided slab test.
    """
    bp = scene.vol_bparams[vi]
    btype = scene.vol_btype[vi]
    NEG = jnp.float32(-3.0e38)

    # ---- sphere boundary candidates (front root; back root needs isInside)
    cen = V3(bp[0], bp[1], bp[2])
    rad = bp[3]
    oc = rays.ro - cen
    b = vdot(oc, rays.rd)
    c = vsdot(oc) - rad * rad
    disc = b * b - c
    sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))  # double-where (see sphere_ts)
    s_ok = disc > 0
    sph_t1 = jnp.where(s_ok, -b - sq, INF)  # front root, always front-facing
    sph_t2 = jnp.where(s_ok & (rays.inside > 0), -b + sq, INF)  # backface root

    # ---- box boundary candidates: 6 one-sided faces in the local frame
    bmin = V3(bp[0], bp[1], bp[2])
    bmax = V3(bp[3], bp[4], bp[5])
    sin_t, cos_t = bp[6], bp[7]
    off = V3(bp[8], bp[9], bp[10])
    ro = rays.ro - off
    lo = V3(cos_t * ro.x - sin_t * ro.z, ro.y, cos_t * ro.z + sin_t * ro.x)
    ld = V3(
        cos_t * rays.rd.x - sin_t * rays.rd.z,
        rays.rd.y,
        cos_t * rays.rd.z + sin_t * rays.rd.x,
    )

    def one_axis(lo_a, ld_a, lo_b, ld_b, lo_c, ld_c, a0, a1, b0, b1, c0, c1):
        inv = 1.0 / jnp.where(
            jnp.abs(ld_a) > 1e-12, ld_a, jnp.where(ld_a >= 0, 1e-12, -1e-12)
        )
        def face(bound, facing_ok):
            t = (bound - lo_a) * inv
            bb = lo_b + t * ld_b
            cc = lo_c + t * ld_c
            okf = facing_ok & (bb >= b0) & (bb <= b1) & (cc >= c0) & (cc <= c1)
            return jnp.where(okf, t, INF)
        # face at a0: outward normal -a_hat -> front-facing iff ld_a > 0
        # face at a1: outward normal +a_hat -> front-facing iff ld_a < 0
        return face(a0, ld_a > 0), face(a1, ld_a < 0)

    fx0, fx1 = one_axis(lo.x, ld.x, lo.y, ld.y, lo.z, ld.z,
                        bmin.x, bmax.x, bmin.y, bmax.y, bmin.z, bmax.z)
    fy0, fy1 = one_axis(lo.y, ld.y, lo.x, ld.x, lo.z, ld.z,
                        bmin.y, bmax.y, bmin.x, bmax.x, bmin.z, bmax.z)
    fz0, fz1 = one_axis(lo.z, ld.z, lo.x, ld.x, lo.y, ld.y,
                        bmin.z, bmax.z, bmin.x, bmax.x, bmin.y, bmax.y)
    box_cands = jnp.stack([fx0, fx1, fy0, fy1, fz0, fz1], axis=0)  # (6, N)

    is_sph = btype == T.VOLB_SPHERE
    cands = jnp.where(
        is_sph,
        jnp.stack([sph_t1, sph_t2, jnp.full_like(fx0, INF),
                   jnp.full_like(fx0, INF), jnp.full_like(fx0, INF),
                   jnp.full_like(fx0, INF)], axis=0),
        box_cands,
    )
    # probe 1: first hit in (lowest, max)
    rec1 = jnp.min(cands, axis=0)
    got1 = rec1 < INF
    # probe 2: first hit in (rec1 + 1e-4, max)  (volumes.cpp:12)
    cands2 = jnp.where(cands > rec1[None, :] + 1e-4, cands, INF)
    rec2 = jnp.min(cands2, axis=0)
    got2 = rec2 < INF
    ok = got1 & got2
    return jnp.where(got1, rec1, NEG), jnp.where(got2, rec2, NEG), ok


def volume_ts(scene: T.SceneData, rays: Rays, tmin, tmax, u_volume):
    """Best volume scatter (t, idx) given per-(ray,volume) uniforms
    u_volume (N, V). Mirrors volumes.cpp:5-36 with the surface-closest-hit as
    tmax (the reference's running closest_so_far with volumes last in list)."""
    n = rays.time.shape[0]
    best_t = jnp.full((n,), INF)
    best_i = jnp.zeros((n,), jnp.int32)
    for vi in range(scene.n_volumes):
        enter, exit_, ok = _volume_entry_exit(scene, rays, vi)
        rec1 = jnp.maximum(enter, tmin)
        # sequential closest_so_far: volumes sit last in the reference's
        # object list IN ORDER, so a later volume is clamped by an earlier
        # volume's scatter too (object_list::hit running closest)
        rec2 = jnp.minimum(exit_, jnp.minimum(tmax, best_t))
        valid = ok & (rec1 < rec2) & scene.vol_active[vi]
        inside_dist = rec2 - rec1
        uv = jnp.clip(u_volume[:, vi], 1e-38, 1.0)  # log(0) guard
        hit_dist = -(1.0 / scene.vol_density[vi]) * jnp.log(uv)
        scatter = valid & (hit_dist < inside_dist)
        t = rec1 + hit_dist
        better = scatter & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_i = jnp.where(better, vi, best_i)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Full-scene closest hit
# ---------------------------------------------------------------------------

def scene_hit(
    scene: T.SceneData, rays: Rays, u_volume=None, tmin=TMIN
) -> HitRecord:
    """Closest hit over all primitive types -> full HitRecord.

    `u_volume` (N, n_volumes) uniforms drive volume free-path sampling; pass
    None for scenes without volumes (or to skip volume scattering).
    """
    n = rays.time.shape[0]
    tmax0 = jnp.full((n,), INF)

    t_s, i_s = _chunked_min(
        lambda s, c: sphere_ts(scene, rays, s, c, tmin, tmax0), scene.n_spheres, n
    )
    t_r, i_r = _chunked_min(
        lambda s, c: rect_ts(scene, rays, s, c, tmin, tmax0), scene.n_rects, n
    )
    t_t, i_t = _chunked_min(
        lambda s, c: tri_ts(scene, rays, s, c, tmin, tmax0), scene.n_tris, n
    )

    if scene.has_boxes:
        t_b, i_b = _chunked_min(
            lambda s, c: box_ts(scene, rays, s, c, tmin, tmax0),
            scene.n_boxes, n,
        )
    else:
        t_b = jnp.full((n,), INF)
        i_b = jnp.zeros((n,), jnp.int32)

    # combine surface types
    t_surf = jnp.minimum(jnp.minimum(jnp.minimum(t_s, t_r), t_t), t_b)
    ptype = jnp.where(
        t_s == t_surf,
        T.PRIM_SPHERE,
        jnp.where(
            t_r == t_surf,
            T.PRIM_RECT,
            jnp.where(t_t == t_surf, T.PRIM_TRI, T.PRIM_BOX),
        ),
    ).astype(jnp.int32)
    pidx = jnp.where(
        t_s == t_surf,
        i_s,
        jnp.where(t_r == t_surf, i_r, jnp.where(t_t == t_surf, i_t, i_b)),
    ).astype(jnp.int32)

    # volumes scatter inside [entry, min(exit, nearest surface)]
    if u_volume is not None and scene.n_volumes > 0:
        t_v, i_v = volume_ts(scene, rays, tmin, t_surf, u_volume)
        vol_wins = t_v < t_surf
        t_final = jnp.where(vol_wins, t_v, t_surf)
        ptype = jnp.where(vol_wins, T.PRIM_VOLUME, ptype)
        pidx = jnp.where(vol_wins, i_v, pidx)
    else:
        t_final = t_surf

    hit = t_final < INF
    safe_t = jnp.where(hit, t_final, 1.0)
    safe_idx = jnp.where(hit, pidx, 0)

    # phase 2: reconstruct record for the winner of each type, select by tag
    is_s = ptype == T.PRIM_SPHERE
    is_r = ptype == T.PRIM_RECT
    is_t = ptype == T.PRIM_TRI
    is_b = ptype == T.PRIM_BOX
    p_s, n_s, u_s, v_s, m_s = sphere_record(scene, rays, safe_t, jnp.where(is_s, safe_idx, 0))
    p_r, n_r, u_r, v_r, m_r = rect_record(scene, rays, safe_t, jnp.where(is_r, safe_idx, 0))
    p_t3, n_t3, u_t3, v_t3, m_t3 = tri_record(scene, rays, safe_t, jnp.where(is_t, safe_idx, 0))
    if scene.has_boxes:
        p_b, n_b, u_b, v_b, m_b = box_record(
            scene, rays, safe_t, jnp.where(is_b, safe_idx, 0))
    else:
        zb = jnp.zeros_like(safe_t)
        p_b, u_b, v_b = V3(zb, zb, zb), zb, zb
        n_b = V3(jnp.ones_like(safe_t), zb, zb)
        m_b = jnp.zeros_like(safe_t).astype(jnp.int32)

    p = rays.ro + rays.rd * safe_t
    # volume normal arbitrary (1,0,0) (volumes.cpp:29)
    n_vol = V3(jnp.ones_like(safe_t), jnp.zeros_like(safe_t), jnp.zeros_like(safe_t))
    nrm = vwhere(is_s, n_s,
                 vwhere(is_r, n_r,
                        vwhere(is_t, n_t3, vwhere(is_b, n_b, n_vol))))
    # sanitize MISS lanes: their per-type records are garbage (safe_t=1,
    # idx=0) — e.g. a far-from-sphere point gives a normal of magnitude >> 1.
    # The caller masks the VALUES, but garbage magnitudes feed masked shading
    # branches whose backward factors can overflow to inf, and scatter-adding
    # +-inf cotangents into the scene tables produces NaN gradients.
    nrm = vwhere(hit, nrm, n_vol)
    uu = jnp.where(is_s, u_s, jnp.where(is_r, u_r, jnp.where(
        is_t, u_t3, jnp.where(is_b, u_b, 0.0))))
    vv = jnp.where(is_s, v_s, jnp.where(is_r, v_r, jnp.where(
        is_t, v_t3, jnp.where(is_b, v_b, 0.0))))
    uu = jnp.where(hit, uu, 0.0)
    vv = jnp.where(hit, vv, 0.0)
    mat = jnp.where(
        is_s,
        m_s,
        jnp.where(
            is_r,
            m_r,
            jnp.where(
                is_t,
                m_t3,
                jnp.where(
                    is_b,
                    m_b,
                    lookup_cols(
                        jnp.where(ptype == T.PRIM_VOLUME, safe_idx, 0),
                        (scene.vol_mat,),
                    )[0],
                ),
            ),
        ),
    ).astype(jnp.int32)

    return HitRecord(t=t_final, p=p, n=nrm, u=uu, v=vv, mat=mat, hit=hit)
