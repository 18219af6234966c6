"""Flattened-BVH ray traversal (vectorized, masked, stack-based).

The device-side counterpart of the native builder (csrc/bvh.cpp /
utils.runtime.bvh_build): a `lax.while_loop` where every ray carries its own
short stack and current node, all lanes stepping in lockstep with masked
updates. Node visits are ordered by the ray's direction octant using the
builder's precomputed order codes (the reference's `node_order & dirMask`
trick, scene_object.h:224-231 / triangle.h:282-322), and — unlike the
reference, which early-returns on ANY closer-child hit (quirk SURVEY.md
9.1) — traversal is exact: a subtree is culled only when its slab entry
exceeds the current best t.

Status: a correctness-verified component (tests/test_bvh.py), not yet on
the render path. The renderers sweep every primitive per bounce, which is
O(primitives) per ray; per-ray traversal of this BVH is the O(log n)
answer for large scenes on the GPU, where a node fetch is a native
per-lane load. Its speed on the H100 is not measured.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from miniraytracer_tpu.ops import intersect as ix
from miniraytracer_tpu.ops.lookup import lookup_cols
from miniraytracer_tpu.ops.vecmath import V3
from miniraytracer_tpu.scene import types as T

INF = jnp.float32(3.0e38)
MAX_STACK = 48  # depth bound: balanced tree of 2^24 prims fits


class BVH(NamedTuple):
    """Flat BVH over the scene's triangle table (device-resident)."""

    bmin: jnp.ndarray  # (M,3)
    bmax: jnp.ndarray  # (M,3)
    left: jnp.ndarray  # (M,) i32; leaf: -1
    first: jnp.ndarray  # (M,) i32 into prim_order
    count: jnp.ndarray  # (M,) i32; 0 = interior
    order: jnp.ndarray  # (M,) i32 8-octant left-first bits
    prim_order: jnp.ndarray  # (n,) i32 triangle row permutation
    leaf_size: int  # static


def build_tri_bvh(scene: T.SceneData, leaf_size: int = 4) -> BVH | None:
    """Host-side build over the ACTIVE triangles (native csrc builder)."""
    from miniraytracer_tpu.utils import runtime as rt

    m = np.asarray(scene.tri_m)
    u = np.asarray(scene.tri_u)
    v = np.asarray(scene.tri_v)
    active = np.asarray(scene.tri_active)
    if not active.any():
        return None
    a = m
    b = m + u
    c = m + v
    bmin = np.minimum(np.minimum(a, b), c)
    bmax = np.maximum(np.maximum(a, b), c)
    # inactive rows: collapse to a far-away point so they land in one leaf
    far = np.float32(1e30)
    bmin[~active] = far
    bmax[~active] = far
    nb, nm, po = rt.bvh_build(bmin, bmax, leaf_size=leaf_size)
    return BVH(
        bmin=jnp.asarray(nb[:, :3]),
        bmax=jnp.asarray(nb[:, 3:]),
        left=jnp.asarray(nm[:, 0]),
        first=jnp.asarray(nm[:, 1]),
        count=jnp.asarray(nm[:, 2]),
        order=jnp.asarray(nm[:, 3]),
        prim_order=jnp.asarray(po),
        leaf_size=leaf_size,
    )


class _Trav(NamedTuple):
    stack: jnp.ndarray  # (N, MAX_STACK) i32
    sp: jnp.ndarray  # (N,) i32 stack pointer
    node: jnp.ndarray  # (N,) i32 current node (-1 = pop next)
    best_t: jnp.ndarray
    best_i: jnp.ndarray
    active: jnp.ndarray  # (N,) bool lane still traversing


def _node_cols(bvh: BVH, idx):
    cols = lookup_cols(
        idx,
        (
            bvh.bmin[:, 0], bvh.bmin[:, 1], bvh.bmin[:, 2],
            bvh.bmax[:, 0], bvh.bmax[:, 1], bvh.bmax[:, 2],
            bvh.left, bvh.first, bvh.count, bvh.order,
        ),
    )
    return cols


def bvh_tri_hit(bvh: BVH, scene: T.SceneData, rays: ix.Rays, tmin=ix.TMIN):
    """Closest triangle hit via BVH traversal. Returns (t, idx) like the
    brute-force sweep (INF on miss)."""
    n = rays.time.shape[0]
    inv = V3(
        1.0 / jnp.where(jnp.abs(rays.rd.x) > 1e-30, rays.rd.x, 1e-30),
        1.0 / jnp.where(jnp.abs(rays.rd.y) > 1e-30, rays.rd.y, 1e-30),
        1.0 / jnp.where(jnp.abs(rays.rd.z) > 1e-30, rays.rd.z, 1e-30),
    )
    # 3-bit direction octant (ray.h:20-27): bit k set when dir[k] < 0
    octant = (
        (rays.rd.x < 0).astype(jnp.int32)
        + 2 * (rays.rd.y < 0).astype(jnp.int32)
        + 4 * (rays.rd.z < 0).astype(jnp.int32)
    )

    def slab(bx0, by0, bz0, bx1, by1, bz1, best_t):
        tx0 = (bx0 - rays.ro.x) * inv.x
        tx1 = (bx1 - rays.ro.x) * inv.x
        ty0 = (by0 - rays.ro.y) * inv.y
        ty1 = (by1 - rays.ro.y) * inv.y
        tz0 = (bz0 - rays.ro.z) * inv.z
        tz1 = (bz1 - rays.ro.z) * inv.z
        enter = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.minimum(tz0, tz1),
        )
        exit_ = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.maximum(tz0, tz1),
        )
        # strict test like aabb.h:76, plus cull beyond current best
        return (exit_ > jnp.maximum(enter, tmin)) & (enter < best_t) & (exit_ > tmin)

    def leaf_intersect(first, count, best_t, best_i):
        """Masked per-slot intersection of up to leaf_size prims."""
        for k in range(bvh.leaf_size):
            in_leaf = k < count
            slot = jnp.clip(first + k, 0, bvh.prim_order.shape[0] - 1)
            (tri_idx,) = lookup_cols(slot, (bvh.prim_order,))
            (mx, my, mz, ux, uy, uz, vx, vy, vz, act) = lookup_cols(
                tri_idx,
                (
                    scene.tri_m[:, 0], scene.tri_m[:, 1], scene.tri_m[:, 2],
                    scene.tri_u[:, 0], scene.tri_u[:, 1], scene.tri_u[:, 2],
                    scene.tri_v[:, 0], scene.tri_v[:, 1], scene.tri_v[:, 2],
                    scene.tri_active,
                ),
            )
            # Moller-Trumbore (triangle.cpp:221-264), componentwise
            px = rays.rd.y * vz - rays.rd.z * vy
            py = rays.rd.z * vx - rays.rd.x * vz
            pz = rays.rd.x * vy - rays.rd.y * vx
            det = ux * px + uy * py + uz * pz
            sign = jnp.where((rays.inside > 0) & (det < 0.0), -1.0, 1.0)
            sdet = det * sign
            tx = rays.ro.x - mx
            ty = rays.ro.y - my
            tz = rays.ro.z - mz
            uu = (tx * px + ty * py + tz * pz) * sign
            qx = ty * uz - tz * uy
            qy = tz * ux - tx * uz
            qz = tx * uy - ty * ux
            vv = (rays.rd.x * qx + rays.rd.y * qy + rays.rd.z * qz) * sign
            tval = (vx * qx + vy * qy + vz * qz) / jnp.where(
                jnp.abs(det) > ix.TRI_EPS, det, 1.0
            )
            ok = (
                in_leaf
                & act
                & (sdet >= ix.TRI_EPS)
                & (uu >= 0) & (uu <= sdet)
                & (vv >= 0) & (uu + vv <= sdet)
                & (tval >= tmin) & (tval < best_t)
            )
            best_i = jnp.where(ok, tri_idx, best_i)
            best_t = jnp.where(ok, tval, best_t)
        return best_t, best_i

    state = _Trav(
        stack=jnp.zeros((n, MAX_STACK), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        node=jnp.zeros((n,), jnp.int32),  # start at root
        best_t=jnp.full((n,), INF),
        best_i=jnp.zeros((n,), jnp.int32),
        active=jnp.ones((n,), bool),
    )

    def cond(s):
        return jnp.any(s.active)

    def body(s):
        idx = jnp.maximum(s.node, 0)
        (bx0, by0, bz0, bx1, by1, bz1, left, first, count, order) = _node_cols(bvh, idx)
        hit_box = slab(bx0, by0, bz0, bx1, by1, bz1, s.best_t) & s.active & (s.node >= 0)
        is_leaf = count > 0

        # leaves: masked prim tests
        do_leaf = hit_box & is_leaf
        bt, bi = leaf_intersect(
            jnp.where(do_leaf, first, 0), jnp.where(do_leaf, count, 0),
            s.best_t, s.best_i,
        )

        # interior: near child continues, far child pushed
        go_in = hit_box & ~is_leaf
        left_first = ((order >> octant) & 1) > 0
        near = jnp.where(left_first, left, left + 1)
        far = jnp.where(left_first, left + 1, left)
        stack = s.stack
        push = go_in
        stack = stack.at[jnp.arange(n), jnp.clip(s.sp, 0, MAX_STACK - 1)].set(
            jnp.where(push, far, stack[jnp.arange(n), jnp.clip(s.sp, 0, MAX_STACK - 1)])
        )
        sp = jnp.where(push, jnp.minimum(s.sp + 1, MAX_STACK), s.sp)

        # next node: near child if descending, else pop
        can_pop = sp > 0
        popped = stack[jnp.arange(n), jnp.clip(sp - 1, 0, MAX_STACK - 1)]
        node = jnp.where(
            go_in, near, jnp.where(can_pop, popped, -1)
        )
        sp = jnp.where(go_in, sp, jnp.where(can_pop, sp - 1, sp))
        active = s.active & (node >= 0)
        return _Trav(stack=stack, sp=sp, node=node, best_t=bt, best_i=bi, active=active)

    state = jax.lax.while_loop(cond, body, state)
    return state.best_t, state.best_i
