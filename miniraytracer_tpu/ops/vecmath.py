"""Vector math core (data-parallel replacement for the reference SIMD library).

The reference implements a hand-written SSE/AVX Vec3/Vec4 library
(vec3.h, mrt_math.h). Here the "SIMD core" is ordinary jnp code over
`(..., 3)` arrays and componentwise V3 triples: XLA spreads the lanes over
the device's threads and fuses the elementwise chains. All semantics
(reflect/refract conventions, BT.709 luminance, gamma, ARGB8 packing) follow
the reference formulas: vec3.h:178-198 (reflect/refract), vec3.h:275-279
(luminance), vec3.h:327-333 (ARGB32), onb.h:19-31 (orthonormal basis).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

EPS = 1e-8


# ---------------------------------------------------------------------------
# V3: structure-of-arrays 3-vector (the device-native form)
#
# A batched (N, 3) array interleaves the components, so any op that slices
# or builds the size-3 axis (cross products, component extraction,
# stacking) reads strided memory and forces relayouts. V3 keeps x/y/z as
# three independent (N,) arrays so every op is a contiguous full-width
# elementwise pass; the (..., 3) form exists only at host boundaries
# (framebuffers, scene tables, image output).
# ---------------------------------------------------------------------------


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (componentwise; scalars broadcast) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- conversions --
    @property
    def arr(self) -> jnp.ndarray:
        """(..., 3) array form (host/frame boundary only — causes relayout)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def from_arr(a) -> "V3":
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def of(x, y, z) -> "V3":
        """V3 of (broadcastable) scalars/arrays, asarray'd."""
        return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))

    @staticmethod
    def fill(shape, cx, cy, cz, dtype=jnp.float32) -> "V3":
        return V3(
            jnp.full(shape, cx, dtype),
            jnp.full(shape, cy, dtype),
            jnp.full(shape, cz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "V3":
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vsdot(a: V3):
    return a.x * a.x + a.y * a.y + a.z * a.z


def vlength(a: V3):
    return jnp.sqrt(vsdot(a))


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vnormalize(a: V3) -> V3:
    """Safe normalize (near-zero vectors -> zero).

    The floor is 1e-20, not 0: the backward of 1/sqrt(n2) carries an
    n2^(-3/2) factor that overflows to inf for denormal lengths (e.g. the
    metal fuzz direction can cancel the reflection, reference quirk
    material.h:94 / SURVEY.md 9.8), and 0-masked-cotangent * inf = NaN.
    """
    n2 = vsdot(a)
    ok = n2 > 1e-20
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)
    return a * inv


def vwhere(mask, a: V3, b: V3) -> V3:
    """Select with an unexpanded (...,)-shaped mask."""
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def vreflect(v: V3, n: V3) -> V3:
    """v - 2*dot(v,n)*n (vec3.h:178-181)."""
    return v - n * (2.0 * vdot(v, n))


def vrefract(v: V3, n: V3, ni_over_nt):
    """Snell refraction (vec3.h:185-198), componentwise; see `refract`."""
    ncosI = vdot(v, n)
    sinT2 = (ni_over_nt * ni_over_nt) * (1.0 - ncosI * ncosI)
    ok = sinT2 <= 1.0
    # double-where with an eps margin: sqrt's backward is 1/(2 sqrt(x)), which
    # still overflows for x in (0, ~1e-38) — the TIR grazing sliver. Lanes in
    # [1-1e-9, 1] get cosT from the safe branch; measure-zero forward change.
    safe = sinT2 < 1.0 - 1e-9
    cosT = jnp.sqrt(jnp.where(safe, 1.0 - sinT2, 1.0))
    cosT = jnp.where(safe, cosT, 0.0)  # true cosT <= 3e-5 there; TIR anyway
    cosI = -ncosI
    refracted = v * ni_over_nt + n * (ni_over_nt * cosI - cosT)
    return refracted, ok


def vluminance(c: V3):
    """BT.709 luminance (vec3.h:275-279)."""
    return 0.212655 * c.x + 0.715158 * c.y + 0.072187 * c.z


def vonb_from_w(n: V3):
    """Orthonormal basis from a normalized normal (onb.h:19-23) -> (u,v,w)."""
    w = n
    big_x = jnp.abs(w.x) > 0.9
    ax = jnp.where(big_x, 0.0, 1.0)
    ay = jnp.where(big_x, 1.0, 0.0)
    a = V3(ax, ay, jnp.zeros_like(ax))
    v = vnormalize(vcross(w, a))
    u = vcross(w, v)
    return u, v, w


def vonb_l2w(u: V3, v: V3, w: V3, local: V3) -> V3:
    """onb * vec (onb.h:25-27): local.x*u + local.y*v + local.z*w."""
    return u * local.x + v * local.y + w * local.z


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector dot product over the last axis -> (...)."""
    return jnp.sum(a * b, axis=-1)


def sdot(a: jnp.ndarray) -> jnp.ndarray:
    """Squared length (reference `sdot`)."""
    return jnp.sum(a * a, axis=-1)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(sdot(a))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Normalize over the last axis. Safe for zero vectors (returns 0)."""
    n2 = sdot(a)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return a * inv[..., None]


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (vec3.h:178-181): v - 2*dot(v,n)*n."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, ni_over_nt: jnp.ndarray):
    """Snell refraction (vec3.h:185-198).

    `v` is the (normalized) incident direction, `n` the normal oriented
    *against* v (facing normal). Returns `(refracted, ok)` where `ok` is False
    on total internal reflection (then `refracted` content is unspecified but
    finite). Refracted vector is NOT normalized (matches reference).
    """
    ncosI = dot(v, n)
    sinT2 = (ni_over_nt * ni_over_nt) * (1.0 - ncosI * ncosI)
    ok = sinT2 <= 1.0
    cosT = jnp.sqrt(jnp.maximum(1.0 - sinT2, 0.0))
    cosI = -ncosI
    refracted = ni_over_nt[..., None] * v + (ni_over_nt * cosI - cosT)[..., None] * n
    return refracted, ok


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    """Relative luminance, BT.709 weights (vec3.h:275-279)."""
    w = jnp.array([0.212655, 0.715158, 0.072187], dtype=c.dtype)
    return jnp.sum(c * w, axis=-1)


def gamma_correct(c: jnp.ndarray) -> jnp.ndarray:
    """sqrt gamma (vec3.h gamma_correct)."""
    return jnp.sqrt(jnp.maximum(c, 0.0))


def argb32(c: jnp.ndarray) -> jnp.ndarray:
    """Pack float RGB in [0,1] into uint32 0xAARRGGBB (vec3.h:327-333).

    Clamps to 1.0 and scales by 255.99 like the reference.
    """
    v = jnp.clip(c, 0.0, 1.0) * 255.99
    v = v.astype(jnp.uint32)
    a = jnp.uint32(0xFF) << 24
    return a | (v[..., 0] << 16) | (v[..., 1] << 8) | v[..., 2]


def onb_from_w(n: jnp.ndarray):
    """Orthonormal basis from a (normalized) normal (onb.h:19-23).

    Returns (u, v, w) with w = n.
    """
    w = n
    a = jnp.where(
        (jnp.abs(w[..., 0]) > 0.9)[..., None],
        jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
        jnp.array([1.0, 0.0, 0.0], dtype=n.dtype),
    )
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local_to_world(u, v, w, vec):
    """onb * vec (onb.h:25-27): vec.x*u + vec.y*v + vec.z*w."""
    return vec[..., 0:1] * u + vec[..., 1:2] * v + vec[..., 2:3] * w


# ---------------------------------------------------------------------------
# Polynomial inverse trig: cephes atanf (odd minimax over three ranges).
# sphere_record's texture uv uses THESE rather than the backend's own
# atan2/asin, so texel quantization is the same on every backend. Max abs error
# vs libm ~1e-7 rad (well under one texel: 2pi/1024 ~ 6e-3).
# Pullback-safe by construction: every division has a selected-away safe
# denominator, so 0-cotangent lanes cannot mint NaN under jax.vjp replay.
# ---------------------------------------------------------------------------


def vatan(x):
    """Elementwise arctan via cephes atanf range reduction + 4-term poly."""
    ax = jnp.abs(x)
    big = ax > 2.414213562373095  # tan(3pi/8)
    mid = (ax > 0.4142135623730951) & ~big  # tan(pi/8)
    safe_big = jnp.where(big, ax, 1.0)
    x1 = jnp.where(big, -1.0 / safe_big,
                   jnp.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = jnp.where(big, jnp.float32(jnp.pi / 2),
                   jnp.where(mid, jnp.float32(jnp.pi / 4), 0.0))
    z = x1 * x1
    p = ((((8.05374449538e-2 * z - 1.38776856032e-1) * z
           + 1.99777106478e-1) * z - 3.33329491539e-1) * z * x1 + x1)
    return jnp.sign(x) * (y0 + p)


def vatan2(y, x):
    """Elementwise atan2 with C quadrant semantics; (0, 0) -> 0."""
    safe_x = jnp.where(x == 0.0, 1.0, x)
    base = vatan(y / safe_x)
    pi = jnp.float32(jnp.pi)
    half = jnp.float32(jnp.pi / 2)
    return jnp.where(
        x > 0.0, base,
        jnp.where(x < 0.0,
                  jnp.where(y >= 0.0, base + pi, base - pi),
                  jnp.where(y > 0.0, half,
                            jnp.where(y < 0.0, -half, 0.0 * base))))


def vasin(y):
    """Elementwise arcsin on [-1, 1] via atan2(y, sqrt(1-y^2)); the 1e-30
    floor keeps sqrt's pullback finite at |y| == 1 without moving the f32
    forward value off +-pi/2."""
    yc = jnp.clip(y, -1.0, 1.0)
    return vatan2(yc, jnp.sqrt(jnp.maximum(1.0 - yc * yc, 1e-30)))
