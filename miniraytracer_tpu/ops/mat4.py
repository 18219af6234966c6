"""4x4 matrix library (column-major, like the reference's mat4.h/.cpp).

The reference hand-writes AVX-256 multiply, a full SIMD inverse, and a set
of transform builders (mat4.cpp:13-253). Here the SIMD layer IS XLA, so
these are ordinary jnp ops — batched (stack leading axes) and
differentiable. Column-major convention matches the reference: columns are
`m[:, j]`; `apply_point/apply_vector` multiply column vectors.

Used by the host scene compiler for OBJ transforms and available as a
user-facing math utility (the reference exposes Mat4 publicly).
"""

from __future__ import annotations

import jax.numpy as jnp


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def matmul(a, b):
    """a @ b for column-major 4x4 (mat4.h operator*, AVX path mat4.cpp)."""
    return a @ b


def transpose(m):
    return jnp.swapaxes(m, -1, -2)


def invert(m):
    """Full inverse (mat4.cpp:13-127's SIMD cofactor expansion -> jnp)."""
    return jnp.linalg.inv(m)


def translate(t):
    """mat4 Translate builder."""
    t = jnp.asarray(t, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(t)


def scale(s):
    """Uniform or per-axis scale."""
    s = jnp.asarray(s, jnp.float32)
    if s.ndim == 0:
        s = jnp.stack([s, s, s])
    return jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))


def scale_axis(factor, axis):
    """Scale by `factor` along unit direction `axis` (mat4.cpp:179-190):
    M = I + (factor-1) * axis axis^T."""
    a = jnp.asarray(axis, jnp.float32)
    a = a / jnp.linalg.norm(a)
    m3 = jnp.eye(3, dtype=jnp.float32) + (factor - 1.0) * jnp.outer(a, a)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(m3)


def reflect(axis):
    """Reflection across the plane with unit normal `axis`: scale -1."""
    return scale_axis(-1.0, axis)


def involution(axis):
    """Point reflection through the axis line (mat4 Involution):
    M = 2 aa^T - I."""
    a = jnp.asarray(axis, jnp.float32)
    a = a / jnp.linalg.norm(a)
    m3 = 2.0 * jnp.outer(a, a) - jnp.eye(3, dtype=jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(m3)


def _axis_rot(c, s, axis):
    if axis == 0:
        r = [[1, 0, 0], [0, c, -s], [0, s, c]]
    elif axis == 1:
        r = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    else:
        r = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(jnp.asarray(r, jnp.float32))


def rotate_x(rad):
    return _axis_rot(jnp.cos(rad), jnp.sin(rad), 0)


def rotate_y(rad):
    """Matches the reference rotate_y object transform sense
    (scene_object.cpp:85-92: x' = c x + s z, z' = c z - s x)."""
    return _axis_rot(jnp.cos(rad), jnp.sin(rad), 1)


def rotate_z(rad):
    return _axis_rot(jnp.cos(rad), jnp.sin(rad), 2)


def rotate_axis(rad, axis):
    """Rodrigues rotation about unit `axis` (mat4.cpp Rotate)."""
    a = jnp.asarray(axis, jnp.float32)
    a = a / jnp.linalg.norm(a)
    c, s = jnp.cos(rad), jnp.sin(rad)
    x, y, z = a[0], a[1], a[2]
    k = jnp.asarray([[0, -z, y], [z, 0, -x], [-y, x, 0]], jnp.float32)
    m3 = c * jnp.eye(3, dtype=jnp.float32) + s * k + (1 - c) * jnp.outer(a, a)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(m3)


def apply_point(m, p):
    """Transform points (..., 3) with w = 1."""
    p = jnp.asarray(p, jnp.float32)
    return p @ m[:3, :3].T + m[:3, 3]


def apply_vector(m, v):
    """Transform directions (..., 3) with w = 0."""
    v = jnp.asarray(v, jnp.float32)
    return v @ m[:3, :3].T


def apply_normal(m, n):
    """Transform normals: inverse-transpose rule (obj_loader.cpp:117-119
    uses the inverse rotation for pure rotations)."""
    inv3 = jnp.linalg.inv(m[:3, :3])
    return jnp.asarray(n, jnp.float32) @ inv3
