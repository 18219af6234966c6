"""Counter-based stateless RNG + sampling routines.

The reference uses thread-local mutable PCG32 streams (pcg.cpp:40-46) and
rejection-sampling loops (pcg.cpp:70-80, 112-119). Neither maps to a
data-parallel device: mutable per-lane state breaks functional tracing and rejection loops have
unbounded trip counts. Instead every random draw is a *pure function* of
integer counters `(stream, bounce, slot)` — reproducible independent of
sharding, batching or schedule — and the rejection samplers are replaced by
exact analytic equivalents (polar disk, inverse-CDF ball radius), which
produce the same distributions with a fixed op count.

Hash core: 32-bit PCG-RXS-M-XS output permutation over an LCG-mixed counter
(same family as the reference's PCG32, pcg.cpp:13-26, but keyed/stateless).

Sampling formula parity with the reference:
- `sample_cosine_direction` replicates the *non-normalized* reference variant
  (pcg.cpp:87-98 — note the extra factor 2 on x/y; documented quirk pcg.h:15).
  Callers normalize, as the reference ray constructor does (ray.h:30).
- `sample_on_sphere` matches pcg.cpp:102-110.
- `sample_towards_sphere` matches pcg.cpp:125-136.
- `sample_in_disk`/`sample_in_ball` are analytic but distribution-identical to
  the reference's rejection loops.
"""

from __future__ import annotations

import jax.numpy as jnp

from miniraytracer_tpu.ops.vecmath import V3

PI = 3.14159265358979323846

_M1 = jnp.uint32(0x9E3779B1)  # golden-ratio Weyl constant
_M2 = jnp.uint32(0x85EBCA77)
_M3 = jnp.uint32(0xC2B2AE3D)


def pcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """PCG-RXS-M-XS 32-bit output permutation over an LCG step.

    Statistically strong single-word integer hash (O'Neill, pcg-random.org).
    """
    x = x.astype(jnp.uint32)
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def fold(key: jnp.ndarray, data) -> jnp.ndarray:
    """Mix an integer into a key, producing a new independent key."""
    d = jnp.asarray(data).astype(jnp.uint32)
    return pcg_hash(key.astype(jnp.uint32) * _M1 + d * _M2 + _M3)


def ray_key(pixel_id, sample_id) -> jnp.ndarray:
    """Root key for one (pixel, sample) ray path — sharding-independent."""
    p = jnp.asarray(pixel_id).astype(jnp.uint32)
    s = jnp.asarray(sample_id).astype(jnp.uint32)
    return pcg_hash(pcg_hash(p * _M1 + jnp.uint32(0x1234567)) + s * _M2)


def bits(key: jnp.ndarray, slot) -> jnp.ndarray:
    """Random uint32 for draw number `slot` under `key`."""
    s = jnp.asarray(slot).astype(jnp.uint32)
    return pcg_hash(key.astype(jnp.uint32) + s * _M3)


def uniform(key: jnp.ndarray, slot) -> jnp.ndarray:
    """float32 in [0, 1) via the mantissa bit trick (pcg.cpp:53-65)."""
    b = bits(key, slot)
    f = (b & jnp.uint32(0x007FFFFF)) | jnp.uint32(0x3F800000)
    return jnp.asarray(f).view(jnp.float32) - 1.0


def uniform2(key, slot):
    return uniform(key, slot), uniform(key, jnp.asarray(slot) + 1)


def uniform3(key, slot):
    return (
        uniform(key, slot),
        uniform(key, jnp.asarray(slot) + 1),
        uniform(key, jnp.asarray(slot) + 2),
    )


# ---------------------------------------------------------------------------
# Direction / point samplers. All take pre-drawn uniforms so callers control
# slot accounting; all return componentwise V3 (SoA — see vecmath.V3).
# ---------------------------------------------------------------------------


def sample_cosine_direction(r1, r2) -> V3:
    """Reference cosine-ish lobe sample in local (u,v,w) frame.

    Replicates pcg.cpp:87-98 exactly, including the non-unit length (factor 2
    on x/y): after normalization the directional distribution differs from the
    textbook cosine lobe, and the reference's estimator uses it as-is — we
    reproduce it for image parity (documented quirk, pcg.h:15-17).
    """
    z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = 2.0 * jnp.sqrt(r2)
    return V3(jnp.cos(phi) * sq, jnp.sin(phi) * sq, z)


def sample_cosine_direction_exact(r1, r2) -> V3:
    """Textbook cosine-weighted hemisphere sample (unit length, density
    cos(theta)/pi). Opt-in alternative to the reference-compat variant above:
    the reference's extra factor 2 skews its lobe so that *material-pdf-only*
    estimates are ~4x too dark for overhead lights (verified numerically);
    with light-list mixture sampling both variants agree closely."""
    z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = jnp.sqrt(r2)
    return V3(jnp.cos(phi) * sq, jnp.sin(phi) * sq, z)


def sample_on_sphere(r1, r2) -> V3:
    """Uniform direction on the unit sphere (pcg.cpp:102-110)."""
    x = r1 * 2.0 - 1.0
    phi = r2 * 2.0 * PI
    s = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
    return V3(x, jnp.cos(phi) * s, jnp.sin(phi) * s)


def sample_in_ball(r1, r2, r3) -> V3:
    """Uniform point in the unit ball.

    Analytic replacement for the reference rejection loop (pcg.cpp:70-80):
    uniform direction scaled by cbrt-distributed radius — identical
    distribution, fixed op count.
    """
    d = sample_on_sphere(r1, r2)
    return d * jnp.cbrt(r3)


def sample_in_disk(r1, r2) -> V3:
    """Uniform point in the unit disk (z=0).

    Analytic replacement for pcg.cpp:112-119's rejection loop.
    """
    rad = jnp.sqrt(r1)
    phi = 2.0 * PI * r2
    return V3(rad * jnp.cos(phi), rad * jnp.sin(phi), jnp.zeros_like(r1))


def sample_towards_sphere(radius, dist_sq, r1, r2) -> V3:
    """Cone sample towards a sphere of `radius` at squared distance `dist_sq`
    in local frame with +z towards the center (pcg.cpp:125-136).

    radius/dist_sq may be differentiated scene params — sqrt args are
    double-where'd so masked/degenerate lanes keep finite backward."""
    frac = jnp.clip(1.0 - radius * radius / jnp.maximum(dist_sq, 1e-30), 0.0, 1.0)
    f_ok = frac > 1e-12  # eps margins: sqrt backward overflows below them
    sq_frac = jnp.where(f_ok, jnp.sqrt(jnp.where(f_ok, frac, 1.0)), 0.0)
    z = 1.0 + r2 * (sq_frac - 1.0)
    phi = 2.0 * PI * r1
    z2 = z * z
    z_ok = z2 < 1.0 - 1e-12
    s = jnp.where(z_ok, jnp.sqrt(jnp.where(z_ok, 1.0 - z2, 1.0)), 0.0)
    return V3(jnp.cos(phi) * s, jnp.sin(phi) * s, z)


# ---------------------------------------------------------------------------
# Exact PCG32 (two-word u64 emulation) — for bit-compat mode against the
# reference's deterministic single-thread configuration (-mode 0 -threads 1).
# Host-side scene generation also uses this to replicate the fixed-seed
# scene layouts (main.cpp:302, scene.cpp random placements).
# ---------------------------------------------------------------------------

_PCG_MULT = 6364136223846793005
_PCG_MASK = (1 << 64) - 1


class Pcg32:
    """Exact PCG32 (XSH-RR) — Python ints, host-side only.

    Mirrors pcg32_random_r / pcg32_srandom_r (pcg.cpp:13-37) for scene-gen
    determinism parity: the reference seeds its main thread with fixed
    constants (main.cpp:302) so object placement is reproducible.
    """

    def __init__(self, initstate: int, initseq: int, raw: bool = False):
        if raw:
            # pre-main static G_rng: struct-initialized, no srandom warmup
            self.state = initstate & _PCG_MASK
            self.inc = initseq & _PCG_MASK
        else:
            self.state = 0
            self.inc = ((initseq << 1) | 1) & _PCG_MASK
            self.rand32()
            self.state = (self.state + initstate) & _PCG_MASK
            self.rand32()

    def rand32(self) -> int:
        old = self.state
        self.state = (old * _PCG_MULT + self.inc) & _PCG_MASK
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF

    def randf(self) -> float:
        """float in [0,1) via the same mantissa trick (pcg.cpp:53-65)."""
        import struct

        bits32 = 0x3F800000 | (self.rand32() & 0x007FFFFF)
        return struct.unpack("<f", struct.pack("<I", bits32))[0] - 1.0

    def in_ball(self):
        """random_in_sphere rejection loop (pcg.cpp:70-80), bit-faithful.

        NOTE draw order: `Vec3(randf(), randf(), randf())` — C++ argument
        evaluation is right-to-left under MSVC and GCC, so the FIRST draw
        lands in z, then y, then x (verified against the headless reference
        build; this is what makes the Perlin field bit-match)."""
        while True:
            z = 2.0 * self.randf() - 1.0
            y = 2.0 * self.randf() - 1.0
            x = 2.0 * self.randf() - 1.0
            if x * x + y * y + z * z < 1.0:
                return (x, y, z)
