"""Per-ray table lookups: `table[idx]` over parallel table columns.

On the GPU a dynamic gather is a native load per lane, so a lookup is a
plain gather; its gradient w.r.t. the table is the matching scatter-add.
"""

from __future__ import annotations

import jax.numpy as jnp

from miniraytracer_tpu.ops.vecmath import V3


def lookup_cols(idx: jnp.ndarray, cols):
    """Row lookup over parallel table columns.

    idx: (N,) integer indices into tables of length K.
    cols: sequence of (K,) arrays (float/int/bool — any mix).
    Returns a tuple of (N,) arrays with the original dtypes.
    """
    return tuple(jnp.asarray(c)[idx] for c in cols)


def lookup_v3_table(idx: jnp.ndarray, table: jnp.ndarray) -> V3:
    """(K, 3) table -> V3 of (N,) components."""
    x, y, z = lookup_cols(idx, (table[:, 0], table[:, 1], table[:, 2]))
    return V3(x, y, z)
