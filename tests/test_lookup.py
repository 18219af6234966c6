"""lookup_cols: a plain gather that keeps each column's dtype, and whose
gradient w.r.t. the table is the matching scatter-add."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniraytracer_tpu.ops import lookup


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32, np.bool_])
def test_lookup_cols_gather_keeps_dtype(dtype):
    rng = np.random.default_rng(0)
    k = 3000
    col = rng.integers(0, 2**20, k).astype(dtype)
    other = rng.standard_normal(k).astype(np.float32)
    idx = rng.integers(0, k, 4096).astype(np.int32)
    got, got_other = lookup.lookup_cols(jnp.asarray(idx),
                                        (jnp.asarray(col), jnp.asarray(other)))
    assert got.dtype == jnp.dtype(dtype) and got_other.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got), col[idx])
    np.testing.assert_array_equal(np.asarray(got_other), other[idx])


def test_lookup_cols_differentiable_wrt_table():
    col = jnp.arange(8, dtype=jnp.float32)
    idx = jnp.asarray([1, 1, 3], jnp.int32)

    def f(c):
        (out,) = lookup.lookup_cols(idx, (c,))
        return jnp.sum(out * jnp.asarray([1.0, 2.0, 4.0]))

    g = jax.grad(f)(col)
    np.testing.assert_allclose(np.asarray(g), [0, 3, 0, 4, 0, 0, 0, 0])


def test_lookup_v3_table_rows():
    table = jnp.arange(12, dtype=jnp.float32).reshape(4, 3)
    v = lookup.lookup_v3_table(jnp.asarray([3, 0], jnp.int32), table)
    np.testing.assert_array_equal(np.asarray(v.x), [9, 0])
    np.testing.assert_array_equal(np.asarray(v.y), [10, 1])
    np.testing.assert_array_equal(np.asarray(v.z), [11, 2])
