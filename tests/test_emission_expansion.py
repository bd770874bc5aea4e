"""The scan's emission expansion H @ EA @ H^T against the gather form.

H is the exact 0/1 path->allele one-hot, so each output element sums
one nonzero product: the expansion must equal the gather bitwise for
normal floats (a matmul may flush subnormals to zero). It runs at
Precision.HIGHEST, which keeps it bitwise on a GPU too (a TF32 matmul
would round EA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pangenie_tpu.hmm.forward_backward import (
    _expand_state_emission,
    _gather_state_emission,
)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("A,P", [(2, 32), (3, 15), (8, 64)])
def test_expansion_bitwise_equals_gather(dtype, A, P):
    rng = np.random.default_rng(A * 1000 + P)
    # values across many binades (all normal floats) and exact zeros
    ea = (rng.random((A, A)) + 0.1) * 10.0 ** rng.integers(-30, 3, (A, A))
    ea[0, -1] = 0.0
    ea = jnp.asarray(ea.astype(dtype))
    allele_local = jnp.asarray(rng.integers(0, A, P).astype(np.int32))
    one_hot = jax.nn.one_hot(allele_local, A, dtype=ea.dtype)
    got = jax.jit(_expand_state_emission)(ea, one_hot)
    want = jax.jit(_gather_state_emission)(ea, allele_local)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
