"""Forward-backward pair HMM as two Pallas kernels for the GPU (Triton).

The XLA formulation (forward_backward.py) is a ``lax.scan`` over N
columns: every step launches a few small kernels for about a thousand
floats of work per problem, so it is bound by per-step latency. Here
one program per HMM problem walks all N columns in a loop inside the
kernel, with the [P, P] state carry held on chip:

- forward:  alphas [B, N, PP, PP] and the normalisation sums c [B, N];
- backward: runs over the stored alphas in reverse and collapses each
  column's raw posterior to allele pairs in-kernel, [B, N, AP, AP].

P is padded to PP, a power of two (Triton's block shapes); the padded
states have emission 0, are masked out of every sum and of the uniform
underflow fallback, so real states see exactly the unpadded recurrence.
The emission expansion E[p, q] = EA[al[p], al[q]] is a gather load of
the column's [A, A] row (the form the XLA scan's one-hot matmul equals
bitwise for normal floats).

Semantics match forward_backward.forward_backward column for column
(reference src/hmm.cpp:175-405): per-column sum normalisation with the
underflow -> uniform fallback, is_first/is_last boundary handling, raw
posterior = alpha * cur * c_fwd. Results agree with the XLA scan up to
f32 reduction-order rounding (the transition mix is regrouped, see
``_factor_trans``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .forward_backward import ColumnArrays, _allele_emissions


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def num_warps(pp: int) -> int:
    """Warps per program: about sixteen [PP, PP] elements per thread.

    On an H100 at the bench shape (B=128, N=4096) 2 warps at PP=32 ran
    12.6 ms against 15.2 ms with 4 and 18.0 ms with 8; at PP=64, 8 warps
    ran 15.8 ms against 19.2 ms with 16 (N=2048)."""
    return max(1, min(16, pp * pp // 512))


def _factor_trans(trans):
    """[..., N, 3] (t0, t1, t2) -> (u0, u1, u2) with u[0] = (1, 0, 0).

    prev = t0*c + t1*(h_i+h_j-2c) + t2*(h-h_i-h_j+c) regroups to
    u0*c + u1*(h_i+h_j) + u2*h with u0 = t0-2*t1+t2, u1 = t1-t2,
    u2 = t2. Pinning the first column to the identity mix and starting
    the carry at ones gives that column's all-ones prev
    (src/hmm.cpp:236-239) without a per-column select."""
    t0, t1, t2 = trans[..., 0], trans[..., 1], trans[..., 2]
    u = jnp.stack([t0 - 2.0 * t1 + t2, t1 - t2, t2], axis=-1)
    return u.at[..., 0, :].set(jnp.asarray([1.0, 0.0, 0.0], u.dtype))


def _state_mask(P: int, PP: int):
    valid = jax.lax.broadcasted_iota(jnp.int32, (PP,), 0) < P
    return (valid[:, None] & valid[None, :]).astype(jnp.float32)


def _emission(ea_ref, al_ref, n, A: int, mask):
    """Column n's [PP, PP] state emission, gathered from its [A*A] row."""
    al = jnp.maximum(al_ref[n, :], 0)            # padded states -> 0
    idx = al[:, None] * A + al[None, :]
    return ea_ref[n, idx] * mask


def _mix(carry, u_ref, n):
    """Rank-1 transition mix in factored form (see _factor_trans)."""
    h_i = jnp.sum(carry, axis=1, keepdims=True)   # [PP, 1]
    h_j = jnp.sum(carry, axis=0, keepdims=True)   # [1, PP]
    h = jnp.sum(h_i)
    return u_ref[n, 0] * carry + u_ref[n, 1] * (h_i + h_j) + u_ref[n, 2] * h


def _normalize(cur, mask, P: int):
    """(cur / sum, sum), or (uniform over real states, 1) when the
    column underflowed to zero (src/hmm.cpp:253-267)."""
    s = jnp.sum(cur)
    pos = s > 0
    safe = jnp.where(pos, s, 1.0)
    return jnp.where(pos, cur / safe, mask * (1.0 / (P * P))), safe


def _collapse(post, al, A: int, AP: int, PP: int):
    """Raw [PP, PP] posterior -> [AP, AP] allele pairs, in 2-D steps:
    rows_a[q] = sum_{p: al[p]=a} post[p, q], then
    out[a, c] = sum_{q: al[q]=c} rows_a[q]."""
    c_ids = jax.lax.broadcasted_iota(jnp.int32, (AP, PP), 0)
    onehot = (al[None, :] == c_ids).astype(jnp.float32)          # [AP, PP]
    a_ids = jax.lax.broadcasted_iota(jnp.int32, (AP, AP), 0)
    out = jnp.zeros((AP, AP), jnp.float32)
    for a in range(A):
        hit = (al == a).astype(jnp.float32)
        row = jnp.sum(hit[:, None] * post, axis=0)                # [PP]
        pairs = jnp.sum(row[None, :] * onehot, axis=1)            # [AP]
        out = out + jnp.where(a_ids == a, pairs[None, :], 0.0)
    return out


def _fwd_kernel(ea_ref, al_ref, u_ref, alpha_ref, c_ref,
                *, N: int, P: int, PP: int, A: int):
    mask = _state_mask(P, PP)

    def body(n, carry):
        cur = _mix(carry, u_ref, n) * _emission(ea_ref, al_ref, n, A, mask)
        alpha, c = _normalize(cur, mask, P)
        alpha_ref[n, :, :] = alpha
        c_ref[n] = c
        return alpha

    jax.lax.fori_loop(0, N, body, jnp.ones((PP, PP), jnp.float32))


def _bwd_kernel(alpha_ref, c_ref, ea_ref, al_ref, u_ref, last_ref, post_ref,
                *, N: int, P: int, PP: int, A: int, AP: int):
    mask = _state_mask(P, PP)

    def body(r, beta):
        n = N - 1 - r
        # successor column; the final column's is clamped (its value is
        # discarded: is_last re-seeds the recurrence at or before it)
        nxt = jnp.minimum(n + 1, N - 1)
        helper = beta * _emission(ea_ref, al_ref, nxt, A, mask)
        mixed = _mix(helper, u_ref, nxt)
        cur = jnp.where(last_ref[n] > 0, 1.0, mixed) * mask
        beta_new, _ = _normalize(cur, mask, P)
        post = alpha_ref[n, :, :] * cur * c_ref[n]          # [PP, PP]
        post_ref[n, :, :] = _collapse(post, al_ref[n, :], A, AP, PP)
        return beta_new

    jax.lax.fori_loop(0, N, body, jnp.zeros((PP, PP), jnp.float32))


@partial(jax.jit, static_argnames=("interpret",))
def forward_backward_batch_pallas(columns: ColumnArrays,
                                  interpret: bool = False):
    """Kernel version of ``jax.vmap(forward_backward)``.

    Args:
      columns: ColumnArrays with leading dims [B, N, ...], float32.
      interpret: run the kernels in Pallas interpret mode (CPU tests).

    Returns:
      (posteriors [B, N, A, A], log_correction [B, N]) matching
      :func:`forward_backward` up to f32 reduction-order rounding.
    """
    B, N, P = columns.alleles.shape
    A = columns.incidence.shape[3]
    PP, AP = _pow2(P), _pow2(A)
    f32 = jnp.float32

    ea = jax.vmap(_allele_emissions)(columns).astype(f32).reshape(B, N, A * A)
    al = jnp.pad(columns.allele_local.astype(jnp.int32),
                 [(0, 0), (0, 0), (0, PP - P)], constant_values=-1)
    u = _factor_trans(columns.trans.astype(f32))
    last = columns.is_last.astype(jnp.int32)

    params = plt.CompilerParams(num_warps=num_warps(PP), num_stages=2)

    def spec(*block):
        return pl.BlockSpec((None,) + block,
                            lambda b: (b,) + (0,) * len(block))

    # the package enables x64 globally; the kernels are 32-bit
    with jax.enable_x64(False):
        alphas, c_fwd = pl.pallas_call(
            partial(_fwd_kernel, N=N, P=P, PP=PP, A=A),
            grid=(B,),
            in_specs=[spec(N, A * A), spec(N, PP), spec(N, 3)],
            out_specs=[spec(N, PP, PP), spec(N)],
            out_shape=[jax.ShapeDtypeStruct((B, N, PP, PP), f32),
                       jax.ShapeDtypeStruct((B, N), f32)],
            compiler_params=params,
            backend="triton",
            interpret=interpret,
            name="pangenie_fb_forward",
        )(ea, al, u)
        posts = pl.pallas_call(
            partial(_bwd_kernel, N=N, P=P, PP=PP, A=A, AP=AP),
            grid=(B,),
            in_specs=[spec(N, PP, PP), spec(N), spec(N, A * A),
                      spec(N, PP), spec(N, 3), spec(N)],
            out_specs=spec(N, AP, AP),
            out_shape=jax.ShapeDtypeStruct((B, N, AP, AP), f32),
            compiler_params=params,
            backend="triton",
            interpret=interpret,
            name="pangenie_fb_backward",
        )(alphas, c_fwd, ea, al, u, last)

    next_scale = jnp.concatenate(
        [columns.scale[:, 1:], jnp.zeros((B, 1), columns.scale.dtype)],
        axis=1,
    )
    return posts[:, :, :A, :A], columns.scale + next_scale
