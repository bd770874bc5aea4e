"""Forward-Backward pair HMM as batched JAX scans.

Re-design of the reference HMM forward/backward passes
(src/hmm.cpp:175-405) for an accelerator:

- The P^2 path-pair state space is kept as a [P, P] matrix; the
  reference's rank-1 transition trick (helpers h_i = row sums,
  h_j = col sums, h_ij = total; src/hmm.cpp:209-234) becomes broadcasted
  elementwise math — O(P^2) work per column, no P^2 x P^2 matmul.
- Each column is normalized to sum 1 exactly as the reference does,
  with the underflow -> uniform fallback (src/hmm.cpp:253-267).
- Posterior per column = alpha_norm * beta_unnorm * forward_norm_sum
  (src/hmm.cpp:364-368), accumulated into a per-column
  [A, A] allele-pair matrix via two small matmuls (H^T P H with H
  the path->local-allele one-hot). Raw (unnormalized) outputs are
  comparable across path subsets up to the shared emission rescale.
- The reference's sqrt(N) sparse-column recompute (src/hmm.cpp:81-89,
  298-308) is a CPU memory trick; here the forward pass is stored in
  device memory ([N, P, P]) and traded for a two-level checkpointed scan only when
  that exceeds memory (see `segment_size`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .emissions import log_emission_allele_matrix, log_emission_column


class ColumnArrays(NamedTuple):
    """Stacked per-column device inputs (leading axis = column)."""

    lp: jax.Array          # [N, K, 3]
    incidence: jax.Array   # [N, K, A] kmer-on-allele (local allele ids)
    kmer_mask: jax.Array   # [N, K]
    alleles: jax.Array     # [N, P] global allele ids (host scatter only)
    undefined: jax.Array   # [N, A] local allele undefined
    all_zeros: jax.Array   # [N]
    scale: jax.Array       # [N]
    trans: jax.Array       # [N, 3]; trans[n] = t(n-1 -> n), trans[0] unused
    allele_local: jax.Array  # [N, P] local allele index per path
    nr_local: jax.Array    # [N]
    is_last: jax.Array     # [N] True at the LAST REAL column (padding
                           # columns after it are pass-through)


def _emission(col: ColumnArrays):
    return log_emission_column(
        col.lp,
        col.incidence,
        col.kmer_mask,
        col.allele_local,
        col.undefined,
        col.all_zeros,
        col.scale,
    )


def _allele_emissions(columns: ColumnArrays) -> jax.Array:
    """Precompute every column's LINEAR [A, A] emission matrix at once.

    The reference rebuilds an EmissionProbabilityComputer inside the
    column loop (src/hmm.cpp:209, :311); the emission has no sequential
    dependency, so hoisting it out of the scan turns O(N * K * A^2)
    transcendental work (done twice more in the backward pass for
    E_{n+1}) into ONE embarrassingly parallel pass, leaving the scan
    step a [P, P] gather + the rank-1 mix. exp/gather commute
    elementwise, so results are bitwise identical to the in-step form.
    """
    logEA = jax.vmap(log_emission_allele_matrix)(
        columns.lp,
        columns.incidence,
        columns.kmer_mask,
        columns.undefined,
        columns.all_zeros,
        columns.scale,
    )
    return jnp.exp(logEA)  # [N, A, A]


_EXACT = jax.lax.Precision.HIGHEST


def _gather_state_emission(ea: jax.Array, allele_local: jax.Array):
    """[A, A] linear emission -> [P, P] state emission via path gather."""
    return ea[allele_local[:, None], allele_local[None, :]]


def _expand_state_emission(ea: jax.Array, one_hot: jax.Array):
    """[A, A] linear emission -> [P, P] state emission as H @ EA @ H^T.

    H [P, A] is the exact 0/1 path->local-allele one-hot, so each
    output element sums exactly one nonzero term — bitwise equal to the
    gather form for normal floats (a subnormal entry, below ~1e-38 of
    the column's best allele pair in f32, may flush to zero), but it
    compiles to two tiny matmuls instead of a dynamic gather. The
    products must run in full f32: a TF32 matmul (the GPU's default for
    f32) rounds EA to 10 mantissa bits.
    """
    return jnp.einsum("pa,ab,qb->pq", one_hot, ea, one_hot,
                      precision=_EXACT)


def _mix_previous(alpha, t):
    """Rank-1-factorized transition mix (src/hmm.cpp:232-234).

    prev[i,j] = t0*a[i,j] + t1*(h_i[i]+h_j[j]-2a[i,j])
              + t2*(h_ij - h_i[i] - h_j[j] + a[i,j])
    """
    h_i = jnp.sum(alpha, axis=1, keepdims=True)  # [P,1] row sums
    h_j = jnp.sum(alpha, axis=0, keepdims=True)  # [1,P] col sums
    h_ij = jnp.sum(alpha)
    return (
        t[0] * alpha
        + t[1] * (h_i + h_j - 2.0 * alpha)
        + t[2] * (h_ij - h_i - h_j + alpha)
    )


@jax.jit
def forward_backward(columns: ColumnArrays):
    """Run both passes; returns per-column allele-pair posteriors.

    Returns:
      posteriors: [N, A, A] rescaled raw genotype-likelihood matrices;
        symmetric states are NOT collapsed (caller adds G[i,j] + G[j,i]
        for i < j).
      log_correction: [N] per-column log factor such that the
        reference's raw (long double) posterior equals
        posteriors * exp(log_correction). The emissions are rescaled by
        exp(-scale_n) on device to stay in f64/f32 range; the column's
        posterior picks up exp(-(scale_n + scale_{n+1})) through the
        forward normalization constant and the backward emission
        (scale_{N-1} only for the last column). Undoing the factor in
        extended precision host-side restores the reference's raw
        values, which its cross-subset `combine` adds directly.
    """
    N, P = columns.alleles.shape
    A = columns.incidence.shape[2]
    dtype = columns.lp.dtype
    uniform_val = jnp.asarray(1.0, dtype) / (P * P)

    # emissions hoisted out of the sequential scans: one parallel pass
    EA = _allele_emissions(columns)  # [N, A, A] linear, rescaled
    one_hot = jax.nn.one_hot(columns.allele_local, A, dtype=dtype)  # [N, P, A]

    # ---- forward pass ----
    def fwd_step(carry, inputs):
        alpha_prev, is_first = carry
        ea, oh, trans = inputs
        E = _expand_state_emission(ea, oh)
        prev = jnp.where(
            is_first, jnp.ones((P, P), dtype), _mix_previous(alpha_prev, trans)
        )
        cur = prev * E
        s = jnp.sum(cur)
        alpha = jnp.where(s > 0, cur / s, jnp.full((P, P), uniform_val))
        c_fwd = jnp.where(s > 0, s, jnp.asarray(1.0, dtype))
        return (alpha, jnp.zeros((), bool)), (alpha, c_fwd)

    init = (jnp.zeros((P, P), dtype), jnp.ones((), bool))
    _, (alphas, c_fwd) = jax.lax.scan(
        fwd_step, init, (EA, one_hot, columns.trans)
    )

    # ---- backward pass (reverse scan) ----
    # at column n we need E_{n+1} and t(n -> n+1) = trans[n+1]; shift
    # the precomputed emissions so each reverse step sees its successor
    EA_next = jnp.roll(EA, -1, axis=0)
    oh_next = jnp.roll(one_hot, -1, axis=0)
    tr_next = jnp.roll(columns.trans, -1, axis=0)

    def bwd_step(carry, inputs):
        beta_next = carry
        alpha_n, c_n, ea_next, oh_nxt, trans_next, is_last = inputs
        E_next = _expand_state_emission(ea_next, oh_nxt)
        helper = beta_next * E_next
        cur = jnp.where(
            is_last,
            jnp.ones((P, P), dtype),
            _mix_previous(helper, trans_next),
        )
        s = jnp.sum(cur)
        beta = jnp.where(s > 0, cur / s, jnp.full((P, P), uniform_val))
        posterior = alpha_n * cur * c_n  # [P, P] raw
        return beta, posterior

    _, posts = jax.lax.scan(
        bwd_step,
        jnp.zeros((P, P), dtype),
        (alphas, c_fwd, EA_next, oh_next, tr_next, columns.is_last),
        reverse=True,
    )

    # ---- collapse to allele pairs (batched matmuls) ----
    posteriors = jnp.einsum("npa,npq,nqb->nab", one_hot, posts, one_hot,
                            precision=_EXACT)

    next_scale = jnp.concatenate(
        [columns.scale[1:], jnp.zeros(1, columns.scale.dtype)]
    )
    log_correction = columns.scale + next_scale
    return posteriors, log_correction


# ---------------------------------------------------------------------------
# Segmented (checkpoint + recompute) variant for long chromosomes:
# device memory O(segment * P^2) instead of O(N * P^2). The forward
# pass streams column segments, storing only segment-boundary alpha
# carries and the per-column normalization sums; the backward pass
# recomputes each segment's alphas from its checkpoint — the device
# analogue of the reference's sqrt(N) sparse table
# (src/hmm.cpp:81-89, 298-308), at 2x forward compute.
# ---------------------------------------------------------------------------


def _fwd_step_impl(carry, inputs, P, dtype):
    alpha_prev, is_first = carry
    ea, oh, trans = inputs
    uniform_val = jnp.asarray(1.0, dtype) / (P * P)
    E = _expand_state_emission(ea, oh)
    prev = jnp.where(
        is_first, jnp.ones((P, P), dtype), _mix_previous(alpha_prev, trans)
    )
    cur = prev * E
    s = jnp.sum(cur)
    alpha = jnp.where(s > 0, cur / s, jnp.full((P, P), uniform_val))
    c_fwd = jnp.where(s > 0, s, jnp.asarray(1.0, dtype))
    return (alpha, jnp.zeros((), bool)), (alpha, c_fwd)


@jax.jit
def _segment_forward(carry, cols: ColumnArrays):
    """Carry the forward recurrence across one segment; emits only the
    per-column normalization sums."""
    dtype = cols.lp.dtype
    P = cols.alleles.shape[1]
    EA = _allele_emissions(cols)

    oh = jax.nn.one_hot(cols.allele_local, EA.shape[1], dtype=dtype)

    def step(c, inputs):
        new_c, (_alpha, c_fwd) = _fwd_step_impl(c, inputs, P, dtype)
        return new_c, c_fwd

    return jax.lax.scan(step, carry, (EA, oh, cols.trans))


@jax.jit
def _segment_forward_full(carry, cols: ColumnArrays):
    """Forward recurrence over one segment, storing the alphas."""
    dtype = cols.lp.dtype
    P = cols.alleles.shape[1]
    EA = _allele_emissions(cols)

    oh = jax.nn.one_hot(cols.allele_local, EA.shape[1], dtype=dtype)

    def step(c, inputs):
        new_c, out = _fwd_step_impl(c, inputs, P, dtype)
        return new_c, out

    return jax.lax.scan(step, carry, (EA, oh, cols.trans))


@jax.jit
def _segment_backward(beta, cols, next_cols, alphas, c_fwd):
    """Backward recurrence + posterior collapse over one segment."""
    dtype = cols.lp.dtype
    P = cols.alleles.shape[1]
    A = cols.incidence.shape[2]
    uniform_val = jnp.asarray(1.0, dtype) / (P * P)
    EA_next = _allele_emissions(next_cols)
    oh_next = jax.nn.one_hot(
        next_cols.allele_local, EA_next.shape[1], dtype=dtype
    )

    def step(b, inputs):
        alpha_n, c_n, ea_next, oh_nxt, trans_next, is_last = inputs
        E_next = _expand_state_emission(ea_next, oh_nxt)
        helper = b * E_next
        cur = jnp.where(
            is_last, jnp.ones((P, P), dtype), _mix_previous(helper, trans_next)
        )
        s = jnp.sum(cur)
        new_b = jnp.where(s > 0, cur / s, jnp.full((P, P), uniform_val))
        posterior = alpha_n * cur * c_n
        return new_b, posterior

    beta, posts = jax.lax.scan(
        step,
        beta,
        (alphas, c_fwd, EA_next, oh_next, next_cols.trans,
         cols.is_last),
        reverse=True,
    )
    one_hot = jax.nn.one_hot(cols.allele_local, A, dtype=dtype)
    return beta, jnp.einsum("npa,npq,nqb->nab", one_hot, posts, one_hot,
                            precision=_EXACT)


def forward_backward_segmented(host_columns: ColumnArrays, segment: int):
    """Segmented forward-backward over host-resident column arrays.

    ``host_columns`` leaves are numpy arrays [N, ...] (N a multiple of
    nothing in particular — the last segment may be short; shapes per
    segment are padded implicitly by the bucketing upstream). Returns
    (posteriors [N, A, A], log_correction [N]) as numpy arrays.
    """
    import numpy as np

    N, P = host_columns.alleles.shape
    dtype = jnp.asarray(host_columns.lp[:1]).dtype
    n_segs = (N + segment - 1) // segment

    def dev_slice(sl) -> ColumnArrays:
        return ColumnArrays(*[jnp.asarray(x[sl]) for x in host_columns])

    def dev_next_slice(lo, hi) -> ColumnArrays:
        """Columns shifted by -1 (each row n holds column n+1); the
        final row wraps like jnp.roll, matching the unsegmented path
        (its value is ignored: is_last masks it)."""
        idx = np.arange(lo + 1, hi + 1)
        idx[-1] = idx[-1] % N
        return ColumnArrays(*[jnp.asarray(x[idx]) for x in host_columns])

    # pass 1: checkpoints + normalization sums
    checkpoints = []
    carry = (jnp.zeros((P, P), dtype), jnp.ones((), bool))
    c_fwd_segs = []
    for s in range(n_segs):
        checkpoints.append(carry)
        sl = slice(s * segment, min(N, (s + 1) * segment))
        carry, c_fwd = _segment_forward(carry, dev_slice(sl))
        c_fwd_segs.append(c_fwd)

    # pass 2: per-segment alpha recompute + backward
    posteriors = None
    beta = jnp.zeros((P, P), dtype)
    for s in range(n_segs - 1, -1, -1):
        lo, hi = s * segment, min(N, (s + 1) * segment)
        cols = dev_slice(slice(lo, hi))
        _, (alphas, _c) = _segment_forward_full(checkpoints[s], cols)
        beta, posts = _segment_backward(
            beta, cols, dev_next_slice(lo, hi), alphas, c_fwd_segs[s]
        )
        posts = np.asarray(posts)
        if posteriors is None:
            A = posts.shape[1]
            posteriors = np.empty((N, A, A), dtype=posts.dtype)
        posteriors[lo:hi] = posts

    scale = np.asarray(host_columns.scale)
    next_scale = np.concatenate([scale[1:], np.zeros(1, scale.dtype)])
    return posteriors, scale + next_scale
