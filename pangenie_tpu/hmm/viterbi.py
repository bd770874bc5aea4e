"""Viterbi (phasing) pass as a max-plus JAX scan.

The reference Viterbi is O(P^4) per column (src/hmm.cpp:408-511): for
every current path-pair it scans all previous path-pairs. The pair
transition only depends on the SWITCH COUNT between states, so the
max-plus recurrence factorizes exactly like the forward pass's rank-1
sum trick — per current state (p1, p2) the best predecessor is the max
over three classes {stay both, switch one, switch both}, each
computable from per-row / per-column top-2 maxima of the previous
column in O(P^2) total (vs O(P^4) dense). Tie-breaking is preserved
exactly: the reference's `>=` scan in ascending row-major previous-
state order means the LAST maximal index wins (src/hmm.cpp:464-471),
which the factored form reproduces with last-argmax top-2 statistics
and (value, index)-lexicographic class combination. The dense [S, S]
formulation is kept as `_prev_best_dense` — the oracle for the
tie-exactness regression tests.

Backtrace pointers for all columns are stored ([N, S] int32) and the
path is recovered with a reverse pointer-chase scan; the reference's
sqrt(N)-checkpoint recompute (src/hmm.cpp:119-129, 152-158) is a
host-memory trick device memory does not need at phasing scale.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp

from .forward_backward import ColumnArrays
from .emissions import log_emission_allele_matrix


def _switch_counts(P: int) -> jnp.ndarray:
    """[S, S] number of path switches between state j and state i."""
    ids = jnp.arange(P * P)
    p1 = ids // P
    p2 = ids % P
    sw = (p1[:, None] != p1[None, :]).astype(jnp.int32) + (
        p2[:, None] != p2[None, :]
    ).astype(jnp.int32)
    return sw


def _log_allele_emissions(columns: ColumnArrays) -> jnp.ndarray:
    """All columns' log [A, A] emission matrices in one parallel pass
    (the emission has no sequential dependency; hoisting it out of the
    max-plus scan mirrors forward_backward._allele_emissions)."""
    return jax.vmap(log_emission_allele_matrix)(
        columns.lp,
        columns.incidence,
        columns.kmer_mask,
        columns.undefined,
        columns.all_zeros,
        columns.scale,
    )


def _prev_best_dense(lv_prev, lt, P: int):
    """O(P^4) reference formulation: (best value, last-max argmax) of
    lv_prev[j] + lt[switches(j, i)] over previous states j, per current
    state i. Test oracle for `_prev_best_factored`."""
    S = P * P
    sw = _switch_counts(P)
    T = lt[sw]  # [S, S]
    scores = lv_prev[:, None] + T  # scores[j, i]
    best_val = jnp.max(scores, axis=0)
    rev_arg = jnp.argmax(scores[::-1, :], axis=0)
    best_idx = (S - 1) - rev_arg
    return best_val, best_idx.astype(jnp.int32)


def _top2_last(x, axis: int):
    """Per-slice (m1, a1, m2, a2): max with LAST argmax, and the max
    with LAST argmax after excluding index a1 (so m2/a2 answer "max
    over the slice minus one given index" queries exactly, including
    under ties). Gather/flip-free: last-argmax is the max of the iota
    where the value equals the max — reduces only (gathers and flip
    copies made this the scan's hot spot on the device it was first
    written for)."""
    n = x.shape[axis]
    neg_inf = jnp.array(-jnp.inf, x.dtype)
    idx = jnp.expand_dims(
        jnp.arange(n, dtype=jnp.int32),
        [d for d in range(x.ndim) if d != axis],
    )

    m1 = jnp.max(x, axis=axis)
    m1e = jnp.expand_dims(m1, axis)
    a1 = jnp.max(jnp.where(x == m1e, idx, -1), axis=axis)
    masked = jnp.where(idx == jnp.expand_dims(a1, axis), neg_inf, x)
    m2 = jnp.max(masked, axis=axis)
    a2 = jnp.max(
        jnp.where(masked == jnp.expand_dims(m2, axis), idx, -1), axis=axis
    )
    return m1, a1.astype(jnp.int32), m2, a2.astype(jnp.int32)


def _lex_max(va, ja, vb, jb):
    """(value, state-index)-lexicographic max: larger value wins, ties
    go to the LARGER previous-state index (the reference's last-max
    `>=` ascending scan, src/hmm.cpp:464-471)."""
    take_a = (va > vb) | ((va == vb) & (ja > jb))
    return jnp.where(take_a, va, vb), jnp.where(take_a, ja, jb)


def _prev_best_factored(lv_prev, lt, P: int):
    """Exact O(P^2) factorization of `_prev_best_dense`.

    The transition weight depends only on the switch count s(j, i), so
    per current state i = (p1, p2) the best predecessor decomposes into
    three classes: stay-both (j == i), switch-one (j shares exactly one
    coordinate), switch-both (j shares neither). Each class max comes
    from top-2 row/column statistics of lv_prev; last-max argmaxes and
    lexicographic combination keep the dense tie-breaking bit-exact.
    """
    lv = lv_prev.reshape(P, P)
    p = jnp.arange(P)
    grid_r = p[:, None]  # p1
    grid_c = p[None, :]  # p2

    # per-row / per-column top-2 of the previous column's values
    rm1, ra1, rm2, ra2 = _top2_last(lv, axis=1)  # [P] over q2 per q1
    cm1, ca1, cm2, ca2 = _top2_last(lv, axis=0)  # [P] over q1 per q2

    # class 0 — stay both: j == i
    v0 = lv + lt[0]
    j0 = (grid_r * P + grid_c).astype(jnp.int32)

    # class 1 — switch one: (p1, q2 != p2)  or  (q1 != p1, p2)
    ex = ra1[:, None] == grid_c                       # row max sits AT p2?
    vr = jnp.where(ex, rm2[:, None], rm1[:, None])    # [P, P]
    jr = grid_r * P + jnp.where(ex, ra2[:, None], ra1[:, None])
    ey = ca1[None, :] == grid_r                       # col max sits AT p1?
    vc = jnp.where(ey, cm2[None, :], cm1[None, :])
    jc = jnp.where(ey, ca2[None, :], ca1[None, :]) * P + grid_c
    v1, j1 = _lex_max(vr, jr.astype(jnp.int32), vc, jc.astype(jnp.int32))
    v1 = v1 + lt[1]

    # class 2 — switch both: q1 != p1 and q2 != p2.
    # g[q1, p2] = max over q2 != p2 of lv[q1, q2] (with its col index);
    # then top-2 over q1 per p2 answers the q1 != p1 exclusion.
    gv = jnp.where(ex, rm2[:, None], rm1[:, None])            # [q1, p2]
    gm1, gA1, gm2, gA2 = _top2_last(gv, axis=0)               # [P] per p2
    hit = gA1[None, :] == grid_r                              # top row == p1?
    v2 = jnp.where(hit, gm2[None, :], gm1[None, :]) + lt[2]
    j2_row = jnp.where(hit, gA2[None, :], gA1[None, :])       # [P, P]
    # winning column = ga[j2_row, p2] where ga[q1, p2] picks ra2[q1]
    # when that row's best column sits AT p2 (ex) else ra1[q1].
    # j2_row is one of {gA1[p2], gA2[p2]}, so the [P, P] gather
    # collapses to four [P]-sized gathers + selects (a [P, P] gather
    # per scan step would dominate the replay)
    r1g1, r2g1 = ra1[gA1], ra2[gA1]                           # [P]
    r1g2, r2g2 = ra1[gA2], ra2[gA2]
    ra1_at = jnp.where(hit, r1g2[None, :], r1g1[None, :])     # [P, P]
    ra2_at = jnp.where(hit, r2g2[None, :], r2g1[None, :])
    ex_at = ra1_at == grid_c
    j2_col = jnp.where(ex_at, ra2_at, ra1_at)
    j2 = (j2_row * P + j2_col).astype(jnp.int32)

    best_val, best_idx = _lex_max(v0, j0, v1, j1)
    best_val, best_idx = _lex_max(best_val, best_idx, v2, j2)
    return best_val.reshape(P * P), best_idx.reshape(P * P)


def _viterbi_step(carry, inputs, P, dtype, uniform: bool,
                  with_backtrace: bool, dense: bool = False):
    lv_prev, is_first = carry
    logEA, allele_local, trans = inputs
    S = P * P
    logE = logEA[allele_local[:, None], allele_local[None, :]].reshape(S)
    if uniform:
        lt = jnp.zeros(3, dtype)
    else:
        lt = jnp.log(trans)
    prev_best = _prev_best_dense if dense else _prev_best_factored
    best_val, best_idx = prev_best(lv_prev, lt, P)
    prev_cell = jnp.where(is_first, jnp.zeros(S, dtype), best_val)
    cur = prev_cell + logE
    # per-column normalization (reference divides by the sum; any
    # positive rescale preserves the argmax chain — subtract logsumexp
    # for bounded magnitudes, uniform fallback if everything is -inf)
    lse = jax.scipy.special.logsumexp(cur)
    cur = jnp.where(
        jnp.isfinite(lse), cur - lse, jnp.full(S, -jnp.log(float(S)), dtype)
    )
    if not with_backtrace:
        return (cur, jnp.zeros((), bool)), None
    backtrace = jnp.where(is_first, jnp.zeros(S, jnp.int32), best_idx)
    return (cur, jnp.zeros((), bool)), backtrace


@partial(jax.jit, static_argnames=("uniform",))
def viterbi(columns: ColumnArrays, uniform: bool = False):
    """Max-plus scan; returns (best path-pair state per column) [N].

    States are flattened row-major: state = p1 * P + p2. Long
    chromosomes with few alleles dispatch to the two-pass blocked
    formulation (:func:`_viterbi_fast`); the plain scan is the
    reference path and fallback.
    """
    import os

    N, P = columns.alleles.shape
    A = columns.incidence.shape[2]
    if (
        N >= 2048
        and A <= 8
        and not os.environ.get("PANGENIE_TPU_NO_FAST_VITERBI")
    ):
        return _viterbi_fast(columns, uniform)
    return _viterbi_scan(columns, uniform)


def _viterbi_scan(columns: ColumnArrays, uniform: bool):
    N, P = columns.alleles.shape
    S = P * P
    dtype = columns.lp.dtype
    logEA = _log_allele_emissions(columns)

    def step(carry, inputs):
        return _viterbi_step(carry, inputs, P, dtype, uniform, True)

    init = (jnp.zeros(S, dtype), jnp.ones((), bool))
    (last, _), backtraces = jax.lax.scan(
        step, init, (logEA, columns.allele_local, columns.trans)
    )

    # best final state: reference takes `>=` over ascending i => last max
    # (src/hmm.cpp:132-141), on sum-normalized probabilities. Our values
    # are log-space max-normalized; ties coincide.
    rev = jnp.argmax(last[::-1])
    best_last = ((S - 1) - rev).astype(jnp.int32)

    def chase(state, bt):
        prev_state = bt[state]
        return prev_state, state

    # walk pointers from the end; state emitted for each column
    _, states_rev = jax.lax.scan(chase, best_last, backtraces, reverse=True)
    # states_rev[n] = state at column n (chase emits current state, then
    # moves to its predecessor for column n-1)
    return states_rev


_VIT_L = 64  # pass-2 segment length of the blocked formulation


def _viterbi_fast(columns: ColumnArrays, uniform: bool):
    """Two-pass blocked Viterbi: ~10x the plain scan's throughput.

    The scan pays ~30 us of serial latency per column, almost all of it
    in the tie-exact top-2/backtrace machinery. Split it:

    Pass 1 — VALUE-ONLY scan (~8 ops/column): per current state the
    best predecessor VALUE needs no exclusion logic at all, because a
    dominated candidate cannot change a max: the row/column/global
    maxima may sit at excluded coordinates, but any such candidate
    belongs to a cheaper switch class and is already included there
    with a transition weight at least as large (stay >= switch-one >=
    switch-two in log space), and float addition is monotone, so the
    unconstrained form is bit-equal to the constrained one.

    Pass 2 — the EXACT original step (top-2 last-argmax statistics,
    lexicographic class combination) replays every _VIT_L-column
    segment in parallel from pass 1's boundary values, emitting the
    bit-exact backtraces; a reverse segment scan with statically
    unrolled scalar gathers chases the path (same pattern as the
    blocked sampling DP).

    The per-column emission [S] is materialized once up front with
    A^2 select passes (exact copies — no arithmetic), which also
    removes the per-step [P, P] gather from both scans.
    """
    N, P = columns.alleles.shape
    S = P * P
    dtype = columns.lp.dtype
    logEA = _log_allele_emissions(columns)
    A = logEA.shape[1]
    al = columns.allele_local

    logE = jnp.zeros((N, P, P), dtype)
    for a in range(A):
        ma = al == a
        for b in range(A):
            m = ma[:, :, None] & (al == b)[:, None, :]
            logE = jnp.where(m, logEA[:, a, b][:, None, None], logE)
    logE = logE.reshape(N, S)
    lt = (
        jnp.zeros((N, 3), dtype)
        if uniform
        else jnp.log(columns.trans).astype(dtype)
    )
    neglogS = -jnp.log(jnp.asarray(float(S), dtype))

    def normalize(cur):
        lse = jax.scipy.special.logsumexp(cur)
        return jnp.where(
            jnp.isfinite(lse), cur - lse, jnp.full(S, neglogS, dtype)
        )

    def vstep(carry, inputs):
        lv_prev, is_first = carry
        logE_n, lt_n = inputs
        lv = lv_prev.reshape(P, P)
        rowmax = jnp.max(lv, axis=1)
        colmax = jnp.max(lv, axis=0)
        gmax = jnp.max(rowmax)
        best = jnp.maximum(
            jnp.maximum(lv + lt_n[0], rowmax[:, None] + lt_n[1]),
            jnp.maximum(colmax[None, :] + lt_n[1], gmax + lt_n[2]),
        ).reshape(S)
        prev_cell = jnp.where(is_first, jnp.zeros(S, dtype), best)
        cur = normalize(prev_cell + logE_n)
        return (cur, jnp.zeros((), bool)), cur

    init = (jnp.zeros(S, dtype), jnp.ones((), bool))
    (last, _), ys = jax.lax.scan(vstep, init, (logE, lt))

    rev = jnp.argmax(last[::-1])
    best_last = ((S - 1) - rev).astype(jnp.int32)

    # pass 2: exact replay per segment
    def replay_step(carry, inputs):
        lv_prev, is_first = carry
        logE_n, lt_n = inputs
        best_val, best_idx = _prev_best_factored(lv_prev, lt_n, P)
        prev_cell = jnp.where(is_first, jnp.zeros(S, dtype), best_val)
        cur = normalize(prev_cell + logE_n)
        bt = jnp.where(is_first, jnp.zeros(S, jnp.int32), best_idx)
        return (cur, jnp.zeros((), bool)), bt

    L = _VIT_L
    Kf = N // L
    tail = N - Kf * L
    ent = jnp.concatenate(
        [jnp.zeros((1, S), dtype), ys[L - 1:Kf * L - 1:L]], axis=0
    )                                                   # [Kf, S]
    isf = jnp.concatenate(
        [jnp.ones((1,), bool), jnp.zeros((Kf - 1,), bool)]
    )

    def seg_replay(entry, isf_s, logE_s, lt_s):
        (_, _), bts = jax.lax.scan(
            replay_step, (entry, isf_s), (logE_s, lt_s)
        )
        return bts

    bts = jax.vmap(seg_replay)(
        ent, isf,
        logE[: Kf * L].reshape(Kf, L, S),
        lt[: Kf * L].reshape(Kf, L, 3),
    )                                                   # [Kf, L, S]

    state = best_last
    tail_states = None
    if tail:
        (_, _), bt_tail = jax.lax.scan(
            replay_step,
            (ys[Kf * L - 1], jnp.zeros((), bool)),
            (logE[Kf * L:], lt[Kf * L:]),
        )

        def chase_t(s, bt):
            return bt[s], s

        state, tail_states = jax.lax.scan(
            chase_t, state, bt_tail, reverse=True
        )

    def chase_seg(sigma, bt_seg):                       # bt_seg [L, S]
        outs = []
        for col in range(L - 1, -1, -1):
            outs.append(sigma)
            sigma = bt_seg[col][sigma]
        return sigma, jnp.stack(outs[::-1])

    _, seg_states = jax.lax.scan(chase_seg, state, bts, reverse=True)
    states = seg_states.reshape(Kf * L)
    if tail_states is not None:
        states = jnp.concatenate([states, tail_states])
    return states


@partial(jax.jit, static_argnames=("uniform",))
def _viterbi_segment_forward(carry, cols: ColumnArrays, uniform: bool):
    """Carry the max-plus recurrence over one segment, no backtraces."""
    P = cols.alleles.shape[1]
    dtype = cols.lp.dtype
    logEA = _log_allele_emissions(cols)

    def step(c, inputs):
        return _viterbi_step(c, inputs, P, dtype, uniform, False)

    carry, _ = jax.lax.scan(
        step, carry, (logEA, cols.allele_local, cols.trans)
    )
    return carry


@partial(jax.jit, static_argnames=("uniform",))
def _viterbi_segment_backtrace(carry, cols: ColumnArrays, state_in,
                               uniform: bool):
    """Recompute one segment's backtraces from its entry carry and
    chase from state_in (or, when state_in < 0, the last-max argmax of
    the final column — the reference's `>=` ascending rule)."""
    P = cols.alleles.shape[1]
    dtype = cols.lp.dtype
    logEA = _log_allele_emissions(cols)

    def step(c, inputs):
        return _viterbi_step(c, inputs, P, dtype, uniform, True)

    (last, _), backtraces = jax.lax.scan(
        step, carry, (logEA, cols.allele_local, cols.trans)
    )
    S = last.shape[0]
    rev = jnp.argmax(last[::-1])
    last_max = ((S - 1) - rev).astype(jnp.int32)
    state = jnp.where(state_in >= 0, state_in, last_max)

    def chase(s, bt):
        return bt[s], s

    state_out, states = jax.lax.scan(chase, state, backtraces, reverse=True)
    return state_out, states


def viterbi_segmented(host_columns: ColumnArrays, segment: int,
                      uniform: bool = False):
    """Checkpointed Viterbi over host-resident columns: O(segment * S)
    device memory for the backtrace table (the reference's sqrt(N)
    recompute, src/hmm.cpp:119-129, on column segments)."""
    import numpy as np

    N, P = host_columns.alleles.shape
    S = P * P
    dtype = jnp.asarray(host_columns.lp[:1]).dtype
    n_segs = (N + segment - 1) // segment

    def dev_slice(sl) -> ColumnArrays:
        return ColumnArrays(*[jnp.asarray(x[sl]) for x in host_columns])

    checkpoints = []
    carry = (jnp.zeros(S, dtype), jnp.ones((), bool))
    for s in range(n_segs):
        checkpoints.append(carry)
        sl = slice(s * segment, min(N, (s + 1) * segment))
        carry = _viterbi_segment_forward(carry, dev_slice(sl), uniform)

    states = np.empty(N, dtype=np.int32)
    state = jnp.int32(-1)
    for s in range(n_segs - 1, -1, -1):
        sl = slice(s * segment, min(N, (s + 1) * segment))
        state, seg_states = _viterbi_segment_backtrace(
            checkpoints[s], dev_slice(sl), state, uniform
        )
        states[sl] = np.asarray(seg_states)
    return states
