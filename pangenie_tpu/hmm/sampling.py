"""Haplotype sampling (panel reduction, the ``-x`` mechanism).

Re-design of the reference HaplotypeSampler
(src/haplotypesampler.cpp:20-314) for an accelerator: the greedy
iterative min-cost single-path Viterbi becomes a batched min-plus ``lax.scan``
over columns with uint32 phred costs. Each of the ``size`` iterations:

- forward scan, O(P) per column via the (min, second-min) trick
  (reference get_column_minima, src/haplotypesampler.cpp:79-107): the
  cheapest predecessor for state i is the previous column's minimum
  over j != i, which is min2 when i is the argmin and min1 otherwise;
- previously sampled paths are masked out per column (emission +inf ==
  UINT32_MAX with saturating adds, mirroring the reference's overflow
  clamps, src/haplotypesampler.cpp:259-283);
- backtrace pointer chase (reverse scan), then the chosen allele's
  emission cost is penalized per column (+allele_penalty, clamped to
  the default penalty 25 — which also CAPS undefined alleles' cost of
  50 down to 25 once penalized, a reference quirk we keep,
  src/samplingemissions.cpp:39-45).

Tie-breaking is faithful: first-minimum (lowest index) in column
minima and final-column argmin; on stay-vs-switch cost ties the switch
(helper) wins because the stay path only replaces on strict '<'
(src/haplotypesampler.cpp:267-274).

For short chromosomes the full [N, P] backtrace lives in device memory;
beyond ~65k columns the checkpointed variant streams column segments and
recomputes backtraces per segment during the backward chase — the
device analogue of the reference's sqrt(N) sparse table
(src/haplotypesampler.cpp:116-126), with O(segment * P) device memory.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kmers.unique import UniqueKmersRecord

UINT_MAX = np.uint32(0xFFFFFFFF)


def sampling_emission_costs(record: UniqueKmersRecord) -> np.ndarray:
    """Initial per-allele phred costs for one column.

    cost = trunc(-10*log10(fraction of allele kmers with count >= 3)),
    25 if the fraction is 0, 50 for undefined alleles
    (reference src/samplingemissions.cpp:9-32; fraction is computed in
    float32 as the reference uses `float`).
    """
    allele_ids = record.get_allele_ids()
    max_allele = max(allele_ids)
    costs = np.zeros(max_allele + 1, dtype=np.uint32)
    for a in allele_ids:
        if record.is_undefined_allele(a):
            costs[a] = 50
            continue
        fraction = record.fraction_present_kmers_on_allele(a)
        if fraction > 0.0:
            costs[a] = int(-10.0 * math.log10(float(fraction)))
            assert costs[a] < 25
        else:
            costs[a] = 25
    return costs


def bulk_emission_costs(records: Sequence[UniqueKmersRecord]) -> np.ndarray:
    """Vectorized :func:`sampling_emission_costs` over all records.

    Returns [N, A_max] uint32; entries for allele ids a record does not
    know stay 0 (they are never indexed). Uses the records' CSR arrays:
    per-(record, allele) kmer totals and read-supported totals come from
    two bincounts over record-offset allele keys.
    """
    N = len(records)
    n_alleles = np.fromiter(
        (max(r.alleles) + 1 if r.alleles else 1 for r in records),
        dtype=np.int64,
        count=N,
    )
    A = max(1, int(n_alleles.max()))

    data_lens = np.fromiter(
        (len(r.allele_data) for r in records), dtype=np.int64, count=N
    )
    rec_of = np.repeat(np.arange(N, dtype=np.int64), data_lens)
    total_e = int(data_lens.sum())
    if total_e:
        flat_allele = np.concatenate(
            [r.allele_data for r in records if len(r.allele_data)]
        ).astype(np.int64)
        if all(r.all_single_allele() for r in records):
            present_flags = np.concatenate(
                [r.kmer_counts for r in records if r.size()]
            ) >= 3
        else:
            present_flags = np.concatenate(
                [
                    np.repeat(r.kmer_counts >= 3, np.diff(r.allele_indptr))
                    for r in records
                    if r.size()
                ]
            )
        keys = rec_of * A + flat_allele
        totals = np.bincount(keys, minlength=N * A).reshape(N, A)
        present = np.bincount(
            keys[present_flags], minlength=N * A
        ).reshape(N, A)
    else:
        totals = np.zeros((N, A), dtype=np.int64)
        present = totals

    # fraction in float32 (the reference uses `float`), log10 in double
    frac = np.ones((N, A), dtype=np.float32)
    has_kmers = totals > 0
    np.divide(
        present.astype(np.float32),
        totals.astype(np.float32),
        out=frac,
        where=has_kmers,
    )
    costs = np.zeros((N, A), dtype=np.uint32)
    positive = frac > 0.0
    with np.errstate(divide="ignore"):
        logcost = np.trunc(-10.0 * np.log10(frac.astype(np.float64)))
    costs[positive] = logcost[positive].astype(np.uint32)
    costs[~positive] = 25
    if np.any(costs[positive] >= 25):
        raise AssertionError("bulk_emission_costs: cost >= 25 for positive fraction")

    # undefined alleles cost 50 (rare; per-record fix-up)
    for n, record in enumerate(records):
        if record.has_undefined_alleles():
            for a, undef in record.alleles.items():
                if undef:
                    costs[n, a] = 50
    # alleles outside a record's id set must stay 0, as in
    # sampling_emission_costs (costs array sized per record there)
    mask = (
        np.arange(A)[None, :] < n_alleles[:, None]
    )
    costs = np.where(mask, costs, 0).astype(np.uint32)
    return costs


def sampling_transition_cost(
    from_pos: int, to_pos: int, recomb_rate: float, nr_paths: int,
    effective_N: float,
) -> int:
    """trunc(-10*log10(p_recomb)) in long double
    (reference src/samplingtransitions.cpp:5-23)."""
    LD = np.longdouble
    distance = LD(to_pos - from_pos) * LD(0.000004) * LD(recomb_rate) * LD(
        effective_N
    )
    recomb_prob = (LD(1.0) - np.exp(-distance / LD(nr_paths))) * (
        LD(1.0) / LD(nr_paths)
    )
    return int(-10.0 * np.log10(recomb_prob))


def _sat_add(a, b):
    """uint32 saturating add (reference overflow clamps)."""
    s = a + b
    return jnp.where(s < a, jnp.uint32(0xFFFFFFFF), s)


@partial(jax.jit, static_argnames=())
def _viterbi_iteration(path_cost, mask, switch_cost):
    """One masked single-path min-plus Viterbi.

    Args:
      path_cost: [N, P] uint32 emission cost of path i at column n
        (already UINT_MAX where masked).
      mask: [N, P] bool — True where the path is still available.
      switch_cost: [N] uint32; switch_cost[n] = cost of a recombination
        between columns n-1 and n (entry 0 unused).

    Returns:
      path: [N] int32 chosen path per column,
      best_score: uint32 DP score of the path.
    """
    N, P = path_cost.shape
    umax = jnp.uint32(0xFFFFFFFF)
    idx = jnp.arange(P)

    def fwd(carry, inputs):
        prev, prev_mask, is_first = carry
        cost_n, mask_n, sw = inputs

        masked_prev = jnp.where(prev_mask, prev, umax)
        first_val = jnp.min(masked_prev)
        first_id = jnp.argmin(masked_prev)  # first occurrence
        rest = jnp.where(idx == first_id, umax, masked_prev)
        second_val = jnp.min(rest)
        second_id = jnp.argmin(rest)

        helper_val = jnp.where(idx == first_id, second_val, first_val)
        helper_id = jnp.where(idx == first_id, second_id, first_id)

        prev_cell = _sat_add(helper_val, sw)
        backtrace = helper_id.astype(jnp.int32)
        stay = _sat_add(prev, jnp.uint32(0))  # stay cost is 0
        take_stay = prev_mask & (stay < prev_cell)
        prev_cell = jnp.where(take_stay, stay, prev_cell)
        backtrace = jnp.where(take_stay, idx.astype(jnp.int32), backtrace)

        prev_cell = jnp.where(is_first, jnp.uint32(0), prev_cell)
        backtrace = jnp.where(is_first, jnp.int32(0), backtrace)

        cur = _sat_add(prev_cell, cost_n)
        cur = jnp.where(mask_n, cur, umax)
        return (cur, mask_n, jnp.zeros((), bool)), (cur, backtrace)

    init = (
        jnp.zeros(P, jnp.uint32),
        jnp.zeros(P, bool),
        jnp.ones((), bool),
    )
    (last, _, _), (_, backtraces) = jax.lax.scan(
        fwd, init, (path_cost, mask, switch_cost)
    )

    best_index = jnp.argmin(last).astype(jnp.int32)  # first occurrence
    best_score = jnp.min(last)

    def chase(state, bt):
        return bt[state], state

    _, path = jax.lax.scan(chase, best_index, backtraces, reverse=True)
    return path, best_score


# ---------------------------------------------------------------------------
# Blocked exact min-plus Viterbi
#
# The column scan above pays ~7-10 us of tile-padded latency PER COLUMN
# (unrolling does not help — the cost is the per-step [C, P] tensors,
# not loop overhead). This formulation cuts the serial depth from N to
# ~L + 3*(N/L) by splitting the chromosome into K = N/L segments:
#
#  * All x-independent segment tables are computed IN PARALLEL:
#    per-path prefix sums Cpre, the [L, L] matrix
#    V[u, t] = min_i (Cpre[t, i] - Cpre[u-1, i]) (cheapest single-run
#    bridge from a switch at u to column t), and the tropical closure
#    Dstar of the within-segment switch graph (which resolves
#    multi-switch paths without a sequential scalar chain).
#  * One K-step combine scan propagates the entry vector x through the
#    segments with dense [L, P] algebra (last-switch decomposition):
#        y_i = min(x_i + S_i, min_u [ m_{u-1} + w_u + Ssuf_{u,i} ])
#    where the within-segment minima chain m is r (x-dependent base)
#    pushed through the precomputed closure.
#  * A vmapped second pass recomputes each segment's forward DP from
#    its now-known entry vector with the ORIGINAL uint32 column logic
#    (min1/min2 ids, strict-< stay rule), so backtraces and therefore
#    tie-breaking are bit-identical to the column scan; a K-step
#    pointer scan composes per-segment route maps and a final vmapped
#    chase emits the path.
#
# Value-exactness notes (vs the reference recurrence,
# src/haplotypesampler.cpp:259-283):
#  * dropping the j != i switch constraint cannot change any DP VALUE:
#    when argmin == i the unconstrained switch term is y_i + sw >= y_i
#    (stay), and the constrained one is min2 + sw >= min1 = y_i — both
#    collapse onto y_i. Only backtrace CHOICES differ, and those come
#    from the exact second pass.
#  * masking is INF arithmetic: masked cells cost INF64 = 2^40 in the
#    int64 prefix sums, so a run crossing a masked cell is INF while
#    prefix DIFFERENCES spanning only live cells cancel the INF
#    exactly. Within-segment tables clamp to INF32 = 2^29; a fake
#    (clamped-INF) term can only win when no live path exists at all,
#    in which case the original value is UINT_MAX anyway — entry
#    vectors and the final column re-apply their masks before use.
#  * saturating uint32 semantics: legitimate scores stay far below
#    2^32 (<= N * ~110 phred), so clamping the int64 values at
#    UINT32_MAX reproduces the reference's saturation bit-for-bit.

_INF64 = np.int64(1) << 40
_INF32 = np.int64(1) << 29


def _closure_minplus(delta):
    """Tropical (min, +) closure of a strictly-upper-triangular [L, L]
    cost matrix via log2(L) squarings of (I ⊕ Δ)."""
    L = delta.shape[-1]
    inf = jnp.asarray(_INF32, dtype=delta.dtype)
    ar = jnp.arange(L)
    eye = jnp.where(ar[:, None] == ar[None, :], 0, inf).astype(delta.dtype)
    a = jnp.minimum(delta, eye)
    for _ in range(max(1, (L - 1).bit_length())):
        a = jnp.min(a[..., :, :, None] + a[..., None, :, :], axis=-2)
        a = jnp.minimum(a, inf)
    return a


def _blocked_viterbi(path_cost, mask, switch, L: int):
    """Exact blocked batched single-path Viterbi.

    Args:
      path_cost: [C, N, P] uint32 emission costs (values < 2^29).
      mask: [C, N, P] bool, True where the path is available.
      switch: [C, N] uint32 (entry 0 unused).
      L: segment length; N must be a multiple of L.

    Returns (paths [C, N] int32, best_scores [C] uint32), bit-identical
    to vmap(_viterbi_iteration).
    """
    C, N, P = path_cost.shape
    assert N % L == 0 and L <= 64
    K = N // L
    i32 = jnp.int32
    INF32 = i32(_INF32)

    # K-leading layout [K, C, L, P]: one transpose up front, none in
    # the per-segment pipeline (scan/vmap both want K leading)
    cost_seg = jnp.moveaxis(path_cost.reshape(C, K, L, P), 1, 0)
    mask_seg = jnp.moveaxis(mask.reshape(C, K, L, P), 1, 0)
    sw_seg = jnp.moveaxis(
        switch.at[:, 0].set(0).reshape(C, K, L), 1, 0
    ).astype(i32)                                        # [K,C,L]

    # (real, badness) split: real costs and masked-cell counts cumsum
    # separately, so prefix DIFFERENCES stay exact in int32 (a run is
    # dead iff its badness difference is positive) without int64 INF
    # arithmetic. Requires unmasked costs < 2^24 (phred costs are
    # <= ~60) and L <= 64 (badness fits int8).
    creal = jnp.where(mask_seg, cost_seg, 0).astype(i32)
    cr = jnp.cumsum(creal, axis=2)                       # [K,C,L,P] i32
    cb = jnp.cumsum((~mask_seg).astype(jnp.int8), axis=2)
    crs = jnp.concatenate(                               # value at u-1
        [jnp.zeros((K, C, 1, P), i32), cr[:, :, : L - 1, :]], axis=2
    )
    cbs = jnp.concatenate(
        [jnp.zeros((K, C, 1, P), jnp.int8), cb[:, :, : L - 1, :]], axis=2
    )

    cpre32 = jnp.where(cb > 0, INF32, cr)                # [K,C,L,P]
    s_real = cr[:, :, L - 1, :]                          # [K,C,P]
    s_bad = cb[:, :, L - 1, :]
    s32 = jnp.where(s_bad > 0, INF32, s_real)            # [K,C,P]

    # V[u, t] = min_i (run cost u..t), INF32 when every path's run is
    # dead; u processed in blocks so the prefix tables are re-read
    # L/G times instead of L times
    G = min(8, L)
    assert L % G == 0

    def vblock(b, acc):
        rows_r = jax.lax.dynamic_slice_in_dim(crs, b * G, G, axis=2)
        rows_b = jax.lax.dynamic_slice_in_dim(cbs, b * G, G, axis=2)
        dr = cr[:, :, None, :, :] - rows_r[:, :, :, None, :]
        db = cb[:, :, None, :, :] - rows_b[:, :, :, None, :]
        val = jnp.min(jnp.where(db > 0, INF32, dr), axis=4)  # [K,C,G,L]
        return jax.lax.dynamic_update_slice_in_dim(acc, val, b * G, axis=2)

    v = jax.lax.fori_loop(
        0, L // G, vblock, jnp.full((K, C, L, L), INF32, i32)
    )

    gamma0 = jnp.minimum(
        sw_seg[:, :, 0, None] + v[:, :, 0, :], INF32
    )                                                    # [K,C,L]
    ar = jnp.arange(L)
    if L > 1:
        gamma_rest = jnp.minimum(
            sw_seg[:, :, 1:, None] + v[:, :, 1:, :], INF32
        )                                                # [K,C,L-1,L]
        delta = jnp.concatenate(
            [gamma_rest, jnp.full((K, C, 1, L), INF32, i32)], axis=2
        )
        delta = jnp.where(
            ar[None, None, :, None] < ar[None, None, None, :], delta, INF32
        )
        dstar = _closure_minplus(delta)
    else:
        dstar = jnp.zeros((K, C, 1, 1), i32)

    # E[u, i] = w_u + suffix run cost u..L-1 of path i (INF32 if dead).
    # Within-segment tables clamp to INF32: segment-relative costs are
    # tiny (<= L * ~110 phred) next to 2^29, so a clamped-INF term can
    # never beat a live alternative (entry-vector spread within one
    # segment is bounded by segment costs).
    er = s_real[:, :, None, :] - crs                     # [K,C,L,P]
    eb = s_bad[:, :, None, :] - cbs
    e32 = jnp.minimum(
        sw_seg[:, :, :, None] + jnp.where(eb > 0, INF32, er), INF32
    )

    # ---- sequential combine over segments (the only K-depth pass) ----
    # All int32 (32-bit integer math is native on every accelerator).
    # Live global scores must stay below INF32 = 2^29 (the
    # caller guards N * ~130 phred/column < 2^29); dead-path values are
    # clamped into [2^29, 2^30], so live-vs-dead ordering is exact and
    # truly-dead entry values are overwritten by the mask/poison
    # overrides below anyway.
    INF2 = i32(1 << 30)
    # mm_u = m_{u-1}: shift dstar's t-axis once here instead of a
    # concatenate inside the scan body
    dstar_shift = jnp.concatenate(
        [jnp.full((K, C, L, 1), INF32, i32), dstar[:, :, :, : L - 1]],
        axis=3,
    )
    u0 = jnp.arange(L) == 0

    def combine(x, seg):
        cpre_k, dsh_k, e_k, s_k, g0_k = seg
        m_x = jnp.min(x, axis=1)                          # [C]
        base = jnp.min(x[:, None, :] + cpre_k, axis=2)    # [C,L]
        r = jnp.minimum(jnp.minimum(base, m_x[:, None] + g0_k), INF2)
        mm = jnp.minimum(
            jnp.min(r[:, :, None] + dsh_k, axis=1),
            jnp.where(u0[None, :], m_x[:, None], INF2),
        )
        mm = jnp.minimum(mm, INF2)
        y = jnp.minimum(x + s_k, jnp.min(mm[:, :, None] + e_k, axis=1))
        y = jnp.minimum(y, INF2)
        return y, x                                       # emit ENTRY

    x0 = jnp.zeros((C, P), i32)
    x_final, entries = jax.lax.scan(
        combine, x0, (cpre32, dstar_shift, e32, s32, gamma0),
    )                                                    # entries [K,C,P]

    # poison semantics: the original scan NEVER recovers after a fully
    # masked column (helper stays UINT_MAX forever); the clamped-INF
    # algebra would "recover", so override every value at or after such
    # a column. Interior poisoning within a segment is reproduced by
    # the exact second pass once its entry vector is corrected.
    alive = mask.any(axis=2)                             # [C,N]
    poisoned = jnp.cumsum((~alive).astype(jnp.int32), axis=1) > 0

    umax32 = jnp.uint32(0xFFFFFFFF)
    final_u32 = jnp.where(
        mask[:, N - 1, :] & ~poisoned[:, N - 1, None],
        x_final.astype(jnp.uint32), umax32
    )
    best_index = jnp.argmin(final_u32, axis=1).astype(jnp.int32)  # [C]
    best_score = jnp.min(final_u32, axis=1)

    # entry vectors in exact uint32 form (masked/poisoned -> UINT_MAX)
    entry_mask = jnp.concatenate(
        [jnp.zeros((1, C, P), bool), mask_seg[: K - 1, :, L - 1, :]],
        axis=0,
    )                                                    # [K,C,P]
    entry_poison = jnp.concatenate(
        [jnp.zeros((1, C), bool),
         poisoned.reshape(C, K, L)[:, : K - 1, L - 1].swapaxes(0, 1)],
        axis=0,
    )                                                    # [K,C]
    entries_u32 = jnp.where(
        entry_mask & ~entry_poison[:, :, None],
        entries.astype(jnp.uint32), umax32
    )

    # ---- pass 2: exact per-segment forward with original semantics ----
    # All K segments advance their column-t step TOGETHER: one scan
    # over t with [K,C,P] state (a vmapped per-segment scan would slice
    # the column axis stridedly). The body
    # mirrors _viterbi_iteration's fwd exactly (min1/min2 first-
    # occurrence ids, strict-< stay rule), so backtraces are
    # bit-identical to the reference scan.
    umax = jnp.uint32(0xFFFFFFFF)
    p_iota = jnp.arange(P)
    p_row = jnp.arange(P)[None, None, :]
    cost_cols = jnp.moveaxis(cost_seg, 2, 0)             # [L,K,C,P]
    mask_cols = jnp.moveaxis(mask_seg, 2, 0)
    sw_cols = jnp.moveaxis(sw_seg.astype(jnp.uint32), 2, 0)  # [L,K,C]
    isf = jnp.concatenate(
        [jnp.ones((1, C), bool), jnp.zeros((K - 1, C), bool)], axis=0
    )

    def fwd(carry, inputs):
        prev, prev_mask, is_first = carry                 # [K,C,P]x2,[K,C]
        cost_n, mask_n, sw = inputs
        masked_prev = jnp.where(prev_mask, prev, umax)
        first_val = jnp.min(masked_prev, axis=2)          # [K,C]
        first_id = jnp.argmin(masked_prev, axis=2)
        rest = jnp.where(p_row == first_id[:, :, None], umax, masked_prev)
        second_val = jnp.min(rest, axis=2)
        second_id = jnp.argmin(rest, axis=2)
        is_first_col = p_row == first_id[:, :, None]
        helper_val = jnp.where(
            is_first_col, second_val[:, :, None], first_val[:, :, None]
        )
        helper_id = jnp.where(
            is_first_col, second_id[:, :, None], first_id[:, :, None]
        )
        prev_cell = _sat_add(helper_val, sw[:, :, None])
        backtrace = helper_id.astype(jnp.int32)
        take_stay = prev_mask & (prev < prev_cell)
        prev_cell = jnp.where(take_stay, prev, prev_cell)
        backtrace = jnp.where(take_stay, p_row.astype(jnp.int32), backtrace)
        prev_cell = jnp.where(is_first[:, :, None], jnp.uint32(0), prev_cell)
        backtrace = jnp.where(is_first[:, :, None], jnp.int32(0), backtrace)
        cur = _sat_add(prev_cell, cost_n)
        cur = jnp.where(mask_n, cur, umax)
        return (cur, mask_n, jnp.zeros((K, C), bool)), backtrace

    (_, _, _), bts = jax.lax.scan(
        fwd, (entries_u32, entry_mask, isf),
        (cost_cols, mask_cols, sw_cols),
    )                                                    # bts [L,K,C,P]

    # backward chase: ONE reverse scan over segments, each step chasing
    # its L columns with [C]-wide gathers (a per-exit-state route-map
    # composition costs N*P gathers, while the single traced path only
    # needs N*C)
    bts_k = jnp.moveaxis(bts, 0, 1)                      # [K,L,C,P]

    def chase_seg(sigma, bt_seg):                        # bt_seg [L,C,P]
        # statically unrolled over the segment: 32 dependent tiny
        # gathers schedule tighter than a fori_loop's bookkeeping
        outs = []
        for col in range(L - 1, -1, -1):
            outs.append(sigma)
            sigma = jnp.take_along_axis(
                bt_seg[col], sigma[:, None], axis=1
            )[:, 0]
        return sigma, jnp.stack(outs[::-1])              # [L,C]

    _, path_cols = jax.lax.scan(
        chase_seg, best_index, bts_k, reverse=True
    )                                                    # [K,L,C]
    paths = jnp.transpose(path_cols, (2, 0, 1)).reshape(C, N)
    return paths, best_score


_BLOCK_L = 32
_blocked_viterbi_jit = jax.jit(_blocked_viterbi, static_argnames=("L",))


def _blocked_eligible(n_columns: int) -> bool:
    """Blocked formulation pays off once the column scan's serial
    latency dominates; below ~4k columns the plain scan is fine. The
    upper bound keeps live int32 scores (~130 phred/column worst case)
    below the INF32 = 2^29 dead-path marker."""
    import os

    return (
        4096 <= n_columns <= 4_000_000
        and not os.environ.get("PANGENIE_TPU_NO_BLOCKED_SAMPLING")
    )


def _viterbi_iteration_auto(path_cost, mask, switch):
    """Single-instance dispatch: the blocked formulation (padded to a
    multiple of _BLOCK_L with neutral cost-0/switch-1 columns, which
    preserve the final argmin, score and backtraces — see
    sample_panels_batched) when the chromosome is long enough."""
    N, P = path_cost.shape
    if _blocked_eligible(N):
        pad = (-N) % _BLOCK_L
        if pad:
            path_cost = jnp.concatenate(
                [path_cost, jnp.zeros((pad, P), path_cost.dtype)]
            )
            mask = jnp.concatenate([mask, jnp.ones((pad, P), bool)])
            switch = jnp.concatenate(
                [switch, jnp.ones((pad,), switch.dtype)]
            )
        paths, score = _blocked_viterbi_jit(
            path_cost[None], mask[None], switch[None], L=_BLOCK_L
        )
        return paths[0, :N], score[0]
    return _viterbi_iteration(path_cost, mask, switch)


@jax.jit
def _segment_forward(carry, path_cost, mask, switch_cost):
    """Run the forward recurrence over one column segment, returning
    only the end-of-segment carry (no backtraces stored)."""
    N, P = path_cost.shape
    umax = jnp.uint32(0xFFFFFFFF)
    idx = jnp.arange(P)

    def fwd(c, inputs):
        prev, prev_mask, is_first = c
        cost_n, mask_n, sw = inputs
        masked_prev = jnp.where(prev_mask, prev, umax)
        first_val = jnp.min(masked_prev)
        first_id = jnp.argmin(masked_prev)
        rest = jnp.where(idx == first_id, umax, masked_prev)
        second_val = jnp.min(rest)
        helper_val = jnp.where(idx == first_id, second_val, first_val)
        prev_cell = _sat_add(helper_val, sw)
        stay = prev
        take_stay = prev_mask & (stay < prev_cell)
        prev_cell = jnp.where(take_stay, stay, prev_cell)
        prev_cell = jnp.where(is_first, jnp.uint32(0), prev_cell)
        cur = _sat_add(prev_cell, cost_n)
        cur = jnp.where(mask_n, cur, umax)
        return (cur, mask_n, jnp.zeros((), bool)), None

    carry, _ = jax.lax.scan(fwd, carry, (path_cost, mask, switch_cost))
    return carry


@jax.jit
def _segment_backtrace(carry, path_cost, mask, switch_cost, state_in):
    """Recompute one segment's backtraces from its entry carry and
    chase the pointer path from state_in (the chosen state at the
    column AFTER the segment, or the argmin of the final column when
    state_in < 0)."""
    N, P = path_cost.shape
    umax = jnp.uint32(0xFFFFFFFF)
    idx = jnp.arange(P)

    def fwd(c, inputs):
        prev, prev_mask, is_first = c
        cost_n, mask_n, sw = inputs
        masked_prev = jnp.where(prev_mask, prev, umax)
        first_val = jnp.min(masked_prev)
        first_id = jnp.argmin(masked_prev)
        rest = jnp.where(idx == first_id, umax, masked_prev)
        second_val = jnp.min(rest)
        second_id = jnp.argmin(rest)
        helper_val = jnp.where(idx == first_id, second_val, first_val)
        helper_id = jnp.where(idx == first_id, second_id, first_id)
        prev_cell = _sat_add(helper_val, sw)
        backtrace = helper_id.astype(jnp.int32)
        stay = prev
        take_stay = prev_mask & (stay < prev_cell)
        prev_cell = jnp.where(take_stay, stay, prev_cell)
        backtrace = jnp.where(take_stay, idx.astype(jnp.int32), backtrace)
        prev_cell = jnp.where(is_first, jnp.uint32(0), prev_cell)
        backtrace = jnp.where(is_first, jnp.int32(0), backtrace)
        cur = _sat_add(prev_cell, cost_n)
        cur = jnp.where(mask_n, cur, umax)
        return (cur, mask_n, jnp.zeros((), bool)), (cur, backtrace)

    (last, _, _), (values, backtraces) = jax.lax.scan(
        fwd, carry, (path_cost, mask, switch_cost)
    )
    # entry state: either handed in from the next segment's chase, or
    # (for the final segment) the argmin of the last column
    state = jnp.where(
        state_in >= 0, state_in, jnp.argmin(last).astype(jnp.int32)
    )

    def chase(s, bt):
        return bt[s], s

    state_out, path = jax.lax.scan(chase, state, backtraces, reverse=True)
    return state_out, path, jnp.min(last)


def _viterbi_iteration_segmented(
    path_cost: np.ndarray, mask: np.ndarray, switch: np.ndarray,
    segment: int,
):
    """Checkpointed single-path Viterbi: O(segment * P) device memory
    instead of O(N * P) — the device analogue of the reference's
    sqrt(N) sparse table (src/haplotypesampler.cpp:116-126). Host
    arrays stream segment by segment; forward runs once storing only
    segment-boundary carries, backtraces are recomputed per segment
    during the backward chase (2x forward compute, as in the
    reference)."""
    N, P = path_cost.shape
    n_segs = (N + segment - 1) // segment

    carries = []
    carry = (
        jnp.zeros(P, jnp.uint32), jnp.zeros(P, bool), jnp.ones((), bool)
    )
    for s in range(n_segs):
        carries.append(carry)
        sl = slice(s * segment, min(N, (s + 1) * segment))
        carry = _segment_forward(
            carry, jnp.asarray(path_cost[sl]), jnp.asarray(mask[sl]),
            jnp.asarray(switch[sl]),
        )

    path = np.empty(N, dtype=np.int32)
    state = jnp.int32(-1)
    best_score = None
    for s in range(n_segs - 1, -1, -1):
        sl = slice(s * segment, min(N, (s + 1) * segment))
        state, seg_path, seg_best = _segment_backtrace(
            carries[s], jnp.asarray(path_cost[sl]), jnp.asarray(mask[sl]),
            jnp.asarray(switch[sl]), state,
        )
        path[sl] = np.asarray(seg_path)
        if best_score is None:
            best_score = seg_best  # from the final segment's last column
    return jnp.asarray(path), best_score


class HaplotypeSampler:
    """Greedy panel reduction; constructor does everything
    (reference src/haplotypesampler.cpp:20-77).
    """

    def __init__(
        self,
        records: Sequence[UniqueKmersRecord],
        size: int,
        recombrate: float = 1.26,
        effective_N: float = 25000.0,
        best_scores: Optional[List[int]] = None,
        add_reference: bool = False,
        path_output: str = "",
        chromosome: str = "None",
        allele_penalty: int = 10,
    ):
        self.records = records
        self.sampled_paths: List[List[int]] = []
        if size < 1:
            return

        N = len(records)
        if N == 0:
            return
        P = records[0].get_nr_paths()

        # dense emission state: [N, A_max] allele costs + [N, P] alleles
        costs = bulk_emission_costs(records)
        alleles = np.empty((N, P), dtype=np.int32)
        for n, r in enumerate(records):
            alleles[n] = r.path_to_allele

        positions = np.fromiter(
            (r.variant_position for r in records), dtype=np.int64, count=N
        )
        switch = np.zeros(N, dtype=np.uint32)
        if N > 1:
            # vectorized sampling_transition_cost in long double
            LD = np.longdouble
            distance = (
                np.diff(positions).astype(LD)
                * LD(0.000004) * LD(recombrate) * LD(effective_N)
            )
            recomb_prob = (LD(1.0) - np.exp(-distance / LD(P))) * (
                LD(1.0) / LD(P)
            )
            switch[1:] = np.trunc(-10.0 * np.log10(recomb_prob)).astype(
                np.uint32
            )
        switch_j = jnp.asarray(switch)
        alleles_j = jnp.asarray(alleles)

        # beyond this many columns, use the checkpointed scan: device
        # memory O(segment * P) instead of O(N * P)
        SEGMENT = 1 << 16
        used = np.zeros((N, P), dtype=bool)  # masked (already sampled)
        for _ in range(size):
            if N > SEGMENT:
                host_cost = np.take_along_axis(costs, alleles, axis=1)
                path, score = _viterbi_iteration_segmented(
                    host_cost, ~used, switch, SEGMENT
                )
            else:
                mask = jnp.asarray(~used)
                path_cost = jnp.take_along_axis(
                    jnp.asarray(costs), alleles_j, axis=1
                )
                path, score = _viterbi_iteration_auto(
                    path_cost, mask, switch_j
                )
            path = np.asarray(path)
            if best_scores is not None:
                best_scores.append(int(score))
            self.sampled_paths.append(path.tolist())
            # mask the chosen path ids and penalize their alleles
            used[np.arange(N), path] = True
            chosen_alleles = alleles[np.arange(N), path]
            pen = costs[np.arange(N), chosen_alleles] + allele_penalty
            costs[np.arange(N), chosen_alleles] = np.where(pen > 25, 25, pen)

        if add_reference:
            self.sampled_paths.append([0] * N)

        if path_output:
            self._write_paths(path_output, chromosome)

        self._update_unique_kmers()

    # -- outputs -----------------------------------------------------------

    def _write_paths(self, path_output: str, chromosome: str) -> None:
        """Per-column sampled path/recombination TSV
        (reference src/haplotypesampler.cpp:45-66).

        Bulk-formatted: path ids, recombination flags and positions are
        assembled as one [N, 1+2S] integer matrix, string-joined per row
        and written in a single call (no per-column/per-path writes)."""
        S = len(self.sampled_paths)
        N = len(self.records)
        header = "#chromosome\tposition" + "".join(
            f"\tHaplotypeID_path{p}\tRecombination_path{p}" for p in range(S)
        )
        sampled = np.asarray(self.sampled_paths, dtype=np.int64)  # [S, N]
        recomb = np.zeros_like(sampled)
        if N > 1:
            recomb[:, 1:] = (np.diff(sampled, axis=1) != 0).astype(np.int64)
        body = np.empty((N, 1 + 2 * S), dtype=np.int64)
        body[:, 0] = np.fromiter(
            (r.get_variant_position() for r in self.records),
            dtype=np.int64, count=N,
        )
        body[:, 1::2] = sampled.T
        body[:, 2::2] = recomb.T
        prefix = chromosome + "\t"
        lines = [
            prefix + "\t".join(map(str, row)) for row in body.tolist()
        ]
        with open(path_output, "w") as out:
            out.write(header + "\n")
            out.write("\n".join(lines))
            if lines:
                out.write("\n")

    def _update_unique_kmers(self) -> None:
        """Rewrite every record onto the sampled path set
        (reference src/haplotypesampler.cpp:296-309)."""
        if not self.sampled_paths:
            return
        from ..kmers.unique import bulk_update_paths

        sampled = np.asarray(self.sampled_paths, dtype=np.int64)  # [S, N]
        bulk_update_paths(self.records, sampled)

    def get_sampled_paths(self) -> List[List[int]]:
        return self.sampled_paths


@partial(jax.jit, static_argnames=("size", "allele_penalty"))
def _sample_group(costs, alleles, switch, valid, size: int,
                  allele_penalty: int):
    """Device-resident batched greedy sampling.

    Args:
      costs: [C, N, A] uint32 initial per-allele emission costs.
      alleles: [C, N, P] int32 path->allele.
      switch: [C, N] uint32 per-column switch costs (1 in padding).
      valid: [C, N] bool — False on padding columns (their mask and
        penalty updates are suppressed so they stay neutral).
      size: number of greedy iterations.

    Returns: [size, C, N] int32 sampled path per iteration.

    The whole loop runs as one XLA program: per iteration a vmapped
    min-plus Viterbi picks a path per chromosome, then the chosen
    paths are masked and their alleles penalized with broadcast
    (scatter-free) updates — host<->device traffic is limited to the
    inputs once and the final paths.
    """
    C, N, P = alleles.shape
    p_iota = jnp.arange(P)

    blocked = _blocked_eligible(N) and N % _BLOCK_L == 0

    def iteration(carry, _):
        path_cost, used = carry
        if blocked:
            paths, _scores = _blocked_viterbi(
                path_cost, ~used, switch, _BLOCK_L
            )
        else:
            paths, _scores = jax.vmap(_viterbi_iteration)(
                path_cost, ~used, switch
            )
        hit = (p_iota[None, None, :] == paths[:, :, None]) & valid[
            :, :, None
        ]
        used = used | hit
        # penalize the chosen allele IN PLACE on the path-cost tensor:
        # every path carrying that allele shares the same cost cell, so
        # a broadcast where over [C, N, P] replaces the per-iteration
        # [C, N, P] gather from the [C, N, A] cost table (identical
        # result, far less memory traffic)
        chosen = jnp.take_along_axis(
            alleles, paths[:, :, None], axis=2
        )[:, :, 0]
        sel = (alleles == chosen[:, :, None]) & valid[:, :, None]
        pen = jnp.minimum(
            path_cost + jnp.uint32(allele_penalty), jnp.uint32(25)
        )
        path_cost = jnp.where(sel, pen, path_cost)
        return (path_cost, used), paths

    used0 = jnp.zeros((C, N, P), bool)
    path_cost0 = jnp.take_along_axis(costs, alleles, axis=2)
    (_, _), all_paths = jax.lax.scan(
        iteration, (path_cost0, used0), None, length=size
    )
    return all_paths


class _ChromState:
    """Dense per-chromosome sampling state for the batched driver."""

    def __init__(self, chromosome: str, records: Sequence[UniqueKmersRecord],
                 recombrate: float, effective_N: float):
        self.chromosome = chromosome
        self.records = records
        self.N = len(records)
        self.P = records[0].get_nr_paths()
        self.costs = bulk_emission_costs(records)  # [N, A]
        alleles = np.empty((self.N, self.P), dtype=np.int32)
        for n, r in enumerate(records):
            alleles[n] = r.path_to_allele
        self.alleles = alleles
        positions = np.fromiter(
            (r.variant_position for r in records), dtype=np.int64,
            count=self.N,
        )
        self.switch = np.zeros(self.N, dtype=np.uint32)
        if self.N > 1:
            LD = np.longdouble
            distance = (
                np.diff(positions).astype(LD)
                * LD(0.000004) * LD(recombrate) * LD(effective_N)
            )
            recomb_prob = (LD(1.0) - np.exp(-distance / LD(self.P))) * (
                LD(1.0) / LD(self.P)
            )
            self.switch[1:] = np.trunc(
                -10.0 * np.log10(recomb_prob)
            ).astype(np.uint32)
        self.used = np.zeros((self.N, self.P), dtype=bool)
        self.sampled_paths: List[List[int]] = []


def sample_panels_batched(
    chrom_records: "dict[str, Sequence[UniqueKmersRecord]]",
    size: int,
    recombrate: float = 1.26,
    effective_N: float = 25000.0,
    add_reference: bool = False,
    path_outputs: "Optional[dict[str, str]]" = None,
    allele_penalty: int = 10,
    max_group_bytes: int = 2 << 30,
) -> "dict[str, List[List[int]]]":
    """HaplotypeSampler over several chromosomes as BATCHED device scans.

    Chromosomes are independent, so each greedy iteration runs as ONE
    vmapped min-plus Viterbi over a [C, N_max, P] batch instead of C
    sequential dispatches — the production path for whole-genome
    sampling (the reference dispatches one thread per chromosome,
    src/commands.cpp:864-874; here the batch dim is the parallelism).

    Chromosomes are padded to a group-wide column count with (cost 0 on
    every path, all paths live, switch cost 0) columns. Such columns
    collapse every state onto the REAL final column's first-minimum
    state, reproducing the unpadded final-argmin tie-break exactly, and
    add 0 to the score, so sampled paths and scores are bit-identical
    to the sequential path (tested against HaplotypeSampler). Padded
    columns are excluded from the mask/penalty updates between
    iterations so they stay neutral.

    Chromosomes longer than the segmented-scan threshold fall back to
    the per-chromosome checkpointed path. Groups are capped at
    ``max_group_bytes`` of [C, N, P] cost tensor per dispatch.

    Updates every record's path set in place (as HaplotypeSampler does)
    and returns {chromosome: sampled paths}.
    """
    path_outputs = path_outputs or {}
    out: "dict[str, List[List[int]]]" = {}

    states: List[_ChromState] = []
    for chromosome, records in chrom_records.items():
        if size < 1 or not len(records):
            out[chromosome] = []
            continue
        st = _ChromState(chromosome, records, recombrate, effective_N)
        states.append(st)

    # full [N, P] backtraces live in device memory up to this budget;
    # only truly chromosome-scale states (e.g. 5M columns) fall back to the
    # checkpointed host-streaming scan
    SEGMENT = 1 << 16
    full_budget = 1 << 30
    long_states = [
        s for s in states if s.N * s.P * 4 > full_budget
    ]
    states = [s for s in states if s.N * s.P * 4 <= full_budget]

    # group chromosomes of similar length (padded N within 2x) under a
    # device-memory cap
    states.sort(key=lambda s: s.N)
    groups: List[List[_ChromState]] = []
    for st in states:
        Npad = 1 << max(0, (st.N - 1).bit_length())
        if groups:
            cur = groups[-1]
            cur_pad = 1 << max(0, (cur[0].N - 1).bit_length())
            pad_target = max(cur_pad, Npad)
            bytes_needed = (
                (len(cur) + 1) * pad_target * st.P * 4
            )
            if (1 << max(0, (cur[-1].N - 1).bit_length())) == Npad and \
                    bytes_needed <= max_group_bytes:
                cur.append(st)
                continue
        groups.append([st])

    for group in groups:
        C = len(group)
        N_max = max(s.N for s in group)
        # round up to the blocked formulation's segment multiple (the
        # extra columns are the same neutral padding described below)
        if _blocked_eligible(N_max):
            N_max = -(-N_max // _BLOCK_L) * _BLOCK_L
        P = group[0].P
        A = max(s.costs.shape[1] for s in group)
        # padding columns: emission cost 0 on every path, all paths
        # live, switch cost 1. The positive switch cost makes 'stay'
        # strictly cheaper for every state already at the running
        # minimum, so the real final column's FIRST-minimum state
        # self-sustains through the padding and the padded final argmin
        # lands exactly on it — reproducing the unpadded tie-break
        # (switch cost 0 breaks ties differently: all-equal columns
        # alternate backtraces and the entry state depends on padding
        # parity).
        switch = np.ones((C, N_max), dtype=np.uint32)
        alleles = np.zeros((C, N_max, P), dtype=np.int32)
        valid = np.zeros((C, N_max), dtype=bool)
        costs0 = np.zeros((C, N_max, A), dtype=np.uint32)
        for c, st in enumerate(group):
            switch[c, : st.N] = st.switch
            alleles[c, : st.N] = st.alleles
            valid[c, : st.N] = True
            costs0[c, : st.N, : st.costs.shape[1]] = st.costs

        # the whole greedy loop runs device-resident: ONE dispatch per
        # group, paths for every iteration read back together at the
        # end. (The per-iteration variant re-transferred [C, N, P]
        # cost + mask tensors each round — ~40 MB per iteration on
        # genome-scale groups, the dominant wall of the r2 sampler.)
        all_paths = _sample_group(
            jnp.asarray(costs0), jnp.asarray(alleles), jnp.asarray(switch),
            jnp.asarray(valid), size, int(allele_penalty),
        )
        all_paths = np.asarray(all_paths)  # [size, C, N_max]
        for c, st in enumerate(group):
            for it in range(size):
                st.sampled_paths.append(all_paths[it, c, : st.N].tolist())

    # long chromosomes: per-chromosome segmented scans
    for st in long_states:
        for _ in range(size):
            host_cost = np.take_along_axis(st.costs, st.alleles, axis=1)
            path, _score = _viterbi_iteration_segmented(
                host_cost, ~st.used, st.switch, SEGMENT
            )
            path = np.asarray(path)
            st.sampled_paths.append(path.tolist())
            rows_c = np.arange(st.N)
            st.used[rows_c, path] = True
            chosen = st.alleles[rows_c, path]
            pen = st.costs[rows_c, chosen] + allele_penalty
            st.costs[rows_c, chosen] = np.where(pen > 25, 25, pen)

    for st in states + long_states:
        if add_reference:
            st.sampled_paths.append([0] * st.N)
        sampler = HaplotypeSampler.__new__(HaplotypeSampler)
        sampler.records = st.records
        sampler.sampled_paths = st.sampled_paths
        output = path_outputs.get(st.chromosome, "")
        if output:
            sampler._write_paths(output, st.chromosome)
        sampler._update_unique_kmers()
        out[st.chromosome] = st.sampled_paths
    return out


def get_column_minima(
    column: np.ndarray, mask: np.ndarray
) -> Tuple[int, int, int, int]:
    """(first_id, second_id, first_val, second_val) with the reference's
    tie-breaking (src/haplotypesampler.cpp:79-107). Exposed for tests.
    """
    first_val = second_val = int(UINT_MAX)
    first_id = second_id = int(UINT_MAX)
    for i in range(len(column)):
        if not mask[i]:
            continue
        if column[i] < first_val:
            second_val = first_val
            second_id = first_id
            first_val = int(column[i])
            first_id = i
        elif column[i] < second_val and i != first_id:
            second_val = int(column[i])
            second_id = i
    return first_id, second_id, first_val, second_val
