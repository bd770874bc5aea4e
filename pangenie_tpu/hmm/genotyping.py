"""PairHMM: per-(chromosome, path-subset) genotyping/phasing driver.

Mirrors the reference HMM class contract (src/hmm.cpp:25-63): construct
with records + probabilities + options, run forward/backward (genotype
likelihoods) and/or Viterbi (haplotypes), expose one GenotypeLikelihoods
per variant record. Computation runs as JAX scans (see
forward_backward.py / viterbi.py); this layer densifies inputs and
scatters device outputs back into host result objects, replicating the
reference's bookkeeping quirks:

- Columns skipped by the column indexer keep empty likelihood maps.
- After the backward pass, unique-kmer counts and coverage are stored
  for EVERY record (src/hmm.cpp:106-109).
- The Viterbi backtrack stores haplotype alleles at the record the
  column maps to, but (faithfully to src/hmm.cpp:164-165) writes
  kmer-count/coverage at the COLUMN index.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..kmers.unique import UniqueKmersRecord
from ..model.probabilities import ProbabilityTable
from ..panel.variant import GenotypeLikelihoods
from .columns import HMMColumns, build_columns, transition_probs
from .batch import forward_backward_batch
from .forward_backward import (
    ColumnArrays,
    forward_backward,
    forward_backward_segmented,
)
from .viterbi import viterbi, viterbi_segmented


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (shape-bucketing so XLA
    compiles once per bucket, not once per chromosome)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@jax.jit
def _gather_lp(idx, table):
    """[N, K] uint16 -> [N, K, 3] via the small value table."""
    return table[idx.astype(jnp.int32)]


@jax.jit
def _lp_and_scale(idx, table, kmer_mask):
    """Fused device-side grid gather + per-column rescale constant —
    ONE program where the grid path ran eager scale ops, so the
    compressed transfer does not add compile surface."""
    lp = table[idx.astype(jnp.int32)]
    m = jnp.max(lp, axis=-1)
    m = jnp.where(kmer_mask & jnp.isfinite(m), m, 0.0)
    return lp, jnp.sum(m, axis=-1)


def _to_device_columns(
    columns: HMMColumns,
    recombrate: float,
    effective_N: float,
    uniform: bool,
    dtype,
    bucketed: bool = True,
    as_host: bool = False,
) -> ColumnArrays:
    from .emissions import emission_scale

    N = columns.n_columns
    trans = np.ones((N, 3), dtype=np.float64)
    if N >= 2:
        trans[1:] = transition_probs(
            columns.positions, columns.n_paths, recombrate, effective_N, uniform
        )

    lp = columns.log_probs
    lp_idx = columns.lp_idx
    incidence = columns.incidence
    kmer_mask = columns.kmer_mask
    alleles = columns.alleles
    undefined = columns.undefined
    all_zeros = columns.all_zeros
    allele_local = columns.allele_local
    nr_local = columns.nr_local

    if bucketed:
        # pad columns (N), kmers (K) and alleles (A) up to power-of-two
        # buckets. Padding is EXACT, not approximate:
        # - extra kmer slots are masked out (contribute nothing),
        # - extra allele slots have empty incidence and are never
        #   referenced by allele_local,
        # - extra COLUMNS get all_zeros=True (emission == 1 uniformly)
        #   and stay-only transitions t=(1,0,0): the forward alpha and
        #   backward beta pass through them unchanged, the per-column
        #   normalization constants are 1, and their posteriors are
        #   simply ignored by the scatter. This reproduces the exact
        #   unpadded recurrence values at every real column.
        K = lp.shape[1]
        A = incidence.shape[2]
        P = alleles.shape[1]
        Np, Kp, Ap = _bucket(N, 16), _bucket(K, 8), _bucket(A, 2)

        def pad(arr, shape, fill=0):
            out = np.full(shape, fill, dtype=arr.dtype)
            out[tuple(slice(0, s) for s in arr.shape)] = arr
            return out

        if Kp != K or Ap != A or Np != N:
            lp = pad(lp, (Np, Kp, 3))
            if lp_idx is not None:
                # row 0 of the value table is the zeros row — identical
                # to the grid's 0.0 padding
                lp_idx = pad(lp_idx, (Np, Kp))
            incidence = pad(incidence, (Np, Kp, Ap))
            kmer_mask = pad(kmer_mask, (Np, Kp))
            alleles = pad(alleles, (Np, P))
            undefined = pad(undefined, (Np, Ap))
            all_zeros = pad(all_zeros, (Np,), fill=False)
            all_zeros[N:] = True
            allele_local = pad(allele_local, (Np, P))
            nr_local = pad(nr_local, (Np,))
            trans_p = np.zeros((Np, 3), dtype=np.float64)
            trans_p[:N] = trans
            trans_p[N:, 0] = 1.0  # stay-only through padding columns
            trans = trans_p

    is_last = np.zeros(len(all_zeros), dtype=bool)
    if N > 0:
        is_last[N - 1] = True

    if as_host:
        # numpy leaves for the segmented (streaming) execution path
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        with np.errstate(invalid="ignore"):
            m = np.max(lp, axis=-1)
        m = np.where(kmer_mask & np.isfinite(m), m, 0.0)
        scale_np = np.sum(m, axis=-1).astype(np_dtype)
        return ColumnArrays(
            lp=lp.astype(np_dtype),
            incidence=incidence,
            kmer_mask=kmer_mask,
            alleles=alleles,
            undefined=undefined,
            all_zeros=all_zeros,
            scale=scale_np,
            trans=trans.astype(np_dtype),
            allele_local=allele_local,
            nr_local=nr_local,
            is_last=is_last,
        )

    if lp_idx is not None and not os.environ.get("PANGENIE_TPU_NO_IDX_LP"):
        # ship uint16 table indices (2 B/cell) + the small value table
        # and gather the [N, K, 3] grid ON DEVICE — bit-identical to
        # transferring the f32 grid at a sixth of the bytes (the grid
        # is the HMM phase's biggest single transfer)
        kmer_mask_j = jnp.asarray(kmer_mask)
        lp_j, scale = _lp_and_scale(
            jnp.asarray(lp_idx),
            jnp.asarray(columns.lp_table.astype(
                np.dtype(jnp.dtype(dtype).name))),
            kmer_mask_j,
        )
    else:
        lp_j = jnp.asarray(lp, dtype)
        kmer_mask_j = jnp.asarray(kmer_mask)
        scale = emission_scale(lp_j, kmer_mask_j)
    return ColumnArrays(
        lp=lp_j,
        incidence=jnp.asarray(incidence),
        kmer_mask=kmer_mask_j,
        alleles=jnp.asarray(alleles),
        undefined=jnp.asarray(undefined),
        all_zeros=jnp.asarray(all_zeros),
        scale=scale,
        trans=jnp.asarray(trans, dtype),
        allele_local=jnp.asarray(allele_local),
        nr_local=jnp.asarray(nr_local),
        is_last=jnp.asarray(is_last),
    )


class PairHMM:
    """Forward-Backward + Viterbi over path-pair states.

    With ``defer=True`` the constructor only densifies inputs; call
    :func:`run_deferred` on a list of deferred instances to execute
    them batched — instances whose padded device shapes match run as
    ONE vmapped scan (chromosomes and path subsets become a batch dim).
    """

    def __init__(
        self,
        records: Sequence[UniqueKmersRecord],
        probabilities: ProbabilityTable,
        run_genotyping: bool,
        run_phasing: bool,
        recombrate: float = 1.26,
        uniform: bool = False,
        effective_N: float = 25000.0,
        only_paths: Optional[Sequence[int]] = None,
        normalize: bool = True,
        dtype=jnp.float64,
        defer: bool = False,
        dense=None,
        prebuilt=None,
        bulk: bool = False,
    ):
        import time as _time

        _t0 = _time.monotonic()
        self.runtime = 0.0  # host build + (attributed) device seconds
        self.records = records
        self._run_genotyping = run_genotyping
        self._run_phasing = run_phasing
        self._normalize = normalize
        self._uniform = uniform
        self.genotyping_result: List[GenotypeLikelihoods] = [
            GenotypeLikelihoods() for _ in records
        ]
        # (mask[M], vals[M, 3]) array-resident likelihood channel for
        # canonical biallelic variants, filled by _scatter_genotypes on
        # normalized runs when opted in (the command drivers do; direct
        # users keep the reference's dict-per-variant contract)
        self.bulk_likelihoods = None
        self._bulk_enabled = bulk
        self._host_cols = None
        if not records:
            # a chromosome with no variant records is a no-op HMM
            self.columns = None
            self.device_cols = None
            if not defer:
                self._execute()
            return
        if prebuilt is not None:
            # share densified/padded/transferred columns with another
            # run over the same records + path subset (genotyping and
            # phasing use identical columns whenever their subsets
            # coincide — always true once sampling reduced the panel)
            self.columns, self.device_cols, self._host_cols = prebuilt
            if not defer:
                self._execute()
            self.runtime += _time.monotonic() - _t0
            return
        columns = build_columns(
            records, probabilities, only_paths, dense=dense,
            dtype=np.dtype(jnp.dtype(dtype).name),
        )
        self.columns = columns
        self.device_cols = None
        if columns.n_columns > self.SEGMENT:
            # long chromosome: stream segments (O(segment * P^2) memory)
            self._host_cols = _to_device_columns(
                columns, recombrate, effective_N, uniform, dtype,
                as_host=True,
            )
        elif columns.n_columns > 0:
            self.device_cols = _to_device_columns(
                columns, recombrate, effective_N, uniform, dtype
            )
        if not defer:
            self._execute()
        self.runtime += _time.monotonic() - _t0

    def shared_columns(self):
        """(columns, device_cols, host_cols) for PairHMM(prebuilt=...)."""
        return (self.columns, self.device_cols, self._host_cols)

    SEGMENT = 1 << 17  # columns per streamed segment for long scans

    def _execute(self) -> None:
        if self._host_cols is not None:
            if self._run_genotyping:
                posteriors, log_corr = forward_backward_segmented(
                    self._host_cols, self.SEGMENT
                )
                self._finish_genotyping(posteriors, log_corr)
            if self._run_phasing:
                states = viterbi_segmented(
                    self._host_cols, self.SEGMENT, uniform=self._uniform
                )
                self._scatter_haplotypes(states)
            return
        if self.device_cols is not None:
            if self._run_genotyping:
                # dispatch through the batched entry point (B=1) so the
                # Pallas fast paths also cover single, ungrouped runs
                stacked = jax.tree.map(lambda x: x[None], self.device_cols)
                posteriors, log_corr = forward_backward_batch(stacked)
                self._finish_genotyping(
                    np.asarray(posteriors)[0], np.asarray(log_corr)[0]
                )
            if self._run_phasing:
                states = np.asarray(
                    viterbi(self.device_cols, uniform=self._uniform)
                )
                self._scatter_haplotypes(states)
        elif self._run_genotyping:
            self._store_kmer_stats()

    def _store_kmer_stats(self) -> None:
        for i, record in enumerate(self.records):
            self.genotyping_result[i].nr_unique_kmers = record.size()
            self.genotyping_result[i].coverage = record.get_coverage()

    def _finish_genotyping(
        self, posteriors: np.ndarray, log_corr: np.ndarray
    ) -> None:
        self._scatter_genotypes(
            posteriors, log_corr, normalized=self._normalize
        )
        self._store_kmer_stats()

    # -- host scatter ------------------------------------------------------

    def _scatter_genotypes(
        self, posteriors: np.ndarray, log_corr: np.ndarray,
        normalized: bool = False,
    ) -> None:
        columns = self.columns
        N = columns.n_columns
        if N == 0:
            return
        # undo the device-side emission rescale in extended precision so
        # stored raw likelihoods match the reference's long double scale
        # (they can be far below f64 range, e.g. 1e-400)
        corr = np.exp(log_corr.astype(np.longdouble))
        A = columns.local_alleles.shape[1]
        G = posteriors[:, :A, :A].astype(np.longdouble) * corr[:, None, None]
        # symmetrize: value of unordered pair (i<j) is G[i,j] + G[j,i]
        sym = G + np.swapaxes(G, 1, 2)
        iu, ju = np.triu_indices(A)
        vals = sym[:, iu, ju]                     # [N, A*(A+1)/2]
        diag_cols = np.nonzero(iu == ju)[0]
        vals[:, diag_cols] = G[:, iu[diag_cols], ju[diag_cols]]
        vals = vals[:N]  # drop bucket-padding columns
        if normalized:
            # vectorized GenotypeLikelihoods.normalize over all columns
            # (same math: dominant entry via the reciprocal form so the
            # long-double rounding of near-certain probabilities matches
            # the per-object path at the final ulp). Only pairs with
            # j < nr_local exist; higher pair slots carry zeros and do
            # not perturb totals.
            valid = ju[None, :] < columns.nr_local[:, None]
            vals = np.where(valid, vals, np.longdouble(0.0))
            total = vals.sum(axis=1)
            vmax = vals.max(axis=1)
            pos = total > 0
            with np.errstate(divide="ignore", invalid="ignore"):
                scaled = vals / total[:, None]
                rest = (total - vmax) / vmax
                dom = np.longdouble(1.0) / (np.longdouble(1.0) + rest)
            is_dom = (vals == vmax[:, None]) & (vals > 0)
            out = np.where(is_dom, dom[:, None], scaled)
            vals = np.where(pos[:, None], out, vals)
        la = columns.local_alleles
        nr_local = columns.nr_local
        variant_ids_a = columns.variant_ids[:N]
        # ARRAY-RESIDENT fast channel: canonical biallelic columns
        # (local alleles exactly [0, 1]) keep their normalized
        # {(0,0),(0,1),(1,1)} likelihoods in one [M, 3] longdouble array
        # instead of per-variant dicts; the VCF writers read it directly
        # and only slow-path rows ever materialize a dict. Only active
        # for the single-subset normalized run (cross-subset combine
        # still sums dicts).
        if normalized and self._bulk_enabled:
            elig = (
                (nr_local[:N] == 2) & (la[:N, 0] == 0) & (la[:N, 1] == 1)
            )
            elig_rows = np.nonzero(elig)[0]
            if elig_rows.size:
                M = len(self.genotyping_result)
                mask = np.zeros(M, dtype=bool)
                v3 = np.zeros((M, 3), dtype=np.longdouble)
                vids = variant_ids_a[elig_rows]
                mask[vids] = True
                # pair columns of (0,0), (0,1), (1,1) in triu order
                v3[vids] = vals[elig_rows][:, [0, 1, A]]
                self.bulk_likelihoods = (mask, v3)
            dict_rows = np.nonzero(~elig)[0]
        else:
            dict_rows = np.arange(N)
        if dict_rows.size == 0:
            return
        key_a = la[dict_rows][:, iu].tolist()  # [rows][pairs]
        key_b = la[dict_rows][:, ju].tolist()
        dvals = vals[dict_rows]
        # a pair (i <= j) exists iff j < nr_local; precompute the valid
        # pair-column lists per nr_local value (avoids per-row nonzero)
        d_nr_local = nr_local[dict_rows]
        pair_cols = {
            c: np.nonzero(ju < c)[0].tolist()
            for c in np.unique(d_nr_local).tolist()
        }
        nr_local_list = d_nr_local.tolist()
        variant_ids = variant_ids_a[dict_rows].tolist()
        results = self.genotyping_result
        # zero-valued entries still create map keys, as the reference's
        # operator[] does — the uniqueness check and
        # contains_no_likelihoods() observe them
        for n in range(dict_rows.size):
            ka, kb, vn = key_a[n], key_b[n], dvals[n]
            results[variant_ids[n]].likelihoods = {
                (ka[c], kb[c]): vn[c] for c in pair_cols[nr_local_list[n]]
            }

    def _scatter_haplotypes(self, states: np.ndarray) -> None:
        columns = self.columns
        N = columns.n_columns
        if N == 0:
            return
        P = columns.n_paths
        # bulk index math on arrays; the remaining loop only assigns
        # plain ints to result objects (no per-column numpy scalars)
        states = np.asarray(states[:N], dtype=np.int64)
        rows = np.arange(N)
        allele1 = columns.alleles[rows, states // P].tolist()
        allele2 = columns.alleles[rows, states % P].tolist()
        variant_ids = columns.variant_ids.tolist()
        results = self.genotyping_result
        for n in range(N):
            g = results[variant_ids[n]]
            g.haplotype_1 = allele1[n]
            g.haplotype_2 = allele2[n]
        # reference quirk: kmer count / coverage written at the
        # COLUMN index, not the variant id (src/hmm.cpp:164-165)
        for n in range(N):
            g = results[n]
            record = self.records[n]
            g.nr_unique_kmers = record.size()
            g.coverage = record.get_coverage()

    # -- reference-parity accessors ----------------------------------------

    def get_genotyping_result(self) -> List[GenotypeLikelihoods]:
        return self.genotyping_result

    def move_genotyping_result(self) -> List[GenotypeLikelihoods]:
        result = self.genotyping_result
        self.genotyping_result = []
        return result

    def move_bulk_likelihoods(self):
        """(mask, vals) array-resident biallelic likelihoods, or None."""
        bulk = self.bulk_likelihoods
        self.bulk_likelihoods = None
        return bulk

    @staticmethod
    def run_deferred(hmms: Sequence["PairHMM"]) -> None:
        """Execute deferred PairHMMs, batching shape-compatible runs.

        Genotyping runs whose padded device tensors have identical
        shapes (same bucket: chromosomes of similar size, path subsets
        of the same panel) execute as ONE vmapped forward-backward —
        the (chromosome x subset) grid becomes a batch dimension, as in
        the reference's thread pool over the same grid
        (src/commands.cpp:955-978). Phasing (Viterbi) runs likewise.
        """
        import jax

        groups = {}
        for hmm in hmms:
            if hmm.device_cols is None:
                if hmm._host_cols is not None:
                    hmm._execute()  # segmented streaming path
                elif hmm._run_genotyping:
                    hmm._store_kmer_stats()
                continue
            key = tuple(x.shape for x in hmm.device_cols)
            groups.setdefault((key, hmm._run_genotyping, hmm._run_phasing,
                               hmm._uniform), []).append(hmm)

        import os

        n_devices = len(jax.devices())
        for (key, run_g, run_p, uniform), members in groups.items():
            if len(members) == 1:
                members[0]._execute()
                continue
            if (
                n_devices > 1
                and not os.environ.get("PANGENIE_TPU_NO_LOCAL_SHARD")
            ):
                # single-process multi-device: the work-item grid shards
                # over the local devices (bit-identical per-item math;
                # see run_grid_local_sharded)
                from ..parallel.genotyping import run_grid_local_sharded

                posteriors, log_corr, states = run_grid_local_sharded(
                    [h.device_cols for h in members], run_g, run_p,
                    uniform, n_devices,
                )
                if run_g:
                    for i, hmm in enumerate(members):
                        hmm._finish_genotyping(posteriors[i], log_corr[i])
                if run_p:
                    for i, hmm in enumerate(members):
                        hmm._scatter_haplotypes(states[i])
                continue
            stacked = jax.tree.map(
                lambda *xs: jnp.stack(xs), *[h.device_cols for h in members]
            )
            if run_g:
                posteriors, log_corr = forward_backward_batch(stacked)
                posteriors = np.asarray(posteriors)
                log_corr = np.asarray(log_corr)
                for i, hmm in enumerate(members):
                    hmm._finish_genotyping(posteriors[i], log_corr[i])
            if run_p:
                states = np.asarray(
                    jax.vmap(lambda c: viterbi(c, uniform=uniform))(stacked)
                )
                for i, hmm in enumerate(members):
                    hmm._scatter_haplotypes(states[i])

    def combine_likelihoods(self, other: "PairHMM") -> None:
        if len(self.genotyping_result) != len(other.genotyping_result):
            raise RuntimeError(
                "PairHMM.combine_likelihoods: HMMs must be the same size."
            )
        for mine, theirs in zip(self.genotyping_result, other.genotyping_result):
            mine.combine(theirs)

    def normalize(self) -> None:
        for g in self.genotyping_result:
            g.normalize()
