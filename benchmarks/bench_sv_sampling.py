"""Benchmarks for the two BASELINE configs without a cell in bench.py.

The SV-rich multi-allelic forward-backward path (reference equivalent
src/multiallelicuniquekmers.cpp feeding src/hmm.cpp; batches with
A > 32 alleles run the XLA scan) and a 200+ haplotype panel with the
sampling DP engaged (reference src/haplotypesampler.cpp:20-314), plus
the phasing Viterbi.

Prints one JSON line per config. Timing: best of two warm reps, each
ended by a device-side reduction copied to the host.

Usage: python benchmarks/bench_sv_sampling.py [sv] [mixed] [sampling] [phasing]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_sv_multiallelic():
    """SV-shaped workload: A=16 merged alleles per bubble, K=32 kmers
    (the multiallelic cap), P=32 paths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm import batch as hmm_batch
    from pangenie_tpu.hmm.batch import forward_backward_batch
    from pangenie_tpu.utils.synthetic import synthetic_columns

    B, N, P, K, A = 32, 4096, 32, 32, 16

    def make(seed):
        cols = synthetic_columns(
            n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
            batch_dims=(B,), dtype=jnp.float32, seed=seed,
        )
        return type(cols)(*[jnp.asarray(x) for x in cols])

    reps = 3
    inputs = [make(seed) for seed in range(reps + 1)]

    def device_sum(result):
        return sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(result))

    float(np.asarray(device_sum(forward_backward_batch(inputs[-1]))))
    best = float("inf")
    for _ in range(2):
        start = time.perf_counter()
        results = [forward_backward_batch(inputs[s]) for s in range(reps)]
        total = sum(device_sum(r) for r in results)
        float(np.asarray(total))
        best = min(best, (time.perf_counter() - start) / reps)
    print(json.dumps({
        "metric": "hmm_sv_multiallelic_columns_per_sec_per_chip",
        "value": round(B * N / best, 1),
        "unit": "columns/s",
        "dispatch": hmm_batch.last_dispatch,
        "alleles_per_column": A,
        "kmers_per_column": K,
        "paths": P,
        "ms_per_batch": round(best * 1000, 1),
        "backend": jax.devices()[0].platform,
    }), flush=True)


def bench_sampling_200hap():
    """Greedy haplotype-sampling DP at a 220-haplotype panel:
    15 masked min-plus Viterbi iterations over [C, N, P] on device —
    the auto-sampling configuration every >100-haplotype panel runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm.sampling import _sample_group

    C, N, P, A, SIZE = 2, 65536, 220, 4, 15
    rng = np.random.default_rng(0)

    sample = jax.jit(_sample_group, static_argnames=("size", "allele_penalty"))

    def make(seed):
        r = np.random.default_rng(seed)
        costs = jnp.asarray(
            r.integers(0, 26, size=(C, N, A)).astype(np.uint32)
        )
        alleles = jnp.asarray(
            r.integers(0, A, size=(C, N, P)).astype(np.int32)
        )
        switch = jnp.asarray(
            r.integers(1, 40, size=(C, N)).astype(np.uint32)
        )
        valid = jnp.ones((C, N), bool)
        return costs, alleles, switch, valid

    inputs = [make(seed) for seed in range(3)]
    out = sample(*inputs[2], size=SIZE, allele_penalty=5)
    float(np.asarray(jnp.sum(out)))
    best = float("inf")
    for i in range(2):
        start = time.perf_counter()
        out = sample(*inputs[i], size=SIZE, allele_penalty=5)
        float(np.asarray(jnp.sum(out)))
        best = min(best, time.perf_counter() - start)
    print(json.dumps({
        "metric": "sampling_dp_column_iters_per_sec_per_chip",
        "value": round(C * N * SIZE / best, 1),
        "unit": "column-iters/s",
        "paths": P,
        "panel_size": SIZE,
        "columns": C * N,
        "wall_s": round(best, 3),
        "backend": jax.devices()[0].platform,
    }), flush=True)


def bench_mixed_sv():
    """REALISTIC mixed workload: ~97% biallelic columns + ~2% small
    multiallelic (A<=4) + ~1% SV-scale (A<=16) in ONE batch — the shape
    every real chromosome has. A single A=16 bubble sets the whole
    batch's allele width; the allele-count profile is reported."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm import batch as hmm_batch
    from pangenie_tpu.hmm.batch import forward_backward_batch
    from pangenie_tpu.utils.synthetic import synthetic_columns

    B, N, P, K, A = 2, 65536, 32, 32, 16

    def make(seed):
        rng = np.random.default_rng(seed)
        cols = synthetic_columns(
            n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
            batch_dims=(B,), dtype=jnp.float32, seed=seed,
        )
        # restrict most columns to a small allele set (mixed profile)
        draw = rng.random(N)
        cap = np.where(draw < 0.97, 2, np.where(draw < 0.99, 4, 16))
        alleles = np.asarray(cols.alleles) % cap[None, :, None]
        nr_local = np.asarray(cols.nr_local).copy()
        nr_local[:] = cap[None, :]
        allele_local = alleles.astype(np.int32)
        return type(cols)(
            lp=jnp.asarray(cols.lp),
            incidence=jnp.asarray(cols.incidence),
            kmer_mask=jnp.asarray(cols.kmer_mask),
            alleles=jnp.asarray(alleles.astype(np.int32)),
            undefined=jnp.asarray(cols.undefined),
            all_zeros=jnp.asarray(cols.all_zeros),
            scale=jnp.asarray(cols.scale),
            trans=jnp.asarray(cols.trans),
            allele_local=jnp.asarray(allele_local),
            nr_local=jnp.asarray(nr_local),
            is_last=jnp.asarray(cols.is_last),
        ), cap

    reps = 2
    made = [make(seed) for seed in range(reps + 1)]
    inputs = [m[0] for m in made]
    cap = np.asarray(made[0][1])
    occupancy = {f"A<={a}": int(np.sum(cap == a)) for a in (2, 4, 16)}

    def device_sum(result):
        return sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(result))

    float(np.asarray(device_sum(forward_backward_batch(inputs[-1]))))
    best = float("inf")
    for _ in range(2):
        start = time.perf_counter()
        results = [forward_backward_batch(inputs[s]) for s in range(reps)]
        total = sum(device_sum(r) for r in results)
        float(np.asarray(total))
        best = min(best, (time.perf_counter() - start) / reps)
    print(json.dumps({
        "metric": "hmm_mixed_sv_columns_per_sec_per_chip",
        "value": round(B * N / best, 1),
        "unit": "columns/s",
        "dispatch": hmm_batch.last_dispatch,
        "profile": "97% A=2 / 2% A=4 / 1% A=16",
        "bucket_occupancy": occupancy,
        "paths": P,
        "ms_per_batch": round(best * 1000, 1),
        "backend": jax.devices()[0].platform,
    }), flush=True)


def bench_phasing_viterbi():
    """The -p mode's core loop: batched max-plus Viterbi over path-pair
    states at the production phasing shape (30-path subset — the
    min(P, 30) cap every big panel hits, reference src/commands.cpp —
    across 2 chromosome blocks). Measures the O(P^2)-state factored
    scan (hmm/viterbi.py), reference equivalent src/hmm.cpp:408-511."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm.viterbi import viterbi
    from pangenie_tpu.utils.synthetic import synthetic_columns

    B, N, P, K = 2, 65536, 30, 16

    def make(seed):
        cols = synthetic_columns(
            n_columns=N, n_paths=P, n_kmers=K, batch_dims=(B,),
            dtype=jnp.float32, seed=seed,
        )
        return type(cols)(*[jnp.asarray(x) for x in cols])

    run = jax.jit(jax.vmap(lambda c: viterbi(c, uniform=False)))
    inputs = [make(seed) for seed in range(3)]
    float(np.asarray(jnp.sum(run(inputs[2]))))  # compile + warm
    best = float("inf")
    for i in range(2):
        start = time.perf_counter()
        states = run(inputs[i])
        float(np.asarray(jnp.sum(states)))  # completion sync
        best = min(best, time.perf_counter() - start)
    print(json.dumps({
        "metric": "phasing_viterbi_columns_per_sec_per_chip",
        "value": round(B * N / best, 1),
        "unit": "columns/s",
        "paths": P,
        "pair_states": P * P,
        "wall_s": round(best, 3),
        "backend": jax.devices()[0].platform,
    }), flush=True)


def main():
    which = set(sys.argv[1:]) or {"sv", "mixed", "sampling", "phasing"}
    if "sv" in which:
        bench_sv_multiallelic()
    if "mixed" in which:
        bench_mixed_sv()
    if "sampling" in which:
        bench_sampling_200hap()
    if "phasing" in which:
        bench_phasing_viterbi()


if __name__ == "__main__":
    main()
