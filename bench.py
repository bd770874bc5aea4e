"""Driver benchmark: JSON lines covering the pipeline's metrics.

Runs on a GPU and nowhere else: without one it exits non-zero. Every
line names the device it ran on (platform, device kind, device count,
and nvidia-smi's name and power limit).

1. hmm_variant_columns_per_sec_per_chip — the HMM hot loop (batched
   f32 forward-backward pair-HMM through hmm.batch), with the plain
   ``jax.vmap(forward_backward)`` XLA scan timed on the same inputs.
   Runs FIRST so the flagship metric is always captured.
2. kmer_count_device_primed_mbps — the genotype-phase read-counting
   engine (PRIME+UPDATE streaming against a fixed graph-kmer table,
   kmers/device_counter.py). vs_baseline: the reference's only e2e
   number implies its Jellyfish phase streams ~90 Gbp of 30x reads
   inside the 55-min 24-core genotyping wall (BASELINE.md)
   => >=27.3 Mbp/s.
3. e2e_genotype_variants_per_sec — a full simulated genotyping run
   (graph build, counting, unique-kmer selection, HMM, VCF write) via
   run_single_command. The workload SIZE adapts to the remaining wall
   budget (PANGENIE_BENCH_BUDGET_S, default 1500 s): 20 Mb when ample,
   10 Mb when tight, a skip line when exhausted. Simulated inputs are
   cached under .work/bench in the checkout.
   vs_baseline: the reference genotypes 36M variants in 55 min on 24
   cores => 10,909 variants/sec.
4. The HMM line from step 1 is RE-PRINTED verbatim as the final line.

Every timed run uses a distinct input buffer and ends in a device-side
reduction whose scalar is copied to the host.
"""

import json
import os
import sys
import time
import traceback

BASELINE_COLUMNS_PER_SEC = 36_000_000 / (55 * 60)  # reference README.md:254
BASELINE_KMER_MBPS = 90_000 / (55 * 60)  # 30x human reads in the same wall

_START = time.monotonic()
_BUDGET_S = float(os.environ.get("PANGENIE_BENCH_BUDGET_S", "1500"))


def _remaining() -> float:
    return _BUDGET_S - (time.monotonic() - _START)


_DEVICE: dict = {}


def _ensure_backend() -> None:
    """Start JAX on the GPU, or fail: a number from another device is
    not this benchmark's number."""
    import subprocess

    os.environ["PANGENIE_TPU_PLATFORM"] = "gpu"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from pangenie_tpu import backend

    backend.platform()  # raises without a GPU
    devices = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()
    _DEVICE.update(
        platform=devices[0].platform,
        device_kind=devices[0].device_kind,
        device_count=len(devices),
        nvidia_smi=[line.strip() for line in smi if line.strip()],
    )


def _emit(line: dict) -> None:
    print(json.dumps(dict(line, **_DEVICE)), flush=True)


def bench_kmers() -> None:
    """Device PRIME+UPDATE counting rate on genome-derived reads.

    The graph-kmer table is PRIMED once, untimed — it is the per-panel
    index artifact the reference also builds once (its jellyfish hash
    of the path-segments corpus) and then reuses across the whole read
    stream. Each timed run then streams 8 distinct 33.5 Mbp read
    batches (mask-free 2-bit packing: 0.25 bytes/base) through the
    UPDATE path and flushes, synced by a device-side
    reduction. Counting is validated exactly: reads are pure genome
    slices, so every one of their canonical k-mer windows must land in
    the table — the final count mass is asserted equal to the total
    window count across all runs.
    """
    if _remaining() < 300:
        _emit({
            "metric": "kmer_count_device_primed_mbps", "value": None,
            "unit": "Mbp/s", "skipped": True,
            "reason": f"budget exhausted ({_remaining():.0f}s left)",
            "vs_baseline": None,
        })
        return
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.kmers.counter import ExactKmerCounter
    from pangenie_tpu.kmers.device_counter import (
        PrimedDeviceCounter, pack_codes_2bit,
    )

    # 256k-read batches: one fused ingest dispatch per 33 Mbp
    K, GENOME_MBP, READ_LEN, BATCH = 31, 4, 128, 262_144
    BATCHES_PER_RUN = 8
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME_MBP * 1_000_000).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = np.unique(ExactKmerCounter._extract_canonical(
        [lut[genome].tobytes()], K
    ))

    def make_packed(seed):
        r = np.random.default_rng(seed)
        n_reads = BATCHES_PER_RUN * BATCH
        starts = r.integers(0, len(genome) - READ_LEN, size=n_reads)
        reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
        return [
            pack_codes_2bit(reads[b * BATCH:(b + 1) * BATCH])[0]
            for b in range(BATCHES_PER_RUN)
        ]

    # a DISTINCT read set per timed run (no dispatch deduplication)
    packed_sets = [make_packed(seed) for seed in range(3)]
    mbp = BATCHES_PER_RUN * BATCH * READ_LEN / 1e6

    counter = PrimedDeviceCounter(K, keys)  # PRIME: once, untimed

    def run(packed):
        for words in packed:
            counter.update_packed_batch(words, None, READ_LEN)
        counter._flush()
        # device-side reduce + scalar host copy = true completion sync
        float(np.asarray(jnp.sum(counter._counts)))

    run(packed_sets[2])  # compile + warm up
    best = float("inf")
    for i in range(2):
        start = time.perf_counter()
        run(packed_sets[i])
        best = min(best, time.perf_counter() - start)
    _, counts = counter.to_host_arrays()
    windows_per_run = BATCHES_PER_RUN * BATCH * (READ_LEN - K + 1)
    assert counts.sum() == 3 * windows_per_run, (
        f"count mass {counts.sum()} != {3 * windows_per_run}"
    )
    value = mbp / best
    _emit({
        "metric": "kmer_count_device_primed_mbps",
        "value": round(value, 1),
        "unit": "Mbp/s",
        "graph_kmers": int(len(keys)),
        "vs_baseline": round(value / BASELINE_KMER_MBPS, 3),
    })


def bench_e2e() -> None:
    """Genome-scale end-to-end genotyping: variants/sec.

    Workload: multi-chromosome simulated panel, 61 diploid samples =
    123 haplotype paths (auto-sampling to 15 engages, as on every real
    panel), reference-like variant density, 12x error-prone 150 bp
    reads. The SIZE adapts to the remaining budget so the stage always
    finishes inside the run's time limit.

    The full `single` pipeline runs up to three times in-process: the
    first (cold) run pays XLA compiles, the later ones are the steady
    state. All walls are reported; vs_baseline uses the best warm one.
    Per-phase wall summaries for both runs print to stderr above the
    JSON line, so host-bound phases are attributable.
    """
    import types

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # budget-adaptive sizing: pick the largest size whose cold+warm
    # pair still fits the remaining budget (thresholds not yet
    # re-measured on the GPU)
    workdir = os.environ.get(
        "PANGENIE_BENCH_WORKDIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".work",
                     "bench"),
    )
    remaining = _remaining()

    def _cached(mb, chroms):
        tag = (f"mb{mb}_c{chroms}_s61_cov12.0_d150_seed11")
        return os.path.exists(os.path.join(workdir, tag, "DONE"))

    if remaining > (1000 if _cached(20.0, 2) else 1250):
        mb, chroms = 20.0, 2
    elif remaining > (500 if _cached(10.0, 2) else 650):
        mb, chroms = 10.0, 2
    else:
        _emit({
            "metric": "e2e_genotype_variants_per_sec", "value": None,
            "unit": "variants/s", "skipped": True,
            "reason": f"budget exhausted ({remaining:.0f}s left of "
                      f"{_BUDGET_S:.0f}s)",
            "vs_baseline": None,
        })
        return
    from benchmarks.genome_scale import build_inputs
    from pangenie_tpu.commands import run_single_command
    from pangenie_tpu.eval.concordance import genotype_concordance

    args = types.SimpleNamespace(
        mb=mb, chroms=chroms, samples=61, coverage=12.0, read_len=150,
        distance=150, seed=11,
    )
    # persistent cache: repeated runs skip the input simulation
    import resource

    casedir = build_inputs(args, workdir)
    outpref = os.path.join(casedir, "out")
    walls = []
    cpu_s = []
    phase_snaps = []
    # up to THREE reps (1 cold + best-of-2 warm): one warm rep is not
    # a number. cpu_seconds per rep separates host throttling (wall up,
    # cpu flat) from real regressions (both up).
    for rep in range(3):
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.monotonic()
        run_single_command(
            os.path.join(casedir, "reads.fa"),
            os.path.join(casedir, "ref.fa"),
            os.path.join(casedir, "panel.vcf"),
            31,
            outpref,
            nr_jellyfish_threads=2,
            nr_core_threads=2,
        )
        walls.append(time.monotonic() - t0)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s.append(
            (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
        )
        phase_snaps.append(_phase_walls())
        if _remaining() < walls[-1] * 0.8 + 60:
            break  # not enough budget for another rep
    result = genotype_concordance(
        outpref + "_genotyping.vcf", os.path.join(casedir, "truth.vcf")
    )
    best = min(walls[1:]) if len(walls) > 1 else walls[0]
    best_i = walls.index(best)
    value = result.total / best
    _emit({
        "metric": "e2e_genotype_variants_per_sec",
        "value": round(value, 1),
        "unit": "variants/s",
        "warm": len(walls) > 1,
        "warm_wall_s": round(best, 2),
        "cold_wall_s": round(walls[0], 2),
        "all_walls_s": [round(w, 2) for w in walls],
        "cpu_seconds": round(cpu_s[best_i], 2),
        "all_cpu_seconds": [round(c, 2) for c in cpu_s],
        "variants": result.total,
        "length_bp": int(args.mb * 1_000_000),
        "chromosomes": args.chroms,
        "paths": 2 * args.samples + 1,
        "coverage": args.coverage,
        "concordance": round(result.concordance, 5),
        "phase_walls_s": phase_snaps[best_i] if phase_snaps else {},
        "vs_baseline": round(value / BASELINE_COLUMNS_PER_SEC, 3),
    })


def _phase_walls():
    """Per-phase walls of one completed run (index phases included, so
    the index-side walls are driver-verified artifacts too)."""
    try:
        from pangenie_tpu.utils.timer import last_phases

        return {k: round(v, 2) for k, v in last_phases.items()}
    except Exception:
        return {}


def bench_hmm() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm import batch as hmm_batch
    from pangenie_tpu.hmm.batch import forward_backward_batch
    from pangenie_tpu.hmm.forward_backward import forward_backward
    from pangenie_tpu.utils.synthetic import synthetic_columns

    B, N, P, K = 128, 4096, 32, 16

    def make(seed):
        cols = synthetic_columns(
            n_columns=N, n_paths=P, n_kmers=K, batch_dims=(B,),
            dtype=jnp.float32, seed=seed,
        )
        return type(cols)(*[jnp.asarray(x) for x in cols])

    def device_sum(result):
        return sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(result))

    # distinct inputs per timed dispatch; dispatches are enqueued back
    # to back with one device reduce + scalar host copy of ALL outputs
    # at the end — the production pattern (run_deferred streams batch
    # after batch without host syncs)
    reps = 4
    inputs = [make(seed) for seed in range(reps + 1)]

    def timed(fn):
        float(np.asarray(device_sum(fn(inputs[-1]))))  # compile + warm
        best = float("inf")
        for _ in range(2):
            start = time.perf_counter()
            results = [fn(inputs[seed]) for seed in range(reps)]
            total = sum(device_sum(r) for r in results)
            float(np.asarray(total))  # completion sync
            best = min(best, time.perf_counter() - start)
        return best / reps

    elapsed = timed(jax.jit(forward_backward_batch))
    dispatch = hmm_batch.last_dispatch
    # the plain XLA scan on the same inputs, called directly
    scan_elapsed = timed(jax.jit(jax.vmap(forward_backward)))

    columns_per_sec = B * N / elapsed
    line = {
        "metric": "hmm_variant_columns_per_sec_per_chip",
        "value": round(columns_per_sec, 1),
        "unit": "columns/s",
        "dispatch": dispatch,
        "kernel_ms_per_batch": round(elapsed * 1000, 3),
        "xla_scan_ms_per_batch": round(scan_elapsed * 1000, 3),
        "kernel_speedup_vs_scan": round(scan_elapsed / elapsed, 2),
        "vs_baseline": round(columns_per_sec / BASELINE_COLUMNS_PER_SEC, 3),
    }
    _emit(line)
    return line


def main() -> None:
    known = {"kmers", "e2e", "hmm"}
    unknown = set(sys.argv[1:]) - known
    if unknown:
        print(f"unknown benchmark(s): {sorted(unknown)}; "
              f"choose from {sorted(known)}", file=sys.stderr)
        sys.exit(2)
    _ensure_backend()
    which = set(sys.argv[1:]) or known
    # hmm FIRST (flagship metric always captured), then the
    # budget-adaptive e2e, then kmers (skips itself when the budget is
    # spent); the hmm line re-prints last.
    hmm_line = None
    for name, fn in (("hmm", bench_hmm), ("e2e", bench_e2e),
                     ("kmers", bench_kmers)):
        if name not in which:
            continue
        try:
            result = fn()
            if name == "hmm":
                hmm_line = result
        except Exception:
            traceback.print_exc()
            _emit({
                "metric": f"bench_{name}_failed", "value": None,
                "unit": "", "vs_baseline": None,
            })
    if hmm_line is not None and which != {"hmm"}:
        _emit(hmm_line)


if __name__ == "__main__":
    main()
