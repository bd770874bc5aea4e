"""K-mer counting throughput benchmark (Mbp/s): host C++ vs device.

The reference's counting phase is Jellyfish's lock-free hash
(src/jellyfishcounter.cpp); BASELINE.md lists "k-mer counting Mbp/sec"
as a target metric. Reads are sampled from a synthetic genome so the
distinct-kmer count and repeat structure look like a real run (random
reads would make every k-mer unique).

Engines measured (one JSON line each):

  host_primed:   threaded C++ PRIME+UPDATE hash streaming — the
                 production genotype-phase path (kmers/native.py)
  device_all:    extract_canonical + lax.sort count table — index-phase
                 count-everything mode (kmers/device_counter.py)
  device_primed: binary-search + scatter-add streaming against a fixed
                 graph-key table — genotype-phase mode on device
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 31
GENOME_MBP = 8
READ_LEN = 128
COVERAGE = 8
BATCH = 65_536


def synthetic_workload(seed: int = 0):
    """(genome codes [G], read codes [R, L]) sampled at COVERAGE x."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=GENOME_MBP * 1_000_000).astype(np.uint8)
    n_reads = GENOME_MBP * 1_000_000 * COVERAGE // READ_LEN
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    return genome, reads


def _to_bytes(codes: np.ndarray):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [row.tobytes() for row in lut[codes]]


def bench_host_primed(genome: np.ndarray, reads: np.ndarray) -> None:
    from pangenie_tpu.kmers import native
    from pangenie_tpu.kmers.counter import ExactKmerCounter

    if not native.available():
        print(json.dumps({"metric": "kmer_count_host_primed_mbps",
                          "value": None, "unit": "Mbp/s",
                          "note": "native engine missing"}))
        return
    keys = ExactKmerCounter._extract_canonical([_to_bytes(genome[None, :])[0]], K)
    keys = np.unique(keys)
    seqs = _to_bytes(reads)
    counts = np.zeros(len(keys), dtype=np.int64)
    index = native.KmerHashIndex(keys)
    mbp = reads.size / 1e6

    start = time.perf_counter()
    index.stream_update(seqs, K, counts)
    elapsed = time.perf_counter() - start
    assert counts.sum() > 0
    print(json.dumps({
        "metric": "kmer_count_host_primed_mbps",
        "value": round(mbp / elapsed, 1),
        "unit": "Mbp/s",
        "graph_kmers": int(len(keys)),
        "threads": os.cpu_count(),
    }))


def bench_device_all(reads: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp

    from pangenie_tpu.kmers.device_counter import (
        count_kmers, extract_canonical, pack_codes_2bit, unpack_codes_2bit,
    )

    mbp = reads.size / 1e6
    n_batches = (reads.shape[0] + BATCH - 1) // BATCH
    pad_rows = n_batches * BATCH - reads.shape[0]
    padded = np.concatenate(
        [reads, np.full((pad_rows, READ_LEN), 4, np.uint8)]
    ) if pad_rows else reads

    @jax.jit
    def extract(words, vwords):
        return extract_canonical(
            unpack_codes_2bit(words, vwords, READ_LEN), K
        )

    def run():
        his, los, valids = [], [], []
        for b in range(n_batches):
            words, vwords = pack_codes_2bit(
                padded[b * BATCH:(b + 1) * BATCH]
            )
            hi, lo, valid = extract(
                jnp.asarray(words), jnp.asarray(vwords)
            )
            his.append(hi.ravel())
            los.append(lo.ravel())
            valids.append(valid.ravel())
        table = count_kmers(
            jnp.concatenate(his), jnp.concatenate(los),
            jnp.concatenate(valids),
        )
        # device-side reduce + scalar host copy: the completion sync
        float(np.asarray(jnp.sum(table[2])))
        return table

    run()  # compile
    best, table = float("inf"), None
    for _ in range(3):
        start = time.perf_counter()
        table = run()
        best = min(best, time.perf_counter() - start)
    distinct = int(np.asarray(jnp.sum(table[3])))
    print(json.dumps({
        "metric": "kmer_count_device_all_mbps",
        "value": round(mbp / best, 1),
        "unit": "Mbp/s",
        "distinct_kmers": distinct,
        "backend": jax.devices()[0].platform,
    }))


def bench_device_primed(genome: np.ndarray, reads: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp

    from pangenie_tpu.kmers.counter import ExactKmerCounter
    from pangenie_tpu.kmers.device_counter import (
        PrimedDeviceCounter, pack_codes_2bit,
    )

    keys = ExactKmerCounter._extract_canonical(
        [_to_bytes(genome[None, :])[0]], K
    )
    keys = np.unique(keys)
    mbp = reads.size / 1e6
    n_batches = (reads.shape[0] + BATCH - 1) // BATCH
    pad_rows = n_batches * BATCH - reads.shape[0]
    padded = np.concatenate(
        [reads, np.full((pad_rows, READ_LEN), 4, np.uint8)]
    ) if pad_rows else reads

    def run():
        counter = PrimedDeviceCounter(K, keys)
        for b in range(n_batches):
            words, vwords = pack_codes_2bit(
                padded[b * BATCH:(b + 1) * BATCH]
            )
            counter.update_packed_batch(words, vwords, READ_LEN)
        # true completion sync (see bench_device_all)
        float(np.asarray(jnp.sum(counter._counts)))
        return counter

    run()  # compile
    best, counter = float("inf"), None
    for _ in range(3):
        start = time.perf_counter()
        counter = run()
        best = min(best, time.perf_counter() - start)
    _, counts = counter.to_host_arrays()
    assert counts.sum() > 0
    print(json.dumps({
        "metric": "kmer_count_device_primed_mbps",
        "value": round(mbp / best, 1),
        "unit": "Mbp/s",
        "graph_kmers": int(len(keys)),
        "backend": jax.devices()[0].platform,
    }))


def main() -> None:
    genome, reads = synthetic_workload()
    which = set(sys.argv[1:]) or {"host", "device", "primed"}
    if which & {"host", "both"}:
        bench_host_primed(genome, reads)
    if which & {"device", "both"}:
        bench_device_all(reads)
    if which & {"primed", "both"}:
        bench_device_primed(genome, reads)


if __name__ == "__main__":
    main()
