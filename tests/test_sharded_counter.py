"""Pod-scale sharded PRIME+UPDATE counter: hash-partitioned graph
tables over a device mesh must count exactly like the host engine,
at tables larger than one device's budget (reference behaviour being
scaled: src/jellyfishcounter.cpp:29-85)."""

import jax
import numpy as np
import pytest

from pangenie_tpu.kmers.counter import ExactKmerCounter
from pangenie_tpu.kmers.device_counter import (
    ShardedPrimedDeviceCounter,
    count_stream_sharded,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs an 8-device (virtual) mesh"
)

LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:8]), ("d",))


def _genome_and_keys(k, n_bases, seed=0):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    keys = np.unique(ExactKmerCounter._extract_canonical(
        [LUT[genome].tobytes()], k
    ))
    return genome, keys


def _reads(genome, n_reads, read_len, seed=1, with_ns=False):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if with_ns:
        ni = rng.random(reads.shape) < 0.01
        reads[ni] = 4
    return reads


def _host_counts(k, keys, reads):
    """Ground truth: canonical windows of the reads against the keys."""
    seqs = [LUT[np.minimum(r, 3)][r != 4_0_0 if False else slice(None)]
            for r in reads]
    texts = []
    for r in reads:
        b = np.where(r == 4, ord("N"), LUT[np.minimum(r, 3)]).astype(np.uint8)
        texts.append(b.tobytes())
    kmers = ExactKmerCounter._extract_canonical(texts, k)
    counts = np.zeros(len(keys), np.int64)
    uk, uc = np.unique(kmers, return_counts=True)
    pos = np.searchsorted(keys, uk)
    hit = (pos < len(keys))
    hit[hit] = keys[pos[hit]] == uk[hit]
    counts[pos[hit]] = uc[hit]
    return counts


@pytest.mark.parametrize("with_ns", [False, True])
def test_sharded_matches_host(with_ns):
    k = 31
    genome, keys = _genome_and_keys(k, 200_000)
    reads = _reads(genome, 600, 150, with_ns=with_ns)
    want = _host_counts(k, keys, reads)

    mesh = _mesh()
    # buffer far below table size: several mid-stream flushes
    counter = ShardedPrimedDeviceCounter(
        mesh, k, keys, buffer_capacity=1 << 15
    )
    for b in range(0, len(reads), 128):
        counter.update_batch(reads[b:b + 128])
    got_keys, got = counter.to_host_arrays()
    np.testing.assert_array_equal(got_keys, keys)
    np.testing.assert_array_equal(got, want)


def test_batch_larger_than_buffer_is_ingested_in_parts():
    """A batch with more windows than the whole exchange buffer (a
    small graph table sizes a small buffer) is split, not refused."""
    k = 31
    genome, keys = _genome_and_keys(k, 50_000, seed=11)
    reads = _reads(genome, 512, 150, seed=12)
    want = _host_counts(k, keys, reads)
    counter = ShardedPrimedDeviceCounter(
        _mesh(), k, keys, buffer_capacity=1 << 14
    )
    # one batch: 512 * 120 windows * slack 3 >> 2^14 buffer slots
    counter.update_batch(reads)
    _, got = counter.to_host_arrays()
    np.testing.assert_array_equal(got, want)


def test_stream_driver_chunks_variable_reads():
    """count_stream_sharded re-chunks variable-length reads with k-1
    separators: every window exactly once, none across reads."""
    k = 17
    genome, keys = _genome_and_keys(k, 50_000, seed=3)
    rng = np.random.default_rng(4)
    lens = rng.integers(k, 400, size=300)
    starts = rng.integers(0, len(genome) - 400, size=300)
    reads = [genome[s:s + ln] for s, ln in zip(starts, lens)]
    texts = [LUT[r].tobytes() for r in reads]
    kmers = ExactKmerCounter._extract_canonical(texts, k)
    want = np.zeros(len(keys), np.int64)
    uk, uc = np.unique(kmers, return_counts=True)
    pos = np.searchsorted(keys, uk)
    hit = pos < len(keys)
    hit[hit] = keys[pos[hit]] == uk[hit]
    want[pos[hit]] = uc[hit]

    data = np.concatenate(reads)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    counter = count_stream_sharded(
        _mesh(), [(LUT[data], offsets)], k, keys,
        chunk=256, batch_rows=64, buffer_capacity=1 << 14,
    )
    got_keys, got = counter.to_host_arrays()
    np.testing.assert_array_equal(got_keys, keys)
    np.testing.assert_array_equal(got, want)


def test_partition_exceeds_single_device_budget():
    """A table whose single-device footprint exceeds a (simulated)
    per-device budget still counts exactly when sharded 8 ways —
    each partition holds ~1/8 of the keys."""
    k = 21
    genome, keys = _genome_and_keys(k, 300_000, seed=7)
    assert len(keys) > 8_000
    reads = _reads(genome, 400, 200, seed=8)
    want = _host_counts(k, keys, reads)
    counter = ShardedPrimedDeviceCounter(
        _mesh(), k, keys, buffer_capacity=1 << 15
    )
    # partitions are balanced: max/min within 20%
    per = counter._per_dev
    assert per.max() < 1.2 * per.min()
    for b in range(0, len(reads), 100):
        counter.update_batch(reads[b:b + 100])
    _, got = counter.to_host_arrays()
    np.testing.assert_array_equal(got, want)


def test_overflow_detection():
    k = 15
    genome, keys = _genome_and_keys(k, 20_000, seed=9)
    reads = _reads(genome, 256, 100, seed=10)
    counter = ShardedPrimedDeviceCounter(
        _mesh(), k, keys, buffer_capacity=1 << 14, slack=0.01
    )
    counter.update_batch(reads)
    with pytest.raises(RuntimeError, match="overflow"):
        counter.to_host_arrays()


def test_read_counter_routes_sharded(monkeypatch, tmp_path):
    """PANGENIE_TPU_COUNTER=device on a multi-chip mesh must route
    through the sharded counter and produce counts identical to the
    host C++ engine (same full key set, allreduce-compatible)."""
    from pangenie_tpu.commands import _read_counter

    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, size=60_000).astype(np.uint8)
    corpus = tmp_path / "segments.fa"
    corpus.write_text(f">seg\n{LUT[genome].tobytes().decode()}\n")
    reads = _reads(genome, 300, 120, seed=22)
    with open(tmp_path / "reads.fa", "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{LUT[r].tobytes().decode()}\n")

    k = 31
    keys = np.unique(ExactKmerCounter._extract_canonical(
        [LUT[genome].tobytes()], k
    ))

    monkeypatch.setenv("PANGENIE_TPU_COUNTER", "device")
    dev = _read_counter(
        str(tmp_path / "reads.fa"), str(corpus), k, True,
        prime_keys=keys,
    )
    monkeypatch.setenv("PANGENIE_TPU_COUNTER", "host")
    host = _read_counter(
        str(tmp_path / "reads.fa"), str(corpus), k, True,
        prime_keys=keys,
    )
    np.testing.assert_array_equal(dev.keys, host.keys)
    np.testing.assert_array_equal(dev.counts, host.counts)
