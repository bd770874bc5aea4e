"""Device (XLA) k-mer counter vs the host engine — exact match."""

import numpy as np
import pytest

from pangenie_tpu.kmers.counter import ExactKmerCounter
from pangenie_tpu.kmers.device_counter import DeviceKmerCounter, pack_read_batch


def _random_reads(rng, n, length, with_ns=False):
    alphabet = [65, 67, 71, 84, 78] if with_ns else [65, 67, 71, 84]
    p = [0.235, 0.235, 0.235, 0.235, 0.06] if with_ns else None
    return [
        bytes(rng.choice(alphabet, length, p=p).astype(np.uint8))
        for _ in range(n)
    ]


@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_device_counts_match_host(k):
    rng = np.random.default_rng(k)
    reads = _random_reads(rng, 64, 80, with_ns=True)
    host = ExactKmerCounter.count_sequences(reads, k)

    dev = DeviceKmerCounter(k)
    codes, _ = pack_read_batch(reads)
    dev.add_batch(codes)
    keys, counts = dev.to_host_arrays()
    assert np.array_equal(keys, host.keys)
    assert np.array_equal(counts, host.counts)


def test_device_batched_merge_matches_host():
    rng = np.random.default_rng(9)
    reads = _random_reads(rng, 200, 60)
    host = ExactKmerCounter.count_sequences(reads, 31)

    dev = DeviceKmerCounter(31)
    for i in range(0, len(reads), 64):  # uneven batches
        codes, _ = pack_read_batch(reads[i : i + 64], length=60)
        dev.add_batch(codes)
    keys, counts = dev.to_host_arrays()
    assert np.array_equal(keys, host.keys)
    assert np.array_equal(counts, host.counts)


def test_device_counter_roundtrip_lookup():
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 32, 50)
    dev = DeviceKmerCounter(21)
    codes, _ = pack_read_batch(reads)
    dev.add_batch(codes)
    counter = dev.to_exact_counter()
    # query the first kmer of each read (canonicalized inside)
    from pangenie_tpu.kmers.mer import encode_kmer

    for read in reads[:5]:
        query = read[:21].decode()
        host = ExactKmerCounter.count_sequences(reads, 21)
        assert counter.get_kmer_abundance(query) == host.get_kmer_abundance(query)


def test_sharded_count_matches_host():
    """Mesh-sharded counting: per-device partial tables merged via
    all_gather equal the host counter exactly."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from pangenie_tpu.parallel.mesh import make_mesh
    from pangenie_tpu.kmers.device_counter import sharded_count_kmers

    rng = np.random.default_rng(5)
    reads = _random_reads(rng, 40, 64, with_ns=True)  # 40 % 8 != 0: pads
    host = ExactKmerCounter.count_sequences(reads, 21)

    mesh = make_mesh(8)
    codes, _ = pack_read_batch(reads)
    hi, lo, counts, mask = (
        np.asarray(x) for x in sharded_count_kmers(mesh, codes, 21)
    )
    keep = mask.astype(bool)
    keys = (hi[keep].astype(np.uint64) << np.uint64(32)) | lo[keep].astype(
        np.uint64
    )
    order = np.argsort(keys)
    assert np.array_equal(keys[order], host.keys)
    assert np.array_equal(counts[keep][order].astype(np.int64), host.counts)


def test_partitioned_count_matches_host():
    """Hash-partitioned all_to_all counting: the union of per-device
    partition tables equals the host counter exactly, partitions are
    disjoint, and no bin overflowed."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from pangenie_tpu.parallel.mesh import make_mesh
    from pangenie_tpu.kmers.device_counter import (
        sharded_count_kmers_partitioned,
    )

    rng = np.random.default_rng(6)
    reads = _random_reads(rng, 48, 64, with_ns=True)
    host = ExactKmerCounter.count_sequences(reads, 21)

    mesh = make_mesh(8)
    codes, _ = pack_read_batch(reads)
    khi, klo, cnt, mask, overflow = sharded_count_kmers_partitioned(
        mesh, codes, 21, slack=4.0
    )
    assert overflow == 0
    khi, klo, cnt, mask = (np.asarray(x) for x in (khi, klo, cnt, mask))
    keep = mask.astype(bool)
    keys = (khi[keep].astype(np.uint64) << np.uint64(32)) | klo[keep].astype(
        np.uint64
    )
    assert len(np.unique(keys)) == len(keys)  # partitions disjoint
    order = np.argsort(keys)
    assert np.array_equal(keys[order], host.keys)
    assert np.array_equal(cnt[keep][order].astype(np.int64), host.counts)


def test_primed_device_counter_matches_host():
    """Device PRIME+UPDATE: only registered (graph) k-mers are counted,
    exactly matching the host primed counter."""
    from pangenie_tpu.kmers.device_counter import PrimedDeviceCounter

    rng = np.random.default_rng(11)
    graph_seqs = _random_reads(rng, 30, 90)
    reads = _random_reads(rng, 150, 70, with_ns=True)
    # reads share content with the graph: splice graph fragments in
    reads = [
        graph_seqs[i % len(graph_seqs)][:40] + r[40:]
        for i, r in enumerate(reads)
    ]
    k = 21
    host = ExactKmerCounter.count_sequences_primed(reads, graph_seqs, k)

    graph_keys = ExactKmerCounter.count_sequences(graph_seqs, k).keys
    dev = PrimedDeviceCounter(k, graph_keys)
    for i in range(0, len(reads), 64):
        codes, _ = pack_read_batch(reads[i : i + 64], length=70)
        dev.update_batch(codes)

    counter = dev.to_exact_counter()
    for key in graph_keys:
        assert counter.get_abundances(np.array([key]))[0] == \
            host.get_abundances(np.array([key]))[0]
    # nothing outside the graph key set is tracked
    assert set(counter.keys).issubset(set(graph_keys))


def test_lookup_pair_sorted_bounds():
    from pangenie_tpu.kmers.device_counter import lookup_pair_sorted
    import jax.numpy as jnp

    keys = np.array([3, 9, 12, 700, 2**40 + 5], dtype=np.uint64)
    hi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    q = np.array([0, 3, 10, 12, 2**40 + 5, 2**63], dtype=np.uint64)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    idx, found = lookup_pair_sorted(hi, lo, qhi, qlo)
    assert list(np.asarray(found)) == [False, True, False, True, True, False]
    assert np.asarray(idx)[1] == 0
    assert np.asarray(idx)[3] == 2
    assert np.asarray(idx)[4] == 4


def test_pack_unpack_2bit_roundtrip():
    from pangenie_tpu.kmers.device_counter import (
        pack_codes_2bit, unpack_codes_2bit,
    )

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(7, 53)).astype(np.uint8)  # incl. N=4
    words, vwords = pack_codes_2bit(codes)
    back = np.asarray(unpack_codes_2bit(words, vwords, codes.shape[1]))
    np.testing.assert_array_equal(back, codes)


def test_primed_merge_matches_host_counts():
    from pangenie_tpu.kmers.counter import ExactKmerCounter
    from pangenie_tpu.kmers.device_counter import (
        PrimedDeviceCounter, pack_codes_2bit,
    )

    rng = np.random.default_rng(11)
    k = 21
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    graph_keys = np.unique(
        ExactKmerCounter._extract_canonical([lut[genome].tobytes()], k)
    )
    starts = rng.integers(0, len(genome) - 60, size=300)
    reads = genome[starts[:, None] + np.arange(60)[None, :]]
    # sprinkle invalid bases
    reads = reads.copy()
    reads[rng.integers(0, 300, 40), rng.integers(0, 60, 40)] = 4

    # host oracle: count read kmers restricted to graph keys
    read_kmers = ExactKmerCounter._extract_canonical(
        [bytes(lut[c] if c <= 3 else b"N"[0] for c in r) for r in reads], k
    )
    uniq, cnt = np.unique(read_kmers, return_counts=True)
    expected = np.zeros(len(graph_keys), np.int64)
    pos = np.searchsorted(graph_keys, uniq)
    ok = (pos < len(graph_keys))
    ok &= graph_keys[np.minimum(pos, len(graph_keys) - 1)] == uniq
    expected[pos[ok]] = cnt[ok]

    dev = PrimedDeviceCounter(k, graph_keys)
    dev.update_batch(reads[:128])
    words, vwords = pack_codes_2bit(reads[128:])
    dev.update_packed_batch(words, vwords, reads.shape[1])
    keys, counts = dev.to_host_arrays()
    np.testing.assert_array_equal(keys, graph_keys)
    np.testing.assert_array_equal(counts, expected)


def test_count_file_primed_device_matches_host(tmp_path):
    """The production device streaming path (file in, ExactKmerCounter
    out) produces the host primed counter's table exactly — keys AND
    counts, zero-count graph keys included."""
    from pangenie_tpu.kmers.device_counter import count_file_primed_device

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=6000)].tobytes()
    corpus = tmp_path / "segments.fa"
    corpus.write_text(f">seg\n{genome.decode()}\n")
    reads = tmp_path / "reads.fa"
    with open(reads, "w") as out:
        for i in range(300):
            start = int(rng.integers(0, len(genome) - 100))
            length = int(rng.integers(40, 100))  # mixed length buckets
            out.write(f">r{i}\n{genome[start:start + length].decode()}\n")
        out.write(">odd\nACGTNNACGTACGTACGTACGTACGTACGTACGTACG\n")

    k = 31
    host = ExactKmerCounter.count_file_primed(str(reads), [str(corpus)], k)
    # tiny block_bases forces multiple flushes incl. padded partials
    dev = count_file_primed_device(
        str(reads), [str(corpus)], k, block_bases=4096
    )
    np.testing.assert_array_equal(host.keys, dev.keys)
    np.testing.assert_array_equal(host.counts, dev.counts)


def test_hmm_dtype_env_and_platform(monkeypatch):
    import jax.numpy as jnp

    from pangenie_tpu import backend, commands

    monkeypatch.setenv("PANGENIE_TPU_DTYPE", "float32")
    assert backend.hmm_dtype() == jnp.float32
    monkeypatch.setenv("PANGENIE_TPU_DTYPE", "f64")
    assert backend.hmm_dtype() == jnp.float64
    monkeypatch.delenv("PANGENIE_TPU_DTYPE")
    # CPU test backend -> verification default f64
    assert backend.hmm_dtype() == jnp.float64
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.hmm_dtype() == jnp.float32
    # counter routing honors the env override on any backend
    monkeypatch.setenv("PANGENIE_TPU_COUNTER", "host")
    assert not commands._use_device_counter()
    monkeypatch.setenv("PANGENIE_TPU_COUNTER", "device")
    assert commands._use_device_counter()


def test_prime_from_corpus_builds_device_table(tmp_path, monkeypatch):
    """The on-device PRIME build must reproduce the host key table
    exactly — including N-containing corpus sequences, chunking of
    sequences longer than one row, and multi-round dedupe folds."""
    import numpy as np

    monkeypatch.setenv("PANGENIE_TPU_DEVICE_PRIME", "1")

    from pangenie_tpu.kmers.counter import ExactKmerCounter, iter_sequences
    from pangenie_tpu.kmers.device_counter import PrimedDeviceCounter

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 31
    seqs = []
    genome = bases[rng.integers(0, 4, size=20000)].tobytes()
    # a 67 kb sequence (> one 32768-base chunk row) made of repeated
    # genome copies: ~80k windows over ~20k unique keys, so a 32k
    # capacity sits between them and forces multi-round dedupe folds
    seqs.append(genome + genome[100:] + genome[257:] + genome[1033:9000])
    withn = bytearray(bases[rng.integers(0, 4, size=500)].tobytes())
    withn[100:105] = b"NNNNN"
    seqs.append(bytes(withn))
    seqs.append(b"ACG")  # shorter than k: skipped
    corpus = tmp_path / "corpus.fa"
    with open(corpus, "w") as out:
        for i, s in enumerate(seqs):
            out.write(f">s{i}\n{s.decode()}\n")

    keys = np.unique(
        ExactKmerCounter._extract_canonical(iter_sequences(str(corpus)), k)
    )
    # capacity below the corpus window count forces multiple dedupe
    # rounds through the fixed-size held table
    counter = PrimedDeviceCounter(
        k, keys, capacity=1 << 15, corpus_files=[str(corpus)]
    )
    assert counter.primed_on_device
    tagged = keys << np.uint64(1)
    np.testing.assert_array_equal(
        np.asarray(counter._hi),
        (tagged >> np.uint64(32)).astype(np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(counter._lo),
        (tagged & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )

    # wrong host keys must be detected by checksum and fall back to the
    # transferred table (so counting stays correct regardless)
    bad_keys = keys.copy()
    bad_keys[0] ^= np.uint64(4)
    bad_keys = np.unique(bad_keys)
    fallback = PrimedDeviceCounter(
        k, bad_keys, capacity=1 << 15, corpus_files=[str(corpus)]
    )
    assert not fallback.primed_on_device
    tagged_bad = bad_keys << np.uint64(1)
    np.testing.assert_array_equal(
        np.asarray(fallback._hi),
        (tagged_bad >> np.uint64(32)).astype(np.uint32),
    )


def test_ultralong_read_exceeding_flush_buffer(tmp_path):
    """A single read whose window count exceeds the flush buffer must
    count correctly (capacity growth handles it)."""
    import numpy as np

    from pangenie_tpu.kmers.counter import ExactKmerCounter
    from pangenie_tpu.kmers.device_counter import (
        PrimedDeviceCounter, count_file_primed_device,
    )

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 31
    genome = bases[rng.integers(0, 4, size=3000)].tobytes()
    longread = (genome * 40)[:100_000]  # windows >> a small capacity
    corpus = tmp_path / "c.fa"
    reads = tmp_path / "r.fa"
    corpus.write_text(f">s\n{genome.decode()}\n")
    reads.write_text(
        f">L\n{longread.decode()}\n>tiny\n{genome[:80].decode()}\n"
    )
    host = ExactKmerCounter.count_file_primed(str(reads), [str(corpus)], k)
    # force a tiny flush buffer so the long read cannot fit
    orig = PrimedDeviceCounter.__init__

    def small(self, k, keys, capacity=None, corpus_files=None):
        orig(self, k, keys, capacity=1 << 14, corpus_files=corpus_files)

    PrimedDeviceCounter.__init__ = small
    try:
        dev = count_file_primed_device(
            str(reads), [str(corpus)], k, block_bases=1 << 18
        )
    finally:
        PrimedDeviceCounter.__init__ = orig
    np.testing.assert_array_equal(host.keys, dev.keys)
    np.testing.assert_array_equal(host.counts, dev.counts)
