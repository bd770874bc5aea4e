"""Native k-mer engine vs numpy reference implementation."""

import numpy as np
import pytest

from pangenie_tpu.kmers import native
from pangenie_tpu.kmers.counter import ExactKmerCounter
from pangenie_tpu.kmers.mer import canonicalize, enumerate_valid_kmers

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _numpy_extract(seqs, k):
    parts = [canonicalize(enumerate_valid_kmers(s, k), k) for s in seqs]
    parts = [p for p in parts if len(p)]
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)


def test_extract_canonical_matches_numpy():
    rng = np.random.default_rng(1)
    seqs = []
    for _ in range(200):
        n = int(rng.integers(5, 200))
        # inject Ns to exercise invalid-window resets
        chars = rng.choice([65, 67, 71, 84, 78], n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
        seqs.append(bytes(chars.astype(np.uint8)))
    for k in (5, 21, 31):
        got = native.extract_canonical_batch(seqs, k)
        expected = _numpy_extract(seqs, k)
        assert np.array_equal(got, expected), k


def test_count_and_lookup_match_numpy():
    rng = np.random.default_rng(2)
    kmers = rng.integers(0, 1 << 20, 50_000, dtype=np.uint64)
    keys_n, counts_n = native.count_sorted(kmers.copy())
    keys_e, counts_e = np.unique(kmers, return_counts=True)
    assert np.array_equal(keys_n, keys_e)
    assert np.array_equal(counts_n, counts_e)

    queries = rng.integers(0, 1 << 20, 10_000, dtype=np.uint64)
    got = native.lookup_sorted(keys_n, counts_n, queries)
    idx = np.searchsorted(keys_e, queries)
    idx = np.minimum(idx, len(keys_e) - 1)
    expected = np.where(keys_e[idx] == queries, counts_e[idx], 0)
    assert np.array_equal(got, expected)


def test_update_counts():
    keys = np.array([3, 7, 11], dtype=np.uint64)
    counts = np.zeros(3, dtype=np.int64)
    queries = np.array([7, 7, 3, 5, 11, 99], dtype=np.uint64)
    assert native.update_counts_sorted(keys, counts, queries)
    assert counts.tolist() == [1, 2, 1]


def test_counter_identical_with_and_without_native(monkeypatch):
    rng = np.random.default_rng(3)
    reads = [bytes(rng.choice([65, 67, 71, 84], 100).astype(np.uint8))
             for _ in range(50)]
    corpus = [bytes(rng.choice([65, 67, 71, 84], 500).astype(np.uint8))
              for _ in range(5)]
    fast = ExactKmerCounter.count_sequences_primed(reads, corpus, 31)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", True)
    slow = ExactKmerCounter.count_sequences_primed(reads, corpus, 31)
    assert np.array_equal(fast.keys, slow.keys)
    assert np.array_equal(fast.counts, slow.counts)


def test_library_is_built_from_source_keyed_by_hash(tmp_path):
    """The library lives in csrc/build under a name keyed by the
    source: other source (or another CPU) never loads a stale build."""
    import os

    src = os.path.join(native._CSRC, "kmercount.cpp")
    so = native.library_path(src)
    assert os.path.dirname(so) == native._BUILD
    assert os.path.exists(so)
    changed = tmp_path / "kmercount.cpp"
    changed.write_bytes(open(src, "rb").read() + b"\n// edited\n")
    assert native.library_path(str(changed)) != so
    assert native.library_path(src) == so
