"""Device-side (XLA) canonical k-mer counting.

The count table keeps the host engine's sorted-array layout (see
counter.py), built with device primitives only:

- reads are streamed as padded [B, L] uint8 code batches (host packs),
- every length-k window is packed into a (hi, lo) PAIR of uint32 words
  holding the host's 2-bit uint64 encoding split at bit 32 (a layout
  chosen for a device without native 64-bit integers; whether uint64
  keys sort faster on the GPU is not measured yet); all comparisons are
  lexicographic on (hi, lo), which equals uint64 order,
- reverse complement is 64-bit bit-twiddling carried across the word
  pair; canonical = elementwise min,
- counting = `lax.sort` with num_keys=2 (lexicographic) + run-length
  encode via segment boundaries,
- the abundance histogram is a bincount of the counts.

Partial tables from read batches (or from different devices) merge by
concatenation + re-sort + segment-sum — across a mesh this is an
all-gather followed by the same local merge.

Random-access abundance lookups stay host-side (they touch only the
~1e7 selected kmers once); the streaming-bandwidth-heavy counting is
what the device accelerates.

Why sort-based and not a hash table: the engine was designed for a
device whose random gathers and scatter-adds were far slower than a
sort, so ``lax.sort`` is its hash table; the engine's job is to
amortize it (fill-sized flushes, tagged single-sort join against the
pre-sorted graph table, mask-free 0.25 B/base ingest). Whether a GPU
hash table would beat it has not been measured.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MASK32 = np.uint32(0xFFFFFFFF)

# graph-table length -> flush sizes already compiled this process (the
# jit cache is process-global; reusing a compiled size beats compiling
# a new big-sort program)
_FLUSH_SIZES: dict = {}


def pack_read_batch(
    seqs: List[bytes], length: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: encode sequences to a padded [B, L] uint8 code array.

    Codes: A=0 C=1 G=2 T=3, invalid/padding=4.
    """
    from ..io.sequence import encode_bases

    if length is None:
        length = max((len(s) for s in seqs), default=0)
    batch = np.full((len(seqs), length), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes = encode_bases(s[:length])
        batch[i, : len(codes)] = codes
    return batch, np.array([min(len(s), length) for s in seqs])


def pack_codes_2bit(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: [B, L] uint8 codes -> (words [B, ceil(L/16)] uint32,
    valid bitmask [B, ceil(L/32)] uint32). 2 bits/base + 1 validity
    bit/base = 4.5x less host->device transfer than byte codes."""
    from . import native

    packed = native.pack_2bit(codes)
    if packed is not None:
        return packed
    B, L = codes.shape
    W16 = (L + 15) // 16
    W32 = (L + 31) // 32
    c = np.where(codes > 3, 0, codes).astype(np.uint32)
    cpad = np.zeros((B, W16 * 16), np.uint32)
    cpad[:, :L] = c
    words = np.zeros((B, W16), np.uint32)
    for i in range(16):  # strided |= keeps this a handful of SIMD passes
        words |= cpad[:, i::16] << np.uint32(2 * i)
    v = (codes <= 3).astype(np.uint32)
    vpad = np.zeros((B, W32 * 32), np.uint32)
    vpad[:, :L] = v
    vwords = np.zeros((B, W32), np.uint32)
    for i in range(32):
        vwords |= vpad[:, i::32] << np.uint32(i)
    return words, vwords


@partial(jax.jit, static_argnames=("L",))
def unpack_codes_2bit(words: jax.Array, vwords: jax.Array, L: int):
    """Device-side inverse of :func:`pack_codes_2bit` -> [B, L] uint8."""
    B = words.shape[0]
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    c = (words[:, :, None] >> shifts) & jnp.uint32(3)
    codes = c.reshape(B, -1)[:, :L].astype(jnp.uint8)
    vshifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    v = (vwords[:, :, None] >> vshifts) & jnp.uint32(1)
    valid = v.reshape(B, -1)[:, :L] > 0
    return jnp.where(valid, codes, jnp.uint8(4))


def _rc_pair(hi, lo, k: int):
    """Reverse complement of the (hi, lo) 64-bit pair encoding."""
    u = jnp.uint32
    hi = ~hi
    lo = ~lo
    for s, m in ((1, u(0x33333333)), (2, u(0x0F0F0F0F)),
                 (3, u(0x00FF00FF)), (4, u(0x0000FFFF))):
        shift = u(1 << s)
        hi = ((hi >> shift) & m) | ((hi & m) << shift)
        lo = ((lo >> shift) & m) | ((lo & m) << shift)
    hi, lo = lo, hi  # the 32-bit swap
    # 64-bit right shift by (64 - 2k)
    sh = 64 - 2 * k
    if sh == 0:
        return hi, lo
    if sh >= 32:
        return jnp.zeros_like(hi), hi >> u(sh - 32) if sh > 32 else hi
    return hi >> u(sh), (lo >> u(sh)) | (hi << u(32 - sh))


def _min_pair(ahi, alo, bhi, blo):
    """Lexicographic min over (hi, lo) pairs == uint64 min."""
    a_smaller = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    return (
        jnp.where(a_smaller, ahi, bhi),
        jnp.where(a_smaller, alo, blo),
    )


@partial(jax.jit, static_argnames=("k",))
def extract_canonical(codes: jax.Array, k: int):
    """All valid canonical k-mer windows of a [B, L] code batch.

    Returns (hi, lo, valid): [B, W] uint32/uint32/bool with
    W = L - k + 1. Windows containing an invalid code are masked.
    """
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1
    c = codes.astype(jnp.uint32)
    u = jnp.uint32

    hi = jnp.zeros((B, W), jnp.uint32)
    lo = jnp.zeros((B, W), jnp.uint32)
    invalid = jnp.zeros((B, W), bool)
    for i in range(k):
        ci = jax.lax.dynamic_slice_in_dim(c, i, W, axis=1)
        bitpos = 2 * (k - 1 - i)
        if bitpos >= 32:
            hi = hi | ((ci & u(3)) << u(bitpos - 32))
        else:
            lo = lo | ((ci & u(3)) << u(bitpos))
        invalid = invalid | (ci > 3)

    rhi, rlo = _rc_pair(hi, lo, k)
    chi, clo = _min_pair(hi, lo, rhi, rlo)
    return chi, clo, ~invalid


def _sorted_segment_count(hi, lo, weights):
    """Sort (hi, lo) pairs and sum weights per distinct key.

    Entries with key 0xFFFFFFFF:0xFFFFFFFF (or zero weight) are treated
    as padding: they sort to the top and are masked out. Returns
    (keys_hi, keys_lo, counts, mask): keys stay at their sorted
    positions (duplicates included); mask marks each distinct key's
    FIRST slot, where its summed count lives.

    Scatter-free: per-segment sums come from the weight prefix sum
    (count = csum[segment end] - csum[before start], with each start's
    end found by a reverse cumulative min over end positions).
    """
    shi, slo, scnt = jax.lax.sort(
        (hi.ravel(), lo.ravel(), weights.ravel()), num_keys=2
    )
    n = shi.shape[0]
    # segment starts: first element or different from predecessor
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    is_start = (shi != prev_hi) | (slo != prev_lo)
    is_end = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
    csum = jnp.cumsum(scnt)  # weight mass up to and including slot i
    big = jnp.iinfo(jnp.int32).max
    end_csum = jnp.where(is_end, csum, big)
    # csum is nondecreasing, so the first end at-or-after each slot is
    # the segment's own end: a reverse cumulative min
    seg_end_csum = jax.lax.cummin(end_csum[::-1])[::-1]
    prev_csum = jnp.concatenate([jnp.zeros(1, csum.dtype), csum[:-1]])
    counts = jnp.where(is_start, seg_end_csum - prev_csum, 0)
    mask = is_start & (counts > 0)
    return shi, slo, counts, mask


@jax.jit
def count_kmers(hi: jax.Array, lo: jax.Array, valid: jax.Array):
    """Sorted count table from flattened kmer arrays.

    Invalid entries sort to the top (key 0xFFFFFFFF) and are excluded
    via the returned table mask.

    Returns (keys_hi, keys_lo, counts, table_mask): [N] arrays where
    table_mask marks each distinct key's first sorted slot.
    """
    hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF))
    return _sorted_segment_count(hi, lo, valid.astype(jnp.int32))


@jax.jit
def merge_tables(
    ahi, alo, acnt, amask, bhi, blo, bcnt, bmask
):
    """Merge two sorted count tables (concat + re-sort + segment-sum)."""
    hi = jnp.concatenate([jnp.where(amask, ahi, jnp.uint32(0xFFFFFFFF)),
                          jnp.where(bmask, bhi, jnp.uint32(0xFFFFFFFF))])
    lo = jnp.concatenate([jnp.where(amask, alo, jnp.uint32(0xFFFFFFFF)),
                          jnp.where(bmask, blo, jnp.uint32(0xFFFFFFFF))])
    cnt = jnp.concatenate([jnp.where(amask, acnt, 0),
                           jnp.where(bmask, bcnt, 0)])
    return _sorted_segment_count(hi, lo, cnt)


@partial(jax.jit, static_argnames=("max_count",))
def histogram(counts: jax.Array, mask: jax.Array, max_count: int):
    """count -> frequency histogram (clamped at max_count)."""
    c = jnp.where(mask, jnp.minimum(counts, max_count), 0)
    return jnp.zeros(max_count + 1, jnp.int32).at[c].add(
        mask.astype(jnp.int32)
    )[1:]


def sharded_count_kmers(mesh, codes: np.ndarray, k: int):
    """Count a [B, L] read batch sharded over a device mesh.

    Each device extracts + counts its read shard locally, then
    the partial tables merge through an ``all_gather`` over the mesh's
    'batch' axis followed by the same local sort/segment-sum merge —
    the collective replacement for the reference's shared lock-free
    hash (src/jellyfishcounter.cpp:26-49). At pod scale the gather
    would become a hash-partitioned ``all_to_all`` so each device owns
    a key range; the gather version is exact at single-host sizes.

    Returns replicated (keys_hi, keys_lo, counts, mask) device arrays.
    """
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from functools import partial

    axis = mesh.axis_names[-1]
    n_dev = mesh.devices.size
    B = codes.shape[0]
    if B % n_dev:
        pad = n_dev - B % n_dev
        codes = np.concatenate(
            [codes, np.full((pad,) + codes.shape[1:], 4, dtype=codes.dtype)]
        )
    flat_mesh = jax.sharding.Mesh(mesh.devices.reshape(-1), (axis,))
    sharded = jax.device_put(
        jnp.asarray(codes), NamedSharding(flat_mesh, P(axis))
    )

    @partial(
        shard_map,
        mesh=flat_mesh,
        in_specs=(P(axis),),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def count(local_codes):
        hi, lo, valid = extract_canonical(local_codes, k)
        khi, klo, cnt, mask = count_kmers(hi, lo, valid)
        # merge partials: gather every device's table, re-count
        all_hi = jax.lax.all_gather(khi, axis).ravel()
        all_lo = jax.lax.all_gather(klo, axis).ravel()
        all_cnt = jax.lax.all_gather(cnt, axis).ravel()
        all_mask = jax.lax.all_gather(mask, axis).ravel()
        return _sorted_segment_count(
            jnp.where(all_mask, all_hi, jnp.uint32(0xFFFFFFFF)),
            jnp.where(all_mask, all_lo, jnp.uint32(0xFFFFFFFF)),
            jnp.where(all_mask, all_cnt, 0),
        )

    return count(sharded)


def sharded_count_kmers_partitioned(
    mesh, codes: np.ndarray, k: int, slack: float = 2.0
):
    """Pod-scale counting: hash-partitioned ``all_to_all`` exchange.

    Unlike :func:`sharded_count_kmers` (gather-replicated tables), each
    device ends up OWNING a disjoint hash-partition of the key space —
    table memory scales 1/D with device count, the layout required at
    pod scale:

      1. every device extracts canonical k-mers from its read shard,
      2. k-mers route to owner = hash(kmer) mod D and are binned into a
         fixed-capacity [D, M] send buffer (M = slack * expected),
      3. one ``all_to_all`` exchanges the bins between devices,
      4. each device sort/segment-counts what it received.

    Returns (keys_hi, keys_lo, counts, mask, overflow): per-device
    partition tables concatenated along axis 0 ([D, M_recv, ...]
    flattened), plus the summed bin-overflow count — non-zero overflow
    means `slack` was too small and dropped k-mers (callers should
    retry with a larger slack; the uniform hash makes overflow
    vanishingly rare at realistic sizes).
    """
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from functools import partial

    axis = mesh.axis_names[-1]
    n_dev = int(mesh.devices.size)
    B = codes.shape[0]
    if B % n_dev:
        pad = n_dev - B % n_dev
        codes = np.concatenate(
            [codes, np.full((pad,) + codes.shape[1:], 4, dtype=codes.dtype)]
        )
    flat_mesh = jax.sharding.Mesh(mesh.devices.reshape(-1), (axis,))
    sharded = jax.device_put(
        jnp.asarray(codes), NamedSharding(flat_mesh, P(axis))
    )
    W = codes.shape[1] - k + 1
    per_dev = (codes.shape[0] // n_dev) * W
    capacity = int(slack * per_dev / n_dev) + 8

    @partial(
        shard_map,
        mesh=flat_mesh,
        in_specs=(P(axis),),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )
    def count(local_codes):
        hi, lo, valid = extract_canonical(local_codes, k)
        hi, lo, valid = hi.ravel(), lo.ravel(), valid.ravel()
        # owner = splitmix-style mix of the 64-bit key, mod D
        key_mix = (hi ^ jnp.uint32(0x9E3779B9)) * jnp.uint32(0x85EBCA6B) ^ (
            lo * jnp.uint32(0xC2B2AE35)
        )
        owner = (key_mix % jnp.uint32(n_dev)).astype(jnp.int32)
        owner = jnp.where(valid, owner, -1)

        # bin into [D, capacity] send buffers
        send_hi = jnp.full((n_dev, capacity), 0xFFFFFFFF, jnp.uint32)
        send_lo = jnp.full((n_dev, capacity), 0xFFFFFFFF, jnp.uint32)
        # slot index of each kmer within its destination bin
        onehot = jax.nn.one_hot(owner, n_dev, dtype=jnp.int32)  # [n, D]
        slot = jnp.cumsum(onehot, axis=0) - onehot  # occupancy before row
        slot_of = jnp.sum(slot * onehot, axis=1)  # [n]
        fits = valid & (slot_of < capacity)
        overflow = jnp.sum((valid & ~fits).astype(jnp.int32))
        # non-fitting entries route out of bounds and are dropped
        dest = jnp.where(fits, owner, n_dev)
        slot_oob = jnp.where(fits, slot_of, capacity)
        send_hi = send_hi.at[dest, slot_oob].set(hi, mode="drop")
        send_lo = send_lo.at[dest, slot_oob].set(lo, mode="drop")

        # exchange: axis d of the send buffer scatters to device d
        recv_hi = jax.lax.all_to_all(send_hi, axis, 0, 0, tiled=False)
        recv_lo = jax.lax.all_to_all(send_lo, axis, 0, 0, tiled=False)
        rhi = recv_hi.ravel()
        rlo = recv_lo.ravel()
        rvalid = ~((rhi == 0xFFFFFFFF) & (rlo == 0xFFFFFFFF))
        khi, klo, cnt, mask = count_kmers(rhi, rlo, rvalid)
        return (
            khi[None], klo[None], cnt[None], mask[None],
            jax.lax.psum(overflow, axis)[None],
        )

    khi, klo, cnt, mask, overflow = count(sharded)
    return khi, klo, cnt, mask, int(np.asarray(overflow)[0])


@jax.jit
def lookup_pair_sorted(keys_hi, keys_lo, qhi, qlo):
    """Vectorized lower-bound of (qhi, qlo) queries in the sorted
    (keys_hi, keys_lo) table; returns (index, found) arrays.

    Branchless binary search: ceil(log2(N)) gather steps over the whole
    query batch — the device replacement for Jellyfish's random hash
    probes (src/jellyfishcounter.cpp:87-104) against a FIXED key set.
    """
    n = keys_hi.shape[0]
    if n == 0:
        return (
            jnp.zeros(qhi.shape, jnp.int32),
            jnp.zeros(qhi.shape, bool),
        )
    steps = max(1, (n - 1).bit_length())
    lo_b = jnp.zeros(qhi.shape, jnp.int32)
    hi_b = jnp.full(qhi.shape, n, jnp.int32)

    def body(_, carry):
        lo_b, hi_b = carry
        mid = (lo_b + hi_b) // 2
        mhi = keys_hi[mid]
        mlo = keys_lo[mid]
        # key[mid] < q  (lexicographic on uint32 pairs == uint64 order)
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        return jnp.where(less, mid + 1, lo_b), jnp.where(less, hi_b, mid)

    lo_b, _ = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    idx = jnp.minimum(lo_b, n - 1)
    found = (keys_hi[idx] == qhi) & (keys_lo[idx] == qlo)
    return idx, found


DIR_BITS = 16


@partial(jax.jit, static_argnames=("steps",))
def lookup_pair_directed(keys_hi, keys_lo, directory, qhi, qlo,
                         steps: int):
    """Directory-accelerated lower bound: the sorted table is bucketed
    by the top DIR_BITS bits of `hi`; `directory` [2^DIR_BITS + 1]
    holds each bucket's start offset, so the binary search runs only
    `steps` = ceil(log2(max bucket width)) gather rounds instead of
    log2(N) — the dominant cost of the probe is these random
    device-memory gathers."""
    n = keys_hi.shape[0]
    bucket = (qhi >> jnp.uint32(32 - DIR_BITS)).astype(jnp.int32)
    lo_b = directory[bucket]
    hi_b = directory[bucket + 1]

    def body(_, carry):
        lo_b, hi_b = carry
        mid = (lo_b + hi_b) // 2
        mhi = keys_hi[mid]
        mlo = keys_lo[mid]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        return jnp.where(less, mid + 1, lo_b), jnp.where(less, hi_b, mid)

    lo_b, _ = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    idx = jnp.minimum(lo_b, n - 1)
    found = (keys_hi[idx] == qhi) & (keys_lo[idx] == qlo)
    return idx, found


@partial(jax.jit, static_argnames=("k", "steps"), donate_argnums=(4,))
def primed_update_batch(keys_hi, keys_lo, directory, codes, counts,
                        k: int, steps: int):
    """PRIME+UPDATE streaming step (src/jellyfishcounter.cpp:51-85):
    count one read batch's canonical k-mers INTO a fixed sorted table;
    k-mers absent from the table are dropped. `counts` is donated, so
    streaming updates are in place in device memory."""
    hi, lo, valid = extract_canonical(codes, k)
    idx, found = lookup_pair_directed(
        keys_hi, keys_lo, directory, hi.ravel(), lo.ravel(), steps
    )
    hits = (valid.ravel() & found).astype(counts.dtype)
    idx = jnp.where(valid.ravel() & found, idx, keys_hi.shape[0])
    return counts.at[idx].add(hits, mode="drop")


@partial(jax.jit, static_argnames=("k",), donate_argnums=(2,))
def primed_update_merge(keys_hi, keys_lo, counts, codes, k: int):
    """PRIME+UPDATE via sorted merge-join — no gathers, no scatters.

    One batch step: graph keys (weight 0, tag 0) and the batch's
    canonical k-mers (weight 1, tag 1) are sorted together on
    (hi, lo, tag); each graph key then sits at the START of its key
    segment, so the scatter-free segment sum (see
    :func:`_sorted_segment_count`) yields the batch occurrence count at
    exactly the graph rows. A stable partition by tag restores graph
    order (graph keys are unique and pre-sorted), and the counts add
    elementwise into the donated running table — in place of
    random-access probes (binary search + scatter-add).
    """
    hi, lo, valid = extract_canonical(codes, k)
    bad = jnp.uint32(0xFFFFFFFF)
    qhi = jnp.where(valid, hi, bad).ravel()
    qlo = jnp.where(valid, lo, bad).ravel()
    n_g = keys_hi.shape[0]
    all_hi = jnp.concatenate([keys_hi, qhi])
    all_lo = jnp.concatenate([keys_lo, qlo])
    tag = jnp.concatenate([
        jnp.zeros(n_g, jnp.uint32),
        jnp.ones(qhi.shape[0], jnp.uint32),
    ])
    w = jnp.concatenate([
        jnp.zeros(n_g, jnp.int32),
        valid.ravel().astype(jnp.int32),
    ])
    shi, slo, stag, sw = jax.lax.sort((all_hi, all_lo, tag, w), num_keys=3)
    n = shi.shape[0]
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    is_start = (shi != prev_hi) | (slo != prev_lo)
    is_end = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
    csum = jnp.cumsum(sw)
    big = jnp.iinfo(jnp.int32).max
    end_csum = jnp.where(is_end, csum, big)
    seg_end_csum = jax.lax.cummin(end_csum[::-1])[::-1]
    prev_csum = jnp.concatenate([jnp.zeros(1, csum.dtype), csum[:-1]])
    seg_counts = jnp.where(is_start, seg_end_csum - prev_csum, 0)
    # stable partition by tag: graph rows form the prefix in key order
    _, batch_counts = jax.lax.sort((stag, seg_counts), num_keys=1)
    return counts + batch_counts[:n_g]


@partial(jax.jit, static_argnames=("k",))
def _extract_tagged(codes: jax.Array, k: int):
    """Canonical k-mers of a [B, L] code batch as TAGGED key pairs.

    The (hi, lo) 2k-bit key is shifted left by one and tag bit 1 set in
    the new LSB (2k+1 <= 63 bits for k <= 31), so a later lexicographic
    sort orders by key first and graph-vs-read tag second WITHOUT a
    third sort operand. Invalid windows become the all-ones sentinel
    (max key, tag set) and sort to the top.
    """
    hi, lo, valid = extract_canonical(codes, k)
    thi = (hi << jnp.uint32(1)) | (lo >> jnp.uint32(31))
    tlo = (lo << jnp.uint32(1)) | jnp.uint32(1)
    bad = jnp.uint32(0xFFFFFFFF)
    thi = jnp.where(valid, thi, bad).ravel()
    tlo = jnp.where(valid, tlo, bad).ravel()
    return thi, tlo


@partial(jax.jit, donate_argnums=(3, 4))
def _append_tagged(thi, tlo, offset, buf_hi, buf_lo):
    """Write one batch's tagged keys into the accumulation buffer."""
    buf_hi = jax.lax.dynamic_update_slice(buf_hi, thi, (offset,))
    buf_lo = jax.lax.dynamic_update_slice(buf_lo, tlo, (offset,))
    return buf_hi, buf_lo


@partial(jax.jit, static_argnames=("L", "k"), donate_argnums=(3, 4))
def _ingest_packed(words, vwords, offset, buf_hi, buf_lo, L: int, k: int):
    """Fused unpack + canonical extract + tag + append: ONE dispatch
    per streamed batch."""
    codes = unpack_codes_2bit(words, vwords, L)
    thi, tlo = _extract_tagged(codes, k)
    buf_hi = jax.lax.dynamic_update_slice(buf_hi, thi, (offset,))
    buf_lo = jax.lax.dynamic_update_slice(buf_lo, tlo, (offset,))
    return buf_hi, buf_lo


@partial(jax.jit, static_argnames=("L", "k"), donate_argnums=(2, 3))
def _ingest_packed_nomask(words, offset, buf_hi, buf_lo, L: int, k: int):
    """Mask-free ingest for batches of full-length, all-ACGT reads.

    Skipping the validity words cuts host->device traffic by a third
    (0.25 vs 0.375 bytes/base); fixed-length Illumina-style reads
    without Ns (split at Ns host-side) are the common case."""
    B = words.shape[0]
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    c = (words[:, :, None] >> shifts) & jnp.uint32(3)
    codes = c.reshape(B, -1)[:, :L].astype(jnp.uint8)
    W = L - k + 1
    u = jnp.uint32
    cc = codes.astype(jnp.uint32)
    hi = jnp.zeros((B, W), jnp.uint32)
    lo = jnp.zeros((B, W), jnp.uint32)
    for i in range(k):
        ci = jax.lax.dynamic_slice_in_dim(cc, i, W, axis=1)
        bitpos = 2 * (k - 1 - i)
        if bitpos >= 32:
            hi = hi | (ci << u(bitpos - 32))
        else:
            lo = lo | (ci << u(bitpos))
    rhi, rlo = _rc_pair(hi, lo, k)
    chi, clo = _min_pair(hi, lo, rhi, rlo)
    thi = ((chi << u(1)) | (clo >> u(31))).ravel()
    tlo = ((clo << u(1)) | u(1)).ravel()
    buf_hi = jax.lax.dynamic_update_slice(buf_hi, thi, (offset,))
    buf_lo = jax.lax.dynamic_update_slice(buf_lo, tlo, (offset,))
    return buf_hi, buf_lo


@partial(jax.jit, static_argnames=("size",), donate_argnums=(2,))
def _flush_tagged(ghi, glo, counts, buf_hi, buf_lo, size: Optional[int] = None):
    """Merge one accumulation buffer into the graph count table.

    ONE lexicographic sort of [graph keys (tag 0) ++ buffered read
    kmers (tag 1)] groups equal keys with the graph row FIRST in its
    segment; the scatter-free prefix-sum segment count (weight = tag,
    so graph rows weigh 0) then yields each graph key's occurrence
    count at its row, and a stable partition by tag compacts the graph
    rows — still in table order — to the front. Cost: one 2-operand
    sort + one 2-operand 1-key sort over n_g + fill elements,
    amortizing the graph table over every batch in the buffer (a
    per-batch merge re-sorts the graph keys for every batch streamed).
    Callers slice the buffer to (near) the actual fill before calling:
    sort cost is what dominates counting, and capacity-sized sentinel
    tails would be sorted for nothing.
    """
    n_g = ghi.shape[0]
    if size is not None and size < buf_hi.shape[0]:
        buf_hi = jax.lax.slice(buf_hi, (0,), (size,))
        buf_lo = jax.lax.slice(buf_lo, (0,), (size,))
    all_hi = jnp.concatenate([ghi, buf_hi])
    all_lo = jnp.concatenate([glo, buf_lo])
    shi, slo = jax.lax.sort((all_hi, all_lo), num_keys=2)
    stag = (slo & jnp.uint32(1)).astype(jnp.int32)
    klo = slo & jnp.uint32(0xFFFFFFFE)  # key bits without the tag
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([klo[:1], klo[:-1]])
    is_start = (shi != prev_hi) | (klo != prev_lo)
    is_end = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
    csum = jnp.cumsum(stag)
    big = jnp.iinfo(jnp.int32).max
    end_csum = jnp.where(is_end, csum, big)
    seg_end_csum = jax.lax.cummin(end_csum, reverse=True)
    prev_csum = jnp.concatenate([jnp.zeros(1, csum.dtype), csum[:-1]])
    seg_counts = jnp.where(is_start, seg_end_csum - prev_csum, 0)
    # stable partition by tag: graph rows form the prefix in key order
    _, part_counts = jax.lax.sort((stag, seg_counts), num_keys=1)
    return counts + part_counts[:n_g]


@partial(jax.jit, static_argnames=("n_out", "size"), donate_argnums=(2, 3))
def _dedupe_round(held_hi, held_lo, buf_hi, buf_lo, n_out: int,
                  size: Optional[int] = None):
    """Fold one tagged-key buffer into the compact unique-key table.

    Sorts [held unique keys ++ buffered keys], keeps each distinct
    key's first slot (sentinels dropped), and stable-partitions the
    kept keys — still sorted — into the fixed-size [n_out] prefix.
    Used by the on-device PRIME build (see
    PrimedDeviceCounter._prime_from_corpus)."""
    if size is not None and size < buf_hi.shape[0]:
        buf_hi = jax.lax.slice(buf_hi, (0,), (size,))
        buf_lo = jax.lax.slice(buf_lo, (0,), (size,))
    all_hi = jnp.concatenate([held_hi, buf_hi])
    all_lo = jnp.concatenate([held_lo, buf_lo])
    shi, slo = jax.lax.sort((all_hi, all_lo), num_keys=2)
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    is_first = (shi != prev_hi) | (slo != prev_lo)
    bad = (shi == jnp.uint32(0xFFFFFFFF)) & (slo == jnp.uint32(0xFFFFFFFF))
    keep = is_first & ~bad
    _, phi, plo = jax.lax.sort(
        ((~keep).astype(jnp.uint32), shi, slo), num_keys=1
    )
    return phi[:n_out], plo[:n_out]


@jax.jit
def _table_checksums(hi, lo):
    """Wraparound uint32 sums of a tagged table (one tiny readback).

    The accumulator dtype is pinned to uint32: under x64 jnp.sum would
    otherwise promote to uint64 and the mod-2^32 wrap would no longer
    match the host side."""
    return jnp.stack([
        jnp.sum(hi, dtype=jnp.uint32),
        jnp.sum(lo & jnp.uint32(0xFFFFFFFE), dtype=jnp.uint32),
    ])


class PrimedDeviceCounter:
    """Device PRIME+UPDATE counter: graph k-mers registered once as a
    sorted tagged-key table; read batches accumulate into a large
    device buffer and are folded into the counts by
    :func:`_flush_tagged` when it fills. Fixed shapes per batch size
    and one fixed flush shape => a handful of XLA compiles; table
    memory stays O(graph kmers + capacity) regardless of read volume —
    the device analogue of the reference's memory-saving default mode
    (src/jellyfishcounter.cpp:51-85).

    ``corpus_files`` enables the on-device PRIME build: the packed
    corpus (0.25 bytes/base) streams to the device, which extracts,
    sorts and dedupes the graph keys itself — versus shipping the
    8-bytes/key host table. The device table is validated against the
    host keys by checksum and falls back to the transfer on any
    mismatch."""

    def __init__(self, k: int, keys: np.ndarray,
                 capacity: Optional[int] = None,
                 corpus_files: Optional[List[str]] = None):
        if not (1 <= k <= 31):
            raise ValueError("PrimedDeviceCounter supports k in [1, 31].")
        self.k = k
        keys = np.sort(np.asarray(keys, dtype=np.uint64))
        if capacity is None:
            # large enough to amortize the graph-table sort over many
            # read batches, small enough that the flush sort workspace
            # stays a modest slice of device memory (and CPU tests stay
            # fast). Hard cap 64M: XLA compile time of the
            # donated-buffer ingest/flush programs grew steeply beyond
            # it on the device the engine was first built for; not yet
            # measured on the GPU
            capacity = max(1 << 20, min(16 * max(1, len(keys)), 64 << 20))
        self._keys = keys
        self._capacity = int(capacity)
        self._hi = self._lo = None
        self.primed_on_device = False
        # OPT-IN: building the table on device replaces an 8-bytes/key
        # host transfer with two device sort programs, whose compiles
        # are large at graph-table sizes; which wins on the GPU is not
        # measured yet.
        import os

        if (
            corpus_files
            and len(keys)
            and os.environ.get("PANGENIE_TPU_DEVICE_PRIME")
        ):
            self._prime_from_corpus(corpus_files)
            self.primed_on_device = self._hi is not None
        if self._hi is None:
            # tagged graph keys (tag bit 0): (key << 1) split at bit 32
            tagged = keys << np.uint64(1)
            self._hi = jnp.asarray((tagged >> np.uint64(32)).astype(np.uint32))
            self._lo = jnp.asarray((tagged & np.uint64(MASK32)).astype(np.uint32))
        self._counts = jnp.zeros(len(keys), jnp.int32)
        self._fill = 0
        self._buf_hi = None
        self._buf_lo = None

    def _prime_from_corpus(self, corpus_files: List[str]) -> None:
        """Build the sorted graph-key table ON DEVICE from the corpus.

        Streams every corpus sequence as fixed-length chunks
        (overlapping k-1 so no window is lost) through the packed
        ingest path, deduping rounds into a fixed [n_keys] table.
        Success criterion: the device table's checksums equal the host
        key set's — guaranteed when extraction agrees, since both are
        sorted unique sets of the same size."""
        from . import native
        from .counter import try_sequence_blocks

        if not native.available():
            return
        n_keys = len(self._keys)
        cap = self._capacity
        if n_keys >= cap:
            return
        k = self.k
        CH = 1 << 15
        step = CH - (k - 1)
        win = CH - k + 1
        rows_per = max(1, (cap // 2) // win)

        bad = jnp.uint32(0xFFFFFFFF)
        held_hi = jnp.full(n_keys, bad)
        held_lo = jnp.full(n_keys, bad)
        buf_hi = jnp.full(cap, bad)
        buf_lo = jnp.full(cap, bad)
        fill = 0

        def quantized(n: int) -> int:
            size = 1 << 20
            while size < n:
                size *= 2
            if size > (1 << 20):
                s = size // 16
                size = ((n + s - 1) // s) * s
            return min(size, cap)

        def fold(buf_hi, buf_lo, fill):
            return _dedupe_round(
                held_hi, held_lo, buf_hi, buf_lo, n_keys,
                size=quantized(max(1, fill)),
            )

        for filename in corpus_files:
            blocks = try_sequence_blocks(filename)
            if blocks is None:
                return  # gz/FASTQ corpus: fall back to the transfer
            for data, offsets in blocks:
                data = np.asarray(data, dtype=np.uint8)
                lens = np.diff(offsets)
                starts = offsets[:-1]
                keep = lens >= k
                nw = lens[keep] - (k - 1)
                seq_starts = starts[keep]
                seq_lens = lens[keep]
                if not len(nw):
                    continue
                n_chunks = (nw + step - 1) // step
                seq_idx = np.repeat(
                    np.arange(len(nw), dtype=np.int64), n_chunks
                )
                first = np.concatenate(
                    [[0], np.cumsum(n_chunks)[:-1]]
                )
                within = (
                    np.arange(len(seq_idx), dtype=np.int64)
                    - first[seq_idx]
                )
                row_start = seq_starts[seq_idx] + within * step
                row_len = np.minimum(
                    CH, seq_lens[seq_idx] - within * step
                )
                for lo_i in range(0, len(row_start), rows_per):
                    rs = row_start[lo_i:lo_i + rows_per]
                    rl = row_len[lo_i:lo_i + rows_per]
                    if len(rs) < rows_per and lo_i > 0:
                        pad = rows_per - len(rs)
                        rs = np.concatenate([rs, np.zeros(pad, np.int64)])
                        rl = np.concatenate([rl, np.zeros(pad, np.int64)])
                    packed = native.pack_rows(data, rs, rl, CH)
                    if packed is None:
                        return
                    n_win = len(rs) * win
                    if fill + n_win > cap:
                        held_hi, held_lo = fold(buf_hi, buf_lo, fill)
                        buf_hi = jnp.full(cap, bad)
                        buf_lo = jnp.full(cap, bad)
                        fill = 0
                    buf_hi, buf_lo = _ingest_packed(
                        jnp.asarray(packed[0]), jnp.asarray(packed[1]),
                        fill, buf_hi, buf_lo, CH, k,
                    )
                    fill += n_win
        held_hi, held_lo = fold(buf_hi, buf_lo, fill)

        sums = np.asarray(_table_checksums(held_hi, held_lo))
        tagged = self._keys << np.uint64(1)
        want_hi = (tagged >> np.uint64(32)).astype(np.uint32).sum(
            dtype=np.uint32
        )
        want_lo = (tagged.astype(np.uint64) & np.uint64(0xFFFFFFFE)).astype(
            np.uint32
        ).sum(dtype=np.uint32)
        if int(sums[0]) != int(want_hi) or int(sums[1]) != int(want_lo):
            import sys

            print(
                "PrimedDeviceCounter: device-built table checksum mismatch; "
                "falling back to host key transfer",
                file=sys.stderr,
            )
            return
        # clear the ingest tag bit: tagged-read (key<<1)|1 and
        # tagged-graph (key<<1) share hi; only lo's LSB differs
        self._hi = held_hi
        self._lo = held_lo & jnp.uint32(0xFFFFFFFE)

    def _reset_buffer(self) -> None:
        bad = jnp.uint32(0xFFFFFFFF)
        self._buf_hi = jnp.full(self._capacity, bad)
        self._buf_lo = jnp.full(self._capacity, bad)
        self._fill = 0

    def _flush(self) -> None:
        import os
        import time as _time

        if self._buf_hi is None or self._fill == 0:
            return
        _t0 = _time.monotonic()
        # sort only (about) what was filled: round the fill up to the
        # next 1/8-step of a power of two (1.0, 1.125, ..., 1.875 x
        # 2^m) so only a few dozen flush shapes ever compile while the
        # sentinel tail stays under 12.5% of the sort
        size = 1 << 20
        while size < self._fill:
            size *= 2
        if size > (1 << 20):
            step = size // 16
            size = ((self._fill + step - 1) // step) * step
        size = min(size, int(self._buf_hi.shape[0]))
        # prefer a size this process has already compiled (same graph
        # table length): XLA compile of a big-sort program costs minutes
        # on some backends, far more than sorting a somewhat larger
        # sentinel tail (typical case: the final partial flush reuses
        # the steady full-buffer shape)
        seen = _FLUSH_SIZES.setdefault(len(self._keys), set())
        compiled = [
            s for s in seen if size <= s <= int(self._buf_hi.shape[0])
        ]
        if compiled:
            size = min(compiled)
        seen.add(size)
        self._counts = _flush_tagged(
            self._hi, self._lo, self._counts, self._buf_hi, self._buf_lo,
            size=size,
        )
        self._buf_hi = None
        self._buf_lo = None
        self._fill = 0
        if os.environ.get("PANGENIE_TPU_COUNTER_DEBUG"):
            import sys

            print(
                f"    [flush] size={size} enqueue_wall="
                f"{_time.monotonic() - _t0:.1f}s",
                file=sys.stderr,
            )

    def _add_tagged(self, thi, tlo) -> None:
        n = thi.shape[0]
        if n > self._capacity:
            # batch larger than the buffer: grow to fit (rare; capacity
            # is sized to hold many batches)
            self._flush()
            self._capacity = int(n)
        if self._buf_hi is None:
            self._reset_buffer()
        if self._fill + n > self._capacity:
            self._flush()
            self._reset_buffer()
        self._buf_hi, self._buf_lo = _append_tagged(
            thi, tlo, self._fill, self._buf_hi, self._buf_lo
        )
        self._fill += n

    def update_batch(self, codes: np.ndarray) -> None:
        if not len(self._keys):
            return
        self._add_tagged(*_extract_tagged(jnp.asarray(codes), self.k))

    def update_packed_batch(self, words: np.ndarray,
                            vwords: Optional[np.ndarray],
                            length: int) -> None:
        """Streaming update from 2-bit packed reads (pack_codes_2bit).

        One fused device dispatch per batch; flushes happen between
        batches when the accumulation buffer would overflow.
        ``vwords=None`` asserts every base of every row is a valid
        ACGT code of a full-length read and skips the validity-mask
        transfer entirely (a third of the stream bytes).
        """
        if not len(self._keys):
            return
        B = words.shape[0]
        n = B * max(0, length - self.k + 1)
        if n == 0:
            return
        if n > self._capacity:
            self._flush()
            self._capacity = int(n)
        if self._buf_hi is None:
            self._reset_buffer()
        if self._fill + n > self._capacity:
            self._flush()
            self._reset_buffer()
        if vwords is None:
            self._buf_hi, self._buf_lo = _ingest_packed_nomask(
                jnp.asarray(words), self._fill,
                self._buf_hi, self._buf_lo, length, self.k,
            )
        else:
            self._buf_hi, self._buf_lo = _ingest_packed(
                jnp.asarray(words), jnp.asarray(vwords), self._fill,
                self._buf_hi, self._buf_lo, length, self.k,
            )
        self._fill += n

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        import os

        self._flush()
        n = len(self._keys)
        # OPT-IN like the on-device prime: the saturate/nonzero/gather
        # programs cut readback bytes at the price of more compiles
        if n >= (1 << 22) and os.environ.get("PANGENIE_TPU_U8_READBACK"):
            # saturated uint8 readback: 4x fewer bytes to the host;
            # the (rare) counts >= 255 are restored exactly from a
            # small index/value gather
            cap_over = max(1, n // 64)
            over = np.asarray(
                jnp.nonzero(
                    self._counts >= 255, size=cap_over, fill_value=-1
                )[0]
            )
            over = over[over >= 0]
            if len(over) == cap_over:
                # overflow list may be truncated (extremely repetitive
                # corpus): take the full exact readback instead
                counts = np.asarray(self._counts).astype(np.int64)[:n]
                return self._keys, counts
            small = np.asarray(
                jnp.minimum(self._counts, 255).astype(jnp.uint8)
            )
            counts = small.astype(np.int64)[:n]
            if len(over):
                vals = np.asarray(self._counts[jnp.asarray(over)])
                counts[over] = vals
            return self._keys, counts
        counts = np.asarray(self._counts).astype(np.int64)
        return self._keys, counts[: len(self._keys)]

    def to_exact_counter(self):
        from .counter import ExactKmerCounter

        keys, counts = self.to_host_arrays()
        keep = counts > 0
        return ExactKmerCounter(self.k, keys[keep], counts[keep])


def count_file_primed_device(
    read_file: str,
    corpus_files,
    k: int,
    block_bases: int = 32 << 20,
    shard=None,
    keys: Optional[np.ndarray] = None,
) -> "ExactKmerCounter":  # noqa: F821 (forward ref, see import below)
    """PRIME+UPDATE counting of a read file on the device.

    The genotype-phase counting path on an accelerator (host engine:
    ``ExactKmerCounter.count_file_primed``). Graph-corpus k-mers are
    extracted host-side (native C++), registered once as the fixed
    device table, and the read file is streamed through
    :func:`primed_update_merge` in fixed-shape batches:

    - reads are bucketed by length (next power of two, >=128) so each
      bucket compiles exactly one XLA executable,
    - a bucket flushes when it holds ~``block_bases`` bases; the final
      partial flush pads with invalid rows (masked in the kernel),
    - host packing (2 bits/base + validity bit) overlaps device compute
      since ``primed_update_merge`` dispatches asynchronously.

    ``block_bases`` is the device-memory knob standing in for the
    reference's jellyfish hash size `-e` (src/jellyfishcounter.cpp:29-36):
    the count table itself is O(graph kmers) regardless of read volume;
    the streaming buffer is what scales with it.

    ``shard=(process index, process count)`` restricts the stream to
    every n-th read for multi-host runs (parallel/distributed.py).

    Returns an ExactKmerCounter with the SAME key set and counts the
    host primed counter produces (zero-count graph keys included).
    """
    from .counter import ExactKmerCounter, iter_sequences
    import sys
    import time as _time

    _t0 = _time.monotonic()

    if keys is None:
        # ``keys`` short-circuits the corpus re-extraction when the
        # caller already holds the graph-kmer table (run_single_command
        # counts the corpus first; the key sets are identical)
        corpus_kmers = [
            ExactKmerCounter._extract_canonical(iter_sequences(f), k)
            for f in corpus_files
        ]
        keys = np.unique(
            np.concatenate(corpus_kmers)
            if corpus_kmers
            else np.empty(0, dtype=np.uint64)
        )
    if not len(keys):
        return ExactKmerCounter(k, keys, np.zeros(0, dtype=np.int64))

    counter = PrimedDeviceCounter(k, keys, corpus_files=list(corpus_files))
    _t_prime = _time.monotonic()
    min_bucket = 128

    def bucket_of(n: int) -> int:
        # eighth-steps of powers of two: 150 bp reads land in a 152
        # bucket, not 256 — padded windows ride through every sort as
        # sentinels, so tight buckets halve the device work for
        # Illumina-length reads
        b = min_bucket
        while b < n:
            b *= 2
        if b > min_bucket:
            step = b // 16
            b = ((n + step - 1) // step) * step
        return b

    from . import native
    from .counter import try_sequence_blocks

    raw_blocks = try_sequence_blocks(read_file)
    if raw_blocks is not None and native.available():
        # fast path: native FASTA parse + native encode-and-pack
        # straight from the raw byte buffer (pg_pack_rows) — the
        # earlier numpy window-gather pipeline cost ~90 ms/Mbp of host
        # time, several times the device dispatch itself
        shard_i, shard_n = shard if shard is not None else (0, 1)
        base = 0
        for data, offsets in raw_blocks:
            data = np.asarray(data, dtype=np.uint8)
            lens = np.diff(offsets)
            starts = offsets[:-1]
            n_here = len(lens)
            keep = lens >= k
            if shard_n > 1:
                keep &= (base + np.arange(n_here)) % shard_n == shard_i
            base += n_here
            lens_k = lens[keep]
            starts_k = starts[keep]
            if not len(lens_k):
                continue
            shift = np.maximum(
                0, np.ceil(np.log2(lens_k / min_bucket)).astype(np.int64)
            )
            pow2 = np.int64(min_bucket) << shift
            # eighth-steps within each power-of-two octave (see
            # bucket_of): tight buckets halve sentinel windows
            step = np.maximum(pow2 // 16, 1)
            buckets = np.where(
                pow2 > min_bucket,
                ((lens_k + step - 1) // step) * step,
                pow2,
            )
            for L in np.unique(buckets):
                rows = buckets == L
                row_starts = starts_k[rows]
                row_lens = lens_k[rows]
                # size batches so (at least) two fit in the flush
                # buffer: each flush then amortizes the graph-table
                # sort over twice the read volume
                win = max(1, int(L) - k + 1)
                rows_per = max(1, min(
                    block_bases // int(L),
                    (counter._capacity // 2 - 8) // win,
                ))
                n_rows = len(row_starts)
                for lo in range(0, n_rows, rows_per):
                    cs = row_starts[lo: lo + rows_per]
                    cl = row_lens[lo: lo + rows_per]
                    if len(cs) < rows_per and lo > 0:
                        # pad with empty rows (all-invalid) to keep the
                        # device shape compiled once
                        pad = rows_per - len(cs)
                        cs = np.concatenate([cs, np.zeros(pad, np.int64)])
                        cl = np.concatenate([cl, np.zeros(pad, np.int64)])
                    words, vwords = native.pack_rows(data, cs, cl, int(L))
                    counter.update_packed_batch(words, vwords, int(L))
        _t_stream = _time.monotonic()
        keys_out, counts = counter.to_host_arrays()
        print(
            f"  [device counter] prime {_t_prime - _t0:.1f}s "
            f"(on_device={counter.primed_on_device}) "
            f"stream {_t_stream - _t_prime:.1f}s "
            f"flush+readback {_time.monotonic() - _t_stream:.1f}s",
            file=sys.stderr,
        )
        return ExactKmerCounter(k, keys_out, counts)

    pending: dict = {}  # L_bucket -> (rows list, fixed row count)

    def flush(L: int) -> None:
        rows, nrows = pending.pop(L)
        if not rows:
            return
        if len(rows) < nrows:  # final partial block: pad invalid rows
            rows = rows + [b""] * (nrows - len(rows))
        codes, _ = pack_read_batch(rows, length=L)
        packed = pack_codes_2bit(codes)
        counter.update_packed_batch(packed[0], packed[1], L)

    from ..parallel.distributed import shard_sequences

    for seq in shard_sequences(iter_sequences(read_file), shard):
        if len(seq) < k:
            continue
        L = bucket_of(len(seq))
        if L not in pending:
            pending[L] = ([], max(1, block_bases // L))
        rows, nrows = pending[L]
        rows.append(seq)
        if len(rows) >= nrows:
            flush(L)
    for L in list(pending):
        flush(L)

    keys_out, counts = counter.to_host_arrays()
    return ExactKmerCounter(k, keys_out, counts)


class DeviceKmerCounter:
    """Batch-streaming device counter with host-compatible output."""

    def __init__(self, k: int):
        if not (1 <= k <= 31):
            raise ValueError("DeviceKmerCounter supports k in [1, 31].")
        self.k = k
        self._table = None  # (hi, lo, counts, mask) device arrays

    def add_batch(self, codes: np.ndarray) -> None:
        """Count one [B, L] code batch and merge into the table."""
        hi, lo, valid = extract_canonical(jnp.asarray(codes), self.k)
        table = count_kmers(hi, lo, valid)
        if self._table is None:
            self._table = table
        else:
            self._table = merge_tables(*self._table, *table)

    def add_packed_batch(self, words: np.ndarray, vwords: np.ndarray,
                         length: int) -> None:
        """Count one 2-bit packed batch (see pack_codes_2bit)."""
        codes = unpack_codes_2bit(
            jnp.asarray(words), jnp.asarray(vwords), length
        )
        hi, lo, valid = extract_canonical(codes, self.k)
        table = count_kmers(hi, lo, valid)
        if self._table is None:
            self._table = table
        else:
            self._table = merge_tables(*self._table, *table)

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys uint64, counts int64) — the host counter's layout."""
        if self._table is None:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        hi, lo, cnt, mask = (np.asarray(x) for x in self._table)
        keep = mask.astype(bool)
        keys = (hi[keep].astype(np.uint64) << np.uint64(32)) | lo[
            keep
        ].astype(np.uint64)
        return keys, cnt[keep].astype(np.int64)

    def to_exact_counter(self):
        from .counter import ExactKmerCounter

        keys, counts = self.to_host_arrays()
        return ExactKmerCounter(self.k, keys, counts)


# ---------------------------------------------------------------------------
# Pod-scale sharded PRIME+UPDATE
# ---------------------------------------------------------------------------


def _owner_mix(thi, tlo, n_dev):
    """Owner device of a tagged key: splitmix-style mix of the key bits
    (tag stripped, so graph and read forms of the same k-mer agree),
    mod device count. jnp/np polymorphic (uint32 wraparound both)."""
    key_lo = tlo & 0xFFFFFFFE
    mix = (thi ^ 0x9E3779B9) * 0x85EBCA6B ^ (key_lo * 0xC2B2AE35)
    return mix % n_dev


class ShardedPrimedDeviceCounter:
    """PRIME+UPDATE counting with the graph table HASH-PARTITIONED over
    a device mesh: a human graph corpus holds ~2.5-3G distinct 31-mers
    (~30+ GB of table + flush workspace), so each device OWNS the keys
    hashing to it
    (table memory scales 1/D) and read batches route to their owners
    through one ``all_to_all`` per ingest step before the same
    sort-based tagged-key flush runs shard-locally. The collective
    replacement for the reference's shared lock-free jellyfish hash
    (src/jellyfishcounter.cpp:29-85) — exchanges ride NVLink instead
    of a memory bus.

    Exactness: the owner hash is a pure function of the canonical
    k-mer, so every read window lands on the device holding its graph
    row; windows whose k-mer is in no partition (or invalid windows)
    match nothing and are dropped by the flush sort, exactly as in the
    single-device counter.
    """

    def __init__(self, mesh, k: int, keys: np.ndarray,
                 buffer_capacity: Optional[int] = None,
                 slack: float = 3.0):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        if not (1 <= k <= 31):
            raise ValueError("supports k in [1, 31]")
        self.k = k
        self.slack = float(slack)
        axis = mesh.axis_names[-1]
        self._axis = axis
        self._mesh = jax.sharding.Mesh(mesh.devices.reshape(-1), (axis,))
        D = int(mesh.devices.size)
        self.n_devices = D

        keys = np.sort(np.asarray(keys, dtype=np.uint64))
        self._keys = keys
        tagged = keys << np.uint64(1)
        thi = (tagged >> np.uint64(32)).astype(np.uint32)
        tlo = (tagged & np.uint64(MASK32)).astype(np.uint32)
        with np.errstate(over="ignore"):
            owner = _owner_mix(thi, tlo, np.uint32(D)).astype(np.int64)
        order = np.argsort(owner, kind="stable")  # sorted within owner
        self._order = order
        per_dev = np.bincount(owner, minlength=D)
        self._per_dev = per_dev
        M = max(1, int(per_dev.max()))
        self._M = M
        # padding rows: key bits all-ones with tag 0 — they sort last
        # within the graph prefix; any count they pick up (from invalid
        # read windows, whose key bits are also all-ones) is discarded
        # when the partitions are reassembled host-side
        part_hi = np.full((D, M), 0xFFFFFFFF, np.uint32)
        part_lo = np.full((D, M), 0xFFFFFFFE, np.uint32)
        off = 0
        for d in range(D):
            n_d = int(per_dev[d])
            rows = order[off:off + n_d]
            part_hi[d, :n_d] = thi[rows]
            part_lo[d, :n_d] = tlo[rows]
            off += n_d
        shard = NamedSharding(self._mesh, P(axis))
        self._ghi = jax.device_put(jnp.asarray(part_hi), shard)
        self._glo = jax.device_put(jnp.asarray(part_lo), shard)
        self._counts = jax.device_put(jnp.zeros((D, M), jnp.int32), shard)
        if buffer_capacity is None:
            buffer_capacity = max(1 << 18, min(16 * M, 64 << 20))
        self._cap = int(buffer_capacity)
        self._buf_hi = jax.device_put(
            jnp.full((D, self._cap), 0xFFFFFFFF, jnp.uint32), shard
        )
        self._buf_lo = jax.device_put(
            jnp.full((D, self._cap), 0xFFFFFFFF, jnp.uint32), shard
        )
        self._fill = 0
        self._overflow = jax.device_put(jnp.zeros((D,), jnp.int32), shard)
        self._sharding = shard
        self._ingest_cache = {}
        self._flush_cache = None

    # -- jitted shard_map programs (built per (B, L) shape) -------------

    def _ingest_program(self, B: int, L: int, cap_x: int):
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from functools import partial

        key = (B, L, cap_x)
        prog = self._ingest_cache.get(key)
        if prog is not None:
            return prog
        D = self.n_devices
        k = self.k
        axis = self._axis

        @partial(
            shard_map, mesh=self._mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), None),
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        )
        def step(local_codes, buf_hi, buf_lo, overflow, offset):
            # local_codes [B/D, L] -> tagged windows
            thi, tlo = _extract_tagged(local_codes, k)
            valid = ~((thi == jnp.uint32(0xFFFFFFFF))
                      & (tlo == jnp.uint32(0xFFFFFFFF)))
            owner = _owner_mix(thi, tlo, jnp.uint32(D)).astype(jnp.int32)
            onehot = jax.nn.one_hot(
                jnp.where(valid, owner, -1), D, dtype=jnp.int32
            )
            slot = jnp.cumsum(onehot, axis=0) - onehot
            slot_of = jnp.sum(slot * onehot, axis=1)
            fits = valid & (slot_of < cap_x)
            over = jnp.sum((valid & ~fits).astype(jnp.int32))
            dest = jnp.where(fits, owner, D)
            slot_oob = jnp.where(fits, slot_of, cap_x)
            send_hi = jnp.full((D, cap_x), 0xFFFFFFFF, jnp.uint32)
            send_lo = jnp.full((D, cap_x), 0xFFFFFFFF, jnp.uint32)
            send_hi = send_hi.at[dest, slot_oob].set(thi, mode="drop")
            send_lo = send_lo.at[dest, slot_oob].set(tlo, mode="drop")
            recv_hi = jax.lax.all_to_all(
                send_hi, axis, 0, 0, tiled=False
            ).ravel()
            recv_lo = jax.lax.all_to_all(
                send_lo, axis, 0, 0, tiled=False
            ).ravel()
            bh = jax.lax.dynamic_update_slice(buf_hi[0], recv_hi, (offset,))
            bl = jax.lax.dynamic_update_slice(buf_lo[0], recv_lo, (offset,))
            return bh[None], bl[None], overflow + over

        prog = jax.jit(step, donate_argnums=(1, 2, 3))
        self._ingest_cache[key] = prog
        return prog

    def _flush_program(self):
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from functools import partial

        if self._flush_cache is not None:
            return self._flush_cache
        axis = self._axis

        @partial(
            shard_map, mesh=self._mesh,
            in_specs=(P(axis),) * 5,
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        )
        def flush(ghi, glo, counts, buf_hi, buf_lo):
            new_counts = _flush_tagged.__wrapped__(
                ghi[0], glo[0], counts[0], buf_hi[0], buf_lo[0]
            )
            bad = jnp.uint32(0xFFFFFFFF)
            return (
                new_counts[None],
                jnp.full_like(buf_hi, bad),
                jnp.full_like(buf_lo, bad),
            )

        self._flush_cache = jax.jit(flush, donate_argnums=(2, 3, 4))
        return self._flush_cache

    # -- streaming API ---------------------------------------------------

    def update_batch(self, codes: np.ndarray) -> None:
        """Ingest a [B, L] base-code batch (one all_to_all exchange)."""
        import jax

        B, L = codes.shape
        D = self.n_devices
        if B % D:
            pad = D - B % D
            codes = np.concatenate(
                [codes, np.full((pad, L), 4, np.uint8)]
            )
            B += pad
        W = L - self.k + 1
        per_dev_windows = (B // D) * W
        cap_x = int(self.slack * per_dev_windows / D) + 16
        if D * cap_x > self._cap and B > D:
            # more windows than the buffer holds (a small graph table
            # sizes a small buffer): ingest the batch in halves
            half = (B // 2 + D - 1) // D * D
            self.update_batch(codes[:half])
            self.update_batch(codes[half:])
            return
        if self._fill + D * cap_x > self._cap:
            self._flush()
        if self._fill + D * cap_x > self._cap:
            raise RuntimeError(
                "ShardedPrimedDeviceCounter: batch exceeds buffer "
                "capacity; raise buffer_capacity or shrink batches."
            )
        sharded_codes = jax.device_put(
            jnp.asarray(codes), self._sharding
        )
        prog = self._ingest_program(B, L, cap_x)
        self._buf_hi, self._buf_lo, self._overflow = prog(
            sharded_codes, self._buf_hi, self._buf_lo, self._overflow,
            self._fill,
        )
        self._fill += D * cap_x

    def _flush(self) -> None:
        if self._fill == 0:
            return
        prog = self._flush_program()
        self._counts, self._buf_hi, self._buf_lo = prog(
            self._ghi, self._glo, self._counts, self._buf_hi, self._buf_lo
        )
        self._fill = 0

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted keys, counts) — partitions reassembled host-side."""
        self._flush()
        overflow = int(np.asarray(self._overflow).sum())
        if overflow:
            raise RuntimeError(
                f"ShardedPrimedDeviceCounter: {overflow} k-mers dropped "
                "by exchange-bin overflow; raise `slack`."
            )
        mat = np.asarray(self._counts).astype(np.int64)  # [D, M]
        concat = np.concatenate(
            [mat[d, : int(self._per_dev[d])] for d in range(self.n_devices)]
        )
        counts = np.empty(len(self._keys), np.int64)
        counts[self._order] = concat
        return self._keys, counts

    def to_exact_counter(self):
        from .counter import ExactKmerCounter

        keys, counts = self.to_host_arrays()
        keep = counts > 0
        return ExactKmerCounter(self.k, keys[keep], counts[keep])


def count_stream_sharded(
    mesh, read_blocks, k: int, keys: np.ndarray,
    chunk: int = 4096, batch_rows: int = 4096,
    buffer_capacity: Optional[int] = None, slack: float = 3.0,
) -> "ShardedPrimedDeviceCounter":
    """Drive a ShardedPrimedDeviceCounter from (data, offsets) read
    blocks (the native FASTA parser's output). Reads are joined with
    k-1 invalid separator bases and re-chunked into fixed [batch_rows,
    chunk] code batches with k-1 overlap, so every read window appears
    exactly once and no cross-read windows exist — one XLA program per
    batch shape regardless of read-length mix."""
    counter = ShardedPrimedDeviceCounter(
        mesh, k, keys, buffer_capacity=buffer_capacity, slack=slack
    )
    step = chunk - (k - 1)
    sep = np.full(k - 1, 4, np.uint8)
    pending = np.zeros(0, np.uint8)
    from ..io.sequence import _ENCODE_LUT

    def emit(stream: np.ndarray, final: bool):
        nonlocal pending
        stream = np.concatenate([pending, stream])
        n_rows = max(0, (len(stream) - (k - 1) + step - 1) // step)
        if not final:
            n_rows = (n_rows // batch_rows) * batch_rows
        used = n_rows * step
        if n_rows:
            padded = np.full(used + (k - 1), 4, np.uint8)
            avail = min(len(stream), used + (k - 1))
            padded[:avail] = stream[:avail]
            rows = np.lib.stride_tricks.as_strided(
                padded, (n_rows, chunk), (step, 1)
            )
            for b in range(0, n_rows, batch_rows):
                counter.update_batch(
                    np.ascontiguousarray(rows[b:b + batch_rows])
                )
        pending = stream[used:].copy() if not final else np.zeros(0, np.uint8)

    for data, offsets in read_blocks:
        data = np.asarray(data, np.uint8)
        codes = _ENCODE_LUT[data]
        parts = []
        for i in range(len(offsets) - 1):
            parts.append(codes[offsets[i]:offsets[i + 1]])
            parts.append(sep)
        if parts:
            emit(np.concatenate(parts), final=False)
    emit(np.zeros(0, np.uint8), final=True)
    return counter


def count_file_primed_sharded(
    read_file: str, k: int, keys: np.ndarray, mesh=None,
    shard=None, block_bases: int = 8 << 20, **kwargs
) -> "ExactKmerCounter":  # noqa: F821
    """File driver for the sharded counter: PRIME+UPDATE a read file
    against a hash-partitioned graph table over all local devices.
    Returns an ExactKmerCounter with the SAME key set (zero counts
    kept), so multi-host callers can allreduce the count vectors."""
    import jax

    from .counter import ExactKmerCounter, iter_sequences
    from ..parallel.distributed import shard_sequences

    if mesh is None:
        devs = jax.devices()
        mesh = jax.sharding.Mesh(np.array(devs), ("d",))

    def blocks():
        buf, total = [], 0
        for seq in shard_sequences(iter_sequences(read_file), shard):
            if len(seq) < k:
                continue
            buf.append(seq)
            total += len(seq)
            if total >= block_bases:
                data = np.frombuffer(b"".join(buf), np.uint8)
                offs = np.zeros(len(buf) + 1, np.int64)
                np.cumsum([len(s) for s in buf], out=offs[1:])
                yield data, offs
                buf, total = [], 0
        if buf:
            data = np.frombuffer(b"".join(buf), np.uint8)
            offs = np.zeros(len(buf) + 1, np.int64)
            np.cumsum([len(s) for s in buf], out=offs[1:])
            yield data, offs

    counter = count_stream_sharded(mesh, blocks(), k, keys, **kwargs)
    keys_out, counts = counter.to_host_arrays()
    return ExactKmerCounter(k, keys_out, counts)
