// Native k-mer engine: canonical 2-bit k-mer extraction + counting.
//
// Host-side replacement for the Jellyfish boundary of the reference
// (src/jellyfishcounter.cpp): the JAX framework keeps count tables as
// sorted (key, count) arrays (device-friendly layout); this module
// provides the CPU hot loops around that layout:
//
//   - extract_canonical: rolling 2-bit encode + canonical min(kmer, rc)
//     over every valid window of a sequence batch (the inner loop of
//     read streaming),
//   - count_sorted: sort + run-length-encode a kmer block,
//   - lookup_sorted: batched binary-search abundance queries,
//   - update_counts_sorted: PRIME+UPDATE accumulation into an existing
//     key set (graph-only counting mode).
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// base codes: A=0 C=1 G=2 T=3, everything else invalid (4)
inline void init_code_table(uint8_t* table) {
    memset(table, 4, 256);
    table['A'] = 0; table['a'] = 0;
    table['C'] = 1; table['c'] = 1;
    table['G'] = 2; table['g'] = 2;
    table['T'] = 3; table['t'] = 3;
}

inline uint64_t revcomp(uint64_t v, int k) {
    v = ~v;
    v = ((v >> 2) & 0x3333333333333333ULL) | ((v & 0x3333333333333333ULL) << 2);
    v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
    v = ((v >> 8) & 0x00FF00FF00FF00FFULL) | ((v & 0x00FF00FF00FF00FFULL) << 8);
    v = ((v >> 16) & 0x0000FFFF0000FFFFULL) | ((v & 0x0000FFFF0000FFFFULL) << 16);
    v = (v >> 32) | (v << 32);
    return v >> (64 - 2 * k);
}

}  // namespace

extern "C" {

// Extract canonical k-mers from a batch of sequences packed into one
// byte buffer. offsets has n_seqs+1 entries delimiting each sequence.
// Windows containing a non-ACGT base are skipped. Returns the number
// of kmers written to `out` (caller allocates total_len capacity).
int64_t pg_extract_canonical(
    const uint8_t* data, const int64_t* offsets, int64_t n_seqs, int k,
    uint64_t* out) {
    uint8_t code[256];
    init_code_table(code);
    const uint64_t mask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;
    int64_t n_out = 0;
    for (int64_t s = 0; s < n_seqs; ++s) {
        const uint8_t* seq = data + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;
        uint64_t fwd = 0;
        int valid = 0;  // number of consecutive valid bases in window
        for (int64_t i = 0; i < len; ++i) {
            const uint8_t c = code[seq[i]];
            if (c > 3) {
                valid = 0;
                fwd = 0;
                continue;
            }
            fwd = ((fwd << 2) | c) & mask;
            if (++valid >= k) {
                const uint64_t rc = revcomp(fwd, k);
                out[n_out++] = fwd < rc ? fwd : rc;
            }
        }
    }
    return n_out;
}

// Non-canonical variant (used for allele kmer enumeration parity).
int64_t pg_extract_forward(
    const uint8_t* data, const int64_t* offsets, int64_t n_seqs, int k,
    uint64_t* out) {
    uint8_t code[256];
    init_code_table(code);
    const uint64_t mask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;
    int64_t n_out = 0;
    for (int64_t s = 0; s < n_seqs; ++s) {
        const uint8_t* seq = data + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;
        uint64_t fwd = 0;
        int valid = 0;
        for (int64_t i = 0; i < len; ++i) {
            const uint8_t c = code[seq[i]];
            if (c > 3) {
                valid = 0;
                fwd = 0;
                continue;
            }
            fwd = ((fwd << 2) | c) & mask;
            if (++valid >= k) out[n_out++] = fwd;
        }
    }
    return n_out;
}

// In-place sort + run-length-encode. keys/counts are caller-allocated
// with capacity n. Returns the number of unique keys.
//
// Sort: LSD radix with 11-bit digits (2048 buckets stay cache-warm;
// passes with a constant digit are skipped — k=31 keys use 62 bits).
// Measured ~1.5x std::sort at graph-corpus sizes (60M kmers).
int64_t pg_count_sorted(uint64_t* kmers, int64_t n, uint64_t* keys,
                        int64_t* counts) {
    // MSD partition (one scatter pass over the data) + per-partition
    // std::sort in parallel: the old 6-pass LSD radix moved the whole
    // array 6 times and measured 5.7 s at a 24M-kmer graph corpus on
    // the throttled 2-core bench VM; partitions are L2-resident and
    // sort concurrently.
    if (n > (1 << 16)) {
        constexpr int BITS = 11;
        constexpr int NB = 1 << BITS;
        const int shift = 64 - BITS;  // top bits (uniform for kmers)
        std::vector<uint64_t> scratch(n);
        std::vector<int64_t> hist(NB + 1, 0);
        for (int64_t i = 0; i < n; ++i)
            ++hist[(kmers[i] >> shift) + 1];
        for (int b = 1; b <= NB; ++b) hist[b] += hist[b - 1];
        {
            std::vector<int64_t> pos(hist.begin(), hist.end() - 1);
            for (int64_t i = 0; i < n; ++i)
                scratch[pos[kmers[i] >> shift]++] = kmers[i];
        }
        unsigned hw = std::thread::hardware_concurrency();
        int n_threads = (int)std::min<unsigned>(hw ? hw : 2, 8);
        std::atomic<int> next_bucket{0};
        auto worker = [&]() {
            // per-bucket LSD radix on the remaining low bits: buckets
            // are L2-resident, so the passes are cache-hit streams
            // (std::sort's branchy introsort measured ~4x slower here)
            std::vector<uint64_t> tmp;
            int b;
            while ((b = next_bucket.fetch_add(1)) < NB) {
                const int64_t lo = hist[b], cnt = hist[b + 1] - hist[b];
                if (cnt <= 1) continue;
                if (cnt < 64) {
                    std::sort(scratch.data() + lo, scratch.data() + lo + cnt);
                    continue;
                }
                if ((int64_t)tmp.size() < cnt) tmp.resize(cnt);
                uint64_t* a = scratch.data() + lo;
                uint64_t* t2 = tmp.data();
                constexpr int LB = 11;
                constexpr int LNB = 1 << LB;
                for (int pass = 0; pass * LB < shift; ++pass) {
                    const int sh = pass * LB;
                    int32_t h[LNB + 1] = {0};
                    for (int64_t i = 0; i < cnt; ++i)
                        ++h[((a[i] >> sh) & (LNB - 1)) + 1];
                    if (h[1] == cnt) continue;  // constant digit
                    for (int d = 1; d <= LNB; ++d) h[d] += h[d - 1];
                    for (int64_t i = 0; i < cnt; ++i)
                        t2[h[(a[i] >> sh) & (LNB - 1)]++] = a[i];
                    std::swap(a, t2);
                }
                if (a != scratch.data() + lo)
                    memcpy(scratch.data() + lo, a, cnt * sizeof(uint64_t));
            }
        };
        std::vector<std::thread> threads;
        for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
        worker();
        for (auto& th : threads) th.join();
        memcpy(kmers, scratch.data(), n * sizeof(uint64_t));
    } else {
        std::sort(kmers, kmers + n);
    }
    int64_t m = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t j = i + 1;
        while (j < n && kmers[j] == kmers[i]) ++j;
        keys[m] = kmers[i];
        counts[m] = j - i;
        ++m;
        i = j;
    }
    return m;
}

// Batched abundance lookup: binary search each canonical query in the
// sorted key array; missing keys get 0.
void pg_lookup_sorted(const uint64_t* keys, const int64_t* counts,
                      int64_t n_keys, const uint64_t* queries,
                      int64_t n_queries, int64_t* out) {
    for (int64_t i = 0; i < n_queries; ++i) {
        const uint64_t q = queries[i];
        const uint64_t* it = std::lower_bound(keys, keys + n_keys, q);
        out[i] = (it != keys + n_keys && *it == q) ? counts[it - keys] : 0;
    }
}

// PRIME+UPDATE: add 1 to counts[] for every query found in keys[]
// (queries not in the key set are dropped — graph-only counting).
void pg_update_counts_sorted(const uint64_t* keys, int64_t* counts,
                             int64_t n_keys, const uint64_t* queries,
                             int64_t n_queries) {
    for (int64_t i = 0; i < n_queries; ++i) {
        const uint64_t q = queries[i];
        const uint64_t* it = std::lower_bound(keys, keys + n_keys, q);
        if (it != keys + n_keys && *it == q) ++counts[it - keys];
    }
}

// ---------------------------------------------------------------------------
// Open-addressing hash index over the key set (key -> slot in counts[]),
// built once per counter and reused across read blocks. Linear probing,
// splitmix64 finalizer, table sized to the next power of two >= 2n.
// ---------------------------------------------------------------------------

struct KmerHash {
    std::vector<uint64_t> keys;   // EMPTY sentinel = ~0
    std::vector<int64_t> slots;
    uint64_t mask;
    static constexpr uint64_t EMPTY = ~0ULL;

    static inline uint64_t mix(uint64_t x) {
        x += 0x9E3779B97F4A7C15ULL;
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
        x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
        return x ^ (x >> 31);
    }

    explicit KmerHash(const uint64_t* sorted_keys, int64_t n) {
        uint64_t size = 16;
        while (size < (uint64_t)(2 * n + 1)) size <<= 1;
        mask = size - 1;
        keys.assign(size, EMPTY);
        slots.assign(size, -1);
        constexpr int B = 16;  // prefetch-batched random inserts
        uint64_t hs[B];
        for (int64_t i = 0; i < n; i += B) {
            const int m = (int)std::min<int64_t>(B, n - i);
            for (int j = 0; j < m; ++j) {
                hs[j] = mix(sorted_keys[i + j]) & mask;
                __builtin_prefetch(&keys[hs[j]], 1, 1);
            }
            for (int j = 0; j < m; ++j) {
                uint64_t h = hs[j];
                while (keys[h] != EMPTY) h = (h + 1) & mask;
                keys[h] = sorted_keys[i + j];
                slots[h] = i + j;
            }
        }
    }

    inline int64_t find(uint64_t key) const {
        uint64_t h = mix(key) & mask;
        while (true) {
            const uint64_t k = keys[h];
            if (k == key) return slots[h];
            if (k == EMPTY) return -1;
            h = (h + 1) & mask;
        }
    }
};

extern "C" void* pg_hash_create(const uint64_t* sorted_keys, int64_t n) {
    return new KmerHash(sorted_keys, n);
}

extern "C" void pg_hash_destroy(void* handle) {
    delete static_cast<KmerHash*>(handle);
}

// Threaded batched abundance lookup via the hash index (canonical
// queries): ~2 probes per query instead of log2(n) binary-search
// cache misses — the unique-kmer selection issues ~200 queries per
// bubble against multi-10M-key tables.
// Canonicalizing variant: queries may be either strand; the
// canonical min(q, revcomp(q)) is computed per probe (a handful of
// bit ops next to a DRAM-latency probe — free), replacing a ~7-pass
// numpy canonicalization on the host.
extern "C" void pg_hash_lookup_canon(
    void* handle, const int64_t* counts, const uint64_t* queries,
    int64_t n_queries, int k, int64_t* out, int n_threads) {
    const KmerHash* hash = static_cast<KmerHash*>(handle);
    auto worker = [&](int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            const uint64_t q = queries[i];
            const uint64_t rc = revcomp(q, k);
            const int64_t slot = hash->find(q < rc ? q : rc);
            out[i] = slot >= 0 ? counts[slot] : 0;
        }
    };
    if (n_threads <= 1 || n_queries < (1 << 16)) {
        worker(0, n_queries);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_queries + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_queries, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

extern "C" void pg_hash_lookup(
    void* handle, const int64_t* counts, const uint64_t* queries,
    int64_t n_queries, int64_t* out, int n_threads) {
    const KmerHash* hash = static_cast<KmerHash*>(handle);
    auto worker = [&](int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            const int64_t slot = hash->find(queries[i]);
            out[i] = slot >= 0 ? counts[slot] : 0;
        }
    };
    if (n_threads <= 1 || n_queries < (1 << 16)) {
        worker(0, n_queries);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_queries + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_queries, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// Threaded fused extract + PRIME/UPDATE accumulation via the hash
// index. Threads split the sequence batch; counts are updated with
// atomic adds (contention is negligible: different kmers hash apart).
extern "C" void pg_hash_stream_update(
    void* handle, const uint8_t* data, const int64_t* offsets,
    int64_t n_seqs, int k, int64_t* counts, int n_threads) {
    const KmerHash* hash = static_cast<KmerHash*>(handle);
    uint8_t code[256];
    init_code_table(code);
    const uint64_t kmask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;

    auto worker = [&](int64_t s_begin, int64_t s_end) {
        for (int64_t s = s_begin; s < s_end; ++s) {
            const uint8_t* seq = data + offsets[s];
            const int64_t len = offsets[s + 1] - offsets[s];
            if (len < k) continue;
            uint64_t fwd = 0;
            int valid = 0;
            for (int64_t i = 0; i < len; ++i) {
                const uint8_t c = code[seq[i]];
                if (c > 3) {
                    valid = 0;
                    fwd = 0;
                    continue;
                }
                fwd = ((fwd << 2) | c) & kmask;
                if (++valid >= k) {
                    const uint64_t rc = revcomp(fwd, k);
                    const int64_t slot = hash->find(fwd < rc ? fwd : rc);
                    if (slot >= 0)
                        __atomic_fetch_add(&counts[slot], 1,
                                           __ATOMIC_RELAXED);
                }
            }
        }
    };

    if (n_threads <= 1 || n_seqs < 64) {
        worker(0, n_seqs);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_seqs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_seqs, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// Fused PRIME+UPDATE streaming: extract canonical k-mers from the
// sequence batch and accumulate counts for table hits in one pass —
// no intermediate k-mer array (the read-streaming hot loop).
void pg_stream_update_counts(
    const uint8_t* data, const int64_t* offsets, int64_t n_seqs, int k,
    const uint64_t* keys, int64_t* counts, int64_t n_keys) {
    uint8_t code[256];
    init_code_table(code);
    const uint64_t mask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;
    for (int64_t s = 0; s < n_seqs; ++s) {
        const uint8_t* seq = data + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;
        uint64_t fwd = 0;
        int valid = 0;
        for (int64_t i = 0; i < len; ++i) {
            const uint8_t c = code[seq[i]];
            if (c > 3) {
                valid = 0;
                fwd = 0;
                continue;
            }
            fwd = ((fwd << 2) | c) & mask;
            if (++valid >= k) {
                const uint64_t rc = revcomp(fwd, k);
                const uint64_t canon = fwd < rc ? fwd : rc;
                const uint64_t* it =
                    std::lower_bound(keys, keys + n_keys, canon);
                if (it != keys + n_keys && *it == canon)
                    ++counts[it - keys];
            }
        }
    }
}

// Parse one FASTA text chunk into concatenated sequence bytes +
// cumulative per-sequence offsets. The chunk must start at a record
// boundary ('>') and end at one (caller splits blocks on "\n>").
// Newlines and '\r' are stripped; bases are passed through verbatim
// (the code table downstream handles case and invalid characters).
// data must hold n bytes, offsets one entry per '>' plus one.
// Returns the number of sequences parsed.
int64_t pg_parse_fasta_chunk(const uint8_t* text, int64_t n,
                             uint8_t* data, int64_t* offsets) {
    int64_t n_seqs = 0, dpos = 0, i = 0;
    bool open = false;
    offsets[0] = 0;
    while (i < n) {
        if (text[i] == '>') {
            if (open) offsets[++n_seqs] = dpos;
            while (i < n && text[i] != '\n') ++i;
            ++i;
            open = true;
            continue;
        }
        int64_t line_start = i;
        while (i < n && text[i] != '\n') ++i;
        int64_t line_end = i;
        if (line_end > line_start && text[line_end - 1] == '\r') --line_end;
        memcpy(data + dpos, text + line_start, line_end - line_start);
        dpos += line_end - line_start;
        ++i;
    }
    if (open) offsets[++n_seqs] = dpos;
    return n_seqs;
}

// pg_hash_stream_update restricted to sequences with
// (base + s) % shard_n == shard_i — the multi-host read partition
// applied inside the native loop (no per-read Python filtering).
extern "C" void pg_hash_stream_update_sharded(
    void* handle, const uint8_t* data, const int64_t* offsets,
    int64_t n_seqs, int k, int64_t* counts, int n_threads,
    int64_t shard_i, int64_t shard_n, int64_t base) {
    const KmerHash* hash = static_cast<KmerHash*>(handle);
    uint8_t code[256];
    init_code_table(code);
    const uint64_t kmask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;

    auto worker = [&](int64_t s_begin, int64_t s_end) {
        for (int64_t s = s_begin; s < s_end; ++s) {
            if (shard_n > 1 && ((base + s) % shard_n) != shard_i) continue;
            const uint8_t* seq = data + offsets[s];
            const int64_t len = offsets[s + 1] - offsets[s];
            if (len < k) continue;
            uint64_t fwd = 0;
            int valid = 0;
            for (int64_t i = 0; i < len; ++i) {
                const uint8_t c = code[seq[i]];
                if (c > 3) {
                    valid = 0;
                    fwd = 0;
                    continue;
                }
                fwd = ((fwd << 2) | c) & kmask;
                if (++valid >= k) {
                    const uint64_t rc = revcomp(fwd, k);
                    const int64_t slot = hash->find(fwd < rc ? fwd : rc);
                    if (slot >= 0)
                        __atomic_fetch_add(&counts[slot], 1,
                                           __ATOMIC_RELAXED);
                }
            }
        }
    };

    if (n_threads <= 1 || n_seqs < 64) {
        worker(0, n_seqs);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_seqs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_seqs, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// Translate raw sequence bytes to base codes (A/a=0 .. T/t=3, else 4).
void pg_encode_bases(const uint8_t* text, int64_t n, uint8_t* codes) {
    uint8_t code[256];
    init_code_table(code);
    for (int64_t i = 0; i < n; ++i) codes[i] = code[text[i]];
}

// Pack [n_rows, L] base codes (0-3 valid, anything else invalid) into
// 2-bit words (16 codes / uint32) plus a 1-bit validity mask
// (32 codes / uint32) — the compact host->device transfer format.
// words must hold n_rows * ceil(L/16), vwords n_rows * ceil(L/32).
void pg_pack_2bit(const uint8_t* codes, int64_t n_rows, int64_t L,
                  uint32_t* words, uint32_t* vwords, int n_threads) {
    const int64_t W16 = (L + 15) / 16;
    const int64_t W32 = (L + 31) / 32;
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t row_lo, int64_t row_hi) {
        for (int64_t r = row_lo; r < row_hi; ++r) {
            const uint8_t* row = codes + r * L;
            uint32_t* w = words + r * W16;
            uint32_t* v = vwords + r * W32;
            memset(w, 0, W16 * sizeof(uint32_t));
            memset(v, 0, W32 * sizeof(uint32_t));
            for (int64_t i = 0; i < L; ++i) {
                const uint8_t c = row[i];
                if (c <= 3) {
                    w[i >> 4] |= uint32_t(c) << (2 * (i & 15));
                    v[i >> 5] |= 1u << (i & 31);
                }
            }
        }
    };
    if (n_threads == 1 || n_rows < 1024) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Pack variable-length rows straight from the raw sequence byte
// buffer (ASCII bases) into the 2-bit + validity-bit device transfer
// format, encoding inline — replaces the numpy window-gather +
// separate-encode pipeline that dominated host time when streaming
// reads to the device counter. Rows shorter than L get an invalid
// (mask 0) tail.
void pg_pack_rows(const uint8_t* text, const int64_t* starts,
                  const int64_t* lens, int64_t n_rows, int64_t L,
                  uint32_t* words, uint32_t* vwords, int n_threads) {
    uint8_t code[256];
    init_code_table(code);
    const int64_t W16 = (L + 15) / 16;
    const int64_t W32 = (L + 31) / 32;
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t row_lo, int64_t row_hi) {
        for (int64_t r = row_lo; r < row_hi; ++r) {
            const uint8_t* row = text + starts[r];
            const int64_t len = std::min(lens[r], L);
            uint32_t* w = words + r * W16;
            uint32_t* v = vwords + r * W32;
            memset(w, 0, W16 * sizeof(uint32_t));
            memset(v, 0, W32 * sizeof(uint32_t));
            for (int64_t i = 0; i < len; ++i) {
                const uint8_t c = code[row[i]];
                if (c <= 3) {
                    w[i >> 4] |= uint32_t(c) << (2 * (i & 15));
                    v[i >> 5] |= 1u << (i & 31);
                }
            }
        }
    };
    if (n_threads == 1 || n_rows < 1024) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Parse one VCF record's genotype region (tab-separated phased
// diploid GT fields, "a|b[:...]"): writes 2 path allele ids per
// sample. '.' haplotypes become sequential undefined allele ids
// starting at n_base_alleles (the caller appends that many "N"
// alleles). Returns the number of undefined haplotypes, or a negative
// error: -1 unphased ('/'), -2 not diploid, -3 invalid genotype id,
// -4 sample-count mismatch (caller falls back to its own parser).
int64_t pg_parse_gt(const uint8_t* text, int64_t len,
                    int64_t n_base_alleles, int64_t n_samples,
                    int32_t* paths_out) {
    int64_t n_undef = 0;
    int64_t sample = 0;
    int64_t i = 0;
    while (i <= len) {
        // token [i, j)
        int64_t j = i;
        while (j < len && text[j] != '\t') ++j;
        if (j > i || i < len) {
            if (sample >= n_samples) return -4;
            // scan token: find first '|', reject '/', reject 2nd '|'
            int64_t bar = -1;
            for (int64_t p = i; p < j; ++p) {
                const uint8_t c = text[p];
                if (c == '/') return -1;
                if (c == '|') {
                    if (bar >= 0) return -2;
                    bar = p;
                }
            }
            if (bar < 0) return -2;
            const int64_t halves[4] = {i, bar, bar + 1, j};
            for (int h = 0; h < 2; ++h) {
                const int64_t lo = halves[2 * h], hi = halves[2 * h + 1];
                if (hi - lo == 1 && text[lo] == '.') {
                    paths_out[2 * sample + h] =
                        (int32_t)(n_base_alleles + n_undef);
                    ++n_undef;
                    continue;
                }
                // C atoi: optional sign + leading digits, 0 otherwise
                int64_t p = lo;
                while (p < hi && (text[p] == ' ' || text[p] == '\t')) ++p;
                int64_t sign = 1;
                if (p < hi && (text[p] == '+' || text[p] == '-')) {
                    if (text[p] == '-') sign = -1;
                    ++p;
                }
                int64_t v = 0;
                while (p < hi && text[p] >= '0' && text[p] <= '9') {
                    v = v * 10 + (text[p] - '0');
                    ++p;
                }
                v *= sign;
                if (v >= n_base_alleles + n_undef || v < 0) return -3;
                paths_out[2 * sample + h] = (int32_t)v;
            }
            ++sample;
        }
        if (j >= len) break;
        i = j + 1;
    }
    if (sample != n_samples) return -4;
    return n_undef;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused {key, count} streaming table: PRIME+UPDATE counting with ONE
// random cache-line touch per window. The older KmerHash keeps keys[],
// slots[] and the caller's counts[] in three separate arrays — three
// DRAM misses per counted window (~200+ ns measured at 24M-key
// tables); interleaving the count next to the key and prefetching
// probes in batches of 16 hides most of the latency. The table serves
// streaming accumulation only; shared lookups keep using KmerHash.
// ---------------------------------------------------------------------------

namespace {

struct KmerCountTable {
    struct Entry {
        uint64_t key;
        int64_t cnt;
    };
    std::vector<Entry> tab;
    uint64_t mask;
    static constexpr uint64_t EMPTY = ~0ULL;

    static inline uint64_t mix(uint64_t x) {
        x += 0x9E3779B97F4A7C15ULL;
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
        x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
        return x ^ (x >> 31);
    }

    explicit KmerCountTable(const uint64_t* sorted_keys, int64_t n) {
        uint64_t size = 16;
        while (size < (uint64_t)(2 * n + 1)) size <<= 1;
        mask = size - 1;
        tab.assign(size, Entry{EMPTY, 0});
        // prefetch-batched build: the 2n random insert probes are
        // DRAM-latency-bound exactly like the streaming loop
        constexpr int B = 16;
        uint64_t hs[B];
        for (int64_t i = 0; i < n; i += B) {
            const int m = (int)std::min<int64_t>(B, n - i);
            for (int j = 0; j < m; ++j) {
                hs[j] = mix(sorted_keys[i + j]) & mask;
                __builtin_prefetch(&tab[hs[j]], 1, 1);
            }
            for (int j = 0; j < m; ++j) {
                uint64_t h = hs[j];
                while (tab[h].key != EMPTY) h = (h + 1) & mask;
                tab[h].key = sorted_keys[i + j];
            }
        }
    }
};

}  // namespace

extern "C" {

void* pg_kc_create(const uint64_t* sorted_keys, int64_t n) {
    return new KmerCountTable(sorted_keys, n);
}

void pg_kc_destroy(void* handle) {
    delete static_cast<KmerCountTable*>(handle);
}

// Threaded fused extract + count with batched prefetch; sequences with
// (base + s) % shard_n != shard_i are skipped (shard_n <= 1 disables).
void pg_kc_stream_update(
    void* handle, const uint8_t* data, const int64_t* offsets,
    int64_t n_seqs, int k, int n_threads,
    int64_t shard_i, int64_t shard_n, int64_t base) {
    KmerCountTable* kc = static_cast<KmerCountTable*>(handle);
    auto* tab = kc->tab.data();
    const uint64_t mask = kc->mask;
    uint8_t code[256];
    init_code_table(code);
    const uint64_t kmask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;
    constexpr int B = 16;

    const int rc_shift = 2 * (k - 1);
    auto worker = [&](int64_t s_begin, int64_t s_end) {
        // double-buffered software pipeline: the probes of batch N run
        // only after batch N+1's windows were EXTRACTED (extraction
        // time >> DRAM latency), so the prefetches issued when a batch
        // fills have landed by the time it is probed. The prior
        // prefetch-then-probe-immediately loop left the first ~half of
        // each batch's probes exposed to full DRAM latency.
        constexpr int PB = 32;
        uint64_t bufA[PB], bufB[PB], hsA[PB], hsB[PB];
        uint64_t* cur = bufA;
        uint64_t* curh = hsA;
        uint64_t* prev = bufB;
        uint64_t* prevh = hsB;
        int np = 0, prev_np = 0;
        auto probe = [&](const uint64_t* keys, const uint64_t* hh, int m) {
            for (int j = 0; j < m; ++j) {
                uint64_t h = hh[j];
                const uint64_t key = keys[j];
                while (true) {
                    const uint64_t k0 = tab[h].key;
                    if (k0 == key) {
                        __atomic_fetch_add(&tab[h].cnt, 1,
                                           __ATOMIC_RELAXED);
                        break;
                    }
                    if (k0 == KmerCountTable::EMPTY) break;
                    h = (h + 1) & mask;
                }
            }
        };
        auto rotate = [&]() {
            for (int j = 0; j < np; ++j) {
                curh[j] = KmerCountTable::mix(cur[j]) & mask;
                __builtin_prefetch(&tab[curh[j]], 1, 1);
            }
            probe(prev, prevh, prev_np);
            std::swap(cur, prev);
            std::swap(curh, prevh);
            prev_np = np;
            np = 0;
        };
        for (int64_t s = s_begin; s < s_end; ++s) {
            if (shard_n > 1 && ((base + s) % shard_n) != shard_i)
                continue;
            const uint8_t* seq = data + offsets[s];
            const int64_t len = offsets[s + 1] - offsets[s];
            if (len < k) continue;
            uint64_t fwd = 0;
            uint64_t rc = 0;  // incremental reverse complement
            int valid = 0;
            for (int64_t i = 0; i < len; ++i) {
                const uint8_t c = code[seq[i]];
                if (c > 3) {
                    valid = 0;
                    fwd = 0;
                    rc = 0;
                    continue;
                }
                fwd = ((fwd << 2) | c) & kmask;
                rc = (rc >> 2) | ((uint64_t)(3 - c) << rc_shift);
                if (++valid >= k) {
                    cur[np++] = fwd < rc ? fwd : rc;
                    if (np == PB) rotate();
                }
            }
        }
        rotate();
        probe(prev, prevh, prev_np);
    };

    if (n_threads <= 1 || n_seqs < 64) {
        worker(0, n_seqs);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_seqs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_seqs, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// Reference unique_kmers() enumeration over a segment batch
// (src/uniquekmercomputer.cpp:9-32 semantics): NON-canonical kmers,
// invalid bases packed as code 3, body windows emitted only when
// N-free, the FINAL window emitted unconditionally (sequences shorter
// than k roll into one final window with implicit leading zeros).
// out_kmers/out_segs must hold total_data_len + n_seqs entries.
int64_t pg_extract_segment_kmers(
    const uint8_t* data, const int64_t* offsets, int64_t n_seqs, int k,
    uint64_t* out_kmers, int32_t* out_segs) {
    uint8_t code[256];
    init_code_table(code);
    const uint64_t mask =
        (k < 32) ? ((1ULL << (2 * k)) - 1ULL) : ~0ULL;
    int64_t n_out = 0;
    for (int64_t s = 0; s < n_seqs; ++s) {
        const uint8_t* seq = data + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        uint64_t fwd = 0;
        int valid = 0;
        if (len < k) {
            for (int64_t i = 0; i < len; ++i) {
                uint8_t c = code[seq[i]];
                if (c > 3) c = 3;
                fwd = ((fwd << 2) | c) & mask;
            }
            out_kmers[n_out] = fwd;
            out_segs[n_out++] = (int32_t)s;
            continue;
        }
        for (int64_t i = 0; i < len; ++i) {
            uint8_t c = code[seq[i]];
            if (c > 3) {
                c = 3;
                valid = 0;
            } else {
                ++valid;
            }
            fwd = ((fwd << 2) | c) & mask;
            if (i >= k - 1 && (valid >= k || i == len - 1)) {
                out_kmers[n_out] = fwd;
                out_segs[n_out++] = (int32_t)s;
            }
        }
    }
    return n_out;
}

// In-place ascending sort of values within each
// [offsets[s], offsets[s+1]) segment — the unique-kmer selection's
// sort pattern (segment ids are already non-decreasing, so a global
// lexsort is per-segment work in disguise; thousands of tiny
// cache-local sorts run ~10x faster than one 16M-element lexsort).
void pg_sort_segments(uint64_t* values, const int64_t* offsets,
                      int64_t n_segs, int n_threads) {
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t s = lo; s < hi; ++s)
            std::sort(values + offsets[s], values + offsets[s + 1]);
    };
    if (n_threads <= 1 || n_segs < 256) {
        worker(0, n_segs);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_segs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_segs, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// STABLE in-place co-sort of (key, payload) pairs by key within each
// segment (ties keep their original relative order — matching
// np.lexsort semantics the selection pipeline's later stages rely on).
void pg_kv_sort_segments(int64_t* keys, uint64_t* payload,
                         const int64_t* offsets, int64_t n_segs,
                         int n_threads) {
    auto worker = [&](int64_t lo, int64_t hi) {
        std::vector<std::pair<int64_t, uint64_t>> buf;
        for (int64_t s = lo; s < hi; ++s) {
            const int64_t b = offsets[s], e = offsets[s + 1];
            const int64_t n = e - b;
            if (n <= 1) continue;
            buf.resize(n);
            for (int64_t i = 0; i < n; ++i)
                buf[i] = {keys[b + i], payload[b + i]};
            std::stable_sort(
                buf.begin(), buf.end(),
                [](const auto& x, const auto& y) {
                    return x.first < y.first;
                });
            for (int64_t i = 0; i < n; ++i) {
                keys[b + i] = buf[i].first;
                payload[b + i] = buf[i].second;
            }
        }
    };
    if (n_threads <= 1 || n_segs < 256) {
        worker(0, n_segs);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_segs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n_segs, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

// out[i] = accumulated count of sorted_keys[i] (prefetch-batched).
void pg_kc_export(void* handle, const uint64_t* sorted_keys, int64_t n,
                  int64_t* out, int n_threads) {
    const KmerCountTable* kc = static_cast<KmerCountTable*>(handle);
    const auto* tab = kc->tab.data();
    const uint64_t mask = kc->mask;
    constexpr int B = 16;
    auto worker = [&](int64_t lo, int64_t hi) {
        uint64_t hs[B];
        for (int64_t i = lo; i < hi; i += B) {
            const int m = (int)std::min<int64_t>(B, hi - i);
            for (int j = 0; j < m; ++j) {
                hs[j] = KmerCountTable::mix(sorted_keys[i + j]) & mask;
                __builtin_prefetch(&tab[hs[j]], 0, 1);
            }
            for (int j = 0; j < m; ++j) {
                uint64_t h = hs[j];
                const uint64_t key = sorted_keys[i + j];
                int64_t cnt = 0;
                while (true) {
                    const uint64_t k0 = tab[h].key;
                    if (k0 == key) {
                        cnt = tab[h].cnt;
                        break;
                    }
                    if (k0 == KmerCountTable::EMPTY) break;
                    h = (h + 1) & mask;
                }
                out[i + j] = cnt;
            }
        }
    };
    if (n_threads <= 1 || n < (1 << 18)) {
        worker(0, n);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n, b + chunk);
        if (b >= e) break;
        threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native VCF body tokenizer: the happy path of PanelBuilder's per-line
// loop (reference src/graphbuilder.cpp:55-279) over a raw byte chunk.
// Python owns the header, error reporting, and graph assembly; this
// scanner owns tokenization, REF-vs-FASTA validation, ALT filtering,
// GT parsing, the covered/uncovered allele scan and the cluster-break
// decision. ANY anomaly (would-be exception, unparseable field) makes
// the call "bail": Python re-parses the whole file with its exact
// reference-faithful error semantics. Bail is therefore allowed to be
// slow but must never be WRONG about the happy path.

extern "C" {

// Returns n_accepted >= 0 on success, -1 on bail (Python must
// re-parse; *bail_off = byte offset of the offending line), -2 when
// uncov_flat overflowed uncov_cap (retry with a bigger buffer).
int64_t pg_parse_vcf_chunk(
    const uint8_t* buf, int64_t len,
    int64_t n_samples, int64_t k, int add_reference,
    int32_t n_chroms,
    const uint8_t* const* chrom_seqs, const int64_t* chrom_sizes,
    const uint8_t* names_blob, const int64_t* name_offs,
    int32_t prev_chrom_in, int64_t prev_end_in,
    int32_t* out_chrom, int64_t* out_start, int64_t* out_end,
    int64_t* out_alt_off, int32_t* out_alt_len,
    int64_t* out_id_off, int32_t* out_id_len,
    int32_t* out_nundef, uint8_t* out_newcluster,
    uint16_t* out_paths,
    int32_t* out_nuncov, int32_t* uncov_flat, int64_t uncov_cap,
    int32_t* final_chrom, int64_t* final_end, int64_t* bail_off) {
    uint8_t upper[256];
    for (int i = 0; i < 256; ++i)
        upper[i] = (i >= 'a' && i <= 'z') ? (uint8_t)(i - 32) : (uint8_t)i;
    // per-record covered-allele stamps (allele ids are < 65536)
    std::vector<int32_t> stamp(65536, -1);

    int32_t prev_chrom = prev_chrom_in;
    int64_t prev_end = prev_end_in;
    int64_t n_acc = 0;
    int64_t uncov_pos = 0;
    const int64_t n_paths_total = 2 * n_samples + (add_reference ? 1 : 0);
    if (n_paths_total > 65535) { *bail_off = 0; return -1; }

    int64_t line = 0;
    while (line < len) {
        int64_t eol = line;
        while (eol < len && buf[eol] != '\n') ++eol;
        const int64_t lbeg = line, lend = eol;  // [lbeg, lend)
        line = eol + 1;
        if (lend == lbeg) continue;             // empty line
        if (buf[lbeg] == '#') { *bail_off = lbeg; return -1; }

        // tokenize fields 0..8 by tab; field 9 = GT region to EOL
        int64_t f[10];                          // start offsets
        f[0] = lbeg;
        int nf = 1;
        for (int64_t p = lbeg; p < lend && nf < 10; ++p)
            if (buf[p] == '\t') f[nf++] = p + 1;
        if (nf < 10) { *bail_off = lbeg; return -1; }
        const int64_t chrom_b = f[0], chrom_e = f[1] - 1;
        const int64_t pos_b = f[1], pos_e = f[2] - 1;
        const int64_t ref_b = f[3], ref_e = f[4] - 1;
        const int64_t alt_b = f[4], alt_e = f[5] - 1;
        const int64_t info_b = f[7], info_e = f[8] - 1;
        const int64_t gt_b = f[9];

        // chromosome lookup (cached: data is chromosome-grouped)
        int32_t ci = -1;
        const int64_t clen = chrom_e - chrom_b;
        if (prev_chrom >= 0 &&
            name_offs[prev_chrom + 1] - name_offs[prev_chrom] == clen &&
            memcmp(names_blob + name_offs[prev_chrom], buf + chrom_b,
                   (size_t)clen) == 0) {
            ci = prev_chrom;
        } else {
            for (int32_t c = 0; c < n_chroms; ++c) {
                if (name_offs[c + 1] - name_offs[c] == clen &&
                    memcmp(names_blob + name_offs[c], buf + chrom_b,
                           (size_t)clen) == 0) { ci = c; break; }
            }
            if (ci < 0) { *bail_off = lbeg; return -1; }  // not in FASTA
        }

        // POS: strictly digits (anything fancier -> Python semantics)
        if (pos_e <= pos_b) { *bail_off = lbeg; return -1; }
        int64_t pos = 0;
        for (int64_t p = pos_b; p < pos_e; ++p) {
            if (buf[p] < '0' || buf[p] > '9') { *bail_off = lbeg; return -1; }
            pos = pos * 10 + (buf[p] - '0');
            if (pos > (int64_t)1 << 60) { *bail_off = lbeg; return -1; }
        }
        const int64_t start = pos - 1;
        // overlap with the previous accepted record => reference error
        if (ci == prev_chrom && start < prev_end) { *bail_off = lbeg; return -1; }

        // REF must match the FASTA (case-insensitively; FASTA is upper)
        const int64_t ref_len = ref_e - ref_b;
        const int64_t end = start + ref_len;
        if (ref_len <= 0 || start < 0 || end > chrom_sizes[ci]) {
            *bail_off = lbeg; return -1;
        }
        const uint8_t* cseq = chrom_seqs[ci];
        bool ref_ok = true;
        for (int64_t p = 0; p < ref_len; ++p)
            if (upper[buf[ref_b + p]] != cseq[start + p]) { ref_ok = false; break; }
        if (!ref_ok) { *bail_off = lbeg; return -1; }

        // ALT: ^[CAGTcagt,]+$ else the record is SKIPPED (not an error)
        bool alt_ok = alt_e > alt_b;
        int64_t n_alts = 1;
        for (int64_t p = alt_b; p < alt_e && alt_ok; ++p) {
            const uint8_t c = buf[p];
            if (c == ',') { ++n_alts; continue; }
            const uint8_t u = upper[c];
            if (u != 'A' && u != 'C' && u != 'G' && u != 'T') alt_ok = false;
        }
        if (!alt_ok) continue;
        const int64_t n_alleles = 1 + n_alts;
        if (n_alleles > 65535) { *bail_off = lbeg; return -1; }

        // too close to the chromosome ends => skip
        if (start < 2 * k || end + 2 * k > chrom_sizes[ci]) continue;

        // INFO ID= value region (first occurrence)
        int64_t id_off = -1, id_len = -1;
        for (int64_t p = info_b; p < info_e;) {
            int64_t q = p;
            while (q < info_e && buf[q] != ';') ++q;
            if (q - p >= 3 && buf[p] == 'I' && buf[p + 1] == 'D' &&
                buf[p + 2] == '=') { id_off = p + 3; id_len = q - (p + 3); break; }
            p = q + 1;
        }

        // GT region: phased diploid tokens; '.' haplotypes extend the
        // allele set (same semantics as pg_parse_gt above)
        uint16_t* prow = out_paths + n_acc * 2 * n_samples;
        int64_t n_undef = 0, sample = 0;
        {
            int64_t i = gt_b;
            const int64_t glen = lend;
            while (i <= glen) {
                int64_t j = i;
                while (j < glen && buf[j] != '\t') ++j;
                if (j > i || i < glen) {
                    if (sample >= n_samples) { *bail_off = lbeg; return -1; }
                    int64_t bar = -1;
                    for (int64_t p = i; p < j; ++p) {
                        const uint8_t c = buf[p];
                        if (c == '/') { *bail_off = lbeg; return -1; }
                        if (c == '|') {
                            if (bar >= 0) { *bail_off = lbeg; return -1; }
                            bar = p;
                        }
                    }
                    if (bar < 0) { *bail_off = lbeg; return -1; }
                    const int64_t halves[4] = {i, bar, bar + 1, j};
                    for (int h = 0; h < 2; ++h) {
                        const int64_t lo = halves[2 * h], hi = halves[2 * h + 1];
                        if (hi - lo == 1 && buf[lo] == '.') {
                            const int64_t v = n_alleles + n_undef;
                            if (v > 65534) { *bail_off = lbeg; return -1; }
                            prow[2 * sample + h] = (uint16_t)v;
                            ++n_undef;
                            continue;
                        }
                        int64_t p = lo;
                        while (p < hi && (buf[p] == ' ')) ++p;
                        int64_t sign = 1;
                        if (p < hi && (buf[p] == '+' || buf[p] == '-')) {
                            if (buf[p] == '-') sign = -1;
                            ++p;
                        }
                        int64_t v = 0;
                        while (p < hi && buf[p] >= '0' && buf[p] <= '9') {
                            v = v * 10 + (buf[p] - '0');
                            if (v > 1 << 20) { *bail_off = lbeg; return -1; }
                        ++p;
                        }
                        v *= sign;
                        if (v >= n_alleles + n_undef || v < 0) {
                            *bail_off = lbeg; return -1;
                        }
                        prow[2 * sample + h] = (uint16_t)v;
                    }
                    ++sample;
                }
                if (j >= glen) break;
                i = j + 1;
            }
            if (sample != n_samples) { *bail_off = lbeg; return -1; }
        }

        // covered/uncovered scan over the full (incl. undefined) set
        const int32_t rec = (int32_t)n_acc;
        if (add_reference) stamp[0] = rec;
        for (int64_t s = 0; s < 2 * n_samples; ++s) stamp[prow[s]] = rec;
        int32_t n_uncov = 0;
        for (int64_t a = 0; a < n_alleles + n_undef; ++a) {
            if (stamp[a] != rec) {
                if (uncov_pos >= uncov_cap) return -2;
                uncov_flat[uncov_pos++] = (int32_t)a;
                ++n_uncov;
            }
        }

        out_chrom[n_acc] = ci;
        out_start[n_acc] = start;
        out_end[n_acc] = end;
        out_alt_off[n_acc] = alt_b;
        out_alt_len[n_acc] = (int32_t)(alt_e - alt_b);
        out_id_off[n_acc] = id_off;
        out_id_len[n_acc] = (int32_t)id_len;
        out_nundef[n_acc] = (int32_t)n_undef;
        out_newcluster[n_acc] =
            (ci != prev_chrom || (start - prev_end) >= k - 1) ? 1 : 0;
        out_nuncov[n_acc] = n_uncov;
        ++n_acc;
        prev_chrom = ci;
        prev_end = end;
    }
    *final_chrom = prev_chrom;
    *final_end = prev_end;
    return n_acc;
}

}  // extern "C"
