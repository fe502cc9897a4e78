// Native corpus ingestion: unique-word deduplication in one hash pass.
//
// C++ replacement for the numpy dedup in ops/ingest.py (make_stream and
// StreamAccumulator): where numpy buckets words by length and sorts each
// bucket (O(N log N) with several full-array permutations per chunk),
// this runs ONE open-addressing hash pass per chunk and sorts only the
// unique entries once at the end. Output is BITWISE-identical to the
// numpy path: unique words ordered by (length asc, bytes asc), symbols
// carry the word-start bit on the first byte, weights repeat the exact
// corpus count per position.
//
// Fills the reference's data-loading role (file-manager.js + the worker
// ingest boundary) as real native runtime code rather than a Python shim.
//
// C ABI (ctypes, see ops/native.py) — accumulator handle API:
//   void*   ingest_acc_new();
//   int64_t ingest_acc_add(void* h, const uint8_t* data,
//                          const uint8_t* starts, int64_t n);
//       word bytes are COPIED into an internal arena (chunk buffers may
//       be freed between calls); returns 0 ok, -3 allocation failure.
//   int64_t ingest_acc_unique_bytes(void* h);   // exact out_cap to pass
//   int64_t ingest_acc_finish(void* h, uint32_t ws_bit,
//                             uint32_t* out_syms, int32_t* out_wts,
//                             int64_t out_cap, int64_t* out_n);
//       returns 0 ok; -1 out_cap too small; -2 count overflows int32.
//       Does not free the handle (callable once; table left sorted).
//   void    ingest_acc_free(void* h);
//
// One-shot convenience (make_stream's monolithic path):
//   int64_t ingest_dedup(data, starts, n, ws_bit, out_syms, out_wts,
//                        out_cap, out_n);  // same return codes

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <new>
#include <vector>

namespace {

struct Entry {
    uint64_t hash;       // 0 = empty slot (hashes are forced non-zero)
    int64_t count;
    uint64_t arena_off;  // word bytes live in the arena (chunk-lifetime safe)
    uint32_t len;
};

// fast 64-bit mix over the word bytes (wyhash-style folding; quality only
// affects probe lengths, never correctness — matches are byte-compared)
inline uint64_t mix(uint64_t a, uint64_t b) {
    __uint128_t m = (__uint128_t)(a ^ 0x9e3779b97f4a7c15ull) *
                    (b ^ 0xbf58476d1ce4e5b9ull);
    return (uint64_t)m ^ (uint64_t)(m >> 64);
}

inline uint64_t hash_bytes(const uint8_t* p, uint32_t len) {
    uint64_t h = 0x243f6a8885a308d3ull ^ len;
    uint32_t i = 0;
    while (i + 8 <= len) {
        uint64_t w;
        std::memcpy(&w, p + i, 8);
        h = mix(h, w);
        i += 8;
    }
    if (i < len) {
        uint64_t w = 0;
        std::memcpy(&w, p + i, len - i);
        h = mix(h, w);
    }
    return h | 1;  // never 0 (0 marks an empty slot)
}

struct Acc {
    std::vector<Entry> slots;
    std::vector<uint8_t> arena;
    uint64_t mask = 0;
    size_t used = 0;
    uint64_t unique_bytes = 0;

    Acc() {
        slots.assign(1 << 16, Entry{0, 0, 0, 0});
        mask = (1 << 16) - 1;
    }

    void grow() {
        std::vector<Entry> old;
        old.swap(slots);
        uint64_t new_cap = (mask + 1) * 2;
        slots.assign(new_cap, Entry{0, 0, 0, 0});
        mask = new_cap - 1;
        for (const Entry& e : old) {
            if (!e.hash) continue;
            uint64_t i = e.hash & mask;
            while (slots[i].hash) i = (i + 1) & mask;
            slots[i] = e;
        }
    }

    void add(const uint8_t* data, const uint8_t* starts, int64_t n) {
        int64_t word_start = 0;  // position 0 always starts a word (rule 1)
        for (int64_t pos = 1; pos <= n; ++pos) {
            if (pos < n && !starts[pos]) continue;
            uint32_t len = (uint32_t)(pos - word_start);
            const uint8_t* w = data + word_start;
            uint64_t h = hash_bytes(w, len);
            uint64_t i = h & mask;
            for (;;) {
                Entry& e = slots[i];
                if (!e.hash) {
                    e.hash = h;
                    e.count = 1;
                    e.arena_off = arena.size();
                    e.len = len;
                    arena.insert(arena.end(), w, w + len);
                    unique_bytes += len;
                    if (++used * 4 > (mask + 1) * 3) grow();
                    break;
                }
                if (e.hash == h && e.len == len &&
                    std::memcmp(arena.data() + e.arena_off, w, len) == 0) {
                    e.count++;
                    break;
                }
                i = (i + 1) & mask;
            }
            word_start = pos;
        }
    }

    int64_t finish(uint32_t ws_bit, uint32_t* out_syms, int32_t* out_wts,
                   int64_t out_cap, int64_t* out_n) {
        std::vector<const Entry*> uniq;
        uniq.reserve(used);
        for (const Entry& e : slots)
            if (e.hash) uniq.push_back(&e);
        // canonical order: (length asc, bytes asc) — the numpy path's
        // np.unique-within-length-groups order, so streams (hence
        // checkpoint fingerprints) are identical across loaders
        const uint8_t* a = arena.data();
        std::sort(uniq.begin(), uniq.end(),
                  [a](const Entry* x, const Entry* y) {
                      if (x->len != y->len) return x->len < y->len;
                      return std::memcmp(a + x->arena_off, a + y->arena_off,
                                         x->len) < 0;
                  });
        int64_t k = 0;
        for (const Entry* e : uniq) {
            if (e->count >= (int64_t)1 << 31) return -2;
            if (k + e->len > out_cap) return -1;
            const uint8_t* p = a + e->arena_off;
            int32_t c = (int32_t)e->count;
            out_syms[k] = (uint32_t)p[0] | ws_bit;
            out_wts[k] = c;
            for (uint32_t j = 1; j < e->len; ++j) {
                out_syms[k + j] = p[j];
                out_wts[k + j] = c;
            }
            k += e->len;
        }
        *out_n = k;
        return 0;
    }
};

}  // namespace

extern "C" {

void* ingest_acc_new() { return new (std::nothrow) Acc(); }

int64_t ingest_acc_add(void* h, const uint8_t* data, const uint8_t* starts,
                       int64_t n) {
    if (!h) return -3;
    if (n <= 0) return 0;
    try {
        static_cast<Acc*>(h)->add(data, starts, n);
    } catch (const std::bad_alloc&) {
        return -3;
    }
    return 0;
}

int64_t ingest_acc_unique_bytes(void* h) {
    return h ? (int64_t)static_cast<Acc*>(h)->unique_bytes : 0;
}

int64_t ingest_acc_finish(void* h, uint32_t ws_bit, uint32_t* out_syms,
                          int32_t* out_wts, int64_t out_cap, int64_t* out_n) {
    *out_n = 0;
    if (!h) return -3;
    return static_cast<Acc*>(h)->finish(ws_bit, out_syms, out_wts, out_cap,
                                        out_n);
}

void ingest_acc_free(void* h) { delete static_cast<Acc*>(h); }

int64_t ingest_dedup(const uint8_t* data, const uint8_t* starts, int64_t n,
                     uint32_t ws_bit, uint32_t* out_syms, int32_t* out_wts,
                     int64_t out_cap, int64_t* out_n) {
    *out_n = 0;
    if (n <= 0) return 0;
    Acc* acc = new (std::nothrow) Acc();
    if (!acc) return -3;
    int64_t rc = ingest_acc_add(acc, data, starts, n);
    if (rc == 0) rc = acc->finish(ws_bit, out_syms, out_wts, out_cap, out_n);
    delete acc;
    return rc;
}

}  // extern "C"
