// dense_match: the tokenizer's dense join, one hash probe per position and
// dense token length. For every position p of a pass it finds the longest
// vocab token of a dense length ln that starts at p and ends within p's
// chunk and the input (ln <= min((p / chunk + 1) * chunk, input_len) - p),
// and writes its id and length; where none matches, the incoming match
// stays: the single-byte match (computed here from `byte_ids` when no
// incoming arrays are given) or the stab join's.
//
// Replaces no TPU kernel: the JAX package's dense join
// (gpu_bpe_tpu/ops/tokenize.py, `build_match_table`) is plain jnp, an
// equality join of every position with every key of every length. Its
// PyTorch form (`dense_match_plain` in ops/dense_kernels.py, kept as the
// CPU path and as this kernel's yardstick on the card) builds an int64
// [positions, keys] tensor per length and reduces it: ~1.3e10 compares and
// ~181 ms of device time for a 2^24-byte pass at a trained 1K vocab (768
// keys of 13 lengths), ~1000 times its byte bound.
//
// Bound on this card: bytes. One read of the pass (1 B per position), the
// incoming match read when given (16 B) and the match written (16 B): 17 B
// per position with the single-byte step folded in, ~285 MB and ~85 us for
// a 2^24-byte pass at 3.35 TB/s; 33 B (~0.55 GB, ~165 us) on top of the
// stab join. The table (16 B a slot) is read once per block.
//
// Design (own; the host builds the table once per vocab and device, in
// `DenseHash.build`, which mirrors the hash below in numpy):
//   * an open-addressed table over every dense (length, key) pair, a power
//     of two of slots at a load of at most 0.5, linear probing. A slot is
//     {length (0 = empty), id, key word 0, offset of key words 1.. in a
//     packed word array}; key words are big-endian, the last one's unused
//     low bytes zero. A probe stops at an empty slot or after `max_probes`
//     slots (the longest displacement of any key, plus one);
//   * the hash is murmur3's block mix over the key's words, seeded with the
//     length, and its finaliser; a probe compares the length and every
//     word, so a collision costs time and never an id;
//   * persistent blocks: each loads the table into shared memory once (when
//     it fits in SMEM_TABLE_MAX bytes, else it is read through L1/L2) and
//     walks tiles of TILE_N positions. A tile's bytes and the halo its
//     longest probe needs are staged in shared memory with 16-byte loads
//     (bytes past the pass read as 0 and are never compared: a probe needs
//     ln <= room, so its bytes lie inside the input);
//   * a thread takes every THREADS-th position of the tile, so a warp's
//     byte reads are 32 consecutive bytes and its 8-byte stores are
//     coalesced. A window word is two aligned shared loads, a funnel shift
//     and a byte swap; the first REG_WORDS words stay in registers across
//     lengths. Lengths go longest first, only those within the room; the
//     first hit ends the position.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_N = 2048;                   // positions per tile
constexpr int REG_WORDS = 4;                   // window words kept in registers (keys up to 16 bytes)
constexpr long long SMEM_TABLE_MAX = 96 * 1024;  // largest table (with the stage) kept in shared memory
constexpr long long SMEM_LIMIT = 227 * 1024;     // a block's shared memory on sm_90
constexpr long long MAX_STAGE_LEN = 64 * 1024;   // longest token a probe can match (ops/dense_kernels.py MAX_LEN)

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// murmur3's block mix of one key word into the running hash
__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t w) {
    w *= 0xCC9E2D51u;
    w = rotl32(w, 15);
    w *= 0x1B873593u;
    h ^= w;
    h = rotl32(h, 13);
    return h * 5u + 0xE6546B64u;
}

// murmur3's finaliser, with the length folded in
__device__ __forceinline__ uint32_t finish(uint32_t h, uint32_t ln) {
    h ^= ln;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// big-endian word of the staged bytes q .. q + 3
__device__ __forceinline__ uint32_t window_word(const uint32_t* stage, int q) {
    const uint32_t a = stage[q >> 2], b = stage[(q >> 2) + 1];
    return __byte_perm(__funnelshift_r(a, b, (q & 3) * 8), 0u, 0x0123);
}

template <bool SMEM_TABLE, bool FOLD>
__global__ void __launch_bounds__(THREADS)
dense_match_tiles(const unsigned char* __restrict__ data, long long n, long long input_len, long long chunk,
                  const int* __restrict__ lens_g, int n_len, const uint4* __restrict__ slots_g, uint32_t smask,
                  const uint32_t* __restrict__ words_g, int n_words, int max_probes,
                  const int* __restrict__ byte_ids_g, const long long* __restrict__ in_id,
                  const long long* __restrict__ in_len, long long* __restrict__ out_id,
                  long long* __restrict__ out_len, int stage_bytes) {
    // shared: stage | byte ids (FOLD) | lengths (padded to 4) | slots, words (SMEM_TABLE)
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
    const unsigned char* stage_b = smem;
    int* byte_ids = reinterpret_cast<int*>(smem + stage_bytes);
    int* lens = byte_ids + (FOLD ? 256 : 0);
    uint4* slots_s = reinterpret_cast<uint4*>(lens + ((n_len + 3) & ~3));
    uint32_t* words_s = reinterpret_cast<uint32_t*>(slots_s + (SMEM_TABLE ? smask + 1 : 0));
    const int t = threadIdx.x;

    if (FOLD)
        for (int i = t; i < 256; i += THREADS) byte_ids[i] = byte_ids_g[i];
    for (int i = t; i < n_len; i += THREADS) lens[i] = lens_g[i];
    if (SMEM_TABLE) {
        for (uint32_t i = t; i <= smask; i += THREADS) slots_s[i] = slots_g[i];
        for (int i = t; i < n_words; i += THREADS) words_s[i] = words_g[i];
    }
    const uint4* slots = SMEM_TABLE ? slots_s : slots_g;
    const uint32_t* words = SMEM_TABLE ? words_s : words_g;
    __syncthreads();
    const int shortest = lens[n_len - 1];
    const bool narrow = n <= 0x7FFFFFFFll && chunk <= 0x7FFFFFFFll;  // 32-bit division suffices
    const long long ntiles = (n + TILE_N - 1) / TILE_N;

    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const long long start = tile * TILE_N;
        for (int i = 16 * t; i < stage_bytes; i += 16 * THREADS) {
            const long long g = start + i;
            uint4 v;
            if (g + 16 <= n && (reinterpret_cast<unsigned long long>(data + g) & 15) == 0) {
                v = __ldg(reinterpret_cast<const uint4*>(data + g));
            } else {
                uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int k = 0; k < 16; ++k)
                    if (g + k < n) w[k >> 2] |= (uint32_t)data[g + k] << (8 * (k & 3));
                v = make_uint4(w[0], w[1], w[2], w[3]);
            }
            *reinterpret_cast<uint4*>(smem + i) = v;
        }
        __syncthreads();

        for (int i = t; i < TILE_N; i += THREADS) {
            const long long p = start + i;
            if (p >= n) break;
            long long id, len;
            if (FOLD) {
                id = p < input_len ? byte_ids[stage_b[i]] : -1;
                len = id >= 0 ? 1 : 0;
            } else {
                id = in_id[p];
                len = in_len[p];
            }
            const long long end = (narrow ? (long long)((uint32_t)p / (uint32_t)chunk) : p / chunk) * chunk + chunk;
            const long long room = (end < input_len ? end : input_len) - p;
            if (room >= shortest) {
                uint32_t wr[REG_WORDS];
#pragma unroll
                for (int k = 0; k < REG_WORDS; ++k) wr[k] = window_word(stage, i + 4 * k);
                for (int li = 0; li < n_len; ++li) {
                    const int ln = lens[li];
                    if (ln > room) continue;
                    const int nw = (ln + 3) >> 2;
                    const int rem = ln & 3;
                    const uint32_t last = rem ? ~0u << (8 * (4 - rem)) : ~0u;
                    uint32_t h = (uint32_t)ln * 0x9E3779B9u;
#pragma unroll
                    for (int k = 0; k < REG_WORDS; ++k)
                        if (k < nw) h = mix_word(h, k == nw - 1 ? wr[k] & last : wr[k]);
                    for (int k = REG_WORDS; k < nw; ++k) {
                        const uint32_t w = window_word(stage, i + 4 * k);
                        h = mix_word(h, k == nw - 1 ? w & last : w);
                    }
                    h = finish(h, (uint32_t)ln);
                    const uint32_t w0 = nw == 1 ? wr[0] & last : wr[0];
                    int found = -1;
                    for (int pr = 0; pr < max_probes; ++pr) {
                        const uint4 s = slots[(h + (uint32_t)pr) & smask];
                        if (s.x == 0u) break;  // an empty slot ends the run: a miss
                        if (s.x != (uint32_t)ln || s.z != w0) continue;
                        bool eq = true;
#pragma unroll
                        for (int k = 1; k < REG_WORDS; ++k)
                            if (eq && k < nw) eq = (k == nw - 1 ? wr[k] & last : wr[k]) == words[s.w + k - 1];
                        for (int k = REG_WORDS; eq && k < nw; ++k) {
                            const uint32_t w = window_word(stage, i + 4 * k);
                            eq = (k == nw - 1 ? w & last : w) == words[s.w + k - 1];
                        }
                        if (eq) {
                            found = (int)s.y;
                            break;
                        }
                    }
                    if (found >= 0) {
                        id = found;
                        len = ln;
                        break;
                    }
                }
            }
            out_id[p] = id;
            out_len[p] = len;
        }
        __syncthreads();
    }
}

template <bool SMEM_TABLE, bool FOLD>
cudaError_t launch(const unsigned char* data, long long n, long long input_len, long long chunk, const int* lens,
                   int n_len, const uint4* slots, uint32_t smask, const uint32_t* words, int n_words,
                   int max_probes, const int* byte_ids, const long long* in_id, const long long* in_len,
                   long long* out_id, long long* out_len, int stage_bytes, int smem, cudaStream_t s) {
    auto kernel = dense_match_tiles<SMEM_TABLE, FOLD>;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess)
        return err;
    const long long ntiles = (n + TILE_N - 1) / TILE_N;
    long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    if (grid > ntiles) grid = ntiles;
    kernel<<<(unsigned)grid, THREADS, smem, s>>>(data, n, input_len, chunk, lens, n_len, slots, smask, words,
                                                  n_words, max_probes, byte_ids, in_id, in_len, out_id, out_len,
                                                  stage_bytes);
    return cudaGetLastError();
}

}  // namespace

extern "C" long long dm_tile_positions() { return TILE_N; }

// data: n bytes of the pass (any alignment), the input its first input_len;
// lens: n_len dense lengths, longest first, each at least 2; max_len: the
// longest length a probe can match (at most min(lens[0], chunk, input_len)
// is needed, at most MAX_STAGE_LEN); slots: n_slots (a power of two) x
// {length, id, word 0, offset}; words: n_words u32 key words 1..; byte_ids:
// 256 ids (-1 = no single-byte token), read when in_id is null; in_id,
// in_len: the incoming match (int64 [n]) or null; out_id, out_len: int64 [n].
extern "C" int dense_match(const unsigned char* data, long long n, long long input_len, long long chunk,
                           const int* lens, long long n_len, long long max_len, const void* slots,
                           long long n_slots, const uint32_t* words, long long n_words, long long max_probes,
                           const int* byte_ids, const long long* in_id, const long long* in_len,
                           long long* out_id, long long* out_len, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool fold = in_id == nullptr;
    if (n < 0 || chunk < 1 || n_len < 1 || n_len > MAX_STAGE_LEN || max_len < 1 || max_len > MAX_STAGE_LEN
        || n_slots < 2 || n_slots > (1ll << 31) || (n_slots & (n_slots - 1)) != 0 || n_words < 0
        || n_words > (1ll << 30) || max_probes < 1 || max_probes > n_slots || (fold && byte_ids == nullptr)
        || (!fold && in_len == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long reach = max_len > 4 * REG_WORDS ? max_len : 4 * REG_WORDS;
    const long long stage_bytes = (TILE_N + reach + 8 + 15) / 16 * 16;
    const long long fixed = stage_bytes + (fold ? 256 * 4 : 0) + (n_len + 3) / 4 * 16;
    const long long table = n_slots * 16 + n_words * 4;
    const bool in_smem = fixed + table <= SMEM_TABLE_MAX;
    const long long smem = fixed + (in_smem ? table : 0);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const auto* sl = static_cast<const uint4*>(slots);
    const uint32_t smask = (uint32_t)(n_slots - 1);
    const cudaError_t err =
        in_smem ? (fold ? launch<true, true> : launch<true, false>)(
                      data, n, input_len, chunk, lens, (int)n_len, sl, smask, words, (int)n_words, (int)max_probes,
                      byte_ids, in_id, in_len, out_id, out_len, (int)stage_bytes, (int)smem, s)
                : (fold ? launch<false, true> : launch<false, false>)(
                      data, n, input_len, chunk, lens, (int)n_len, sl, smask, words, (int)n_words, (int)max_probes,
                      byte_ids, in_id, in_len, out_id, out_len, (int)stage_bytes, (int)smem, s);
    return (int)err;
}
