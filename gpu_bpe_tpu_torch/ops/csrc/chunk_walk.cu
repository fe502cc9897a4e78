// chunk_walk: the tokenizer's greedy walk over one pass, in one launch.
// Each chunk of `chunk` positions emits at its first byte; from an emitted
// position p the next emission is at p + max(match_len[p], 1) (1 where
// match_id[p] < 0); nothing is emitted at or after min(chunk end,
// input_len). The output is int32 and position-aligned: the token id (the
// raw byte where match_id < 0) at each emitted position, PAD (-1, the bits
// of 0xFFFFFFFF) everywhere else, which is what `compact_valid` strips.
//
// Replaces no TPU kernel: the JAX package's walk is a `lax.scan` over the
// chunk offsets (gpu_bpe_tpu/ops/tokenize.py `chunk_walk`, and a gather
// walk past 63-byte tokens). Its PyTorch form (`chunk_walk_plain` in
// ops/walk_kernels.py, kept as the CPU path and as this kernel's yardstick
// on the card) is a host loop of four tiny launches per chunk offset:
// ~2,048 launches for a pass at chunk 512, each over one int64 per chunk.
//
// Bound on this card: bytes. match_id and match_len read (16 B), the byte
// read (1 B) and the int32 written (4 B): 21 B per position, ~352 MB and
// ~105 us for a 2^24-byte pass at 3.35 TB/s. The walk itself is ~cs / 3
// dependent shared-memory steps per chunk.
//
// Design (own):
//   * a block takes G consecutive chunks (G = BLOCK_POSITIONS / chunk,
//     1..MAX_GROUP, so a block stages about 8192 positions and four blocks
//     fit an SM) with THREADS threads;
//   * stage 1: the threads stage each chunk's steps (u16, clamped to the
//     chunk: a longer step ends the chunk all the same) and tokens (u32)
//     into shared memory with coalesced loads of match_id, match_len and
//     the byte; positions at or past the input are not read;
//   * stage 2: thread j < G walks chunk j in shared memory and sets the
//     EMIT bit of the step at each emitted position (each thread writes
//     only its own chunk, so no atomics). Chunk rows are padded so that
//     the G walkers start in G different banks;
//   * stage 3: the threads write the int32 output of every position of
//     the block's chunks, coalesced: the token where EMIT is set, else PAD.
//   No length limit of the walk: a step may be anything up to the chunk.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long BLOCK_POSITIONS = 8192;  // positions staged per block (cw_chunks_per_block)
constexpr long long MAX_GROUP = 32;          // chunks per block: one warp walks them
constexpr long long MAX_CHUNK = 0x7FFF;      // steps and the EMIT flag share a u16
constexpr long long SMEM_LIMIT = 227 * 1024;  // a block's shared memory on sm_90
constexpr uint16_t EMIT = 0x8000;

long long chunks_per_block(long long chunk) {
    const long long g = BLOCK_POSITIONS / chunk;
    return g < 1 ? 1 : (g > MAX_GROUP ? MAX_GROUP : g);
}

// u16 entries per staged chunk row: even, with an odd number of 4-byte words
long long row_stride(long long chunk) {
    const long long even = (chunk + 1) & ~1ll;
    return (even / 2) % 2 ? even : even + 2;
}

__global__ void __launch_bounds__(THREADS)
chunk_walk_blocks(const long long* __restrict__ match_id, const long long* __restrict__ match_len,
                  const unsigned char* __restrict__ data, long long input_len, int chunk, int group,
                  int stride, long long num_chunks, int* __restrict__ out) {
    // shared: tokens [group][chunk] u32 | steps [group][stride] u16
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* toks = reinterpret_cast<uint32_t*>(smem);
    uint16_t* steps = reinterpret_cast<uint16_t*>(smem + (size_t)group * chunk * 4);
    const int t = threadIdx.x;
    const long long first = (long long)blockIdx.x * group;
    const int count = (int)(num_chunks - first < group ? num_chunks - first : group);

    const long long base = first * chunk;  // the block's chunks are one run of positions
    const int span = count * chunk;
    const int pad = stride - chunk;
#pragma unroll 4
    for (int i = t; i < span; i += THREADS) {
        const long long p = base + i;
        const int k = i + (int)((unsigned)i / (unsigned)chunk) * pad;
        if (p < input_len) {
            const long long id = __ldg(match_id + p), ln = __ldg(match_len + p);
            const uint32_t b = __ldg(data + p);
            steps[k] = id >= 0 && ln > 1 ? (uint16_t)(ln < chunk ? ln : chunk) : (uint16_t)1;
            toks[i] = id >= 0 ? (uint32_t)(unsigned long long)id : b;
        } else {
            steps[k] = 0;
        }
    }
    __syncthreads();

    if (t < count) {
        const long long rest = input_len - (first + t) * chunk;
        const int lim = rest < chunk ? (rest > 0 ? (int)rest : 0) : chunk;
        uint16_t* st = steps + (size_t)t * stride;
        for (int pos = 0; pos < lim;) {
            const uint16_t s = st[pos];
            st[pos] = s | EMIT;
            pos += s;
        }
    }
    __syncthreads();

#pragma unroll 4
    for (int i = t; i < span; i += THREADS) {
        const int k = i + (int)((unsigned)i / (unsigned)chunk) * pad;
        out[base + i] = (steps[k] & EMIT) ? (int)toks[i] : -1;
    }
}

}  // namespace

extern "C" long long cw_chunks_per_block(long long chunk) { return chunk < 1 ? 0 : chunks_per_block(chunk); }

// match_id, match_len: int64 [n] (match_id < 0: no token, emit the byte);
// data: the pass's n bytes; input_len <= n; chunk: 1..MAX_CHUNK dividing n;
// out: int32 [n].
extern "C" int chunk_walk(const long long* match_id, const long long* match_len, const unsigned char* data,
                          long long n, long long input_len, long long chunk, int* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 0 || chunk < 1 || chunk > MAX_CHUNK || n % chunk != 0 || input_len < 0 || input_len > n)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long group = chunks_per_block(chunk);
    const long long stride = row_stride(chunk);
    const long long smem = group * chunk * 4 + group * stride * 2;
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(chunk_walk_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long num_chunks = n / chunk;
    const long long grid = (num_chunks + group - 1) / group;
    if (grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
    chunk_walk_blocks<<<(unsigned)grid, THREADS, (size_t)smem, s>>>(match_id, match_len, data, input_len, (int)chunk,
                                                                   (int)group, (int)stride, num_chunks, out);
    return (int)cudaGetLastError();
}
