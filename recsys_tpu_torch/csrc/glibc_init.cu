// The glibc random() stream (TYPE_3) for NVIDIA Hopper (sm_90a): the device
// init's draws, L's and R's, in one launch (ops/device_rng.py::glibc_stream).
//
// It replaces no Pallas kernel: the JAX package draws the stream with plain
// XLA ops (recsys_tpu/ops/device_rng.py).  It was added because the torch
// form of those ops (DeviceGlibcStream: a (34, block) int64 coefficient
// table, streamed through device memory by 68 int64 multiply-adds a block)
// ran at 0.18% of its floor on an H100.  The floor is the output: 4 bytes a
// draw written once (0.84 ms for the 700,070,000 draws of the 1M-user
// instance at 3.35 TB/s).  Nothing else need touch device memory.
//
// The recurrence x[i] = x[i-31] + x[i-3] (mod 2^32) is linear, so the 34-word
// window x[p-34 .. p-1] ahead of position p is J_p times the window ahead of
// position 0, J_p a 34 x 34 integer matrix; uint32 arithmetic wraps mod 2^32
// exactly.  A thread draws a segment of SEG consecutive words, a block of T
// threads a span of T * SEG.
//  1. Jump.  The host builds J_{SEG * 2^e} for e < count once a process
//     (device_rng.jump_matrices), rows padded to 36 words for 16-byte loads.
//     Block b's window (row 0 of shared memory): 34 threads, a row each,
//     multiply the seed window by J_{SEG * T * 2^e} for each set bit e of b.
//     Then the block's windows double: in round e the windows of segments
//     [2^e, 2^(e+1)) are J_{SEG * 2^e} times those of [0, 2^e), one 34-word
//     dot product a (window, row), spread over the block, with the matrix
//     row the same across a warp's lanes once a round has 32 windows.
//     device_rng.plan_windows is this plan in numpy.
//  2. Draw.  A thread keeps its window in registers and draws CHUNK words at
//     a time with every index known at compile time: one add a word, three
//     independent at a time (the shortest lag is 3).  A word is stored as
//     f32(x >> 1) * scale (__fmul_rn, no contraction: the torch twin's two
//     roundings), or in the words form as x itself.
//  3. Store.  A thread's segment is contiguous, so the lanes' own stores
//     would be SEG words apart.  Each chunk goes through shared memory
//     instead, rows of 36 words (16-byte writes and reads free of bank
//     conflicts), and the warp writes its 32 rows out as 16-byte vectors,
//     eight lanes to a 128-byte row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 34;         // the state window
constexpr int LOG_T = 8;
constexpr int T = 1 << LOG_T;   // threads a block
constexpr int SEG = 1024;       // words a thread
constexpr int CHUNK = 32;       // words a thread stages at a time
constexpr int ROW = 36;         // a staged row, in words
constexpr int WROW = 35;        // a window's row in the jump phase
constexpr int JROW = 36;        // a jump matrix's row in device memory
constexpr int JMAT = WIN * JROW;

struct Window {
  uint32_t w[WIN];
};

// Row `J` (36 words, the last two 0) of a jump matrix dotted with the window
// at `src` (34 words of shared memory), mod 2^32.
__device__ __forceinline__ uint32_t dot_row(const uint32_t* __restrict__ J, const uint32_t* src) {
  const uint4* j4 = reinterpret_cast<const uint4*>(J);
  uint32_t acc = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = __ldg(j4 + q);
    acc += v.x * src[4 * q] + v.y * src[4 * q + 1] + v.z * src[4 * q + 2] + v.w * src[4 * q + 3];
  }
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(J + 32));
  return acc + v.x * src[32] + v.y * src[33];
}

template <bool WORDS>
__device__ __forceinline__ uint32_t value(uint32_t x, float scale) {
  if (WORDS) return x;
  return __float_as_uint(__fmul_rn(__uint2float_rn(x >> 1), scale));
}

template <bool WORDS>
__global__ void __launch_bounds__(T, 2)
    glibc_init(const uint32_t* __restrict__ jumps, Window seed, uint32_t* __restrict__ out, long long n,
               float scale) {
  __shared__ __align__(16) uint32_t sm[T * ROW];
  const int t = threadIdx.x;
  const unsigned b = blockIdx.x;

  // 1. Jump: the block's window, then each segment's.
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < WIN; ++j) sm[j] = seed.w[j];
  }
  __syncthreads();
#pragma unroll 1
  for (int e = 0; (b >> e) != 0u; ++e) {
    if (!((b >> e) & 1u)) continue;
    uint32_t v = 0;
    if (t < WIN) v = dot_row(jumps + (size_t)(LOG_T + e) * JMAT + t * JROW, sm);
    __syncthreads();
    if (t < WIN) sm[t] = v;
    __syncthreads();
  }
#pragma unroll 1
  for (int e = 0; e < LOG_T; ++e) {
    const int h = 1 << e;
    const uint32_t* J = jumps + (size_t)e * JMAT;
    for (int item = t; item < (WIN << e); item += T) {
      const int r = item >> e, j = item & (h - 1);
      sm[(h + j) * WROW + r] = dot_row(J + r * JROW, sm + j * WROW);
    }
    __syncthreads();
  }
  uint32_t w[WIN];
#pragma unroll
  for (int j = 0; j < WIN; ++j) w[j] = sm[t * WROW + j];
  __syncthreads();

  // 2 and 3. Draw and store, a warp at a time.
  const int lane = t & 31, warp = t >> 5;
  const long long first = ((long long)b * T + warp * 32) * SEG;  // the warp's first segment
  if (first >= n) return;
  const long long left = n - first;
  const int chunks = left >= SEG ? SEG / CHUNK : (int)((left + CHUNK - 1) / CHUNK);
  uint32_t* stage = sm + warp * 32 * ROW;
  uint32_t* mine = stage + lane * ROW;
  const int quad = 4 * (lane & 7);
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    uint32_t v[WIN + CHUNK];
#pragma unroll
    for (int j = 0; j < WIN; ++j) v[j] = w[j];
#pragma unroll
    for (int j = WIN; j < WIN + CHUNK; ++j) v[j] = v[j - 31] + v[j - 3];
#pragma unroll
    for (int j = 0; j < WIN; ++j) w[j] = v[CHUNK + j];
#pragma unroll
    for (int q = 0; q < CHUNK / 4; ++q) {
      const uint32_t* x = v + WIN + 4 * q;
      *reinterpret_cast<uint4*>(mine + 4 * q) = make_uint4(value<WORDS>(x[0], scale), value<WORDS>(x[1], scale),
                                                           value<WORDS>(x[2], scale), value<WORDS>(x[3], scale));
    }
    __syncwarp();
    const long long at = first + (long long)c * CHUNK + quad;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = 4 * i + (lane >> 3);  // the row (lane) this lane writes out
      const uint4 o = *reinterpret_cast<const uint4*>(stage + p * ROW + quad);
      const long long pos = at + (long long)p * SEG;
      if (pos + 4 <= n) {
        *reinterpret_cast<uint4*>(out + pos) = o;
      } else if (pos < n) {
        out[pos] = o.x;
        if (pos + 1 < n) out[pos + 1] = o.y;
        if (pos + 2 < n) out[pos + 2] = o.z;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// The first n words of the stream whose 34-word window ahead of position 0
// is `window` (host memory), into `out` (device memory, 16-byte aligned, n
// words): f32(x >> 1) * scale, or x where `words` is nonzero.  `jumps` holds
// `count` padded matrices J_{segment * 2^e} (device_rng.jump_matrices);
// `segment` and `log_threads` must be this file's SEG and LOG_T.
extern "C" int rs_glibc_init(const uint32_t* jumps, int count, int segment, int log_threads, const uint32_t* window,
                             uint32_t* out, long long n, float scale, int words, void* stream) {
  if (segment != SEG || log_threads != LOG_T || n < 1 || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return cudaErrorInvalidValue;
  }
  const long long span = (long long)T * SEG;
  const long long blocks = (n + span - 1) / span;
  int bits = 0;
  while ((blocks - 1) >> bits) ++bits;
  if (blocks > 0x7fffffffLL || count < LOG_T + bits) return cudaErrorInvalidValue;
  Window seed;
  for (int j = 0; j < WIN; ++j) seed.w[j] = window[j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words) {
    glibc_init<true><<<(unsigned)blocks, T, 0, st>>>(jumps, seed, out, n, scale);
  } else {
    glibc_init<false><<<(unsigned)blocks, T, 0, st>>>(jumps, seed, out, n, scale);
  }
  return cudaGetLastError();
}
