// Tiled dense GD for NVIDIA Hopper (sm_90a): kernel B5 and the fused step
// built on it.
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_dense.py::tiled_deltas (:566;
// bodies _dl_kernel :538 and _dr_kernel :552, called at :578 and :594): the raw
// gradient sums of one stable-snapshot GD step on lane-major factors L (U, K),
// R (I, K), with the implicit mask a != 0 (pallas_dense.py module docstring):
//
//     E  = (A != 0) * (A - L.R^T)      (U, I), never stored
//     dL = E.R                          (U, K)
//     dR = E^T.L                        (I, K)
//
// rs_tiled_deltas returns them raw: the sharded engine first sums them across
// shards (parallel/step.py:106).  rs_tiled_step is the whole step that
// tiled_gd_step (:614) composes outside the kernel, L' = L + a2*dL and
// R' = R + a2*dR, with the update fused: the product rounded, then the sum
// (__fmul_rn, __fadd_rn: never one FMA), a2 the f32 rounding of alpha2, so
// its bits are those of the raw deltas followed by torch's `L + dL.mul_(a2)`.
//
// What bounds it on this card.  At gen-inst1e6-100-700-1-3 (U = 1M users,
// I = 100 items, K = 704, 2.0M ratings) the step needs 6*k FLOP per rated
// cell, 8.4 GFLOP, but has to read L (2.8 GB) and A and write L' (2.8 GB):
// 5.76 GB, ~1.72 ms at 3.35 TB/s.  It is bound by HBM bytes, not by
// operations.  Counted densely, as the TPU kernel computes it, the step is
// 8*U*I*K = 0.72 TFLOP.  The dR pass reads one L row per rating on top
// (5.6 GB at that shape), which the bound does not count.
//
// What the design does about that.
//  * Rated cells only.  A warp owns one row of the side it sums -- a user row
//    of L in the L pass, an item row of R in dr_pass -- K/32 values a lane
//    (k = m*32 + lane).  It walks its line of A 32 cells at a time, ballots
//    the rated cells and visits only those: for each it loads the other
//    side's row, forms pred = L_u . R_i by per-lane sums and a butterfly of
//    shuffles, e = a - pred, and adds e * row to its sums.  An unrated cell
//    costs its byte of A and nothing else.
//  * E never leaves registers, and in the fused step neither do dL and dR:
//    the L pass writes L' and the R reduction writes R'.  Each pass
//    recomputes pred for its cells with the same lane map and shuffle order,
//    so both see the same e bit for bit.
//  * The L pass has two forms with the same arithmetic in the same order.
//    The warp form (dl_pass) keeps its own row in registers and walks A and
//    R as dependent round trips: one warp waits on its L row, each chunk of
//    A and each rated R row in turn, so at the 16 warps an SM its registers
//    allow it reached 62% of its bytes.  The ring form (dl_ring) is
//    persistent: each warp takes every W-th user and streams their L rows
//    and A lines into a ring of RING stages in shared memory with cp.async,
//    RING - 1 users ahead, so HBM latency overlaps the current users' work
//    (a user waits for its own stage and the next user's).
//    The L row is read from shared memory at each use (no registers for it),
//    and the R row of the next rated cell -- in this user or the next, whose
//    A line is already staged -- is in flight during the current cell's dot.
//    It needs a stage of 4*K + I*|a| bytes per warp and stage in shared
//    memory, so it serves short A lines; the wrapper picks the form.
//  * A is read in both orientations: the L pass walks A (U, I) along items,
//    dr_pass walks A^T (I, U) along users, so every line is contiguous.
//  * dR sums over all users.  dr_pass cuts the users into S chunks, one warp
//    per (item, chunk), enough warps to fill the card, and writes S partial
//    rows; sum_parts adds them in chunk order into dR or, in the fused step,
//    writes R' = R + a2 * sum.  With one chunk the pass writes dR, or R',
//    itself.  No float atomics: two runs give the same bits.
//  * Precision is a template parameter, with the operand rounding of
//    pallas_dense._dot (:122): HIGHEST is IEEE f32 FMA (never TF32), DEFAULT
//    rounds both operands to bf16 (products exact in f32, f32 sums), BF16X3
//    splits every operand hi + lo and sums (ah*bl + al*bh) + ah*bh.
//  * K/32 values per lane are a template parameter, KPL in {8, 24, 32}; K
//    is at most 32 * 32 = 1024.
//
// Later work: the dR pass folded into the user walk (it reads L once per
// rating today), which keeps dR's order of sums only if each block owns a
// dr_split chunk and adds per item in ascending user order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr int BLOCK = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// Stages of dl_ring's per-warp ring: users RING - 1 ahead are in flight.
constexpr int RING = 4;

enum Prec { HIGHEST = 0, BF16X3 = 1, DEFAULT = 2 };
enum AKind { A_INT8 = 0, A_BF16 = 1, A_F32 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _bsplit (pallas_dense.py:107): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void bsplit(float x, float& hi, float& lo) {
  hi = round_bf16(x);
  lo = round_bf16(x - hi);
}

// One operand as the mode reads it: (hi, lo) under BF16X3, bf16(x) under
// DEFAULT, x under HIGHEST (lo is read under BF16X3 only).
template <int P>
__device__ __forceinline__ void split(float v, float& h, float& l) {
  if (P == BF16X3) {
    bsplit(v, h, l);
  } else {
    h = P == DEFAULT ? round_bf16(v) : v;
    l = 0.f;
  }
}

// _load_at (pallas_dense.py:155): int8 holds 2x the rating, x0.5 is exact.
// The kind is uniform across the grid, so the branch costs no divergence.
__device__ __forceinline__ float load_a(const void* A, int kind, size_t idx) {
  if (kind == A_INT8) return static_cast<float>(__ldg(static_cast<const signed char*>(A) + idx)) * 0.5f;
  if (kind == A_BF16) return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(A) + idx));
  return __ldg(static_cast<const float*>(A) + idx);
}

// One factor row as a lane holds it: k = m*32 + lane for m < nk = K/32, split
// for the mode (lo is read under BF16X3 only).
template <int P, int KPL>
struct Row {
  float h[KPL];
  float l[KPL];

  __device__ __forceinline__ void load(const float* __restrict__ p, int nk, int lane) {
#pragma unroll
    for (int m = 0; m < KPL; ++m) split<P>(m < nk ? __ldg(p + m * 32 + lane) : 0.f, h[m], l[m]);
  }
};

// One k's terms of pred = _dot(L_u, R_i): BF16X3 keeps the small terms
// Lh*Rl + Ll*Rh in ss apart from Lh*Rh in sb until the end, as _dot does.
template <int P>
__device__ __forceinline__ void dot_term(float lh, float ll, float rh, float rl, float& sb, float& ss) {
  if (P == BF16X3) {
    ss = fmaf(lh, rl, ss);
    ss = fmaf(ll, rh, ss);
  }
  sb = fmaf(lh, rh, sb);
}

// The per-lane sums of pred summed over the lanes by a butterfly (every lane
// ends with the same sum: a + b == b + a).
template <int P>
__device__ __forceinline__ float butterfly(float sb, float ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sb += __shfl_xor_sync(FULL, sb, o);
    if (P == BF16X3) ss += __shfl_xor_sync(FULL, ss, o);
  }
  return P == BF16X3 ? ss + sb : sb;
}

// acc + _dot(e, y) for one k of one cell: (yl*eh + yh*el) + yh*eh under
// BF16X3 (products of bf16 values are exact in f32, so each fmaf rounds
// once, like a separate add), e*y under HIGHEST, bf16(e)*bf16(y) under
// DEFAULT.  (eh, el) is e as the mode reads it (split<P>).
template <int P>
__device__ __forceinline__ float acc_term(float acc, float yh, float yl, float eh, float el) {
  if (P == BF16X3) return acc + fmaf(yh, eh, fmaf(yh, el, yl * eh));
  return fmaf(eh, yh, acc);
}

// pred = _dot(L_u, R_i) over K: per-lane sums in k order, then the
// butterfly.  Both passes call it with (L row, R row) in this order.
template <int P, int KPL>
__device__ __forceinline__ float warp_pred(const Row<P, KPL>& lr, const Row<P, KPL>& rr) {
  float sb = 0.f, ss = 0.f;
#pragma unroll
  for (int m = 0; m < KPL; ++m) dot_term<P>(lr.h[m], lr.l[m], rr.h[m], rr.l[m], sb, ss);
  return butterfly<P>(sb, ss);
}

// acc += _dot(e, y) for one cell.
template <int P, int KPL>
__device__ __forceinline__ void accumulate(float (&acc)[KPL], const Row<P, KPL>& y, float e) {
  float eh, el;
  split<P>(e, eh, el);
#pragma unroll
  for (int m = 0; m < KPL; ++m) acc[m] = acc_term<P>(acc[m], y.h[m], y.l[m], eh, el);
}

// A warp's walk along its line of A, cells line + c for c in [c0, c1) (a
// multiple of 32 long): for every rated cell, e against row c of Y, and
// acc += e * Y_c.  OWN_L: the warp's own row is L's (dl_pass), else R's.
template <int P, int KPL, bool OWN_L>
__device__ __forceinline__ void walk(const void* A, int a_kind, size_t line, int c0, int c1,
                                     const Row<P, KPL>& own, const float* __restrict__ Y,
                                     int K, int nk, int lane, float (&acc)[KPL]) {
  if (c0 >= c1) return;
  float a_next = load_a(A, a_kind, line + c0 + lane);
  for (int c = c0; c < c1; c += 32) {
    const float a_lane = a_next;
    if (c + 32 < c1) a_next = load_a(A, a_kind, line + c + 32 + lane);
    unsigned rated = __ballot_sync(FULL, a_lane != 0.f);
    while (rated) {  // warp-uniform: the ballot is the same in every lane
      const int j = __ffs(rated) - 1;
      rated &= rated - 1;
      const float a = __shfl_sync(FULL, a_lane, j);
      Row<P, KPL> y;
      y.load(Y + static_cast<size_t>(c + j) * K, nk, lane);
      const float pred = OWN_L ? warp_pred(own, y) : warp_pred(y, own);
      accumulate(acc, y, a - pred);
    }
  }
}

// A factor row as raw values, K/32 a lane (0 past K).
template <int KPL>
__device__ __forceinline__ void load_row(float (&y)[KPL], const float* __restrict__ p, int nk, int lane) {
#pragma unroll
  for (int m = 0; m < KPL; ++m) y[m] = m < nk ? __ldg(p + m * 32 + lane) : 0.f;
}

// x + a2 * d as tiled_gd_step's torch ops round it: the product, then the
// sum.  The intrinsics keep nvcc from contracting the two into one FMA.
__device__ __forceinline__ float apply(float x, float d, float a2) { return __fadd_rn(x, __fmul_rn(d, a2)); }

// _dl_kernel, the warp form: warp w owns user w and sums dL[w] over all
// items into out (FUSE: out = L' = L + a2 * dL, else out = dL).
template <int P, int KPL, bool FUSE>
__global__ void __launch_bounds__(BLOCK)
    dl_pass(const void* __restrict__ A, int a_kind, const float* __restrict__ L,
            const float* __restrict__ R, float* __restrict__ out, int U, int I, int K, float a2) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= U) return;  // warp-uniform
  const int nk = K >> 5;
  Row<P, KPL> own;
  own.load(L + static_cast<size_t>(u) * K, nk, lane);
  float acc[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) acc[m] = 0.f;
  walk<P, KPL, true>(A, a_kind, static_cast<size_t>(u) * I, 0, I, own, R, K, nk, lane, acc);
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    if (m >= nk) continue;
    const size_t idx = static_cast<size_t>(u) * K + m * 32 + lane;
    out[idx] = FUSE ? apply(__ldg(L + idx), acc[m], a2) : acc[m];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One cell of an A line staged in shared memory, as load_a reads it.
__device__ __forceinline__ float staged_a(const unsigned char* line, int kind, int j) {
  if (kind == A_INT8) return static_cast<float>(reinterpret_cast<const signed char*>(line)[j]) * 0.5f;
  if (kind == A_BF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(line)[j]);
  return reinterpret_cast<const float*>(line)[j];
}

// The next rated cell of a staged line of I cells after the cursor (c,
// mask), mask holding the unvisited rated cells of the chunk at c: its index,
// taken from mask, or -1 past the line's end.  (-32, 0) starts a line.
__device__ __forceinline__ int next_rated(const unsigned char* line, int kind, int I, int lane, int& c,
                                          unsigned& mask) {
  while (!mask) {  // warp-uniform
    c += 32;
    if (c >= I) return -1;
    mask = __ballot_sync(FULL, staged_a(line, kind, c + lane) != 0.f);
  }
  const int j = c + __ffs(mask) - 1;
  mask &= mask - 1;
  return j;
}

// _dl_kernel, the ring form, fused: L' = L + a2 * dL.  Persistent: warp gw of
// W takes users gw, gw + W, ...; each user's L row (4K bytes) and A line
// (I * |a| bytes) land in the warp's ring of RING stages by cp.async, RING - 1
// users ahead.  The cells, the L row's split, pred's terms and the
// accumulation are the warp form's (dot_term, butterfly, acc_term in k order),
// so L' has its bits; the R row of the next rated cell, in this user's line or
// the next user's (staged too), is loaded during the current cell's dot.
// Two blocks an SM up to KPL = 24 (128 registers a thread, no spills; 94 KB
// of ring a block at gen-inst1e6's K = 704 and int8 A); past it a stage of
// up to 4 KB leaves room for one.
template <int P, int KPL>
__global__ void __launch_bounds__(BLOCK, KPL <= 24 ? 2 : 1)
    dl_ring(const void* __restrict__ A, int a_kind, const float* __restrict__ L,
            const float* __restrict__ R, float* __restrict__ Lout, int U, int I, int K, float a2) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = gridDim.x * WARPS, gw = blockIdx.x * WARPS + warp;
  const int n = gw < U ? (U - 1 - gw) / W + 1 : 0;  // users gw + i * W, i < n
  const int nk = K >> 5;
  const int l_bytes = 4 * K, a_bytes = I * (a_kind == A_INT8 ? 1 : a_kind == A_BF16 ? 2 : 4);
  const int stage = l_bytes + a_bytes;  // a multiple of 16: K % 32 == 0, I % 128 == 0
  unsigned char* const mine = ring + static_cast<size_t>(warp) * RING * stage;

  // User i's L row and A line into stage i % RING: one commit group a call,
  // empty past the warp's last user, so wait_group counts users.
  auto fetch = [&](int i) {
    if (i < n) {
      const size_t u = gw + static_cast<size_t>(i) * W;
      unsigned char* st = mine + (i % RING) * stage;
      const unsigned char* gl = reinterpret_cast<const unsigned char*>(L + u * K);
      for (int q = lane * 16; q < l_bytes; q += 32 * 16) cp_async16(st + q, gl + q);
      const unsigned char* ga = static_cast<const unsigned char*>(A) + u * a_bytes;
      for (int q = lane * 16; q < a_bytes; q += 32 * 16) cp_async16(st + l_bytes + q, ga + q);
    }
    cp_async_commit();
  };
  for (int i = 0; i < RING - 1; ++i) fetch(i);

  float y[KPL], acc[KPL];  // y: the raw R row of cell j, the next to visit
  int c = -32, j = -1;     // the cursor in the line that holds cell j
  unsigned mask = 0u;
  bool ahead = false;      // cell j (or its absence) was found in the user's line before its turn
  for (int i = 0; i < n; ++i) {
    fetch(i + RING - 1);  // into the stage of user i - 1, done with below
    cp_async_wait<RING - 2>();  // users i and i + 1 have landed
    __syncwarp();
    const unsigned char* st = mine + (i % RING) * stage;
    const float* sL = reinterpret_cast<const float*>(st);
    const unsigned char* line = st + l_bytes;
    if (!ahead) {
      c = -32;
      mask = 0u;
      j = next_rated(line, a_kind, I, lane, c, mask);
      if (j >= 0) load_row(y, R + static_cast<size_t>(j) * K, nk, lane);
    }
    ahead = false;
#pragma unroll
    for (int m = 0; m < KPL; ++m) acc[m] = 0.f;
    while (j >= 0) {  // warp-uniform
      const float a = staged_a(line, a_kind, j);
      int jn = next_rated(line, a_kind, I, lane, c, mask);
      const bool last = jn < 0;
      if (last && i + 1 < n) {  // the next rated cell is the next user's
        c = -32;
        mask = 0u;
        jn = next_rated(mine + ((i + 1) % RING) * stage + l_bytes, a_kind, I, lane, c, mask);
        ahead = true;
      }
      float yn[KPL];
      load_row(yn, R + static_cast<size_t>(jn < 0 ? 0 : jn) * K, nk, lane);
      float sb = 0.f, ss = 0.f;
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        float lh, ll, rh, rl;
        split<P>(m < nk ? sL[m * 32 + lane] : 0.f, lh, ll);
        split<P>(y[m], rh, rl);
        dot_term<P>(lh, ll, rh, rl, sb, ss);
      }
      float eh, el;
      split<P>(a - butterfly<P>(sb, ss), eh, el);
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        float rh, rl;
        split<P>(y[m], rh, rl);
        acc[m] = acc_term<P>(acc[m], rh, rl, eh, el);
        y[m] = yn[m];
      }
      j = jn;
      if (last) break;
    }
    const size_t u = gw + static_cast<size_t>(i) * W;
#pragma unroll
    for (int m = 0; m < KPL; ++m)
      if (m < nk) Lout[u * K + m * 32 + lane] = apply(sL[m * 32 + lane], acc[m], a2);
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
  cp_async_wait<0>();
}

// _dr_kernel: warp w owns item i = w % I and sums dR[i] over user chunk
// s = w / I, into part[s, i]; with one chunk and Rout given, it writes
// R'[i] = R[i] + a2 * dR[i] to Rout instead.
template <int P, int KPL>
__global__ void __launch_bounds__(BLOCK)
    dr_pass(const void* __restrict__ At, int a_kind, const float* __restrict__ L,
            const float* __restrict__ R, float* __restrict__ part, int U, int I, int K,
            int chunk, int S, float* __restrict__ Rout, float a2) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int i = w % I, s = w / I;
  if (s >= S) return;  // warp-uniform
  const int nk = K >> 5;
  Row<P, KPL> own;
  own.load(R + static_cast<size_t>(i) * K, nk, lane);
  float acc[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) acc[m] = 0.f;
  const int u0 = s * chunk, u1 = min(U, u0 + chunk);
  walk<P, KPL, false>(At, a_kind, static_cast<size_t>(i) * U, u0, u1, own, L, K, nk, lane, acc);
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    if (m >= nk) continue;
    const size_t idx = static_cast<size_t>(i) * K + m * 32 + lane;
    if (Rout != nullptr)
      Rout[idx] = apply(__ldg(R + idx), acc[m], a2);
    else
      part[static_cast<size_t>(s) * I * K + idx] = acc[m];
  }
}

// out = sum_s part[s], chunks in ascending order (deterministic); with Rout
// given, Rout = R + a2 * out instead.
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ out, size_t n, int S,
                          const float* __restrict__ R, float* __restrict__ Rout, float a2) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = __ldg(part + idx);
    for (int s = 1; s < S; ++s) v += __ldg(part + static_cast<size_t>(s) * n + idx);
    if (Rout != nullptr)
      Rout[idx] = apply(__ldg(R + idx), v, a2);
    else
      out[idx] = v;
  }
}

enum Form { WARP_FORM = 0, RING_FORM = 1 };

struct Args {
  const void *A, *At;
  int a_kind;
  const float *L, *R;
  float *dL, *dR, *part;  // the fused step: dL = L', dR = R'
  int U, I, K, chunk, S;
  float a2;
  int form;
  cudaStream_t stream;
};

// Bytes of dl_ring's shared memory: RING stages of an L row and an A line per warp.
size_t ring_bytes(int K, int I, int a_kind) {
  return static_cast<size_t>(WARPS) * RING * (4 * K + I * (a_kind == A_INT8 ? 1 : a_kind == A_BF16 ? 2 : 4));
}

template <int P, int KPL>
cudaError_t launch_ring(const Args& a) {
  const size_t smem = ring_bytes(a.K, a.I, a.a_kind);
  auto kernel = dl_ring<P, KPL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(per_sm * sms, (a.U + WARPS - 1) / WARPS);
  kernel<<<grid, BLOCK, smem, a.stream>>>(a.A, a.a_kind, a.L, a.R, a.dL, a.U, a.I, a.K, a.a2);
  return cudaGetLastError();
}

// FUSE: the whole step (L', R' into dL, dR), else the raw deltas.
template <int P, int KPL, bool FUSE>
int launch(const Args& a) {
  cudaError_t err;
  if (FUSE && a.form == RING_FORM) {
    err = launch_ring<P, KPL>(a);
  } else {
    dl_pass<P, KPL, FUSE><<<(a.U + WARPS - 1) / WARPS, BLOCK, 0, a.stream>>>(a.A, a.a_kind, a.L, a.R, a.dL,
                                                                             a.U, a.I, a.K, a.a2);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  // With one chunk the pass writes dR (the caller passes part = dR), or R'.
  dr_pass<P, KPL><<<(a.I * a.S + WARPS - 1) / WARPS, BLOCK, 0, a.stream>>>(
      a.At, a.a_kind, a.L, a.R, a.part, a.U, a.I, a.K, a.chunk, a.S, FUSE && a.S == 1 ? a.dR : nullptr, a.a2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.S > 1) {
    const size_t n = static_cast<size_t>(a.I) * a.K;
    const int grid = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    sum_parts<<<grid, 256, 0, a.stream>>>(a.part, a.dR, n, a.S, a.R, FUSE ? a.dR : nullptr, a.a2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int P, bool FUSE>
int dispatch_k(const Args& a) {
  if (a.K <= 8 * 32) return launch<P, 8, FUSE>(a);
  if (a.K <= 24 * 32) return launch<P, 24, FUSE>(a);
  if (a.K <= 32 * 32) return launch<P, 32, FUSE>(a);
  return cudaErrorInvalidValue;
}

template <bool FUSE>
int dispatch(const Args& a, int precision) {
  switch (precision) {
    case HIGHEST: return dispatch_k<HIGHEST, FUSE>(a);
    case BF16X3: return dispatch_k<BF16X3, FUSE>(a);
    case DEFAULT: return dispatch_k<DEFAULT, FUSE>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// B5: the raw (dL, dR) of one stable-snapshot step (pallas_dense.py:566).
// A (U, I) and At (I, U) hold the same ratings; a_kind: 0 int8 (2x rating),
// 1 bf16, 2 f32.  precision: 0 highest, 1 bf16x3, 2 default.  part is
// (S, I, K) scratch, or dR itself when S == 1.  Returns the first non-zero
// cudaError_t, else 0.  The caller (ops/dense_tiled.py) checks shapes: U, I
// multiples of 128, K a multiple of 32 up to 1024, chunks multiples of 32.
extern "C" int rs_tiled_deltas(const void* A, const void* At, int a_kind, const float* L,
                               const float* R, float* dL, float* dR, float* part, int U, int I,
                               int K, int precision, int chunk, int S, void* stream) {
  if (a_kind < A_INT8 || a_kind > A_F32 || K % 32 != 0 || K <= 0) return cudaErrorInvalidValue;
  const Args a{A, At, a_kind, L, R, dL, dR, part, U, I, K, chunk, S, 0.f, WARP_FORM,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, precision);
}

// The fused step (tiled_gd_step, pallas_dense.py:614): L' = L + a2 * dL into
// Lout and R' = R + a2 * dR into Rout, each product rounded before its sum,
// in three launches (two with one chunk): the L pass, the dR pass and the R
// reduction.  Lout and Rout must not alias L or R (the dR pass reads L while
// the L pass writes Lout).  part is (S, I, K) scratch when S > 1, unused
// otherwise.  form: 0 the warp form of the L pass, 1 the ring form, which
// needs ring_bytes(K, I, a_kind) of shared memory a block.  Other arguments
// as rs_tiled_deltas.
extern "C" int rs_tiled_step(const void* A, const void* At, int a_kind, const float* L, const float* R,
                             float* Lout, float* Rout, float* part, int U, int I, int K, int precision,
                             int chunk, int S, float a2, int form, void* stream) {
  if (a_kind < A_INT8 || a_kind > A_F32 || K % 32 != 0 || K <= 0) return cudaErrorInvalidValue;
  if (form != WARP_FORM && form != RING_FORM) return cudaErrorInvalidValue;
  const Args a{A, At, a_kind, L, R, Lout, Rout, part, U, I, K, chunk, S, a2, form,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, precision);
}
