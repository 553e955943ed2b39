// Tiled dense GD deltas for NVIDIA Hopper (sm_90a): kernel B5.
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
// with no update applied: the caller adds alpha2 * dL (tiled_gd_step :617), or
// first sums the deltas across shards (parallel/step.py:106).
//
// What bounds it on this card.  At gen-inst1e6-100-700-1-3 (U = 1M users,
// I = 100 items, K = 704, 2.0M ratings) the function needs 6*k FLOP per rated
// cell, 8.4 GFLOP, but has to read L (2.8 GB) and write dL (2.8 GB): it is
// bound by HBM bytes (~1.7 ms at 3.35 TB/s), not by operations.  Counted
// densely, as the TPU kernel computes it, the step is 8*U*I*K = 0.72 TFLOP.
//
// What the design does about that.
//  * Rated cells only.  A warp owns one row of the side it sums -- a user row
//    of L in dl_pass, an item row of R in dr_pass -- and holds its K values in
//    registers, K/32 per lane (k = m*32 + lane).  It walks its line of A 32
//    cells at a time (one coalesced load, the next one in flight), ballots the
//    rated cells and visits only those: for each it loads the other side's
//    row, forms pred = L_u . R_i by per-lane sums and a butterfly of shuffles,
//    e = a - pred, and adds e * row to its sums.  An unrated cell costs its
//    byte of A and nothing else, so L is read once per pass plus once per
//    rating, and dL is written once.
//  * E never leaves registers.  Each pass recomputes pred for its cells, as
//    the TPU kernel recomputes E per pass; both passes compute it with the
//    same lane map and shuffle order, so they see the same e bit for bit.
//  * A is read in both orientations: dl_pass walks A (U, I) along items,
//    dr_pass walks A^T (I, U) along users, so every line is contiguous.
//  * dR sums over all users.  dr_pass cuts the users into S chunks, one warp
//    per (item, chunk), enough warps to fill the card, and writes S partial
//    rows; sum_parts adds them in chunk order.  No float atomics: two runs
//    give the same bits.
//  * Precision is a template parameter, with the operand rounding of
//    pallas_dense._dot (:122): HIGHEST is IEEE f32 FMA (never TF32), DEFAULT
//    rounds both operands to bf16 (products exact in f32, f32 sums), BF16X3
//    splits every operand hi + lo and sums (ah*bl + al*bh) + ah*bh.
//  * K/32 values per lane are a template parameter, KPL in {8, 24, 32}, so
//    the rows stay in registers; K is at most 32 * 32 = 1024.
//
// Later work: the update fused into dl_pass, the next rated row's load in
// flight during the current one's dot, and a wgmma/TMA form for dense A.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr int BLOCK = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

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
    for (int m = 0; m < KPL; ++m) {
      const float v = m < nk ? __ldg(p + m * 32 + lane) : 0.f;
      if (P == BF16X3) {
        bsplit(v, h[m], l[m]);
      } else {
        h[m] = P == DEFAULT ? round_bf16(v) : v;
        l[m] = 0.f;
      }
    }
  }
};

// pred = _dot(L_u, R_i) over K: per-lane sums in k order, then a butterfly
// over the lanes (every lane ends with the same sum: a + b == b + a).  BF16X3
// keeps the small terms Lh*Rl + Ll*Rh apart from Lh*Rh until the end, as
// _dot does.  Both passes call it with (L row, R row) in this order.
template <int P, int KPL>
__device__ __forceinline__ float warp_pred(const Row<P, KPL>& lr, const Row<P, KPL>& rr) {
  float sb = 0.f, ss = 0.f;
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    if (P == BF16X3) {
      ss = fmaf(lr.h[m], rr.l[m], ss);
      ss = fmaf(lr.l[m], rr.h[m], ss);
    }
    sb = fmaf(lr.h[m], rr.h[m], sb);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sb += __shfl_xor_sync(FULL, sb, o);
    if (P == BF16X3) ss += __shfl_xor_sync(FULL, ss, o);
  }
  return P == BF16X3 ? ss + sb : sb;
}

// acc += _dot(e, y) for one cell: (yl*eh + yh*el) + yh*eh under BF16X3
// (products of bf16 values are exact in f32, so each fmaf rounds once, like a
// separate add), e*y under HIGHEST, bf16(e)*bf16(y) under DEFAULT.
template <int P, int KPL>
__device__ __forceinline__ void accumulate(float (&acc)[KPL], const Row<P, KPL>& y, float e) {
  if (P == BF16X3) {
    float eh, el;
    bsplit(e, eh, el);
#pragma unroll
    for (int m = 0; m < KPL; ++m) acc[m] += fmaf(y.h[m], eh, fmaf(y.h[m], el, y.l[m] * eh));
  } else {
    const float ee = P == DEFAULT ? round_bf16(e) : e;
#pragma unroll
    for (int m = 0; m < KPL; ++m) acc[m] = fmaf(ee, y.h[m], acc[m]);
  }
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

// _dl_kernel: warp w owns user w and sums dL[w] over all items.
template <int P, int KPL>
__global__ void __launch_bounds__(BLOCK)
    dl_pass(const void* __restrict__ A, int a_kind, const float* __restrict__ L,
            const float* __restrict__ R, float* __restrict__ dL, int U, int I, int K) {
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
  for (int m = 0; m < KPL; ++m)
    if (m < nk) dL[static_cast<size_t>(u) * K + m * 32 + lane] = acc[m];
}

// _dr_kernel: warp w owns item i = w % I and sums dR[i] over user chunk
// s = w / I, into part[s, i].
template <int P, int KPL>
__global__ void __launch_bounds__(BLOCK)
    dr_pass(const void* __restrict__ At, int a_kind, const float* __restrict__ L,
            const float* __restrict__ R, float* __restrict__ part, int U, int I, int K,
            int chunk, int S) {
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
  for (int m = 0; m < KPL; ++m)
    if (m < nk) part[(static_cast<size_t>(s) * I + i) * K + m * 32 + lane] = acc[m];
}

// out = sum_s part[s], chunks in ascending order (deterministic).
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ out, size_t n, int S) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = __ldg(part + idx);
    for (int s = 1; s < S; ++s) v += __ldg(part + static_cast<size_t>(s) * n + idx);
    out[idx] = v;
  }
}

struct Args {
  const void *A, *At;
  int a_kind;
  const float *L, *R;
  float *dL, *dR, *part;
  int U, I, K, chunk, S;
  cudaStream_t stream;
};

template <int P, int KPL>
int deltas(const Args& a) {
  dl_pass<P, KPL><<<(a.U + WARPS - 1) / WARPS, BLOCK, 0, a.stream>>>(a.A, a.a_kind, a.L, a.R,
                                                                     a.dL, a.U, a.I, a.K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // With one chunk the pass writes dR itself (the caller passes part = dR).
  dr_pass<P, KPL><<<(a.I * a.S + WARPS - 1) / WARPS, BLOCK, 0, a.stream>>>(
      a.At, a.a_kind, a.L, a.R, a.part, a.U, a.I, a.K, a.chunk, a.S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.S > 1) {
    const size_t n = static_cast<size_t>(a.I) * a.K;
    const int grid = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    sum_parts<<<grid, 256, 0, a.stream>>>(a.part, a.dR, n, a.S);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int P>
int dispatch_k(const Args& a) {
  if (a.K <= 8 * 32) return deltas<P, 8>(a);
  if (a.K <= 24 * 32) return deltas<P, 24>(a);
  if (a.K <= 32 * 32) return deltas<P, 32>(a);
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
  const Args a{A, At, a_kind, L, R, dL, dR, part, U, I, K, chunk, S,
               static_cast<cudaStream_t>(stream)};
  switch (precision) {
    case HIGHEST: return dispatch_k<HIGHEST>(a);
    case BF16X3: return dispatch_k<BF16X3>(a);
    case DEFAULT: return dispatch_k<DEFAULT>(a);
  }
  return cudaErrorInvalidValue;
}
