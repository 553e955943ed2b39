// Fused dense full-batch GD + masked top-1 for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_dense.py::resident_train_top1
// (:662; bodies _resident_top1_kernel :620 and _resident_kernel :172): all
// `iters` stable-snapshot GD steps on K-major factors, then the masked top-1,
// from ONE host call (rs_resident_sparse_train_top1, B1).  More entries share
// its kernels: rs_resident_sparse_train (B2, pallas_dense.py:238
// resident_train) runs the steps alone, rs_resident_train_top1 and
// rs_resident_train the same in the dense form, and rs_stream_top1 (B4,
// pallas_dense.py:473 stream_top1) the top-1 alone, from factors the stream
// kernel (dense_stream.cu) trained.  Per step, with A^T (I, U) and the
// implicit mask a != 0 (pallas_dense.py module docstring):
//
//     pred^T = Rt^T . Lt                     (I, U), contracting K
//     E^T    = (a != 0) * (a - pred^T)
//     Lt'    = Lt + alpha2 * Rt . E^T        (K, U), contracting items
//     Rt'    = Rt + alpha2 * Lt . E          (K, I), contracting users
//
// both gradients reading the pre-step (Lt, Rt) (matFact.c:38-39).  After the
// loop, B^T = Rt^T . Lt with rated cells and items >= items_true at -inf, and
// a strictly-greater running max from index 0 (lowest-index tie-break,
// matFact.c:17).
//
// Two forms of the steps share this contract and give the same bits.
//
// The dense form (grad_pass + apply_update, rs_resident_train_top1 and
// rs_resident_train; kept as the baseline of probes/resident_sparse.py).
//  * grad_pass: one launch computes both gradient sides.  A thread (or a
//    group of G lanes, for K > 32) owns one output column -- a user column of
//    Lt on the "dl" side, an item column of Rt on the "dr" side -- and keeps
//    that column's factor and gradient sum in registers.  It walks a CHUNK of
//    the other side's columns, staged 32 at a time in shared memory together
//    with the matching A^T tile (dequantised to f32, as _load_at :155 does),
//    recomputes e for each cell, and accumulates e * y.  Splitting the
//    reduction into chunks is what fills the card: ~220 blocks per side at
//    ML100k instead of 8.  Each chunk's sum goes to a partial buffer.
//  * apply_update: sums the partials of each column in fixed chunk order and
//    writes x + alpha2 * sum into the ping-pong buffer.  No atomics, so every
//    run gives the same bits; the next step reads the new buffers.
//  * A lane reads its slice of a staged row as 16-byte loads (slices padded
//    to start in different banks), one load per four FMAs, and the dot
//    runs as four independent partial sums instead of one FMA chain.
//  * A warp whose 32 cells are all unrated skips the gradient work: e is 0
//    there, and adding +-0 to a sum that started at +0 changes no bit.
// What bounds the dense form: the dense work.  At instML100k (K=32, U=1024,
// I=1792, 6.3% of cells rated) a warp of 32 columns finds a rated cell in a
// row 87% of the time, so ~204 M FMA a step run where the rated cells need
// 12.8 M, and each step pays two launches from the C loop.
//
// The sparse form (the engine's: rs_resident_sparse_train, and with the
// dense top-1 behind it rs_resident_sparse_train_top1).  It walks the rated
// cells alone.  An unrated cell adds an exact zero to the dense form's sums
// (fmaf(0, y, acc) == acc while acc is not -0.0, and a sum that starts at
// +0 under round-to-nearest never becomes -0.0; in BF16X3 the split terms
// of a zero are zeros), so a walk that keeps the dense form's chunks and
// the order and grouping of every sum gives its bits while the factors are
// finite:
//  * Units.  A unit is (side, BC-column block, chunk of the other side),
//    the chunks of _split as in the dense form.  Tables built once per A^T
//    by ops/dense_fused.py::walk_tables (torch ops on the card, in the
//    engine's upload phase) list each unit's rated cells by (sub-strip,
//    column, row) with their dequantised values, the offsets of every
//    (sub-strip, column) run, and the unit's columns by degree.
//  * Per sub-strip of SR rows (64, or 32 for K > 32), in one round trip of
//    loads: the other side's rows into shared memory, and the segment's
//    cells (the block's own columns come in a round trip before).  Then
//    (A) pred and e of every cell, G lanes a cell with the dense form's
//    four partial sums over j mod 4 and its xor butterfly, each side with
//    its own operand order (in BF16X3 the two sides' preds may differ, as
//    in the dense form); (B) 4G lanes a column and 8 k a lane, so a block
//    walks half its columns at once (two rounds, the heaviest columns
//    first), each column's cells in row order onto its partial held in
//    registers across the sub-strips.  The unit then writes its (K, BC)
//    partial; an empty column writes +0, so padding stays exactly 0.  The
//    update sums the S partials of each column in ascending chunk order,
//    as apply_update does.
//  * Units go to blocks heaviest first (the tables' unit order): a step
//    lasts as long as its slowest block.
//  * Taken from B3's sparse walk (dense_stream.cu, sparse_pass): the
//    sub-strip staging, phases A and B, the degree order of a unit's
//    columns (columns of like degree share a warp's loop), the cell two
//    ahead and the row one ahead loaded during this row's FMAs.  Not taken:
//    its item order and phase C (here the dr side is a unit of its own,
//    walked like the dl side), its clusters, its 4 k a lane (four rounds
//    of chains where two do), and __ldg of the factors, which change
//    within a launch in the persistent form.
//  * Two forms run the same device code.  The loop form (sparse_grad +
//    sparse_update, two launches a step from the C loop) is the engine's
//    (ops/dense_fused.py::ENGINE_FORM): it read faster.  The persistent
//    form (resident_persistent) runs every step in one cooperative launch:
//    a grid sized by cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs
//    so every block is resident (cudaLaunchCooperativeKernel refuses it
//    otherwise, and the wrapper raises), units dealt from a ticket counter,
//    a grid-wide barrier (cooperative_groups), the update over the grid,
//    and a second barrier before the next step reads the new factors.
// What bounds the sparse form: 6 * nnz * k FLOP a step is 0.04 us of the
// f32 peak at instML100k; a step is dependent memory round trips.  Phase
// clocks of an instrumented copy (not in the repo) read ~3,800 cycles for
// one staging round trip of a unit even with one block an SM, against
// ~1,700-2,400 for each of phases A and B; the (S, K, N) partials cost a
// write and a read of 7.3 MB a step at instML100k (the update, ~3-5 us).
// Other designs were held against this one and dropped (PERF.md): a warp
// a column with no partials (one launch a step; each cell waits on its row
// gather), the same with a cp.async ring of rows, and this one with a
// unit's own columns in its first sub-strip's round trip.
//
// The top-1 (B4, rs_stream_top1; B1's and B6's last pass) visits every
// unrated cell, in two forms with the same bits.
//  * Both: the strictly-greater running max of each chunk of items, then
//    top1_reduce's strictly-greater merge of the chunks in ascending order
//    -- equal to one ascending walk over all items.  Precision is a
//    template parameter, with the operand rounding of pallas_dense._dot
//    (:122): HIGHEST is IEEE f32 FMA (never TF32), DEFAULT rounds both
//    operands to bf16 (products exact in f32, f32 sums), BF16X3 splits
//    every operand hi + lo and sums (ah*bl + al*bh) + ah*bh.
//  * The dense form (top1_pass; the B1 dense entry's, and the baseline of
//    probes/top1_tiled.py): the gradient walk above with a running max in
//    place of the sums.  A thread (G lanes for K > 32) owns one user and
//    makes one score an item step: every 4 FMAs wait on one 16-byte load
//    of the item's row, and no value is reused across users in registers.
//  * The tiled form (top1_tiled; the engine's, behind B1's sparse entry,
//    B4 and B6): a block owns 64 users and walks its item chunk in tiles
//    of 64 items (32 in BF16X3 or for K > 64), each tile's Rt slice and A
//    tile (as stored) coming in by cp.async while the previous tile is
//    used, the block's Lt staged once.  A thread holds a 4 x 4 (or 4 x 2)
//    micro-tile of scores, so each staged value feeds four FMAs.  A score
//    keeps the dense form's bits: per 32-k slice the four fmaf chains by
//    j mod 4 in ascending j, combined (c0 + c1) + (c2 + c3), then the G
//    slices in the xor butterfly's tree (pairs G/2 apart first: the slices
//    come in bit-reversed order and a binary counter of partial sums merges
//    them); padding k adds exact zeros to sums that never reach -0.0, so
//    skipping it keeps every bit.  DEFAULT's and BF16X3's rounded operands
//    come from one elementwise pass (top1_operands).  A thread's running
//    (best, index) advances on a strictly greater score over ascending
//    items, reading the A tile only where a score beats it; the 16 threads
//    of a user merge by (higher score, then lower index), which is the
//    ascending walk's answer for any order of the merge.
// What bounds the top-1: 2 * K FLOP per (user, item), 1.56 GFLOP at
// gen-instML1M, 23 us at the f32 CUDA-core peak; its bytes (A^T once, 24.4
// MB in int8) take 7.3 us.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;      // factor values each lane holds (lane g holds k = g*KC + j)
constexpr int SEG = KC + 4; // a lane's K slice in a staged row, padded so the G slices
                            // of one row start in different banks (16-byte loads)
constexpr int BLOCK = 128;  // threads per block
constexpr int BR = 32;      // reduction columns per shared-memory tile
static_assert(BLOCK == 1 << 7, "walk() shifts by log2(BLOCK) = 7");
constexpr unsigned FULL = 0xffffffffu;

enum Prec { HIGHEST = 0, BF16X3 = 1, DEFAULT = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _bsplit (pallas_dense.py:107): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void bsplit(float x, float& hi, float& lo) {
  hi = round_bf16(x);
  lo = round_bf16(x - hi);
}

// _load_at (pallas_dense.py:155): int8 holds 2x the rating, x0.5 is exact.
__device__ __forceinline__ float load_a(const int8_t* p) {
  return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p))) * 0.5f;
}
__device__ __forceinline__ float load_a(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float load_a(const float* p) { return __ldg(p); }

// One side of the problem: the pass owns the N columns of X (K, N) and
// reduces over the M columns of Y (K, M), chunk columns per block.
struct Side {
  const float* X;
  const float* Y;
  int N;
  int M;
  int own_major;  // 1: A(c, r) = At[c*M + r] (own = items); 0: At[r*N + c] (own = users)
  int chunk;
  int S;
  float* part;  // (S, K, N) partial gradient sums
};

__host__ __device__ __forceinline__ int side_blocks(const Side& s, int lg) {
  return (s.N / (BLOCK >> lg)) * s.S;
}

// Field by field, so the chosen side lives in registers (a select of the
// whole struct puts both in local memory).
__device__ __forceinline__ Side pick(bool left, const Side& a, const Side& b) {
  Side s;
  s.X = left ? a.X : b.X;
  s.Y = left ? a.Y : b.Y;
  s.N = left ? a.N : b.N;
  s.M = left ? a.M : b.M;
  s.own_major = left ? a.own_major : b.own_major;
  s.chunk = left ? a.chunk : b.chunk;
  s.S = left ? a.S : b.S;
  s.part = left ? a.part : b.part;
  return s;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int lg, int prec) {
  const int G = 1 << lg, BC = BLOCK >> lg;
  const int nsplit = prec == BF16X3 ? 2 : 1;
  return sizeof(float) * (static_cast<size_t>(nsplit) * BR * G * SEG + BR * (BC + 1));
}

// The walk shared by the gradient and top-1 passes.  TOP1 = false: returns
// the chunk's gradient sums in acc.  TOP1 = true: returns the chunk's
// masked running max in best / best_i.  G = 2^lg lanes share a column; the
// staging index math is shifts (a runtime division costs ~60 instructions).
template <typename T, int P, bool TOP1>
__device__ __forceinline__ void walk(const T* __restrict__ At, const Side sd, int K, int lg,
                                     int bid, int items_true, float (&acc)[KC], float& best,
                                     int& best_i) {
  extern __shared__ float smem[];
  const int G = 1 << lg, lbc = 7 - lg;  // BLOCK = 128 = 2^7
  const int KP = KC * G, YS = G * SEG, BC = BLOCK >> lg, AS = BC + 1;
  float* sy_h = smem;
  float* sy_l = smem + BR * YS;  // BF16X3 only
  float* sa = smem + (P == BF16X3 ? 2 : 1) * BR * YS;

  const int ncb = sd.N / BC;
  const int cb = bid % ncb, s = bid / ncb;
  const int c0 = cb * BC;
  const int r_begin = s * sd.chunk;
  const int r_end = min(sd.M, r_begin + sd.chunk);
  const int t = threadIdx.x;
  const int cl = t >> lg, g = t & (G - 1);
  const int c = c0 + cl;

  float xh[KC], xl[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = g * KC + j;
    const float v = k < K ? __ldg(sd.X + static_cast<size_t>(k) * sd.N + c) : 0.f;
    if (P == BF16X3) {
      bsplit(v, xh[j], xl[j]);
    } else {
      xh[j] = P == DEFAULT ? round_bf16(v) : v;
      xl[j] = 0.f;
    }
    acc[j] = 0.f;
  }
  best = -INFINITY;
  best_i = 0;

  for (int r0 = r_begin; r0 < r_end; r0 += BR) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = t; idx < KP * BR; idx += BLOCK) {
      const int k = idx / BR, r = idx % BR;
      const float v = k < K ? __ldg(sd.Y + static_cast<size_t>(k) * sd.M + r0 + r) : 0.f;
      const int at = r * YS + (k / KC) * SEG + k % KC;
      if (P == BF16X3) {
        bsplit(v, sy_h[at], sy_l[at]);
      } else {
        sy_h[at] = P == DEFAULT ? round_bf16(v) : v;
      }
    }
    if (sd.own_major) {  // A(c, r) = At[c*M + r]: contiguous along r
      for (int idx = t; idx < BR * BC; idx += BLOCK) {
        const int cc = idx / BR, r = idx % BR;
        sa[r * AS + cc] = load_a(At + static_cast<size_t>(c0 + cc) * sd.M + r0 + r);
      }
    } else {  // A(c, r) = At[r*N + c]: contiguous along c
      for (int idx = t; idx < BR * BC; idx += BLOCK) {
        const int r = idx >> lbc, cc = idx & (BC - 1);
        sa[r * AS + cc] = load_a(At + static_cast<size_t>(r0 + r) * sd.N + c0 + cc);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BR; ++r) {
      const float a = sa[r * AS + cl];
      if (!TOP1 && !__any_sync(FULL, a != 0.f)) continue;  // warp-uniform: e = 0 everywhere
      const float4* yh4 = reinterpret_cast<const float4*>(sy_h + r * YS + g * SEG);
      const float4* yl4 = reinterpret_cast<const float4*>(sy_l + r * YS + g * SEG);
      float yh[KC], yl[KC];
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 h = yh4[q];
        yh[4 * q] = h.x, yh[4 * q + 1] = h.y, yh[4 * q + 2] = h.z, yh[4 * q + 3] = h.w;
        if (P == BF16X3) {
          const float4 l = yl4[q];
          yl[4 * q] = l.x, yl[4 * q + 1] = l.y, yl[4 * q + 2] = l.z, yl[4 * q + 3] = l.w;
        }
      }
      // pred = _dot(rt, lt): the Y operand plays `a`, X plays `b`.  Four
      // independent partial sums keep the FMA pipes busy.
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (P == BF16X3) {
          ps[j % 4] = fmaf(yh[j], xl[j], ps[j % 4]);
          ps[j % 4] = fmaf(yl[j], xh[j], ps[j % 4]);
        }
        pb[j % 4] = fmaf(yh[j], xh[j], pb[j % 4]);
      }
      float sb = (pb[0] + pb[1]) + (pb[2] + pb[3]);
      float ss = (ps[0] + ps[1]) + (ps[2] + ps[3]);
      for (int o = G >> 1; o > 0; o >>= 1) {
        sb += __shfl_xor_sync(FULL, sb, o);
        if (P == BF16X3) ss += __shfl_xor_sync(FULL, ss, o);
      }
      const float pred = P == BF16X3 ? ss + sb : sb;
      if (TOP1) {
        const int i = r0 + r;
        if (a == 0.f && i < items_true && pred > best) {
          best = pred;
          best_i = i;
        }
        continue;
      }
      const float e = a != 0.f ? a - pred : 0.f;
      // d = _dot(y, e): (yh*el + yl*eh) + yh*eh.  Products of bf16 values
      // are exact in f32, so each fmaf rounds once, like a separate add.
      if (P == BF16X3) {
        float eh, el;
        bsplit(e, eh, el);
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] += fmaf(yh[j], eh, fmaf(yh[j], el, yl[j] * eh));
      } else {
        const float ee = P == DEFAULT ? round_bf16(e) : e;
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = fmaf(ee, yh[j], acc[j]);
      }
    }
  }
}

// highest/default fit 128 registers without spilling, which buys a 4th block
// per SM; bf16x3 holds twice the operands and spills if capped.
template <typename T, int P>
__global__ void __launch_bounds__(BLOCK, P == BF16X3 ? 1 : 4)
    grad_pass(const T* __restrict__ At, Side sl, Side sr, int K, int lg) {
  const int nbl = side_blocks(sl, lg);
  const bool left = static_cast<int>(blockIdx.x) < nbl;
  const Side sd = pick(left, sl, sr);
  const int bid = left ? blockIdx.x : blockIdx.x - nbl;
  float acc[KC];
  float best;
  int best_i;
  walk<T, P, false>(At, sd, K, lg, bid, 0, acc, best, best_i);
  const int BC = BLOCK >> lg, ncb = sd.N / BC;
  const int c = (bid % ncb) * BC + (threadIdx.x >> lg), g = threadIdx.x & ((1 << lg) - 1);
  const int s = bid / ncb;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = g * KC + j;
    if (k < K) sd.part[(static_cast<size_t>(s) * K + k) * sd.N + c] = acc[j];
  }
}

// x' = x + alpha2 * sum_s part[s], both sides in one launch, chunks summed
// in ascending order (deterministic).
__global__ void apply_update(Side sl, Side sr, const float* __restrict__ xl_cur,
                             const float* __restrict__ xr_cur, float* __restrict__ xl_nxt,
                             float* __restrict__ xr_nxt, int K, float alpha2) {
  const size_t nl = static_cast<size_t>(K) * sl.N, nr = static_cast<size_t>(K) * sr.N;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < nl + nr;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const bool left = idx < nl;
    const size_t i = left ? idx : idx - nl;
    const size_t n = left ? nl : nr;
    const float* part = left ? sl.part : sr.part;
    const int S = left ? sl.S : sr.S;
    float sum = __ldg(part + i);
    for (int s = 1; s < S; ++s) sum += __ldg(part + static_cast<size_t>(s) * n + i);
    const float x = __ldg((left ? xl_cur : xr_cur) + i);
    (left ? xl_nxt : xr_nxt)[i] = __fadd_rn(x, __fmul_rn(alpha2, sum));
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(BLOCK) top1_pass(const T* __restrict__ At, Side sd, int K,
                                                   int lg, int items_true, float* __restrict__ pval,
                                                   int* __restrict__ pidx) {
  float acc[KC];
  float best;
  int best_i;
  walk<T, P, true>(At, sd, K, lg, blockIdx.x, items_true, acc, best, best_i);
  const int BC = BLOCK >> lg, ncb = sd.N / BC;
  const int c = (blockIdx.x % ncb) * BC + (threadIdx.x >> lg), s = blockIdx.x / ncb;
  if ((threadIdx.x & ((1 << lg) - 1)) == 0) {
    pval[static_cast<size_t>(s) * sd.N + c] = best;
    pidx[static_cast<size_t>(s) * sd.N + c] = best_i;
  }
}

// Both forms' merge: the chunks' (best, index) in ascending chunk order,
// strictly greater; `best_out` (may be null) takes each column's best score.
__global__ void top1_reduce(const float* __restrict__ pval, const int* __restrict__ pidx, int S,
                            int N, int* __restrict__ top1, float* __restrict__ best_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float best = -INFINITY;
  int bi = 0;
  for (int s = 0; s < S; ++s) {
    const float v = pval[static_cast<size_t>(s) * N + c];
    if (v > best) {
      best = v;
      bi = pidx[static_cast<size_t>(s) * N + c];
    }
  }
  top1[c] = bi;
  if (best_out != nullptr) best_out[c] = best;
}

// ---------------------------------------------------------------------------
// B4's tiled form (top1_tiled, then top1_reduce): the engine's top-1.

constexpr int TBLOCK = 256;   // threads of top1_tiled: 16 x 16 micro-tiles
constexpr int TU = 4;         // users a thread
constexpr int TBU = 16 * TU;  // users a block
constexpr int TBI_MAX = 64;   // items of a block's tile, at most: chunks are multiples of it
constexpr int TMINB = 2;      // blocks an SM at least (__launch_bounds__): at most 128 registers

// A thread's TU x TI cells; TI = 2 where BF16X3's second chain or the
// slices' tree (G >= 4) would hold too many sums in registers.  Shared
// memory holds NS (hi, and lo in BF16X3) slices of KC rows of X (TBU users)
// and Y (BI items), two stages, and two A tiles (BI, TBU) as stored.
template <int P, int G>
struct TopTile {
  static constexpr int TI = (P == BF16X3 || G >= 4) ? 2 : 4;
  static constexpr int BI = 16 * TI;
  static constexpr int NS = P == BF16X3 ? 2 : 1;
  static constexpr int SX = NS * KC * TBU;
  static constexpr int SY = NS * KC * BI;
  static constexpr int STAGE = (G == 1 ? 0 : SX) + SY;  // G == 1: X is staged once
  static constexpr int LG = G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : 3;
};

template <int P, int G>
size_t tiled_smem_bytes(int esz) {
  using S = TopTile<P, G>;
  return sizeof(float) * ((G == 1 ? S::SX : 0) + 2 * static_cast<size_t>(S::STAGE)) +
         2 * static_cast<size_t>(S::BI) * TBU * esz;
}

// The tiled form's operands: X = Lt (K, U) and Y = Rt (K, I) as the dot
// reads them: the factors themselves in HIGHEST; in DEFAULT their bf16
// roundings and in BF16X3 their hi and lo parts, from top1_operands.
struct TopOps {
  const float *xh, *xl, *yh, *yl;
};

// ops: hi of Lt then Rt, and in BF16X3 lo of Lt then Rt.
template <int P>
__global__ void top1_operands(const float* __restrict__ Lt, size_t nl, const float* __restrict__ Rt,
                              size_t nr, float* __restrict__ ops) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < nl + nr;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float v = idx < nl ? __ldg(Lt + idx) : __ldg(Rt + idx - nl);
    if (P == BF16X3) {
      bsplit(v, ops[idx], ops[nl + nr + idx]);
    } else {
      ops[idx] = round_bf16(v);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// `rows` rows of W floats from src (row stride ld) to dst (row stride W).
template <int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t ld, int rows) {
  constexpr int PER = W / 4;  // 16-byte copies a row
  for (int idx = threadIdx.x; idx < rows * PER; idx += TBLOCK) {
    const int r = idx / PER, c = idx - r * PER;
    cp_async16(dst + r * W + 4 * c, src + r * ld + 4 * c);
  }
}

// N (even) consecutive floats of shared memory, 16 bytes a load.
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
  }
  if constexpr (N % 4 == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p + N - 2);
    v[N - 2] = f.x, v[N - 1] = f.y;
  }
}

// One fmaf chain of the thread's cells: k = m, m + 4, ... of the slice
// (nt steps, ascending), from +0; pb the hi*hi chain, ps in BF16X3 the
// cross terms (yh*xl then yl*xh), as walk() forms them.
template <int P, int TI, int BI>
__device__ __forceinline__ void top_chain(const float* xh, const float* xl, const float* yh, const float* yl,
                                          int m, int nt, float (&pb)[TU][TI], float (&ps)[TU][TI]) {
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int i = 0; i < TI; ++i) pb[u][i] = ps[u][i] = 0.f;
#pragma unroll
  for (int s = 0; s < KC / 4; ++s) {
    if (s < nt) {
      const int k = m + 4 * s;
      float x[TU], y[TI], xlo[TU], ylo[TI];
      lds(x, xh + k * TBU);
      lds(y, yh + k * BI);
      if (P == BF16X3) {
        lds(xlo, xl + k * TBU);
        lds(ylo, yl + k * BI);
      }
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          if (P == BF16X3) {
            ps[u][i] = fmaf(y[i], xlo[u], ps[u][i]);
            ps[u][i] = fmaf(ylo[i], x[u], ps[u][i]);
          }
          pb[u][i] = fmaf(y[i], x[u], pb[u][i]);
        }
    }
  }
}

template <int TI>
__device__ __forceinline__ void add_to(float (&a)[TU][TI], const float (&b)[TU][TI]) {
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int i = 0; i < TI; ++i) a[u][i] = a[u][i] + b[u][i];
}

// A slice's sums: the four chains by j mod 4 as (c0 + c1) + (c2 + c3).
template <int P, int TI, int BI>
__device__ __forceinline__ void slice_sums(const float* xh, const float* xl, const float* yh, const float* yl,
                                           int nt, float (&sb)[TU][TI], float (&ss)[TU][TI]) {
  float b[TU][TI], bs[TU][TI], c[TU][TI], cs[TU][TI];
  top_chain<P, TI, BI>(xh, xl, yh, yl, 0, nt, sb, ss);
  top_chain<P, TI, BI>(xh, xl, yh, yl, 1, nt, b, bs);
  add_to(sb, b);
  if (P == BF16X3) add_to(ss, bs);
  top_chain<P, TI, BI>(xh, xl, yh, yl, 2, nt, b, bs);
  top_chain<P, TI, BI>(xh, xl, yh, yl, 3, nt, c, cs);
  add_to(b, c);
  add_to(sb, b);
  if (P == BF16X3) {
    add_to(bs, cs);
    add_to(ss, bs);
  }
}

// The stored A values of a thread's TU users at one item: rated or not
// (a != 0 on the dequantised value is a != +-0 on the stored one).
__device__ __forceinline__ void rated(const unsigned char* p, int lesz, bool (&r)[TU]) {
#pragma unroll
  for (int g = 0; g < TU / 4; ++g) {  // four users a load
    const unsigned char* q = p + ((4 * g) << lesz);
    bool* rg = r + 4 * g;
    if (lesz == 0) {
      const unsigned v = *reinterpret_cast<const unsigned*>(q);
      rg[0] = v & 0xffu, rg[1] = (v >> 8) & 0xffu, rg[2] = (v >> 16) & 0xffu, rg[3] = v >> 24;
    } else if (lesz == 1) {
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      rg[0] = v.x & 0x7fffu, rg[1] = (v.x >> 16) & 0x7fffu, rg[2] = v.y & 0x7fffu, rg[3] = (v.y >> 16) & 0x7fffu;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(q);
      rg[0] = v.x & 0x7fffffffu, rg[1] = v.y & 0x7fffffffu, rg[2] = v.z & 0x7fffffffu, rg[3] = v.w & 0x7fffffffu;
    }
  }
}

__device__ __forceinline__ bool takes(float v, int i, float best, int best_i) {
  return v > best || (v == best && i < best_i);
}

// The masked top-1 of a chunk of items for a block of TBU users.  Thread
// (tx, ty) owns users ty*TU + [0, TU) and, in each item tile of BI, items
// tx*TI + [0, TI); a warp is 8 tx x 4 ty, so each staged X and Y value
// reaches several threads in one load.  Per tile, the G slices of K (in
// the order of the xor butterfly's tree) pass through the two stages.
template <int P, int G>
__global__ void __launch_bounds__(TBLOCK, TMINB)
    top1_tiled(const unsigned char* __restrict__ At, int lesz, TopOps op, int K, int U, int I,
               int items_true, int chunk, float* __restrict__ pval, int* __restrict__ pidx) {
  using S = TopTile<P, G>;
  constexpr int TI = S::TI, BI = S::BI, LG = S::LG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xres = reinterpret_cast<float*>(smem_raw);  // G == 1: X, staged once
  float* stages = xres + (G == 1 ? S::SX : 0);
  unsigned char* sa = reinterpret_cast<unsigned char*>(stages + 2 * S::STAGE);
  const int arow = TBU << lesz;  // bytes of an A tile row

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tx = (w & 1) * 8 + (lane & 7), ty = (w >> 1) * 4 + (lane >> 3);
  const int u0 = blockIdx.x * TBU;
  const int i_begin = blockIdx.y * chunk, i_end = min(I, i_begin + chunk);
  const int nq = (i_end - i_begin) / BI * G;  // stages: (tile, slice)

  // Stage q: slice n = q mod G of tile q / G, and with slice 0 the tile's A.
  auto issue = [&](int q) {
    const int j = q >> LG, n = q & (G - 1);
    const int kb = (LG == 0 ? 0 : __brev(n) >> (32 - LG)) * KC, nk = min(KC, K - kb);
    const int i0 = i_begin + j * BI;
    float* st = stages + (q & 1) * S::STAGE;
    if (nk > 0) {
      float* sy = st + (G == 1 ? 0 : S::SX);
      if (G > 1) stage_rows<TBU>(st, op.xh + static_cast<size_t>(kb) * U + u0, U, nk);
      stage_rows<BI>(sy, op.yh + static_cast<size_t>(kb) * I + i0, I, nk);
      if (P == BF16X3) {
        if (G > 1) stage_rows<TBU>(st + KC * TBU, op.xl + static_cast<size_t>(kb) * U + u0, U, nk);
        stage_rows<BI>(sy + KC * BI, op.yl + static_cast<size_t>(kb) * I + i0, I, nk);
      }
    }
    if (n == 0) {
      unsigned char* dst = sa + (j & 1) * BI * arow;
      const unsigned char* src = At + (static_cast<size_t>(i0) * U + u0) * (1u << lesz);
      const int per = arow >> 4;  // 16-byte copies a row
      for (int idx = t; idx < BI * per; idx += TBLOCK) {
        const int r = idx / per, c = idx - r * per;
        cp_async16(dst + r * arow + 16 * c, src + static_cast<size_t>(r) * (static_cast<size_t>(U) << lesz) + 16 * c);
      }
    }
  };

  float best[TU];
  int best_i[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) best[u] = -INFINITY, best_i[u] = 0;
  float stk_b[LG > 0 ? LG : 1][TU][TI], stk_s[LG > 0 ? LG : 1][TU][TI];  // the tree's pending sums

  if (G == 1) {
    stage_rows<TBU>(xres, op.xh + u0, U, min(KC, K));
    if (P == BF16X3) stage_rows<TBU>(xres + KC * TBU, op.xl + u0, U, min(KC, K));
  }
  if (nq > 0) issue(0);
  cp_async_commit();
  for (int q0 = 0; q0 < nq; q0 += G) {
    const int j = q0 >> LG, i0 = i_begin + j * BI;
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int q = q0 + n;
      if (q + 1 < nq) issue(q + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const float* st = stages + (q & 1) * S::STAGE;
      const float* sx = G == 1 ? xres : st;
      const float* sy = st + (G == 1 ? 0 : S::SX);
      const int kb = (LG == 0 ? 0 : __brev(n) >> (32 - LG)) * KC, nk = min(KC, K - kb);
      float sb[TU][TI], ss[TU][TI];
      slice_sums<P, TI, BI>(sx + ty * TU, sx + KC * TBU + ty * TU, sy + tx * TI, sy + KC * BI + tx * TI,
                            nk > 0 ? nk / 4 : 0, sb, ss);
      // Leaf n of the tree: pairs G/2 apart first, so a binary counter
      // over the slices in bit-reversed order merges them as the
      // butterfly does.
      bool carry = true;
#pragma unroll
      for (int lv = 0; lv < LG; ++lv) {
        if (carry && ((n >> lv) & 1)) {
          add_to(sb, stk_b[lv]);
          if (P == BF16X3) add_to(ss, stk_s[lv]);
        } else if (carry) {
#pragma unroll
          for (int u = 0; u < TU; ++u)
#pragma unroll
            for (int i = 0; i < TI; ++i) stk_b[lv][u][i] = sb[u][i], stk_s[lv][u][i] = ss[u][i];
          carry = false;
        }
      }
      if (n == G - 1) {  // the tile's scores: mask, then the running max over ascending items
        const unsigned char* at = sa + (j & 1) * BI * arow + (tx * TI) * arow + ((ty * TU) << lesz);
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int item = i0 + tx * TI + i;
          float v[TU];
          bool any = false;
#pragma unroll
          for (int u = 0; u < TU; ++u) {
            v[u] = P == BF16X3 ? ss[u][i] + sb[u][i] : sb[u][i];
            any |= v[u] > best[u];
          }
          if (any && item < items_true) {  // A is read only where a score could win
            bool r[TU];
            rated(at + i * arow, lesz, r);
#pragma unroll
            for (int u = 0; u < TU; ++u)
              if (!r[u] && v[u] > best[u]) best[u] = v[u], best_i[u] = item;
          }
        }
      }
      __syncthreads();  // stage q (and at a tile's end its A) is consumed
    }
  }

  // Merge the 16 threads of a user row: lowest index among equal bests.
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, best[u], o);
      const int oi = __shfl_xor_sync(FULL, best_i[u], o);
      if (takes(ov, oi, best[u], best_i[u])) best[u] = ov, best_i[u] = oi;
    }
  float* rv = reinterpret_cast<float*>(smem_raw);
  int* ri = reinterpret_cast<int*>(rv + TBU);
  if ((w & 1) && (lane & 7) == 0) {
#pragma unroll
    for (int u = 0; u < TU; ++u) rv[ty * TU + u] = best[u], ri[ty * TU + u] = best_i[u];
  }
  __syncthreads();
  if (!(w & 1) && (lane & 7) == 0) {
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const int c = ty * TU + u;
      if (takes(rv[c], ri[c], best[u], best_i[u])) best[u] = rv[c], best_i[u] = ri[c];
      pval[static_cast<size_t>(blockIdx.y) * U + u0 + c] = best[u];
      pidx[static_cast<size_t>(blockIdx.y) * U + u0 + c] = best_i[u];
    }
  }
}

struct Args {
  const void* At;
  const float *Lt_in, *Rt_in;
  float *Lt_out, *Rt_out, *Lt_tmp, *Rt_tmp;
  float *part_l, *part_r, *top_val;
  int *top_idx, *top1;
  int K, U, I, G, iters, items_true;
  float alpha2;
  int chunk_l, s_l, chunk_r, s_r;
  cudaStream_t stream;
  float* top_ops;   // the tiled top-1's operands: K * (U + I) floats in DEFAULT, twice that in BF16X3
  float* top_best;  // each user's best score, or null
  int top_form;     // the top-1's form: DENSE_TOP1 or TILED_TOP1
};

enum TopForm { DENSE_TOP1 = 0, TILED_TOP1 = 1 };

int log2_lanes(int G) {
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  return lg;
}

// `iters` GD steps from (Lt_in, Rt_in); the last step lands in (Lt_out,
// Rt_out).  iters == 0 copies the inputs there.
template <typename T, int P>
int train(const Args& a) {
  const T* At = static_cast<const T*>(a.At);
  const int lg = log2_lanes(a.G);
  const size_t smem = smem_bytes(lg, P);
  cudaError_t err = cudaFuncSetAttribute(grad_pass<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t nl = static_cast<size_t>(a.K) * a.U, nr = static_cast<size_t>(a.K) * a.I;
  const int apply_grid = static_cast<int>(std::min<size_t>((nl + nr + 255) / 256, 4096));
  const float* lc = a.Lt_in;
  const float* rc = a.Rt_in;
  for (int it = 0; it < a.iters; ++it) {
    // The last step lands in the output buffers.
    const bool to_out = (a.iters - 1 - it) % 2 == 0;
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rt_out : a.Rt_tmp;
    Side sl{lc, rc, a.U, a.I, 0, a.chunk_l, a.s_l, a.part_l};
    Side sr{rc, lc, a.I, a.U, 1, a.chunk_r, a.s_r, a.part_r};
    grad_pass<T, P><<<side_blocks(sl, lg) + side_blocks(sr, lg), BLOCK, smem, a.stream>>>(
        At, sl, sr, a.K, lg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    apply_update<<<apply_grid, 256, 0, a.stream>>>(sl, sr, lc, rc, ln, rn, a.K, a.alpha2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lc = ln;
    rc = rn;
  }
  if (a.iters == 0) {
    err = cudaMemcpyAsync(a.Lt_out, a.Lt_in, nl * sizeof(float), cudaMemcpyDeviceToDevice,
                          a.stream);
    if (err != cudaSuccess) return err;
    err = cudaMemcpyAsync(a.Rt_out, a.Rt_in, nr * sizeof(float), cudaMemcpyDeviceToDevice,
                          a.stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// A kernel's dynamic shared memory limit, raised once per kernel and size,
// so a top-1 captured into a CUDA graph (probes/top1_tiled.py times it so)
// makes no call outside the stream.
template <auto Kernel>
cudaError_t raise_smem(size_t smem) {
  static size_t done = 0;
  if (smem <= done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) done = smem;
  return err;
}

// The tiled top-1 over item chunks (chunk_l, s_l), multiples of TBI_MAX.
template <int P, int G>
int top1_tiled_run(const Args& a, const float* Lt, const float* Rt, int lesz) {
  if (a.U % TBU || a.I % TBI_MAX || a.chunk_l <= 0 || a.chunk_l % TBI_MAX ||
      a.s_l != (a.I + a.chunk_l - 1) / a.chunk_l || a.K > KC * G)
    return cudaErrorInvalidValue;
  cudaError_t err;
  TopOps op{Lt, nullptr, Rt, nullptr};
  const size_t nl = static_cast<size_t>(a.K) * a.U, nr = static_cast<size_t>(a.K) * a.I;
  if (P != HIGHEST) {
    if (a.top_ops == nullptr) return cudaErrorInvalidValue;
    top1_operands<P><<<static_cast<int>(std::min<size_t>((nl + nr + 255) / 256, 4096)), 256, 0, a.stream>>>(
        Lt, nl, Rt, nr, a.top_ops);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const bool lo = P == BF16X3;
    op = {a.top_ops, lo ? a.top_ops + nl + nr : nullptr, a.top_ops + nl, lo ? a.top_ops + 2 * nl + nr : nullptr};
  }
  const size_t smem = tiled_smem_bytes<P, G>(1 << lesz);
  if ((err = raise_smem<top1_tiled<P, G>>(smem)) != cudaSuccess) return err;
  top1_tiled<P, G><<<dim3(a.U / TBU, a.s_l), TBLOCK, smem, a.stream>>>(
      static_cast<const unsigned char*>(a.At), lesz, op, a.K, a.U, a.I, a.items_true, a.chunk_l, a.top_val,
      a.top_idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  top1_reduce<<<(a.U + 255) / 256, 256, 0, a.stream>>>(a.top_val, a.top_idx, a.s_l, a.U, a.top1, a.top_best);
  return cudaGetLastError();
}

// The masked top-1 from the factors (Lt, Rt), walking the items in the dl
// side's chunks (chunk_l, s_l): the dense form, or the tiled form.
template <typename T, int P>
int top1(const Args& a, const float* Lt, const float* Rt) {
  if (a.top_form == TILED_TOP1) {
    const int lesz = sizeof(T) == 1 ? 0 : sizeof(T) == 2 ? 1 : 2;
    switch (a.G) {
      case 1: return top1_tiled_run<P, 1>(a, Lt, Rt, lesz);
      case 2: return top1_tiled_run<P, 2>(a, Lt, Rt, lesz);
      case 4: return top1_tiled_run<P, 4>(a, Lt, Rt, lesz);
      case 8: return top1_tiled_run<P, 8>(a, Lt, Rt, lesz);
    }
    return cudaErrorInvalidValue;
  }
  if (a.top_form != DENSE_TOP1) return cudaErrorInvalidValue;
  const T* At = static_cast<const T*>(a.At);
  const int lg = log2_lanes(a.G);
  const size_t smem = smem_bytes(lg, P);
  cudaError_t err = raise_smem<top1_pass<T, P>>(smem);
  if (err != cudaSuccess) return err;
  Side st{Lt, Rt, a.U, a.I, 0, a.chunk_l, a.s_l, nullptr};
  top1_pass<T, P><<<side_blocks(st, lg), BLOCK, smem, a.stream>>>(
      At, st, a.K, lg, a.items_true, a.top_val, a.top_idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  top1_reduce<<<(a.U + 255) / 256, 256, 0, a.stream>>>(a.top_val, a.top_idx, a.s_l, a.U, a.top1, a.top_best);
  return cudaGetLastError();
}

enum Job { TRAIN_TOP1 = 0, TRAIN = 1, TOP1 = 2 };

template <typename T, int P>
int run(const Args& a, int job) {
  if (job != TOP1) {
    const int err = train<T, P>(a);
    if (err != cudaSuccess || job == TRAIN) return err;
    return top1<T, P>(a, a.Lt_out, a.Rt_out);
  }
  return top1<T, P>(a, a.Lt_in, a.Rt_in);
}

template <typename T>
int run_prec(const Args& a, int precision, int job) {
  switch (precision) {
    case HIGHEST: return run<T, HIGHEST>(a, job);
    case BF16X3: return run<T, BF16X3>(a, job);
    case DEFAULT: return run<T, DEFAULT>(a, job);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const Args& a, int a_kind, int precision, int job) {
  switch (a_kind) {
    case 0: return run_prec<int8_t>(a, precision, job);
    case 1: return run_prec<__nv_bfloat16>(a, precision, job);
    case 2: return run_prec<float>(a, precision, job);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The sparse form.

constexpr int SBLOCK = 256;  // threads per block of the sparse passes
constexpr int SWARPS = SBLOCK / 32;
constexpr int UNIT_COLS = 128;  // columns of a unit at G = 1: UNIT_COLS / G, two rounds of phase B
constexpr int CELL_ROW_BITS = 24;  // cell: column within the block << 24 | row within the chunk
constexpr int CELL_ROW_MASK = (1 << CELL_ROW_BITS) - 1;

// One side's walk (ops/dense_fused.py::walk_tables).  A unit is (chunk s,
// column block cb), unit = s * (N / BC) + cb; a segment is (unit, sub-strip).
struct SideWalk {
  const int* cell;   // by (segment, column, row): column within the block << 24 | row within the chunk
  const float* val;  // the dequantised rating, same order
  const int* off;    // (segment, column) -> first cell; units * nsub * BC + 1
  const int* order;  // (unit, i) -> the unit's i-th column by descending degree
};

// One gradient side: it owns the N columns of X (K, N) and reduces over the
// M columns of Y (K, M) in S chunks of `chunk`, as the dense form's Side.
struct SSide {
  SideWalk w;
  int N, M, chunk, S;
  float* part;  // (S, K, N)
};

// Everything the sparse steps take, by value, in both forms.
struct SArgs {
  SSide l, r;  // l: the dl side (own users), r: the dr side (own items)
  const int* units;  // every unit of both sides (the dl side's first), by descending cell count
  int* tickets;      // two zeroed counters: the persistent form deals units from them
  const float *Lt_in, *Rt_in;
  float *Lt_out, *Rt_out, *Lt_tmp, *Rt_tmp;
  int K, iters, SR, cap;
  float alpha2;
};

__device__ __forceinline__ SSide pick_side(bool left, const SSide& a, const SSide& b) {
  SSide s;
  s.w.cell = left ? a.w.cell : b.w.cell;
  s.w.val = left ? a.w.val : b.w.val;
  s.w.off = left ? a.w.off : b.w.off;
  s.w.order = left ? a.w.order : b.w.order;
  s.N = left ? a.N : b.N;
  s.M = left ? a.M : b.M;
  s.chunk = left ? a.chunk : b.chunk;
  s.S = left ? a.S : b.S;
  s.part = left ? a.part : b.part;
  return s;
}

// Shared memory of a unit, in bytes: the block's X columns (hi, lo), the
// sub-strip's Y rows (hi, lo), the columns by degree (BC), the columns'
// first cells (BC + 1), two segments' bounds (by parity), and per cell of
// the segment, up to `cap`: its cell word and its rating, then its e.
// Rows are G slices of SEG floats, k = g * KC + j at g * SEG + j.
__host__ __device__ __forceinline__ size_t sparse_smem_bytes(int G, int prec, int SR, int cap) {
  const int BC = UNIT_COLS / G, XS = G * SEG;
  const int NS = prec == BF16X3 ? 2 : 1;
  return sizeof(float) * (static_cast<size_t>(NS) * (BC + SR) * XS + 2 * BC + 1 + 4 +
                          2 * static_cast<size_t>(cap));
}

template <int P>
__device__ __forceinline__ void stage(float* hi, float* lo, int at, float v) {
  if (P == BF16X3) {
    bsplit(v, hi[at], lo[at]);
  } else {
    hi[at] = P == DEFAULT ? round_bf16(v) : v;
  }
}

// acc += the product of e and y as walk() forms it in each precision.
template <int P>
__device__ __forceinline__ void add_cell(float& acc, float y_hi, float y_lo, float eh, float el) {
  if (P == BF16X3) {
    acc += fmaf(y_hi, eh, fmaf(y_hi, el, y_lo * eh));
  } else {
    acc = fmaf(y_hi, eh, acc);
  }
}

template <int P>
__device__ __forceinline__ void split_e(float e, float& eh, float& el) {
  if (P == BF16X3) {
    bsplit(e, eh, el);
  } else {
    eh = P == DEFAULT ? round_bf16(e) : e;
    el = 0.f;
  }
}

// One lane's chain over a column's `cnt` cells from position i0 in row
// order, `steps` (the warp's longest) iterations: acc[m] gains e times the
// lane's 8 values of the cell's staged row, at row * xs + lofs.  The cell
// word two ahead, and the row and e one ahead, load during a step.
template <int P>
__device__ __forceinline__ void chain(float (&acc)[8], const int* uc, const float* es, int i0, int cnt,
                                      int steps, int base, int xs, int lofs, const float* rh,
                                      const float* rl) {
  auto row = [&](int c) { return ((c & CELL_ROW_MASK) - base) * xs + lofs; };
  auto load = [&](float4(&h)[2], float4(&l)[2], int at) {
    h[0] = *reinterpret_cast<const float4*>(rh + at);
    h[1] = *reinterpret_cast<const float4*>(rh + at + 4);
    l[0] = P == BF16X3 ? *reinterpret_cast<const float4*>(rl + at) : h[0];
    l[1] = P == BF16X3 ? *reinterpret_cast<const float4*>(rl + at + 4) : h[1];
  };
  int c1 = cnt > 1 ? uc[i0 + 1] : 0;
  float e = cnt > 0 ? es[i0] : 0.f;
  float4 h[2], l[2];
  load(h, l, cnt > 0 ? row(uc[i0]) : lofs);
  for (int s = 0; s < steps; ++s) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 nh[2] = {z, z}, nl[2] = {z, z};
    float en = 0.f;
    if (s + 1 < cnt) {
      en = es[i0 + s + 1];
      load(nh, nl, row(c1));
    }
    const int c2 = s + 2 < cnt ? uc[i0 + s + 2] : 0;
    if (s < cnt) {
      float eh, el;
      split_e<P>(e, eh, el);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        add_cell<P>(acc[4 * v], h[v].x, l[v].x, eh, el);
        add_cell<P>(acc[4 * v + 1], h[v].y, l[v].y, eh, el);
        add_cell<P>(acc[4 * v + 2], h[v].z, l[v].z, eh, el);
        add_cell<P>(acc[4 * v + 3], h[v].w, l[v].w, eh, el);
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      h[v] = nh[v];
      l[v] = nl[v];
    }
    e = en;
    c1 = c2;
  }
}

// One unit's partial: the chunk's gradient sums of the block's BC columns,
// from the rated cells alone, bit for bit walk()'s.  X and Y change within
// the persistent launch, so they are read through L2 (__ldcg), not the
// read-only path; the tables are read-only.
template <int P, int G>
__device__ __forceinline__ void grad_unit(const SSide& sd, const float* __restrict__ X,
                                          const float* __restrict__ Y, int K, int unit, int SR, int cap,
                                          unsigned char* smem_raw) {
  constexpr int BC = UNIT_COLS / G, XS = G * SEG, KP = KC * G;
  constexpr int NS = P == BF16X3 ? 2 : 1;
  // Phase B: LPC lanes a column, 8 k a lane; CPR columns a round, RU rounds.
  constexpr int LPC = 4 * G, CPW = 32 / LPC, CPR = SWARPS * CPW, RU = BC / CPR;
  static_assert(RU * CPR == BC, "phase B covers the block's columns");
  constexpr int SR_MAX = G == 1 ? 64 : 32;  // ops/dense_fused.py::sub_strip
  float* xs_h = reinterpret_cast<float*>(smem_raw);  // X columns (BC, XS)
  float* xs_l = xs_h + BC * XS;                       // BF16X3 only
  float* ys_h = xs_h + NS * BC * XS;                  // Y rows (SR, XS)
  float* ys_l = ys_h + SR * XS;                       // BF16X3 only
  int* ud = reinterpret_cast<int*>(ys_h + NS * SR * XS);  // columns by degree
  int* uo = ud + BC;                                  // columns' first cells, from the segment's
  int* nx = uo + BC + 1;                              // (p0, n) of a segment, two by parity
  int* uc = nx + 4;                                   // cells: column << 24 | row in chunk
  float* es = reinterpret_cast<float*>(uc + cap);     // cells: the rating, then e
  float* tp = xs_h;                                   // the partial (K, BC) at the end

  const int ncb = sd.N / BC;
  const int cb = unit % ncb, s = unit / ncb;
  const int c0 = cb * BC;
  const int r_begin = s * sd.chunk, r_end = min(sd.M, r_begin + sd.chunk);
  const int nsub = (sd.chunk + SR - 1) / SR;  // the tables' stride
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5, cw = lane / LPC, q = lane % LPC;
  const int lofs = (q >> 2) * SEG + (q & 3) * 8;  // the lane's k: slice q / 4, 8 values from (q % 4) * 8

  __syncthreads();  // the block's previous unit is done with shared memory
  // Batches of 8 independent loads a thread, then the stores.
  for (int base = t; base < KP * BC; base += 8 * SBLOCK) {  // coalesced along columns
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SBLOCK, k = idx / BC, cc = idx - k * BC;
      v[u] = idx < KP * BC && k < K ? __ldcg(X + static_cast<size_t>(k) * sd.N + c0 + cc) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SBLOCK, k = idx / BC, cc = idx - k * BC;
      if (idx < KP * BC) stage<P>(xs_h, xs_l, cc * XS + (k / KC) * SEG + k % KC, v[u]);
    }
  }
  for (int i = t; i < BC; i += SBLOCK) ud[i] = __ldg(sd.w.order + unit * BC + i);
  if (t == 0) {
    const int p0 = __ldg(sd.w.off + unit * nsub * BC);
    nx[0] = p0;
    nx[1] = __ldg(sd.w.off + unit * nsub * BC + BC) - p0;
  }
  float acc[RU][8];  // the partial of the lane's columns, k = (q / 4) * KC + (q % 4) * 8 + m
#pragma unroll
  for (int ru = 0; ru < RU; ++ru)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[ru][m] = 0.f;

  for (int sub = 0; r_begin + sub * SR < r_end; ++sub) {
    const int r0 = r_begin + sub * SR, len = min(SR, r_end - r0);
    const int seg = unit * nsub + sub;
    __syncthreads();  // this segment's bounds are in; the previous sub-strip's readers are done
    const int p0 = nx[2 * (sub & 1)], n = nx[2 * (sub & 1) + 1];
    int q0 = 0, q1 = 0;  // the next segment's bounds, loaded under this one's phases
    if (t == 0 && r_begin + (sub + 1) * SR < r_end) {
      q0 = __ldg(sd.w.off + (seg + 1) * BC);
      q1 = __ldg(sd.w.off + (seg + 1) * BC + BC);
    }
    int* nq = nx + 2 * ((sub + 1) & 1);  // read in the next sub-strip, after its barrier
    if (n == 0) {  // block-uniform: no rated cell in this sub-strip
      if (t == 0) nq[0] = q0, nq[1] = q1 - q0;
      continue;
    }
    {  // every load of the sub-strip first, then the stores: one round trip
      constexpr int NY = (KP * SR_MAX + SBLOCK - 1) / SBLOCK;  // Y values a thread
      float yv[NY];
#pragma unroll
      for (int u = 0; u < NY; ++u) {
        const int idx = t + u * SBLOCK, k = idx / SR, r = idx - k * SR;
        yv[u] = idx < KP * SR && k < K && r < len ? __ldcg(Y + static_cast<size_t>(k) * sd.M + r0 + r) : 0.f;
      }
      const int o_u = t <= BC ? __ldg(sd.w.off + seg * BC + t) : 0;
      constexpr int NC = 8;  // cells a thread a batch: the first batch in this round trip
      int c[NC];
      float a[NC];
      for (int i0 = t; i0 < n || i0 == t; i0 += NC * SBLOCK) {
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int i = i0 + u * SBLOCK;
          c[u] = i < n ? __ldg(sd.w.cell + p0 + i) : 0;
          a[u] = i < n ? __ldg(sd.w.val + p0 + i) : 0.f;
        }
        if (i0 == t) {  // the rows' stores wait for the first batch's loads to be issued
#pragma unroll
          for (int u = 0; u < NY; ++u) {
            const int idx = t + u * SBLOCK, k = idx / SR, r = idx - k * SR;
            if (idx < KP * SR) stage<P>(ys_h, ys_l, r * XS + (k / KC) * SEG + k % KC, yv[u]);
          }
          if (t <= BC) uo[t] = o_u - p0;
        }
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int i = i0 + u * SBLOCK;
          if (i < n) {
            uc[i] = c[u];
            es[i] = a[u];
          }
        }
      }
    }
    __syncthreads();

    // (A) pred and e of the segment's cells, G lanes a cell: walk()'s four
    // partial sums over j mod 4 with Y as `a` and X as `b`, then the xor
    // butterfly.
    for (int base = wid * 32; base < n * G; base += SBLOCK) {  // warp-uniform
      const int idx = base + lane;
      const int i = idx < n * G ? idx / G : 0;
      const int g = lane & (G - 1);
      const int cell = uc[i];
      const int cl = cell >> CELL_ROW_BITS, r = (cell & CELL_ROW_MASK) - sub * SR;
      const float4* xh4 = reinterpret_cast<const float4*>(xs_h + cl * XS + g * SEG);
      const float4* xl4 = reinterpret_cast<const float4*>(xs_l + cl * XS + g * SEG);
      const float4* yh4 = reinterpret_cast<const float4*>(ys_h + r * XS + g * SEG);
      const float4* yl4 = reinterpret_cast<const float4*>(ys_l + r * XS + g * SEG);
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int qq = 0; qq < KC / 4; ++qq) {
        const float4 yh = yh4[qq], xh = xh4[qq];
        const float yhv[4] = {yh.x, yh.y, yh.z, yh.w}, xhv[4] = {xh.x, xh.y, xh.z, xh.w};
        if (P == BF16X3) {
          const float4 yl = yl4[qq], xl = xl4[qq];
          const float ylv[4] = {yl.x, yl.y, yl.z, yl.w}, xlv[4] = {xl.x, xl.y, xl.z, xl.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ps[u] = fmaf(yhv[u], xlv[u], ps[u]);
            ps[u] = fmaf(ylv[u], xhv[u], ps[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) pb[u] = fmaf(yhv[u], xhv[u], pb[u]);
      }
      float sb = (pb[0] + pb[1]) + (pb[2] + pb[3]);
      float ss = (ps[0] + ps[1]) + (ps[2] + ps[3]);
#pragma unroll
      for (int o = G >> 1; o > 0; o >>= 1) {
        sb += __shfl_xor_sync(FULL, sb, o);
        if (P == BF16X3) ss += __shfl_xor_sync(FULL, ss, o);
      }
      const float pred = P == BF16X3 ? ss + sb : sb;
      if (idx < n * G && g == 0) es[i] = es[i] - pred;
    }
    __syncthreads();

    // (B) CPW columns a warp at once, LPC lanes a column and 8 k a lane, the
    // heaviest columns in the first round; a column's cells in row order
    // onto its registers.
#pragma unroll
    for (int ru = 0; ru < RU; ++ru) {
      const int cl = ud[ru * CPR + wid * CPW + cw];
      const int i0 = uo[cl], cnt = uo[cl + 1] - i0;
      chain<P>(acc[ru], uc, es, i0, cnt, __reduce_max_sync(FULL, cnt), sub * SR, XS, lofs, ys_h, ys_l);
    }
    if (t == 0) nq[0] = q0, nq[1] = q1 - q0;
  }
  __syncthreads();  // phase A's readers of the X columns are done

  // The partial through shared memory, so the write is coalesced along columns.
#pragma unroll
  for (int ru = 0; ru < RU; ++ru) {
    const int cl = ud[ru * CPR + wid * CPW + cw];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int k = (q >> 2) * KC + (q & 3) * 8 + m;
      if (k < K) tp[k * BC + cl] = acc[ru][m];
    }
  }
  __syncthreads();
  for (int idx = t; idx < K * BC; idx += SBLOCK) {
    const int k = idx / BC, cc = idx - k * BC;
    sd.part[(static_cast<size_t>(s) * K + k) * sd.N + c0 + cc] = tp[idx];
  }
}

// Unit u of both sides (the dl side's first).
template <int P, int G>
__device__ __forceinline__ void grad_one(const SArgs& a, const float* lc, const float* rc, int u,
                                         unsigned char* smem) {
  constexpr int BC = UNIT_COLS / G;
  const int nl_units = (a.l.N / BC) * a.l.S;
  const bool left = u < nl_units;
  const SSide sd = pick_side(left, a.l, a.r);
  grad_unit<P, G>(sd, left ? lc : rc, left ? rc : lc, a.K, left ? u : u - nl_units, a.SR, a.cap, smem);
}

// x' = x + alpha2 * sum_s part[s] over [start, K*(U + I)) by stride, the
// partials summed in ascending chunk order: apply_update's arithmetic and
// loop (with 32 partials in flight a thread it read 5.2 us a step at
// instML100k against apply_update's 3.4; PERF.md).  In the persistent form
// other blocks wrote the partials and factors in this launch, so they are
// read through L2 (__ldcg).
__device__ __forceinline__ void update_range(const SArgs& a, const float* lc, const float* rc, float* ln,
                                             float* rn, size_t start, size_t stride) {
  const size_t nl = static_cast<size_t>(a.K) * a.l.N, nr = static_cast<size_t>(a.K) * a.r.N;
  for (size_t idx = start; idx < nl + nr; idx += stride) {
    const bool left = idx < nl;
    const size_t i = left ? idx : idx - nl;
    const size_t n = left ? nl : nr;
    const float* part = left ? a.l.part : a.r.part;
    const int S = left ? a.l.S : a.r.S;
    float sum = __ldcg(part + i);
    for (int s = 1; s < S; ++s) sum += __ldcg(part + static_cast<size_t>(s) * n + i);
    const float x = __ldcg((left ? lc : rc) + i);
    (left ? ln : rn)[i] = __fadd_rn(x, __fmul_rn(a.alpha2, sum));
  }
}

// The loop form: one step's partials, a block a unit (the heaviest units
// first), then sparse_update.
template <int P, int G>
__global__ void __launch_bounds__(SBLOCK, G == 8 ? 2 : 4)
    sparse_grad(SArgs a, const float* __restrict__ lc, const float* __restrict__ rc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  grad_one<P, G>(a, lc, rc, __ldg(a.units + blockIdx.x), smem_raw);
}

__global__ void sparse_update(SArgs a, const float* lc, const float* rc, float* ln, float* rn) {
  update_range(a, lc, rc, ln, rn, blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x,
               static_cast<size_t>(gridDim.x) * blockDim.x);
}

// The persistent form: every step in one cooperative launch.  Per step the
// units dealt to the blocks as they come free, heaviest first (a ticket
// counter per step parity; a block draws its next ticket while it walks a
// unit), a grid-wide barrier, the update over the grid, and a barrier
// before the next step reads the new factors.  The last step lands in the
// output buffers.  Two blocks an SM, with 128 registers a thread.
template <int P, int G>
__global__ void __launch_bounds__(SBLOCK, 2) resident_persistent(SArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ticket;
  cg::grid_group grid = cg::this_grid();
  constexpr int BC = UNIT_COLS / G;
  const int n_units = (a.l.N / BC) * a.l.S + (a.r.N / BC) * a.r.S;
  const size_t gtid = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t gstride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const float* lc = a.Lt_in;
  const float* rc = a.Rt_in;
  for (int it = 0; it < a.iters; ++it) {
    const bool to_out = (a.iters - 1 - it) % 2 == 0;
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rt_out : a.Rt_tmp;
    int* counter = a.tickets + (it & 1);
    if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
    __syncthreads();
    for (int tk = ticket; tk < n_units;) {  // block-uniform
      int next = 0;
      if (threadIdx.x == 0) next = atomicAdd(counter, 1);  // in flight during this unit
      grad_one<P, G>(a, lc, rc, __ldg(a.units + tk), smem_raw);  // its first barrier: every tk is read
      if (threadIdx.x == 0) ticket = next;
      __syncthreads();
      tk = ticket;
    }
    grid.sync();
    // The other parity's counter was last drawn in the previous step.
    if (blockIdx.x == 0 && threadIdx.x == 0) a.tickets[(it + 1) & 1] = 0;
    update_range(a, lc, rc, ln, rn, gtid, gstride);
    grid.sync();
    lc = ln;
    rc = rn;
  }
}

enum Form { PERSISTENT = 0, LOOP = 1 };

template <int P, int G>
int sparse_steps(const SArgs& a, int form, cudaStream_t stream) {
  constexpr int BC = UNIT_COLS / G;
  if (a.SR % BR || a.SR <= 0 || a.SR > (G == 1 ? 64 : 32) || a.cap < 0 || a.cap > BC * a.SR ||
      a.l.N % BC || a.r.N % BC || a.l.chunk % BR || a.r.chunk % BR || a.l.M > CELL_ROW_MASK ||
      a.r.M > CELL_ROW_MASK || (form != PERSISTENT && form != LOOP))
    return cudaErrorInvalidValue;
  const size_t smem = sparse_smem_bytes(G, P, a.SR, a.cap);
  const size_t nl = static_cast<size_t>(a.K) * a.l.N, nr = static_cast<size_t>(a.K) * a.r.N;
  cudaError_t err;
  if (a.iters == 0) {
    err = cudaMemcpyAsync(a.Lt_out, a.Lt_in, nl * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
    return cudaMemcpyAsync(a.Rt_out, a.Rt_in, nr * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  }
  if (form == PERSISTENT) {
    auto kernel = resident_persistent<P, G>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SBLOCK, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;  // no block fits an SM
    SArgs args = a;
    void* params[] = {&args};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(per_sm * sms),
                                       dim3(SBLOCK), params, smem, stream);
  }
  err = cudaFuncSetAttribute(sparse_grad<P, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_units = (a.l.N / BC) * a.l.S + (a.r.N / BC) * a.r.S;
  const int apply_grid = static_cast<int>(std::min<size_t>((nl + nr + 255) / 256, 4096));
  const float* lc = a.Lt_in;
  const float* rc = a.Rt_in;
  for (int it = 0; it < a.iters; ++it) {
    const bool to_out = (a.iters - 1 - it) % 2 == 0;
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rt_out : a.Rt_tmp;
    sparse_grad<P, G><<<n_units, SBLOCK, smem, stream>>>(a, lc, rc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sparse_update<<<apply_grid, 256, 0, stream>>>(a, lc, rc, ln, rn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lc = ln;
    rc = rn;
  }
  return cudaSuccess;
}

template <int P>
int sparse_lanes(const SArgs& a, int G, int form, cudaStream_t stream) {
  switch (G) {
    case 1: return sparse_steps<P, 1>(a, form, stream);
    case 2: return sparse_steps<P, 2>(a, form, stream);
    case 4: return sparse_steps<P, 4>(a, form, stream);
    case 8: return sparse_steps<P, 8>(a, form, stream);
  }
  return cudaErrorInvalidValue;
}

int sparse_dispatch(const SArgs& a, int G, int precision, int form, cudaStream_t stream) {
  switch (precision) {
    case HIGHEST: return sparse_lanes<HIGHEST>(a, G, form, stream);
    case BF16X3: return sparse_lanes<BF16X3>(a, G, form, stream);
    case DEFAULT: return sparse_lanes<DEFAULT>(a, G, form, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a_kind: 0 int8 (2x rating), 1 bf16, 2 f32.  precision: 0 highest,
// 1 bf16x3, 2 default.  Each entry returns the first non-zero cudaError_t,
// else 0.  The callers (ops/dense_fused.py, ops/dense_stream.py) check
// shapes: U, I multiples of 128, K <= 32*G, G in {1, 2, 4, 8}, chunks
// multiples of 32.

// B1 in the dense form: `iters` GD steps, then the masked top-1
// (pallas_dense.py:662); the baseline of the sparse form.
extern "C" int rs_resident_train_top1(
    const void* At, int a_kind, const float* Lt_in, const float* Rt_in, float* Lt_out,
    float* Rt_out, float* Lt_tmp, float* Rt_tmp, float* part_l, float* part_r, float* top_val,
    int* top_idx, int* top1, int K, int U, int I, int G, int iters, float alpha2, int precision,
    int items_true, int chunk_l, int s_l, int chunk_r, int s_r, void* stream) {
  const Args a{At, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l, part_r, top_val,
               top_idx, top1, K, U, I, G, iters, items_true, alpha2, chunk_l, s_l, chunk_r,
               s_r, static_cast<cudaStream_t>(stream)};
  return dispatch(a, a_kind, precision, TRAIN_TOP1);
}

// B2 in the dense form: the same steps without the top-1 (pallas_dense.py:238
// resident_train).
// Same kernels, same order: its factors are B1's, bit for bit.
extern "C" int rs_resident_train(const void* At, int a_kind, const float* Lt_in,
                                 const float* Rt_in, float* Lt_out, float* Rt_out,
                                 float* Lt_tmp, float* Rt_tmp, float* part_l, float* part_r,
                                 int K, int U, int I, int G, int iters, float alpha2,
                                 int precision, int chunk_l, int s_l, int chunk_r, int s_r,
                                 void* stream) {
  const Args a{At, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l, part_r, nullptr,
               nullptr, nullptr, K, U, I, G, iters, 0, alpha2, chunk_l, s_l, chunk_r,
               s_r, static_cast<cudaStream_t>(stream)};
  return dispatch(a, a_kind, precision, TRAIN);
}

// B4: the masked top-1 alone, from final factors (pallas_dense.py:473
// stream_top1), over item chunks (chunk, S).  form 1 (TILED_TOP1, the
// engine's): top1_tiled, chunks multiples of 64 items, ops K * (U + I)
// floats of scratch in DEFAULT, 2 * K * (U + I) in BF16X3 (else may be
// null); form 0
// (DENSE_TOP1, the probe's baseline): top1_pass, chunks multiples of 32.
// Both then top1_reduce, which writes each user's best score to `best`
// unless it is null.  With the same factors either form is B1's top-1, and
// the two give the same indices and best scores, bit for bit.
extern "C" int rs_stream_top1(const void* At, int a_kind, const float* Lt, const float* Rt, float* ops,
                              float* top_val, int* top_idx, int* top1, float* best, int K, int U, int I,
                              int G, int precision, int items_true, int chunk, int S, int form,
                              void* stream) {
  const Args a{At, Lt, Rt, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, top_val,
               top_idx, top1, K, U, I, G, 0, items_true, 0.f, chunk, S, 0, 0,
               static_cast<cudaStream_t>(stream), ops, best, form};
  return dispatch(a, a_kind, precision, TOP1);
}

// B1 and B2 in the sparse form, the engine's: `iters` steps over the walk's
// tables (ops/dense_fused.py::walk_tables) for the split (chunk_l, s_l,
// chunk_r, s_r), sub-strips of SR rows and at most cap cells a segment; form
// 0 is the persistent kernel (one cooperative launch; tickets: two zeroed
// ints), 1 the loop of two launches a step.  Bit for bit the dense form at the same split.
extern "C" int rs_resident_sparse_train(const int* l_cell, const float* l_val, const int* l_off,
                                        const int* l_order, const int* r_cell, const float* r_val,
                                        const int* r_off, const int* r_order, const int* units,
                                        int* tickets, int cap, const float* Lt_in,
                                        const float* Rt_in, float* Lt_out, float* Rt_out, float* Lt_tmp,
                                        float* Rt_tmp, float* part_l, float* part_r, int K, int U, int I,
                                        int G, int iters, float alpha2, int precision, int chunk_l, int s_l,
                                        int chunk_r, int s_r, int SR, int form, void* stream) {
  SArgs a;
  a.l = SSide{SideWalk{l_cell, l_val, l_off, l_order}, U, I, chunk_l, s_l, part_l};
  a.r = SSide{SideWalk{r_cell, r_val, r_off, r_order}, I, U, chunk_r, s_r, part_r};
  a.units = units;
  a.tickets = tickets;
  a.Lt_in = Lt_in;
  a.Rt_in = Rt_in;
  a.Lt_out = Lt_out;
  a.Rt_out = Rt_out;
  a.Lt_tmp = Lt_tmp;
  a.Rt_tmp = Rt_tmp;
  a.K = K;
  a.iters = iters;
  a.SR = SR;
  a.cap = cap;
  a.alpha2 = alpha2;
  return sparse_dispatch(a, G, precision, form, static_cast<cudaStream_t>(stream));
}

// B1: the sparse steps, then the tiled top-1 (B4's engine form) over item
// chunks (top_chunk, top_S); ops as rs_stream_top1's.
extern "C" int rs_resident_sparse_train_top1(
    const int* l_cell, const float* l_val, const int* l_off, const int* l_order, const int* r_cell,
    const float* r_val, const int* r_off, const int* r_order, const int* units, int* tickets, int cap,
    const void* At, int a_kind,
    const float* Lt_in, const float* Rt_in, float* Lt_out, float* Rt_out, float* Lt_tmp, float* Rt_tmp,
    float* part_l, float* part_r, float* ops, float* top_val, int* top_idx, int* top1, int K, int U, int I,
    int G, int iters, float alpha2, int precision, int items_true, int chunk_l, int s_l, int chunk_r, int s_r,
    int SR, int form, int top_chunk, int top_S, void* stream) {
  const int err = rs_resident_sparse_train(l_cell, l_val, l_off, l_order, r_cell, r_val, r_off, r_order, units,
                                           tickets, cap, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l,
                                           part_r, K, U, I, G, iters, alpha2, precision, chunk_l, s_l, chunk_r,
                                           s_r, SR, form, stream);
  if (err != 0) return err;
  return rs_stream_top1(At, a_kind, Lt_out, Rt_out, ops, top_val, top_idx, top1, nullptr, K, U, I, G, precision,
                        items_true, top_chunk, top_S, TILED_TOP1, stream);
}
