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
// The top-1 (top1_pass + top1_reduce, shared with B4 through rs_stream_top1)
// stays dense: it visits every unrated cell.
//  * The same walk over item chunks keeping a running (best, index), then a
//    strictly-greater merge of the chunks in ascending order -- equal to
//    one ascending walk over all items.
//  * Precision is a template parameter, with the operand rounding of
//    pallas_dense._dot (:122): HIGHEST is IEEE f32 FMA (never TF32), DEFAULT
//    rounds both operands to bf16 (products exact in f32, f32 sums), BF16X3
//    splits every operand hi + lo and sums (ah*bl + al*bh) + ah*bh.

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

__global__ void top1_reduce(const float* __restrict__ pval, const int* __restrict__ pidx, int S,
                            int N, int* __restrict__ top1) {
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
};

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

// The masked top-1 from the factors (Lt, Rt), walking the items in the dl
// side's chunks (chunk_l, s_l).
template <typename T, int P>
int top1(const Args& a, const float* Lt, const float* Rt) {
  const T* At = static_cast<const T*>(a.At);
  const int lg = log2_lanes(a.G);
  const size_t smem = smem_bytes(lg, P);
  cudaError_t err = cudaFuncSetAttribute(top1_pass<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Side st{Lt, Rt, a.U, a.I, 0, a.chunk_l, a.s_l, nullptr};
  top1_pass<T, P><<<side_blocks(st, lg), BLOCK, smem, a.stream>>>(
      At, st, a.K, lg, a.items_true, a.top_val, a.top_idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  top1_reduce<<<(a.U + 255) / 256, 256, 0, a.stream>>>(a.top_val, a.top_idx, a.s_l, a.U, a.top1);
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
// stream_top1).  top1_pass reads each A^T cell once; with the same factors
// it is B1's top-1, bit for bit.
extern "C" int rs_stream_top1(const void* At, int a_kind, const float* Lt, const float* Rt,
                              float* top_val, int* top_idx, int* top1, int K, int U, int I,
                              int G, int precision, int items_true, int chunk, int S,
                              void* stream) {
  const Args a{At, Lt, Rt, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, top_val,
               top_idx, top1, K, U, I, G, 0, items_true, 0.f, chunk, S, 0, 0,
               static_cast<cudaStream_t>(stream)};
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

// B1: the sparse steps, then the dense top-1 over the items in the dl side's
// chunks, as rs_resident_train_top1 ends.
extern "C" int rs_resident_sparse_train_top1(
    const int* l_cell, const float* l_val, const int* l_off, const int* l_order, const int* r_cell,
    const float* r_val, const int* r_off, const int* r_order, const int* units, int* tickets, int cap,
    const void* At, int a_kind,
    const float* Lt_in, const float* Rt_in, float* Lt_out, float* Rt_out, float* Lt_tmp, float* Rt_tmp,
    float* part_l, float* part_r, float* top_val, int* top_idx, int* top1, int K, int U, int I, int G,
    int iters, float alpha2, int precision, int items_true, int chunk_l, int s_l, int chunk_r, int s_r,
    int SR, int form, void* stream) {
  const int err = rs_resident_sparse_train(l_cell, l_val, l_off, l_order, r_cell, r_val, r_off, r_order, units,
                                           tickets, cap, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l,
                                           part_r, K, U, I, G, iters, alpha2, precision, chunk_l, s_l, chunk_r,
                                           s_r, SR, form, stream);
  if (err != 0) return err;
  return rs_stream_top1(At, a_kind, Lt_out, Rt_out, top_val, top_idx, top1, K, U, I, G, precision,
                        items_true, chunk_l, s_l, stream);
}
