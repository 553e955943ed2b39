// Fused dense full-batch GD + masked top-1 for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_dense.py::resident_train_top1
// (:662; bodies _resident_top1_kernel :620 and _resident_kernel :172): all
// `iters` stable-snapshot GD steps on K-major factors, then the masked top-1,
// from ONE host call (rs_resident_train_top1) that runs the iteration loop in
// C on the caller's stream.  Two more entries share its kernels:
// rs_resident_train (B2, pallas_dense.py:238 resident_train) runs the steps
// alone, and rs_stream_top1 (B4, pallas_dense.py:473 stream_top1) the top-1
// alone, from factors the stream kernel (dense_stream.cu) trained.  Per step, with A^T (I, U) and the implicit mask
// a != 0 (pallas_dense.py module docstring):
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
// What bounds it on this card.  At instML100k (K=32, U=1024, I=1792) one step
// is at most ~4*U*I*K = 0.23 G multiply-adds (0.47 GFLOP; the warp skip of
// unrated cells below issues under half of that) and A^T is 1.8 MB as int8,
// so everything a step touches (A^T, the factor tables, the partial sums)
// sits in the 50 MB L2: the step is bound on the SMs, not by HBM -- by the
// f32 work of the row loop on the CUDA cores (67 TFLOP/s FMA peak) and,
// because the problem is small, by how many SMs get work: U = 1024 users
// give only 1024 independent output columns.
//
// What the design does about that.
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
//  * top1_pass + top1_reduce: the same walk over item chunks keeping a
//    running (best, index), then a strictly-greater merge of the chunks in
//    ascending order -- equal to one ascending walk over all items.
//  * Precision is a template parameter, with the operand rounding of
//    pallas_dense._dot (:122): HIGHEST is IEEE f32 FMA (never TF32), DEFAULT
//    rounds both operands to bf16 (products exact in f32, f32 sums), BF16X3
//    splits every operand hi + lo and sums (ah*bl + al*bh) + ah*bh.
//  * A lane reads its slice of a staged row as 16-byte loads (slices padded
//    to start in different banks), one load per four FMAs, and the dot
//    runs as four independent partial sums instead of one FMA chain.
//  * A warp whose 32 cells are all unrated skips the gradient work: e is 0
//    there, and adding +-0 to a sum that started at +0 changes no bit.
//
// Later work: a persistent kernel with a grid-wide sync in place of ~2
// launches per step, CUDA graphs, and wgmma/TMA for the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

}  // namespace

// a_kind: 0 int8 (2x rating), 1 bf16, 2 f32.  precision: 0 highest,
// 1 bf16x3, 2 default.  Each entry returns the first non-zero cudaError_t,
// else 0.  The callers (ops/dense_fused.py, ops/dense_stream.py) check
// shapes: U, I multiples of 128, K <= 32*G, G in {1, 2, 4, 8}, chunks
// multiples of 32.

// B1: `iters` GD steps, then the masked top-1 (pallas_dense.py:662).
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

// B2: the same steps without the top-1 (pallas_dense.py:238 resident_train).
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
