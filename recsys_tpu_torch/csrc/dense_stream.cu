// Streamed dense full-batch GD for NVIDIA Hopper (sm_90a): one pass over A^T
// per step.
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_dense.py::stream_train
// (:420; body _stream_kernel :289 through _stream_call :372) and, with the
// top-1 of csrc/dense_fused.cu behind it, stream_train_top1 (:433).  The
// function is the one of csrc/dense_fused.cu: per step, with A^T (I, U) and
// the implicit mask a != 0,
//
//     pred^T = Rt^T . Lt                     (I, U), contracting K
//     E^T    = (a != 0) * (a - pred^T)
//     Lt'    = Lt + alpha2 * Rt . E^T        (K, U), contracting items
//     Rt'    = Rt + alpha2 * Lt . E          (K, I), contracting users
//
// both gradients reading the pre-step (Lt, Rt) (matFact.c:38-39).
//
// Why a second design.  The resident kernel (dense_fused.cu) walks A^T once
// for each gradient side, so it reads A^T twice per step and computes pred
// twice.  That is cheap while A^T sits in L2 (instML100k: 1.8 MB).  At
// gen-instML1M's padded shape (K=32, U=6144, I=3968) int8 A^T is 24.4 MB,
// and B1's step touches about 38 MB (A^T, ~4.7 + 4.6 MB of partial sums and
// six factor tables of 1.3 MB each) against the card's 50 MB L2.  The TPU's
// stream kernel exists to read A once per step while the factors stay on
// chip; this kernel carries that to Hopper.
//
// The design.
//  * stream_pass: a block owns BC user columns (a thread, or G lanes for
//    K > 32, per column) and an item chunk.  It walks the chunk in strips of
//    BR = 32 items.  Each strip's A^T tile (32 items x BC users, in its
//    storage dtype) comes into shared memory once, double-buffered with
//    cp.async: the next tile loads while this one is used.
//  * From the tile the block forms E once.  The row loop computes pred from
//    the column's factors in registers and the strip's Rt rows in shared
//    memory (B1's walk), keeps e in shared memory, and accumulates dLt for
//    its columns in registers over the whole chunk.  A second loop over the
//    same e computes the strip's dRt tile (K x 32) over the block's columns.
//    Both gradient sides come from one read of the tile.
//  * Partial sums, no float atomics.  dLt: one partial per item chunk,
//    part_l (S_i, K, U).  dRt: the C <= 16 blocks of a thread-block cluster
//    share an item chunk and walk it in step; after each strip they sum
//    their dRt tiles through distributed shared memory in rank order, so
//    there is one partial per cluster, part_r (U / (BC * C), K, I).
//    stream_update then sums each column's partials in fixed order and
//    writes x + alpha2 * sum into a ping-pong buffer.  Every run gives the
//    same bits.
//  * Partial bytes at gen-instML1M (K=32; 48 column blocks x 9 item chunks
//    = 432 blocks, about 3 per SM; clusters of 16): part_l
//    9 * 32 * 6144 * 4 = 7.08 MB, part_r 3 * 32 * 3968 * 4 = 1.52 MB.  A
//    step touches 24.4 MB of A^T once, 8.6 MB of partials and the factor
//    tables (3.9 MB for all six): about 36.9 MB, under B1's ~37.6 MB, and
//    A^T is read once instead of twice.
//  * The strip's dRt loop reads the block's Lt columns k-contiguous, 8 k
//    per two 16-byte loads, and e as the product consumes it (rounded or
//    split once, in the row loop).
//  * Precision is a template parameter with _dot's operand rounding
//    (pallas_dense.py:122), as in dense_fused.cu: HIGHEST is IEEE f32 FMA,
//    DEFAULT rounds both operands to bf16, BF16X3 splits both operands
//    hi + lo and sums (ah*bl + al*bh) + ah*bh.  A tiles are dequantised on
//    read as _load_at (:155) does, so int8, bf16 and f32 storage give the
//    same bits.
//
// What bounds it.  The kernel does the dense products: 3 * U * I * K
// multiply-adds per step (2.3 G at gen-instML1M), on the CUDA cores at
// 67 TFLOP/s f32 peak, against 24.4 MB of A^T at 3.35 TB/s (7 us).  So it
// is bound by operations, and at 4% density most of them multiply zeros:
// the warp skip of unrated cells (as in B1) drops a row only when all 32
// users of a warp left it unrated.  The work these inputs need is
// 6 * nnz * k FLOP per step.  Later work: wgmma for the three products, a
// sparse walk of the rated cells, a persistent grid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;       // factor values each lane holds (lane g holds k = g*KC + j)
constexpr int SEG = KC + 4;  // a lane's K slice in a staged Rt row, padded (16-byte loads)
constexpr int BLOCK = 128;   // threads per block
constexpr int BR = 32;       // items per strip
constexpr int ES = BR + 1;   // stride of a column's e values in shared memory
constexpr unsigned FULL = 0xffffffffu;
static_assert(BLOCK == 4 * BR, "the dRt loop maps 4 warps x 32 strip rows");

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
__device__ __forceinline__ float deq(int8_t v) { return static_cast<float>(v) * 0.5f; }
__device__ __forceinline__ float deq(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float deq(float v) { return v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of stream_pass, in bytes: two raw A tiles, then the staged
// Rt strip, the block's Lt columns, its e values and two dRt tiles.
__host__ __device__ __forceinline__ size_t tile_bytes(int lg, int a_size) {
  return static_cast<size_t>(BR) * (BLOCK >> lg) * a_size;
}
__host__ __device__ __forceinline__ size_t stream_smem_bytes(int lg, int prec, int K, int a_size) {
  const int G = 1 << lg, BC = BLOCK >> lg;
  const int nsplit = prec == BF16X3 ? 2 : 1;
  const size_t floats = static_cast<size_t>(nsplit) * BR * G * SEG +
                        static_cast<size_t>(nsplit) * (K + 4) * BC +
                        static_cast<size_t>(nsplit) * BC * ES + 2 * static_cast<size_t>(K) * BR;
  return 2 * tile_bytes(lg, a_size) + sizeof(float) * floats;
}

template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* __restrict__ At, int U,
                                          int r0, int c0, int BC) {
  const int row_bytes = BC * static_cast<int>(sizeof(T));
  const int per_row = row_bytes / 16;
  for (int idx = threadIdx.x; idx < BR * per_row; idx += BLOCK) {
    const int r = idx / per_row, ch = idx - r * per_row;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(At + static_cast<size_t>(r0 + r) * U + c0) + ch * 16;
    cp_async16(dst + r * row_bytes + ch * 16, src);
  }
}

// One step's gradient partials.  Grid (U / BC, S_i), clusters of C blocks
// along x.  Block (cb, si) owns user columns [cb*BC, cb*BC + BC) and items
// [si*chunk, min(I, si*chunk + chunk)).
template <typename T, int P>
__global__ void __launch_bounds__(BLOCK)
    stream_pass(const T* __restrict__ At, const float* __restrict__ Lt,
                const float* __restrict__ Rt, float* __restrict__ part_l,
                float* __restrict__ part_r, int K, int U, int I, int lg, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());

  const int G = 1 << lg, BC = BLOCK >> lg, KP = KC * G, YS = G * SEG, KX = K + 4;
  constexpr int NS = P == BF16X3 ? 2 : 1;
  const size_t tb = tile_bytes(lg, sizeof(T));
  unsigned char* sa = smem_raw;                                      // 2 raw A tiles
  float* sy_h = reinterpret_cast<float*>(smem_raw + 2 * tb);         // Rt strip (BR, G*SEG)
  float* sy_l = sy_h + BR * YS;                                      // BF16X3 only
  float* xs_h = sy_h + NS * BR * YS;                                 // Lt columns (BC, KX)
  float* xs_l = xs_h + KX * BC;                                      // BF16X3 only
  float* se_h = xs_h + NS * KX * BC;                                 // e as dRt reads it (BC, ES)
  float* se_l = se_h + BC * ES;                                      // BF16X3 only
  float* sd = se_h + NS * BC * ES;                                   // 2 dRt tiles (K, BR)

  const int cb = blockIdx.x, si = blockIdx.y;
  const int c0 = cb * BC;
  const int r_begin = si * chunk;
  const int r_end = min(I, r_begin + chunk);
  const int n_strips = (r_end - r_begin) / BR;
  const int t = threadIdx.x;
  const int cl = t >> lg, g = t & (G - 1);
  const int c = c0 + cl;

  // The column's factors in registers, the block's columns in shared memory.
  float xh[KC], xl[KC], acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = g * KC + j;
    const float v = k < K ? __ldg(Lt + static_cast<size_t>(k) * U + c) : 0.f;
    if (P == BF16X3) {
      bsplit(v, xh[j], xl[j]);
    } else {
      xh[j] = P == DEFAULT ? round_bf16(v) : v;
      xl[j] = 0.f;
    }
    acc[j] = 0.f;
  }
  for (int idx = t; idx < K * BC; idx += BLOCK) {
    const int k = idx >> (7 - lg), cc = idx & (BC - 1);
    const float v = __ldg(Lt + static_cast<size_t>(k) * U + c0 + cc);
    const int at = cc * KX + k;  // k contiguous: the dRt loop reads 8 k at a time
    if (P == BF16X3) {
      bsplit(v, xs_h[at], xs_l[at]);
    } else {
      xs_h[at] = P == DEFAULT ? round_bf16(v) : v;
    }
  }

  if (n_strips > 0) load_tile<T>(sa, At, U, r_begin, c0, BC);
  cp_async_commit();
  for (int s = 0; s < n_strips; ++s) {
    const int r0 = r_begin + s * BR;
    const int p = s & 1;
    __syncthreads();  // the previous strip is consumed
    if (s + 1 < n_strips) load_tile<T>(sa + (p ^ 1) * tb, At, U, r0 + BR, c0, BC);
    cp_async_commit();
    for (int idx = t; idx < KP * BR; idx += BLOCK) {
      const int k = idx / BR, r = idx % BR;
      const float v = k < K ? __ldg(Rt + static_cast<size_t>(k) * I + r0 + r) : 0.f;
      const int at = r * YS + (k / KC) * SEG + k % KC;
      if (P == BF16X3) {
        bsplit(v, sy_h[at], sy_l[at]);
      } else {
        sy_h[at] = P == DEFAULT ? round_bf16(v) : v;
      }
    }
    cp_async_wait<1>();  // this strip's tile has landed
    __syncthreads();

    // Rows: pred, e, and dLt over the strip's items.
    const T* ta = reinterpret_cast<const T*>(sa + p * tb);
#pragma unroll 2
    for (int r = 0; r < BR; ++r) {
      const float a = deq(ta[r * BC + cl]);
      float eh = 0.f, el = 0.f;  // e, or its bf16 rounding (DEFAULT) or split (BF16X3)
      if (__any_sync(FULL, a != 0.f)) {  // warp-uniform: e = 0 everywhere otherwise
        const float4* yh4 = reinterpret_cast<const float4*>(sy_h + r * YS + g * SEG);
        const float4* yl4 = reinterpret_cast<const float4*>(sy_l + r * YS + g * SEG);
        float yh[KC], yl[KC];
#pragma unroll
        for (int qq = 0; qq < KC / 4; ++qq) {
          const float4 h = yh4[qq];
          yh[4 * qq] = h.x, yh[4 * qq + 1] = h.y, yh[4 * qq + 2] = h.z, yh[4 * qq + 3] = h.w;
          if (P == BF16X3) {
            const float4 l = yl4[qq];
            yl[4 * qq] = l.x, yl[4 * qq + 1] = l.y, yl[4 * qq + 2] = l.z, yl[4 * qq + 3] = l.w;
          }
        }
        // pred = _dot(rt, lt): four independent partial sums, as in B1.
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
        const float e = a != 0.f ? a - pred : 0.f;
        // dLt += _dot(rt, e): (yh*el + yl*eh) + yh*eh, as in B1.
        if (P == BF16X3) {
          bsplit(e, eh, el);
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[j] += fmaf(yh[j], eh, fmaf(yh[j], el, yl[j] * eh));
        } else {
          eh = P == DEFAULT ? round_bf16(e) : e;
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[j] = fmaf(eh, yh[j], acc[j]);
        }
      }
      if (g == 0) {
        se_h[cl * ES + r] = eh;
        if (P == BF16X3) se_l[cl * ES + r] = el;
      }
    }
    __syncthreads();

    // The strip's dRt tile over the block's columns: thread (kg, r) sums
    // _dot(lt, e) for 8 consecutive k in column order, reading them as two
    // 16-byte loads per column.
    float* sdp = sd + p * K * BR;
    {
      const int r = t & (BR - 1), kg = t >> 5;
      for (int kb = kg * 8; kb < K; kb += 32) {  // warp-uniform; K is a multiple of 8
        float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int cc = 0; cc < BC; ++cc) {
          const float4* h4 = reinterpret_cast<const float4*>(xs_h + cc * KX + kb);
          const float4 h0 = h4[0], h1 = h4[1];
          const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const float eh = se_h[cc * ES + r];
          if (P == BF16X3) {
            const float4* l4 = reinterpret_cast<const float4*>(xs_l + cc * KX + kb);
            const float4 l0 = l4[0], l1 = l4[1];
            const float l[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            const float el = se_l[cc * ES + r];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) d[jj] += fmaf(h[jj], eh, fmaf(h[jj], el, l[jj] * eh));
          } else {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) d[jj] = fmaf(h[jj], eh, d[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) sdp[(kb + jj) * BR + r] = d[jj];
      }
    }
    // Sum the cluster's tiles in rank order; block q writes the k rows
    // k = q (mod C).  The next strip writes the other tile buffer, and the
    // barrier of that strip keeps this one alive until every block has read
    // it.
    cluster.sync();
    {
      const int r = t & (BR - 1), kg = t >> 5;
      const int cu = cb / C;
      for (int k = q + C * kg; k < K; k += 4 * C) {
        float sum = 0.f;
        for (int rho = 0; rho < C; ++rho) {
          const float v = cluster.map_shared_rank(sdp, rho)[k * BR + r];
          sum = rho == 0 ? v : sum + v;
        }
        part_r[(static_cast<size_t>(cu) * K + k) * I + r0 + r] = sum;
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while another reads its shared memory

#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = g * KC + j;
    if (k < K) part_l[(static_cast<size_t>(si) * K + k) * U + c] = acc[j];
  }
}

// x' = x + alpha2 * sum_s part[s] for both sides in one launch, partials
// summed in ascending order (deterministic).
__global__ void stream_update(const float* __restrict__ part_l, int s_l,
                              const float* __restrict__ part_r, int s_r,
                              const float* __restrict__ lc, const float* __restrict__ rc,
                              float* __restrict__ ln, float* __restrict__ rn, size_t nl,
                              size_t nr, float alpha2) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < nl + nr;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const bool left = idx < nl;
    const size_t i = left ? idx : idx - nl;
    const size_t n = left ? nl : nr;
    const float* part = left ? part_l : part_r;
    const int S = left ? s_l : s_r;
    float sum = __ldg(part + i);
    for (int s = 1; s < S; ++s) sum += __ldg(part + static_cast<size_t>(s) * n + i);
    const float x = __ldg((left ? lc : rc) + i);
    (left ? ln : rn)[i] = __fadd_rn(x, __fmul_rn(alpha2, sum));
  }
}

struct Args {
  const void* At;
  const float *Lt_in, *Rt_in;
  float *Lt_out, *Rt_out, *Lt_tmp, *Rt_tmp;
  float *part_l, *part_r;
  int K, U, I, G, C, iters;
  float alpha2;
  int chunk, S;
  cudaStream_t stream;
};

template <typename T, int P>
int train(const Args& a) {
  int lg = 0;
  while ((1 << lg) < a.G) ++lg;
  const int BC = BLOCK >> lg;
  if (a.U % BC || (a.U / BC) % a.C || a.C < 1 || a.C > 16 || a.chunk % BR || a.I % BR)
    return cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes(lg, P, a.K, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(stream_pass<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (a.C > 8) {  // Hopper runs clusters of 16 when asked; 8 is the portable size
    err = cudaFuncSetAttribute(stream_pass<T, P>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.U / BC, a.S, 1);
  cfg.blockDim = dim3(BLOCK, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const size_t nl = static_cast<size_t>(a.K) * a.U, nr = static_cast<size_t>(a.K) * a.I;
  const int s_r = a.U / (BC * a.C);
  const int apply_grid = static_cast<int>(std::min<size_t>((nl + nr + 255) / 256, 4096));
  const T* At = static_cast<const T*>(a.At);
  const float* lc = a.Lt_in;
  const float* rc = a.Rt_in;
  for (int it = 0; it < a.iters; ++it) {
    // The last step lands in the output buffers.
    const bool to_out = (a.iters - 1 - it) % 2 == 0;
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rt_out : a.Rt_tmp;
    err = cudaLaunchKernelEx(&cfg, stream_pass<T, P>, At, lc, rc, a.part_l, a.part_r, a.K, a.U,
                             a.I, lg, a.chunk);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    stream_update<<<apply_grid, 256, 0, a.stream>>>(a.part_l, a.S, a.part_r, s_r, lc, rc, ln, rn,
                                                    nl, nr, a.alpha2);
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

template <typename T>
int train_prec(const Args& a, int precision) {
  switch (precision) {
    case HIGHEST: return train<T, HIGHEST>(a);
    case BF16X3: return train<T, BF16X3>(a);
    case DEFAULT: return train<T, DEFAULT>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// B4, in csrc/dense_fused.cu.
extern "C" int rs_stream_top1(const void* At, int a_kind, const float* Lt, const float* Rt,
                              float* top_val, int* top_idx, int* top1, int K, int U, int I,
                              int G, int precision, int items_true, int chunk, int S,
                              void* stream);

// a_kind: 0 int8 (2x rating), 1 bf16, 2 f32.  precision: 0 highest,
// 1 bf16x3, 2 default.  Returns the first non-zero cudaError_t, else 0.
// The caller (ops/dense_stream.py) checks shapes: U, I multiples of 128,
// K <= 32*G, G in {1, 2, 4, 8}, C in {1, 2, 4, 8, 16} dividing U*G/128, chunk a
// multiple of 32; part_l is (S, K, U), part_r (U*G / (128*C), K, I).

// B3: `iters` streamed GD steps (pallas_dense.py:420 stream_train).
extern "C" int rs_stream_train(const void* At, int a_kind, const float* Lt_in,
                               const float* Rt_in, float* Lt_out, float* Rt_out, float* Lt_tmp,
                               float* Rt_tmp, float* part_l, float* part_r, int K, int U, int I,
                               int G, int C, int iters, float alpha2, int precision, int chunk,
                               int S, void* stream) {
  const Args a{At, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l, part_r, K, U, I, G, C,
               iters, alpha2, chunk, S, static_cast<cudaStream_t>(stream)};
  switch (a_kind) {
    case 0: return train_prec<int8_t>(a, precision);
    case 1: return train_prec<__nv_bfloat16>(a, precision);
    case 2: return train_prec<float>(a, precision);
  }
  return cudaErrorInvalidValue;
}

// B6: B3's steps, then B4's pass over the final factors, in one host call
// (pallas_dense.py:433 stream_train_top1).  Bit for bit B3 then B4.
extern "C" int rs_stream_train_top1(const void* At, int a_kind, const float* Lt_in,
                                    const float* Rt_in, float* Lt_out, float* Rt_out,
                                    float* Lt_tmp, float* Rt_tmp, float* part_l, float* part_r,
                                    float* top_val, int* top_idx, int* top1, int K, int U, int I,
                                    int G, int C, int iters, float alpha2, int precision,
                                    int items_true, int chunk, int S, int top_chunk, int top_S,
                                    void* stream) {
  const int err = rs_stream_train(At, a_kind, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp,
                                  part_l, part_r, K, U, I, G, C, iters, alpha2, precision, chunk,
                                  S, stream);
  if (err != 0) return err;
  return rs_stream_top1(At, a_kind, Lt_out, Rt_out, top_val, top_idx, top1, K, U, I, G,
                        precision, items_true, top_chunk, top_S, stream);
}
