// The TPU probe P3's strip-packed streamed GD for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel scripts/probe_stream_v2.py::stream_v2_train
// (:89, body _v2_kernel :48, call :98): `iters` full GD steps with A stored
// (U, n * strip) and R packed strip by strip, Rp (n * K, strip): rows
// s*K .. s*K + K-1 are strip s of the (K, I) table.  Per step, with the
// implicit mask a != 0,
//
//     pred = Lt^T . rt                  (U, strip), for each strip rt = Rp[s]
//     e    = (a != 0) * (a - pred)
//     Lt'  = Lt + alpha2 * sum_s rt . e^T
//     Rp'[s] = Rp[s] + alpha2 * Lt . e
//
// both gradients reading the pre-step factors (matFact.c:38-39).  On the
// TPU, packing moves every dynamic slice of R to the sublane dimension; the
// probe asks whether the layout changes the streamed step's time.
//
// The design is B3's (csrc/dense_stream.cu: one read of each A tile a step
// feeds both gradient sides, fixed-order partial sums, clusters that sum
// their dR tiles in shared memory, a ping-pong update) with this layout:
//  * A's tile of BC users x BR = 32 items comes user-major from (U, I) and
//    is staged into shared memory with 4-byte cp.async copies into rows of
//    32 * sizeof(T) + 4 bytes, so the row loop's column reads fall in
//    distinct banks;
//  * the strip's R values are read from Rp's strip-contiguous rows, and the
//    dR partials and the update keep Rp's layout.
// Its sums run in B3's order, so from the same factors it gives B3's
// (`highest`) result bit for bit: a probe of the layout alone.  Only
// `highest` (IEEE f32 FMA, no TF32) is built, the probe's only precision.
// Bound, as B3: 3 * U * I * K multiply-adds a step on the CUDA cores; the
// work the ratings need is 6 * nnz * k FLOP a step.
//
// This is P3's dense form (rs_stream_v2_train, ops/stream_v2.py::
// stream_v2_train_dense), kept as the probe's baseline.  P3's own form walks
// the rated cells alone: B3's sparse walk on this layout, sparse_pass in
// csrc/dense_stream.cu (rs_stream_v2_sparse_train), with the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;       // factor values each lane holds (lane g holds k = g*KC + j)
constexpr int SEG = KC + 4;  // a lane's K slice in a staged R row, padded (16-byte loads)
constexpr int BLOCK = 128;   // threads per block
constexpr int BR = 32;       // items per strip of the walk
constexpr int ES = BR + 1;   // stride of a column's e values in shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float deq(int8_t v) { return static_cast<float>(v) * 0.5f; }
__device__ __forceinline__ float deq(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float deq(float v) { return v; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A tile row: one user's 32 items, padded by 4 bytes.
template <typename T>
__host__ __device__ __forceinline__ int row_bytes() {
  return BR * static_cast<int>(sizeof(T)) + 4;
}
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int lg) {
  return static_cast<size_t>(BLOCK >> lg) * row_bytes<T>();
}
template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int lg, int K) {
  const int G = 1 << lg, BC = BLOCK >> lg;
  const size_t floats = static_cast<size_t>(BR) * G * SEG + static_cast<size_t>(K + 4) * BC +
                        static_cast<size_t>(BC) * ES + 2 * static_cast<size_t>(K) * BR;
  return 2 * tile_bytes<T>(lg) + sizeof(float) * floats;
}

// Where item i's value of factor k lives in a packed (n * K, strip) table.
__device__ __forceinline__ size_t packed(int k, int i, int K, int strip) {
  const int s = i / strip;
  return (static_cast<size_t>(s) * K + k) * strip + (i - s * strip);
}

template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* __restrict__ A, int I, int c0,
                                          int r0, int BC) {
  constexpr int words = BR * sizeof(T) / 4;  // 4-byte copies per user row
  for (int idx = threadIdx.x; idx < BC * words; idx += BLOCK) {
    const int cc = idx / words, w = idx - cc * words;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(A + static_cast<size_t>(c0 + cc) * I + r0);
    cp_async4(dst + cc * row_bytes<T>() + 4 * w, src + 4 * w);
  }
}

// One step's gradient partials.  Grid (U / BC, S_i), clusters of C blocks
// along x.  Block (cb, si) owns user columns [cb*BC, cb*BC + BC) and items
// [si*chunk, min(I, si*chunk + chunk)).  B3's stream_pass in `highest`.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    v2_pass(const T* __restrict__ A, const float* __restrict__ Lt, const float* __restrict__ Rp,
            float* __restrict__ part_l, float* __restrict__ part_r, int K, int U, int I, int strip,
            int lg, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());

  const int G = 1 << lg, BC = BLOCK >> lg, KP = KC * G, YS = G * SEG, KX = K + 4;
  const size_t tb = tile_bytes<T>(lg);
  unsigned char* sa = smem_raw;                               // 2 A tiles (BC, row_bytes)
  float* sy = reinterpret_cast<float*>(smem_raw + 2 * tb);    // R strip (BR, G*SEG)
  float* xs = sy + BR * YS;                                   // Lt columns (BC, KX)
  float* se = xs + KX * BC;                                   // e as dR reads it (BC, ES)
  float* sd = se + BC * ES;                                   // 2 dR tiles (K, BR)

  const int cb = blockIdx.x, si = blockIdx.y;
  const int c0 = cb * BC;
  const int r_begin = si * chunk;
  const int r_end = min(I, r_begin + chunk);
  const int n_strips = (r_end - r_begin) / BR;
  const int t = threadIdx.x;
  const int cl = t >> lg, g = t & (G - 1);
  const int c = c0 + cl;

  float xh[KC], acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = g * KC + j;
    xh[j] = k < K ? __ldg(Lt + static_cast<size_t>(k) * U + c) : 0.f;
    acc[j] = 0.f;
  }
  for (int idx = t; idx < K * BC; idx += BLOCK) {
    const int k = idx >> (7 - lg), cc = idx & (BC - 1);
    xs[cc * KX + k] = __ldg(Lt + static_cast<size_t>(k) * U + c0 + cc);
  }

  if (n_strips > 0) load_tile<T>(sa, A, I, c0, r_begin, BC);
  cp_async_commit();
  for (int s = 0; s < n_strips; ++s) {
    const int r0 = r_begin + s * BR;
    const int p = s & 1;
    __syncthreads();  // the previous strip is consumed
    if (s + 1 < n_strips) load_tile<T>(sa + (p ^ 1) * tb, A, I, c0, r0 + BR, BC);
    cp_async_commit();
    for (int idx = t; idx < KP * BR; idx += BLOCK) {
      const int k = idx / BR, r = idx % BR;
      sy[r * YS + (k / KC) * SEG + k % KC] = k < K ? __ldg(Rp + packed(k, r0 + r, K, strip)) : 0.f;
    }
    cp_async_wait<1>();  // this strip's tile has landed
    __syncthreads();

    // Rows: pred, e, and dLt over the strip's items.
    const unsigned char* ta = sa + p * tb + cl * row_bytes<T>();
#pragma unroll 2
    for (int r = 0; r < BR; ++r) {
      const float a = deq(reinterpret_cast<const T*>(ta)[r]);
      float e = 0.f;
      if (__any_sync(FULL, a != 0.f)) {  // warp-uniform: e = 0 everywhere otherwise
        const float4* y4 = reinterpret_cast<const float4*>(sy + r * YS + g * SEG);
        float y[KC];
#pragma unroll
        for (int qq = 0; qq < KC / 4; ++qq) {
          const float4 h = y4[qq];
          y[4 * qq] = h.x, y[4 * qq + 1] = h.y, y[4 * qq + 2] = h.z, y[4 * qq + 3] = h.w;
        }
        float pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KC; ++j) pb[j % 4] = fmaf(y[j], xh[j], pb[j % 4]);
        float sb = (pb[0] + pb[1]) + (pb[2] + pb[3]);
        for (int o = G >> 1; o > 0; o >>= 1) sb += __shfl_xor_sync(FULL, sb, o);
        e = a != 0.f ? a - sb : 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = fmaf(e, y[j], acc[j]);
      }
      if (g == 0) se[cl * ES + r] = e;
    }
    __syncthreads();

    // The strip's dR tile over the block's columns, 8 k per thread.
    float* sdp = sd + p * K * BR;
    {
      const int r = t & (BR - 1), kg = t >> 5;
      for (int kb = kg * 8; kb < K; kb += 32) {
        float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int cc = 0; cc < BC; ++cc) {
          const float4* h4 = reinterpret_cast<const float4*>(xs + cc * KX + kb);
          const float4 h0 = h4[0], h1 = h4[1];
          const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const float ev = se[cc * ES + r];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) d[jj] = fmaf(h[jj], ev, d[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) sdp[(kb + jj) * BR + r] = d[jj];
      }
    }
    // The cluster's tiles summed in rank order into Rp's packed layout.
    cluster.sync();
    {
      const int r = t & (BR - 1), kg = t >> 5;
      const size_t cu = cb / C;
      for (int k = q + C * kg; k < K; k += 4 * C) {
        float sum = 0.f;
        for (int rho = 0; rho < C; ++rho) {
          const float v = cluster.map_shared_rank(sdp, rho)[k * BR + r];
          sum = rho == 0 ? v : sum + v;
        }
        part_r[cu * K * I + packed(k, r0 + r, K, strip)] = sum;
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

// x' = x + alpha2 * sum_s part[s], both sides, partials in ascending order.
__global__ void v2_update(const float* __restrict__ part_l, int s_l, const float* __restrict__ part_r,
                          int s_r, const float* __restrict__ lc, const float* __restrict__ rc,
                          float* __restrict__ ln, float* __restrict__ rn, size_t nl, size_t nr,
                          float alpha2) {
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
  const void* A;
  const float *Lt_in, *Rp_in;
  float *Lt_out, *Rp_out, *Lt_tmp, *Rp_tmp;
  float *part_l, *part_r;
  int K, U, I, strip, G, C, iters;
  float alpha2;
  int chunk, S;
  cudaStream_t stream;
};

template <typename T>
int train(const Args& a) {
  int lg = 0;
  while ((1 << lg) < a.G) ++lg;
  const int BC = BLOCK >> lg;
  if (a.U % BC || (a.U / BC) % a.C || a.C < 1 || a.C > 16 || a.chunk % BR || a.I % BR ||
      a.strip < 1 || a.I % a.strip)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(lg, a.K);
  cudaError_t err = cudaFuncSetAttribute(v2_pass<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (a.C > 8) {
    err = cudaFuncSetAttribute(v2_pass<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  const T* A = static_cast<const T*>(a.A);
  const float* lc = a.Lt_in;
  const float* rc = a.Rp_in;
  for (int it = 0; it < a.iters; ++it) {
    const bool to_out = (a.iters - 1 - it) % 2 == 0;  // the last step lands in the outputs
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rp_out : a.Rp_tmp;
    err = cudaLaunchKernelEx(&cfg, v2_pass<T>, A, lc, rc, a.part_l, a.part_r, a.K, a.U, a.I, a.strip, lg,
                             a.chunk);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    v2_update<<<apply_grid, 256, 0, a.stream>>>(a.part_l, a.S, a.part_r, s_r, lc, rc, ln, rn, nl, nr,
                                                a.alpha2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lc = ln;
    rc = rn;
  }
  if (a.iters == 0) {
    err = cudaMemcpyAsync(a.Lt_out, a.Lt_in, nl * sizeof(float), cudaMemcpyDeviceToDevice, a.stream);
    if (err != cudaSuccess) return err;
    err = cudaMemcpyAsync(a.Rp_out, a.Rp_in, nr * sizeof(float), cudaMemcpyDeviceToDevice, a.stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// P3: `iters` GD steps on A (U, I) and the packed Rp (I / strip * K, strip).
// a_kind: 0 int8 (2x rating), 1 bf16, 2 f32.  The caller (ops/stream_v2.py)
// checks shapes and takes (G, C, chunk, S) from B3's split: U a multiple of
// 128, K <= 32*G, I a multiple of strip and of 32, part_l (S, K, U), part_r
// (U*G / (128*C), K * I).  Returns the first non-zero cudaError_t, else 0.
extern "C" int rs_stream_v2_train(const void* A, int a_kind, const float* Lt_in, const float* Rp_in,
                                  float* Lt_out, float* Rp_out, float* Lt_tmp, float* Rp_tmp,
                                  float* part_l, float* part_r, int K, int U, int I, int strip, int G,
                                  int C, int iters, float alpha2, int chunk, int S, void* stream) {
  const Args a{A, Lt_in, Rp_in, Lt_out, Rp_out, Lt_tmp, Rp_tmp, part_l, part_r, K, U, I, strip, G, C,
               iters, alpha2, chunk, S, static_cast<cudaStream_t>(stream)};
  switch (a_kind) {
    case 0: return train<int8_t>(a);
    case 1: return train<__nv_bfloat16>(a);
    case 2: return train<float>(a);
  }
  return cudaErrorInvalidValue;
}
