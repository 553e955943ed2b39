// BELL side update and row gathers for NVIDIA Hopper (sm_90a): the engine form
// of the TPU probe kernel P2 and the probe's own functions.
//
// Replaces the TPU kernels of scripts/probe_mosaic_gather.py::pcall (:94, call
// :100): p1_kernel, p2_kernel and p3_kernel (:118-133), three lowerings of one
// row gather out[s] = table[idx[s]], here rs_gather_rows; and p4_kernel (:139),
// the gather fused with the BELL error and gradient math, here
// rs_gather_err_grad as the probe wrote it and rs_bell_side_update in the form
// the engine steps with (recsys_tpu/ops/bell.py::bell_gd_step :628, whose JAX
// body is plain XLA).
//
// rs_bell_side_update: one side of a BELL GD step.  For every own row j with at
// least one entry, and its slots in table order (file order), with opposite row
// c and value v:
//
//     dot = 0;  dot = dot + F_own[j][f] * F_other[c][f]     for f = 0..k-1
//     e   = alpha2 * (v - dot)
//     acc = F_own[j];  acc[f] = acc[f] + e * F_other[c][f]  slot after slot
//
// reading the snapshot (F_own, F_other) and writing out.  Every product and
// sum is rounded on its own (__dmul_rn/__dadd_rn, __fmul_rn/__fadd_rn: the
// build's -O3 would contract a*b+c into an FMA), the dot runs f = 0..k-1 and the
// slots in file order: the order of rs_serial_gd (csrc/recsys_native.c), so in
// f64 the factors are bit for bit the reference binary's.  No float atomics,
// and one row's slots never split across warps: two runs give the same bits.
//
// What bounds it on this card.  The function needs 4k operations a slot (dot
// and update) and moves each gathered row (slots * k values) plus the own rows
// in and out.  But the dot of a slot is a chain of k dependent adds by
// contract, and a row's updates are a chain over its slots, so it is bound by
// latency unless many chains are in flight.
//
// What the design does about that.
//  * A warp owns a row and keeps its accumulator in registers, KPL values a
//    lane (f = m*32 + lane, k <= 32 * KPL <= 1024).
//  * The dots of a row's slots are independent (they read the snapshot), so
//    the lanes take 32 slots at a time, each lane one slot's chain; then the
//    warp adds the 32 products into the row in slot order, e and c passed by
//    shuffles, the next slots' rows loaded ahead of their adds.
//  * Buckets narrower than 32 slots give a warp 32 / w rows, so that rows of
//    one to three ratings (the 1M-user side of gen-inst1e6) still fill the
//    lanes with dots.
//  * Padding slots (index = the opposite zero row) are skipped: no value test,
//    a stored rating of 0 is a real entry.
//
// rs_gather_rows / rs_gather_err_grad are P2's functions at the probe's shapes:
// one thread per float4 of a gathered row, and a warp per slot whose err is
// the butterfly sum of its lanes' products (another order than the XLA
// reduction inside the TPU kernel: held to a stated f32 tolerance).
//
// Later work: the longest rows set the time (one warp walks a hub row's slots:
// 737 at instML100k, ~20,000 at gen-inst1e6).  Their dots are independent and
// could spread over several warps, the adds staying in one.  Issuing each
// dot's loads in chunks, and more rows a load round, was tried and did not
// make the step faster across the shapes timed.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr int BLOCK = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Rn;
template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};
template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

// One degree bucket of a side (ops/bell.py::side_warps): rows [b0, b0 + n) of
// width w, whose (w, n) tables start at flat offset base; its warps start at
// warp0 and take rpw rows each.
struct Bucket {
  long long base, warp0, b0, n, w, rpw;
};

// e = alpha2 * (v - <own row, other row>), the dot in order f = 0..k-1.
template <typename T>
__device__ __forceinline__ T slot_err(const T* __restrict__ fo, const T* __restrict__ go, int k, T v,
                                      T alpha2) {
  T dot = T(0);
#pragma unroll 4
  for (int f = 0; f < k; ++f) dot = Rn<T>::add(dot, Rn<T>::mul(__ldg(fo + f), __ldg(go + f)));
  return Rn<T>::mul(alpha2, Rn<T>::sub(v, dot));
}

// Slots batched per load round: as many gathered rows in flight as keep the
// lane's registers at 16 values or fewer.
template <int KPL>
struct Batch {
  static constexpr int value = KPL >= 16 ? 1 : (16 / KPL > 8 ? 8 : 16 / KPL);
};

// acc += e_t * F_other[c_t] for the live lanes t in [t0, t1), in order.
template <typename T, int KPL>
__device__ __forceinline__ void add_slots(T (&acc)[KPL], unsigned live, int t0, int t1, int c, T e,
                                          const T* __restrict__ other, int k, int lane) {
  constexpr int B = Batch<KPL>::value;
  for (int t = t0; t < t1; t += B) {
    T g[B][KPL];
    T et[B];
    bool on[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int tt = t + u;
      et[u] = __shfl_sync(FULL, e, tt & 31);
      const int ct = __shfl_sync(FULL, c, tt & 31);
      on[u] = tt < t1 && ((live >> (tt & 31)) & 1u);
      const T* row = other + static_cast<size_t>(ct) * k;
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const int f = m * 32 + lane;
        g[u][m] = on[u] && f < k ? __ldg(row + f) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (!on[u]) continue;  // warp-uniform
#pragma unroll
      for (int m = 0; m < KPL; ++m) acc[m] = Rn<T>::add(acc[m], Rn<T>::mul(et[u], g[u][m]));
    }
  }
}

template <typename T, int KPL>
__device__ __forceinline__ void load_row(T (&acc)[KPL], const T* __restrict__ row, int k, int lane) {
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int f = m * 32 + lane;
    acc[m] = f < k ? __ldg(row + f) : T(0);
  }
}

template <typename T, int KPL>
__device__ __forceinline__ void store_row(const T (&acc)[KPL], T* __restrict__ row, int k, int lane) {
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int f = m * 32 + lane;
    if (f < k) row[f] = acc[m];
  }
}

template <typename T, int KPL>
__global__ void __launch_bounds__(BLOCK)
    side_update(const T* __restrict__ own, const T* __restrict__ other, T* __restrict__ out,
                const int* __restrict__ idx, const T* __restrict__ vals, const Bucket* __restrict__ bk,
                int nb, long long warps, int k, int pad, T alpha2) {
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (g >= warps) return;  // warp-uniform
  int lo = 0, hi = nb - 1;  // the bucket holding warp g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bk[mid].warp0 <= g) lo = mid;
    else hi = mid - 1;
  }
  const Bucket b = bk[lo];
  const long long r0 = (g - b.warp0) * b.rpw;  // first row of the warp, in the bucket
  const int rows = static_cast<int>(b.n - r0 < b.rpw ? b.n - r0 : b.rpw);
  const int w = static_cast<int>(b.w);
  const long long n = b.n;
  T acc[KPL];
  if (b.rpw == 1) {  // one row, its slots 32 at a time
    const long long j = b.b0 + r0;
    load_row(acc, own + j * k, k, lane);
    for (int s0 = 0; s0 < w; s0 += 32) {
      const int s = s0 + lane;
      int c = pad;
      T e = T(0);
      if (s < w) {
        const long long p = b.base + s * n + r0;
        c = __ldg(idx + p);
        if (c != pad) e = slot_err(own + j * k, other + static_cast<size_t>(c) * k, k, __ldg(vals + p), alpha2);
      }
      const unsigned live = __ballot_sync(FULL, s < w && c != pad);
      add_slots(acc, live, 0, min(32, w - s0), c, e, other, k, lane);
    }
    store_row(acc, out + j * k, k, lane);
    return;
  }
  // rows * w <= 32 slots: lane -> (row q = lane / w, slot s = lane % w).
  const int q = lane / w, s = lane - q * w;
  int c = pad;
  T e = T(0);
  if (q < rows) {
    const long long p = b.base + s * n + r0 + q;
    c = __ldg(idx + p);
    if (c != pad)
      e = slot_err(own + (b.b0 + r0 + q) * k, other + static_cast<size_t>(c) * k, k, __ldg(vals + p), alpha2);
  }
  const unsigned live = __ballot_sync(FULL, q < rows && c != pad);
  for (int r = 0; r < rows; ++r) {
    const long long j = b.b0 + r0 + r;
    load_row(acc, own + j * k, k, lane);
    add_slots(acc, live, r * w, r * w + w, c, e, other, k, lane);
    store_row(acc, out + j * k, k, lane);
  }
}

template <typename T, int KPL>
int launch_side(const void* own, const void* other, void* out, const int* idx, const void* vals,
                const void* buckets, int nb, long long warps, int k, int pad, double alpha2,
                cudaStream_t stream) {
  const long long blocks = (warps + WARPS - 1) / WARPS;
  side_update<T, KPL><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(
      static_cast<const T*>(own), static_cast<const T*>(other), static_cast<T*>(out), idx,
      static_cast<const T*>(vals), static_cast<const Bucket*>(buckets), nb, warps, k, pad,
      static_cast<T>(alpha2));
  return cudaGetLastError();
}

template <typename T>
int dispatch_k(const void* own, const void* other, void* out, const int* idx, const void* vals,
               const void* buckets, int nb, long long warps, int k, int pad, double alpha2,
               cudaStream_t st) {
  if (k <= 32) return launch_side<T, 1>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  if (k <= 64) return launch_side<T, 2>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  if (k <= 128) return launch_side<T, 4>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  if (k <= 256) return launch_side<T, 8>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  if (k <= 512) return launch_side<T, 16>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  if (k <= 1024) return launch_side<T, 32>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  return cudaErrorInvalidValue;
}

// out[s, :] = table[idx[s], :], four values a thread (K % 4 == 0, rows
// 16-byte aligned: the wrapper checks both).
__global__ void gather_rows4(const float4* __restrict__ table, const int* __restrict__ idx,
                             float4* __restrict__ out, long long S, int K4) {
  const long long total = S * K4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long s = i / K4;
    out[i] = __ldg(table + static_cast<size_t>(__ldg(idx + s)) * K4 + (i - s * K4));
  }
}

// p4_kernel: g = table[idx[s]], fo = 0.5 * table[s mod blk],
// err = 0.001 * (vals[s] - <fo, g>), out[s] = err * g.  A warp per slot.
__global__ void __launch_bounds__(BLOCK)
    gather_err_grad(const float* __restrict__ table, const int* __restrict__ idx,
                    const float* __restrict__ vals, float* __restrict__ out, long long S, int K, int blk) {
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const float* g = table + static_cast<size_t>(__ldg(idx + s)) * K;
  const float* fo = table + static_cast<size_t>(s % blk) * K;
  float part = 0.f;
  for (int f = lane; f < K; f += 32) part += (0.5f * __ldg(fo + f)) * __ldg(g + f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  const float err = 0.001f * (__ldg(vals + s) - part);
  for (int f = lane; f < K; f += 32) out[s * K + f] = err * __ldg(g + f);
}

int grid_for(long long work) {
  const long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

// One side of a BELL step (ops/bell.py::bell_side_update).  own (size + 1, k)
// and other (other size + 1, k) are the snapshot, out receives own's rows
// updated (the caller fills rows past the side's n_nz); idx/vals are the flat
// side tables; buckets (nb, 6) int64 rows of Bucket; pad is the opposite zero
// row's index.  f64: 1 for double, 0 for float.  Returns the first non-zero
// cudaError_t, else 0.
extern "C" int rs_bell_side_update(const void* own, const void* other, void* out, const int* idx,
                                   const void* vals, const void* buckets, int nb, long long warps,
                                   int k, int pad, double alpha2, int f64, void* stream) {
  if (k <= 0 || nb <= 0 || warps <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) return dispatch_k<double>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
  return dispatch_k<float>(own, other, out, idx, vals, buckets, nb, warps, k, pad, alpha2, st);
}

// P2's p1/p2/p3: out (S, K) = table[idx] (f32, K % 4 == 0, 16-byte aligned).
extern "C" int rs_gather_rows(const float* table, const int* idx, float* out, long long S, int K,
                              void* stream) {
  if (S <= 0 || K <= 0 || K % 4 != 0) return cudaErrorInvalidValue;
  gather_rows4<<<grid_for(S * K / 4), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), S, K / 4);
  return cudaGetLastError();
}

// P2's p4: out (S, K) = err * table[idx] with err from the stand-in partner
// 0.5 * table[s mod blk] (f32).
extern "C" int rs_gather_err_grad(const float* table, const int* idx, const float* vals, float* out,
                                  long long S, int K, int blk, void* stream) {
  if (S <= 0 || K <= 0 || blk <= 0) return cudaErrorInvalidValue;
  gather_err_grad<<<static_cast<unsigned>((S + WARPS - 1) / WARPS), BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(table, idx, vals, out, S, K, blk);
  return cudaGetLastError();
}
