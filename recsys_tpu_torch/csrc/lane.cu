// The TPU probe P1's two loops for NVIDIA Hopper (sm_90a): an in-kernel
// gather along a row, and a scan along a row, each repeated T times.
//
// Replaces the Pallas kernels of scripts/probe_gather.py:
//   * run_gather (:40, body gather_kernel :29): out = 0, then T times
//     out = 0.5 * out + take_along_axis(tab, idx, axis=1), tab f32 (S, W),
//     idx int32 (S, W) in [0, W);
//   * run_cumsum (:57, body cumsum_kernel :48): T times
//     out = 0 * out + cumsum(x, axis=1), x f32 (S, W).  The TPU body reads
//     out before its first write; the function's defined result is cumsum(x)
//     for any finite start, and this kernel starts from out = 0.
// The probe asks what an in-kernel lane gather and a lane scan cost, as the
// substrate of a resident sparse kernel.  On Hopper both live in shared
// memory, so that is what these kernels measure.
//
// lane_gather_loop.  The whole table row sits in shared memory (W = 32768
// is 128 KB of the 227 KB a block may take).  Each row is split into spans
// over several blocks, about one block per SM in all, so S = 8 rows fill
// the card; each block loads its full row, since an index may point
// anywhere in it.  A thread keeps its PER outputs and their indices in
// registers and gathers from shared memory each step.  Bound: the gathers
// read S * W * T * 4 bytes of shared memory, 32 random addresses a warp,
// so bank conflicts cost ~3.5 passes each; HBM moves only tab, idx and
// out once.
//
// lane_cumsum_loop.  One block per row: a thread owns EPT consecutive
// elements, held in shared memory with slot j of every thread contiguous
// ([j][thread], skewed so that no access has bank conflicts).  A step sums its elements in order,
// scans the thread totals across the warp with shuffles and across the
// warps through shared memory (the block carry), then walks its elements
// again from its offset.  Bound: shared memory again (2 * S * W * T * 4
// bytes read); S blocks use S SMs.
//
// Both bodies are loop-invariant: the gather and the scan give the same
// values every step.  The row is read through a volatile pointer, so each
// step performs its shared-memory reads and the arithmetic that follows,
// and the time grows with T.  Products and sums are __fmul_rn/__fadd_rn,
// torch's order for the gather's 0.5 * out + g, so the gather equals its
// twin bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may opt into (H100)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Grid (cpr, S): block (c, s) owns row s's outputs [c*span, min(W, c*span + span)),
// thread i the outputs begin + i + m*blockDim for m < PER.  With `vec` (W a
// multiple of 4, tab 16-byte aligned) the row comes in as 16-byte cp.async
// copies all in flight at once: the load is the kernel's fixed cost.
template <int PER>
__global__ void __launch_bounds__(1024)
    gather_loop(const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
                int W, int span, int t, int vec) {
  extern __shared__ __align__(16) float row[];
  const size_t base = static_cast<size_t>(blockIdx.y) * W;
  if (vec) {
    for (int i = threadIdx.x; i < W / 4; i += blockDim.x) cp_async16(row + 4 * i, tab + base + 4 * i);
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int i = threadIdx.x; i < W; i += blockDim.x) row[i] = __ldg(tab + base + i);
  }
  __syncthreads();

  const int begin = blockIdx.x * span;
  const int end = min(W, begin + span);
  int ix[PER];
  float acc[PER];
  bool live[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int w = begin + threadIdx.x + m * blockDim.x;
    live[m] = w < end;
    ix[m] = live[m] ? __ldg(idx + base + w) : 0;
    acc[m] = 0.f;
  }
  const volatile float* vrow = row;
#pragma unroll 4
  for (int step = 0; step < t; ++step) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      if (live[m]) acc[m] = __fadd_rn(__fmul_rn(acc[m], 0.5f), vrow[ix[m]]);
    }
  }
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    if (live[m]) out[base + begin + threadIdx.x + m * blockDim.x] = acc[m];
  }
}

// Grid (S); blockDim NT threads, NT * EPT >= W.  Element e of the row is
// slot e % EPT of thread e / EPT, at sx[slot * LD + thread] with the slot
// stride LD = NT + 32 / EPT: a warp's 32 consecutive elements then fall in
// 32 banks, so the row comes in and the result goes out coalesced and free
// of bank conflicts, and a step's reads (one slot of 32 threads) too.
// Elements past W are 0 and come after every real one, so they change no
// prefix.
template <int EPT>
__global__ void __launch_bounds__(1024, 1)
    cumsum_loop(const float* __restrict__ x, float* __restrict__ out, int W, int t) {
  extern __shared__ float sx[];
  __shared__ float wsum[2][32];
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LD = NT + 32 / EPT;
  const size_t base = static_cast<size_t>(blockIdx.x) * W;
  for (int e = tid; e < NT * EPT; e += NT) sx[(e % EPT) * LD + e / EPT] = e < W ? __ldg(x + base + e) : 0.f;
  __syncthreads();

  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;
  const volatile float* v = sx;
  for (int step = 0; step < t; ++step) {
    float total = 0.f;  // the thread's elements, in order
#pragma unroll
    for (int j = 0; j < EPT; ++j) total = __fadd_rn(total, v[j * LD + tid]);
    float incl = total;  // inclusive scan of the warp's totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, y);
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    float* ws = wsum[step & 1];  // alternate buffers: no barrier at the top of a step
    if (lane == 31) ws[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the block carry: an inclusive scan of the warp totals
      float w = lane < (NT >> 5) ? ws[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w = __fadd_rn(w, y);
      }
      ws[lane] = w;
    }
    __syncthreads();
    float run = warp > 0 ? __fadd_rn(ws[warp - 1], excl) : excl;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      run = __fadd_rn(run, v[j * LD + tid]);
      acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.f), run);
    }
  }
  __syncthreads();  // every step's reads of sx are done
#pragma unroll
  for (int j = 0; j < EPT; ++j) sx[j * LD + tid] = acc[j];
  __syncthreads();
  for (int e = tid; e < W; e += NT) out[base + e] = sx[(e % EPT) * LD + e / EPT];
}

template <int PER>
int launch_gather(const float* tab, const int* idx, float* out, int S, int W, int span, int threads,
                  int cpr, int t, cudaStream_t stream) {
  const int smem = W * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(gather_loop<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
  gather_loop<PER><<<dim3(cpr, S), threads, smem, stream>>>(tab, idx, out, W, span, t, vec);
  return cudaGetLastError();
}

template <int EPT>
int launch_cumsum(const float* x, float* out, int S, int W, int NT, int t, cudaStream_t stream) {
  const int smem = (NT + 32 / EPT) * EPT * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cumsum_loop<EPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cumsum_loop<EPT><<<S, NT, smem, stream>>>(x, out, W, t);
  return cudaGetLastError();
}

}  // namespace

// P1a.  tab, out f32 (S, W) and idx int32 (S, W) with every index in
// [0, W); W * 4 bytes fit in a block's shared memory.  `sms` is the card's
// SM count.  Returns the first non-zero cudaError_t, else 0.
extern "C" int rs_lane_gather_loop(const float* tab, const int* idx, float* out, int S, int W, int t,
                                   int sms, void* stream) {
  if (S < 1 || W < 1 || t < 0 || static_cast<long long>(W) * 4 > SMEM_MAX) return cudaErrorInvalidValue;
  // Blocks per row: about one block per SM in all, at least 32 outputs a
  // block, at most 16 * 512 so PER stays within the instances below.
  const int cpr = std::max((W + 8191) / 8192, std::max(1, std::min(sms / S, (W + 31) / 32)));
  const int span = (W + cpr - 1) / cpr;
  int per = 1;
  while (per * 512 < span) per *= 2;
  const int threads = ((span + per - 1) / per + 31) / 32 * 32;
  const int grid = (W + span - 1) / span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: return launch_gather<1>(tab, idx, out, S, W, span, threads, grid, t, st);
    case 2: return launch_gather<2>(tab, idx, out, S, W, span, threads, grid, t, st);
    case 4: return launch_gather<4>(tab, idx, out, S, W, span, threads, grid, t, st);
    case 8: return launch_gather<8>(tab, idx, out, S, W, span, threads, grid, t, st);
    case 16: return launch_gather<16>(tab, idx, out, S, W, span, threads, grid, t, st);
  }
  return cudaErrorInvalidValue;
}

// P1b.  x, out f32 (S, W), W a multiple of 32 up to 32768.
extern "C" int rs_lane_cumsum_loop(const float* x, float* out, int S, int W, int t, void* stream) {
  if (S < 1 || W < 32 || W % 32 || W > 32768 || t < 0) return cudaErrorInvalidValue;
  const int NT = std::min(W, 1024);
  int ept = 1;
  while (ept * NT < W) ept *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ept) {
    case 1: return launch_cumsum<1>(x, out, S, W, NT, t, st);
    case 2: return launch_cumsum<2>(x, out, S, W, NT, t, st);
    case 4: return launch_cumsum<4>(x, out, S, W, NT, t, st);
    case 8: return launch_cumsum<8>(x, out, S, W, NT, t, st);
    case 16: return launch_cumsum<16>(x, out, S, W, NT, t, st);
    case 32: return launch_cumsum<32>(x, out, S, W, NT, t, st);
  }
  return cudaErrorInvalidValue;
}
