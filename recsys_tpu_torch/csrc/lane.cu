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
//     for any finite start, and these kernels start from out = 0.
// The probe asks what an in-kernel lane gather and a lane scan cost, as the
// substrate of a resident sparse kernel.  On Hopper both live in shared
// memory, so that is what these kernels measure.
//
// lane_gather_loop (gather_banked).  The whole table row sits in shared
// memory (W = 32768 is 128 KB of the 227 KB a block may take).  Each row
// is split into spans over several blocks, about one block per SM in all,
// so S = 8 rows fill the card; each block loads its full row, since an
// index may point anywhere in it.  While the row comes in by cp.async, the
// block builds a schedule of its outputs: bucketed by bank (index mod 32)
// with shared-memory counters, lane b takes bank b's outputs, round after
// round, a round being one (warp, slot) pair.  So each warp-wide load of a
// step reads 32 distinct banks, and a step costs as many shared-memory
// wavefronts as the fullest bucket holds outputs (~85 for a span of 2048
// random indices, against ~224 with conflicts).  Rounds are capped at twice
// the mean bucket; what a fuller bucket holds beyond the cap goes to the
// free cells of other lanes (those loads conflict, and equal addresses
// broadcast).  The schedule lives beside the row in shared memory, or in a
// scratch buffer in device memory where the two do not fit; it is built on
// the card in every launch.  A thread keeps its outputs' indices in
// registers for all T steps.
// It replaced a form whose thread i took the outputs begin + i + m *
// blockDim, so that a warp's 32 random indices cost ~3.5 wavefronts a
// load.  Bound: the gathers read S * W * T * 4 bytes of shared memory; HBM
// moves only tab, idx and out once.
//
// lane_cumsum_loop (cumsum_cluster).  A row is split over the C blocks of
// a thread-block cluster (grid (C, S), C <= 8 by lane.cumsum_cluster_plan),
// so S * C of the card's SMs work where the block form it replaced, one
// block a row, used S.  The decomposition is the block form's (NT =
// min(W, 1024) threads in all, EPT consecutive elements a thread, a zero
// tail) with the NT / 32 warps dealt out to the cluster's blocks.  A step reads the thread's elements once
// (into registers) and sums them in order; the warp's totals are scanned
// by five shuffles; each warp pushes its total into every block of the
// cluster by st.async, which completes bytes on that block's mbarrier; then
// every warp reads the row's NT / 32 warp totals from its own block's
// shared memory and scans them as the block form's warp 0 did (the block
// carry), and walks its elements from its offset.  Every sum is the block
// form's, in its order (lane.lane_cumsum_loop_order_plain): the two were
// shown equal in raw bits on the card when this form replaced the other
// (PERF.md section 6).  The totals of step
// s + 1 are pushed while step s waits for its own, on a ring of four slots
// and barriers, so two steps are in flight and no cluster barrier is
// needed a step.  The step's floor is the exchange's latency, not bytes
// (an exchange by a cluster.sync() a step read about 2.6x slower on an
// H100; PERF.md section 6).
// Bound: shared memory (S * W * T * 4 bytes read once; the block form read
// the row twice a step).
//
// Both bodies are loop-invariant: the gather and the scan give the same
// values every step.  The row is read through a volatile pointer, so each
// step performs its shared-memory reads and the arithmetic that follows,
// and the time grows with T.  Products and sums are __fmul_rn/__fadd_rn,
// torch's order for the gather's 0.5 * out + g, so the gather equals its
// twin bit for bit; the scan's order is lane.lane_cumsum_loop_order_plain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may opt into (H100)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The gather's t steps over the first `live` of a thread's PER slots: a
// loop of exactly L = live slots, chosen by recursion on L, so no slot is
// tested in the loop.
template <int PER, int L>
__device__ __forceinline__ void gather_steps(int live, float (&acc)[PER], const int (&ix)[PER], const float* row,
                                             int t) {
  if constexpr (L > 0) {
    if (live < L) return gather_steps<PER, L - 1>(live, acc, ix, row, t);
    const volatile float* vrow = row;
#pragma unroll 4
    for (int step = 0; step < t; ++step) {
#pragma unroll
      for (int m = 0; m < L; ++m) acc[m] = __fadd_rn(__fmul_rn(acc[m], 0.5f), vrow[ix[m]]);
    }
  }
}

// A block's scratch after its row: the bank counters, the exclusive prefix
// sums of the overflow and free cells by lane, the rounds used, then the
// schedule, one cell a (round, lane): (index << 16) | output, or EMPTY.
constexpr int META = 4 * 32;
constexpr unsigned EMPTY = 0xffffffffu;

// Grid (grid, S): block (c, s) owns row s's outputs [c*span, min(W,
// c*span + span)); blockDim NT = 32 * NW.  With `vec` (W a multiple of 4,
// tab 16-byte aligned) the row comes in as 16-byte cp.async copies.
// Rounds R_CAP = NW * PER; round r is slot r / NW of warp r % NW, so the
// rounds in use are spread over every warp, and a warp runs a loop of
// exactly its slots in use.
// `scratch` null: the schedule follows the row in shared memory; else it
// is the block's part of that device buffer.
template <int PER>
__global__ void __launch_bounds__(512, 1)
    gather_banked(const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
                  int* __restrict__ scratch, int W, int span, int t, int vec) {
  extern __shared__ __align__(16) float row[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, NT = blockDim.x, NW = NT >> 5;
  const int R_CAP = NW * PER;
  const size_t base = static_cast<size_t>(blockIdx.y) * W;
  const int begin = blockIdx.x * span, n = min(W, begin + span) - begin;
  int* meta = scratch ? scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * (META + R_CAP * 32)
                      : reinterpret_cast<int*>(row + W);
  int *cnt = meta, *ovf0 = meta + 32, *free0 = meta + 64, *rounds = meta + 96;
  unsigned* sched = reinterpret_cast<unsigned*>(meta + META);

  // The block's indices, then the row, come in while the schedule is built.
  constexpr int ITEMS = PER / 2;  // NT * ITEMS >= span
  int myix[ITEMS], mypos[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * NT;
    myix[k] = i < n ? __ldg(idx + base + begin + i) : 0;
  }
  if (vec) {
    for (int i = tid; i < W / 4; i += NT) cp_async16(row + 4 * i, tab + base + 4 * i);
  } else {
    for (int i = tid; i < W; i += NT) row[i] = __ldg(tab + base + i);
  }
  if (tid < 32) cnt[tid] = 0;
  for (int c = tid; c < R_CAP * 32; c += NT) sched[c] = EMPTY;
  __syncthreads();
  // Bucket the outputs by bank: output i lands at position pos of bucket
  // ix & 31.  The order within a bucket is the atomics' and changes no
  // output's value.
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (tid + k * NT < n) mypos[k] = atomicAdd(cnt + (myix[k] & 31), 1);
  }
  __syncthreads();
  if (warp == 0) {  // lane b: bank b's own rounds, overflow and free cells
    const int c = cnt[lane], own = min(c, R_CAP), o = c - own, f = R_CAP - own;
    int so = o, sf = f, m = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yo = __shfl_up_sync(FULL, so, off), yf = __shfl_up_sync(FULL, sf, off);
      if (lane >= off) so += yo, sf += yf;
      m = max(m, __shfl_xor_sync(FULL, m, off));
    }
    ovf0[lane] = so - o;
    free0[lane] = sf - f;
    if (lane == 31) rounds[0] = so > 0 ? R_CAP : m;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * NT;
    if (i < n) {
      const int b = myix[k] & 31, p = mypos[k];
      int cell = p * 32 + b;
      if (p >= R_CAP) {  // the j-th overflow output takes the j-th free cell, lanes in order
        const int j = ovf0[b] + p - R_CAP;
        int L = 0;
        while (j >= free0[L] + R_CAP - min(cnt[L], R_CAP)) ++L;
        cell = (cnt[L] + j - free0[L]) * 32 + L;
      }
      sched[cell] = static_cast<unsigned>(myix[k]) << 16 | static_cast<unsigned>(i);
    }
  }
  __syncthreads();

  const int R = rounds[0];
  const int live = R > warp ? (R - warp + NW - 1) / NW : 0;  // the warp's slots in use
  const int idle = lane < W ? lane : 0;  // an empty cell reads its own bank and is never stored
  int ix[PER];
  float acc[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const unsigned c = sched[(m * NW + warp) * 32 + lane];
    ix[m] = c == EMPTY ? idle : static_cast<int>(c >> 16);
    acc[m] = 0.f;
  }
  if (vec) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  gather_steps<PER, PER>(live, acc, ix, row, t);
  __syncthreads();  // every step's reads of the row are done: it stages the outputs
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    if (m < live) {
      const unsigned c = sched[(m * NW + warp) * 32 + lane];
      if (c != EMPTY) row[c & 0xffffu] = acc[m];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += NT) out[base + begin + i] = row[i];
}

// Pass 1 of a step: the thread's elements into registers, summed in order
// from 0, then the warp's inclusive and exclusive scans of those totals.
template <int EPT>
__device__ __forceinline__ void scan_pass1(const volatile float* v, int LD, int tid, int lane, float (&xv)[EPT],
                                           float& incl, float& excl) {
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    xv[j] = v[j * LD + tid];
    total = __fadd_rn(total, xv[j]);
  }
  incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, y);
  }
  excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The warp's total (in lane 31's incl) into slot `gw` of `wslot` in each of
// the cluster's C blocks by st.async, lane r serving block r: the store
// completes 4 bytes of the transaction count of that block's `bar`.  No
// fence: the data is visible to the block once the barrier's phase
// completes.
__device__ __forceinline__ void push_total(float* wslot, unsigned long long* bar, int gw, float incl, int lane, int C) {
  const float tot = __shfl_sync(FULL, incl, 31);
  if (lane < C) {
    unsigned rw, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rw) : "r"(smem_addr(wslot + gw)), "r"(lane));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(lane));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(rw), "f"(tot),
                 "r"(rb) : "memory");
  }
}

__device__ __forceinline__ void wait_parity(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Grid (C, S) in clusters of (C, 1, 1); blockDim NB = NT / C.  Block q of
// row s holds the row's threads q * NB .. (q + 1) * NB - 1 of the block
// form, their elements in its shared memory in the block form's skewed
// layout (slot stride LD = NB + 32 / EPT).  Step s's warp totals go to
// slot s % 4 of every block (wsum, bar): pushed during step s - 1, so two
// steps are in flight.  A slot is written again 4 steps on; by then every
// block has read it: a warp pushes step s + 1 only after reading step s - 1,
// and a pusher of step s + 4 has waited on step s + 2, which every warp
// pushed after reading step s.  Thread 0 of each block sets a phase's 4 *
// NWARP expected bytes at the start of its step; the bytes may come first.
template <int EPT>
__global__ void __launch_bounds__(EPT == 1 ? 1024 : 256, 1)
    cumsum_cluster(const float* __restrict__ x, float* __restrict__ out, int W, int t) {
  extern __shared__ float sx[];
  __shared__ float wsum[4][32];
  __shared__ __align__(8) unsigned long long bar[4];
  cg::cluster_group cluster = cg::this_cluster();
  const int NB = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = gridDim.x;
  const int q = static_cast<int>(cluster.block_rank()), NWARP = (NB >> 5) * C;
  const int gw = q * (NB >> 5) + warp;  // the warp's number in the row
  const int LD = NB + 32 / EPT, e0 = q * NB * EPT;
  const size_t base = static_cast<size_t>(blockIdx.y) * W;
  for (int e = tid; e < NB * EPT; e += NB) sx[(e % EPT) * LD + e / EPT] = e0 + e < W ? __ldg(x + base + e0 + e) : 0.f;
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + k)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // the slices are in and every block's barriers set before the first push

  float acc[EPT], xv[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;
  const volatile float* v = sx;
  float incl, excl;
  if (t > 0) {
    scan_pass1<EPT>(v, LD, tid, lane, xv, incl, excl);
    push_total(wsum[0], bar, gw, incl, lane, C);
  }
  for (int step = 0; step < t; ++step) {
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar + (step & 3))),
                   "r"(4 * NWARP) : "memory");
    float xn[EPT], incl_n = 0.f, excl_n = 0.f;
    if (step + 1 < t) {  // the next step's pass 1 and push, in flight with this step's exchange
      scan_pass1<EPT>(v, LD, tid, lane, xn, incl_n, excl_n);
      push_total(wsum[(step + 1) & 3], bar + ((step + 1) & 3), gw, incl_n, lane, C);
    }
    wait_parity(bar + (step & 3), (step >> 2) & 1);
    // The block carry: an inclusive scan of the row's warp totals.
    float w = lane < NWARP ? wsum[step & 3][lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = __fadd_rn(w, y);
    }
    const float carry = __shfl_sync(FULL, w, (gw + 31) & 31);
    float run = gw > 0 ? __fadd_rn(carry, excl) : excl;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      run = __fadd_rn(run, xv[j]);
      acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.f), run);
      xv[j] = xn[j];
    }
    excl = excl_n;
  }
  cluster.sync();  // no block leaves while another may still push into it
#pragma unroll
  for (int j = 0; j < EPT; ++j) sx[j * LD + tid] = acc[j];
  __syncthreads();
  for (int e = tid; e < NB * EPT && e0 + e < W; e += NB) out[base + e0 + e] = sx[(e % EPT) * LD + e / EPT];
}

template <int PER>
int launch_banked(const float* tab, const int* idx, float* out, int* scratch, int S, int W, int span, int threads,
                  int grid, int t, cudaStream_t stream) {
  const int smem = (W + (scratch ? 0 : META + threads * PER)) * 4;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gather_banked<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
  gather_banked<PER><<<dim3(grid, S), threads, smem, stream>>>(tab, idx, out, scratch, W, span, t, vec);
  return cudaGetLastError();
}

// Launches cumsum_cluster, or with `clusters` set only reports how many
// of its clusters the card holds at once.
template <int EPT>
int launch_cluster(const float* x, float* out, int S, int W, int C, int t, int* clusters, cudaStream_t stream) {
  const int NB = std::min(W, 1024) / C;
  const int smem = (NB + 32 / EPT) * EPT * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cumsum_cluster<EPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, S, 1);
  cfg.blockDim = dim3(NB, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(cumsum_cluster<EPT>), &cfg);
  err = cudaLaunchKernelEx(&cfg, cumsum_cluster<EPT>, x, out, W, t);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The spans of lane.gather_plan: `grid` blocks a row of `span` outputs,
// `threads` threads a block; false where they do not cover the row.
static bool spans_ok(int S, int W, int t, int grid, int span, int threads) {
  return S >= 1 && W >= 1 && W <= 65535 && t >= 0 && static_cast<long long>(W) * 4 <= SMEM_MAX && span >= 1 &&
         grid >= 1 && (grid - 1) * span < W && static_cast<long long>(grid) * span >= W && threads >= 32 &&
         threads <= 512 && threads % 32 == 0;
}

// P1a (gather_banked): tab, out f32 (S, W) and idx int32 (S, W) with every
// index in [0, W); W * 4 bytes fit in a block's shared memory; the spans of
// lane.gather_plan (`grid` blocks a row of `span` outputs, `threads`
// threads), `slots` cells of the schedule a thread and `scratch`, null where
// the schedule fits beside the row in shared memory, else
// S * grid * (128 + threads * slots) ints.  Returns the first non-zero
// cudaError_t, else 0.
extern "C" int rs_lane_gather_loop(const float* tab, const int* idx, float* out, int* scratch, int S, int W, int t,
                                   int grid, int span, int threads, int slots, void* stream) {
  if (!spans_ok(S, W, t, grid, span, threads) || threads * (slots / 2) < span) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 4: return launch_banked<4>(tab, idx, out, scratch, S, W, span, threads, grid, t, st);
    case 8: return launch_banked<8>(tab, idx, out, scratch, S, W, span, threads, grid, t, st);
    case 16: return launch_banked<16>(tab, idx, out, scratch, S, W, span, threads, grid, t, st);
    case 32: return launch_banked<32>(tab, idx, out, scratch, S, W, span, threads, grid, t, st);
  }
  return cudaErrorInvalidValue;
}

// P1b (cumsum_cluster): x, out f32 (S, W), W a multiple of 32 up to 32768,
// a row over a cluster of C blocks (lane.cumsum_cluster_plan): C a power of
// two up to 8 (the portable cluster size) that divides NT / 32, with at
// most 256 threads a block where a thread holds 2 or more elements.  With
// `clusters` non-null nothing runs: *clusters gets
// cudaOccupancyMaxActiveClusters of this launch.
extern "C" int rs_lane_cumsum_loop(const float* x, float* out, int S, int W, int C, int t, int* clusters,
                                   void* stream) {
  if (S < 1 || W < 32 || W % 32 || W > 32768 || t < 0 || C < 1 || C > 8 || (C & (C - 1))) return cudaErrorInvalidValue;
  const int NT = std::min(W, 1024);
  int ept = 1;
  while (ept * NT < W) ept *= 2;
  if ((NT / 32) % C || NT / C > (ept == 1 ? 1024 : 256)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ept) {
    case 1: return launch_cluster<1>(x, out, S, W, C, t, clusters, st);
    case 2: return launch_cluster<2>(x, out, S, W, C, t, clusters, st);
    case 4: return launch_cluster<4>(x, out, S, W, C, t, clusters, st);
    case 8: return launch_cluster<8>(x, out, S, W, C, t, clusters, st);
    case 16: return launch_cluster<16>(x, out, S, W, C, t, clusters, st);
    case 32: return launch_cluster<32>(x, out, S, W, C, t, clusters, st);
  }
  return cudaErrorInvalidValue;
}
