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
// and each dot and each f's adds run in one thread: two runs give the same
// bits.
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
// Wide rows take a block (side_update_wide).  In the warp form the longest
// rows set the step: one warp walks a hub row's slots (737 at instML100k,
// ~20,000 at gen-inst1e6, whose item side is 100 such rows, so 100 warps on
// the card).  But of a row's work only two kinds of chain are serial by
// contract: each slot's dot over f, and each f's adds over the slots.  So
// rows of a bucket at least `wide` slots wide (ops/bell.py::side_warps)
// get a block of WBLOCK threads:
//  * The dots: a thread a slot, f = 0..k-1 in order, the own row staged in
//    shared memory; each e goes to a scratch table shaped like vals, read
//    back by the same block.
//  * The adds: the gathered rows come into shared memory in chunks of
//    slots by cp.async, the next chunk in flight while this one is used.
//    Every thread forms the chunk's rounded products e_t * F_other[c_t][f]
//    in place; then thread f, keeping acc[f] in a register (KPT values a
//    thread), adds them in slot order: a bare chain of dependent adds.
// What bounds the block form: the gathered rows.  Each slot's opposite row
// is read twice (dot, then the adds), k values a read; at gen-inst1e6's
// item side that is 2 x 2M slots x 5.6 KB in f64, from device memory, as
// the 1M-row user table does not fit in L2.  The design keeps tens of KB of
// rows in flight a block; the k add chains are as long as the row.

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

// The warp form: warp g's rows (one of a bucket at least 32 wide, else as
// many as fit 32 of their slots).
template <typename T, int KPL>
__device__ __forceinline__ void warp_rows(const T* __restrict__ own, const T* __restrict__ other,
                                          T* __restrict__ out, const int* __restrict__ idx,
                                          const T* __restrict__ vals, const Bucket* __restrict__ bk, int nb,
                                          long long g, int k, int pad, T alpha2) {
  const int lane = threadIdx.x & 31;
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
__global__ void __launch_bounds__(BLOCK)
    side_update(const T* __restrict__ own, const T* __restrict__ other, T* __restrict__ out,
                const int* __restrict__ idx, const T* __restrict__ vals, const Bucket* __restrict__ bk,
                int nb, long long warps, int k, int pad, T alpha2) {
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (g < warps) warp_rows<T, KPL>(own, other, out, idx, vals, bk, nb, g, k, pad, alpha2);  // warp-uniform
}

constexpr int WBLOCK = 512;          // threads of the block form
constexpr int ROW_BYTES = 32 * 1024;  // gathered rows a chunk, per buffer

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8) asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Slots a chunk of the block form: as many gathered rows as fill ROW_BYTES,
// at most one a thread.
__host__ __device__ __forceinline__ int wide_chunk(int k, int size) {
  const int n = ROW_BYTES / (k * size);
  return n < 1 ? 1 : (n > WBLOCK ? WBLOCK : n);
}

// Both forms in one launch: block g < blocks owns one row of a wide
// bucket (bk, nb; warp0 is then the bucket's first block), and the blocks
// after it run the warp form's warps (nk, nbn, warps) for the narrow
// buckets, WBLOCK / 32 a block.  escr has vals' shape: the slots' e.
template <typename T, int KPL>
__global__ void __launch_bounds__(WBLOCK)
    side_update_wide(const T* __restrict__ own, const T* __restrict__ other, T* __restrict__ out,
                     const int* __restrict__ idx, const T* __restrict__ vals,
                     const Bucket* __restrict__ bk, int nb, long long blocks, const Bucket* __restrict__ nk,
                     int nbn, long long warps, T* escr, int k, int pad, T alpha2) {
  constexpr int KPT = (32 * KPL + WBLOCK - 1) / WBLOCK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const long long g = blockIdx.x;
  if (g >= blocks) {  // block-uniform
    const long long wg = (g - blocks) * (WBLOCK / 32) + (t >> 5);
    if (wg < warps) warp_rows<T, KPL>(own, other, out, idx, vals, nk, nbn, wg, k, pad, alpha2);  // warp-uniform
    return;
  }
  int lo = 0, hi = nb - 1;  // the bucket holding block g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bk[mid].warp0 <= g) lo = mid;
    else hi = mid - 1;
  }
  const Bucket b = bk[lo];
  const long long r = g - b.warp0, n = b.n, j = b.b0 + r;
  const int w = static_cast<int>(b.w), ch = wide_chunk(k, sizeof(T));
  // Shared memory: the own row, two chunks' rows, three chunks' e and c.
  const int kp = (k + 1) & ~1;  // 16-byte aligned rows for the chunk buffers (T = float)
  T* fo = reinterpret_cast<T*>(smem_raw);
  T* rows = fo + ((k + 3) & ~3);
  T* es = rows + 2 * static_cast<size_t>(ch) * kp;
  int* cs = reinterpret_cast<int*>(es + 3 * ch);

  for (int f = t; f < k; f += WBLOCK) fo[f] = __ldg(own + j * k + f);
  T acc[KPT];
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int f = m * WBLOCK + t;
    acc[m] = f < k ? __ldg(own + j * k + f) : T(0);
  }
  __syncthreads();
  // The dots, a thread a slot, f = 0..k-1 against the staged own row.
  for (int s = t; s < w; s += WBLOCK) {
    const long long p = b.base + s * n + r;
    const int c = __ldg(idx + p);
    if (c == pad) continue;
    const T* go = other + static_cast<size_t>(c) * k;
    T dot = T(0);
    T g[16];  // 16 values in flight: the next batch loads while this one is summed in order
#pragma unroll
    for (int u = 0; u < 16; ++u) g[u] = u < k ? __ldg(go + u) : T(0);
    for (int f0 = 0; f0 < k; f0 += 16) {
      T h[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        h[u] = g[u];
        g[u] = f0 + 16 + u < k ? __ldg(go + f0 + 16 + u) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (f0 + u < k) dot = Rn<T>::add(dot, Rn<T>::mul(fo[f0 + u], h[u]));
    }
    escr[p] = Rn<T>::mul(alpha2, Rn<T>::sub(__ldg(vals + p), dot));
  }
  __syncthreads();  // e is written (global, read back by this block only)

  // The adds, chunk by chunk of slots in file order.  Chunk q's c and e
  // come to shared memory one chunk ahead of its rows (ring of 3), its
  // rows by cp.async one chunk ahead of its adds (ring of 2).
  const int nch = (w + ch - 1) / ch;
  const int vec = (k * sizeof(T)) % 16 == 0 ? 16 : static_cast<int>(sizeof(T));
  const int per_row = k * static_cast<int>(sizeof(T)) / vec;
  auto slot = [&](int q, int u) { return b.base + static_cast<long long>(q * ch + u) * n + r; };
  auto count = [&](int q) { return min(ch, w - q * ch); };
  auto fetch_rows = [&](int q) {
    unsigned char* dst = reinterpret_cast<unsigned char*>(rows + static_cast<size_t>(q & 1) * ch * kp);
    const int* cq = cs + (q % 3) * ch;
    for (int i = t; i < count(q) * per_row; i += WBLOCK) {
      const int u = i / per_row, v = i - u * per_row;
      if (cq[u] == pad) continue;
      cp_async(dst + static_cast<size_t>(u) * kp * sizeof(T) + v * vec,
               reinterpret_cast<const unsigned char*>(other + static_cast<size_t>(cq[u]) * k) + v * vec, vec);
    }
  };
  for (int q = 0; q < 2 && q < nch; ++q) {
    if (t < count(q)) {
      const int c = __ldg(idx + slot(q, t));
      cs[q * ch + t] = c;
      es[q * ch + t] = c == pad ? T(0) : escr[slot(q, t)];
    }
  }
  __syncthreads();
  fetch_rows(0);
  cp_async_commit();
  for (int q = 0; q < nch; ++q) {
    if (q + 1 < nch) fetch_rows(q + 1);
    cp_async_commit();  // possibly empty: the count of groups in flight stays 2
    int c2 = pad;       // chunk q + 2's c and e, stored after the adds
    T e2 = T(0);
    if (q + 2 < nch && t < count(q + 2)) {  // two independent loads (a padding slot's e is unused)
      c2 = __ldg(idx + slot(q + 2, t));
      e2 = escr[slot(q + 2, t)];
    }
    cp_async_wait1();  // chunk q's rows have landed
    __syncthreads();
    T* rq = rows + static_cast<size_t>(q & 1) * ch * kp;
    const int* cq = cs + (q % 3) * ch;
    const T* eq = es + (q % 3) * ch;
    const int cnt = count(q);
    // The products, every thread of the block, in place of the rows; a
    // padding slot's term is -0.0 (x + -0.0 is x for every x).
    for (int i = t; i < cnt * k; i += WBLOCK) {
      const int u = i / k, f = i - u * k;
      T* at = rq + static_cast<size_t>(u) * kp + f;
      *at = cq[u] == pad ? T(-0.0) : Rn<T>::mul(eq[u], *at);
    }
    __syncthreads();
    // The adds: thread f's chain over the chunk's slots in file order.
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int f = m * WBLOCK + t;
      if (f < k) {
        T a = acc[m];
#pragma unroll 8
        for (int u = 0; u < cnt; ++u) a = Rn<T>::add(a, rq[static_cast<size_t>(u) * kp + f]);
        acc[m] = a;
      }
    }
    if (q + 2 < nch && t < count(q + 2)) {
      cs[((q + 2) % 3) * ch + t] = c2;
      es[((q + 2) % 3) * ch + t] = e2;
    }
    __syncthreads();  // chunk q's buffers are free; chunk q + 2's c and e are in
  }
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int f = m * WBLOCK + t;
    if (f < k) out[j * k + f] = acc[m];
  }
}

template <typename T>
size_t wide_smem_bytes(int k) {
  const int ch = wide_chunk(k, sizeof(T)), kp = (k + 1) & ~1;
  return sizeof(T) * (((k + 3) & ~3) + 2 * static_cast<size_t>(ch) * kp + 3 * ch) + sizeof(int) * 3 * ch;
}

// The side's two forms: rows of narrow buckets by warps, of wide buckets by
// blocks, in one launch on the stream.
struct Side {
  const void *own, *other;
  void* out;
  const int* idx;
  const void* vals;
  const void *narrow, *wide;
  int nb_narrow, nb_wide;
  long long warps, blocks;
  void* escr;
  int k, pad;
  double alpha2;
  cudaStream_t stream;
};

template <typename T, int KPL>
int launch_side(const Side& s) {
  if (s.blocks == 0) {  // the warp form alone
    side_update<T, KPL><<<static_cast<unsigned>((s.warps + WARPS - 1) / WARPS), BLOCK, 0, s.stream>>>(
        static_cast<const T*>(s.own), static_cast<const T*>(s.other), static_cast<T*>(s.out), s.idx,
        static_cast<const T*>(s.vals), static_cast<const Bucket*>(s.narrow), s.nb_narrow, s.warps, s.k,
        s.pad, static_cast<T>(s.alpha2));
    return cudaGetLastError();
  }
  const size_t smem = wide_smem_bytes<T>(s.k);
  cudaError_t err = cudaFuncSetAttribute(side_update_wide<T, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid = s.blocks + (s.warps + WBLOCK / 32 - 1) / (WBLOCK / 32);
  side_update_wide<T, KPL><<<static_cast<unsigned>(grid), WBLOCK, smem, s.stream>>>(
      static_cast<const T*>(s.own), static_cast<const T*>(s.other), static_cast<T*>(s.out), s.idx,
      static_cast<const T*>(s.vals), static_cast<const Bucket*>(s.wide), s.nb_wide, s.blocks,
      static_cast<const Bucket*>(s.narrow), s.nb_narrow, s.warps, static_cast<T*>(s.escr), s.k, s.pad,
      static_cast<T>(s.alpha2));
  return cudaGetLastError();
}

template <typename T>
int dispatch_k(const Side& s) {
  if (s.k <= 32) return launch_side<T, 1>(s);
  if (s.k <= 64) return launch_side<T, 2>(s);
  if (s.k <= 128) return launch_side<T, 4>(s);
  if (s.k <= 256) return launch_side<T, 8>(s);
  if (s.k <= 512) return launch_side<T, 16>(s);
  if (s.k <= 1024) return launch_side<T, 32>(s);
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
// side tables; narrow (nb_narrow, 6) and wide (nb_wide, 6) int64 rows of
// Bucket for the warp and the block form, with their warp and block counts;
// escr a scratch table of vals' shape and type (used by the block form);
// pad is the opposite zero row's index.  f64: 1 for double, 0 for float.
// Returns the first non-zero cudaError_t, else 0.
extern "C" int rs_bell_side_update(const void* own, const void* other, void* out, const int* idx,
                                   const void* vals, const void* narrow, int nb_narrow,
                                   long long warps, const void* wide, int nb_wide, long long blocks,
                                   void* escr, int k, int pad, double alpha2, int f64,
                                   void* stream) {
  if (k <= 0 || warps < 0 || blocks < 0 || warps + blocks == 0 || (warps > 0 && nb_narrow <= 0) ||
      (blocks > 0 && nb_wide <= 0))
    return cudaErrorInvalidValue;
  const Side s{own, other, out, idx, vals, narrow, wide, nb_narrow, nb_wide, warps, blocks,
               escr, k, pad, alpha2, static_cast<cudaStream_t>(stream)};
  return f64 ? dispatch_k<double>(s) : dispatch_k<float>(s);
}

// `iters` BELL steps (ops/bell.py::bell_train): step it reads the last
// step's tables (L, R at first) and writes lbuf[it % 2] and rbuf[it % 2],
// the user side then the item side, each as rs_bell_side_update with the
// side's descriptors and scratch.  A side with neither warps nor blocks is
// skipped.  Returns the first non-zero cudaError_t, else 0.
extern "C" int rs_bell_train(const void* L, const void* R, void* l0, void* l1, void* r0, void* r1,
                             const int* ucols, const void* uvals, const void* u_narrow, int u_nbn,
                             long long u_warps, const void* u_wide, int u_nbw, long long u_blocks,
                             void* u_escr, const int* irows, const void* ivals,
                             const void* i_narrow, int i_nbn, long long i_warps, const void* i_wide,
                             int i_nbw, long long i_blocks, void* i_escr, int iters, int k,
                             int users, int items, double alpha2, int f64, void* stream) {
  void* lbuf[2] = {l0, l1};
  void* rbuf[2] = {r0, r1};
  const void* lc = L;
  const void* rc = R;
  for (int it = 0; it < iters; ++it) {
    void* ln = lbuf[it % 2];
    void* rn = rbuf[it % 2];
    if (u_warps + u_blocks > 0) {
      const int err = rs_bell_side_update(lc, rc, ln, ucols, uvals, u_narrow, u_nbn, u_warps, u_wide,
                                          u_nbw, u_blocks, u_escr, k, items, alpha2, f64, stream);
      if (err != 0) return err;
    }
    if (i_warps + i_blocks > 0) {
      const int err = rs_bell_side_update(rc, lc, rn, irows, ivals, i_narrow, i_nbn, i_warps, i_wide,
                                          i_nbw, i_blocks, i_escr, k, users, alpha2, f64, stream);
      if (err != 0) return err;
    }
    lc = ln;
    rc = rn;
  }
  return 0;
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
