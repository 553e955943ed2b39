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
// bfloat16 (storage __nv_bfloat16, arithmetic in f32) computes what the JAX
// package's bf16 step computes (recsys_tpu/ops/bell.py::_delta_side, then
// L + dL), where XLA keeps a fused multiply-reduce in f32 and rounds each
// other result to bf16:
//
//     dot = 0;  dot = dot + F_own[j][f] * F_other[c][f]   (f32, f = 0..k-1)
//     e   = bf(alpha2 * bf(v - bf(dot)))                  (alpha2 a bf16)
//     d   = 0;  d[f] = d[f] + e * F_other[c][f]           (f32, slot after slot)
//     out = bf(F_own[j][f] + bf(d[f]))
//
// with bf() the round to nearest even bf16 (__float2bfloat16_rn).  A product
// of two bf16 values is exact in f32, so only the sums' order rounds, and it
// is the same order as above.  The row's change is summed apart from the row
// and added once: a bf16 accumulator over a hub row's slots would swamp.
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
// rs_bell_side_delta: the same side in delta form, the per-shard step of the
// sharded engine (recsys_tpu/parallel/step.py::make_bell_train :185, whose
// per-shard partial is ops/bell.py::_delta_side :578).  The dot, e and each
// slot's term are as above; the row's change is summed from 0 in slot order
// and written as it is, the row not added:
//
//     d = 0;  d[f] = d[f] + e * F_other[c][f]     slot after slot
//     out[j] = d                                  (bf16: bf(d), the f32 sum rounded once)
//
// out holds the side's n_nz rows.  The caller sums the shards' partials along
// the mesh axis and adds the sum to the rows.  One flag picks the form in
// both the warp and the block form; the update form's arithmetic is unchanged.
//
// rs_gather_rows / rs_gather_err_grad are P2's functions at the probe's shapes:
// one thread per float4 of a gathered row, and a warp per slot whose err is
// the butterfly sum of its lanes' products (another order than the XLA
// reduction inside the TPU kernel: held to a stated f32 tolerance).
//
// What bounds gather_err_grad: bytes, and 90.2 of its 94.1 MB at the probe's
// shape are the output; the table (2.56 MB) and the partner rows sit in L2.
// Its first form (gather_err_grad_direct, kept as the probe's baseline) is a
// chain a warp: idx load, row loads, butterfly, vals load, stores, with the
// gathered row read twice.  The grouped form (gather_err_grad_grouped) gives
// a warp G consecutive slots: one load of the group's idx and vals, every
// row load of the group in flight before the first product, the rows kept in
// registers (KPL values a lane) for the output, and streaming stores
// (__stcs) so the output does not evict the table from L2.  Lane l keeps
// f = l + 32m and the partial's fused multiply-adds in m order from 0.f, then
// the same butterfly: the first form's bits (nvcc contracts its
// part += (0.5f*fo)*g into an FFMA; the grouped form writes __fmaf_rn).
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

#include <cuda_bf16.h>
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

// The step's arithmetic on storage type T in compute type C: the dot's
// term, the error, the row's start, a slot's term and add, and the row's
// end.  f32 and f64 add each term into the row itself; bf16 sums the
// terms from 0 in f32 and adds them to the row once (see the top).
template <typename T>
struct Step {
  using C = T;
  static __device__ __forceinline__ C cv(T x) { return x; }
  static __device__ __forceinline__ T st(C x) { return x; }
  static __device__ __forceinline__ C ld(const T* p) { return __ldg(p); }
  static __host__ __device__ __forceinline__ C alpha(double a) { return static_cast<C>(a); }
  static __device__ __forceinline__ C dot(C d, C a, C b) { return Rn<T>::add(d, Rn<T>::mul(a, b)); }
  static __device__ __forceinline__ C err(C a2, C v, C dot) { return Rn<T>::mul(a2, Rn<T>::sub(v, dot)); }
  static __device__ __forceinline__ C start(C own) { return own; }
  static __device__ __forceinline__ C term(C e, C g) { return Rn<T>::mul(e, g); }
  static __device__ __forceinline__ C add(C a, C t) { return Rn<T>::add(a, t); }
  static __device__ __forceinline__ C end(C a, C) { return a; }
};
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
template <>
struct Step<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using C = float;
  static __device__ __forceinline__ C cv(T x) { return __bfloat162float(x); }
  static __device__ __forceinline__ T st(C x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ C ld(const T* p) { return __bfloat162float(__ldg(p)); }
  // alpha2 as a bf16 (the wrapper passes one already).
  static __host__ __device__ __forceinline__ C alpha(double a) {
    return __bfloat162float(__float2bfloat16_rn(static_cast<float>(a)));
  }
  static __device__ __forceinline__ C dot(C d, C a, C b) { return __fadd_rn(d, __fmul_rn(a, b)); }
  static __device__ __forceinline__ C err(C a2, C v, C dot) {
    return bf(__fmul_rn(a2, bf(__fsub_rn(v, bf(dot)))));
  }
  static __device__ __forceinline__ C start(C) { return 0.f; }
  static __device__ __forceinline__ C term(C e, C g) { return __fmul_rn(e, g); }
  static __device__ __forceinline__ C add(C a, C t) { return __fadd_rn(a, t); }
  static __device__ __forceinline__ C end(C a, C own) { return bf(__fadd_rn(own, bf(a))); }
};

// One degree bucket of a side (ops/bell.py::side_warps): rows [b0, b0 + n) of
// width w, whose (w, n) tables start at flat offset base; its warps start at
// warp0 and take rpw rows each.
struct Bucket {
  long long base, warp0, b0, n, w, rpw;
};

// e = alpha2 * (v - <own row, other row>), the dot in order f = 0..k-1.
template <typename T>
__device__ __forceinline__ typename Step<T>::C slot_err(const T* __restrict__ fo, const T* __restrict__ go, int k,
                                                        typename Step<T>::C v, typename Step<T>::C alpha2) {
  using S = Step<T>;
  typename S::C dot = 0;
#pragma unroll 4
  for (int f = 0; f < k; ++f) dot = S::dot(dot, S::ld(fo + f), S::ld(go + f));
  return S::err(alpha2, v, dot);
}

// Slots batched per load round: as many gathered rows in flight as keep the
// lane's registers at 16 values or fewer.
template <int KPL>
struct Batch {
  static constexpr int value = KPL >= 16 ? 1 : (16 / KPL > 8 ? 8 : 16 / KPL);
};

// acc += e_t * F_other[c_t] for the live lanes t in [t0, t1), in order.
template <typename T, int KPL>
__device__ __forceinline__ void add_slots(typename Step<T>::C (&acc)[KPL], unsigned live, int t0, int t1, int c,
                                          typename Step<T>::C e, const T* __restrict__ other, int k, int lane) {
  using S = Step<T>;
  using C = typename S::C;
  constexpr int B = Batch<KPL>::value;
  for (int t = t0; t < t1; t += B) {
    C g[B][KPL];
    C et[B];
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
        g[u][m] = on[u] && f < k ? S::ld(row + f) : C(0);
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (!on[u]) continue;  // warp-uniform
#pragma unroll
      for (int m = 0; m < KPL; ++m) acc[m] = S::add(acc[m], S::term(et[u], g[u][m]));
    }
  }
}

// The row's start (acc) from its own values; 0 in the delta form.
template <typename T, int KPL>
__device__ __forceinline__ void load_row(typename Step<T>::C (&acc)[KPL], const T* __restrict__ row, int k,
                                         int lane, bool delta) {
  using S = Step<T>;
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int f = m * 32 + lane;
    acc[m] = delta ? typename S::C(0) : S::start(f < k ? S::ld(row + f) : typename S::C(0));
  }
}

// The row's end into out (own: the row's values in the snapshot; f32 and
// f64 do not read them); the delta form stores acc as it is.
template <typename T, int KPL>
__device__ __forceinline__ void store_row(const typename Step<T>::C (&acc)[KPL], const T* __restrict__ own,
                                          T* __restrict__ row, int k, int lane, bool delta) {
  using S = Step<T>;
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int f = m * 32 + lane;
    if (f < k) row[f] = S::st(delta ? acc[m] : S::end(acc[m], sizeof(T) == 2 ? S::ld(own + f) : acc[m]));
  }
}

// The warp form: warp g's rows (one of a bucket at least 32 wide, else as
// many as fit 32 of their slots).
template <typename T, int KPL>
__device__ __forceinline__ void warp_rows(const T* __restrict__ own, const T* __restrict__ other,
                                          T* __restrict__ out, const int* __restrict__ idx,
                                          const T* __restrict__ vals, const Bucket* __restrict__ bk, int nb,
                                          long long g, int k, int pad, typename Step<T>::C alpha2, bool delta) {
  using S = Step<T>;
  using C = typename S::C;
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
  C acc[KPL];
  if (b.rpw == 1) {  // one row, its slots 32 at a time
    const long long j = b.b0 + r0;
    load_row<T, KPL>(acc, own + j * k, k, lane, delta);
    for (int s0 = 0; s0 < w; s0 += 32) {
      const int s = s0 + lane;
      int c = pad;
      C e = C(0);
      if (s < w) {
        const long long p = b.base + s * n + r0;
        c = __ldg(idx + p);
        if (c != pad) e = slot_err(own + j * k, other + static_cast<size_t>(c) * k, k, S::ld(vals + p), alpha2);
      }
      const unsigned live = __ballot_sync(FULL, s < w && c != pad);
      add_slots<T, KPL>(acc, live, 0, min(32, w - s0), c, e, other, k, lane);
    }
    store_row<T, KPL>(acc, own + j * k, out + j * k, k, lane, delta);
    return;
  }
  // rows * w <= 32 slots: lane -> (row q = lane / w, slot s = lane % w).
  const int q = lane / w, s = lane - q * w;
  int c = pad;
  C e = C(0);
  if (q < rows) {
    const long long p = b.base + s * n + r0 + q;
    c = __ldg(idx + p);
    if (c != pad)
      e = slot_err(own + (b.b0 + r0 + q) * k, other + static_cast<size_t>(c) * k, k, S::ld(vals + p), alpha2);
  }
  const unsigned live = __ballot_sync(FULL, q < rows && c != pad);
  for (int r = 0; r < rows; ++r) {
    const long long j = b.b0 + r0 + r;
    load_row<T, KPL>(acc, own + j * k, k, lane, delta);
    add_slots<T, KPL>(acc, live, r * w, r * w + w, c, e, other, k, lane);
    store_row<T, KPL>(acc, own + j * k, out + j * k, k, lane, delta);
  }
}

template <typename T, int KPL>
__global__ void __launch_bounds__(BLOCK)
    side_update(const T* __restrict__ own, const T* __restrict__ other, T* __restrict__ out,
                const int* __restrict__ idx, const T* __restrict__ vals, const Bucket* __restrict__ bk,
                int nb, long long warps, int k, int pad, typename Step<T>::C alpha2, bool delta) {
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (g < warps) warp_rows<T, KPL>(own, other, out, idx, vals, bk, nb, g, k, pad, alpha2, delta);  // warp-uniform
}

constexpr int WBLOCK = 512;          // threads of the block form
constexpr int ROW_BYTES = 32 * 1024;  // gathered rows a chunk, per buffer

// cp.async of 16, 8 or 4 bytes; 2 (a bf16 row of odd k) is a plain copy,
// seen by the block after the same barrier.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8) asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else if (bytes == 4) asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  else *static_cast<unsigned short*>(dst) = __ldg(static_cast<const unsigned short*>(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Slots a chunk of the block form: as many gathered rows as fill ROW_BYTES,
// at most one a thread.
__host__ __device__ __forceinline__ int wide_chunk(int k, int size) {
  const int n = ROW_BYTES / (k * size);
  return n < 1 ? 1 : (n > WBLOCK ? WBLOCK : n);
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// The block form's shared memory, in bytes from its start: the own row,
// two chunks' rows (kp values a row), three chunks' e and three chunks' c.
struct WideSmem {
  size_t rows, es, cs, total;
};
__host__ __device__ __forceinline__ WideSmem wide_smem(int k, int size) {
  const int ch = wide_chunk(k, size), kp = (k + 1) & ~1;
  WideSmem m;
  m.rows = align16(static_cast<size_t>(k) * size);
  m.es = m.rows + align16(2 * static_cast<size_t>(ch) * kp * size);
  m.cs = m.es + align16(3 * static_cast<size_t>(ch) * size);
  m.total = m.cs + sizeof(int) * 3 * ch;
  return m;
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
                     int nbn, long long warps, T* escr, int k, int pad, typename Step<T>::C alpha2,
                     bool delta) {
  using S = Step<T>;
  using C = typename S::C;
  // f32 and f64 form a chunk's terms in place of its rows; a bf16 term is
  // exact only in f32, so bf16 forms each where it is added.
  constexpr bool kTermsInPlace = sizeof(T) >= 4;
  constexpr int KPT = (32 * KPL + WBLOCK - 1) / WBLOCK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const long long g = blockIdx.x;
  if (g >= blocks) {  // block-uniform
    const long long wg = (g - blocks) * (WBLOCK / 32) + (t >> 5);
    if (wg < warps) warp_rows<T, KPL>(own, other, out, idx, vals, nk, nbn, wg, k, pad, alpha2, delta);  // warp-uniform
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
  const int kp = (k + 1) & ~1;  // 16-byte aligned rows for the chunk buffers where a row allows it
  const WideSmem lay = wide_smem(k, sizeof(T));
  T* fo = reinterpret_cast<T*>(smem_raw);
  T* rows = reinterpret_cast<T*>(smem_raw + lay.rows);
  T* es = reinterpret_cast<T*>(smem_raw + lay.es);
  int* cs = reinterpret_cast<int*>(smem_raw + lay.cs);

  for (int f = t; f < k; f += WBLOCK) fo[f] = __ldg(own + j * k + f);
  C acc[KPT];
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int f = m * WBLOCK + t;
    acc[m] = delta ? C(0) : S::start(f < k ? S::ld(own + j * k + f) : C(0));
  }
  __syncthreads();
  // The dots, a thread a slot, f = 0..k-1 against the staged own row.
  for (int s = t; s < w; s += WBLOCK) {
    const long long p = b.base + s * n + r;
    const int c = __ldg(idx + p);
    if (c == pad) continue;
    const T* go = other + static_cast<size_t>(c) * k;
    C dot = C(0);
    C g[16];  // 16 values in flight: the next batch loads while this one is summed in order
#pragma unroll
    for (int u = 0; u < 16; ++u) g[u] = u < k ? S::ld(go + u) : C(0);
    for (int f0 = 0; f0 < k; f0 += 16) {
      C h[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        h[u] = g[u];
        g[u] = f0 + 16 + u < k ? S::ld(go + f0 + 16 + u) : C(0);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (f0 + u < k) dot = S::dot(dot, S::cv(fo[f0 + u]), h[u]);
    }
    escr[p] = S::st(S::err(alpha2, S::ld(vals + p), dot));
  }
  __syncthreads();  // e is written (global, read back by this block only)

  // The adds, chunk by chunk of slots in file order.  Chunk q's c and e
  // come to shared memory one chunk ahead of its rows (ring of 3), its
  // rows by cp.async one chunk ahead of its adds (ring of 2).
  const int nch = (w + ch - 1) / ch;
  const int row_bytes = k * static_cast<int>(sizeof(T));
  const int vec = row_bytes % 16 == 0 ? 16
                  : sizeof(T) >= 4    ? static_cast<int>(sizeof(T))
                  : row_bytes % 8 == 0 ? 8
                  : row_bytes % 4 == 0 ? 4
                                       : 2;
  const int per_row = row_bytes / vec;
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
    if constexpr (kTermsInPlace) {
      // The products, every thread of the block, in place of the rows; a
      // padding slot's term is -0.0 (x + -0.0 is x for every x).
      for (int i = t; i < cnt * k; i += WBLOCK) {
        const int u = i / k, f = i - u * k;
        T* at = rq + static_cast<size_t>(u) * kp + f;
        *at = cq[u] == pad ? T(-0.0) : S::term(eq[u], *at);
      }
      __syncthreads();
    }
    // The adds: thread f's chain over the chunk's slots in file order.
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int f = m * WBLOCK + t;
      if (f < k) {
        C a = acc[m];
        if constexpr (kTermsInPlace) {
#pragma unroll 8
          for (int u = 0; u < cnt; ++u) a = S::add(a, rq[static_cast<size_t>(u) * kp + f]);
        } else {
#pragma unroll 8
          for (int u = 0; u < cnt; ++u)
            if (cq[u] != pad) a = S::add(a, S::term(S::cv(eq[u]), S::cv(rq[static_cast<size_t>(u) * kp + f])));
        }
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
    if (f < k) out[j * k + f] = S::st(delta ? acc[m] : S::end(acc[m], S::cv(fo[f])));
  }
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
  bool delta;  // the delta form (rs_bell_side_delta)
};

template <typename T, int KPL>
int launch_side(const Side& s) {
  const auto a2 = Step<T>::alpha(s.alpha2);
  if (s.blocks == 0) {  // the warp form alone
    side_update<T, KPL><<<static_cast<unsigned>((s.warps + WARPS - 1) / WARPS), BLOCK, 0, s.stream>>>(
        static_cast<const T*>(s.own), static_cast<const T*>(s.other), static_cast<T*>(s.out), s.idx,
        static_cast<const T*>(s.vals), static_cast<const Bucket*>(s.narrow), s.nb_narrow, s.warps, s.k,
        s.pad, a2, s.delta);
    return cudaGetLastError();
  }
  const size_t smem = wide_smem(s.k, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(side_update_wide<T, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid = s.blocks + (s.warps + WBLOCK / 32 - 1) / (WBLOCK / 32);
  side_update_wide<T, KPL><<<static_cast<unsigned>(grid), WBLOCK, smem, s.stream>>>(
      static_cast<const T*>(s.own), static_cast<const T*>(s.other), static_cast<T*>(s.out), s.idx,
      static_cast<const T*>(s.vals), static_cast<const Bucket*>(s.wide), s.nb_wide, s.blocks,
      static_cast<const Bucket*>(s.narrow), s.nb_narrow, s.warps, static_cast<T*>(s.escr), s.k, s.pad, a2,
      s.delta);
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
    gather_err_grad_direct(const float* __restrict__ table, const int* __restrict__ idx,
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

// The grouped form of gather_err_grad_direct, the same bits: a warp per G
// consecutive slots, K <= 32 * KPL.
template <int KPL, int G>
__global__ void __launch_bounds__(BLOCK)
    gather_err_grad_grouped(const float* __restrict__ table, const int* __restrict__ idx,
                            const float* __restrict__ vals, float* __restrict__ out, long long S, int K,
                            int blk) {
  const int lane = threadIdx.x & 31;
  const long long s0 = (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * G;
  if (s0 >= S) return;  // warp-uniform
  int my_c = 0;  // lane u < G holds slot s0 + u's index and rating
  float my_v = 0.f;
  if (lane < G && s0 + lane < S) {
    my_c = __ldg(idx + s0 + lane);
    my_v = __ldg(vals + s0 + lane);
  }
  float g[G][KPL], fo[G][KPL];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int c = __shfl_sync(FULL, my_c, u);
    const bool on = s0 + u < S;
    const float* row = table + static_cast<size_t>(c) * K;
    const float* prow = table + static_cast<size_t>((s0 + u) % blk) * K;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int f = lane + 32 * m;
      g[u][m] = on && f < K ? __ldg(row + f) : 0.f;
      fo[u][m] = on && f < K ? __ldg(prow + f) : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m)
      if (lane + 32 * m < K) part = __fmaf_rn(0.5f * fo[u][m], g[u][m], part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    const float err = 0.001f * (__shfl_sync(FULL, my_v, u) - part);
    if (s0 + u < S) {
      float* dst = out + (s0 + u) * K;
#pragma unroll
      for (int m = 0; m < KPL; ++m)
        if (lane + 32 * m < K) __stcs(dst + lane + 32 * m, err * g[u][m]);
    }
  }
}

// G = 2 slots a warp where KPL <= 16, else 1: at most 32 row values a lane
// in registers.  2 was the fastest of G = 1, 2, 4, 8 on the H100 (PERF.md).
template <int KPL>
int launch_grouped(const float* table, const int* idx, const float* vals, float* out, long long S, int K,
                   int blk, cudaStream_t stream) {
  constexpr int G = KPL <= 16 ? 2 : 1;
  const long long warps = (S + G - 1) / G;
  gather_err_grad_grouped<KPL, G><<<static_cast<unsigned>((warps + WARPS - 1) / WARPS), BLOCK, 0, stream>>>(
      table, idx, vals, out, S, K, blk);
  return cudaGetLastError();
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
// pad is the opposite zero row's index.  dtype: 0 float, 1 double, 2
// bfloat16.  Returns the first non-zero cudaError_t, else 0.
static int side_call(const void* own, const void* other, void* out, const int* idx, const void* vals,
                     const void* narrow, int nb_narrow, long long warps, const void* wide, int nb_wide,
                     long long blocks, void* escr, int k, int pad, double alpha2, int dtype, void* stream,
                     bool delta) {
  if (k <= 0 || warps < 0 || blocks < 0 || warps + blocks == 0 || (warps > 0 && nb_narrow <= 0) ||
      (blocks > 0 && nb_wide <= 0))
    return cudaErrorInvalidValue;
  const Side s{own, other, out, idx, vals, narrow, wide, nb_narrow, nb_wide, warps, blocks,
               escr, k, pad, alpha2, static_cast<cudaStream_t>(stream), delta};
  switch (dtype) {
    case 0: return dispatch_k<float>(s);
    case 1: return dispatch_k<double>(s);
    case 2: return dispatch_k<__nv_bfloat16>(s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int rs_bell_side_update(const void* own, const void* other, void* out, const int* idx,
                                   const void* vals, const void* narrow, int nb_narrow,
                                   long long warps, const void* wide, int nb_wide, long long blocks,
                                   void* escr, int k, int pad, double alpha2, int dtype,
                                   void* stream) {
  return side_call(own, other, out, idx, vals, narrow, nb_narrow, warps, wide, nb_wide, blocks, escr, k, pad,
                   alpha2, dtype, stream, false);
}

// The delta form (ops/bell.py::bell_side_delta): the arguments of
// rs_bell_side_update, out (n_nz, k) receiving each row's change summed
// from 0; own is read for the dots alone.
extern "C" int rs_bell_side_delta(const void* own, const void* other, void* out, const int* idx,
                                  const void* vals, const void* narrow, int nb_narrow,
                                  long long warps, const void* wide, int nb_wide, long long blocks,
                                  void* escr, int k, int pad, double alpha2, int dtype, void* stream) {
  return side_call(own, other, out, idx, vals, narrow, nb_narrow, warps, wide, nb_wide, blocks, escr, k, pad,
                   alpha2, dtype, stream, true);
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
                             int users, int items, double alpha2, int dtype, void* stream) {
  void* lbuf[2] = {l0, l1};
  void* rbuf[2] = {r0, r1};
  const void* lc = L;
  const void* rc = R;
  for (int it = 0; it < iters; ++it) {
    void* ln = lbuf[it % 2];
    void* rn = rbuf[it % 2];
    if (u_warps + u_blocks > 0) {
      const int err = rs_bell_side_update(lc, rc, ln, ucols, uvals, u_narrow, u_nbn, u_warps, u_wide,
                                          u_nbw, u_blocks, u_escr, k, items, alpha2, dtype, stream);
      if (err != 0) return err;
    }
    if (i_warps + i_blocks > 0) {
      const int err = rs_bell_side_update(rc, lc, rn, irows, ivals, i_narrow, i_nbn, i_warps, i_wide,
                                          i_nbw, i_blocks, i_escr, k, users, alpha2, dtype, stream);
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
// 0.5 * table[s mod blk] (f32), in the grouped form, K <= 1024.
extern "C" int rs_gather_err_grad(const float* table, const int* idx, const float* vals, float* out,
                                  long long S, int K, int blk, void* stream) {
  if (S <= 0 || K <= 0 || blk <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 32) return launch_grouped<1>(table, idx, vals, out, S, K, blk, st);
  if (K <= 64) return launch_grouped<2>(table, idx, vals, out, S, K, blk, st);
  if (K <= 128) return launch_grouped<4>(table, idx, vals, out, S, K, blk, st);
  if (K <= 256) return launch_grouped<8>(table, idx, vals, out, S, K, blk, st);
  if (K <= 512) return launch_grouped<16>(table, idx, vals, out, S, K, blk, st);
  if (K <= 1024) return launch_grouped<32>(table, idx, vals, out, S, K, blk, st);
  return cudaErrorInvalidValue;
}

// The same function in the first form (a warp a slot, any K): the probe's
// baseline.
extern "C" int rs_gather_err_grad_direct(const float* table, const int* idx, const float* vals, float* out,
                                         long long S, int K, int blk, void* stream) {
  if (S <= 0 || K <= 0 || blk <= 0) return cudaErrorInvalidValue;
  gather_err_grad_direct<<<static_cast<unsigned>((S + WARPS - 1) / WARPS), BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(table, idx, vals, out, S, K, blk);
  return cudaGetLastError();
}
