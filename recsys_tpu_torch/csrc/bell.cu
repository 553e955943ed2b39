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
// latency unless many chains are in flight: a step lasts as long as its
// longest row's chain, or as its waves of blocks where the card cannot hold
// them all at once.
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
//  * Both sides of a step run in one launch (rs_bell_train): they read only
//    the snapshot and write their own tables, so their chains overlap
//    instead of adding up.
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
// one thread per float4 of a gathered row, and a warp per slot (two slots a
// warp through K = 512) whose err is the butterfly sum of its lanes'
// products (another order than the XLA
// reduction inside the TPU kernel: held to a stated f32 tolerance).
//
// What bounds gather_err_grad: bytes, and 90.2 of its 94.1 MB at the probe's
// shape are the output; the table (2.56 MB) and the partner rows sit in L2.
// The kernel (gather_err_grad_grouped) gives a warp G consecutive slots: one
// load of the group's idx and vals, every row load of the group in flight
// before the first product, the rows kept in registers (KPL values a lane)
// for the output, and streaming stores (__stcs) so the output does not evict
// the table from L2.  Lane l keeps f = l + 32m and the partial's fused
// multiply-adds in m order from 0.f, then the butterfly: the bits of the form
// it replaced, a warp a slot (a chain of idx load, row loads, butterfly, vals
// load, stores, with the gathered row read twice), whose
// part += (0.5f*fo)*g nvcc contracted into an FFMA.  The two were shown
// equal in raw bits on the card when the grouped form replaced the other
// (PERF.md section 6).
//
// Wide rows take a block (bell_step's block form).  In the warp form the
// longest rows set the step: one warp walks a hub row's slots (737 at
// instML100k, ~20,000 at gen-inst1e6, whose item side is 100 such rows, so
// 100 warps on the card).  But of a row's work only two kinds of chain are
// serial by contract: each slot's dot over f, and each f's adds over the
// slots.  So rows of a bucket at least `wide` slots wide
// (ops/bell.py::side_warps) get a block of WB threads, which walks the
// row's rated slots (its padding is a suffix: it stops at the last rated
// one) in chunks of ch slots:
//  * The chunk's gathered rows come into shared memory once, while the
//    previous chunk is added: plain 16-byte loads (FR rows a warp in
//    flight) or cp.async, by the warps that hold no add chain.
//  * The dots: a thread a slot, f = 0..k-1 in order, against the own row
//    staged in shared memory; each v becomes its e in shared memory.
//  * The adds: thread f keeps acc[f] in a register (KPT values a thread)
//    and adds the chunk's terms e_t * F_other[c_t][f] in slot order, each
//    formed where it is added: a chain of dependent adds, the products off
//    it.  A padding slot's row is zeros and its e -0.0: its term is -0.0.
// What bounds it: the gathered rows.  A block brings in a row in ~30
// cycles alone on an SM, ~60 per block with eight on one (H100, PERF.md),
// about what its chain of adds takes for the same slot; the dots and the
// adds of a chunk follow each other.  Reading each row once (the
// dots had read them from device memory, the adds again) and taking the
// copies off the chain warp halved the widest row's time.
//
// One launch a step (bell_step).  Its grid is the block form's rows of both
// sides, widest first, so the two sides' hub chains start together, then
// the warp form's warps, WB / 32 a block.  The geometry follows the shapes
// (ops/bell.py::step_plan): WB = 128 or 512 threads and the chunk ch from
// k, the dtype, the bucket widths and the blocks an SM the card holds
// (rs_bell_resident), the fewest waves first, then the larger block.  At
// instML100k (584 rows in blocks, 1,527 warps) 512 threads take one block
// an SM and six waves; 128 threads with chunks sized to keep eight blocks
// an SM hold the whole step at once.  Where no size does (gen-inst1e6's
// million narrow rows), the widest-first order still starts the hub rows
// at the head of the grid.  rs_bell_side_update and rs_bell_side_delta
// launch the same kernel with one side.

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

// The dot <fo, go> in order f = 0..k-1, the gathered row go read V at a
// time (a word that divides the row: fewer, wider loads), from device
// memory or, kShared, from a row staged in shared memory (kp values a row:
// the same word divides it); the own row fo in either.
template <typename T, typename V, bool kShared>
__device__ __forceinline__ typename Step<T>::C dot_by(const T* fo, const T* go, int k) {
  using S = Step<T>;
  constexpr int N = sizeof(V) / sizeof(T);
  const V* gv = reinterpret_cast<const V*>(go);
  typename S::C dot = 0;
#pragma unroll 4
  for (int i = 0; i < k / N; ++i) {
    V x;
    if constexpr (kShared) x = gv[i];
    else x = __ldg(gv + i);
    const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int u = 0; u < N; ++u) dot = S::dot(dot, S::cv(fo[i * N + u]), S::cv(xs[u]));
  }
  return dot;
}
template <typename T, bool kShared = false>
__device__ __forceinline__ typename Step<T>::C row_dot(const T* fo, const T* go, int k) {
  const int bytes = k * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0) return dot_by<T, uint4, kShared>(fo, go, k);
  if (bytes % 8 == 0) return dot_by<T, uint2, kShared>(fo, go, k);
  if (sizeof(T) < 4 && bytes % 4 == 0) return dot_by<T, unsigned, kShared>(fo, go, k);
  return dot_by<T, T, kShared>(fo, go, k);
}

// e = alpha2 * (v - <own row, other row>), the dot in order f = 0..k-1.
template <typename T>
__device__ __forceinline__ typename Step<T>::C slot_err(const T* __restrict__ fo, const T* __restrict__ go, int k,
                                                        typename Step<T>::C v, typename Step<T>::C alpha2) {
  return Step<T>::err(alpha2, v, row_dot(fo, go, k));
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
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// The block form's shared memory at chunks of ch slots, in bytes from its
// start: the own row, two chunks' rows (kp values a row), three chunks' v
// (each turned into its e) and three chunks' c.
struct WideSmem {
  size_t rows, es, cs, total;
};
__host__ __device__ __forceinline__ WideSmem wide_smem(int k, int size, int ch) {
  const int kp = (k + 1) & ~1;
  WideSmem m;
  m.rows = align16(static_cast<size_t>(k) * size);
  m.es = m.rows + align16(2 * static_cast<size_t>(ch) * kp * size);
  m.cs = m.es + align16(3 * static_cast<size_t>(ch) * size);
  m.total = m.cs + sizeof(int) * 3 * ch;
  return m;
}

// One side of a launch: the snapshot (own, other), the rows' output, the
// side's flat tables, its buckets in the warp form (narrow) and in the
// block form (wide, whose warp0 is the bucket's first block) and the
// opposite zero row's index.
struct SideArgs {
  const void *own, *other;
  void* out;
  const int* idx;
  const void* vals;
  const Bucket *narrow, *wide;
  int nb_narrow, nb_wide;
  int pad;
};

// One launch, a whole step or one side: block g < blocks runs the block
// form's row order[g] (its block in its side << 1 | the side), the blocks
// after it the warp form's warps, side 0's warps0 first, then side 1's.
struct StepArgs {
  SideArgs side[2];
  const int* order;
  long long blocks, warps0, warps;
  int k, ch;
  bool delta;
};

__device__ __forceinline__ SideArgs pick(const StepArgs& a, int s) { return s ? a.side[1] : a.side[0]; }

// The block form: one row of a wide bucket (g, its block in the side) on
// the whole block of WB threads.
template <typename T, int KPL, int WB>
__device__ __forceinline__ void wide_row(const SideArgs& sa, long long g, int k, int ch,
                                         typename Step<T>::C alpha2, bool delta) {
  using S = Step<T>;
  using C = typename S::C;
  constexpr int KPT = (32 * KPL + WB - 1) / WB;
  constexpr int NW = WB / 32;
  constexpr int FR = 4;  // rows a copying warp has in flight
  const T* __restrict__ own = static_cast<const T*>(sa.own);
  const T* __restrict__ other = static_cast<const T*>(sa.other);
  T* __restrict__ out = static_cast<T*>(sa.out);
  const int* __restrict__ idx = sa.idx;
  const T* __restrict__ vals = static_cast<const T*>(sa.vals);
  const int pad = sa.pad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int lo = 0, hi = sa.nb_wide - 1;  // the bucket holding block g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sa.wide[mid].warp0 <= g) lo = mid;
    else hi = mid - 1;
  }
  const Bucket b = sa.wide[lo];
  const long long r = g - b.warp0, n = b.n, j = b.b0 + r;
  const int w = static_cast<int>(b.w);
  const int kp = (k + 1) & ~1;  // 16-byte aligned rows for the chunk buffers where a row allows it
  const WideSmem lay = wide_smem(k, sizeof(T), ch);
  T* fo = reinterpret_cast<T*>(smem_raw);
  T* rows = reinterpret_cast<T*>(smem_raw + lay.rows);
  T* es = reinterpret_cast<T*>(smem_raw + lay.es);
  int* cs = reinterpret_cast<int*>(smem_raw + lay.cs);

  __shared__ int end;
  if (t == 0) end = 0;
  for (int f = t; f < k; f += WB) fo[f] = __ldg(own + j * k + f);
  C acc[KPT];
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int f = m * WB + t;
    acc[m] = delta ? C(0) : S::start(f < k ? S::ld(own + j * k + f) : C(0));
  }
  __syncthreads();
  // end: one past the row's last rated slot (the builders put a row's
  // padding after its ratings); no slot past it is read.
  int last = 0;
  for (int s = t; s < w; s += WB)
    if (__ldg(idx + b.base + s * n + r) != pad) last = s + 1;
  if (last) atomicMax(&end, last);
  __syncthreads();

  // Chunk by chunk of slots in file order, each gathered row read once,
  // into shared memory (ring of 2), its c and v one chunk ahead of its rows
  // (ring of 3).  A chunk's dots, a thread a slot against the staged own
  // row, turn each v into its e; then its adds run, thread f's chain over
  // the chunk's slots in file order, each slot's term formed where it is
  // added, off the chain, while the warps past the chain's (threads f < k)
  // bring in the next chunk's rows: plain 16-byte loads, FR rows a warp in
  // flight, where a row is whole such words; else cp.async, issued by
  // every warp where each holds a chain.  A padding slot's row is zeros.
  const int nch = (end + ch - 1) / ch;
  const int row_bytes = k * static_cast<int>(sizeof(T));
  const int vec = row_bytes % 16 == 0 ? 16
                  : sizeof(T) >= 4    ? static_cast<int>(sizeof(T))
                  : row_bytes % 8 == 0 ? 8
                  : row_bytes % 4 == 0 ? 4
                                       : 2;
  const int per_row = row_bytes / vec;
  const int fw0 = (k + 31) / 32 < NW ? (k + 31) / 32 : 0;  // the first warp with no chain, else 0
  const bool plain = vec == 16 && fw0 > 0;
  auto slot = [&](int q, int u) { return b.base + static_cast<long long>(q * ch + u) * n + r; };
  auto count = [&](int q) { return min(ch, end - q * ch); };
  auto fetch_rows = [&](int q) {  // chunk q's rows into their buffer (cp.async: issued only)
    T* buf = rows + static_cast<size_t>(q & 1) * ch * kp;
    const int* cq = cs + (q % 3) * ch;
    if (warp < fw0) return;
    const int cnt = count(q), step = NW - fw0;
    if (plain) {
      for (int u0 = warp - fw0; u0 < cnt; u0 += FR * step)
        for (int v = lane; v < per_row; v += 32) {
          uint4 x[FR];
#pragma unroll
          for (int i = 0; i < FR; ++i) {
            const int u = u0 + i * step;
            const int c = u < cnt ? cq[u] : pad;
            if (c != pad) x[i] = __ldg(reinterpret_cast<const uint4*>(other + static_cast<size_t>(c) * k) + v);
          }
#pragma unroll
          for (int i = 0; i < FR; ++i) {
            const int u = u0 + i * step;
            if (u < cnt) reinterpret_cast<uint4*>(buf + static_cast<size_t>(u) * kp)[v] = cq[u] != pad ? x[i] : uint4{};
          }
        }
      return;
    }
    for (int u = warp - fw0; u < cnt; u += step) {
      const int c = cq[u];
      T* d = buf + static_cast<size_t>(u) * kp;
      if (c == pad) {
        for (int f = lane; f < k; f += 32) d[f] = T(0);
        continue;
      }
      const unsigned char* src = reinterpret_cast<const unsigned char*>(other + static_cast<size_t>(c) * k);
      unsigned char* dst = reinterpret_cast<unsigned char*>(d);
      for (int v = lane; v < per_row; v += 32) cp_async(dst + v * vec, src + v * vec, vec);
    }
    cp_async_commit();
  };
  // Chunk q's dots, a thread a slot: each v turned into its e, a padding
  // slot's e -0.0 (its row is zeros, so its term is -0.0, and x + -0.0 is
  // x for every x).
  auto dots = [&](int q) {
    const T* rq = rows + static_cast<size_t>(q & 1) * ch * kp;
    const int* cq = cs + (q % 3) * ch;
    T* eq = es + (q % 3) * ch;
    if (t < count(q)) {
      const T* gt = rq + static_cast<size_t>(t) * kp;  // slot t's gathered row
      eq[t] = cq[t] == pad ? S::st(C(-0.0)) : S::st(S::err(alpha2, S::cv(eq[t]), row_dot<T, true>(fo, gt, k)));
    }
  };
  for (int q = 0; q < 2 && q < nch; ++q)
    if (t < count(q)) {
      cs[q * ch + t] = __ldg(idx + slot(q, t));
      es[q * ch + t] = vals[slot(q, t)];
    }
  __syncthreads();
  if (nch > 0) fetch_rows(0);
  cp_async_wait0();
  __syncthreads();
  for (int q = 0; q < nch; ++q) {
    dots(q);
    int c2 = pad;  // chunk q + 2's c and v, stored after the adds
    T v2 = T(0);
    if (q + 2 < nch && t < count(q + 2)) {
      c2 = __ldg(idx + slot(q + 2, t));
      v2 = vals[slot(q + 2, t)];
    }
    __syncthreads();  // the chunk's e are in
    if (q + 1 < nch) fetch_rows(q + 1);
    const T* rq = rows + static_cast<size_t>(q & 1) * ch * kp;
    const T* eq = es + (q % 3) * ch;
    const int cnt = count(q);
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int f = m * WB + t;
      if (f < k) {
        C a = acc[m];
#pragma unroll 8
        for (int u = 0; u < cnt; ++u) a = S::add(a, S::term(S::cv(eq[u]), S::cv(rq[static_cast<size_t>(u) * kp + f])));
        acc[m] = a;
      }
    }
    cp_async_wait0();
    if (q + 2 < nch && t < count(q + 2)) {
      cs[((q + 2) % 3) * ch + t] = c2;
      es[((q + 2) % 3) * ch + t] = v2;
    }
    __syncthreads();  // chunk q's buffers are free; chunk q + 1's rows, q + 2's c and v are in
  }
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int f = m * WB + t;
    if (f < k) out[j * k + f] = S::st(delta ? acc[m] : S::end(acc[m], S::cv(fo[f])));
  }
}

// Blocks an SM the registers must allow: 8 of 128 threads where a lane
// holds at most 2 values of a row, fewer where it holds more.
template <int KPL, int WB>
struct MinBlocks {
  static constexpr int value = WB >= 512 ? 1 : KPL <= 2 ? 8 : KPL <= 8 ? 6 : KPL <= 16 ? 4 : 2;
};

// The step (or one side): the block form's rows in the launch's order,
// then the warp form's warps.
template <typename T, int KPL, int WB>
__global__ void __launch_bounds__(WB, (MinBlocks<KPL, WB>::value))
    bell_step(const StepArgs a, typename Step<T>::C alpha2) {
  const long long g = blockIdx.x;
  if (g < a.blocks) {  // block-uniform
    const int o = __ldg(a.order + g);
    wide_row<T, KPL, WB>(pick(a, o & 1), o >> 1, a.k, a.ch, alpha2, a.delta);
    return;
  }
  const long long wg = (g - a.blocks) * (WB / 32) + (threadIdx.x >> 5);
  if (wg >= a.warps) return;  // warp-uniform
  const int sd = wg >= a.warps0;
  const SideArgs s = pick(a, sd);
  warp_rows<T, KPL>(static_cast<const T*>(s.own), static_cast<const T*>(s.other), static_cast<T*>(s.out), s.idx,
                    static_cast<const T*>(s.vals), s.narrow, s.nb_narrow, sd ? wg - a.warps0 : wg, a.k, s.pad,
                    alpha2, a.delta);
}

// op.go<T, KPL, WB>() for a dtype code (0 float, 1 double, 2 bfloat16), k
// and a block size; `bad` where none fits.
template <typename T, int WB, typename Op>
int by_k(int k, const Op& op, int bad) {
  if (k <= 0) return bad;
  if (k <= 32) return op.template go<T, 1, WB>();
  if (k <= 64) return op.template go<T, 2, WB>();
  if (k <= 128) return op.template go<T, 4, WB>();
  if (k <= 256) return op.template go<T, 8, WB>();
  if (k <= 512) return op.template go<T, 16, WB>();
  if (k <= 1024) return op.template go<T, 32, WB>();
  return bad;
}
template <typename T, typename Op>
int by_threads(int k, int wb, const Op& op, int bad) {
  if (wb == 128) return by_k<T, 128>(k, op, bad);
  if (wb == 512) return by_k<T, 512>(k, op, bad);
  return bad;
}
template <typename Op>
int dispatch(int dtype, int k, int wb, const Op& op, int bad) {
  switch (dtype) {
    case 0: return by_threads<float>(k, wb, op, bad);
    case 1: return by_threads<double>(k, wb, op, bad);
    case 2: return by_threads<__nv_bfloat16>(k, wb, op, bad);
    default: return bad;
  }
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory a block gets without asking

struct LaunchOp {
  const StepArgs& a;
  double alpha2;
  cudaStream_t stream;
  template <typename T, int KPL, int WB>
  int go() const {
    const size_t smem = a.blocks ? wide_smem(a.k, sizeof(T), a.ch).total : 0;
    if (smem > SMEM_DEFAULT) {
      const cudaError_t err = cudaFuncSetAttribute(bell_step<T, KPL, WB>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    const long long grid = a.blocks + (a.warps + WB / 32 - 1) / (WB / 32);
    bell_step<T, KPL, WB><<<static_cast<unsigned>(grid), WB, smem, stream>>>(a, Step<T>::alpha(alpha2));
    return cudaGetLastError();
  }
};

struct ResidentOp {
  int k, ch;
  template <typename T, int KPL, int WB>
  int go() const {
    const size_t smem = ch > 0 ? wide_smem(k, sizeof(T), ch).total : 0;
    if (smem > SMEM_DEFAULT && cudaFuncSetAttribute(bell_step<T, KPL, WB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem)) != cudaSuccess) {
      cudaGetLastError();  // more than a block may ask for: none fits
      return 0;
    }
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bell_step<T, KPL, WB>, WB, smem);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
};

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
// err = 0.001 * (vals[s] - <fo, g>), out[s] = err * g.  A warp per G
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

// One launch of bell_step: the checks, then the kernel for the dtype, k
// and block size.  A launch with no rows launches nothing.
static int step_call(const StepArgs& a, int dtype, int threads, double alpha2, void* stream) {
  if (a.blocks + a.warps == 0) return 0;
  const bool wide_ok = a.side[0].nb_wide > 0 || a.side[1].nb_wide > 0;
  if (a.k <= 0 || a.warps < 0 || a.blocks < 0 || a.warps0 < 0 || a.warps0 > a.warps ||
      (a.warps0 > 0 && a.side[0].nb_narrow <= 0) || (a.warps > a.warps0 && a.side[1].nb_narrow <= 0) ||
      (a.blocks > 0 && (a.order == nullptr || !wide_ok || a.ch < 1 || a.ch > threads)))
    return cudaErrorInvalidValue;
  return dispatch(dtype, a.k, threads, LaunchOp{a, alpha2, static_cast<cudaStream_t>(stream)},
                  cudaErrorInvalidValue);
}

static int side_call(const void* own, const void* other, void* out, const int* idx, const void* vals,
                     const void* narrow, int nb_narrow, long long warps, const void* wide, int nb_wide,
                     long long blocks, const int* order, int k, int pad, double alpha2, int dtype,
                     int threads, int chunk, void* stream, bool delta) {
  StepArgs a{};
  a.side[0] = SideArgs{own, other, out, idx, vals, static_cast<const Bucket*>(narrow),
                       static_cast<const Bucket*>(wide), nb_narrow, nb_wide, pad};
  a.order = order;
  a.blocks = blocks;
  a.warps0 = a.warps = warps;
  a.k = k;
  a.ch = chunk;
  a.delta = delta;
  if (blocks + warps == 0) return cudaErrorInvalidValue;
  return step_call(a, dtype, threads, alpha2, stream);
}

// One side of a BELL step (ops/bell.py::bell_side_update).  own (size + 1, k)
// and other (other size + 1, k) are the snapshot, out receives own's rows
// updated (the caller fills rows past the side's n_nz); idx/vals are the flat
// side tables; narrow (nb_narrow, 6) and wide (nb_wide, 6) int64 rows of
// Bucket for the warp and the block form, with their warp and block counts;
// order the block form's rows in launch order (block << 1); pad the
// opposite zero row's index; dtype 0 float, 1 double, 2 bfloat16; threads
// (128 or 512) and chunk (slots, 1..threads) the launch's geometry
// (ops/bell.py::step_plan).  Returns the first non-zero cudaError_t, else 0.
extern "C" int rs_bell_side_update(const void* own, const void* other, void* out, const int* idx,
                                   const void* vals, const void* narrow, int nb_narrow,
                                   long long warps, const void* wide, int nb_wide, long long blocks,
                                   const int* order, int k, int pad, double alpha2, int dtype,
                                   int threads, int chunk, void* stream) {
  return side_call(own, other, out, idx, vals, narrow, nb_narrow, warps, wide, nb_wide, blocks, order, k,
                   pad, alpha2, dtype, threads, chunk, stream, false);
}

// The delta form (ops/bell.py::bell_side_delta): the arguments of
// rs_bell_side_update, out (n_nz, k) receiving each row's change summed
// from 0; own is read for the dots alone.
extern "C" int rs_bell_side_delta(const void* own, const void* other, void* out, const int* idx,
                                  const void* vals, const void* narrow, int nb_narrow,
                                  long long warps, const void* wide, int nb_wide, long long blocks,
                                  const int* order, int k, int pad, double alpha2, int dtype,
                                  int threads, int chunk, void* stream) {
  return side_call(own, other, out, idx, vals, narrow, nb_narrow, warps, wide, nb_wide, blocks, order, k,
                   pad, alpha2, dtype, threads, chunk, stream, true);
}

// `iters` BELL steps (ops/bell.py::bell_train), one launch a step: step it
// reads the last step's tables (L, R at first) and writes lbuf[it % 2]
// (the user side, side 0) and rbuf[it % 2] (the item side, side 1), each
// side with its descriptors as in rs_bell_side_update, order
// holding both sides' block-form rows (block << 1 | side).  A side with
// neither warps nor blocks has no rows in the launch.  Returns the first
// non-zero cudaError_t, else 0.
extern "C" int rs_bell_train(const void* L, const void* R, void* l0, void* l1, void* r0, void* r1,
                             const int* ucols, const void* uvals, const void* u_narrow, int u_nbn,
                             long long u_warps, const void* u_wide, int u_nbw, long long u_blocks,
                             const int* irows, const void* ivals,
                             const void* i_narrow, int i_nbn, long long i_warps, const void* i_wide,
                             int i_nbw, long long i_blocks, const int* order, int iters, int k,
                             int users, int items, double alpha2, int dtype, int threads, int chunk,
                             void* stream) {
  void* lbuf[2] = {l0, l1};
  void* rbuf[2] = {r0, r1};
  StepArgs a{};
  a.order = order;
  a.blocks = u_blocks + i_blocks;
  a.warps0 = u_warps;
  a.warps = u_warps + i_warps;
  a.k = k;
  a.ch = chunk;
  a.delta = false;
  const void* lc = L;
  const void* rc = R;
  for (int it = 0; it < iters; ++it) {
    void* ln = lbuf[it % 2];
    void* rn = rbuf[it % 2];
    a.side[0] = SideArgs{lc, rc, ln, ucols, uvals, static_cast<const Bucket*>(u_narrow),
                         static_cast<const Bucket*>(u_wide), u_nbn, u_nbw, items};
    a.side[1] = SideArgs{rc, lc, rn, irows, ivals, static_cast<const Bucket*>(i_narrow),
                         static_cast<const Bucket*>(i_wide), i_nbn, i_nbw, users};
    const int err = step_call(a, dtype, threads, alpha2, stream);
    if (err != 0) return err;
    lc = ln;
    rc = rn;
  }
  return 0;
}

// Blocks of bell_step an SM can hold at once for a dtype code, k, block
// size (128 or 512) and chunk (slots; 0: no block-form rows, no shared
// memory): cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
// device.  0 where a block cannot fit, a negative cudaError_t on a fault.
extern "C" int rs_bell_resident(int dtype, int k, int threads, int chunk) {
  if (chunk < 0 || chunk > threads) return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, k, threads, ResidentOp{k, chunk}, -static_cast<int>(cudaErrorInvalidValue));
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
