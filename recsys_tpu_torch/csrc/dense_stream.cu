// Streamed full-batch GD for NVIDIA Hopper (sm_90a): the rated cells of A^T
// walked once per step.
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
// for each gradient side.  At gen-instML1M's padded shape (K=32, U=6144,
// I=3968) int8 A^T is 24.4 MB against the card's 50 MB L2; the TPU's stream
// kernel exists to read A once per step while the factors stay on chip.
// Here one walk of a block's cells feeds both gradient sides.
//
// The order of sums is that of the dense pass this walk replaced, which
// visited every cell of each (32 items x BC users) tile of A^T:
//  * Block (cb, si) owns BC user columns (a lane, or G lanes for K > 32,
//    per column) and item chunk si.  dLt: one partial per item chunk,
//    part_l (S_i, K, U), each column's products in item order.  dRt: the
//    C <= 16 blocks of a thread-block cluster share an item chunk and walk
//    it in step; each block's dRt tile of a strip is summed in user order
//    from a zero start, and the cluster sums its tiles in rank order through
//    distributed shared memory, so there is one partial per cluster,
//    part_r (U / (BC * C), K, I).  stream_update then sums each column's
//    partials in fixed order and writes x + alpha2 * sum into a ping-pong
//    buffer.  Every run gives the same bits.
//  * pred is B1's: four partial sums over j mod 4, then the xor butterfly.
//  * Precision is a template parameter with _dot's operand rounding
//    (pallas_dense.py:122), as in dense_fused.cu: HIGHEST is IEEE f32 FMA,
//    DEFAULT rounds both operands to bf16, BF16X3 splits both operands
//    hi + lo and sums (ah*bl + al*bh) + ah*bh.
// Every unrated cell adds an exact zero to those sums (fmaf(0, y, acc) ==
// acc, and in BF16X3 the split terms of a zero are zeros), so a walk of the
// rated cells alone gives the same bits if it keeps their grouping and
// order.  The one exception is a chain whose running sum is -0.0, which a
// zero term turns into +0.0: that needs a rated term of exactly -0.0.  The
// walk and the dense pass were shown equal in raw bits on the card when the
// walk replaced it (PERF.md section 6); tests/test_torch_cuda.py holds the
// walk's raw output to digests read from a build that was held equal to the
// dense pass.
//
// The walk (sparse_pass, rs_stream_sparse_train):
//  * The same blocks, clusters and partials; stream_update sums them.
//  * Tables built once per A by ops/dense_stream.py::walk_tables (torch ops
//    on the card; the engine builds them in its upload phase): the tile's
//    rated cells in user order (sub-strip, user, item) with their
//    dequantised values, and in item order (item, user) with the position of
//    each cell in user order; users by degree in each tile, items by degree
//    in each sub-strip.
//  * Per sub-strip of SR items (64, or 32 for K > 32), in one round trip of
//    loads: the Rt rows and the segment's cells into shared memory.  Then
//    (A) pred and e of every rated cell, G lanes a cell; (B) each warp walks
//    4 users at once, 8 lanes a user and 4 k a lane, each user's cells in
//    item order onto the chunk's dLt partial held in registers across the
//    sub-strips; (C) 4 items a warp at once, each item's cells in user order
//    from a zero start: the block's dRt tile.  B and C load the next cell's
//    row and e during this cell's FMAs.  The cluster then sums its tiles in
//    rank order through distributed shared memory.
//  * Degree order puts users (items) of like degree in one warp, so its
//    lanes finish together; a chain's order never changes.
//  * 51 KB of shared memory and at most 64 registers a thread at K <= 128,
//    so four blocks fit an SM and gen-instML1M's 432 blocks run in one wave.
//  * The same body serves P3 (scripts/probe_stream_v2.py): sparse_pass
//    with PACKED reads R, and writes its dR partials, in P3's strip-packed
//    layout (r_at); nothing else differs, so P3 gives B3's bits
//    (rs_stream_v2_sparse_train).
// What bounds the walk: 6 * nnz * k FLOP a step (2.66 us at gen-instML1M) is
// far below what its latencies cost.  Each sub-strip is a chain of dependent
// phases (loads, A, B and C, the cluster barrier, the rank sums) whose
// lengths are set by the tile's heaviest user and item and the slowest block
// of the cluster; B and C are chains of dependent FMAs as long as a user's
// or item's degree in the tile (PERF.md).

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
constexpr int BLOCK = 128;   // user columns of a block at G = 1: BLOCK / G columns of G lanes
constexpr int BR = 32;       // chunks and sub-strips are multiples of it
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

constexpr int SBLOCK = 256;  // threads per block of sparse_pass
constexpr int SWARPS = SBLOCK / 32;
constexpr int CELL_ITEM_BITS = 24;  // u_cell: user << 24 | item within the chunk
constexpr int CELL_ITEM_MASK = (1 << CELL_ITEM_BITS) - 1;

// The walk's tables (ops/dense_stream.py::walk_tables).  A tile is block
// (cb, si), tile = si * gridDim.x + cb; a segment is (tile, sub-strip).
struct Walk {
  const int* u_cell;   // user order: user within the block << 24 | item within the chunk
  const float* u_val;  // user order: the dequantised rating
  const int* u_off;    // (segment, user) -> first cell; ntile * nsub * BC + 1
  const int* u_order;  // (tile, i) -> the tile's i-th user by degree
  const int* i_user;   // item order: user within the block
  const int* i_cell;   // item order: the cell's position in user order
  const int* i_off;    // (tile, item within the chunk) -> first cell; ntile * chunk + 1
  const int* i_order;  // (tile, i) -> item within the chunk, by degree in each sub-strip
};

// Shared memory of sparse_pass, in bytes: the block's Lt columns (hi, lo),
// the sub-strip's Rt rows (hi, lo), two dRt tiles (K, SR + 1), the
// segment's offsets and orders (users: BC + 1 and BC; items: SR + 1 and SR;
// four words of the next segment's bounds), and per cell of the segment, up
// to `cap`: its user-order cell, its rating then e, and its item-order entry.
// Rows are G slices of SEG floats, k = g * KC + j at g * SEG + j.
__host__ __device__ __forceinline__ size_t sparse_smem_bytes(int G, int prec, int K, int SR, int cap) {
  const int BC = BLOCK / G, XS = G * SEG;
  const int NS = prec == BF16X3 ? 2 : 1;
  return sizeof(float) * (static_cast<size_t>(NS) * (BC + SR) * XS + 2 * static_cast<size_t>(K) * (SR + 1) +
                          2 * (BC + SR) + 2 + 4 + 3 * static_cast<size_t>(cap));
}

template <int P>
__device__ __forceinline__ void stage(float* hi, float* lo, int at, float v) {
  if (P == BF16X3) {
    bsplit(v, hi[at], lo[at]);
  } else {
    hi[at] = P == DEFAULT ? round_bf16(v) : v;
  }
}

// acc[m] += the product of e and y[m] as B3 forms it in each precision.
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

constexpr int UW = 4;  // users (or items) a warp walks at once in phases B and C, 8 lanes each

// A lane's 4 k of every slice of a staged row (G float4s; hi, and lo in BF16X3).
template <int P, int G>
__device__ __forceinline__ void load_row(float4 (&h)[G], float4 (&l)[G], const float* rh, const float* rl,
                                         int off) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    h[g] = *reinterpret_cast<const float4*>(rh + off + g * SEG);
    l[g] = P == BF16X3 ? *reinterpret_cast<const float4*>(rl + off + g * SEG) : h[g];
  }
}

// One lane group's chain over `cnt` list entries in order, `steps` (the
// warp's longest) iterations: acc[4g + m] gains e times the entry's staged
// row.  `wk` maps an entry i to a key, a key to its row offset and its e.
// The key two entries ahead and the row and e one ahead load during a step.
template <int P, int G, typename Walker>
__device__ __forceinline__ void chain(float (&acc)[4 * G], const Walker& wk, int cnt, int steps,
                                      const float* rh, const float* rl) {
  const int x0 = cnt > 0 ? wk.key(0) : 0;
  int x1 = cnt > 1 ? wk.key(1) : 0;
  float e = cnt > 0 ? wk.e(x0) : 0.f;
  float4 h[G], l[G];
  load_row<P, G>(h, l, rh, rl, cnt > 0 ? wk.row(x0) : 0);
  for (int s = 0; s < steps; ++s) {
    float4 nh[G], nl[G];
    float en = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) nh[g] = nl[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s + 1 < cnt) {
      en = wk.e(x1);
      load_row<P, G>(nh, nl, rh, rl, wk.row(x1));
    }
    const int x2 = s + 2 < cnt ? wk.key(s + 2) : 0;
    if (s < cnt) {
      float eh, el;
      split_e<P>(e, eh, el);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        add_cell<P>(acc[4 * g], h[g].x, l[g].x, eh, el);
        add_cell<P>(acc[4 * g + 1], h[g].y, l[g].y, eh, el);
        add_cell<P>(acc[4 * g + 2], h[g].z, l[g].z, eh, el);
        add_cell<P>(acc[4 * g + 3], h[g].w, l[g].w, eh, el);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      h[g] = nh[g];
      l[g] = nl[g];
    }
    e = en;
    x1 = x2;
  }
}

// Phase B's entries: a user's cells in item order, keyed by position.
struct UserCells {
  const int* uc;
  const float* es;
  int i0, base, xs, lane4;  // base: the sub-strip's first item in the chunk
  __device__ int key(int i) const { return i0 + i; }
  __device__ int row(int p) const { return ((uc[p] & CELL_ITEM_MASK) - base) * xs + lane4; }
  __device__ float e(int p) const { return es[p]; }
};

// Phase C's entries: an item's cells in user order, keyed by their entry.
struct ItemCells {
  const int* ic;
  const float* es;
  int i0, xs, lane4;
  __device__ int key(int i) const { return ic[i0 + i]; }
  __device__ int row(int x) const { return (x >> 16) * xs + lane4; }
  __device__ float e(int x) const { return es[x & 0xffff]; }
};

// Where item i's value of factor k lives in the R table (and in part_r's
// slices): K-major Rt (K, I), B3's; or, PACKED, P3's strip-packed Rp
// (I / strip * K, strip), rows s*K .. s*K + K-1 holding strip s.
template <bool PACKED>
__device__ __forceinline__ size_t r_at(int k, int i, int I, int K, int strip) {
  if (!PACKED) return static_cast<size_t>(k) * I + i;
  const int s = i / strip;
  return (static_cast<size_t>(s) * K + k) * strip + (i - s * strip);
}

// One step's gradient partials from the rated cells alone (PACKED: R read,
// and the dR partials written, in P3's layout).  Grid (U / BC, S), clusters
// of C blocks along x.  `cap` is the largest segment's cell count
// (walk_tables).
template <int P, int G, bool PACKED>
__global__ void __launch_bounds__(SBLOCK, G == 8 ? 2 : 4)
    sparse_pass(Walk w, const float* __restrict__ Lt, const float* __restrict__ Rt,
                float* __restrict__ part_l, float* __restrict__ part_r, int K, int U, int I,
                int chunk, int SR, int cap, int strip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());

  constexpr int BC = BLOCK / G, XS = G * SEG, KP = KC * G;
  constexpr int NS = P == BF16X3 ? 2 : 1;
  constexpr int UPW = BC / SWARPS, RU = (UPW + UW - 1) / UW;  // users a warp, rounds of UW
  constexpr int SR_MAX = G == 1 ? 64 : 32;                     // ops/dense_stream.py::sub_strip
  const int SRP = SR + 1;
  float* xs_h = reinterpret_cast<float*>(smem_raw);  // Lt columns (BC, XS)
  float* xs_l = xs_h + BC * XS;                       // BF16X3 only
  float* ys_h = xs_h + NS * BC * XS;                  // Rt rows (SR, XS)
  float* ys_l = ys_h + SR * XS;                       // BF16X3 only
  float* sd = ys_h + NS * SR * XS;                    // 2 dRt tiles (K, SRP)
  int* ud = reinterpret_cast<int*>(sd + 2 * K * SRP); // users by degree
  int* uo = ud + BC;                                  // users' first cells, from the segment's
  int* io = uo + BC + 1;                              // items' first cells, from the segment's
  int* id = io + SR + 1;                              // items by degree, within the sub-strip
  int* nx = id + SR;                                  // the next segment's p0, j0, n
  int* uc = nx + 4;                                   // cells: user << 24 | item in chunk
  float* es = reinterpret_cast<float*>(uc + cap);     // cells: the rating, then e
  int* ic = reinterpret_cast<int*>(es + cap);         // item order: user << 16 | cell
  float* tp = ys_h;                                   // the dLt partial (K, BC) at the end

  const int cb = blockIdx.x, si = blockIdx.y;
  const int tile = si * gridDim.x + cb;
  const int c0 = cb * BC;
  const int r_begin = si * chunk, r_end = min(I, r_begin + chunk);
  const int nsub = (chunk + SR - 1) / SR;  // the tables' stride
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5, j4 = lane >> 3, kq = lane & 7;

  // Batches of 8 independent loads a thread, then the stores.
  for (int base = t; base < KP * BC; base += 8 * SBLOCK) {  // coalesced along users
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SBLOCK, k = idx / BC, cc = idx - k * BC;
      v[u] = idx < KP * BC && k < K ? __ldg(Lt + static_cast<size_t>(k) * U + c0 + cc) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SBLOCK, k = idx / BC, cc = idx - k * BC;
      if (idx < KP * BC) stage<P>(xs_h, xs_l, cc * XS + (k / KC) * SEG + k % KC, v[u]);
    }
  }
  for (int i = t; i < BC; i += SBLOCK) ud[i] = __ldg(w.u_order + tile * BC + i);
  if (t == 0) {
    nx[0] = __ldg(w.u_off + tile * nsub * BC);
    nx[1] = __ldg(w.i_off + tile * chunk);
    nx[2] = __ldg(w.u_off + tile * nsub * BC + BC) - nx[0];
  }
  float acc[RU][4 * G];  // dLt of the lane's users, k = g * KC + 4 * kq + m
#pragma unroll
  for (int ru = 0; ru < RU; ++ru)
#pragma unroll
    for (int m = 0; m < 4 * G; ++m) acc[ru][m] = 0.f;

  for (int sub = 0; r_begin + sub * SR < r_end; ++sub) {  // the same count in every block of a cluster
    const int r0 = r_begin + sub * SR, len = min(SR, r_end - r0);
    const int seg = tile * nsub + sub, it0 = tile * chunk + sub * SR;
    __syncthreads();  // the previous sub-strip's readers are done; nx is in
    const int p0 = nx[0], j0 = nx[1], n = nx[2];
    {  // every load of the sub-strip first, then the stores: one round trip
      constexpr int NY = (KP * SR_MAX + SBLOCK - 1) / SBLOCK;  // Rt values a thread
      float yv[NY];
#pragma unroll
      for (int u = 0; u < NY; ++u) {
        const int idx = t + u * SBLOCK, k = idx / SR, r = idx - k * SR;
        yv[u] = idx < KP * SR && k < K && r < len ? __ldg(Rt + r_at<PACKED>(k, r0 + r, I, K, strip)) : 0.f;
      }
      const int o_u = t <= BC ? __ldg(w.u_off + seg * BC + t) : 0;
      const int o_i = t <= len ? __ldg(w.i_off + it0 + t) : 0;
      const int o_d = t < len ? __ldg(w.i_order + it0 + t) : 0;
      constexpr int NC = 2;  // cells a thread in this round trip; any more in a second
      int c[NC], iu[NC], icl[NC];
      float a[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int i = t + u * SBLOCK;  // an empty last segment starts at nnz: no load past it
        c[u] = i < n ? __ldg(w.u_cell + p0 + i) : 0;
        a[u] = i < n ? __ldg(w.u_val + p0 + i) : 0.f;
        iu[u] = i < n ? __ldg(w.i_user + j0 + i) : 0;
        icl[u] = i < n ? __ldg(w.i_cell + j0 + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < NY; ++u) {
        const int idx = t + u * SBLOCK, k = idx / SR, r = idx - k * SR;
        if (idx < KP * SR) stage<P>(ys_h, ys_l, r * XS + (k / KC) * SEG + k % KC, yv[u]);
      }
      if (t <= BC) uo[t] = o_u - p0;
      if (t <= len) io[t] = o_i - j0;
      if (t < len) id[t] = o_d - sub * SR;
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int i = t + u * SBLOCK;
        if (i < n) {
          uc[i] = c[u];
          es[i] = a[u];
          ic[i] = iu[u] << 16 | (icl[u] - p0);
        }
      }
      for (int i = t + NC * SBLOCK; i < n; i += SBLOCK) {
        uc[i] = __ldg(w.u_cell + p0 + i);
        es[i] = __ldg(w.u_val + p0 + i);
        ic[i] = __ldg(w.i_user + j0 + i) << 16 | (__ldg(w.i_cell + j0 + i) - p0);
      }
    }
    __syncthreads();
    int next[3] = {0, 0, 0};  // the next segment's bounds, loaded under phases A-C
    if (t == 0 && r_begin + (sub + 1) * SR < r_end) {
      next[0] = __ldg(w.u_off + (seg + 1) * BC);
      next[1] = __ldg(w.i_off + it0 + SR);
      next[2] = __ldg(w.u_off + (seg + 1) * BC + BC);
    }

    // (A) pred and e of the segment's cells, G lanes a cell: B3's four
    // partial sums over a lane's KC values, then the xor butterfly.
    for (int base = wid * 32; base < n * G; base += SBLOCK) {  // warp-uniform
      const int idx = base + lane;
      const int i = idx < n * G ? idx / G : 0;
      const int g = lane & (G - 1);
      const int cell = uc[i];
      const int cl = cell >> CELL_ITEM_BITS, r = (cell & CELL_ITEM_MASK) - sub * SR;
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

    // (B) dLt: UW users a warp at once, 8 lanes a user, each lane 4 k of
    // every slice; a user's cells in item order onto its registers.
#pragma unroll
    for (int ru = 0; ru < RU; ++ru) {
      const int jj = ru * UW + j4;
      const int cl = jj < UPW ? ud[wid + SWARPS * jj] : 0;
      const int i0 = jj < UPW ? uo[cl] : 0, cnt = jj < UPW ? uo[cl + 1] - i0 : 0;
      chain<P, G>(acc[ru], UserCells{uc, es, i0, sub * SR, XS, 4 * kq}, cnt, __reduce_max_sync(FULL, cnt),
                  ys_h, ys_l);
    }

    // (C) the block's dRt tile: UW items a warp at once, 8 lanes an item,
    // the item's cells in user order from a zero start.
    float* sdp = sd + (sub & 1) * K * SRP;
    for (int rc = 0; rc * SWARPS * UW < len; ++rc) {
      const int v = wid + SWARPS * (rc * UW + j4);
      const int rs = v < len ? id[v] : 0;
      const int i0 = v < len ? io[rs] : 0, cnt = v < len ? io[rs + 1] - i0 : 0;
      float d[4 * G];
#pragma unroll
      for (int m = 0; m < 4 * G; ++m) d[m] = 0.f;
      chain<P, G>(d, ItemCells{ic, es, i0, XS, 4 * kq}, cnt, __reduce_max_sync(FULL, cnt), xs_h, xs_l);
      if (v < len) {
#pragma unroll
        for (int m = 0; m < 4 * G; ++m) {
          const int k = (m / 4) * KC + 4 * kq + m % 4;
          if (k < K) sdp[k * SRP + rs] = d[m];
        }
      }
    }
    if (t == 0) {
      nx[0] = next[0];
      nx[1] = next[1];
      nx[2] = next[2] - next[0];
    }
    // The cluster's tiles summed in rank order: block q
    // writes the k rows k = q (mod C).  The next sub-strip writes the
    // other tile buffer.
    cluster.sync();
    const int cu = cb / C;
    const int nk = (K - q + C - 1) / C;
    for (int idx = t; idx < nk * len; idx += SBLOCK) {
      const int kk = idx / len, r = idx - kk * len;
      const int k = q + C * kk;
      float v[16];
#pragma unroll
      for (int rho = 0; rho < 16; ++rho) v[rho] = rho < C ? cluster.map_shared_rank(sdp, rho)[k * SRP + r] : 0.f;
      float sum = v[0];
#pragma unroll
      for (int rho = 1; rho < 16; ++rho) if (rho < C) sum = sum + v[rho];
      part_r[static_cast<size_t>(cu) * K * I + r_at<PACKED>(k, r0 + r, I, K, strip)] = sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory

  // part_l through shared memory, so the write is coalesced along users.
#pragma unroll
  for (int ru = 0; ru < RU; ++ru) {
    const int jj = ru * UW + j4;
    if (jj < UPW) {
      const int cl = ud[wid + SWARPS * jj];
#pragma unroll
      for (int m = 0; m < 4 * G; ++m) {
        const int k = (m / 4) * KC + 4 * kq + m % 4;
        if (k < K) tp[k * BC + cl] = acc[ru][m];
      }
    }
  }
  __syncthreads();
  for (int idx = t; idx < K * BC; idx += SBLOCK) {
    const int k = idx / BC, cc = idx - k * BC;
    part_l[(static_cast<size_t>(si) * K + k) * U + c0 + cc] = tp[idx];
  }
}

// The factors, buffers and split of the steps.
struct Args {
  const float *Lt_in, *Rt_in;
  float *Lt_out, *Rt_out, *Lt_tmp, *Rt_tmp;
  float *part_l, *part_r;
  int K, U, I, G, C, iters;
  float alpha2;
  int chunk, S;
  cudaStream_t stream;
};

int log2_lanes(int G) {
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  return lg;
}

// Shared memory, the cluster size and the launch configuration of a pass
// over grid (U / BC, S) in clusters of C; attr must outlive cfg.
template <typename Kernel>
int pass_config(Kernel kernel, const Args& a, int threads, size_t smem, cudaLaunchAttribute* attr,
                cudaLaunchConfig_t* cfg) {
  const int BC = BLOCK >> log2_lanes(a.G);
  if (a.U % BC || (a.U / BC) % a.C || a.C < 1 || a.C > 16 || a.chunk % BR || a.I % BR)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (a.C > 8) {  // Hopper runs clusters of 16 when asked; 8 is the portable size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(a.U / BC, a.S, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = a.stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// `iters` steps: pass(lc, rc) writes the partials of the factors (lc, rc),
// stream_update the next factors, ping-ponging so the last step lands in
// the output buffers.
template <typename Pass>
int steps(const Args& a, Pass pass) {
  const size_t nl = static_cast<size_t>(a.K) * a.U, nr = static_cast<size_t>(a.K) * a.I;
  const int s_r = a.U / ((BLOCK >> log2_lanes(a.G)) * a.C);
  const int apply_grid = static_cast<int>(std::min<size_t>((nl + nr + 255) / 256, 4096));
  const float* lc = a.Lt_in;
  const float* rc = a.Rt_in;
  cudaError_t err;
  for (int it = 0; it < a.iters; ++it) {
    const bool to_out = (a.iters - 1 - it) % 2 == 0;
    float* ln = to_out ? a.Lt_out : a.Lt_tmp;
    float* rn = to_out ? a.Rt_out : a.Rt_tmp;
    if ((err = static_cast<cudaError_t>(pass(lc, rc))) != cudaSuccess) return err;
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

// The steps; PACKED: R and its partials in P3's packed layout
// (strip items a strip), else K-major (strip unused).
template <int P, int G, bool PACKED>
int sparse_train(const Args& a, const Walk& w, int SR, int cap, int strip) {
  if (SR % BR || SR <= 0 || SR > (G == 1 ? 64 : 32) || a.I > CELL_ITEM_MASK || cap < 0 ||
      cap > (BLOCK / G) * SR || cap >= 1 << 16 || (PACKED && (strip < 1 || a.I % strip)))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int err = pass_config(sparse_pass<P, G, PACKED>, a, SBLOCK, sparse_smem_bytes(G, P, a.K, SR, cap), attr, &cfg);
  if (err != cudaSuccess) return err;
  return steps(a, [&](const float* lc, const float* rc) {
    return cudaLaunchKernelEx(&cfg, sparse_pass<P, G, PACKED>, w, lc, rc, a.part_l, a.part_r, a.K, a.U, a.I,
                              a.chunk, SR, cap, strip);
  });
}

template <int P, bool PACKED = false>
int sparse_lanes(const Args& a, const Walk& w, int SR, int cap, int strip = 0) {
  switch (a.G) {
    case 1: return sparse_train<P, 1, PACKED>(a, w, SR, cap, strip);
    case 2: return sparse_train<P, 2, PACKED>(a, w, SR, cap, strip);
    case 4: return sparse_train<P, 4, PACKED>(a, w, SR, cap, strip);
    case 8: return sparse_train<P, 8, PACKED>(a, w, SR, cap, strip);
  }
  return cudaErrorInvalidValue;
}

int sparse_prec(const Args& a, const Walk& w, int SR, int cap, int precision) {
  switch (precision) {
    case HIGHEST: return sparse_lanes<HIGHEST>(a, w, SR, cap);
    case BF16X3: return sparse_lanes<BF16X3>(a, w, SR, cap);
    case DEFAULT: return sparse_lanes<DEFAULT>(a, w, SR, cap);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// B4, in csrc/dense_fused.cu.
extern "C" int rs_stream_top1(const void* At, int a_kind, const float* Lt, const float* Rt, float* ops,
                              float* top_val, int* top_idx, int* top1, float* best, int K, int U, int I,
                              int G, int precision, int items_true, int chunk, int S, void* stream);

// a_kind: 0 int8 (2x rating), 1 bf16, 2 f32.  precision: 0 highest,
// 1 bf16x3, 2 default.  Returns the first non-zero cudaError_t, else 0.
// The caller (ops/dense_stream.py) checks shapes: U, I multiples of 128,
// K <= 32*G, G in {1, 2, 4, 8}, C in {1, 2, 4, 8, 16} dividing U*G/128, chunk a
// multiple of 32; part_l is (S, K, U), part_r (U*G / (128*C), K, I).

// B3: `iters` streamed GD steps (pallas_dense.py:420 stream_train) from the
// walk's tables (ops/dense_stream.py::walk_tables) for (G, C, chunk, S),
// sub-strips of SR items and at most cap cells a segment.
extern "C" int rs_stream_sparse_train(const int* u_cell, const float* u_val, const int* u_off,
                                      const int* u_order, const int* i_user, const int* i_cell,
                                      const int* i_off, const int* i_order, int cap,
                                      const float* Lt_in, const float* Rt_in, float* Lt_out,
                                      float* Rt_out, float* Lt_tmp, float* Rt_tmp, float* part_l,
                                      float* part_r, int K, int U, int I, int G, int C, int iters,
                                      float alpha2, int precision, int chunk, int S, int SR,
                                      void* stream) {
  const Args a{Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l, part_r, K, U, I, G, C,
               iters, alpha2, chunk, S, static_cast<cudaStream_t>(stream)};
  const Walk w{u_cell, u_val, u_off, u_order, i_user, i_cell, i_off, i_order};
  return sparse_prec(a, w, SR, cap, precision);
}

// P3 (ops/stream_v2.py::stream_v2_train): B3's walk on A's rated cells (the tables of A^T, walk_tables(A.T)) with R and
// its partials in the strip-packed layout, Rp (I / strip * K, strip);
// `highest` only, as the TPU probe.  Bit for bit B3 at the same split.
extern "C" int rs_stream_v2_sparse_train(const int* u_cell, const float* u_val, const int* u_off,
                                         const int* u_order, const int* i_user, const int* i_cell,
                                         const int* i_off, const int* i_order, int cap, const float* Lt_in,
                                         const float* Rp_in, float* Lt_out, float* Rp_out, float* Lt_tmp,
                                         float* Rp_tmp, float* part_l, float* part_r, int K, int U, int I,
                                         int strip, int G, int C, int iters, float alpha2, int chunk, int S,
                                         int SR, void* stream) {
  const Args a{Lt_in, Rp_in, Lt_out, Rp_out, Lt_tmp, Rp_tmp, part_l, part_r, K, U, I, G, C,
               iters, alpha2, chunk, S, static_cast<cudaStream_t>(stream)};
  const Walk w{u_cell, u_val, u_off, u_order, i_user, i_cell, i_off, i_order};
  return sparse_lanes<HIGHEST, true>(a, w, SR, cap, strip);
}

// B6: B3's steps, then B4 over the final factors and item chunks
// (top_chunk, top_S), in one host call (pallas_dense.py:433
// stream_train_top1).  Bit for bit B3 then B4.
extern "C" int rs_stream_train_top1(const int* u_cell, const float* u_val, const int* u_off,
                                    const int* u_order, const int* i_user, const int* i_cell,
                                    const int* i_off, const int* i_order, int cap, const void* At,
                                    int a_kind, const float* Lt_in, const float* Rt_in,
                                    float* Lt_out, float* Rt_out, float* Lt_tmp, float* Rt_tmp,
                                    float* part_l, float* part_r, float* ops, float* top_val, int* top_idx,
                                    int* top1, int K, int U, int I, int G, int C, int iters,
                                    float alpha2, int precision, int items_true, int chunk, int S,
                                    int SR, int top_chunk, int top_S, void* stream) {
  const int err = rs_stream_sparse_train(u_cell, u_val, u_off, u_order, i_user, i_cell, i_off,
                                         i_order, cap, Lt_in, Rt_in, Lt_out, Rt_out, Lt_tmp, Rt_tmp,
                                         part_l, part_r, K, U, I, G, C, iters, alpha2, precision,
                                         chunk, S, SR, stream);
  if (err != 0) return err;
  return rs_stream_top1(At, a_kind, Lt_out, Rt_out, ops, top_val, top_idx, top1, nullptr, K, U, I, G,
                        precision, items_true, top_chunk, top_S, stream);
}
