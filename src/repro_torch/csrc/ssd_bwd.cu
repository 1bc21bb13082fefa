// Backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a), single
// SSM group (the op launches it once a group, as it does the forward).
//
// Replaces: autodiff of src/repro/models/ssm.py::ssd_chunked (:67) under
// jax.grad — the reference has no Pallas backward; XLA differentiates the
// intra-chunk einsums.  For one (sequence, chunk) cell and head h, with
// the forward's
//   CB = C B^T (q x q),  E(l, s) = exp(cum_l - cum_s) for l >= s else 0,
//   S = CB * E * dt_s,  y = S x,  w_s = exp(cum_last - cum_s) dt_s,
//   st = B^T (w * x),
// and the incoming gradients gy (q x p) and gst (n x p):
//   dS = (gy x^T) masked causal,  U = B gst,  r_s = sum_p x U,
//   gx = S^T gy + w * U,  P = dS * S,  Q = dS * CB * E,
//   gcum = rowsum(P) - dt * colsum(Q) - w r (+ sum_s w r at the last row),
//   gdt = colsum(Q) + exp(cum_last - cum_s) r,
//   gCB = sum_h dS * E * dt_s,  gC = gCB B,
//   gB = gCB^T C + sum_h (w * x) gst^T.
// The gradients of dt and A through cum = cumsum(dt A) stay in PyTorch
// autograd (kernels/ssd/ops.py).
//
// What bounds it on the H100: operations.  At mamba2-130m's training shape
// (4 x 2048 tokens: 32 cells of q 256, h 24, p 64, n 128) the causal pairs
// need 437 MFLOP a cell, 14.00 GFLOP in all, against ~6 MB a cell of
// inputs, outputs and scratch.  Every product must hold 1e-4 of max|g|
// against float64, so each is 3xTF32 (hi.hi + hi.lo + lo.hi) with an fp32
// partial sum a k8 step, at 495/3 TFLOP/s: 0.085 ms.  The grids below
// issue 484 MFLOP a cell (whole 64 x 64 tiles on the diagonal, p and n
// padded to 64), 15.50 GFLOP in all.  What holds them back on the card is
// shared memory and L2: each 64 x 64 x 64 stage moves ~190 KB through
// shared memory (the landed tiles, their lo planes, the three passes'
// operand reads) and the tiles re-read per head and tile pair cross L2
// ~30 MB a cell.
//
// Design: five grids, no atomics — every sum over heads, tiles or head
// groups runs in a fixed order, so two launches are bit-equal.  Every
// product is wgmma m64n64k8 tf32 (tf32_tc.cuh) on K-major planes.  A tile
// lands by TMA (128 B swizzle: the planes' layout) and is split once,
// there: the landed fp32 values are the hi plane (the tensor cores read
// their top 19 bits), lo = tf32(x - trunc(x)) goes beside them, and a
// tile stored MN-major (gst in U, gy in S^T gy, B in gC, C and gCB in gB)
// is transposed in the same pass, so the inner loops only issue products.
// The tiled grids run one warpgroup a block and two blocks an SM, through
// two slots (run_stages): stage k + 1 lands while stage k is split and
// multiplied.
//   * ssd_bwd_cb: a block per causal (l tile, s tile) pair and cell builds
//     C_l B_s^T once into an fp32 (cell, qp, qp) scratch that ds and dx read.
//   * ssd_bwd_ds: a block per pair, head group (HG = 8 heads) and cell:
//     dS_h = gy_h x_h^T a head, then P, Q and gCB's term in registers; the
//     rows' sums of P over the s tile and the columns' sums of Q over the l
//     tile (the four warps' in order) go to scratch, and gCB summed over the
//     group's heads in order to a (cell, group, qp, qp) scratch.
//   * ssd_bwd_dx: a block per (s tile, group of HX = 4 heads, cell), the
//     heads one after another, s tiles with the most causal l tiles first:
//     U = B_s gst_h over n, 64 at a time; r = x U over p to scratch and U
//     scaled by exp(cum_last - cum_s); then over the causal l tiles
//     (C.B^T * E)^T gy_l, its A staged from the C.B^T scratch with the decay
//     (masked inside the exponent); dt_s applied once at the end.
//   * ssd_bwd_bc: a block per (64 rows, 64 columns of n, gC or gB, cell):
//     gC = gCB B over the causal s tiles; gB = gCB^T C over the causal l
//     tiles, then sum_h (w_h x_h) gst_h^T over the heads in order.  gCB's
//     head-group partials are summed in group order as they are staged
//     (from L2, by plain loads).
//   * ssd_bwd_reduce: a block per (head, cell) sums the row and column
//     partials in tile order, adds the state terms and the last row's
//     sum_s w r (a fixed tree over the block), and writes gcum and gdt.
// TMA needs every row stride a multiple of 16 bytes: where p or n is not a
// multiple of 4, every tile comes by 4-byte cp.async into the same swizzled
// layout instead, completing on the same mbarriers; the rows of dt and cum
// (h floats, 12 bytes at h = 3) are always read by plain loads.  Masking is
// inside the exponent, before exp: exp of a non-causal difference would be
// inf, and inf * 0 a NaN gradient.
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers), as its own library.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_tc.cuh"

namespace {

using namespace tf32_tc;

constexpr int HG = 8;            // heads of a ds block
constexpr int HX = 4;            // heads of a dx block, one after another
constexpr int SLOT = 2 * TILE;   // a stage's two 64 x 64 tiles as they land (the hi planes)
constexpr int AREA = 3 * SLOT;   // two slots and the stage's lo planes: 96 KB
constexpr int DEC = 2 * 2 * ROWS;  // per-row floats of a slot's stage (cum or w)
constexpr int ALIGN = 1024;      // to align the base to the swizzle atom
constexpr int BARS = 2 * 8;      // a slot's mbarrier each
constexpr int SPLIT_BAR = 1;     // the named barrier of the transposed splits
constexpr int CB_SMEM = AREA + BARS + ALIGN;
constexpr int DS_EXTRA = (HG * 3 * ROWS + 4 * ROWS) * 4;  // cum and dt, the column sums
constexpr int DS_SMEM = AREA + DS_EXTRA + BARS + ALIGN;
constexpr int DX_SMEM = AREA + DEC * 4 + BARS + ALIGN;
constexpr int BC_SMEM = AREA + DEC * 4 + BARS + ALIGN;
constexpr float NEG = -1e30f;

inline __host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Everything a grid reads: the TMA maps (when tma), the tensors, the
// scratch and the sizes.
struct Args {
  CUtensorMap xm, gym, gstm, bm, cm, cbm;
  const float *x, *dt, *cum, *B, *C, *gy, *gst;
  float *gx, *gdt, *gcum, *gB, *gC;
  float *cb, *gcbp, *rowp, *colq, *rbuf;
  int q, h, p, n;
  int qp, tiles, halves, groups;  // q padded to whole tiles, ceil(q / 64), ceil(n / 64), ceil(h / HG)
  int tma;
};

// One 64-row x 32-column box of a tensor: its TMA map and coordinates,
// and the same box for 4-byte copies (its first element, row stride, and
// the rows and columns that exist from there).
struct Box {
  const CUtensorMap* map;
  int c0, c1, c2, c3;
  const float* at;
  int64_t ld;
  int rows, cols;
};

// rows r0.. of one head of a (cells, q, h, p) tensor, columns c0.. of p
__device__ __forceinline__ Box qhp_box(const Args& a, const CUtensorMap* m, const float* t,
                                       int cell, int head, int r0, int c0) {
  return {m, c0, head, r0, cell,
          t + ((static_cast<int64_t>(cell) * a.q + r0) * a.h + head) * a.p + c0,
          static_cast<int64_t>(a.h) * a.p, a.q - r0, a.p - c0};
}
// rows n0.. (of n) of head `head` of gst (cells, h, n, p), columns c0.. of p
__device__ __forceinline__ Box gst_box(const Args& a, int cell, int head, int n0, int c0) {
  return {&a.gstm, c0, n0, head, cell,
          a.gst + ((static_cast<int64_t>(cell) * a.h + head) * a.n + n0) * a.p + c0, a.p,
          a.n - n0, a.p - c0};
}
// rows r0.., columns c0.. of a (cells, q, n) B or C
__device__ __forceinline__ Box qn_box(const Args& a, const CUtensorMap* m, const float* t, int cell,
                                      int r0, int c0) {
  return {m, c0, r0, cell, 0, t + (static_cast<int64_t>(cell) * a.q + r0) * a.n + c0, a.n,
          a.q - r0, a.n - c0};
}
// rows r0.., columns c0.. of the (cells, qp, qp) C.B^T scratch
__device__ __forceinline__ Box cb_box(const Args& a, int cell, int r0, int c0) {
  return {&a.cbm, c0, r0, cell, 0, a.cb + (static_cast<int64_t>(cell) * a.qp + r0) * a.qp + c0,
          a.qp, a.qp - r0, a.qp - c0};
}

// A stage's loads all complete on its landed mbarrier: TMA boxes by their
// bytes (one arrival: the expect_tx), or the producer's 4-byte copies (128
// arrivals, each when that thread's copies have landed).
__device__ __forceinline__ void stage_begin(const Args& a, uint32_t bar, int boxes, int tid) {
  if (a.tma && tid == 0) mbar_expect_tx(bar, boxes * CHUNK);
}
__device__ __forceinline__ void load_box(const Args& a, const Box& b, uint8_t* dst, uint32_t bar,
                                         int tid) {
  if (a.tma) {
    if (tid == 0) tma_load_4d(smem_u32(dst), b.map, bar, b.c0, b.c1, b.c2, b.c3);
  } else {
    for (int e = tid; e < ROWS * 32; e += WG) {
      const int r = e >> 5, c = e & 31;
      const bool ok = r < b.rows && c < b.cols;
      ssd_tc::cp_async4(reinterpret_cast<float*>(dst + swz(r, c)), ok ? b.at + r * b.ld + c : a.x,
                        ok ? 4 : 0);
    }
  }
}
__device__ __forceinline__ void stage_end(const Args& a, uint32_t bar) {
  if (!a.tma)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Wait for a slot's phase.  A phase that never completes (a load that can
// never land) traps after 2^20 tries instead of hanging the card.
__device__ __forceinline__ void wait_slot(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 20)) __trap();
  }
}

// the causal (l tile, s tile) pair of block x: l tiles in order, s <= l
__device__ __forceinline__ void pair_of(int x, int& lt, int& st) {
  lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= x) ++lt;
  st = x - lt * (lt + 1) / 2;
}

// the aligned base of dynamic shared memory
__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return raw + ((ALIGN - (smem_u32(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

// a C fragment pair (columns c, c + 1 of one row) into row-major dst
__device__ __forceinline__ void store_pair(float* dst, int col, int cols, float v0, float v1) {
  if (col + 1 < cols && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (col < cols) dst[0] = v0;
    if (col + 1 < cols) dst[1] = v1;
  }
}

// The stages every tiled grid runs, one warpgroup a block and two blocks
// an SM: stage k (of K) lands by TMA in slot k % 2, is split there (its lo
// planes in the block's one lo area), multiplied, and the slot refilled
// with stage k + 2, which lands while stage k + 1 is split and multiplied.
// issue(k, tid) starts stage k's loads, split(k, hi, lo, tid) makes its
// planes, consume(k, planes) runs its products and finish(k) the work
// that needs no planes.
struct Slots {
  uint8_t* sm;
  uint32_t bars;  // landed: one a slot
  __device__ uint8_t* hi(int k) const { return sm + (k & 1) * SLOT; }
  __device__ uint8_t* lo() const { return sm + 2 * SLOT; }
  __device__ uint32_t landed(int k) const { return bars + 8 * (k & 1); }
  __device__ uint32_t parity(int k) const { return (k >> 1) & 1; }
};

__device__ __forceinline__ Slots make_slots(const Args& a, uint8_t* sm, int extra_bytes) {
  Slots r{sm, smem_u32(sm + AREA + extra_bytes)};
  if (threadIdx.x == 0) {
    mbar_init(r.landed(0), a.tma ? 1 : WG);
    mbar_init(r.landed(1), a.tma ? 1 : WG);
    mbar_fence_init();
  }
  return r;
}

template <class Issue, class Split, class Consume, class Finish>
__device__ __forceinline__ void run_stages(const Slots& r, int K, Issue issue, Split split,
                                           Consume consume, Finish finish) {
  const int tid = threadIdx.x;
  for (int k = 0; k < min(K, 2); ++k)
    issue(k, tid);
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    wait_slot(r.landed(k), r.parity(k));
    split(k, r.hi(k), r.lo(), tid);
    fence_planes();
    __syncthreads();
    consume(k, Planes{smem_u32(r.hi(k)), smem_u32(r.lo())});
    __syncthreads();  // slot k and the lo planes are free
    if (k + 2 < K) issue(k + 2, tid);
    finish(k);
  }
}

// the planes of a stage's second tile
__device__ __forceinline__ Planes second(Planes p) { return {p.hi + TILE, p.lo + TILE}; }

// C_l B_s^T of one causal pair of a cell, over n 64 at a time, to
// cb[cell, l, s] (the whole tile: rows and columns past q are zeros).
__global__ void __launch_bounds__(WG, 2) ssd_bwd_cb(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned(smem_raw);
  const Slots slots = make_slots(a, sm, 0);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  int lt, st;
  pair_of(blockIdx.x, lt, st);
  const int cell = blockIdx.y, l0 = lt * ROWS, s0 = st * ROWS;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  run_stages(
      slots, a.halves,
      [&](int k, int) {  // C_l (A) and B_s (B) over 64 columns of n
        const uint32_t bar = slots.landed(k);
        uint8_t* hi = slots.hi(k);
        stage_begin(a, bar, 4, tid);
        for (int c = 0; c < 2; ++c) {
          load_box(a, qn_box(a, &a.cm, a.C, cell, l0, 64 * k + 32 * c), hi + c * CHUNK, bar, tid);
          load_box(a, qn_box(a, &a.bm, a.B, cell, s0, 64 * k + 32 * c), hi + TILE + c * CHUNK, bar,
                   tid);
        }
        stage_end(a, bar);
      },
      [&](int, uint8_t* hi, uint8_t* lo, int) { split_natural<SLOT>(hi, lo, tid); },
      [&](int, Planes p) { product_ss(acc, p, second(p)); }, [](int) {});

  float* out = a.cb + (static_cast<int64_t>(cell) * a.qp + l0) * a.qp + s0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * w + g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * a.qp + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// For one causal (l tile, s tile) pair, head group and cell: per head the
// sums of P over the s tile to rowp[cell, s tile, head, l] and of Q over
// the l tile to colq[cell, l tile, head, s]; gCB's tile summed over the
// group's heads in order to gcbp[cell, group, l, s].
__global__ void __launch_bounds__(WG, 2) ssd_bwd_ds(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned(smem_raw);
  float* dec = reinterpret_cast<float*>(sm + AREA);  // [HG][cum_l, cum_s, dt_s][64]
  float* red = dec + HG * 3 * ROWS;                   // [4 warps][64 columns]
  const Slots slots = make_slots(a, sm, DS_EXTRA);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  int lt, st;
  pair_of(blockIdx.x, lt, st);
  const int grp = blockIdx.y, cell = blockIdx.z, l0 = lt * ROWS, s0 = st * ROWS;
  const int q = a.q, h = a.h, head0 = grp * HG, heads = min(HG, h - head0);
  const bool full = lt > st && l0 + ROWS <= q;  // a tile below the diagonal, all inside q

  // the group's cum and dt at the pair's rows and columns (plain loads)
  for (int e = tid; e < HG * 3 * ROWS; e += WG) {
    const int k = e / (3 * ROWS), which = (e % (3 * ROWS)) / ROWS, i = e % ROWS;
    const int row = (which ? s0 : l0) + i;
    const bool ok = k < heads && row < q;
    dec[e] = ok ? (which == 2 ? a.dt : a.cum)[(static_cast<int64_t>(cell) * q + row) * h + head0 + k]
                : 0.f;
  }
  // this thread's C.B^T values, in the accumulator's layout
  float cbv[32];
  const float* cbt = a.cb + (static_cast<int64_t>(cell) * a.qp + l0) * a.qp + s0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          cbt + static_cast<int64_t>(16 * w + g + 8 * i) * a.qp + 8 * j + 2 * t);
      cbv[4 * j + 2 * i] = v.x;
      cbv[4 * j + 2 * i + 1] = v.y;
    }

  float gcb[32], ds[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) gcb[i] = 0.f;
  run_stages(
      slots, heads,
      [&](int k, int) {  // gy_l (A) and x_s (B) of one head
        const uint32_t bar = slots.landed(k);
        uint8_t* hi = slots.hi(k);
        stage_begin(a, bar, 4, tid);
        for (int c = 0; c < 2; ++c) {
          load_box(a, qhp_box(a, &a.gym, a.gy, cell, head0 + k, l0, 32 * c), hi + c * CHUNK, bar,
                   tid);
          load_box(a, qhp_box(a, &a.xm, a.x, cell, head0 + k, s0, 32 * c), hi + TILE + c * CHUNK,
                   bar, tid);
        }
        stage_end(a, bar);
      },
      [&](int, uint8_t* hi, uint8_t* lo, int) { split_natural<SLOT>(hi, lo, tid); },
      [&](int, Planes p) {
#pragma unroll
        for (int i = 0; i < 32; ++i) ds[i] = 0.f;
        product_ss(ds, p, second(p));
      },
      [&](int k) {
        // P, Q and gCB's term at this thread's (l, s): rows 16 w + g (+ 8),
        // columns 8 j + 2 t (+ 1); only a tile on the diagonal or past q
        // needs the mask
        const int head = head0 + k;
        const float* dk = dec + k * 3 * ROWS;
        float row[2] = {0.f, 0.f}, col[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 cs = *reinterpret_cast<const float2*>(dk + ROWS + 8 * j + 2 * t);
          const float2 dd = *reinterpret_cast<const float2*>(dk + 2 * ROWS + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * i + c;
              const int lr = 16 * w + g + 8 * i, sc = 8 * j + 2 * t + c;
              float seg = dk[lr] - (c ? cs.y : cs.x);
              if (!full) {
                const int l = l0 + lr, s = s0 + sc;
                seg = (l >= s && l < q && s < q) ? seg : NEG;
              }
              const float ex = __expf(seg), d = c ? dd.y : dd.x;
              const float qv = ds[e] * cbv[e] * ex;
              gcb[e] = fmaf(ds[e] * ex, d, gcb[e]);
              row[i] = fmaf(qv, d, row[i]);
              col[2 * j + c] = i ? col[2 * j + c] + qv : qv;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float r = row[i];
          r += __shfl_xor_sync(0xffffffffu, r, 1);
          r += __shfl_xor_sync(0xffffffffu, r, 2);
          const int l = l0 + 16 * w + g + 8 * i;
          if (t == 0 && l < q)
            a.rowp[((static_cast<int64_t>(cell) * a.tiles + st) * h + head) * q + l] = r;
        }
        // the columns' sums over the warp's 16 rows by reduce-scatter
        // across the 8 lanes of a column group: three rounds, each keeping
        // half of the values; lane (g, t) ends with columns 8 jg + 2 t
        // (+ 1), jg = 4 g0 + 2 g1 + g2 (g's bits), summed over its 8 lanes
        // in a fixed order
        const int b0 = g & 1, b1 = (g >> 1) & 1, b2 = (g >> 2) & 1;
        float h8[8], h4[4], h2[2];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float give = b0 ? col[e] : col[8 + e], keep = b0 ? col[8 + e] : col[e];
          h8[e] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float give = b1 ? h8[e] : h8[4 + e], keep = b1 ? h8[4 + e] : h8[e];
          h4[e] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float give = b2 ? h4[e] : h4[2 + e], keep = b2 ? h4[2 + e] : h4[e];
          h2[e] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
        }
        *reinterpret_cast<float2*>(red + w * ROWS + 8 * (4 * b0 + 2 * b1 + b2) + 2 * t) =
            make_float2(h2[0], h2[1]);
        __syncthreads();
        if (tid < ROWS && s0 + tid < q)
          a.colq[((static_cast<int64_t>(cell) * a.tiles + lt) * h + head) * q + s0 + tid] =
              red[tid] + red[ROWS + tid] + red[2 * ROWS + tid] + red[3 * ROWS + tid];
      });

  float* out = a.gcbp + ((static_cast<int64_t>(cell) * a.groups + grp) * a.qp + l0) * a.qp + s0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * w + g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * a.qp + 8 * j + 2 * t) =
          make_float2(gcb[4 * j + 2 * i], gcb[4 * j + 2 * i + 1]);
  }
}

// gx[cell, s, head, :] for one (s tile, group of HX heads, cell), the heads
// one after another through the slots; r over p to rbuf[cell, head, s].
__global__ void __launch_bounds__(WG, 2) ssd_bwd_dx(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned(smem_raw);
  float* dec = reinterpret_cast<float*>(sm + AREA);  // [slot][cum_l, cum_s][64]
  const Slots slots = make_slots(a, sm, DEC * 4);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int st = blockIdx.x, cell = blockIdx.z, s0 = st * ROWS;
  const int q = a.q, h = a.h, head0 = blockIdx.y * HX, heads = min(HX, h - head0);
  const int per = a.halves + a.tiles - st;  // stages a head: U over n, then the l tiles
  const float* cumb = a.cum + static_cast<int64_t>(cell) * q * h;

  float acc[32];
  run_stages(
      slots, heads * per,
      // U stages: B_s (A) and gst_h (64 rows of n x p, transposed into B);
      // l stages: the C.B^T tile [l][s] (transposed into A with the decay)
      // and gy_l (transposed into B), with cum_l and cum_s
      [&](int k, int) {
        const uint32_t bar = slots.landed(k);
        uint8_t* hi = slots.hi(k);
        const int head = head0 + k / per, kk = k % per;
        stage_begin(a, bar, 4, tid);
        if (kk < a.halves) {
          for (int c = 0; c < 2; ++c) {
            load_box(a, qn_box(a, &a.bm, a.B, cell, s0, 64 * kk + 32 * c), hi + c * CHUNK, bar,
                     tid);
            load_box(a, gst_box(a, cell, head, 64 * kk, 32 * c), hi + TILE + c * CHUNK, bar, tid);
          }
        } else {
          const int l0 = (st + kk - a.halves) * ROWS;
          for (int c = 0; c < 2; ++c) {
            load_box(a, cb_box(a, cell, l0, s0 + 32 * c), hi + c * CHUNK, bar, tid);
            load_box(a, qhp_box(a, &a.gym, a.gy, cell, head, l0, 32 * c), hi + TILE + c * CHUNK,
                     bar, tid);
          }
          const int row = (tid < ROWS ? l0 : s0) + tid % ROWS;
          dec[(k & 1) * 2 * ROWS + tid] =
              row < q ? cumb[static_cast<int64_t>(row) * h + head] : 0.f;
        }
        stage_end(a, bar);
      },
      [&](int k, uint8_t* hi, uint8_t* lo, int) {
        const int kk = k % per;
        if (kk < a.halves) {
          split_natural<TILE>(hi, lo, tid);
          split_transposed(hi + TILE, lo + TILE, tid, SPLIT_BAR);
        } else {
          // A = (C.B^T * E)^T: plane row s, k = l, masked inside the
          // exponent; B = gy_l^T, in the same pass
          const int l0 = (st + kk - a.halves) * ROWS;
          const float* cl = dec + (k & 1) * 2 * ROWS;
          split_transposed2(
              hi, lo,
              [&](int r, int c, float v) {
                const int l = l0 + r, s = s0 + c;
                const float seg = (l >= s && l < q && s < q) ? cl[r] - cl[ROWS + c] : NEG;
                return v * __expf(seg);
              },
              hi + TILE, lo + TILE, tid, SPLIT_BAR);
        }
      },
      [&](int k, Planes p) {
        if (k % per == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        }
        product_ss(acc, p, second(p));
      },
      [&](int k) {
        const int head = head0 + k / per, kk = k % per;
        if (kk == a.halves - 1) {
          // r over p (x U, in column order, then across the 4 lanes of a
          // row), and U scaled by exp(cum_last - cum_s)
          const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = s0 + 16 * w + g + 8 * i;
            const int64_t at = static_cast<int64_t>(min(s, q - 1)) * h + head;
            const float* xr = a.x + (static_cast<int64_t>(cell) * q * h + at) * a.p;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int col = 8 * j + 2 * t + c;
                sum = fmaf(s < q && col < a.p ? xr[col] : 0.f, acc[4 * j + 2 * i + c], sum);
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (t == 0 && s < q) a.rbuf[(static_cast<int64_t>(cell) * h + head) * q + s] = sum;
            const float ex = s < q ? expf(cum_last - cumb[at]) : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[4 * j + 2 * i] *= ex;
              acc[4 * j + 2 * i + 1] *= ex;
            }
          }
        }
        if (kk == per - 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = s0 + 16 * w + g + 8 * i;
            if (s >= q) continue;
            const int64_t at = (static_cast<int64_t>(cell) * q + s) * h + head;
            const float d = a.dt[at];
            float* dst = a.gx + at * a.p;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = 8 * j + 2 * t;
              store_pair(dst + col, col, a.p, acc[4 * j + 2 * i] * d,
                         acc[4 * j + 2 * i + 1] * d);
            }
          }
        }
      });
}

// gCB's tile [r0.., c0..] summed over the head groups in order, split into
// A planes: as stored (rows r0 + row, k = c0 + k) or transposed (rows
// c0 + row, k = r0 + k, from gCB[r0 + k][c0 + row]).  Each group's eight
// loads a thread are in flight together.
__device__ __forceinline__ void stage_gcb(const Args& a, int cell, int r0, int c0, bool transpose,
                                          uint8_t* hi, uint8_t* lo, int tid) {
  const int64_t plane = static_cast<int64_t>(a.qp) * a.qp;
  const float* base = a.gcbp + static_cast<int64_t>(cell) * a.groups * plane;
  float4 v[8];
  for (int gi = 0; gi < a.groups; ++gi) {
    const float* src = base + gi * plane;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = tid + WG * m;
      float4 u;
      if (!transpose) {
        u = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r0 + (i >> 4)) * a.qp +
                                             c0 + 4 * (i & 15));
      } else {
        const float* col = src + static_cast<int64_t>(r0 + 4 * (i >> 6)) * a.qp + c0 + (i & 63);
        u = make_float4(col[0], col[a.qp], col[2 * a.qp], col[3 * a.qp]);
      }
      if (gi == 0) {
        v[m] = u;
      } else {
        v[m].x += u.x;
        v[m].y += u.y;
        v[m].z += u.z;
        v[m].w += u.w;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = tid + WG * m;
    const int row = transpose ? i & 63 : i >> 4, k4 = transpose ? 4 * (i >> 6) : 4 * (i & 15);
    *reinterpret_cast<float4*>(hi + swz(row, k4)) = v[m];
    *reinterpret_cast<uint4*>(lo + swz(row, k4)) = lo4(v[m]);
  }
}

// gC (blockIdx.y = 0: rows l) or gB (1: rows s) for one (64-row tile x 64
// columns of n, cell).
__global__ void __launch_bounds__(WG, 2) ssd_bwd_bc(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned(smem_raw);
  float* wrow = reinterpret_cast<float*>(sm + AREA);  // [slot][64]: w_s of a head stage
  const Slots slots = make_slots(a, sm, DEC * 4);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int rt = blockIdx.x / a.halves, n0 = (blockIdx.x % a.halves) * ROWS;
  const bool is_b = blockIdx.y == 1;
  const int cell = blockIdx.z, r0 = rt * ROWS, q = a.q, h = a.h;
  const int causal = is_b ? a.tiles - rt : rt + 1;  // gB: l tiles rt.., gC: s tiles ..rt
  const float* cumb = a.cum + static_cast<int64_t>(cell) * q * h;
  const float* dtb = a.dt + static_cast<int64_t>(cell) * q * h;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  run_stages(
      slots, causal + (is_b ? h : 0),
      // causal stages: the B_s or C_l tile over the block's n (transposed
      // into B; A is gCB, staged from L2); head stages: gst_h (B) and x_s
      // (A, times w_s)
      [&](int k, int) {
        const uint32_t bar = slots.landed(k);
        uint8_t* hi = slots.hi(k);
        if (k < causal) {
          const int t0 = (is_b ? rt + k : k) * ROWS;
          stage_begin(a, bar, 2, tid);
          for (int c = 0; c < 2; ++c)
            load_box(a, qn_box(a, is_b ? &a.cm : &a.bm, is_b ? a.C : a.B, cell, t0, n0 + 32 * c),
                     hi + c * CHUNK, bar, tid);
        } else {
          const int hd = k - causal;
          stage_begin(a, bar, 4, tid);
          for (int c = 0; c < 2; ++c) {
            load_box(a, gst_box(a, cell, hd, n0, 32 * c), hi + c * CHUNK, bar, tid);
            load_box(a, qhp_box(a, &a.xm, a.x, cell, hd, r0, 32 * c), hi + TILE + c * CHUNK, bar,
                     tid);
          }
          if (tid < ROWS) {
            const int s = r0 + tid;
            const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + hd];
            wrow[(k & 1) * ROWS + tid] =
                s < q ? expf(cum_last - cumb[static_cast<int64_t>(s) * h + hd]) *
                            dtb[static_cast<int64_t>(s) * h + hd]
                      : 0.f;
          }
        }
        stage_end(a, bar);
      },
      [&](int k, uint8_t* hi, uint8_t* lo, int) {
        if (k < causal) {
          split_transposed(hi, lo, tid, SPLIT_BAR);
          const int t0 = (is_b ? rt + k : k) * ROWS;
          if (is_b)
            stage_gcb(a, cell, t0, r0, true, hi + TILE, lo + TILE, tid);
          else
            stage_gcb(a, cell, r0, t0, false, hi + TILE, lo + TILE, tid);
        } else {
          split_natural<TILE>(hi, lo, tid);
          split_natural<TILE>(hi + TILE, lo + TILE, tid, wrow + (k & 1) * ROWS);
        }
      },
      [&](int, Planes p) { product_ss(acc, second(p), p); }, [](int) {});

  float* out = (is_b ? a.gB : a.gC) + static_cast<int64_t>(cell) * q * a.n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * w + g + 8 * i;
    if (row >= q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      store_pair(out + static_cast<int64_t>(row) * a.n + col, col, a.n, acc[4 * j + 2 * i],
                 acc[4 * j + 2 * i + 1]);
    }
  }
}

// gcum and gdt of one (head, cell) from the partials, in tile order.
__global__ void __launch_bounds__(256) ssd_bwd_reduce(const __grid_constant__ Args a) {
  constexpr int THREADS = 256;
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, head = blockIdx.x, cell = blockIdx.y;
  const int q = a.q, h = a.h, L = a.tiles;
  const float* dtb = a.dt + static_cast<int64_t>(cell) * q * h;
  const float* cumb = a.cum + static_cast<int64_t>(cell) * q * h;
  const float* r = a.rbuf + (static_cast<int64_t>(cell) * h + head) * q;
  const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
  auto part = [&](const float* base, int i, int l) {
    return base[((static_cast<int64_t>(cell) * L + i) * h + head) * q + l];
  };

  float wr = 0.f;
  for (int l = tid; l < q; l += THREADS) {
    const int64_t at = static_cast<int64_t>(l) * h + head;
    wr = fmaf(expf(cum_last - cumb[at]) * dtb[at], r[l], wr);
  }
  red[tid] = wr;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  const float total = red[0];

  for (int l = tid; l < q; l += THREADS) {
    const int lt = l / ROWS;
    float rows = 0.f, cols = 0.f;
    for (int i = 0; i <= lt; ++i) rows += part(a.rowp, i, l);
    for (int i = lt; i < L; ++i) cols += part(a.colq, i, l);
    const int64_t at = static_cast<int64_t>(l) * h + head;
    const float d = dtb[at], ex = expf(cum_last - cumb[at]);
    const int64_t o = static_cast<int64_t>(cell) * q * h + at;
    a.gdt[o] = fmaf(ex, r[l], cols);
    float gc = rows - d * cols - ex * d * r[l];
    if (l == q - 1) gc += total;
    a.gcum[o] = gc;
  }
}

// A 4-d fp32 TMA map of 32-column x `rows` boxes (box {32, b1, b2, b3}),
// 128 B swizzle, zeros outside the tensor.
bool map4(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
          const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_maps(Args& a, int bc) {
  using u64 = cuuint64_t;
  const u64 q = a.q, h = a.h, p = a.p, n = a.n, qp = a.qp, cells = bc;
  const cuuint32_t qhp_box[4] = {32, 1, ROWS, 1}, rows_box[4] = {32, ROWS, 1, 1};
  const u64 qhp_dims[4] = {p, h, q, cells}, qhp_str[3] = {4 * p, 4 * h * p, 4 * q * h * p};
  const u64 gst_dims[4] = {p, n, h, cells}, gst_str[3] = {4 * p, 4 * n * p, 4 * h * n * p};
  const u64 qn_dims[4] = {n, q, cells, 1}, qn_str[3] = {4 * n, 4 * q * n, 4 * cells * q * n};
  const u64 cb_dims[4] = {qp, qp, cells, 1}, cb_str[3] = {4 * qp, 4 * qp * qp, 4 * cells * qp * qp};
  return map4(&a.xm, a.x, qhp_dims, qhp_str, qhp_box) &&
         map4(&a.gym, a.gy, qhp_dims, qhp_str, qhp_box) &&
         map4(&a.gstm, a.gst, gst_dims, gst_str, rows_box) &&
         map4(&a.bm, a.B, qn_dims, qn_str, rows_box) && map4(&a.cm, a.C, qn_dims, qn_str, rows_box) &&
         map4(&a.cbm, a.cb, cb_dims, cb_str, rows_box);
}

}  // namespace

// x / gy (BC, q, h, p), dt / cum (BC, q, h), B / C (BC, q, n), gst (BC, h,
// n, p) fp32 contiguous and 16-byte aligned, BC = batch * chunks, p <= 64;
// writes gx (BC, q, h, p), gdt / gcum (BC, q, h), gB / gC (BC, q, n)
// through the scratch cb (BC, qp, qp), gcbp (BC, G, qp, qp), rowp and colq
// (BC, L, h, q) and rbuf (BC, h, q), L = ceil(q / 64), qp = 64 L, G =
// ceil(h / 8).  Launches the five grids on `stream`; returns the first
// CUDA error (0 on success).
extern "C" int ssd_bwd_launch(const float* x, const float* dt, const float* cum, const float* B,
                              const float* C, const float* gy, const float* gst, float* gx,
                              float* gdt, float* gcum, float* gB, float* gC, float* cb,
                              float* gcbp, float* rowp, float* colq, float* rbuf, int bc, int q,
                              int h, int p, int n, void* stream) {
  if (bc <= 0 || q <= 0 || h <= 0 || p <= 0 || p > 64 || n <= 0 || h > 65535 || bc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x, a.dt = dt, a.cum = cum, a.B = B, a.C = C, a.gy = gy, a.gst = gst;
  a.gx = gx, a.gdt = gdt, a.gcum = gcum, a.gB = gB, a.gC = gC;
  a.cb = cb, a.gcbp = gcbp, a.rowp = rowp, a.colq = colq, a.rbuf = rbuf;
  a.q = q, a.h = h, a.p = p, a.n = n;
  a.tiles = cdiv(q, ROWS), a.qp = ROWS * a.tiles, a.halves = cdiv(n, ROWS);
  a.groups = cdiv(h, HG);
  // TMA takes row strides in multiples of 16 bytes
  a.tma = p % 4 == 0 && n % 4 == 0;
  if (a.tma && (!encoder() || !encode_maps(a, bc))) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_ds, cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc, cudaFuncAttributeMaxDynamicSharedMemorySize, BC_SMEM);
  // the whole of the SM's shared memory, so that two blocks fit
  constexpr auto CARVE = cudaFuncAttributePreferredSharedMemoryCarveout;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ssd_bwd_cb, CARVE, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ssd_bwd_ds, CARVE, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ssd_bwd_dx, CARVE, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ssd_bwd_bc, CARVE, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = a.tiles * (a.tiles + 1) / 2;
  ssd_bwd_cb<<<dim3(pairs, bc), WG, CB_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_ds<<<dim3(pairs, a.groups, bc), WG, DS_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx<<<dim3(a.tiles, cdiv(h, HX), bc), WG, DX_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc<<<dim3(a.tiles * a.halves, 2, bc), WG, BC_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce<<<dim3(h, bc), 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the cb, ds, dx and bc grids (bytes).
extern "C" int ssd_bwd_smem_bytes(int which) {
  return which == 0 ? CB_SMEM : which == 1 ? DS_SMEM : which == 2 ? DX_SMEM : BC_SMEM;
}

// Heads of a ds block (which = 0; the wrapper sizes gCB's head-group
// scratch by it) and of a dx block (1).
extern "C" int ssd_bwd_head_group(int which) { return which ? HX : HG; }

// Blocks of the cb, ds, dx and bc grids (which = 0..3) that fit one SM, or
// a negative CUDA error.
extern "C" int ssd_bwd_blocks_per_sm(int which) {
  int n = 0;
  const void* fns[4] = {reinterpret_cast<const void*>(ssd_bwd_cb),
                        reinterpret_cast<const void*>(ssd_bwd_ds),
                        reinterpret_cast<const void*>(ssd_bwd_dx),
                        reinterpret_cast<const void*>(ssd_bwd_bc)};
  const int smem[4] = {CB_SMEM, DS_SMEM, DX_SMEM, BC_SMEM};
  if (which < 0 || which > 3) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fns[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem[which]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fns[which], cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fns[which], WG, smem[which]);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
