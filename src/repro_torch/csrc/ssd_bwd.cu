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
// (4 x 2048 tokens: 32 cells of q 256, h 24, p 64, n 128) a cell needs
// ~437 MFLOP (causal pairs only; C.B^T's recomputations not counted)
// against ~6 MB of inputs, outputs and scratch.  Every product must hold
// 1e-4 of max|g| against float64, so, as in the forward (ssd.cu), each is
// 3xTF32 on mma.sync m16n8k8 with an fp32 partial sum a k8 step (the
// helpers in ssd_tc.cuh), at 495/3 TFLOP/s.
//
// Design: four grids, no atomics — every sum over heads, tiles or p tiles
// runs in a fixed order, so two launches are bit-equal.
//   * ssd_bwd_dx: a block per (64-row s tile, 64 columns of p, group of
//     G = 2 heads, cell), s tiles with the most causal l tiles first: the
//     forward's y kernel transposed.  First U = B_s gst_h over n, 64 at a
//     time; each row's partial r over this p tile (x brought in with the
//     last of those units) goes to scratch, and U is scaled by
//     exp(cum_last - cum_s).  Then for every causal l tile it
//     rebuilds B_s C_l^T (64 x 64, from 128-wide chunks of n) once for the
//     G heads and accumulates sum_l CB E gy_h; dt_s is applied once at the
//     end.  Four warps a head, each 16 rows x 64 columns (at the forward's
//     two warps of 32 rows, four heads a block, the grid spilled).
//   * ssd_bwd_ds: a block per causal (l tile, s tile) pair and cell.  It
//     builds C_l B_s^T once into shared memory, then walks the heads in
//     order: dS_h = gy_h x_h^T
//     over p, then P, Q and gCB's term in registers; each warp writes its
//     rows' sums of P over its 32 columns and its columns' sums of Q over
//     its 16 rows to scratch, and gCB, summed over the heads in order, goes
//     to an fp32 (cell, q, q) scratch.
//   * ssd_bwd_bc: a block per (64 rows, 64 columns of n, gC or gB, cell):
//     gC = gCB B over the causal s tiles; gB = gCB^T C over the causal l
//     tiles, then sum_h (w_h x_h) gst_h^T over the heads in order.
//   * ssd_bwd_reduce: a block per (head, cell) sums the row, column and r
//     partials in tile order, adds the state terms and the last row's
//     sum_s w r (a fixed tree over the block), and writes gcum and gdt.
// Every tile arrives by cp.async (16 bytes where the rows allow it, else 4)
// into a two-slot ring, zero-filled past q, n, p and h.  Masking is inside
// the exponent, before exp: exp of a non-causal difference would be inf,
// and inf * 0 a NaN gradient.
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers), as its own library.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

using namespace ssd_tc;  // T = 64: the tile edge

constexpr int THREADS = 256;   // 8 warps in every grid
constexpr int NC = 128;        // chunk of n per C.B^T unit
constexpr int G = 2;           // heads per dx block: four warps each
constexpr int LDN = NC + 4;    // 128-wide chunk row stride (rows on g)
constexpr int LDA = T + 4;     // 64-wide tile read with rows on g
constexpr int LDB = T + 8;     // 64-wide tile read with rows on t
constexpr float NEG = -1e30f;
static_assert(THREADS / 32 == 4 * G, "four warps a head in the dx kernel");

// dx: a slot holds (B_s, C_l chunks), (a B_s block and the G heads' gst
// tiles, with their x tiles in the last) or (the G heads' gy tiles with
// cum_l); then the B_s C_l^T tile
constexpr int XH = T * LDB + 2 * T;
constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }
constexpr int DX_SLOT = max3(2 * T * LDN, T * LDA + 2 * G * T * LDB, G * XH);
constexpr int DX_SMEM = (2 * DX_SLOT + T * LDA) * 4;
// ds: (C_l, B_s chunks) or (gy_h, x_h tiles with cum_l, dt_l, cum_s, dt_s);
// then the C_l B_s^T tile
constexpr int DS_SLOT = 2 * T * LDN > 2 * T * LDA + 4 * T ? 2 * T * LDN : 2 * T * LDA + 4 * T;
constexpr int DS_SMEM = (2 * DS_SLOT + T * LDB) * 4;
// bc: (gCB, B tiles), (gCB, C tiles) or (x_h, gst_h tiles with cum_s, dt_s)
constexpr int BC_SLOT = max3(T * LDA + T * LDB, 2 * T * LDB, 2 * T * LDA + 2 * T);
constexpr int BC_SMEM = 2 * BC_SLOT * 4;

inline __host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// a C fragment pair (columns c, c + 1 of one row) into row-major dst
__device__ __forceinline__ void store_pair(float* dst, int col, int cols, float v0, float v1) {
  if (col + 1 < cols && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (col < cols) dst[0] = v0;
    if (col + 1 < cols) dst[1] = v1;
  }
}

// gx[cell, s, head, p] for one (s tile x p tile, head group, cell); the
// partial r over this p tile to rpart[cell, p tile, head, s].
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_dx(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ cum, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ gy,
           const float* __restrict__ gst, float* __restrict__ gx, float* __restrict__ rpart,
           int q, int h, int p, int n, int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem + 2 * DX_SLOT;  // B_s C_l^T tile [s][l]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l_tiles = cdiv(q, T);
  const int st = static_cast<int>(blockIdx.x) / p_tiles;  // most l tiles first
  const int pt = blockIdx.x % p_tiles;
  const int s0 = st * T, p0 = pt * T;
  const int head0 = blockIdx.y * G;
  const int64_t bc = blockIdx.z;
  const float* xb = x + bc * q * h * p;
  const float* gyb = gy + bc * q * h * p;
  const float* gstb = gst + bc * h * n * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float* Cb = C + bc * q * n;
  const bool vec_n = n % 4 == 0, vec_p = p % 4 == 0;

  const int n_blocks = cdiv(n, T);  // state units: 64 rows of n each
  const int n_chunks = cdiv(n, NC);  // C.B^T units of an l tile

  // the three kinds of unit, each into slot `slot`; every call site issues
  // only the kinds that can follow it, then commits
  auto issue_state = [&](int kb, int slot) {
    float* dst = smem + slot * DX_SLOT;
    const int k0 = kb * T;
    load_tile<T, THREADS>(dst, LDA, Bb, n, s0, q, k0, n, vec_n, tid);
    for (int hh = 0; hh < G; ++hh) {
      const int head = head0 + hh;
      const bool ok = head < h;
      load_tile<T, THREADS>(dst + T * LDA + hh * T * LDB, LDB,
                            gstb + static_cast<int64_t>(ok ? head : 0) * n * p, p, k0,
                            ok ? n : 0, p0, p, vec_p, tid);
      if (kb == n_blocks - 1)  // the last one also brings x for r
        load_tile<T, THREADS>(dst + T * LDA + (G + hh) * T * LDB, LDB,
                              xb + (ok ? head : 0) * p, static_cast<int64_t>(h) * p, s0,
                              ok ? q : 0, p0, p, vec_p, tid);
    }
  };
  auto issue_cb = [&](int l0, int ch, int slot) {
    float* dst = smem + slot * DX_SLOT;
    load_tile<NC, THREADS>(dst, LDN, Bb, n, s0, q, ch * NC, n, vec_n, tid);
    load_tile<NC, THREADS>(dst + T * LDN, LDN, Cb, n, l0, q, ch * NC, n, vec_n, tid);
  };
  auto issue_gy = [&](int l0, int slot) {
    for (int hh = 0; hh < G; ++hh) {
      const int head = head0 + hh;
      const bool ok = head < h;
      float* dst = smem + slot * DX_SLOT + hh * XH;
      load_tile<T, THREADS>(dst, LDB, gyb + (ok ? head : 0) * p, static_cast<int64_t>(h) * p,
                            l0, ok ? q : 0, p0, p, vec_p, tid);
      load_decay(dst + T * LDB, cumb, dtb, l0, q, h, head, ok, tid);
    }
  };

  // B_s C_l^T: this warp's 16 x 32 patch (rows rw + g, + 8)
  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  // this warp's head and 16 x 64 patch of gx (rows rh + g, + 8)
  const int hh = warp / 4, rh = 16 * (warp % 4);
  const int head = head0 + hh;
  const bool live = head < h;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // U = B_s gst_h, 64 rows of n a unit; units alternate between the slots
  int u = 0;
  issue_state(0, 0);
  cp_async_commit();
  for (int kb = 0; kb < n_blocks; ++kb, ++u) {
    if (kb + 1 < n_blocks)
      issue_state(kb + 1, (u + 1) % 2);
    else
      issue_cb(s0, 0, (u + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* bs = smem + (u % 2) * DX_SLOT;
    if (live) {
      const float* gs = bs + T * LDA + hh * T * LDB;
#pragma unroll 2
      for (int k = 0; k < T; k += 8) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(bs[(rh + g + 8 * (e & 1)) * LDA + k + t + 4 * (e >> 1)], ahi[e], alo[e]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bhi[2], blo[2];
          const float* gr = gs + (k + t) * LDB + 8 * j + g;
          split(gr[0], bhi[0], blo[0]);
          split(gr[4 * LDB], bhi[1], blo[1]);
          mma3(acc[j], ahi, alo, bhi, blo);
        }
      }
    }
    if (live && kb == n_blocks - 1) {
      // r over this p tile (x U, in column order, then across the 4 lanes
      // of a row), and U scaled by exp(cum_last - cum_s)
      const float* xs = bs + T * LDA + (G + hh) * T * LDB;
      const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rh + 8 * r + g;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + row * LDB + 8 * j + 2 * t);
          sum = fmaf(xv.x, acc[j][2 * r], sum);
          sum = fmaf(xv.y, acc[j][2 * r + 1], sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int s = s0 + row;
        const int64_t at = static_cast<int64_t>(min(s, q - 1)) * h + head;
        if (t == 0 && s < q)
          rpart[((bc * p_tiles + pt) * h + head) * static_cast<int64_t>(q) + s] = sum;
        const float ex = s < q ? expf(cum_last - cumb[at]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][2 * r] *= ex;
          acc[j][2 * r + 1] *= ex;
        }
      }
    }
    __syncthreads();
  }

  // cum_s of this warp's rows (any row past q is masked below)
  float cum_s[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    cum_s[r] = cumb[static_cast<int64_t>(min(s0 + rh + 8 * r + g, q - 1)) * h + head0 +
                    (live ? hh : 0)];

  // sum over the causal l tiles of (B_s C_l^T * E) gy_h
  for (int lt = st; lt < l_tiles; ++lt) {
    const int l0 = lt * T;
    float cb[4][4] = {};
    for (int ch = 0; ch < n_chunks; ++ch, ++u) {
      if (ch + 1 < n_chunks)
        issue_cb(l0, ch + 1, (u + 1) % 2);
      else
        issue_gy(l0, (u + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* bs = smem + (u % 2) * DX_SLOT;
      const float* cs = bs + T * LDN;
#pragma unroll 2
      for (int k = 0; k < NC; k += 8) {
        uint32_t ahi[4], alo[4];
        split(bs[(rw + g) * LDN + k + t], ahi[0], alo[0]);
        split(bs[(rw + g + 8) * LDN + k + t], ahi[1], alo[1]);
        split(bs[(rw + g) * LDN + k + t + 4], ahi[2], alo[2]);
        split(bs[(rw + g + 8) * LDN + k + t + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          const float* cr = cs + (cw + 8 * j + g) * LDN + k + t;
          split(cr[0], bhi[0], blo[0]);
          split(cr[4], bhi[1], blo[1]);
          mma3(cb[j], ahi, alo, bhi, blo);
        }
      }
      if (ch == n_chunks - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cw + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(cbs + (rw + g) * LDA + c) = make_float2(cb[j][0], cb[j][1]);
          *reinterpret_cast<float2*>(cbs + (rw + g + 8) * LDA + c) =
              make_float2(cb[j][2], cb[j][3]);
        }
      }
      __syncthreads();
    }
    if (lt + 1 < l_tiles) issue_cb(l0 + T, 0, (u + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const float* gys = smem + (u % 2) * DX_SLOT + hh * XH;
      const float* cum_l = gys + T * LDB;
#pragma unroll 1
      for (int k = 0; k < T; k += 8) {
        // (B_s C_l^T * E) as the A fragment
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rh + g + 8 * (e & 1), c = k + t + 4 * (e >> 1);
          const int s = s0 + r, l = l0 + c;
          const float seg = (l >= s && l < q && s < q) ? cum_l[c] - cum_s[e & 1] : NEG;
          split(cbs[r * LDA + c] * expf(seg), ahi[e], alo[e]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bhi[2], blo[2];
          const float* gr = gys + (k + t) * LDB + 8 * j + g;
          split(gr[0], bhi[0], blo[0]);
          split(gr[4 * LDB], bhi[1], blo[1]);
          mma3(acc[j], ahi, alo, bhi, blo);
        }
      }
    }
    __syncthreads();
    ++u;
  }

  if (!live) return;
  float* gxb = gx + bc * q * h * p;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + rh + 8 * r + g;
    if (s >= q) continue;
    const float d = dtb[static_cast<int64_t>(s) * h + head];
    float* dst = gxb + (static_cast<int64_t>(s) * h + head) * p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + 8 * j + 2 * t;
      store_pair(dst + col, col, p, acc[j][2 * r] * d, acc[j][2 * r + 1] * d);
    }
  }
}

// For one causal (l tile, s tile) pair of a cell: gCB's tile (summed over
// the heads in order) to gcb[cell, l, s]; per head the sums of P over each
// warp's 32 columns to rowp[cell, 2 s tile + half, head, l] and of Q over
// each warp's 16 rows to colq[cell, 4 l tile + quarter, head, s].
__global__ void __launch_bounds__(THREADS)
ssd_bwd_ds(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ cum, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ gy,
           float* __restrict__ gcb, float* __restrict__ rowp, float* __restrict__ colq, int q,
           int h, int p, int n) {
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem + 2 * DS_SLOT;  // C_l B_s^T tile [l][s]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l_tiles = cdiv(q, T);
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= static_cast<int>(blockIdx.x)) ++lt;
  const int st = static_cast<int>(blockIdx.x) - lt * (lt + 1) / 2;
  const int l0 = lt * T, s0 = st * T;
  const int64_t bc = blockIdx.y;
  const float* xb = x + bc * q * h * p;
  const float* gyb = gy + bc * q * h * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float* Cb = C + bc * q * n;
  const bool vec_n = n % 4 == 0, vec_p = p % 4 == 0;

  const int n_chunks = cdiv(n, NC);
  const int p_chunks = cdiv(p, T);
  const int units = n_chunks + h * p_chunks;

  auto issue = [&](int u) {
    if (u < units) {
      float* slot = smem + (u % 2) * DS_SLOT;
      if (u < n_chunks) {
        load_tile<NC, THREADS>(slot, LDN, Cb, n, l0, q, u * NC, n, vec_n, tid);
        load_tile<NC, THREADS>(slot + T * LDN, LDN, Bb, n, s0, q, u * NC, n, vec_n, tid);
      } else {
        const int v = u - n_chunks, head = v / p_chunks, pc = (v % p_chunks) * T;
        const int64_t hs = static_cast<int64_t>(h) * p;
        load_tile<T, THREADS>(slot, LDA, gyb + head * p, hs, l0, q, pc, p, vec_p, tid);
        load_tile<T, THREADS>(slot + T * LDA, LDA, xb + head * p, hs, s0, q, pc, p, vec_p, tid);
        float* dec = slot + 2 * T * LDA;
        load_decay(dec, cumb, dtb, l0, q, h, head, true, tid);
        load_decay(dec + 2 * T, cumb, dtb, s0, q, h, head, true, tid);
      }
    }
    cp_async_commit();
  };

  // this warp's 16 x 32 patch: rows rw + g (+ 8) of l, columns cw + 8 j + 2 t (+ 1) of s
  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  float cb[4][4] = {};

  issue(0);
  int u = 0;
  for (; u < n_chunks; ++u) {
    issue(u + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* cs = smem + (u % 2) * DS_SLOT;
    const float* bs = cs + T * LDN;
#pragma unroll 1
    for (int k = 0; k < NC; k += 8) {
      uint32_t ahi[4], alo[4];
      split(cs[(rw + g) * LDN + k + t], ahi[0], alo[0]);
      split(cs[(rw + g + 8) * LDN + k + t], ahi[1], alo[1]);
      split(cs[(rw + g) * LDN + k + t + 4], ahi[2], alo[2]);
      split(cs[(rw + g + 8) * LDN + k + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bhi[2], blo[2];
        const float* br = bs + (cw + 8 * j + g) * LDN + k + t;
        split(br[0], bhi[0], blo[0]);
        split(br[4], bhi[1], blo[1]);
        mma3(cb[j], ahi, alo, bhi, blo);
      }
    }
    if (u == n_chunks - 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cw + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(cbs + (rw + g) * LDB + c) = make_float2(cb[j][0], cb[j][1]);
        *reinterpret_cast<float2*>(cbs + (rw + g + 8) * LDB + c) =
            make_float2(cb[j][2], cb[j][3]);
      }
    }
    __syncthreads();
  }

  float gcbr[4][4] = {};
  for (int head = 0; head < h; ++head) {
    float ds[4][4] = {};
    for (int pc = 0; pc < p_chunks; ++pc, ++u) {
      issue(u + 1);
      cp_async_wait<1>();
      __syncthreads();
      const float* gys = smem + (u % 2) * DS_SLOT;
      const float* xs = gys + T * LDA;
#pragma unroll 1
      for (int k = 0; k < T; k += 8) {
        uint32_t ahi[4], alo[4];
        split(gys[(rw + g) * LDA + k + t], ahi[0], alo[0]);
        split(gys[(rw + g + 8) * LDA + k + t], ahi[1], alo[1]);
        split(gys[(rw + g) * LDA + k + t + 4], ahi[2], alo[2]);
        split(gys[(rw + g + 8) * LDA + k + t + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          const float* xr = xs + (cw + 8 * j + g) * LDA + k + t;
          split(xr[0], bhi[0], blo[0]);
          split(xr[4], bhi[1], blo[1]);
          mma3(ds[j], ahi, alo, bhi, blo);
        }
      }
      if (pc == p_chunks - 1) {
        const float* dec = xs + T * LDA;  // cum_l, dt_l, cum_s, dt_s
        float row[2] = {0.f, 0.f}, col[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          col[j][0] = col[j][1] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lr = rw + g + 8 * (e >> 1), sc = cw + 8 * j + 2 * t + (e & 1);
            const int l = l0 + lr, s = s0 + sc;
            const float seg = (l >= s && l < q && s < q) ? dec[lr] - dec[2 * T + sc] : NEG;
            const float ex = expf(seg), d = dec[3 * T + sc];
            const float qv = ds[j][e] * cbs[lr * LDB + sc] * ex;
            gcbr[j][e] = fmaf(ds[j][e] * ex, d, gcbr[j][e]);
            row[e >> 1] = fmaf(qv, d, row[e >> 1]);
            col[j][e & 1] += qv;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          row[r] += __shfl_xor_sync(0xffffffffu, row[r], 1);
          row[r] += __shfl_xor_sync(0xffffffffu, row[r], 2);
          const int l = l0 + rw + g + 8 * r;
          if (t == 0 && l < q)
            rowp[((bc * 2 * l_tiles + 2 * st + warp / 4) * h + head) * static_cast<int64_t>(q) +
                 l] = row[r];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = col[j][c];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            const int s = s0 + cw + 8 * j + 2 * t + c;
            if (g == 0 && s < q)
              colq[((bc * 4 * l_tiles + 4 * lt + warp % 4) * h + head) *
                       static_cast<int64_t>(q) + s] = v;
          }
      }
      __syncthreads();
    }
  }

  float* gb = gcb + bc * q * q;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0 + rw + g + 8 * r;
    if (l >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + cw + 8 * j + 2 * t;
      store_pair(gb + static_cast<int64_t>(l) * q + s, s, q, gcbr[j][2 * r], gcbr[j][2 * r + 1]);
    }
  }
}

// gC (which = 0: rows l) or gB (which = 1: rows s) for one (64-row tile x
// 64 columns of n, which, cell).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_bc(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ cum, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ gst,
           const float* __restrict__ gcb, float* __restrict__ gB, float* __restrict__ gC, int q,
           int h, int p, int n, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l_tiles = cdiv(q, T);
  const int rt = static_cast<int>(blockIdx.x) / n_tiles;
  const int r0 = rt * T, n0 = (blockIdx.x % n_tiles) * T;
  const bool is_b = blockIdx.y == 1;
  const int64_t bc = blockIdx.z;
  const float* xb = x + bc * q * h * p;
  const float* gstb = gst + bc * h * n * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float* Cb = C + bc * q * n;
  const float* gb = gcb + bc * q * q;
  const bool vec_n = n % 4 == 0, vec_p = p % 4 == 0, vec_q = q % 4 == 0;

  // gC: the causal s tiles 0..rt; gB: the causal l tiles rt.., then the
  // heads' p chunks
  const int p_chunks = cdiv(p, T);
  const int tiles = is_b ? l_tiles - rt : rt + 1;
  const int units = tiles + (is_b ? h * p_chunks : 0);

  auto issue = [&](int u) {
    if (u < units) {
      float* slot = smem + (u % 2) * BC_SLOT;
      if (u < tiles && !is_b) {
        load_tile<T, THREADS>(slot, LDA, gb, q, r0, q, u * T, q, vec_q, tid);
        load_tile<T, THREADS>(slot + T * LDA, LDB, Bb, n, u * T, q, n0, n, vec_n, tid);
      } else if (u < tiles) {
        const int l0 = (rt + u) * T;
        load_tile<T, THREADS>(slot, LDB, gb, q, l0, q, r0, q, vec_q, tid);
        load_tile<T, THREADS>(slot + T * LDB, LDB, Cb, n, l0, q, n0, n, vec_n, tid);
      } else {
        const int v = u - tiles, head = v / p_chunks, pc = (v % p_chunks) * T;
        load_tile<T, THREADS>(slot, LDA, xb + head * p, static_cast<int64_t>(h) * p, r0, q, pc,
                              p, vec_p, tid);
        load_tile<T, THREADS>(slot + T * LDA, LDA, gstb + static_cast<int64_t>(head) * n * p, p,
                              n0, n, pc, p, vec_p, tid);
        load_decay(slot + 2 * T * LDA, cumb, dtb, r0, q, h, head, true, tid);
      }
    }
    cp_async_commit();
  };

  // this warp's 16 x 32 patch: rows rw + g (+ 8), columns cw + 8 j + 2 t (+ 1) of n
  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  float acc[4][4] = {};

  issue(0);
  for (int u = 0; u < units; ++u) {
    issue(u + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* a = smem + (u % 2) * BC_SLOT;
    if (u < tiles && !is_b) {
      // gCB[l][s] rows on g; B[s][n] rows on t
      const float* bt = a + T * LDA;
#pragma unroll 2
      for (int k = 0; k < T; k += 8) {
        uint32_t ahi[4], alo[4];
        split(a[(rw + g) * LDA + k + t], ahi[0], alo[0]);
        split(a[(rw + g + 8) * LDA + k + t], ahi[1], alo[1]);
        split(a[(rw + g) * LDA + k + t + 4], ahi[2], alo[2]);
        split(a[(rw + g + 8) * LDA + k + t + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          const float* br = bt + (k + t) * LDB + cw + 8 * j + g;
          split(br[0], bhi[0], blo[0]);
          split(br[4 * LDB], bhi[1], blo[1]);
          mma3(acc[j], ahi, alo, bhi, blo);
        }
      }
    } else if (u < tiles) {
      // gCB[l][s] read transposed (A[s][l], rows on t); C[l][n] rows on t
      const float* ct = a + T * LDB;
#pragma unroll 2
      for (int k = 0; k < T; k += 8) {
        uint32_t ahi[4], alo[4];
        split(a[(k + t) * LDB + rw + g], ahi[0], alo[0]);
        split(a[(k + t) * LDB + rw + g + 8], ahi[1], alo[1]);
        split(a[(k + t + 4) * LDB + rw + g], ahi[2], alo[2]);
        split(a[(k + t + 4) * LDB + rw + g + 8], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          const float* cr = ct + (k + t) * LDB + cw + 8 * j + g;
          split(cr[0], bhi[0], blo[0]);
          split(cr[4 * LDB], bhi[1], blo[1]);
          mma3(acc[j], ahi, alo, bhi, blo);
        }
      }
    } else {
      // (w_h x_h)[s][p] rows on g; gst_h[n][p] read as B[p][n] (rows on g)
      const int head = (u - tiles) / p_chunks;
      const float* gs = a + T * LDA;
      const float* dec = gs + T * LDA;  // cum_s, dt_s
      const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
      const float w0 = expf(cum_last - dec[rw + g]) * dec[T + rw + g];
      const float w1 = expf(cum_last - dec[rw + g + 8]) * dec[T + rw + g + 8];
#pragma unroll 2
      for (int k = 0; k < T; k += 8) {
        uint32_t ahi[4], alo[4];
        split(a[(rw + g) * LDA + k + t] * w0, ahi[0], alo[0]);
        split(a[(rw + g + 8) * LDA + k + t] * w1, ahi[1], alo[1]);
        split(a[(rw + g) * LDA + k + t + 4] * w0, ahi[2], alo[2]);
        split(a[(rw + g + 8) * LDA + k + t + 4] * w1, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          const float* gr = gs + (cw + 8 * j + g) * LDA + k + t;
          split(gr[0], bhi[0], blo[0]);
          split(gr[4], bhi[1], blo[1]);
          mma3(acc[j], ahi, alo, bhi, blo);
        }
      }
    }
    __syncthreads();
  }

  float* out = (is_b ? gB : gC) + bc * q * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rw + g + 8 * r;
    if (row >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + cw + 8 * j + 2 * t;
      store_pair(out + static_cast<int64_t>(row) * n + col, col, n, acc[j][2 * r],
                 acc[j][2 * r + 1]);
    }
  }
}

// gcum and gdt of one (head, cell) from the partials, in tile order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dt, const float* __restrict__ cum,
               const float* __restrict__ rowp, const float* __restrict__ colq,
               const float* __restrict__ rpart, float* __restrict__ gdt,
               float* __restrict__ gcum, int q, int h, int p_tiles) {
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, head = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const int l_tiles = cdiv(q, T);
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
  auto part = [&](const float* base, int parts, int i, int l) {
    return base[((bc * parts + i) * h + head) * static_cast<int64_t>(q) + l];
  };
  auto r_of = [&](int l) {
    float r = 0.f;
    for (int i = 0; i < p_tiles; ++i) r += part(rpart, p_tiles, i, l);
    return r;
  };

  float wr = 0.f;
  for (int l = tid; l < q; l += THREADS) {
    const int64_t at = static_cast<int64_t>(l) * h + head;
    wr = fmaf(expf(cum_last - cumb[at]) * dtb[at], r_of(l), wr);
  }
  red[tid] = wr;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  const float total = red[0];

  for (int l = tid; l < q; l += THREADS) {
    const int lt = l / T;
    float rows = 0.f, cols = 0.f;
    for (int i = 0; i < 2 * (lt + 1); ++i) rows += part(rowp, 2 * l_tiles, i, l);
    for (int i = 4 * lt; i < 4 * l_tiles; ++i) cols += part(colq, 4 * l_tiles, i, l);
    const int64_t at = (bc * q + l) * h + head;
    const float d = dt[at], ex = expf(cum_last - cum[at]), r = r_of(l);
    gdt[at] = fmaf(ex, r, cols);
    float gc = rows - d * cols - ex * d * r;
    if (l == q - 1) gc += total;
    gcum[at] = gc;
  }
}

}  // namespace

// x / gy (BC, q, h, p), dt / cum (BC, q, h), B / C (BC, q, n), gst (BC, h,
// n, p) fp32 contiguous and 16-byte aligned, BC = batch * chunks; writes gx
// (BC, q, h, p), gdt / gcum (BC, q, h), gB / gC (BC, q, n) through the
// scratch gcb (BC, q, q), rowp (BC, 2 L, h, q), colq (BC, 4 L, h, q) and
// rpart (BC, P, h, q), L = ceil(q / 64), P = ceil(p / 64).  Launches the
// four grids on `stream`; returns the CUDA error of the launches.
extern "C" int ssd_bwd_launch(const float* x, const float* dt, const float* cum, const float* B,
                              const float* C, const float* gy, const float* gst, float* gx,
                              float* gdt, float* gcum, float* gB, float* gC, float* gcb,
                              float* rowp, float* colq, float* rpart, int bc, int q, int h, int p,
                              int n, void* stream) {
  if (bc <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || h > 65535 || bc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_bwd_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_ds, cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc, cudaFuncAttributeMaxDynamicSharedMemorySize, BC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int l_tiles = cdiv(q, T), p_tiles = cdiv(p, T), n_tiles = cdiv(n, T);
  ssd_bwd_ds<<<dim3(l_tiles * (l_tiles + 1) / 2, bc), THREADS, DS_SMEM, st>>>(
      x, dt, cum, B, C, gy, gcb, rowp, colq, q, h, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx<<<dim3(l_tiles * p_tiles, cdiv(h, G), bc), THREADS, DX_SMEM, st>>>(
      x, dt, cum, B, C, gy, gst, gx, rpart, q, h, p, n, p_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc<<<dim3(l_tiles * n_tiles, 2, bc), THREADS, BC_SMEM, st>>>(
      x, dt, cum, B, C, gst, gcb, gB, gC, q, h, p, n, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce<<<dim3(h, bc), THREADS, 0, st>>>(dt, cum, rowp, colq, rpart, gdt, gcum, q, h,
                                                  p_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the dx, ds and bc grids (bytes).
extern "C" int ssd_bwd_smem_bytes(int which) {
  return which == 0 ? DX_SMEM : which == 1 ? DS_SMEM : BC_SMEM;
}

extern "C" const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
