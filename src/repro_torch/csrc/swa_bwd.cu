// Backward pass of sliding-window (banded, causal) attention for Hopper
// (sm_90a): dQ, dK and dV of swa.cu's forward, by recomputation.
//
// Replaces: the gradient the reference takes by JAX's autodiff of
// src/repro/models/attention.py::_attend_chunk under jax.checkpoint
// (attention.py:151): its backward pass recomputes each query chunk's
// scores and probabilities instead of storing them.  The reference has no
// Pallas backward kernel; this is the port's form of the same recompute
// policy.  With s = scale * q_i . k_j, c = softcap * tanh(s / softcap) (or
// c = s), p = exp(c - lse_i) over the band i - window < j <= i:
//
//   delta_i = sum_d dO_i[d] O_i[d]
//   dP_ij   = dO_i . v_j
//   dS_ij   = p_ij (dP_ij - delta_i) * (1 - tanh^2)   (the last factor with a softcap)
//   dQ_i    = scale * sum_j dS_ij k_j
//   dK_j    = scale * sum_i dS_ij q_i     (over the KV head's group of query heads)
//   dV_j    = sum_i p_ij dO_i             (likewise)
//
// No atomics on either route: every gradient element is summed in one fixed
// order, so two launches on the same inputs are bit-equal and a resumed
// training run reproduces an unbroken one.  Two routes, chosen by the
// wrapper (kernel.bwd_route) by dtype and head dim:
//
// * bf16 at D <= 128: tensor cores (wgmma, bf16 in, fp32 accumulators) fed
//   by TMA, in the forward's block shape (attn_tc.cuh): a producer thread
//   keeps a 2-stage ring of streamed 64-row tiles in flight on mbarriers,
//   two consumer warpgroups own 64 rows each (setmaxnreg 24 / 240).  Three
//   launches:
//   - swa_bwd_tc_dq, a block per (query head, 128 query rows, batch), rows
//     last-first: Q and dO stay, the ring brings the K and V tiles of the
//     band.  S = Q K^T and dP = dO V^T (K-major), P = exp2(c - lse2) with
//     the lse the forward wrote, dS in fp32 (mask, softcap slope, delta),
//     dQ += dS K with dS rounded to bf16 (K MN-major).  One walk: the
//     forward's lse replaces the FMA route's first.  It also writes each
//     row's (lse2, delta = rowsum(dO O)) to a (B, Hq, SP) fp32 scratch, SP
//     = S rounded up to 64, for
//   - swa_bwd_tc_dkdv, a block per (query head, batch, 128 keys), key
//     blocks first-first (long bands first): K and V stay, the ring brings
//     the Q and dO tiles of the band and their rows' stats (one 512-byte
//     bulk copy).  S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T rounded to bf16 (dO, Q MN-major).  Each
//     GQA group is split over its query heads, so the grid fills the card
//     (448 blocks of 128 keys at qwen2-0.5b's training shape, against 64 if
//     a block owned a KV head); each writes its fp32 dK, dV share to a
//     (2, B, S, Hq, D) scratch, and
//   - swa_bwd_reduce sums each group's shares in head order, scales dK and
//     casts both to bf16 once.
//   Registers of a consumer thread at D 128: dK and dV 64 each, S^T and
//   dP^T 32 each.  Shared memory: 4 owned and 4 streamed tiles, 130 KB at
//   D 128.
// * fp32, and bf16 at D 256 (dK and dV would need 256 accumulator
//   registers a thread): the FMA grids.  swa_bwd_dq, one block per (batch,
//   query head, tile of BR queries), walks the tile's band once for each
//   row's max and sum (online, fp32), writes lse and delta to fp32
//   (B, Hq, S) buffers, then walks again: recomputes P, dP and dS and
//   accumulates dQ in registers.  swa_bwd_dkdv, one block per (batch, KV
//   head, tile of BR keys), loops over the KV head's query heads and the
//   query tiles whose band meets the key tile, recomputes P and dS
//   transposed and accumulates dK and dV for the whole group: GQA without
//   atomics.  Operands are converted to fp32 as they are loaded into shared
//   memory; every product is an fp32 FMA (what holds fp32 to 1e-4); the
//   gradients are cast to the operands' type once.  Tiles are BR = 64 rows
//   (32 at D = 256, to fit shared memory: 142 KB).  256 threads as 16 x
//   16: a thread owns an R x R patch of the score tile (R = BR / 16; rows
//   ty*R + i, columns tx + 16 j) and R rows x 4 columns of each 64-column
//   chunk of the accumulators.
//
// What bounds it on the H100: operations.  Each in-band pair costs 10 D
// FLOP (q.k, dO.v, dS.k, dS.q, p.dO: 2 D each; the FMA route's first walk
// adds 2 D more), 10 D * sum_i min(i + 1, W) per head: at qwen2-0.5b's
// training shape (B 4, S 1024, 14 heads of 64) 18.8 GFLOP a layer against
// 5.5 MB of q, k, v, o, dO, dq, dk, dv in bf16, ~3,400 FLOP a byte, far
// above the ~295 at which bf16 tensor cores (989 TFLOP/s), not HBM, bound
// it.  The shares of the split group add 29 MB of fp32 writes and reads at
// that shape, a few microseconds at 3.35 TB/s.
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers), as its own library.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 (and bf16 at D 256): FMA out of shared memory
// ---------------------------------------------------------------------------
namespace fma {

constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + BR) of one head of a (B, S, H, D) tensor -> dst[r][d]
// in fp32 with row stride D + 4; rows past S are zero.
template <typename T, int D, int BR>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S,
                                          int64_t row_stride, int tid) {
  constexpr int LD = D + 4;
  constexpr int V = D / 4;
  for (int idx = tid; idx < BR * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = load4(src + row * row_stride + c);
    store4(dst + r * LD + c, x);
  }
}

// The R x R patch of a (BR x BR) product tile: out[i][j] += a[ai(i)] . b[bj(j)]
// over D, a rows ty*R + i and b rows tx + 16 j of two fp32 tiles (stride LD).
template <int D, int R>
__device__ __forceinline__ void patch_dot(float (&out)[R][R], const float* a, const float* b,
                                          int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[R], y[R];
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = *reinterpret_cast<const float4*>(&a[(ty * R + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < R; ++j) y[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float s = out[i][j];
        s = fmaf(x[i].x, y[j].x, s);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        s = fmaf(x[i].w, y[j].w, s);
        out[i][j] = s;
      }
  }
}

// acc[i][c] += sum_r w[r][ty*R + i] * m[r][col(c)] over the BR rows r of two
// tiles: w (stride BR + 4, a thread's R entries of a row side by side) and m
// (stride D + 4); col(jj * 4 + e) = jj * 64 + tx * 4 + e.
template <int D, int BR>
__device__ __forceinline__ void accumulate(float (&acc)[BR / 16][((D + 63) / 64) * 4],
                                           const float* w, const float* m, int ty, int tx) {
  constexpr int R = BR / 16;
  constexpr int LD = D + 4;
  constexpr int LP = BR + 4;
  constexpr int DC = (D + 63) / 64;
#pragma unroll 4
  for (int r = 0; r < BR; ++r) {
    float pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = w[r * LP + ty * R + i];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = jj * 64 + tx * 4;
      if (col < D) {
        const float4 x = *reinterpret_cast<const float4*>(&m[r * LD + col]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pv[i], x.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pv[i], x.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pv[i], x.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pv[i], x.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }
}

// rows [row0, row0 + BR) of acc * mult -> out (B, S, H, D) head h, rows < S
template <typename T, int D, int BR>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[BR / 16][((D + 63) / 64) * 4],
                                           float mult, int64_t b, int row0, int S, int H, int h,
                                           int ty, int tx) {
  constexpr int R = BR / 16;
  constexpr int DC = (D + 63) / 64;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ty * R + i;
    if (row >= S) continue;
    T* ob = out + ((b * S + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = jj * 64 + tx * 4;
      if (col < D)
        store4(ob + col, make_float4(acc[i][jj * 4 + 0] * mult, acc[i][jj * 4 + 1] * mult,
                                     acc[i][jj * 4 + 2] * mult, acc[i][jj * 4 + 3] * mult));
    }
  }
}

// The capped score c of a raw dot product u, and dc/du / scale (1 - tanh^2,
// or 1 without a cap).
__device__ __forceinline__ float capped(float u, float scale, float softcap, float* slope) {
  const float s = u * scale;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    *slope = 1.f - t * t;
    return softcap * t;
  }
  *slope = 1.f;
  return s;
}

template <int D, int BR>
struct Shape {
  static constexpr int R = BR / 16;
  static constexpr int LD = D + 4;
  static constexpr int LP = BR + 4;
  static constexpr int DC = (D + 63) / 64;
  // dq: q, dO, k, v tiles and the transposed dS tile
  static constexpr int DQ_SMEM = static_cast<int>(sizeof(float)) * (4 * BR * LD + BR * LP);
  // dkdv: k, v, q, dO tiles, p and dS tiles, lse and delta of a query tile
  static constexpr int DKDV_SMEM =
      static_cast<int>(sizeof(float)) * (4 * BR * LD + 2 * BR * LP + 2 * BR);
};

template <typename T, int D, int BR>
__global__ void __launch_bounds__(THREADS, 1)
swa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
           float* __restrict__ lse_out, float* __restrict__ delta_out, int S, int HQ, int HKV,
           int window, float scale, float softcap) {
  using SH = Shape<D, BR>;
  constexpr int R = SH::R, LD = SH::LD, LP = SH::LP, DC = SH::DC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BR][LD]
  float* dos = qs + BR * LD;   // [BR][LD]
  float* ks = dos + BR * LD;   // [BR][LD]
  float* vs = ks + BR * LD;    // [BR][LD]
  float* dst = vs + BR * LD;   // [BR keys][LP]: dS, transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BR;
  const int hq = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = hq / (HQ / HKV);
  const int64_t qstride = (int64_t)HQ * D, kstride = (int64_t)HKV * D;
  const T* qb = q + (b * S * HQ + hq) * D;
  const T* ob = o + (b * S * HQ + hq) * D;
  const T* dob = dout + (b * S * HQ + hq) * D;
  const T* kb = k + (b * S * HKV + hk) * D;
  const T* vb = v + (b * S * HKV + hk) * D;
  float* lse_row = lse_out + (b * HQ + hq) * S;
  float* delta_row = delta_out + (b * HQ + hq) * S;

  load_tile<T, D, BR>(qs, qb, row0, S, qstride, tid);
  load_tile<T, D, BR>(dos, dob, row0, S, qstride, tid);
  __syncthreads();

  // delta_i = dO_i . O_i, each row reduced over its 16 threads
  float delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i, row = row0 + r;
    float part = 0.f;
    if (row < S)
      for (int c = tx * 4; c < D; c += 64) {
        const float4 x = load4(ob + row * qstride + c);
        const float4 g = *reinterpret_cast<const float4*>(&dos[r * LD + c]);
        part = fmaf(x.x, g.x, part);
        part = fmaf(x.y, g.y, part);
        part = fmaf(x.z, g.z, part);
        part = fmaf(x.w, g.w, part);
      }
    delta[i] = row_reduce_sum(part);
  }

  const int row_hi = min(row0 + BR, S);
  const int key_lo = max(0, row0 - window + 1);
  const int c_first = (key_lo / BR) * BR;

  // walk 1: each row's max and sum over its band -> lse
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  for (int c0 = c_first; c0 < row_hi; c0 += BR) {
    __syncthreads();  // the last tile's ks is read
    load_tile<T, D, BR>(ks, kb, c0, S, kstride, tid);
    __syncthreads();
    float sc[R][R] = {};
    patch_dot<D, R>(sc, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = row0 + ty * R + i;
      float rmax = NEG;
      bool band[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = c0 + tx + 16 * j;
        float slope;
        const float c = capped(sc[i][j], scale, softcap, &slope);
        band[j] = kpos <= qpos && qpos - kpos < window && kpos < S;
        sc[i][j] = band[j] ? c : NEG;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(rmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) psum += band[j] ? expf(sc[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + row_reduce_sum(psum);
      m[i] = m_new;
    }
  }
  float lse[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lse[i] = m[i] + logf(fmaxf(l[i], 1e-30f));
    const int row = row0 + ty * R + i;
    if (tx == 0 && row < S) {
      lse_row[row] = lse[i];
      delta_row[row] = delta[i];
    }
  }

  // walk 2: recompute P and dP, dS = P (dP - delta) (x slope), dQ += dS K
  float acc[R][DC * 4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;
  for (int c0 = c_first; c0 < row_hi; c0 += BR) {
    __syncthreads();  // the last tile's ks, vs, dst are read
    load_tile<T, D, BR>(ks, kb, c0, S, kstride, tid);
    load_tile<T, D, BR>(vs, vb, c0, S, kstride, tid);
    __syncthreads();
    float sc[R][R] = {}, dp[R][R] = {};
    patch_dot<D, R>(sc, qs, ks, ty, tx);
    patch_dot<D, R>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = row0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = c0 + tx + 16 * j;
        float slope;
        const float c = capped(sc[i][j], scale, softcap, &slope);
        const bool band = kpos <= qpos && qpos - kpos < window && kpos < S;
        const float p = band ? expf(c - lse[i]) : 0.f;
        dst[(tx + 16 * j) * LP + ty * R + i] = p * (dp[i][j] - delta[i]) * slope;
      }
    }
    __syncthreads();
    accumulate<D, BR>(acc, dst, ks, ty, tx);
  }
  store_rows<T, D, BR>(dq, acc, scale, b, row0, S, HQ, hq, ty, tx);
}

template <typename T, int D, int BR>
__global__ void __launch_bounds__(THREADS, 1)
swa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
             const float* __restrict__ lse_in, const float* __restrict__ delta_in, int S, int HQ,
             int HKV, int window, float scale, float softcap) {
  using SH = Shape<D, BR>;
  constexpr int R = SH::R, LD = SH::LD, LP = SH::LP, DC = SH::DC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [BR][LD]
  float* vs = ks + BR * LD;    // [BR][LD]
  float* qs = vs + BR * LD;    // [BR][LD]
  float* dos = qs + BR * LD;   // [BR][LD]
  float* ps = dos + BR * LD;   // [BR queries][LP]: P, keys side by side
  float* dss = ps + BR * LP;   // [BR queries][LP]: dS
  float* lse_s = dss + BR * LP;   // [BR]
  float* delta_s = lse_s + BR;    // [BR]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int c0 = blockIdx.x * BR;  // this block's keys
  const int hk = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int G = HQ / HKV;
  const int64_t qstride = (int64_t)HQ * D, kstride = (int64_t)HKV * D;

  load_tile<T, D, BR>(ks, k + (b * S * HKV + hk) * D, c0, S, kstride, tid);
  load_tile<T, D, BR>(vs, v + (b * S * HKV + hk) * D, c0, S, kstride, tid);

  float dk_acc[R][DC * 4], dv_acc[R][DC * 4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // query tiles whose band meets keys [c0, c0 + BR): r0 + BR - 1 >= c0 and
  // r0 - (c0 + BR - 1) < window
  const int r_hi = min(S, c0 + BR - 1 + window);
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const T* qb = q + (b * S * HQ + hq) * D;
    const T* dob = dout + (b * S * HQ + hq) * D;
    const float* lse_row = lse_in + (b * HQ + hq) * S;
    const float* delta_row = delta_in + (b * HQ + hq) * S;
    for (int r0 = c0; r0 < r_hi; r0 += BR) {
      __syncthreads();  // the last tile's qs, dos, ps, dss are read
      load_tile<T, D, BR>(qs, qb, r0, S, qstride, tid);
      load_tile<T, D, BR>(dos, dob, r0, S, qstride, tid);
      for (int r = tid; r < BR; r += THREADS) {
        const bool in = r0 + r < S;
        lse_s[r] = in ? lse_row[r0 + r] : 0.f;
        delta_s[r] = in ? delta_row[r0 + r] : 0.f;
      }
      __syncthreads();
      // transposed patches: keys ty*R + i, queries tx + 16 j
      float sc[R][R] = {}, dp[R][R] = {};
      patch_dot<D, R>(sc, ks, qs, ty, tx);
      patch_dot<D, R>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kpos = c0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = tx + 16 * j, qpos = r0 + r;
          float slope;
          const float c = capped(sc[i][j], scale, softcap, &slope);
          const bool band = kpos <= qpos && qpos - kpos < window && kpos < S && qpos < S;
          const float p = band ? expf(c - lse_s[r]) : 0.f;
          ps[r * LP + ty * R + i] = p;
          dss[r * LP + ty * R + i] = p * (dp[i][j] - delta_s[r]) * slope;
        }
      }
      __syncthreads();
      accumulate<D, BR>(dv_acc, ps, dos, ty, tx);
      accumulate<D, BR>(dk_acc, dss, qs, ty, tx);
    }
  }
  store_rows<T, D, BR>(dk, dk_acc, scale, b, c0, S, HKV, hk, ty, tx);
  store_rows<T, D, BR>(dv, dv_acc, 1.f, b, c0, S, HKV, hk, ty, tx);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
           void* dk, void* dv, float* lse, float* delta, int b, int s, int hq, int hkv,
           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BR = D > 128 ? 32 : 64;
  using SH = Shape<D, BR>;
  cudaError_t err = cudaFuncSetAttribute(swa_bwd_dq<T, D, BR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SH::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(swa_bwd_dkdv<T, D, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SH::DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q((s + BR - 1) / BR, hq, b);
  swa_bwd_dq<T, D, BR><<<grid_q, THREADS, SH::DQ_SMEM, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse, delta, s, hq, hkv,
      window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((s + BR - 1) / BR, hkv, b);
  swa_bwd_dkdv<T, D, BR><<<grid_k, THREADS, SH::DKDV_SMEM, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), lse, delta, s, hq, hkv, window,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma

// ---------------------------------------------------------------------------
// bf16 at D <= 128: wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using namespace attn_tc;

constexpr int BM = ROWS;                        // rows a consumer warpgroup owns
constexpr int BN = ROWS;                        // rows of a streamed tile
constexpr int CONSUMERS = 2;                    // consumer warpgroups: 128 rows a block
constexpr int STAGES = 2;                       // depth of the streamed ring
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int STATS = 2 * 4 * BN;               // (lse2, delta) of a streamed tile's rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Shape : Tile<D> {
  // two owned tiles a consumer warpgroup (Q, dO or K, V), two streamed
  // tiles a stage (K, V or Q, dO) and their rows' stats, barriers, and 1 KB
  // to align the base to the swizzle atom: 130 KB at D 128
  static constexpr int SMEM =
      2 * (CONSUMERS + STAGES) * Tile<D>::TILE + STAGES * STATS + 8 * (1 + 2 * STAGES) + 1024;
};

// The score transform in log2 units: c = scale2 u, or cap2 tanh(inner u)
// with the softcap (cap2 > 0).
struct Scores {
  float scale2, cap2, inner;
};

// P and dS of one pair from its raw products u = q.k and dp = dO.v, its
// row's lse2 (log2 units) and delta; a pair outside the band gets 0.
__device__ __forceinline__ void p_ds(float u, float dp, float lse2, float delta, bool keep,
                                     const Scores& sc, float& p, float& ds) {
  float x, slope = 1.f;
  if (sc.cap2 > 0.f) {
    const float t = tanhf(u * sc.inner);
    x = sc.cap2 * t;
    slope = 1.f - t * t;
  } else {
    x = u * sc.scale2;
  }
  p = keep ? exp2f(x - lse2) : 0.f;
  ds = p * (dp - delta) * slope;
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// One key tile for one dq warpgroup: S = Q K^T, dP = dO V^T, then dQ += dS K
// with dS rounded to bf16.  Thread (warp w, lane) owns rows qrow and qrow + 8
// and, in each 8-key block j, keys c0 + 8 j + kc and + 1.
template <int D>
__device__ __forceinline__ void dq_step(float (&acc)[D / 2], uint32_t qtile, uint32_t dotile,
                                        uint32_t ktile, uint32_t vtile, bool masked, int qrow,
                                        int c0, int kc, int window, const float (&lse2)[2],
                                        const float (&delta)[2], const Scores& sc) {
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  pin(s);
  pin(dp);
  wgmma_fence();
  ss_product<D>(s, qtile, ktile);
  ss_product<D>(dp, dotile, vtile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  pin(dp);
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p, ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = c0 + 8 * j + kc + (e & 1), qpos = qrow + 8 * (e >> 1);
      // keys past S fail kpos <= qpos for every row below S
      const bool keep = !masked || (kpos <= qpos && qpos - kpos < window);
      p_ds(s[4 * j + e], dp[4 * j + e], lse2[e >> 1], delta[e >> 1], keep, sc, p, ds[e]);
    }
    a[j / 2][2 * (j % 2) + 0] = pack_bf16(ds[0], ds[1]);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
  pin(acc);
  wgmma_fence();
  rs_product<D>(acc, a, ktile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
}

// One query tile for one dkdv warpgroup: S^T = K Q^T, dP^T = V dO^T, then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16.  Thread
// (warp w, lane) owns keys krow and krow + 8 and, in each 8-row block j,
// query rows r0 + 8 j + kc and + 1, whose (lse2, delta) pairs are `stats`.
template <int D>
__device__ __forceinline__ void dkdv_step(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t ktile,
                                          uint32_t vtile, uint32_t qtile, uint32_t dotile,
                                          const float4* stats, bool masked, int krow, int r0,
                                          int kc, int window, int S, const Scores& sc) {
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  pin(s);
  pin(dp);
  wgmma_fence();
  ss_product<D>(s, ktile, qtile);
  ss_product<D>(dp, vtile, dotile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  pin(dp);
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 st = stats[(8 * j + kc) / 2];  // rows 8 j + kc and + 1: (lse2, delta) each
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = r0 + 8 * j + kc + (e & 1), kpos = krow + 8 * (e >> 1);
      const bool keep = !masked || (kpos <= qpos && qpos - kpos < window && qpos < S);
      p_ds(s[4 * j + e], dp[4 * j + e], (e & 1) ? st.z : st.x, (e & 1) ? st.w : st.y, keep, sc,
           p[e], ds[e]);
    }
    pa[j / 2][2 * (j % 2) + 0] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    da[j / 2][2 * (j % 2) + 0] = pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
  pin(dk);
  pin(dv);
  wgmma_fence();
  rs_product<D>(dv, pa, dotile);
  rs_product<D>(dk, da, qtile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(dk);
  pin(dv);
}

__device__ __forceinline__ void init_barriers(uint32_t once, uint32_t full, uint32_t empty) {
  mbar_init(once, 1);
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    mbar_init(full + 8 * st, 1);
    mbar_init(empty + 8 * st, CONSUMERS * 4);  // one arrive per consumer warp
  }
  mbar_fence_init();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_bwd_tc_dq(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
              const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float2* __restrict__ stats,
              __nv_bfloat16* __restrict__ dq, int S, int SP, int HQ, int HKV, int window,
              float scale, Scores sc) {
  using SH = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t qs = (smem_u32(smem) + 1023) & ~1023u;  // [CONSUMERS] Q tiles
  const uint32_t dos = qs + CONSUMERS * SH::TILE;          // [CONSUMERS] dO tiles
  const uint32_t ks = dos + CONSUMERS * SH::TILE;          // [STAGES] K tiles
  const uint32_t vs = ks + STAGES * SH::TILE;              // [STAGES] V tiles
  const uint32_t qbar = vs + STAGES * SH::TILE;            // Q, dO landed
  const uint32_t full = qbar + 8;                          // [STAGES] K, V landed
  const uint32_t empty = full + 8 * STAGES;                // [STAGES] K, V read

  // heads fastest, row blocks last-first (long bands first), as the forward
  const int h = blockIdx.x, b = blockIdx.z;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * (CONSUMERS * BM);
  const int hk = h / (HQ / HKV);
  const int t_lo = max(0, row0 - window + 1) / BN;
  const int ntiles = (min(row0 + CONSUMERS * BM, S) - 1) / BN - t_lo + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(qbar, full, empty);
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      const int nq = min(CONSUMERS, (S - row0 + BM - 1) / BM);  // tiles with rows below S
      mbar_expect_tx(qbar, 2 * nq * SH::TILE);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < SH::CHUNKS; ++c) {
          const uint32_t off = w * SH::TILE + c * SH::CHUNK;
          tma_load_4d(qs + off, &qmap, qbar, c * SH::SW, h, row0 + w * BM, b);
          tma_load_4d(dos + off, &domap, qbar, c * SH::SW, h, row0 + w * BM, b);
        }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * SH::TILE);
        const int key0 = (t_lo + t) * BN;
        for (int c = 0; c < SH::CHUNKS; ++c) {
          const uint32_t off = st * SH::TILE + c * SH::CHUNK;
          tma_load_4d(ks + off, &kmap, full + 8 * st, c * SH::SW, hk, key0, b);
          tma_load_4d(vs + off, &vmap, full + 8 * st, c * SH::SW, hk, key0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = row0 + wg * BM;                     // this warpgroup's 64 rows
    const int qrow = r0 + (tid / 32) * 16 + lane / 4;  // and qrow + 8
    const int kc = 2 * (lane % 4);
    // each row's lse in log2 units and delta = dO . O (its four threads
    // each sum a quarter of the row), kept for the dkdv grid in `stats`
    // ((B, Hq, SP) pairs; rows from S to SP get zeros)
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qrow + 8 * r;
      float part = 0.f;
      lse2[r] = 0.f;
      if (qpos < S) {
        lse2[r] = lse[(static_cast<int64_t>(b) * HQ + h) * S + qpos] * LOG2E;
        const int64_t row = ((static_cast<int64_t>(b) * S + qpos) * HQ + h) * D;
        for (int c = (lane % 4) * 8; c < D; c += 32)
          part += dot8(*reinterpret_cast<const uint4*>(o + row + c),
                       *reinterpret_cast<const uint4*>(dout + row + c));
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      delta[r] = part;
      if (kc == 0 && qpos < SP)
        stats[(static_cast<int64_t>(b) * HQ + h) * SP + qpos] = make_float2(lse2[r], part);
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const int c0 = (t_lo + t) * BN;
      mbar_wait(full + 8 * st, (t / STAGES) & 1);
      if (r0 < S && c0 <= r0 + BM - 1 && r0 - (c0 + BN - 1) < window) {
        const bool interior = c0 + BN - 1 <= r0 && r0 + BM - 1 - c0 < window;
        dq_step<D>(acc, qs + wg * SH::TILE, dos + wg * SH::TILE, ks + st * SH::TILE,
                   vs + st * SH::TILE, !interior, qrow, c0, kc, window, lse2, delta, sc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qrow + 8 * r;
      if (qpos >= S) continue;
      __nv_bfloat16* dst = dq + ((static_cast<int64_t>(b) * S + qpos) * HQ + h) * D + kc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_bwd_tc_dkdv(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                const float2* __restrict__ stats, float* __restrict__ part, int S, int SP, int HQ,
                int HKV, int window, Scores sc) {
  using SH = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t ks = (base + 1023) & ~1023u;      // [CONSUMERS] K tiles
  const uint32_t vs = ks + CONSUMERS * SH::TILE;   // [CONSUMERS] V tiles
  const uint32_t qs = vs + CONSUMERS * SH::TILE;   // [STAGES] Q tiles
  const uint32_t dos = qs + STAGES * SH::TILE;     // [STAGES] dO tiles
  const uint32_t ss = dos + STAGES * SH::TILE;     // [STAGES] their rows' stats
  const uint32_t kbar = ss + STAGES * STATS;       // K, V landed
  const uint32_t full = kbar + 8;                  // [STAGES] Q, dO, stats landed
  const uint32_t empty = full + 8 * STAGES;        // [STAGES] Q, dO, stats read

  // heads fastest, then batches, key blocks first-first: the long bands
  // (the keys near 0 are read by the most query rows) start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * (CONSUMERS * BM);
  const int hk = h / (HQ / HKV);
  const int t_lo = k0 / BN;  // query tiles from the block's diagonal
  const int ntiles = (min(S, k0 + CONSUMERS * BM - 1 + window) - 1) / BN - t_lo + 1;
  const int wg = threadIdx.x / 128;
  const float2* stats_bh = stats + (static_cast<int64_t>(b) * HQ + h) * SP;

  if (threadIdx.x == 0) init_barriers(kbar, full, empty);
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      const int nk = min(CONSUMERS, (S - k0 + BM - 1) / BM);  // tiles with keys below S
      mbar_expect_tx(kbar, 2 * nk * SH::TILE);
      for (int w = 0; w < nk; ++w)
        for (int c = 0; c < SH::CHUNKS; ++c) {
          const uint32_t off = w * SH::TILE + c * SH::CHUNK;
          tma_load_4d(ks + off, &kmap, kbar, c * SH::SW, hk, k0 + w * BM, b);
          tma_load_4d(vs + off, &vmap, kbar, c * SH::SW, hk, k0 + w * BM, b);
        }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * SH::TILE + STATS);
        const int row = (t_lo + t) * BN;
        for (int c = 0; c < SH::CHUNKS; ++c) {
          const uint32_t off = st * SH::TILE + c * SH::CHUNK;
          tma_load_4d(qs + off, &qmap, full + 8 * st, c * SH::SW, h, row, b);
          tma_load_4d(dos + off, &domap, full + 8 * st, c * SH::SW, h, row, b);
        }
        bulk_load(ss + st * STATS, stats_bh + row, STATS, full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int c0 = k0 + wg * BM;                       // this warpgroup's 64 keys
    const int krow = c0 + (tid / 32) * 16 + lane / 4;  // and krow + 8
    const int kc = 2 * (lane % 4);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const int r0 = (t_lo + t) * BN;
      mbar_wait(full + 8 * st, (t / STAGES) & 1);
      // keys [c0, c0 + 64) meet rows [r0, r0 + 64) in the band; no mask
      // away from the diagonal, the band's far edge and S
      if (c0 < S && r0 + BN - 1 >= c0 && r0 - (c0 + BM - 1) < window) {
        const bool interior = r0 >= c0 + BM - 1 && r0 + BN - 1 - c0 < window && r0 + BN - 1 < S;
        dkdv_step<D>(dk, dv, ks + wg * SH::TILE, vs + wg * SH::TILE, qs + st * SH::TILE,
                     dos + st * SH::TILE,
                     reinterpret_cast<const float4*>(smem + (ss + st * STATS - base)),
                     !interior, krow, r0, kc, window, S, sc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    // this head's share of dK (unscaled) and dV, fp32, for swa_bwd_reduce
    const int64_t plane = static_cast<int64_t>(gridDim.y) * S * HQ * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = krow + 8 * r;
      if (kpos >= S) continue;
      float* pk = part + ((static_cast<int64_t>(b) * S + kpos) * HQ + h) * D + kc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(pk + plane + 8 * j) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dK = scale * sum_g partial dK, dV = sum_g partial dV over each KV head's
// G query heads, in head order, cast to bf16 once.  part is (2, B, S, Hq, D)
// fp32; row (b * S + s) * Hkv + hk of dK / dV reads Hq-rows row * G ... row *
// G + G - 1 of each plane.  A thread sums 8 columns of one row.
__global__ void __launch_bounds__(256)
swa_bwd_reduce(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int64_t rows, int G, int D, float scale) {
  const int per_row = D / 8;
  const int64_t plane = rows * G * D;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < rows * per_row; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / per_row;
    const int c = static_cast<int>(i % per_row) * 8;
    const float* src = part + row * G * D + c;
    float sk[8] = {}, sv[8] = {};
    for (int g = 0; g < G; ++g) {
      const float4* pk = reinterpret_cast<const float4*>(src + g * D);
      const float4* pv = reinterpret_cast<const float4*>(src + plane + g * D);
      const float4 k0 = pk[0], k1 = pk[1], v0 = pv[0], v1 = pv[1];
      const float xk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float xv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sk[e] += xk[e];
        sv[e] += xv[e];
      }
    }
    uint4 ok, ov;
    ok.x = pack_bf16(sk[0] * scale, sk[1] * scale);
    ok.y = pack_bf16(sk[2] * scale, sk[3] * scale);
    ok.z = pack_bf16(sk[4] * scale, sk[5] * scale);
    ok.w = pack_bf16(sk[6] * scale, sk[7] * scale);
    ov.x = pack_bf16(sv[0], sv[1]);
    ov.y = pack_bf16(sv[2], sv[3]);
    ov.z = pack_bf16(sv[4], sv[5]);
    ov.w = pack_bf16(sv[6], sv[7]);
    *reinterpret_cast<uint4*>(dk + row * D + c) = ok;
    *reinterpret_cast<uint4*>(dv + row * D + c) = ov;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float2* stats, float* part, int b,
           int s, int sp, int hq, int hkv, int window, float scale, float softcap,
           cudaStream_t stream) {
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  const int blocks = (s + CONSUMERS * BM - 1) / (CONSUMERS * BM);
  if (blocks > 65535 || sp != (s + BN - 1) / BN * BN) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if (!tensor_map<D>(&qm, q, b, s, hq) || !tensor_map<D>(&km, k, b, s, hkv) ||
      !tensor_map<D>(&vm, v, b, s, hkv) || !tensor_map<D>(&dom, dout, b, s, hq))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Shape<D>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(swa_bwd_tc_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(swa_bwd_tc_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scores sc{scale * LOG2E, softcap > 0.f ? softcap * LOG2E : 0.f,
                  softcap > 0.f ? scale / softcap : 0.f};
  swa_bwd_tc_dq<D><<<dim3(hq, blocks, b), THREADS, smem, stream>>>(
      qm, km, vm, dom, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats, static_cast<__nv_bfloat16*>(dq), s, sp,
      hq, hkv, window, scale, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_tc_dkdv<D><<<dim3(hq, b, blocks), THREADS, smem, stream>>>(
      qm, km, vm, dom, stats, part, s, sp, hq, hkv, window, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(b) * s * hkv;
  const int64_t threads = rows * (D / 8);
  const int grid = static_cast<int>(threads / 256 + 1 < 132 * 16 ? threads / 256 + 1 : 132 * 16);
  swa_bwd_reduce<<<grid, 256, 0, stream>>>(part, static_cast<__nv_bfloat16*>(dk),
                                           static_cast<__nv_bfloat16*>(dv), rows, hq / hkv, D,
                                           scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using FmaLaunch = int (*)(const void*, const void*, const void*, const void*, const void*, void*,
                          void*, void*, float*, float*, int, int, int, int, int, float, float,
                          cudaStream_t);

// fp32 at every head dim, bf16 only where the tensor-core route does not
// reach (D 256)
FmaLaunch fma_launcher(int d, bool bf16) {
  if (bf16) return d == 256 ? fma::launch<__nv_bfloat16, 256> : nullptr;
  switch (d) {
    case 16: return fma::launch<float, 16>;
    case 32: return fma::launch<float, 32>;
    case 64: return fma::launch<float, 64>;
    case 128: return fma::launch<float, 128>;
    case 256: return fma::launch<float, 256>;
    default: return nullptr;
  }
}

using TcLaunch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const float*, void*, void*, void*, float2*, float*, int, int, int, int,
                         int, int, float, float, cudaStream_t);

TcLaunch tc_launcher(int d) {
  switch (d) {
    case 16: return tc::launch<16>;
    case 32: return tc::launch<32>;
    case 64: return tc::launch<64>;
    case 128: return tc::launch<128>;
    default: return nullptr;
  }
}

bool valid(int b, int s, int hq, int hkv, int window) {
  return b > 0 && s > 0 && hq > 0 && hkv > 0 && hq % hkv == 0 && window >= 1 && b <= 65535 &&
         hq <= 65535;
}

}  // namespace

// q/o/dout/dq (B, S, Hq, D), k/v/dk/dv (B, S, Hkv, D), bf16, contiguous,
// 16-byte aligned, D in {16, 32, 64, 128}; lse the forward's fp32 (B, Hq, S)
// log-sum-exp; scratch: stats fp32 (B, Hq, sp, 2) with sp = S rounded up to
// 64, part fp32 (2, B, S, Hq, D).  Launches the dq, dkdv and reduce grids
// on `stream`; returns the first CUDA error (0 on success).
extern "C" int swa_bwd_tc_launch(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq, void* dk, void* dv,
                                 void* stats, void* part, int b, int s, int sp, int hq, int hkv,
                                 int d, int window, float scale, float softcap, void* stream) {
  const TcLaunch fn = tc_launcher(d);
  if (!fn || !valid(b, s, hq, hkv, window)) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
            static_cast<float2*>(stats), static_cast<float*>(part), b, s, sp, hq, hkv, window,
            scale, softcap, static_cast<cudaStream_t>(stream));
}

// The same tensors in fp32 at D in {16, 32, 64, 128, 256}, or bf16 (`bf16`
// non-zero) at D 256; lse and delta fp32 (B, Hq, S) scratch.  Launches the
// FMA dq grid, then the dkdv grid.
extern "C" int swa_bwd_fma_launch(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv, void* lse,
                                  void* delta, int b, int s, int hq, int hkv, int d, int window,
                                  float scale, float softcap, int bf16, void* stream) {
  const FmaLaunch fn = fma_launcher(d, bf16 != 0);
  if (!fn || !valid(b, s, hq, hkv, window)) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta), b,
            s, hq, hkv, window, scale, softcap, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory at head dim d (bytes), or -1: which = 0 the two
// tensor-core kernels (one size), 1 the FMA dq kernel, 2 the FMA dkdv kernel.
extern "C" int swa_bwd_smem_bytes(int d, int which) {
  switch (which * 1000 + d) {
    case 16: return tc::Shape<16>::SMEM;
    case 32: return tc::Shape<32>::SMEM;
    case 64: return tc::Shape<64>::SMEM;
    case 128: return tc::Shape<128>::SMEM;
    case 1016: return fma::Shape<16, 64>::DQ_SMEM;
    case 1032: return fma::Shape<32, 64>::DQ_SMEM;
    case 1064: return fma::Shape<64, 64>::DQ_SMEM;
    case 1128: return fma::Shape<128, 64>::DQ_SMEM;
    case 1256: return fma::Shape<256, 32>::DQ_SMEM;
    case 2016: return fma::Shape<16, 64>::DKDV_SMEM;
    case 2032: return fma::Shape<32, 64>::DKDV_SMEM;
    case 2064: return fma::Shape<64, 64>::DKDV_SMEM;
    case 2128: return fma::Shape<128, 64>::DKDV_SMEM;
    case 2256: return fma::Shape<256, 32>::DKDV_SMEM;
    default: return -1;
  }
}

extern "C" const char* swa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
