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
// Two launches, no atomics, so every gradient is summed in one fixed order
// and a resumed training run reproduces an unbroken one bit for bit:
//
// * swa_bwd_dq: one block per (batch, query head, tile of BR queries).  It
//   walks the tile's band of keys once for each row's max and sum (online,
//   fp32), writes lse and delta to fp32 (B, Hq, S) buffers, then walks the
//   band again: recomputes P, dP and dS and accumulates dQ in registers.
//   The forward kernel is not touched: it stores no lse.
// * swa_bwd_dkdv: one block per (batch, KV head, tile of BR keys).  It loops
//   over the KV head's query heads and over the query tiles whose band
//   meets the key tile, reads their lse and delta, recomputes P and dS
//   transposed and accumulates dK and dV for the whole group in registers:
//   GQA without atomics.
//
// Operands are bf16 or fp32 (one type), converted to fp32 as they are
// loaded into shared memory; every product is an fp32 FMA and every
// accumulator fp32; the gradients are cast to the operands' type once.
// Tiles are BR = 64 rows (32 at D = 256, to fit shared memory: the dkdv
// block holds K, V, Q and dO tiles of BR x (D + 4) floats and two BR x
// (BR + 4) probability tiles, 170 KB at D = 128, 142 KB at D = 256).
// 256 threads as 16 x 16: a thread owns an R x R patch of the score tile
// (R = BR / 16; rows ty*R + i, columns tx + 16 j) and R rows x 4 columns
// of each 64-column chunk of the accumulators.
//
// What bounds it on the H100: operations.  Each in-band pair costs 10 D
// FLOP in the backward (q.k, dO.v, dS.k, dS.q, p.dO: 2 D each; the dq
// kernel's first walk adds 2 D more), 10 D * sum_i min(i + 1, W) per head:
// at qwen2-0.5b's training shape (B 4, S 1024, 14 heads of 64) 18.8 GFLOP
// a layer against 5.5 MB of q, k, v, o, dO, dq, dk, dv in bf16, ~3,400 FLOP
// a byte.  This first version runs on the FMA units (67 TFLOP/s in fp32),
// not the tensor cores (989 TFLOP/s in bf16): it is simple and right first;
// wgmma and TMA, as in swa.cu's forward, are a later change.
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers), as its own library: swa.cu's library and timings are unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

using Launch = int (*)(const void*, const void*, const void*, const void*, const void*, void*,
                       void*, void*, float*, float*, int, int, int, int, int, float, float,
                       cudaStream_t);

template <typename T>
Launch launcher(int d) {
  switch (d) {
    case 16: return launch<T, 16>;
    case 32: return launch<T, 32>;
    case 64: return launch<T, 64>;
    case 128: return launch<T, 128>;
    case 256: return launch<T, 256>;
    default: return nullptr;
  }
}

}  // namespace

// q/o/dout/dq (B, S, Hq, D), k/v/dk/dv (B, S, Hkv, D), one type (bf16 when
// `bf16` is non-zero, else fp32), contiguous, 16-byte aligned, D in {16, 32,
// 64, 128, 256}; lse and delta fp32 (B, Hq, S) scratch.  Launches the dq
// grid, then the dkdv grid, on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int swa_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, void* dq, void* dk, void* dv, void* lse,
                              void* delta, int b, int s, int hq, int hkv, int d, int window,
                              float scale, float softcap, int bf16, void* stream) {
  const Launch fn = bf16 ? launcher<__nv_bfloat16>(d) : launcher<float>(d);
  if (!fn || b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || window < 1 || b > 65535 ||
      hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta), b,
            s, hq, hkv, window, scale, softcap, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the dq (which = 0) or dkdv (which = 1) kernel at
// head dim d (bytes), or -1.
extern "C" int swa_bwd_smem_bytes(int d, int which) {
  switch (d) {
    case 16: return which ? Shape<16, 64>::DKDV_SMEM : Shape<16, 64>::DQ_SMEM;
    case 32: return which ? Shape<32, 64>::DKDV_SMEM : Shape<32, 64>::DQ_SMEM;
    case 64: return which ? Shape<64, 64>::DKDV_SMEM : Shape<64, 64>::DQ_SMEM;
    case 128: return which ? Shape<128, 64>::DKDV_SMEM : Shape<128, 64>::DQ_SMEM;
    case 256: return which ? Shape<256, 32>::DKDV_SMEM : Shape<256, 32>::DQ_SMEM;
    default: return -1;
  }
}

extern "C" const char* swa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
