// Sliding-window (banded, causal) flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/swa/kernel.py::swa_attention_kernel (body
// _swa_kernel), the Pallas TPU kernel, together with the layout and GQA
// plumbing of src/repro/kernels/swa/ops.py.  For one (batch b, query head
// h), with query positions i and key positions j:
//
//   s(i, j) = softcap * tanh((q_i . k_j) * scale / softcap)   (or no cap)
//   o_i     = sum_j softmax_j(s(i, j)) v_j     over  i - window < j <= i
//
// in fp32 (online softmax m, l and an fp32 accumulator), output in the
// input's dtype.  q and o are (B, S, Hq, D), k and v (B, S, Hkv, D); query
// head h reads KV head h / (Hq / Hkv), so GQA is never expanded in memory.
//
// What bounds it on the H100: operations.  recurrentgemma-9b's prefill
// (S = 2560, 16 query heads, one KV head, D = 256, window 2048) needs
// 4 * D FLOP for each in-band (i, j) pair, 51.5 GFLOP, against 44.6 MB of
// q, k, v and o: ~1,150 FLOP per byte, far above the ~295 at which bf16
// tensor cores (989 TFLOP/s) rather than HBM (3.35 TB/s) are the limit.
// This first kernel computes in fp32 FMA (67 TFLOP/s) for both input
// types, so fp32 inputs hold the reference to 2e-5; tensor cores
// (mma.sync / wgmma on bf16), TMA and warp specialisation are later work.
//
// Design.  The TPU kernel runs a static band of window/bk + 1 kv steps per
// query block on a sequential grid, with out-of-band steps aliased to
// block 0 and masked.  Here one block of 256 threads owns 64 query rows of
// one (b, h) and loops over exactly the 64-key tiles that meet its band,
// [max(0, row0 - window + 1), min(row0 + 64, S)).  The query tile, the key
// and value tiles and the transposed probabilities live in shared memory
// as fp32 (217 KB at D = 256: dynamic shared memory, opted in per launch).
// Each thread computes a 4 x 4 patch of the score tile (rows ty*4 + i,
// keys tx + 16 j, so that the 8 threads of a shared-memory phase read 8
// different bank groups), the row max and sum are reduced across the 16
// threads of a row with shuffles, and the accumulator (64 x D fp32) is
// held in registers, 4 rows x D/16 columns per thread.  Ragged S: rows
// and keys past S are zero-filled on load and masked, and no row past S
// is stored.  A fully masked tile (a row whose band starts later) adds
// exp(0) terms that the first in-band tile scales by exp(-1e30 - m) = 0,
// as the TPU kernel's -1e30 fill does; the final divide clamps l at 1e-30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int LP = BQ + 4;    // row stride of the transposed probabilities
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys / columns
constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor -> fp32
// dst[r][d] with row stride D + 4; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S,
                                          int64_t row_stride, int tid) {
  constexpr int LD = D + 4;
  constexpr int V = D / 4;
  for (int idx = tid; idx < BQ * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = load4(src + row * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int S, int HQ, int HKV, int window, float scale,
           float softcap) {
  constexpr int LD = D + 4;
  constexpr int DC = (D + 63) / 64;  // 64-column chunks of the accumulator
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][LD]
  float* ks = qs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* pt = vs + BK * LD;    // [BK][LP]: probabilities, transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = hq / (HQ / HKV);
  const int64_t qstride = (int64_t)HQ * D, kstride = (int64_t)HKV * D;
  const T* qb = q + (b * S * HQ + hq) * D;
  const T* kb = k + (b * S * HKV + hk) * D;
  const T* vb = v + (b * S * HKV + hk) * D;

  load_tile<T, D>(qs, qb, row0, S, qstride, tid);

  float m[4], l[4], acc[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;
  }

  const int row_hi = min(row0 + BQ, S);
  const int key_lo = max(0, row0 - window + 1);
  for (int c0 = (key_lo / BK) * BK; c0 < row_hi; c0 += BK) {
    __syncthreads();  // q is loaded; the last tile's ks, vs, pt are read
    load_tile<T, D>(ks, kb, c0, S, kstride, tid);
    load_tile<T, D>(vs, vb, c0, S, kstride, tid);
    __syncthreads();

    float sc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(a[i].x, bk[j].x, s);
          s = fmaf(a[i].y, bk[j].y, s);
          s = fmaf(a[i].z, bk[j].z, s);
          s = fmaf(a[i].w, bk[j].w, s);
          sc[i][j] = s;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + ty * 4 + i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = c0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const bool in_band = kpos <= qpos && qpos - kpos < window && kpos < S;
        s = in_band ? s : NEG;
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(rmax));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_reduce_sum(psum);
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * LP + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[c * LP + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int col = jj * 64 + tx * 4;
        if (col < D) {
          const float4 w = *reinterpret_cast<const float4*>(&vs[c * LD + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj * 4 + 0] = fmaf(pv[i], w.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pv[i], w.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pv[i], w.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pv[i], w.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = row0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* ob = o + ((b * S + qpos) * HQ + hq) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = jj * 64 + tx * 4;
      if (col < D)
        store4(ob + col, make_float4(acc[i][jj * 4 + 0] / denom, acc[i][jj * 4 + 1] / denom,
                                     acc[i][jj * 4 + 2] / denom, acc[i][jj * 4 + 3] / denom));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int hq, int hkv,
           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem = static_cast<int>(sizeof(float) * ((BQ + 2 * BK) * LD + BK * LP));
  cudaError_t err = cudaFuncSetAttribute(swa_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  swa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, hq, hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, int b, int s, int hq,
             int hkv, int window, float scale, float softcap, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
    case 32: return launch<T, 32>(q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
    case 64: return launch<T, 64>(q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
    case 128: return launch<T, 128>(q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
    case 256: return launch<T, 256>(q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/o (B, S, Hq, D), k/v (B, S, Hkv, D), contiguous, 16-byte aligned, all of
// one dtype (0 = fp32, 1 = bf16); D in {16, 32, 64, 128, 256}.  Launches one
// grid on `stream` and returns its CUDA error (0 on success).
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int b, int s, int hq, int hkv, int d,
                                    int window, float scale, float softcap, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || window < 1 || hq > 65535 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(d, q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, s, hq, hkv, window, scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* swa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
