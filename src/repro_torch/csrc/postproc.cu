// NVDLA post-processing (SDP + PDP) for Hopper (sm_90a): one fused pass of
// per-channel scale and bias, activation and max-pool over an NHWC map.
//
// Replaces: src/repro/kernels/postproc/kernel.py::postprocess_kernel (body
// _postproc_kernel), the Pallas TPU kernel.  out[n, oh, ow, c] =
// max over the pool x pool window of act(x * scale[c] + bias[c]).
//
// What bounds it on the H100: bytes.  It does a few operations per element
// read, far below the ~300 operations per byte at which the card stops
// being memory-bound.
//
// Design: one thread per output element, channels innermost, so a warp's
// loads and stores are contiguous runs of one row.  Each input is read
// once and only the pooled map is written, as in the TPU kernel.  Scale,
// bias and activation are applied in fp32 before the max (the order
// matters when a scale is negative, and it is the reference's order), with
// __fmul_rn / __fadd_rn so they round exactly as the reference does.  Only
// the floor(H/pool) x floor(W/pool) outputs are computed, so the ragged
// edge needs no padding: the reference's -3e38 padding never reaches a
// kept output.  A grid-stride loop covers any size with a bounded grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

__device__ __forceinline__ float load_in(const float* p) { return *p; }
__device__ __forceinline__ float load_in(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kSigmoid: return 1.0f / (1.0f + expf(-v));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(THREADS)
    postproc_kernel(const InT* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, OutT* __restrict__ out, int H, int W,
                    int C, int Ho, int Wo, int act, int pool, int64_t total) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    int64_t r = idx / C;
    const int ow = (int)(r % Wo);
    r /= Wo;
    const int oh = (int)(r % Ho);
    const int64_t n = r / Ho;
    const float s = scale[c], b = bias[c];
    float m = -INFINITY;
    for (int i = 0; i < pool; ++i) {
      const InT* row = x + ((n * H + (int64_t)oh * pool + i) * W + (int64_t)ow * pool) * C + c;
      for (int j = 0; j < pool; ++j) {
        const float v = activate(__fadd_rn(__fmul_rn(load_in(row + (int64_t)j * C), s), b), act);
        m = fmaxf(m, v);
      }
    }
    store_out(out + idx, m);
  }
}

template <typename InT, typename OutT>
void launch(const void* x, const float* scale, const float* bias, void* out, int N, int H,
            int W, int C, int act, int pool, cudaStream_t stream) {
  const int Ho = H / pool, Wo = W / pool;
  const int64_t total = (int64_t)N * Ho * Wo * C;
  if (total == 0) return;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  postproc_kernel<InT, OutT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const InT*>(x), scale, bias, static_cast<OutT*>(out), H, W, C, Ho, Wo, act,
      pool, total);
}

}  // namespace

// x (N, H, W, C) fp32 or bf16, scale/bias (C,) fp32, out (N, H/pool, W/pool,
// C) fp32 or bf16; all contiguous.  act: 0 none, 1 relu, 2 sigmoid, 3 tanh.
// Returns the CUDA error of the launch (0 on success).
extern "C" int postproc_launch(const void* x, int in_bf16, const void* scale, const void* bias,
                               void* out, int out_bf16, int N, int H, int W, int C, int act,
                               int pool, void* stream) {
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (pool < 1 || act < kNone || act > kTanh) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16) {
    if (out_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, s, b, out, N, H, W, C, act, pool, st);
    else launch<__nv_bfloat16, float>(x, s, b, out, N, H, W, C, act, pool, st);
  } else {
    if (out_bf16) launch<float, __nv_bfloat16>(x, s, b, out, N, H, W, C, act, pool, st);
    else launch<float, float>(x, s, b, out, N, H, W, C, act, pool, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* postproc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
