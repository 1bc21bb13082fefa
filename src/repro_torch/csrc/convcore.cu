// NVDLA convolutional core for Hopper (sm_90a): int8 GEMM with the SDP
// epilogue fused in.
//
// Replaces: src/repro/kernels/convcore/kernel.py::matmul_int8_kernel (body
// _matmul_kernel), the Pallas TPU kernel.  out[m, n] =
// epilogue(sum_k a[m, k] * b[k, n]) with epilogue(acc) = acc * scale[n] +
// bias[n], optionally ReLU'd, cast to fp32 or bf16.
//
// What bounds it on the H100: the YOLOv3-416 convs (M up to 173,056,
// K up to 4,608, N up to 1,024) are compute-bound on the int8 tensor cores
// for all but the thinnest layers (layer 0: K = 27, N = 32 is bound by the
// bytes of its im2col patches and its fp32 output).
//
// Design: int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32),
// int32 accumulation, which is exact: |acc| <= 127^2 * 4,608 < 2^31.  A
// block computes a 128 x BN output tile with 8 warps (4 along M, 2 along
// N); the K loop walks 32-byte slices staged in shared memory by cp.async,
// double-buffered so the next slice loads while the tensor cores work on
// this one.  Shared rows are padded to 48 bytes, so the fragment loads of
// a warp hit 32 distinct banks.  B arrives transposed, (N, Kp) with K
// contiguous, so both operands' fragments are 4 consecutive bytes of K.
// Ragged M and N are masked in the kernel (zero-filled loads, guarded
// stores); the wrapper zero-pads K to a multiple of 32 (zeros add
// nothing).  The epilogue runs in registers before the single store, with
// __fmul_rn / __fadd_rn so that it rounds twice exactly as the reference's
// `acc.astype(f32) * scale + bias` does (no FMA contraction).  wgmma and
// TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // shared row pitch (bytes): conflict-free fragments
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS)
    matmul_int8_kernel(const int8_t* __restrict__ a,   // (M, Kp)
                       const int8_t* __restrict__ bt,  // (N, Kp): B transposed
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       OutT* __restrict__ out, int M, int N, int Kp, int relu) {
  constexpr int WN = BN / 2;  // warp tile along N
  constexpr int NT = WN / 8;  // m16n8 tiles per warp along N
  __shared__ __align__(16) int8_t as[2][BM * LDS];
  __shared__ __align__(16) int8_t bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wm = warp >> 1, wn = warp & 1;    // 4 x 2 warps
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int32_t acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  auto load_slice = [&](int stage, int k0) {
    // BM rows x two 16-byte chunks: one chunk per thread
    {
      const int r = tid >> 1, c = (tid & 1) * 16;
      const bool ok = m0 + r < M;
      const int8_t* src = a + (size_t)(ok ? m0 + r : 0) * Kp + k0 + c;
      cp_async16(&as[stage][r * LDS + c], src, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * 2; i += THREADS) {
      const int r = i >> 1, c = (i & 1) * 16;
      const bool ok = n0 + r < N;
      const int8_t* src = bt + (size_t)(ok ? n0 + r : 0) * Kp + k0 + c;
      cp_async16(&bs[stage][r * LDS + c], src, ok);
    }
  };

  const int nk = Kp / BK;
  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_slice(cur ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_prev();  // slice kt has landed
    __syncthreads();

    const int8_t* sa = as[cur];
    const int8_t* sb = bs[cur];
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(sa + r * LDS + t * 4);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(sa + (r + 8) * LDS + t * 4);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(sa + r * LDS + 16 + t * 4);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(sa + (r + 8) * LDS + 16 + t * 4);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int c = wn * WN + ni * 8 + g;
      uint32_t bf[2];
      bf[0] = *reinterpret_cast<const uint32_t*>(sb + c * LDS + t * 4);
      bf[1] = *reinterpret_cast<const uint32_t*>(sb + c * LDS + 16 + t * 4);
      mma_s8(acc[0][ni], af[0], bf);
      mma_s8(acc[1][ni], af[1], bf);
    }
    __syncthreads();  // every warp is done with `cur` before it is refilled
  }

  // fused SDP epilogue: acc -> fp32, * scale[n] + bias[n], ReLU, one store
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn * WN + ni * 8 + t * 2 + (r & 1);
        if (row < M && col < N) {
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][r]), scale[col]), bias[col]);
          if (relu) v = fmaxf(v, 0.0f);
          store_out(out + (size_t)row * N + col, v);
        }
      }
}

template <int BN, typename OutT>
void launch(const int8_t* a, const int8_t* bt, const float* scale, const float* bias,
            void* out, int M, int N, int Kp, int relu, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_int8_kernel<BN, OutT><<<grid, THREADS, 0, stream>>>(
      a, bt, scale, bias, static_cast<OutT*>(out), M, N, Kp, relu);
}

}  // namespace

// a (M, Kp) int8, bt (N, Kp) int8, scale/bias (N,) fp32, out (M, N) fp32 or
// bf16; all contiguous, 16-byte aligned, Kp % 32 == 0.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int convcore_matmul_int8(const void* a, const void* bt, const void* scale,
                                    const void* bias, void* out, int M, int N, int Kp,
                                    int relu, int out_bf16, void* stream) {
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(bt);
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (Kp % BK != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 64) {
    if (out_bf16) launch<64, __nv_bfloat16>(a8, b8, s, b, out, M, N, Kp, relu, st);
    else launch<64, float>(a8, b8, s, b, out, M, N, Kp, relu, st);
  } else {
    if (out_bf16) launch<128, __nv_bfloat16>(a8, b8, s, b, out, M, N, Kp, relu, st);
    else launch<128, float>(a8, b8, s, b, out, M, N, Kp, relu, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* convcore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
