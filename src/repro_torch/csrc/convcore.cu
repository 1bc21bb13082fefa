// NVDLA convolutional core for Hopper (sm_90a): int8 GEMM with the SDP
// epilogue fused in.
//
// Replaces: src/repro/kernels/convcore/kernel.py::matmul_int8_kernel (body
// _matmul_kernel), the Pallas TPU kernel.  out[m, n] =
// epilogue(sum_k a[m, k] * b[k, n]) with epilogue(acc) = acc * scale[n] +
// bias[n], optionally ReLU'd, cast to fp32 or bf16.
//
// What bounds it on the H100: a YOLOv3-416 frame is 75 GEMMs of 65.86 GOP
// in all (33 us at 1,979 TOP/s int8) against ~350 MB of im2col patches,
// weights and outputs (104 us at 3.35 TB/s): bytes, summed over the frame.
// But every layer's bound is 0.1-8 us, so what a layer takes is set by how
// much of the card it keeps busy and how soon its loads arrive: at 128 x
// 128 output tiles, 71 of the 75 layers have fewer tiles than the 132 SMs.
//
// Design:
// * Tensor cores.  wgmma.mma_async m64nNk32 s8 x s8 -> s32 (N = BN, 64 or
//   128), both operands read from shared memory K-major, as 8-bit wgmma
//   requires: a is (M, Kp) and B arrives transposed, (N, Kp), so each row
//   of either is K-contiguous.  int32 accumulation is exact: |acc| <=
//   127^2 * 4,608 < 2^31, and an int32 sum does not depend on its order.
// * TMA.  One producer thread loads 128-byte K slices of a 128-row a tile
//   and a BN-row B tile into a ring of STAGES stages, with 128 B swizzle,
//   completing on mbarriers by byte count; two consumer warpgroups (64 rows
//   each) wait on them, keep one wgmma group in flight, and free a stage as
//   soon as the group that read it has finished.  setmaxnreg moves
//   registers from the producer warpgroup (40) to the consumers (232), as
//   in swa.cu.  The TMA maps and the wgmma descriptors share one swizzle
//   (128 B rows, 1,024-byte atoms of 8 rows: SBO 1,024, a k32 step is 32
//   bytes along the row).  Ragged M, N and K are TMA's zero fill (zeros
//   add nothing); only the stores are guarded.  A global row stride must
//   be a multiple of 16 bytes, so the wrapper pads K to 16 where it is not
//   (layer 0's K = 27) and nowhere else.
// * Filling the card (the launch plan, kernels/convcore/kernel.py).  A
//   block walks the 128-row tiles of its column of N in turn (blockIdx.x,
//   then gridDim.x on), so the ring runs on into the next tile while the
//   consumers store this one.  Where even BN = 64 leaves fewer tiles than
//   SMs, K is split into `splits` ranges of `kps` slices: each range's
//   block stores its int32 partial sums, and convcore_splitk_reduce adds
//   them in order and applies the epilogue, so the output is bit-identical
//   to the unsplit kernel's.
// * Epilogue.  In registers before the single store, rounding as the
//   reference's `acc.astype(f32) * scale + bias` does: int32 -> fp32 round
//   to nearest (__int2float_rn), __fmul_rn, __fadd_rn (no FMA contraction),
//   ReLU, then __float2bfloat16_rn for bf16.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;         // rows of an output tile: two consumer warpgroups of 64
constexpr int BK = 128;         // K bytes of a stage: one 128-byte swizzled row
constexpr int STAGES = 4;       // TMA ring
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup

template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK;            // 16 KB
  static constexpr int B_BYTES = BN * BK;            // 8 or 16 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;    // a multiple of the 1 KB atom
  // the ring, full and empty barriers, 1 KB to align the base to the atom
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;
};

// The two products, operand lists written out (generated):
// D (64 x N, s32) += A (64 x 32, s8, shared, K-major) . B (N x 32, s8,
// shared, K-major)^T
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float epilogue(int32_t acc, float scale, float bias, int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(v, 0.0f) : v;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One (128-row tile, BN columns, K range) at a time; with `partial` the
// int32 sums of K range blockIdx.z go to partial[z] (M x N), else the
// epilogue's values to `out`.
template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
convcore_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap, const float* __restrict__ scale,
                      const float* __restrict__ bias, OutT* __restrict__ out,
                      int32_t* __restrict__ partial, int M, int N, int nk, int kps, int relu) {
  using TL = Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;  // [STAGES] a tile, B tile
  const uint32_t full = ring + STAGES * TL::STAGE;          // [STAGES] slices landed
  const uint32_t empty = full + 8 * STAGES;                 // [STAGES] slices read

  const int m_tiles = (M + BM - 1) / BM;
  const int n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * kps;
  const int k_cnt = min(kps, nk - k0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int mt = blockIdx.x; mt < m_tiles; mt += gridDim.x)
        for (int kk = 0; kk < k_cnt; ++kk, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, TL::STAGE);
          const uint32_t dst = ring + st * TL::STAGE;
          tma_load_2d(dst, &amap, full + 8 * st, (k0 + kk) * BK, mt * BM);
          tma_load_2d(dst + TL::A_BYTES, &bmap, full + 8 * st, (k0 + kk) * BK, n0);
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int col0 = n0 + 2 * (lane % 4);  // this thread's columns: col0 + 8 j + {0, 1}
  int it = 0;
  for (int mt = blockIdx.x; mt < m_tiles; mt += gridDim.x) {
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kk = 0; kk < k_cnt; ++kk, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t a_tile = ring + st * TL::STAGE + wg * 64 * BK;  // this warpgroup's rows
      const uint32_t b_tile = ring + st * TL::STAGE + TL::A_BYTES;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)
        wgmma_s8(acc, smem_desc(a_tile + 32 * k, 16, 1024, 1),
                 smem_desc(b_tile + 32 * k, 16, 1024, 1));
      wgmma_commit();
      // the previous slice's group has finished: free its stage
      wgmma_wait<1>();
      if (kk > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
    pin(acc);
    if (k_cnt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }

    const int row0 = mt * BM + wg * 64 + warp * 16 + lane / 4;
    const bool pairs = (N & 1) == 0;  // (row, col) pairs 8- / 4-byte aligned
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;
      const bool both = col + 1 < N;
      if (partial) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row >= M) continue;
          int32_t* p = partial + (static_cast<int64_t>(blockIdx.z) * M + row) * N + col;
          if (both && pairs) {
            *reinterpret_cast<int2*>(p) = make_int2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
          } else {
            p[0] = acc[4 * j + 2 * r];
            if (both) p[1] = acc[4 * j + 2 * r + 1];
          }
        }
        continue;
      }
      const float s0 = __ldg(scale + col), b0 = __ldg(bias + col);
      const float s1 = both ? __ldg(scale + col + 1) : 0.f;
      const float b1 = both ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= M) continue;
        OutT* p = out + static_cast<int64_t>(row) * N + col;
        const float v0 = epilogue(acc[4 * j + 2 * r], s0, b0, relu);
        if (both) {
          const float v1 = epilogue(acc[4 * j + 2 * r + 1], s1, b1, relu);
          if (pairs) {
            store2(p, v0, v1);
          } else {
            store1(p, v0);
            store1(p + 1, v1);
          }
        } else {
          store1(p, v0);
        }
      }
    }
  }
}

// out = epilogue(sum over z of partial[z]), the ranges added in order.
template <typename OutT>
__global__ void __launch_bounds__(256)
convcore_splitk_reduce(const int32_t* __restrict__ partial, const float* __restrict__ scale,
                       const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                       int splits, int relu) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int32_t acc = 0;
    for (int z = 0; z < splits; ++z) acc += partial[z * total + i];
    const int col = static_cast<int>(i % N);
    store1(out + i, epilogue(acc, __ldg(scale + col), __ldg(bias + col), relu));
  }
}

// A (rows, Kp) int8 matrix as 2-d TMA boxes of 128 K bytes x box_rows rows,
// 128 B swizzle; K and rows past the ends read 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int kp, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};  // bytes
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename OutT>
int launch(const CUtensorMap& am, const CUtensorMap& bm, const float* scale, const float* bias,
           void* out, int32_t* partial, int M, int N, int nk, int relu, int splits, int kps,
           int m_blocks, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(convcore_wgmma_kernel<BN, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_blocks, (N + BN - 1) / BN, splits);
  convcore_wgmma_kernel<BN, OutT><<<grid, THREADS, smem, stream>>>(
      am, bm, scale, bias, static_cast<OutT*>(out), splits > 1 ? partial : nullptr, M, N, nk,
      kps, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  convcore_splitk_reduce<OutT><<<blocks, 256, 0, stream>>>(partial, scale, bias,
                                                           static_cast<OutT*>(out), M, N,
                                                           splits, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, Kp) int8, bt (N, Kp) int8, scale/bias (N,) fp32, out (M, N) fp32 or
// bf16; all contiguous, a and bt 16-byte aligned, Kp % 16 == 0.  The launch
// plan: BN (64 or 128) columns a tile, K cut into `splits` ranges of `kps`
// 128-byte slices (every range non-empty; `partial` an int32 (splits, M, N)
// scratch when splits > 1), `m_blocks` blocks along M.  Launches on
// `stream`; returns the CUDA error of the launches (0 on success).
extern "C" int convcore_matmul_int8(const void* a, const void* bt, const void* scale,
                                    const void* bias, void* out, void* partial, int M, int N,
                                    int Kp, int relu, int out_bf16, int bn, int splits, int kps,
                                    int m_blocks, void* stream) {
  const int nk = (Kp + BK - 1) / BK;
  const int m_tiles = (M + BM - 1) / BM;
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 16 || (bn != 64 && bn != 128) || splits < 1 ||
      kps < 1 || (splits - 1) * kps >= nk || splits * kps < nk || (splits > 1 && !partial) ||
      m_blocks < 1 || m_blocks > m_tiles || (N + bn - 1) / bn > 65535 || splits > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(bt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap am, bm;
  if (!tensor_map(&am, a, M, Kp, BM) || !tensor_map(&bm, bt, N, Kp, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto* ws = static_cast<int32_t*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return out_bf16 ? launch<64, __nv_bfloat16>(am, bm, s, b, out, ws, M, N, nk, relu, splits,
                                                kps, m_blocks, st)
                    : launch<64, float>(am, bm, s, b, out, ws, M, N, nk, relu, splits, kps,
                                        m_blocks, st);
  return out_bf16 ? launch<128, __nv_bfloat16>(am, bm, s, b, out, ws, M, N, nk, relu, splits,
                                               kps, m_blocks, st)
                  : launch<128, float>(am, bm, s, b, out, ws, M, N, nk, relu, splits, kps,
                                       m_blocks, st);
}

// Dynamic shared memory of the GEMM kernel at BN = bn (bytes), or -1.
extern "C" int convcore_smem_bytes(int bn) {
  return bn == 64 ? Tile<64>::SMEM : bn == 128 ? Tile<128>::SMEM : -1;
}

extern "C" const char* convcore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
