// fp32 products on Hopper's tensor cores in 3xTF32 for the SSD backward
// (ssd_bwd.cu): operand planes split once into tf32 hi and lo, the wgmma
// m64n64k8 tf32 instruction that reads them, and the 3xTF32 product of a
// 64-deep stage with an fp32 partial sum a k8 step.
//
// A plane holds one operand of a product K-major (k contiguous) in chunks
// of 64 rows x 32 columns: 128-byte rows under the 128 B swizzle, which is
// both the layout a 32 x 64 fp32 TMA box with CU_TENSOR_MAP_SWIZZLE_128B
// lands in and the one the wgmma descriptors name (layout type 1, 8-row
// groups 1,024 bytes apart).  A 64-deep operand is two chunks (a 16 KB
// tile); k8 step kk starts kk / 4 chunks in and (kk % 4) x 32 bytes into
// the row.  tf32 wgmma has no transpose bit, so both shared operands must
// be K-major: an operand stored MN-major is transposed as it is split.
//
// Every helper here is run by one warpgroup (128 threads); the splits
// sync it by named barrier `bar` (bar.sync bar, 128).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_tc.cuh"

namespace tf32_tc {

using namespace hopper;

constexpr int WG = 128;            // threads of the warpgroup that runs these
constexpr int ROWS = 64;           // rows of a chunk: the M and N of every product
constexpr int CHUNK = ROWS * 128;  // bytes of a 64 x 32 chunk
constexpr int TILE = 2 * CHUNK;    // a 64 x 64 tile: two chunks

// byte offset of element (r, c) of a tile of 32-column chunks under the
// 128 B swizzle (the chunk base 1,024-byte aligned)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 5) * CHUNK + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// the descriptor of k8 step kk of a plane at shared address `plane`
__device__ __forceinline__ uint64_t plane_desc(uint32_t plane, int kk) {
  return smem_desc(plane + (kk >> 2) * CHUNK + (kk & 3) * 32, 16, 1024, 1);
}

// what k8 step kk adds to a plane's step-0 descriptor: its byte offset in
// the 16-byte units of the start-address field (shared addresses stay
// below 256 KB, so the field never carries)
__device__ __forceinline__ uint64_t step_off(int kk) {
  return static_cast<uint64_t>(((kk >> 2) * CHUNK + (kk & 3) * 32) >> 4);
}

// wgmma m64n64k8 tf32, fp32 accumulator, d = (scale_d ? d : 0) + A . B^T,
// A and B from shared memory (both K-major).  The operand list is written
// out (generated).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the shared addresses of an operand's two planes
struct Planes {
  uint32_t hi, lo;
};

// acc += part in fp32 with round to nearest, once part's group is done
__device__ __forceinline__ void add_part(float (&acc)[32], float (&part)[32]) {
  pin(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// part = A . B^T over k8 step kk in 3xTF32: the small cross terms first
// (lo.hi into a fresh sum, then hi.lo), hi.hi last; one commit group
__device__ __forceinline__ void step_ss(float (&part)[32], uint64_t alo, uint64_t ahi,
                                        uint64_t blo, uint64_t bhi, int kk) {
  wgmma_fence();
  mma_ss(part, alo + step_off(kk), bhi + step_off(kk), 0);
  mma_ss(part, ahi + step_off(kk), blo + step_off(kk), 1);
  mma_ss(part, ahi + step_off(kk), bhi + step_off(kk), 1);
  wgmma_commit();
}

// acc (64 x 64) += A . B^T over one 64-deep stage: eight k8 steps, each a
// fresh 3xTF32 partial added to acc in fp32 in k order.  The tensor cores'
// own accumulation truncates, so no partial is carried from step to step;
// two partials in turn keep one step's products in flight while the last
// step's is added.  acc's element i sits at row 16 w + g + 8 ((i >> 1) &
// 1), column 8 (i >> 2) + 2 t + (i & 1) (warp w of the warpgroup).
__device__ __forceinline__ void product_ss(float (&acc)[32], Planes a, Planes b) {
  const uint64_t alo = plane_desc(a.lo, 0), ahi = plane_desc(a.hi, 0);
  const uint64_t blo = plane_desc(b.lo, 0), bhi = plane_desc(b.hi, 0);
  float p0[32], p1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p0[i] = p1[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; kk += 2) {
    step_ss(p0, alo, ahi, blo, bhi, kk);
    if (kk) {
      wgmma_wait<1>();
      add_part(acc, p1);
    }
    step_ss(p1, alo, ahi, blo, bhi, kk + 1);
    wgmma_wait<1>();
    add_part(acc, p0);
  }
  wgmma_wait<0>();
  add_part(acc, p1);
}

// ---------------------------------------------------------------------------
// splitting.  hi is the fp32 value itself: the tensor cores read a tf32
// operand from an fp32 word's top 19 bits, i.e. hi = x truncated to tf32.
// lo = x - trunc(x) (exact in fp32) rounded to tf32 to nearest, so
// hi + lo = x to within 2^-21 |x|.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t lo_of(float x) {
  return ssd_tc::tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
}
__device__ __forceinline__ uint4 lo4(float4 v) {
  return make_uint4(lo_of(v.x), lo_of(v.y), lo_of(v.z), lo_of(v.w));
}

// An operand already K-major (as it landed): its lo plane at the same
// offsets from `lo` (the landed values are the hi plane).  With `scale`,
// each row r of a chunk is multiplied by scale[r] first, in place.
// Unrolled, so that every load is in flight before the first store.
template <int BYTES>
__device__ __forceinline__ void split_natural(uint8_t* hi, uint8_t* lo, int tid,
                                              const float* scale = nullptr) {
#pragma unroll
  for (int off = 16 * tid; off < BYTES; off += 16 * WG) {
    float4 v = *reinterpret_cast<const float4*>(hi + off);
    if (scale) {
      const float s = scale[(off % CHUNK) >> 7];
      v.x *= s;
      v.y *= s;
      v.z *= s;
      v.w *= s;
      *reinterpret_cast<float4*>(hi + off) = v;
    }
    *reinterpret_cast<uint4*>(lo + off) = lo4(v);
  }
}

// sync the 128 threads of one warpgroup on named barrier `id`
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// identity: an operand split as it landed
struct AsIs {
  __device__ __forceinline__ float operator()(int, int, float v) const { return v; }
};

// A 64 x 64 tile that landed MN-major ([k][m] as rows x columns),
// transposed in place into a K-major hi plane ([m][k]) and split into its
// lo plane, each value v at landed row r, column c first mapped to
// f(r, c, v).
// Each thread reads its 32 values, the warpgroup syncs, then it writes:
// a warp reads 32 consecutive columns of one row and writes 16-byte units
// of 32 consecutive plane rows, both free of bank conflicts.
template <class F>
__device__ __forceinline__ void read_transposed(const uint8_t* hi, int tid, F f,
                                                float (&v)[8][4]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = tid + WG * m, c = i & 63, ku = i >> 6;  // plane row c, k = 4 ku ..
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[m][j] = f(4 * ku + j, c, *reinterpret_cast<const float*>(hi + swz(4 * ku + j, c)));
  }
}
__device__ __forceinline__ void write_transposed(uint8_t* hi, uint8_t* lo, int tid,
                                                 const float (&v)[8][4]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = tid + WG * m, c = i & 63, ku = i >> 6;
    const float4 x = make_float4(v[m][0], v[m][1], v[m][2], v[m][3]);
    *reinterpret_cast<float4*>(hi + swz(c, 4 * ku)) = x;
    *reinterpret_cast<uint4*>(lo + swz(c, 4 * ku)) = lo4(x);
  }
}

template <class F = AsIs>
__device__ __forceinline__ void split_transposed(uint8_t* hi, uint8_t* lo, int tid, int bar,
                                                 F f = F()) {
  float v[8][4];
  read_transposed(hi, tid, f, v);
  wg_sync(bar);
  write_transposed(hi, lo, tid, v);
}

// Two such tiles in one pass (one sync), the first's values mapped by f.
template <class F>
__device__ __forceinline__ void split_transposed2(uint8_t* hi0, uint8_t* lo0, F f, uint8_t* hi1,
                                                  uint8_t* lo1, int tid, int bar) {
  float v0[8][4], v1[8][4];
  read_transposed(hi0, tid, f, v0);
  read_transposed(hi1, tid, AsIs(), v1);
  wg_sync(bar);
  write_transposed(hi0, lo0, tid, v0);
  write_transposed(hi1, lo1, tid, v1);
}

// Make this thread's plane writes visible to the tensor cores (the async
// proxy); the warpgroup syncs after it.
__device__ __forceinline__ void fence_planes() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tf32_tc
