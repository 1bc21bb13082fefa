// Helpers shared by the SSD forward (ssd.cu) and backward (ssd_bwd.cu):
// cp.async tile loads with zero fill, and 3xTF32 products on mma.sync
// m16n8k8 with an fp32 partial sum per k8 step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd_tc {

constexpr int T = 64;  // tile edge: the rows load_tile brings in

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 4-byte async copy of `bytes` (<= the size) bytes, zero-filling the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + 64) x columns [c0, c0 + W) of a row-major fp32 matrix
// (row stride `stride` floats; `rows` rows and `cols` columns exist) into
// dst[r][c] with row stride ld; zero outside.  vec: 16-byte copies (the
// row stride, c0 and the base are multiples of 4 floats).
template <int W, int NTHR>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t stride,
                                          int r0, int rows, int c0, int cols, bool vec, int tid) {
  if (vec) {
    constexpr int V = W / 4;
    for (int i = tid; i < T * V; i += NTHR) {
      const int r = i / V, c = (i % V) * 4;
      const int row = r0 + r, col = c0 + c;
      const int n = row < rows ? max(0, min(4, cols - col)) : 0;
      cp_async16(dst + r * ld + c, n ? src + row * stride + col : src, 4 * n);
    }
  } else {
    for (int i = tid; i < T * W; i += NTHR) {
      const int r = i / W, c = i % W;
      const int row = r0 + r, col = c0 + c;
      const bool ok = row < rows && col < cols;
      cp_async4(dst + r * ld + c, ok ? src + row * stride + col : src, ok ? 4 : 0);
    }
  }
}

// cum and dt of one head at s rows [s0, s0 + 64) -> dst[0..63], dst[64..127]
__device__ __forceinline__ void load_decay(float* dst, const float* cum, const float* dt,
                                           int s0, int q, int h, int head, bool ok, int tid) {
  if (tid < 2 * T) {
    const int s = s0 + tid % T;
    const bool in = ok && s < q;
    const float* src = (tid < T ? cum : dt) + (in ? static_cast<int64_t>(s) * h + head : 0);
    cp_async4(dst + tid, src, in ? 4 : 0);
  }
}

// cvt.rna.tf32.f32 in two integer operations, bit for bit: round the
// magnitude to 10 mantissa bits, ties away from zero (x finite)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b over one k8 step in 3xTF32: the small cross terms first,
// hi . hi last, into a fresh partial sum that is then added to d in fp32
// with round to nearest.  The tensor cores' own accumulation truncates;
// carried through the 16-38 steps of a product it biased y by up to
// ~4x the 3xTF32 products' own error (more than the 1e-4 tolerance).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, alo, bhi);
  mma_tf32(t, ahi, blo);
  mma_tf32(t, ahi, bhi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
}

// A fragment of m16n8k8 (row-major 16 x 8): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B fragment (8 x 8, k x n): b0 (t, g),
// b1 (t + 4, g); C fragment: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1) — g = lane / 4, t = lane % 4.  Shared-memory row
// strides that keep a warp's 32 fragment loads on 32 banks: 4 mod 32 for
// a tile read with rows on g and columns on t, 8 mod 32 for one read with
// rows on t and columns on g.

}  // namespace ssd_tc
