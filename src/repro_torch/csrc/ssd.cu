// Mamba-2 SSD intra-chunk step for Hopper (sm_90a), state-space duality
// (arXiv:2405.21060), single SSM group (g == 1, mamba2-130m).
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_kernel (body
// _ssd_kernel), the Pallas TPU kernel.  Per (sequence b, chunk c, head h),
// with cum the within-chunk prefix sum of dt*A computed by the wrapper:
//
//   scores(l, s) = (C_l . B_s) * exp(cum_l - cum_s) * dt_s      (l >= s)
//   y(l, :)      = sum_s scores(l, s) * x(s, h, :)
//   state(:, :)  = sum_s B_s^T (exp(cum_last - cum_s) * dt_s * x(s, h, :))
//
// What bounds it on the H100: operations.  At q = 256, h = 24, p = 64,
// n = 128 a chunk needs ~214 MFLOP (the causal l >= s pairs only; the TPU
// kernel computes the full q x q, ~327 MFLOP) against ~4.2 MB of inputs
// and outputs.  The result must hold 1e-4 against the fp32 reference
// (|y| reaches the hundreds), which one TF32 product (about three digits)
// misses, so every product is 3xTF32 on the tensor cores: each fp32
// operand a is split into hi = tf32(a) (round to nearest, ties away, as
// cvt.rna) and lo = tf32(a - hi), and lo.hi + hi.lo + hi.hi of each k8
// step go through mma.sync.m16n8k8.tf32 (three products at the TF32
// rate, 495/3 TFLOP/s, against 67 TFLOP/s of fp32 FMA) into a partial sum
// that is added to the accumulator in fp32, rounding to nearest.  mma.sync rather than wgmma: tf32
// wgmma needs both shared operands K-major, and x (s, p) and B (s, n) are
// MN-major in scores @ x and B^T (w x); mma.sync fragments load from
// either layout with 32-bit shared loads.
//
// Design.  The TPU kernel holds the whole (q, q) score matrix of a chunk
// in VMEM and loops over heads.  A Hopper block has at most 227 KB of
// shared memory and the blocks run in parallel, so:
//   * ssd_y_kernel: one block per (64-row l tile, 64 columns of p, group
//     of G = 4 heads, sequence x chunk), l tiles last-first (the long
//     causal rows start first).  For each causal 64-row s tile its 8 warps
//     build the 64 x 64 C.B^T tile once, from 128-wide chunks of n, into
//     shared memory; then two warps a head each take 32 rows x 64 columns
//     of y_h += scores @ x_h, forming scores = CB * exp(masked cum_l -
//     cum_s) * dt_s as their A fragments.  C.B^T costs 24 / G
//     recomputations per chunk instead of one per head and p tile.  A
//     warp's 32 x 64 patch of one head (48 products a k8 step for 8
//     scores and 16 x values split) in place of a 16 x 32 patch of every
//     head (12 products for 4 scores and 8 x values), since the work
//     around the products, not the products, sets the pace on the H100.
//     Shared memory holds one s tile
//     at a time, so it does not grow with q (a ragged prompt of 300 tokens
//     is one chunk of 300).
//   * ssd_state_kernel: one block of 4 warps per (128 rows of n, 64
//     columns of p, head, sequence x chunk), two blocks an SM, a second
//     grid over all of s: B^T (w * x), each warp 32 rows x 64 columns,
//     the weights w = exp(cum_last - cum_s) * dt_s applied to x as its
//     fragments are built.
//   * Loads: every tile arrives by cp.async (16 bytes where the rows allow
//     it, else 4), one unit ahead in the y kernel's ring (a C and B chunk,
//     or the G heads' x tiles) and one s tile ahead in the state kernel,
//     zero-filled past q, n, p and h.
// Masking is inside the exponent, before exp, as the TPU kernel does:
// exp of a non-causal (large positive) difference would be inf.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

using namespace ssd_tc;  // T = 64: the tile edge (l rows, s rows, p columns)

constexpr int NC = 128;        // chunk of n per C.B^T unit
constexpr int G = 4;           // heads per y block: two warps each
constexpr int SLOTS = 2;       // y kernel: units in flight
constexpr int THREADS = 256;   // y kernel: 8 warps
constexpr int LDN = NC + 4;    // C / B chunk row stride: fragments hit 32 banks
constexpr int LDP = T + 8;     // x tile row stride
constexpr int LDS = T + 4;     // C.B^T tile row stride
constexpr int NT = 128;        // state kernel: rows of n a block
constexpr int LDB = NT + 8;    // its B tile row stride
constexpr int S_THREADS = 128; // its 4 warps, 32 rows of n each
constexpr float NEG = -1e30f;
static_assert(THREADS / 32 == 2 * G, "two warps a head in the y kernel");

// y kernel shared memory (floats): a slot holds a C and a B chunk, or the
// G heads' x tiles, each with the s tile's cum and dt; then the C.B^T tile
constexpr int XH = T * LDP + 2 * T;  // one head's x tile, cum and dt
constexpr int SLOT = 2 * T * LDN > G * XH ? 2 * T * LDN : G * XH;
constexpr int Y_SMEM = (SLOTS * SLOT + T * LDS) * 4;
// state kernel: two slots of (B tile, x tile, cum, dt)
constexpr int S_SLOT = T * LDB + T * LDP + 2 * T;
constexpr int S_SMEM = 2 * S_SLOT * 4;

// y[b, c, l, h, p] for one (l tile x p tile, head group, b * nc + c).
__global__ void __launch_bounds__(THREADS, 1)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cum, const float* __restrict__ B,
             const float* __restrict__ C, float* __restrict__ y, int q, int h, int p, int n,
             int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem + SLOTS * SLOT;  // C.B^T tile [l][s]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l_tiles = (q + T - 1) / T;
  const int lt = l_tiles - 1 - static_cast<int>(blockIdx.x) / p_tiles;  // long rows first
  const int l0 = lt * T, p0 = (blockIdx.x % p_tiles) * T;
  const int head0 = blockIdx.y * G;
  const int64_t bc = blockIdx.z;
  const float* xb = x + bc * q * h * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float* Cb = C + bc * q * n;
  const bool vec_n = n % 4 == 0, vec_p = p % 4 == 0;

  const int n_chunks = (n + NC - 1) / NC;
  const int per_tile = n_chunks + 1;       // units of one s tile
  const int units = (lt + 1) * per_tile;   // causal s tiles 0..lt

  // unit u: (a 128-wide chunk of n of C and B) or (the G heads' x tiles
  // and decays)
  auto issue = [&](int u) {
    if (u < units) {
      float* slot = smem + (u % SLOTS) * SLOT;
      const int s0 = (u / per_tile) * T, r = u % per_tile;
      if (r < n_chunks) {
        load_tile<NC, THREADS>(slot, LDN, Cb, n, l0, q, r * NC, n, vec_n, tid);
        load_tile<NC, THREADS>(slot + T * LDN, LDN, Bb, n, s0, q, r * NC, n, vec_n, tid);
      } else {
        for (int hh = 0; hh < G; ++hh) {
          const int head = head0 + hh;
          const bool ok = head < h;
          float* dst = slot + hh * XH;
          load_tile<T, THREADS>(dst, LDP, xb + (ok ? head : 0) * p,
                                static_cast<int64_t>(h) * p, s0, ok ? q : 0, p0, p, vec_p,
                                tid);
          load_decay(dst + T * LDP, cumb, dtb, s0, q, h, head, ok, tid);
        }
      }
    }
    cp_async_commit();
  };

  // C.B^T: this warp's 16 x 32 patch (rows rw + g, + 8)
  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  // scores @ x: this warp's head and 32 x 64 patch (rows rh + 16 m + g, + 8)
  const int hh = warp / 2, rh = 32 * (warp % 2);
  const int head = head0 + hh;
  const bool live = head < h;
  float cum_l[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + rh + 16 * m + 8 * r + g;
      cum_l[m][r] = live && l < q ? cumb[static_cast<int64_t>(l) * h + head] : 0.f;
    }
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int u = 0; u < SLOTS - 1; ++u) issue(u);
  int u = 0;
  for (int st = 0; st <= lt; ++st, ++u) {
    const int s0 = st * T;
    float cb[4][4] = {};
    for (int ch = 0; ch < n_chunks; ++ch, ++u) {
      issue(u + SLOTS - 1);
      cp_async_wait<SLOTS - 1>();
      __syncthreads();
      const float* cs = smem + (u % SLOTS) * SLOT;
      const float* bs = cs + T * LDN;
      // unrolled this far and the scores loop not at all, the kernel
      // keeps to 255 registers with no spills
#pragma unroll 2
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
      if (ch == n_chunks - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cw + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(cbs + (rw + g) * LDS + c) = make_float2(cb[j][0], cb[j][1]);
          *reinterpret_cast<float2*>(cbs + (rw + g + 8) * LDS + c) =
              make_float2(cb[j][2], cb[j][3]);
        }
      }
      __syncthreads();
    }
    issue(u + SLOTS - 1);
    cp_async_wait<SLOTS - 1>();
    __syncthreads();
    if (live) {
      const float* xs = smem + (u % SLOTS) * SLOT + hh * XH;
      const float* cum_s = xs + T * LDP;
      const float* dt_s = cum_s + T;
#pragma unroll 1
      for (int k = 0; k < T; k += 8) {
        // scores as the A fragments of the two 16-row blocks
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rh + 16 * m + g + 8 * (e & 1), c = k + t + 4 * (e >> 1);
            const int l = l0 + r, s = s0 + c;
            const float seg = (l >= s && l < q && s < q) ? cum_l[m][e & 1] - cum_s[c] : NEG;
            split(cbs[r * LDS + c] * expf(seg) * dt_s[c], ahi[m][e], alo[m][e]);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bhi[2], blo[2];
          const float* xr = xs + (k + t) * LDP + 8 * j + g;
          split(xr[0], bhi[0], blo[0]);
          split(xr[4 * LDP], bhi[1], blo[1]);
          mma3(acc[0][j], ahi[0], alo[0], bhi, blo);
          mma3(acc[1][j], ahi[1], alo[1], bhi, blo);
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
  float* yb = y + bc * q * h * p;
  const bool pairs = p % 2 == 0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = l0 + rh + 16 * m + 8 * r + g;
        if (l >= q || col >= p) continue;
        float* dst = yb + (static_cast<int64_t>(l) * h + head) * p + col;
        if (col + 1 < p && pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[m][j][2 * r], acc[m][j][2 * r + 1]);
        } else {
          dst[0] = acc[m][j][2 * r];
          if (col + 1 < p) dst[1] = acc[m][j][2 * r + 1];
        }
      }
    }
}

// states[b, c, h, n, p] for one (n tile x p tile, head, b * nc + c).
__global__ void __launch_bounds__(S_THREADS, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ B,
                 float* __restrict__ states, int q, int h, int p, int n, int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = (blockIdx.x / p_tiles) * NT;
  const int p0 = (blockIdx.x % p_tiles) * T;
  const int head = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const float* xb = x + bc * q * h * p + head * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float cum_last = cumb[static_cast<int64_t>(q - 1) * h + head];
  const bool vec_n = n % 4 == 0, vec_p = p % 4 == 0;
  const int s_tiles = (q + T - 1) / T;

  auto issue = [&](int st) {
    if (st < s_tiles) {
      float* slot = smem + (st % 2) * S_SLOT;
      load_tile<NT, S_THREADS>(slot, LDB, Bb, n, st * T, q, n0, n, vec_n, tid);
      load_tile<T, S_THREADS>(slot + T * LDB, LDP, xb, static_cast<int64_t>(h) * p, st * T, q,
                              p0, p, vec_p, tid);
      load_decay(slot + T * LDB + T * LDP, cumb, dtb, st * T, q, h, head, true, tid);
    }
    cp_async_commit();
  };

  const int nw = 32 * warp;  // this warp's rows of n: nw + 16 m + g, + 8
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  issue(0);
  for (int st = 0; st < s_tiles; ++st) {
    issue(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* bs = smem + (st % 2) * S_SLOT;
    const float* xs = bs + T * LDB;
    const float* cum_s = xs + T * LDP;
    const float* dt_s = cum_s + T;
#pragma unroll 2
    for (int k = 0; k < T; k += 8) {
      // A = B^T: rows n, columns s, for the two 16-row blocks
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(bs[(k + t + 4 * (e >> 1)) * LDB + nw + 16 * m + g + 8 * (e & 1)], ahi[m][e],
                alo[m][e]);
      // padded s rows carry dt = 0 and x = 0
      const float w0 = expf(cum_last - cum_s[k + t]) * dt_s[k + t];
      const float w1 = expf(cum_last - cum_s[k + t + 4]) * dt_s[k + t + 4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bhi[2], blo[2];
        const float* xr = xs + (k + t) * LDP + 8 * j + g;
        split(xr[0] * w0, bhi[0], blo[0]);
        split(xr[4 * LDP] * w1, bhi[1], blo[1]);
        mma3(acc[0][j], ahi[0], alo[0], bhi, blo);
        mma3(acc[1][j], ahi[1], alo[1], bhi, blo);
      }
    }
    __syncthreads();
  }

  float* sb = states + (bc * h + head) * static_cast<int64_t>(n) * p;
  const bool pairs = p % 2 == 0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int nn = n0 + nw + 16 * m + g + 8 * r;
        if (nn >= n || col >= p) continue;
        float* dst = sb + static_cast<int64_t>(nn) * p + col;
        if (col + 1 < p && pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[m][j][2 * r], acc[m][j][2 * r + 1]);
        } else {
          dst[0] = acc[m][j][2 * r];
          if (col + 1 < p) dst[1] = acc[m][j][2 * r + 1];
        }
      }
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// x (BC, q, h, p), dt/cum (BC, q, h), B/C (BC, q, n) fp32 contiguous and
// 16-byte aligned, with BC = batch * chunks; writes y (BC, q, h, p) and
// states (BC, h, n, p).  Launches both grids on `stream`.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int ssd_intra_chunk_launch(const float* x, const float* dt, const float* cum,
                                      const float* B, const float* C, float* y, float* states,
                                      int bc, int q, int h, int p, int n, void* stream) {
  if (bc <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || h > 65535 || bc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Y_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int p_tiles = cdiv(p, T);
  ssd_y_kernel<<<dim3(cdiv(q, T) * p_tiles, cdiv(h, G), bc), THREADS, Y_SMEM, st>>>(
      x, dt, cum, B, C, y, q, h, p, n, p_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3(cdiv(n, NT) * p_tiles, h, bc), S_THREADS, S_SMEM, st>>>(
      x, dt, cum, B, states, q, h, p, n, p_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the y and state kernels (bytes).
extern "C" int ssd_smem_bytes(int which) { return which == 0 ? Y_SMEM : S_SMEM; }

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
