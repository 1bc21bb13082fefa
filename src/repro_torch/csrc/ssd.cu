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
// and outputs: ~51 FLOP per byte, above the ~20 FLOP per byte at which
// fp32 FMA (67 TFLOP/s) rather than HBM (3.35 TB/s) is the limit.  The result must hold 1e-4 against
// the fp32 reference, so the products run in fp32 FMA: TF32 tensor cores
// keep about three digits.
//
// Design.  The TPU kernel holds the whole (q, q) score matrix of a chunk
// in VMEM (256 KiB fp32 at q = 256) and loops over heads.  A Hopper block
// has at most 227 KB of shared memory and the blocks run in parallel, so:
//   * ssd_y_kernel: one block per (64 query rows, 64 columns of p, head,
//     sequence x chunk).  It walks the causal 64-row tiles of s only
//     (tiles above the diagonal are never read), builds C.B^T for the tile
//     from 16-wide slices of n in shared memory, turns it into scores in
//     registers, and accumulates y (64 x 64) in registers, 4 x 4 per
//     thread.  The score tile never leaves the SM.
//   * ssd_state_kernel: one block per (64 rows of n, 64 columns of p, head,
//     sequence x chunk), a second grid over all of s: B^T (w * x) with the
//     weights w = exp(cum_last - cum_s) * dt_s applied as x is staged.
// Masking is inside the exponent, before exp, as the TPU kernel does:
// exp of a non-causal (large positive) difference would be inf.  A chunk
// need not be a multiple of the tile (a 300-token prompt is one chunk of
// 300): rows and columns past q are zero-filled on load and never stored.
// C.B^T is recomputed for each head and p tile (the TPU kernel computes it
// once per chunk); tensor cores, TMA and a warp-specialised pipeline are
// later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;         // tile edge: query rows, s rows, n rows, p columns
constexpr int KN = 16;        // slice of n staged per step of C.B^T
constexpr int PAD = T + 4;    // row stride of the transposed tiles
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr float NEG = -1e30f;

// y[b, c, l, h, p] for one (l tile, p tile, head, b * nc + c).
__global__ void __launch_bounds__(THREADS)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cum, const float* __restrict__ B,
             const float* __restrict__ C, float* __restrict__ y, int q, int h, int p, int n,
             int p_tiles) {
  __shared__ __align__(16) float ct[KN * PAD];  // C^T slice: [k][l]
  __shared__ __align__(16) float bt[KN * PAD];  // B^T slice: [k][s]
  __shared__ __align__(16) float st[T * PAD];   // scores^T: [s][l]
  __shared__ __align__(16) float xs[T * T];     // x tile: [s][p]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int l0 = (blockIdx.x / p_tiles) * T;
  const int p0 = (blockIdx.x % p_tiles) * T;
  const int head = blockIdx.y;
  const int64_t bc = blockIdx.z;

  const float* xb = x + bc * q * h * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float* Cb = C + bc * q * n;

  float cum_l[4];
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    cum_l[i] = l < q ? cumb[(int64_t)l * h + head] : 0.f;
  }
  float acc[4][4] = {};

  const int l_hi = min(l0 + T, q);           // rows of this tile: [l0, l_hi)
  for (int s0 = 0; s0 < l_hi; s0 += T) {     // causal s tiles only
    float cb[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += KN) {
      for (int idx = tid; idx < KN * T; idx += THREADS) {
        const int r = idx / KN, k = idx % KN;
        const int kk = k0 + k;
        const int l = l0 + r, s = s0 + r;
        ct[k * PAD + r] = (l < q && kk < n) ? Cb[(int64_t)l * n + kk] : 0.f;
        bt[k * PAD + r] = (s < q && kk < n) ? Bb[(int64_t)s * n + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&ct[k * PAD + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bt[k * PAD + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(av[i], bv[j], cb[i][j]);
      }
      __syncthreads();
    }
    // scores = C.B^T * exp(masked cum_l - cum_s) * dt_s, stored transposed
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      const float cum_s = s < q ? cumb[(int64_t)s * h + head] : 0.f;
      const float dt_s = s < q ? dtb[(int64_t)s * h + head] : 0.f;
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty * 4 + i;
        const float seg = (l >= s && s < q && l < q) ? cum_l[i] - cum_s : NEG;
        st[(tx * 4 + j) * PAD + ty * 4 + i] = cb[i][j] * expf(seg) * dt_s;
      }
    }
    for (int idx = tid; idx < T * T; idx += THREADS) {
      const int r = idx / T, c = idx % T;
      const int s = s0 + r, col = p0 + c;
      xs[idx] = (s < q && col < p) ? xb[((int64_t)s * h + head) * p + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < T; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&st[s * PAD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[s * T + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* yb = y + bc * q * h * p;
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= q) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx * 4 + j;
      if (col < p) yb[((int64_t)l * h + head) * p + col] = acc[i][j];
    }
  }
}

// states[b, c, h, n, p] for one (n tile, p tile, head, b * nc + c).
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ B,
                 float* __restrict__ states, int q, int h, int p, int n, int p_tiles) {
  __shared__ __align__(16) float bs[T * T];   // B tile: [s][n]
  __shared__ __align__(16) float wx[T * T];   // w * x tile: [s][p]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n0 = (blockIdx.x / p_tiles) * T;
  const int p0 = (blockIdx.x % p_tiles) * T;
  const int head = blockIdx.y;
  const int64_t bc = blockIdx.z;

  const float* xb = x + bc * q * h * p;
  const float* dtb = dt + bc * q * h;
  const float* cumb = cum + bc * q * h;
  const float* Bb = B + bc * q * n;
  const float cum_last = cumb[(int64_t)(q - 1) * h + head];

  float acc[4][4] = {};
  for (int s0 = 0; s0 < q; s0 += T) {
    for (int idx = tid; idx < T * T; idx += THREADS) {
      const int r = idx / T, c = idx % T;
      const int s = s0 + r;
      const int nn = n0 + c, col = p0 + c;
      bs[idx] = (s < q && nn < n) ? Bb[(int64_t)s * n + nn] : 0.f;
      float v = 0.f;
      if (s < q && col < p) {
        const int64_t sh = (int64_t)s * h + head;
        const float w = expf(cum_last - cumb[sh]) * dtb[sh];
        v = xb[sh * p + col] * w;
      }
      wx[idx] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < T; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&bs[s * T + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&wx[s * T + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* sb = states + (bc * h + head) * (int64_t)n * p;
  for (int i = 0; i < 4; ++i) {
    const int nn = n0 + ty * 4 + i;
    if (nn >= n) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx * 4 + j;
      if (col < p) sb[(int64_t)nn * p + col] = acc[i][j];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// x (BC, q, h, p), dt/cum (BC, q, h), B/C (BC, q, n) fp32 contiguous, with
// BC = batch * chunks; writes y (BC, q, h, p) and states (BC, h, n, p).
// Launches both grids on `stream`.  Returns the CUDA error of the launches
// (0 on success).
extern "C" int ssd_intra_chunk_launch(const float* x, const float* dt, const float* cum,
                                      const float* B, const float* C, float* y, float* states,
                                      int bc, int q, int h, int p, int n, void* stream) {
  if (bc <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || h > 65535 || bc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int p_tiles = cdiv(p, T);
  ssd_y_kernel<<<dim3(cdiv(q, T) * p_tiles, h, bc), THREADS, 0, st>>>(x, dt, cum, B, C, y, q,
                                                                       h, p, n, p_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3(cdiv(n, T) * p_tiles, h, bc), THREADS, 0, st>>>(x, dt, cum, B,
                                                                           states, q, h, p, n,
                                                                           p_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
