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
// with an online softmax (m, l in fp32, l clamped at 1e-30), output in the
// input's dtype.  q and o are (B, S, Hq, D), k and v (B, S, Hkv, D); query
// head h reads KV head h / (Hq / Hkv), so GQA is never expanded in memory.
// Two kernels, picked by dtype (the wrapper names the path):
//
// * bf16: swa_tc_kernel, tensor cores (wgmma) fed by TMA.
// * fp32: swa_fma_kernel, fp32 FMA out of shared memory, so that fp32
//   inputs hold the reference to 2e-5 (TF32 or bf16 products would not).
//
// What bounds it on the H100: operations.  recurrentgemma-9b's prefill
// (S = 2560, 16 query heads, one KV head, D = 256, window 2048) needs
// 4 * D FLOP for each in-band (i, j) pair, 51.5 GFLOP, against 44.6 MB of
// q, k, v and o: ~1,150 FLOP per byte, far above the ~295 at which bf16
// tensor cores (989 TFLOP/s) rather than HBM (3.35 TB/s) are the limit.
// The fp32 FMA kernel (67 TFLOP/s) cannot come near that; the bf16 path
// is built for the tensor cores:
//
// * Tensor cores.  S = Q K^T is wgmma m64n64k16 (bf16 in, fp32
//   accumulator) with Q and K read from shared memory, K-major.  O += P V
//   is wgmma m64nDk16 with P in registers, rounded to bf16 as
//   FlashAttention does, and V the shared-memory B operand in its natural
//   (key, d) layout, i.e. MN-major (the transpose bit).  The 64 x D fp32
//   accumulator stays in registers (128 a thread at D 256); scale,
//   softcap, mask and the online softmax run in fp32 on the score
//   fragment, which is then the A fragment of P V without a shuffle.
// * Asynchronous copies.  One producer thread issues TMA loads of the Q
//   tiles and of a 2-stage ring of K and V tiles, completing on mbarriers
//   by transaction count; the consumer warpgroups wait on those and free
//   a stage with an arrive.  setmaxnreg moves registers from the producer
//   warpgroup (40) to the two consumer warpgroups (232).  The TMA swizzle
//   and the wgmma descriptors' swizzle are the same (128 B rows: D is cut
//   into 64-column chunks; 64 B at D 32, 32 B at D 16).  Shared memory at
//   D 256: two Q tiles 64 KB + 2 stages x (K + V) 128 KB = 192 KB.
// * GQA and packing.  A block owns 128 query rows of one (b, h): two
//   64-row blocks, one per consumer warpgroup, that share every K/V tile
//   of the union of their bands in shared memory (the two bands differ by
//   one tile at each end; a warpgroup skips a tile outside its band).
//   This packing works for every Hq / Hkv (packing two heads would need
//   an even group).  Heads are the fastest grid axis, so the 16 query
//   heads of one KV head run side by side and read the same tiles from L2.
// * The band, not the square.  A block walks only the 64-key tiles its
//   band meets; only tiles that cut the band's diagonal or its lower edge
//   pay for the position mask.  Row blocks run last-first, so the long
//   bands start first and the short ones near S = 0 fill the tail.
// * Ragged S.  TMA zero-fills rows past S; keys past S fail the causal
//   test of every stored row, and no row past S is stored.
//
// The fp32 kernel: one block of 256 threads owns 64 query rows of one
// (b, h) and loops over exactly the 64-key tiles that meet its band.  The
// query tile, the key and value tiles and the transposed probabilities
// live in shared memory as fp32 (217 KB at D = 256).  Each thread computes
// a 4 x 4 patch of the score tile (rows ty*4 + i, keys tx + 16 j, so that
// the 8 threads of a shared-memory phase read 8 different bank groups),
// the row max and sum are reduced across the 16 threads of a row with
// shuffles, and the accumulator (64 x D fp32) is held in registers, 4
// rows x D/16 columns per thread.  A fully masked tile (a row whose band
// starts later) adds exp(0) terms that the first in-band tile scales by
// exp(-1e30 - m) = 0, as the TPU kernel's -1e30 fill does.
//
// When the caller passes an lse buffer (training does; serving passes
// null), the bf16 kernel also writes each row's log-sum-exp, (m + log2 l)
// ln 2, fp32 (B, Hq, S): the tensor-core backward (swa_bwd.cu) reads it
// instead of walking the band a second time.  The kernel is built with
// and without that store (template LSE): testing the pointer at run time
// instead cost the serving kernel 3-13% (grok-1's softcap shape most).
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no PyTorch
// headers).  The mbarrier, TMA and wgmma helpers and the tensor-map
// encoder (reached through cudaGetDriverEntryPoint, so nothing links
// libcuda) come from hopper.cuh, shared with convcore.cu; the tile
// layout, the two wgmma products and the tensor maps from attn_tc.cuh,
// shared with swa_bwd.cu.
#include <cuda_bf16.h>
#include <math.h>

#include "attn_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: FMA out of shared memory
// ---------------------------------------------------------------------------
namespace fma {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int LP = BQ + 4;    // row stride of the transposed probabilities
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys / columns
constexpr float NEG = -1e30f;

// rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor -> dst[r][d]
// with row stride D + 4; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int S,
                                          int64_t row_stride, int tid) {
  constexpr int LD = D + 4;
  constexpr int V = D / 4;
  for (int idx = tid; idx < BQ * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = *reinterpret_cast<const float4*>(src + row * row_stride + c);
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

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
swa_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S, int HQ, int HKV,
               int window, float scale, float softcap) {
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
  const float* qb = q + (b * S * HQ + hq) * D;
  const float* kb = k + (b * S * HKV + hk) * D;
  const float* vb = v + (b * S * HKV + hk) * D;

  load_tile<D>(qs, qb, row0, S, qstride, tid);

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
    load_tile<D>(ks, kb, c0, S, kstride, tid);
    load_tile<D>(vs, vb, c0, S, kstride, tid);
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
    float* ob = o + ((b * S + qpos) * HQ + hq) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = jj * 64 + tx * 4;
      if (col < D)
        *reinterpret_cast<float4*>(ob + col) =
            make_float4(acc[i][jj * 4 + 0] / denom, acc[i][jj * 4 + 1] / denom,
                        acc[i][jj * 4 + 2] / denom, acc[i][jj * 4 + 3] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int hq, int hkv,
           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem = static_cast<int>(sizeof(float) * ((BQ + 2 * BK) * LD + BK * LP));
  cudaError_t err = cudaFuncSetAttribute(swa_fma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  swa_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, hq, hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using namespace attn_tc;

constexpr int BM = ROWS;                      // query rows per consumer warpgroup
constexpr int BN = ROWS;                      // keys per tile
constexpr int CONSUMERS = 2;                  // consumer warpgroups: 128 rows a block
constexpr int STAGES = 2;                     // K/V ring
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Shape : Tile<D> {
  // Q tiles, K and V rings, barriers, and 1 KB to align the base to the
  // swizzle atom
  static constexpr int SMEM =
      (CONSUMERS + 2 * STAGES) * Tile<D>::TILE + 8 * (1 + 2 * STAGES) + 1024;
};

// One key tile for one consumer warpgroup: S = Q K^T on the tensor cores,
// scale / softcap / mask and the online softmax in fp32 on the fragment,
// then O = alpha O + P V with P rounded to bf16.  Thread (warp w, lane) owns
// rows qrow = 16 w + lane / 4 and qrow + 8 of the warpgroup's 64, and in
// each 8-column block j the columns 8 j + kc, 8 j + kc + 1; m, l are in the
// log2 domain, l is this thread's partial sum of its columns.
template <int D>
__device__ __forceinline__ void tile_step(float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                          uint32_t qtile, uint32_t ktile, uint32_t vtile,
                                          bool masked, int qrow, int c0, int kc, int window,
                                          float scale, float softcap) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  pin(s);
  wgmma_fence();
  ss_product<D>(s, qtile, ktile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);

  const float capped = softcap * LOG2E, inner = scale / softcap, plain = scale * LOG2E;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      x = softcap > 0.f ? capped * tanhf(x * inner) : x * plain;
      if (masked) {
        // keys past S fail kpos <= qpos for every row below S
        const int kpos = c0 + 8 * j + kc + (e & 1), qpos = qrow + 8 * (e >> 1);
        if (kpos > qpos || qpos - kpos >= window) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float base[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    alpha[r] = exp2f(m[r] - base[r]);
    m[r] = m_new;
  }
  // P as the A fragments of four k16 steps: n-blocks 2 kk and 2 kk + 1
  uint32_t p[4][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2f(s[4 * j + 0] - base[0]), p1 = exp2f(s[4 * j + 1] - base[0]);
    const float p2 = exp2f(s[4 * j + 2] - base[1]), p3 = exp2f(s[4 * j + 3] - base[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    p[j / 2][2 * (j % 2) + 0] = pack_bf16(p0, p1);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  pin(o);
  wgmma_fence();
  rs_product<D>(o, p, vtile);
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int S, int HQ, int HKV, int window, float scale,
              float softcap) {
  using SH = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t qs = (smem_u32(smem) + 1023) & ~1023u;  // [CONSUMERS] Q tiles
  const uint32_t ks = qs + CONSUMERS * SH::TILE;          // [STAGES] K tiles
  const uint32_t vs = ks + STAGES * SH::TILE;             // [STAGES] V tiles
  const uint32_t qbar = vs + STAGES * SH::TILE;           // Q landed
  const uint32_t full = qbar + 8;                         // [STAGES] K, V landed
  const uint32_t empty = full + 8 * STAGES;               // [STAGES] K, V read

  // heads fastest (the query heads of one KV head share its tiles in L2),
  // row blocks last-first (long bands first)
  const int h = blockIdx.x, b = blockIdx.z;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * (CONSUMERS * BM);
  const int hk = h / (HQ / HKV);
  const int t_lo = max(0, row0 - window + 1) / BN;
  const int ntiles = (min(row0 + CONSUMERS * BM, S) - 1) / BN - t_lo + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
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
      const int nq = min(CONSUMERS, (S - row0 + BM - 1) / BM);  // Q tiles with rows below S
      mbar_expect_tx(qbar, nq * SH::TILE);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < SH::CHUNKS; ++c)
          tma_load_4d(qs + w * SH::TILE + c * SH::CHUNK, &qmap, qbar, c * SH::SW, h,
                   row0 + w * BM, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * SH::TILE);
        const int key0 = (t_lo + t) * BN;
        for (int c = 0; c < SH::CHUNKS; ++c) {
          tma_load_4d(ks + st * SH::TILE + c * SH::CHUNK, &kmap, full + 8 * st, c * SH::SW, hk,
                   key0, b);
          tma_load_4d(vs + st * SH::TILE + c * SH::CHUNK, &vmap, full + 8 * st, c * SH::SW, hk,
                   key0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = row0 + wg * BM;                    // this warpgroup's 64 rows
    const int qrow = r0 + (tid / 32) * 16 + lane / 4;  // and qrow + 8
    const int kc = 2 * (lane % 4);
    float acc[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const int c0 = (t_lo + t) * BN;
      mbar_wait(full + 8 * st, (t / STAGES) & 1);
      // rows [r0, r0 + 64) meet keys [c0, c0 + 64) in the band; every
      // pair is in it (no mask) away from the diagonal and the lower edge
      if (r0 < S && c0 <= r0 + BM - 1 && r0 - (c0 + BN - 1) < window) {
        const bool interior = c0 + BN - 1 <= r0 && r0 + BM - 1 - c0 < window;
        tile_step<D>(acc, m, l, qs + wg * SH::TILE, ks + st * SH::TILE, vs + st * SH::TILE,
                     !interior, qrow, c0, kc, window, scale, softcap);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qpos = qrow + 8 * r;
      if (qpos >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      // the row's log-sum-exp (natural log), for the backward kernels
      if (LSE && kc == 0)
        lse[(static_cast<int64_t>(b) * HQ + h) * S + qpos] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
      __nv_bfloat16* dst = o + ((static_cast<int64_t>(b) * S + qpos) * HQ + h) * D + kc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int s, int hq,
           int hkv, int window, float scale, float softcap, cudaStream_t stream) {
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  const int row_blocks = (s + CONSUMERS * BM - 1) / (CONSUMERS * BM);
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!tensor_map<D>(&qm, q, b, s, hq) || !tensor_map<D>(&km, k, b, s, hkv) ||
      !tensor_map<D>(&vm, v, b, s, hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  // the serving kernel carries no lse code at all
  const auto kernel = lse ? swa_tc_kernel<D, true> : swa_tc_kernel<D, false>;
  constexpr int smem = Shape<D>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hq, row_blocks, b), THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, s, hq, hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using TcLaunch = int (*)(const void*, const void*, const void*, void*, float*, int, int, int, int,
                         int, float, float, cudaStream_t);
using FmaLaunch = int (*)(const void*, const void*, const void*, void*, int, int, int, int, int,
                          float, float, cudaStream_t);

TcLaunch tc_launcher(int d) {
  switch (d) {
    case 16: return tc::launch<16>;
    case 32: return tc::launch<32>;
    case 64: return tc::launch<64>;
    case 128: return tc::launch<128>;
    case 256: return tc::launch<256>;
    default: return nullptr;
  }
}

FmaLaunch fma_launcher(int d) {
  switch (d) {
    case 16: return fma::launch<16>;
    case 32: return fma::launch<32>;
    case 64: return fma::launch<64>;
    case 128: return fma::launch<128>;
    case 256: return fma::launch<256>;
    default: return nullptr;
  }
}

bool valid(int b, int s, int hq, int hkv, int window) {
  return b > 0 && s > 0 && hq > 0 && hkv > 0 && hq % hkv == 0 && window >= 1 && b <= 65535;
}

}  // namespace

// q/o (B, S, Hq, D), k/v (B, S, Hkv, D), contiguous, 16-byte aligned, D in
// {16, 32, 64, 128, 256}.  Each launches one grid on `stream` and returns
// its CUDA error (0 on success).  bf16 tensors: the wgmma / TMA kernel,
// which also writes each row's log-sum-exp to `lse`, fp32 (B, Hq, S), when
// it is not null.
extern "C" int swa_tc_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                             int b, int s, int hq, int hkv, int d, int window, float scale,
                             float softcap, void* stream) {
  const TcLaunch fn = tc_launcher(d);
  if (!fn || !valid(b, s, hq, hkv, window)) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, static_cast<float*>(lse), b, s, hq, hkv, window, scale, softcap,
            static_cast<cudaStream_t>(stream));
}

// fp32 tensors: the FMA kernel.
extern "C" int swa_fma_launch(const void* q, const void* k, const void* v, void* o, int b, int s,
                              int hq, int hkv, int d, int window, float scale, float softcap,
                              void* stream) {
  const FmaLaunch fn = fma_launcher(d);
  if (!fn || !valid(b, s, hq, hkv, window) || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, b, s, hq, hkv, window, scale, softcap, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the bf16 kernel at head dim d (bytes), or -1.
extern "C" int swa_tc_smem_bytes(int d) {
  switch (d) {
    case 16: return tc::Shape<16>::SMEM;
    case 32: return tc::Shape<32>::SMEM;
    case 64: return tc::Shape<64>::SMEM;
    case 128: return tc::Shape<128>::SMEM;
    case 256: return tc::Shape<256>::SMEM;
    default: return -1;
  }
}

extern "C" const char* swa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
