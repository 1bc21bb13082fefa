// NVDLA post-processing (SDP + PDP) for Hopper (sm_90a): one fused pass of
// per-channel scale and bias, activation and max-pool over an NHWC map.
//
// Replaces: src/repro/kernels/postproc/kernel.py::postprocess_kernel (body
// _postproc_kernel), the Pallas TPU kernel.  out[n, oh, ow, c] =
// max over the pool x pool window of act(x * scale[c] + bias[c]).
//
// What bounds it on the H100: bytes.  It does a few operations per element
// read, far below the ~300 operations per byte at which the card stops
// being memory-bound, so the design is about keeping enough bytes in
// flight to cover HBM latency and touching each byte once.
//
// Design: a persistent grid (two blocks an SM) walks *items*: the `pool`
// input rows of one output row (a band) over a span of W and all C.  Each
// of those rows is one contiguous run of bytes, so one thread of the block
// issues a cp.async.bulk per row into a ring of shared-memory stages, each
// completing on its own mbarrier, and keeps up to four items in flight.
// The other threads are consumers: each reads 16-byte vectors (4 fp32 or 8
// bf16 channels) of the stage, applies scale, bias and the activation in
// fp32 with __fmul_rn / __fadd_rn (the reference's order and rounding;
// the order matters when a scale is negative), takes the max over the
// window and writes its pooled vector in one 8- to 32-byte store.  Scale
// and bias are read once a block into registers, while the first rows
// land.  The consumer loop is built for each activation and for the main
// path's pool of 2 and picked once an item, so no element pays for the
// choice; the block synchronises only before a stage is refilled.  Index
// math is 32-bit and done once per item; only a band's base offset is
// 64-bit.
//
// The launch plan (make_plan, mirrored by kernels/postproc/kernel.py::
// launch_plan and tested there on the CPU) picks the span so that every
// run starts 16-byte aligned and is a multiple of 16 bytes, as
// cp.async.bulk needs: a span's bytes per row are a multiple of 16, and
// the last span of a band runs to the end of the row, over the ragged
// columns that no window keeps.  What the ring cannot take runs in the
// same kernel shape with scalar accesses: channels that are not a multiple
// of the vector width read the ring one channel at a time, and rows whose
// byte length is not a multiple of 16 (or items too large for the ring)
// are read straight from global memory.  Only the floor(H/pool) x
// floor(W/pool) kept outputs are computed: the reference's -3e38 padding
// never reaches one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_STAGES = 4;
constexpr int STAGE_TARGET = 16 * 1024;  // bytes of a ring stage the plan aims at
constexpr int SMEM_BUDGET = 110 * 1024;  // dynamic shared memory of a block, two an SM
constexpr int BAR_BYTES = 128;           // the stages' mbarriers, ahead of the stages

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

// The launch plan: kernel.py's Plan, field for field.
struct Plan {
  int bulk;    // 1: rows arrive by cp.async.bulk into the ring; 0: direct loads
  int vec;     // channels a consumer access covers: 16 bytes' worth, or 1
  int span;    // output columns of an item
  int spans;   // items of a band
  int items;   // N * Ho * spans
  int run;     // bytes of the longest row run: the ring's row pitch
  int stage;   // bytes of a ring stage: pool runs, rounded up to 128
  int stages;  // ring depth (0 on the direct path)
  int grid;    // blocks
  int smem;    // dynamic shared memory bytes
};

constexpr int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
constexpr int64_t round_up(int64_t a, int64_t b) { return ceil_div(a, b) * b; }

Plan make_plan(int N, int H, int W, int C, int pool, int elt, int sms) {
  Plan p{};
  const int Ho = H / pool, Wo = W / pool;
  if ((int64_t)N * Ho * Wo * C == 0) return p;
  const int64_t px = (int64_t)C * elt;  // bytes of a pixel
  const int64_t col = pool * px;        // bytes of an output column in one row
  const int64_t g = 16 / std::gcd<int64_t>(16, col);
  const int64_t per = std::max<int64_t>(1, STAGE_TARGET / (pool * col));
  int64_t span = std::max(g, per / g * g);
  int64_t spans = ceil_div(Wo, span);
  span = round_up(ceil_div(Wo, spans), g);
  spans = ceil_div(Wo, span);
  const int64_t last = W - (spans - 1) * span * pool;  // the last span runs to the row's end
  const int64_t run = std::max(last, spans > 1 ? span * pool : 0) * px;
  const int64_t stage = round_up(pool * run, 128);
  p.bulk = (W * px) % 16 == 0 && BAR_BYTES + 2 * stage <= SMEM_BUDGET;
  p.vec = p.bulk && px % 16 == 0 ? 16 / elt : 1;
  p.span = (int)span;
  p.spans = (int)spans;
  p.items = (int)std::min<int64_t>((int64_t)N * Ho * spans, INT32_MAX);
  p.run = (int)std::min<int64_t>(run, INT32_MAX);
  p.stage = (int)std::min<int64_t>(stage, INT32_MAX);
  p.stages = p.bulk ? (int)std::min<int64_t>(MAX_STAGES, (SMEM_BUDGET - BAR_BYTES) / stage) : 0;
  p.grid = std::min(p.items, BLOCKS_PER_SM * sms);
  p.smem = p.bulk ? BAR_BYTES + p.stages * p.stage : 0;
  return p;
}

struct Args {
  int H, W, C, Ho, Wo, pool, act;
  int span, spans, items, run, stages;
};

// One item: output row `band` (= n * Ho + oh), output columns [ow0, ow0 +
// cnt), fed by input columns [col0, col0 + cols) of its pool rows.
struct Item {
  int band, ow0, cnt, col0, cols;
};

__device__ __forceinline__ Item item_at(int i, const Args& a) {
  Item it;
  it.band = i / a.spans;
  const int j = i - it.band * a.spans;
  it.ow0 = j * a.span;
  it.cnt = min(a.span, a.Wo - it.ow0);
  it.col0 = it.ow0 * a.pool;
  it.cols = j == a.spans - 1 ? a.W - it.col0 : a.span * a.pool;
  return it;
}

// The item's first input row: 64-bit once per item.
__device__ __forceinline__ int64_t row_offset(const Item& it, const Args& a) {
  const int n = it.band / a.Ho, oh = it.band - n * a.Ho;
  return ((int64_t)n * a.H + (int64_t)oh * a.pool) * a.W * a.C + (int64_t)it.col0 * a.C;
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) return fmaxf(v, 0.0f);
  else if constexpr (ACT == kSigmoid) return 1.0f / (1.0f + expf(-v));
  else if constexpr (ACT == kTanh) return tanhf(v);
  else return v;
}

// V channels at p (16-byte aligned where V > 1) as fp32.
template <int V>
__device__ __forceinline__ void load_in(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    static_assert(V == 1, "fp32 vectors are 4 channels");
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_in(float (&v)[V], const __nv_bfloat16* p) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  } else {
    static_assert(V == 1, "bf16 vectors are 8 channels");
    v[0] = __bfloat162float(*p);
  }
}

// V outputs at p in one store (two 16-byte stores for 8 fp32 outputs).
template <int V>
__device__ __forceinline__ void store_out(float* p, const float (&m)[V]) {
  if constexpr (V == 1) {
    *p = m[0];
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
  }
}
template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&m)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(m[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(m[2 * k], m[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 4) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Which channel groups (of V) and output columns of an item this thread
// takes, fixed for the block: groups cg0, cg0 + cstep, ... and columns r0,
// r0 + rstep, ...  With fewer groups than threads each thread keeps one
// group (so its scale and bias stay in registers) and the threads that do
// not fit a whole column stride idle.
struct Lanes {
  int cg0, cstep, r0, rstep;
};

__device__ __forceinline__ Lanes lanes(int groups) {
  const int t = threadIdx.x;
  if (groups >= THREADS) return {t, THREADS, 0, 1};
  const int rstep = THREADS / groups;
  const int r0 = t / groups;
  return {t - r0 * groups, groups, r0 < rstep ? r0 : INT32_MAX, rstep};
}

// The scale and bias of channel group cg into registers.
template <int V>
__device__ __forceinline__ void load_params(float (&s)[V], float (&b)[V], const float* scale,
                                            const float* bias, int cg) {
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = __ldg(scale + cg * V + k), b[k] = __ldg(bias + cg * V + k);
}

// Pool one item with the activation ACT and, where POOL > 0, that pool
// size as constants.  src: the item's first input pixel of its first row,
// rows `pitch` elements apart (the ring stage's or the map's); dst: its
// first output.  s/b hold the scale and bias of channel group `loaded`.
template <int V, int ACT, int POOL, typename InT, typename OutT>
__device__ __forceinline__ void pool_cols(const InT* src, uint32_t pitch,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias, OutT* dst, int cnt,
                                          const Args& a, const Lanes& ln, int& loaded,
                                          float (&s)[V], float (&b)[V]) {
  const int pool = POOL > 0 ? POOL : a.pool;
  const int groups = a.C / V;
  const uint32_t colstep = (uint32_t)pool * a.C;
  for (int cg = ln.cg0; cg < groups; cg += ln.cstep) {
    if (cg != loaded) load_params(s, b, scale, bias, cg), loaded = cg;
    for (int ow = ln.r0; ow < cnt; ow += ln.rstep) {
      const InT* p0 = src + ow * colstep + cg * V;
      float m[V];
#pragma unroll
      for (int i = 0; i < pool; ++i) {
#pragma unroll
        for (int j = 0; j < pool; ++j) {
          float v[V];
          load_in<V>(v, p0 + i * pitch + j * a.C);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float y = activate<ACT>(__fadd_rn(__fmul_rn(v[k], s[k]), b[k]));
            m[k] = (i | j) ? fmaxf(m[k], y) : y;
          }
        }
      }
      store_out<V>(dst + (uint32_t)ow * a.C + cg * V, m);
    }
  }
}

template <int V, int ACT, typename InT, typename OutT>
__device__ __forceinline__ void pool_act(const InT* src, uint32_t pitch, const float* scale,
                                         const float* bias, OutT* dst, int cnt, const Args& a,
                                         const Lanes& ln, int& loaded, float (&s)[V],
                                         float (&b)[V]) {
  if (a.pool == 2)
    pool_cols<V, ACT, 2>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
  else
    pool_cols<V, ACT, 0>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
}

// Pool one item: one uniform branch an item picks the loop built for this
// activation (and for the main path's pool of 2), so no element pays for
// the choice.
template <int V, typename InT, typename OutT>
__device__ __forceinline__ void pool_item(const InT* src, uint32_t pitch, const float* scale,
                                          const float* bias, OutT* dst, int cnt, const Args& a,
                                          const Lanes& ln, int& loaded, float (&s)[V],
                                          float (&b)[V]) {
  switch (a.act) {
    case kRelu: return pool_act<V, kRelu>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
    case kSigmoid:
      return pool_act<V, kSigmoid>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
    case kTanh: return pool_act<V, kTanh>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
    default: return pool_act<V, kNone>(src, pitch, scale, bias, dst, cnt, a, ln, loaded, s, b);
  }
}

// Issue the bulk copies of item i (the pool row runs) into a ring stage.
template <typename InT>
__device__ __forceinline__ void issue(const InT* x, int i, uint32_t stage, uint32_t bar,
                                      const Args& a) {
  const Item it = item_at(i, a);
  const uint32_t bytes = (uint32_t)it.cols * a.C * sizeof(InT);
  hopper::mbar_expect_tx(bar, bytes * a.pool);
  const InT* row = x + row_offset(it, a);
  for (int r = 0; r < a.pool; ++r)
    hopper::bulk_load(stage + r * a.run, row + (int64_t)r * a.W * a.C, bytes, bar);
}

// The ring path: one thread keeps up to `stages` items' rows in flight by
// cp.async.bulk; all threads pool each stage once it has landed.
template <int V, typename InT, typename OutT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    postproc_ring_kernel(const InT* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ bias, OutT* __restrict__ out, const Args a,
                         const int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = hopper::smem_u32(smem);
  const uint32_t ring = bars + BAR_BYTES;
  // this block's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int mine = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < mine && k < a.stages; ++k)
      issue(x, blockIdx.x + k * gridDim.x, ring + k * stage_bytes, bars + 8 * k, a);
  // this thread's first scale and bias, loaded while the first rows land
  const Lanes ln = lanes(a.C / V);
  float s[V], b[V];
  load_params(s, b, scale, bias, ln.cg0);
  int loaded = ln.cg0;
  int st = 0;           // the ring stage of item k, and its mbarrier phase
  uint32_t phase = 0;
  for (int k = 0, i = blockIdx.x; k < mine; ++k, i += gridDim.x) {
    hopper::mbar_wait(bars + 8 * st, phase);
    const Item it = item_at(i, a);
    const auto* src = reinterpret_cast<const InT*>(smem + BAR_BYTES + st * stage_bytes);
    pool_item<V>(src, a.run / (uint32_t)sizeof(InT), scale, bias,
                 out + ((int64_t)it.band * a.Wo + it.ow0) * a.C, it.cnt, a, ln, loaded, s, b);
    if (k + a.stages < mine) {  // refill the stage once every consumer is done with it
      __syncthreads();
      if (threadIdx.x == 0)
        issue(x, i + a.stages * gridDim.x, ring + st * stage_bytes, bars + 8 * st, a);
    }
    if (++st == a.stages) st = 0, phase ^= 1;
  }
}

// The direct path: the same items, read from global memory one channel at
// a time (rows whose runs cp.async.bulk cannot take).
template <typename InT, typename OutT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    postproc_direct_kernel(const InT* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, OutT* __restrict__ out, const Args a) {
  const Lanes ln = lanes(a.C);
  float s[1], b[1];
  load_params(s, b, scale, bias, ln.cg0);
  int loaded = ln.cg0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
    const Item it = item_at(i, a);
    pool_item<1>(x + row_offset(it, a), (uint32_t)a.W * a.C, scale, bias,
                 out + ((int64_t)it.band * a.Wo + it.ow0) * a.C, it.cnt, a, ln, loaded, s, b);
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory (above 48 KB) on
// device `dev`, once a process for each kernel, device and larger size.
template <auto Kernel>
cudaError_t allow_smem(int dev, int bytes) {
  constexpr int DEVICES = 64;
  static int allowed[DEVICES] = {};
  if (bytes <= 48 * 1024 || (dev < DEVICES && bytes <= allowed[dev])) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < DEVICES) allowed[dev] = bytes;
  return err;
}

template <int V, typename InT, typename OutT>
cudaError_t launch_ring(const InT* x, const float* scale, const float* bias, OutT* out,
                        const Args& a, const Plan& p, int dev, cudaStream_t stream) {
  const cudaError_t err = allow_smem<&postproc_ring_kernel<V, InT, OutT>>(dev, p.smem);
  if (err != cudaSuccess) return err;
  postproc_ring_kernel<V, InT, OutT>
      <<<p.grid, THREADS, p.smem, stream>>>(x, scale, bias, out, a, p.stage);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch(const void* xv, const float* scale, const float* bias, void* outv, int N,
                   int H, int W, int C, int act, int pool, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(N, H, W, C, pool, sizeof(InT), sms);
  if (p.items == 0) return cudaSuccess;
  // in-band offsets are 32-bit; so are item indices
  if ((int64_t)pool * W * C > INT32_MAX || (int64_t)N * (H / pool) * p.spans > INT32_MAX)
    return cudaErrorInvalidValue;
  const auto* x = static_cast<const InT*>(xv);
  auto* out = static_cast<OutT*>(outv);
  const Args a{H, W, C, H / pool, W / pool, pool, act, p.span, p.spans, p.items, p.run, p.stages};
  constexpr int V = 16 / sizeof(InT);
  if (!p.bulk) {
    postproc_direct_kernel<InT, OutT><<<p.grid, THREADS, 0, stream>>>(x, scale, bias, out, a);
    return cudaGetLastError();
  }
  // cp.async.bulk and the vector accesses need 16-byte aligned bases
  if (reinterpret_cast<uintptr_t>(xv) % 16 || reinterpret_cast<uintptr_t>(outv) % 16)
    return cudaErrorMisalignedAddress;
  return p.vec == V ? launch_ring<V>(x, scale, bias, out, a, p, dev, stream)
                    : launch_ring<1>(x, scale, bias, out, a, p, dev, stream);
}

}  // namespace

// x (N, H, W, C) fp32 or bf16, scale/bias (C,) fp32, out (N, H/pool, W/pool,
// C) fp32 or bf16; all contiguous, x and out 16-byte aligned where the
// plan takes the ring path.  act: 0 none, 1 relu, 2 sigmoid, 3 tanh.
// Returns the CUDA error of the launch (0 on success).
extern "C" int postproc_launch(const void* x, int in_bf16, const void* scale, const void* bias,
                               void* out, int out_bf16, int N, int H, int W, int C, int act,
                               int pool, void* stream) {
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (pool < 1 || act < kNone || act > kTanh) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, s, b, out, N, H, W, C, act, pool, st)
                   : launch<__nv_bfloat16, float>(x, s, b, out, N, H, W, C, act, pool, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, s, b, out, N, H, W, C, act, pool, st)
                   : launch<float, float>(x, s, b, out, N, H, W, C, act, pool, st);
  }
  return static_cast<int>(err);
}

// The plan postproc_launch takes for these sizes on `sms` SMs, as 10 ints
// in Plan's field order (kernel.py holds its own copy to this).
extern "C" void postproc_plan(int N, int H, int W, int C, int pool, int in_bytes, int sms,
                              int* fields) {
  const Plan p = make_plan(N, H, W, C, pool, in_bytes, sms);
  const int v[10] = {p.bulk, p.vec,   p.span,   p.spans, p.items,
                     p.run,  p.stage, p.stages, p.grid,  p.smem};
  for (int i = 0; i < 10; ++i) fields[i] = v[i];
}

extern "C" const char* postproc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
