// The exact LLC replay engines for Hopper (sm_90a): the per-set round walk
// of one geometry (llc_set_walk) and the segment-lane scan of L geometries
// (llc_lane_scan), each one launch where the plain PyTorch loops issue
// about twenty small ops a round.
//
// Replaces no Pallas kernel.  The reference runs both loops as one
// compiled device program each: llc_set_walk the jitted lax.scan of
// src/repro/core/cache.py::_segment_rounds_grouped, llc_lane_scan the
// lax.scan / fori_loop of src/repro/core/cache.py::segment_lane_scan,
// vmapped over lanes under jax.jit in src/repro/core/sweep.py.  The port's
// plain versions (src/repro_torch/kernels/llc/ref.py) drive the same loops
// from the host, one eager launch an op; these kernels bring the
// reference's structure to the card.  Every output is bit-identical to the
// plain version's: tests/test_torch_llc.py holds a numpy emulation of the
// per-thread walk below (the spec to keep in step with this file) to the
// plain versions on the CPU, and its gpu cases and chip_smoke.py hold the
// kernels to them on the card.
//
// What bounds it on the H100: neither bytes nor operations.  The work is
// a serial, data-dependent walk over a set's arrivals (the next victim
// depends on the last), so the time is the longest set's walk length
// times the latency of one LRU step; the bytes that must move (the
// arrivals, the state, the hit bits) take microseconds at 3.35 TB/s.
//
// Design: one thread per set (per lane and set for the lane scan) keeps
// its set's ways, tags and ages (timestamps), in registers, unrolled over
// a compile-time bound on the way count (2 to 32; 64 and 128 in local
// memory), and walks its arrivals in order.
// Sets are independent under LRU, so threads never communicate except to
// sum a segment's hits (a warp shuffle, then one integer atomicAdd a warp:
// the sums are exact in any order).  Tie-breaks follow the plain
// versions' first-index rule (ways scanned in ascending order, strict
// comparisons), and every int32 sum wraps as torch's int32 does (computed
// in uint32_t); addresses and block numbers stay int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int32_t IMAX = 0x7fffffff;

// segment-table fields, (L, S, kFields) int64 (kernels/llc/kernel.py)
enum Field {
  kBase,      // first byte address of the segment
  kStride,    // bytes between accesses
  kCount,     // accesses (0: a padding segment)
  kBFirst,    // first block
  kNPre,      // blocks retired by the round walk
  kSbFirst,   // first block of the closed-form suffix
  kNSuf,      // blocks of the closed-form suffix
  kCounter,   // accesses of the lane before this segment
  kWsel,      // way-allocation bitmask (0: every real way)
  kFields
};

enum Suffix { kNone = 0, kOne = 1, kFull = 2 };

// A thread's loops over its ways unroll fully up to 32 ways, so the ways
// stay in registers; wider sets (up to 128 ways) keep them in local memory
// and loop.
constexpr int kMaxWays = 128;
template <int W>
struct Unroll {
  static constexpr int value = W <= 32 ? W : 1;
};

// torch's floor division and remainder of int64 operands
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t floormod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// .to(torch.int32) of an int64: the low 32 bits
__device__ __forceinline__ int32_t low32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(x)));
}

// the index, within a segment of accesses base + j * stride, of the last
// access that lands in `block` (utils/address.py::last_access)
__device__ __forceinline__ int64_t last_access(int64_t block, int64_t base, int64_t stride,
                                               int64_t count, int64_t bb) {
  const int64_t lo = block * bb - base;
  const int64_t hi = floordiv(lo + bb - 1, stride);
  return hi < count - 1 ? hi : count - 1;
}

// ---------------------------------------------------------------------------
// llc_set_walk: thread s walks arrivals first[s] .. first[s] + per_set[s] - 1
// of the set-sorted order.  A matching tag wins; otherwise the first way of
// greatest age.  The touched way's age resets to 0, every other way ages by
// the arrival's access count.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(THREADS)
    llc_set_walk_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ age,
                        const int32_t* __restrict__ tag_s, const int32_t* __restrict__ acc_s,
                        const int64_t* __restrict__ per_set, const int64_t* __restrict__ first,
                        bool* __restrict__ hit_s, int sets, int ways) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= sets) return;
  int32_t tg[W], ag[W];
  const int64_t row = static_cast<int64_t>(s) * ways;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    tg[q] = q < ways ? tags[row + q] : 0;
    ag[q] = q < ways ? age[row + q] : 0;
  }
  const int64_t n = per_set[s], f = first[s];
  for (int64_t r = 0; r < n; ++r) {
    const int32_t t = tag_s[f + r];
    const uint32_t a = static_cast<uint32_t>(acc_s[f + r]);
    bool hit = false;
    int way = 0;
    int32_t best = 0;
#pragma unroll (Unroll<W>::value)
    for (int q = 0; q < W; ++q) {
      if (q < ways) {
        const bool match = tg[q] == t;
        hit |= match;
        const int32_t score = match ? IMAX : ag[q];
        if (q == 0 || score > best) {
          best = score;
          way = q;
        }
      }
    }
#pragma unroll (Unroll<W>::value)
    for (int q = 0; q < W; ++q) {
      if (q < ways) {
        if (q == way) {
          tg[q] = t;
          ag[q] = 0;
        } else {
          ag[q] = static_cast<int32_t>(static_cast<uint32_t>(ag[q]) + a);
        }
      }
    }
    hit_s[f + r] = hit;
  }
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    if (q < ways) {
      tags[row + q] = tg[q];
      age[row + q] = ag[q];
    }
  }
}

// ---------------------------------------------------------------------------
// llc_lane_scan: thread (l, s) walks every segment of lane l in order over
// set s of its (max_ways, max_sets) state: rounds[j] rounds of the per-set
// walk, then the closed-form suffix.  State is a global last-touch
// timestamp a way; ways q >= ways_l are padding (their keys are INT32_MAX
// unless a tag matches, as in the plain version) and sets s >= sets_l do
// nothing.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(THREADS)
    llc_lane_scan_kernel(const int64_t* __restrict__ seg, const int32_t* __restrict__ rounds,
                         const int64_t* __restrict__ geo, int32_t* __restrict__ tags,
                         int32_t* __restrict__ ts, unsigned long long* __restrict__ hits,
                         bool* __restrict__ miss, int n_seg, int max_sets, int max_ways,
                         int r_pad, int suffix) {
  const int l = blockIdx.y;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  const int64_t sets = geo[3 * l], ways = geo[3 * l + 1], bb = geo[3 * l + 2];
  const bool in_state = s < max_sets;
  const bool active = in_state && s < sets;
  int32_t tg[W], st[W];
  const int64_t col = static_cast<int64_t>(l) * max_ways * max_sets + s;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    const bool real = in_state && q < max_ways;
    tg[q] = real ? tags[col + static_cast<int64_t>(q) * max_sets] : 0;
    st[q] = real ? ts[col + static_cast<int64_t>(q) * max_sets] : 0;
  }
  for (int j = 0; j < n_seg; ++j) {
    const int64_t* f = seg + (static_cast<int64_t>(l) * n_seg + j) * kFields;
    const int n_rounds = rounds[j];  // one value for the whole grid
    if (n_rounds > 0) {
      int64_t mine = 0;
      if (active) {
        const int64_t base = f[kBase], stride = f[kStride], count = f[kCount];
        const int64_t b_first = f[kBFirst], n_pre = f[kNPre];
        const int64_t counter = f[kCounter], wsel = f[kWsel];
        const int64_t off = floormod(s - b_first, sets);
        for (int k = 0; k < n_rounds; ++k) {
          const int64_t i = off + k * sets;  // block ordinal within the segment
          if (i >= n_pre) continue;
          const int64_t block = b_first + i;
          const int32_t t = low32(floordiv(block, sets));
          const int64_t lo = block * bb - base;
          const int64_t j_lo = lo <= 0 ? 0 : floordiv(lo + stride - 1, stride);
          const int64_t j_hi = last_access(block, base, stride, count, bb);
          // a matching tag wins (key -1), else the oldest way it may
          // allocate into; the first way of least key
          int way = 0;
          int32_t kmin = 0;
#pragma unroll (Unroll<W>::value)
          for (int q = 0; q < W; ++q) {
            if (q < max_ways) {
              const bool alloc = q < ways && (wsel == 0 || ((wsel >> q) & 1));
              const int32_t key = tg[q] == t ? -1 : (alloc ? st[q] : IMAX);
              if (q == 0 || key < kmin) {
                kmin = key;
                way = q;
              }
            }
          }
          const bool hit = kmin == -1;
          const int32_t stamp = low32(counter + j_hi + 1);
#pragma unroll (Unroll<W>::value)
          for (int q = 0; q < W; ++q) {
            if (q == way) {
              tg[q] = t;
              st[q] = stamp;
            }
          }
          mine += j_hi - j_lo + hit;
          if (miss != nullptr && !hit) {
            miss[((static_cast<int64_t>(l) * n_seg + j) * r_pad + k) * max_sets + s] = true;
          }
        }
      }
      // the segment's round hits: a warp's sum, then one exact atomic
      unsigned long long sum = static_cast<unsigned long long>(mine);
#pragma unroll (Unroll<W>::value)
      for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
      if ((threadIdx.x & 31) == 0 && sum != 0) {
        atomicAdd(hits + static_cast<int64_t>(l) * n_seg + j, sum);
      }
    }
    const int64_t n_suf = f[kNSuf];
    if (!active || suffix == kNone || n_suf <= 0) continue;
    // closed-form suffix: every suffix block misses; victims cycle through
    // the real ways oldest-first
    const int64_t base = f[kBase], stride = f[kStride], count = f[kCount];
    const int64_t sb_first = f[kSbFirst], counter = f[kCounter];
    const int64_t off_suf = floormod(s - sb_first, sets);
    int32_t vt[W];
#pragma unroll (Unroll<W>::value)
    for (int q = 0; q < W; ++q) vt[q] = q < ways ? st[q] : IMAX;
    if (suffix == kOne) {
      // at most one suffix block a set: it evicts the first oldest way
      if (off_suf >= n_suf) continue;
      int way = 0;
      int32_t vmin = 0;
#pragma unroll (Unroll<W>::value)
      for (int q = 0; q < W; ++q) {
        if (q < max_ways && (q == 0 || vt[q] < vmin)) {
          vmin = vt[q];
          way = q;
        }
      }
      const int64_t blk = sb_first + off_suf;
      const int32_t t1 = low32(floordiv(blk, sets));
      const int32_t ts1 = low32(counter + last_access(blk, base, stride, count, bb) + 1);
#pragma unroll (Unroll<W>::value)
      for (int q = 0; q < W; ++q) {
        if (q == way) {
          tg[q] = t1;
          st[q] = ts1;
        }
      }
      continue;
    }
    // the general insert: the set's m suffix blocks land on the ways in
    // oldest-first rank order (ties broken on way index), the last `ways`
    // of them staying
    const int64_t m = off_suf < n_suf ? floordiv(n_suf - off_suf + sets - 1, sets) : 0;
#pragma unroll (Unroll<W>::value)
    for (int a = 0; a < W; ++a) {
      if (a >= max_ways || a >= ways) continue;
      int64_t rank = 0;
#pragma unroll (Unroll<W>::value)
      for (int b = 0; b < W; ++b) {
        if (b < max_ways) rank += (vt[b] < vt[a]) || (vt[b] == vt[a] && b < a);
      }
      const int64_t jstar = m - floormod(m - 1 - rank, ways);
      if (jstar < 1) continue;
      const int64_t blk = sb_first + off_suf + (jstar - 1) * sets;
      tg[a] = low32(floordiv(blk, sets));
      st[a] = low32(counter + last_access(blk, base, stride, count, bb) + 1);
    }
  }
  if (!in_state) return;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    if (q < max_ways) {
      tags[col + static_cast<int64_t>(q) * max_sets] = tg[q];
      ts[col + static_cast<int64_t>(q) * max_sets] = st[q];
    }
  }
}

template <int W>
cudaError_t set_walk(int32_t* tags, int32_t* age, const int32_t* tag_s, const int32_t* acc_s,
                     const int64_t* per_set, const int64_t* first, bool* hit_s, int sets,
                     int ways, cudaStream_t stream) {
  const dim3 grid((sets + THREADS - 1) / THREADS);
  llc_set_walk_kernel<W>
      <<<grid, THREADS, 0, stream>>>(tags, age, tag_s, acc_s, per_set, first, hit_s, sets, ways);
  return cudaGetLastError();
}

template <int W>
cudaError_t lane_scan(const int64_t* seg, const int32_t* rounds, const int64_t* geo,
                      int32_t* tags, int32_t* ts, unsigned long long* hits, bool* miss,
                      int lanes, int n_seg, int max_sets, int max_ways, int r_pad, int suffix,
                      cudaStream_t stream) {
  const dim3 grid((max_sets + THREADS - 1) / THREADS, lanes);
  llc_lane_scan_kernel<W><<<grid, THREADS, 0, stream>>>(
      seg, rounds, geo, tags, ts, hits, miss, n_seg, max_sets, max_ways, r_pad, suffix);
  return cudaGetLastError();
}

}  // namespace

// The largest way count the kernels take (kernels/llc/kernel.py::MAX_WAYS).
extern "C" int llc_max_ways() { return kMaxWays; }

extern "C" int llc_set_walk_launch(void* tags, void* age, const void* tag_s, const void* acc_s,
                                   const void* per_set, const void* first, void* hit_s,
                                   int sets, int ways, void* stream) {
  if (sets < 1 || ways < 1 || ways > kMaxWays) return static_cast<int>(cudaErrorInvalidValue);
  auto* tg = static_cast<int32_t*>(tags);
  auto* ag = static_cast<int32_t*>(age);
  const auto* t = static_cast<const int32_t*>(tag_s);
  const auto* a = static_cast<const int32_t*>(acc_s);
  const auto* n = static_cast<const int64_t*>(per_set);
  const auto* f = static_cast<const int64_t*>(first);
  auto* h = static_cast<bool*>(hit_s);
  auto st = static_cast<cudaStream_t>(stream);
  if (ways <= 2) return static_cast<int>(set_walk<2>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 4) return static_cast<int>(set_walk<4>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 8) return static_cast<int>(set_walk<8>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 16) return static_cast<int>(set_walk<16>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 32) return static_cast<int>(set_walk<32>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 64) return static_cast<int>(set_walk<64>(tg, ag, t, a, n, f, h, sets, ways, st));
  return static_cast<int>(set_walk<128>(tg, ag, t, a, n, f, h, sets, ways, st));
}

extern "C" int llc_lane_scan_launch(const void* seg, const void* rounds, const void* geo,
                                    void* tags, void* ts, void* hits, void* miss, int lanes,
                                    int n_seg, int max_sets, int max_ways, int r_pad,
                                    int suffix, void* stream) {
  if (lanes < 1 || lanes > 65535 || n_seg < 1 || max_sets < 1 || max_ways < 1 ||
      max_ways > kMaxWays || r_pad < 1 || suffix < kNone || suffix > kFull) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sg = static_cast<const int64_t*>(seg);
  const auto* r = static_cast<const int32_t*>(rounds);
  const auto* g = static_cast<const int64_t*>(geo);
  auto* tg = static_cast<int32_t*>(tags);
  auto* t = static_cast<int32_t*>(ts);
  auto* h = static_cast<unsigned long long*>(hits);
  auto* m = static_cast<bool*>(miss);
  auto st = static_cast<cudaStream_t>(stream);
#define LANE_SCAN(W) \
  lane_scan<W>(sg, r, g, tg, t, h, m, lanes, n_seg, max_sets, max_ways, r_pad, suffix, st)
  if (max_ways <= 2) return static_cast<int>(LANE_SCAN(2));
  if (max_ways <= 4) return static_cast<int>(LANE_SCAN(4));
  if (max_ways <= 8) return static_cast<int>(LANE_SCAN(8));
  if (max_ways <= 16) return static_cast<int>(LANE_SCAN(16));
  if (max_ways <= 32) return static_cast<int>(LANE_SCAN(32));
  if (max_ways <= 64) return static_cast<int>(LANE_SCAN(64));
  return static_cast<int>(LANE_SCAN(128));
#undef LANE_SCAN
}

extern "C" const char* llc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
