// The exact LLC replay engines for Hopper (sm_90a): the per-set round walk
// of one geometry (llc_set_walk) and the segment-lane scan of many lane
// batches (llc_lane_scan), each one launch where the plain PyTorch loops
// issue about twenty small ops a round.
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
// per-thread walks below (the spec to keep in step with this file: the
// argmin / argmax trees, the reciprocal divisions, the block table) to the
// plain versions on the CPU, and its gpu cases and chip_smoke.py hold the
// kernels to them on the card.
//
// What bounds it on the H100: neither bytes nor operations.  The work is
// a serial, data-dependent walk over a set's arrivals (the next victim
// depends on the last), so the time is the longest chain of steps times
// the latency of one step; the bytes that must move take microseconds at
// 3.35 TB/s.  So the design keeps every step's operands on chip and its
// issue stream short:
//
// * llc_set_walk: a block is one walker warp (a set a lane; 4,096 sets are
//   128 blocks on the 132 SMs) and WALK_PRODUCERS producer warps.  Each
//   set's arrivals are contiguous, so the producers stage every set's next
//   WALK_CHUNK arrivals (tag and access count) into shared memory with
//   4-byte cp.async, coalesced along each set's run, on a ring of
//   WALK_STAGES slots: a slot's `full` mbarrier completes when every
//   producer lane's copies have landed (cp.async.mbarrier.arrive.noinc),
//   its `empty` mbarrier when the walker has read it and left its hit bits
//   there, which the producers then write out, coalesced, before they
//   stage the slot again.  The walker never waits on global memory once
//   the ring is primed and issues nothing but the walk: the victim is a
//   log-depth argmax tree over the ways in registers, and a set of exactly
//   W ways (kExact) tests no padding.
// * llc_lane_scan: one thread a (bucket, lane, set); a block-descriptor
//   table maps blockIdx to (bucket, lane, first set), so one launch
//   replays every lane bucket of a call and the call costs its longest
//   chain, not the sum of the buckets' chains.  Blocks of the deepest
//   buckets come first.  A lane's segment table streams through shared
//   memory a chunk of SEG_CHUNK segments at a time (cp.async, two slots):
//   each thread derives one segment's 32-bit fields, the reciprocal of
//   its stride and its allocation mask once a block, and every thread
//   reads them back by broadcast.  The round loop and the suffix insert
//   divide by no 64-bit number: the tag of round k is t0 + k, every
//   division by the stride, the set count or the way count is a
//   multiply-high by a reciprocal (Granlund and Montgomery's round-up
//   method, exact for every 32-bit dividend), the victim is a log-depth
//   argmin tree, the suffix's ranks come from one compare a pair of ways,
//   and every update is a select, so the state stays in registers.  The
//   lane engine keeps every address, block, count and timestamp in int32
//   range (core/sweep.py _check_lane_support_meta, core/cache.py
//   _check_lane_table), so 32-bit arithmetic is exact.
//
// Sets are independent under LRU, so threads never communicate except to
// sum a segment's hits (a warp reduction, then one integer reduction to
// global memory a warp, which no thread waits on: the sums are exact in
// any order).  Tie-breaks follow the plain versions' first-index rule:
// the trees combine adjacent ranges, lower indices on the left, and take
// the right side only on a strict compare.  Every int32 sum wraps as
// torch's int32 does (computed in uint32_t).  Sets of 64 and 128 ways
// keep their ways in local memory and scan them in order.
//
// Both take any way count.  The thread routes above take up to kThreadWays
// (128) ways; wider sets take the warp routes below, a warp a set (the set
// walk) or a (bucket, lane, set) (the lane scan), way q on lane q % 32:
//
// * llc_set_walk_warp: the warp stages 32 arrivals at a time (a lane each,
//   coalesced, the next chunk loaded while this one is walked) and
//   broadcasts them by __shfl_sync.  A step scores each lane's ways in
//   order (the first of its greatest scores), then __reduce_max_sync finds
//   the greatest score and __reduce_min_sync the first way holding it;
//   __any_sync gives the hit.  The set lives in registers up to kRegWays
//   (8 ways a lane), else in dynamic shared memory (8 bytes a way, up to
//   kSharedBytes: 29,056 ways), else in place in global memory (L2); the
//   loops over a lane's ways take kTripWays a trip, so that as many loads
//   are in flight.  A step's chain is ceil(ways / 32) scores and updates a
//   lane plus the three collectives, so a fully associative cache, one set
//   and one warp, costs its trace length times that.
// * llc_lane_scan_wide: the same victim search by __reduce_min_sync over
//   the keys, the owning lane touching the way; the suffix insert ranks
//   the ways by a bitonic sort of (stamp, way) pairs, 64-bit keys in the
//   set's slot (ties break on the lower way, as the plain version's rank
//   does), O(ways log^2 ways) a set where the thread route's pair compares
//   are O(ways^2).  A slot is 8 bytes a way and 8 a sort key (the ways
//   rounded up to a power of two): in dynamic shared memory while it fits
//   kSharedBytes, else in a global scratch the wrapper allocates.  Only
//   the lane's real ways are walked: padding ways never match, never win
//   and hold no rank before a real way, so they change nothing.
//
// The only limits left are memory (the wrapper checks it) and int32
// indexing (ways, sets, arrivals and blocks each under 2**31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t IMAX = 0x7fffffff;
constexpr int32_t IMIN = -0x7fffffff - 1;
constexpr int kThreadWays = 128;  // a thread walks a set alone up to this
constexpr int kRegWays = 256;     // a warp holds a set in registers up to this
constexpr int kSharedBytes = 227 * 1024;  // a block's shared memory on Hopper
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NO_WAY = 0xffffffffu;  // a lane that holds no real way
constexpr int kTripWays = 4;  // a lane's ways a trip of the warp routes' loops

constexpr int WALK_SETS = 32;      // sets a block: a walker warp, a set a lane
constexpr int WALK_PRODUCERS = 2;  // producer warps a block, WALK_SETS / 2 sets each
constexpr int WALK_THREADS = 32 * (1 + WALK_PRODUCERS);
constexpr int WALK_CHUNK = 32;     // a set's arrivals a ring slot
constexpr int WALK_STAGES = 4;     // ring slots

constexpr int SCAN_THREADS = 64;         // (lane, set) threads a block
constexpr int SEG_CHUNK = SCAN_THREADS;  // segments a table chunk

// A thread's loops over its ways unroll fully up to 32 ways, so the ways
// stay in registers; wider sets (up to kThreadWays) keep them in local
// memory and loop.
template <int W>
struct Unroll {
  static constexpr int value = W <= 32 ? W : 1;
};

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

// a lane bucket's descriptor, (B, kBucketFields) int64
// (kernels/llc/kernel.py::BUCKET_FIELDS); the last five are device
// addresses
enum BucketField {
  kLanes,
  kSegs,
  kMaxSets,
  kMaxWaysB,
  kRPad,
  kSuffix,
  kTable,   // (L, S, kFields) int64
  kRounds,  // (S,) int32
  kGeo,     // (L, 3) int64: sets, ways, block bytes
  kHits,    // (L, S) int64, zero on entry
  kTags,    // (L, max_ways, max_sets) int32, written
  kStamps,  // (L, max_ways, max_sets) int32, written
  kMiss,    // (L, S, r_pad, max_sets) bool, zero on entry, or 0
  kBucketFields
};

enum Suffix { kNone = 0, kOne = 1, kFull = 2 };

// ---------------------------------------------------------------------------
// exact division of a uint32_t by a run-time constant d >= 1: with
// l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1 (< 2^32),
// floor(n / d) = (mulhi(n, m) + n) >> l for every n < 2^32
// (Granlund and Montgomery 1994, fig. 4.1).  Making one costs a 64-bit
// division, so it is made once a lane or a segment, never a round.
// ---------------------------------------------------------------------------
struct FastDiv {
  uint32_t mul, shift, d;

  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return static_cast<uint32_t>((static_cast<uint64_t>(__umulhi(n, mul)) + n) >> shift);
  }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const { return n - div(n) * d; }
};

__device__ __forceinline__ FastDiv make_fastdiv(uint32_t d) {
  const uint32_t l = 32 - __clz(d - 1);
  const uint64_t m = ((((uint64_t{1} << l) - d) << 32) / d) + 1;
  return {static_cast<uint32_t>(m), l, d};
}

// ---------------------------------------------------------------------------
// cp.async and mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One of the barrier's arrivals, made when every cp.async this thread
// issued before it has landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed; trap
// rather than spin forever if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// An exact add to a global int64 that nothing waits on.  The pointer
// comes from a descriptor, so atomicAdd could not know its space and would
// wait on a generic atomic's round trip.
__device__ __forceinline__ void red_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;\n" ::"l"(__cvta_generic_to_global(p)), "l"(v)
               : "memory");
}

// ---------------------------------------------------------------------------
// first-index trees over W ways: adjacent ranges combine, the lower
// indices on the left, and the right side wins only on a strict compare,
// so a tie goes to the first index, as the plain versions' cumsum rule
// ---------------------------------------------------------------------------
template <int W>
__device__ __forceinline__ int argmax_first(int32_t (&v)[W]) {
  int idx[W];
#pragma unroll
  for (int q = 0; q < W; ++q) idx[q] = q;
#pragma unroll
  for (int w = 1; w < W; w *= 2) {
#pragma unroll
    for (int q = 0; q + w < W; q += 2 * w) {
      if (v[q + w] > v[q]) {
        v[q] = v[q + w];
        idx[q] = idx[q + w];
      }
    }
  }
  return idx[0];
}

template <int W>
__device__ __forceinline__ int argmin_first(int32_t (&v)[W]) {
  int idx[W];
#pragma unroll
  for (int q = 0; q < W; ++q) idx[q] = q;
#pragma unroll
  for (int w = 1; w < W; w *= 2) {
#pragma unroll
    for (int q = 0; q + w < W; q += 2 * w) {
      if (v[q + w] < v[q]) {
        v[q] = v[q + w];
        idx[q] = idx[q + w];
      }
    }
  }
  return idx[0];
}

// ---------------------------------------------------------------------------
// llc_set_walk: lane i of block b's walker warp walks set s = b * 32 + i,
// arrivals first[s] .. first[s] + per_set[s] - 1 of the set-sorted order.
// A matching tag scores INT32_MAX, any other way its age; the first way
// of greatest score is touched: its tag set, its age reset to 0, every
// other way aged by the arrival's access count.  Positions fit int32 (the
// wrapper checks the arrival count).  kExact: ways == W, so no way is
// padding and the step tests none.
// ---------------------------------------------------------------------------
template <int W, bool kExact>
__device__ __forceinline__ bool walk_step(int32_t (&tg)[W], int32_t (&ag)[W], int32_t t, uint32_t a,
                                          int ways) {
  bool hit = false;
  if constexpr (W <= 32) {
    int32_t score[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const bool real = kExact || q < ways;
      const bool match = real && tg[q] == t;
      hit |= match;
      // ways past `ways` score below every real way, and lie to the right
      score[q] = real ? (match ? IMAX : ag[q]) : IMIN;
    }
    const int way = argmax_first<W>(score);
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const bool touched = q == way;
      tg[q] = touched ? t : tg[q];
      ag[q] = touched ? 0 : static_cast<int32_t>(static_cast<uint32_t>(ag[q]) + a);
    }
  } else {
    int way = 0;
    int32_t best = 0;
    for (int q = 0; q < ways; ++q) {
      const bool match = tg[q] == t;
      hit |= match;
      const int32_t score = match ? IMAX : ag[q];
      if (q == 0 || score > best) {
        best = score;
        way = q;
      }
    }
    for (int q = 0; q < ways; ++q) {
      if (q == way) {
        tg[q] = t;
        ag[q] = 0;
      } else {
        ag[q] = static_cast<int32_t>(static_cast<uint32_t>(ag[q]) + a);
      }
    }
  }
  return hit;
}

// Warp 0 walks; warps 1.. produce, each for its share of the sets: a
// producer stages each of its sets' next chunk of arrivals into a ring
// slot (lane i copies arrival c * 32 + i of each set, so each set's run is
// read coalesced) and completes the slot's `full` barrier when its copies
// land, and once the walker has released a slot (`empty`) writes that
// chunk's hit bits out, a set's run along the lanes, before it stages the
// slot again.
template <int W, bool kExact>
__global__ void __launch_bounds__(WALK_THREADS)
    llc_set_walk_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ age,
                        const int32_t* __restrict__ tag_s, const int32_t* __restrict__ acc_s,
                        const int64_t* __restrict__ per_set, const int64_t* __restrict__ first,
                        bool* __restrict__ hit_s, int sets, int ways) {
  // [slot][set][arrival], rows padded: the copies (a set's run along the
  // lanes) and the walk (a row a lane) are conflict-free
  __shared__ int32_t tag_sm[WALK_STAGES][WALK_SETS][WALK_CHUNK + 1];
  __shared__ int32_t acc_sm[WALK_STAGES][WALK_SETS][WALK_CHUNK + 1];
  __shared__ uint8_t hit_sm[WALK_STAGES][WALK_SETS][WALK_CHUNK + 4];
  __shared__ int32_t first_sm[WALK_SETS], count_sm[WALK_SETS];
  __shared__ uint64_t full[WALK_STAGES], empty[WALK_STAGES];

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WALK_SETS + lane;
  const bool real = s < sets;
  const int32_t n = real ? static_cast<int32_t>(per_set[s]) : 0;
  if (threadIdx.x < WALK_SETS) {
    first_sm[lane] = real ? static_cast<int32_t>(first[s]) : 0;
    count_sm[lane] = n;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < WALK_STAGES; ++st) {
      mbar_init(&full[st], 32 * WALK_PRODUCERS);
      mbar_init(&empty[st], WALK_SETS);
    }
  }
  __syncthreads();
  const int32_t most =
      static_cast<int32_t>(__reduce_max_sync(0xffffffffu, static_cast<uint32_t>(n)));
  const int chunks = (most + WALK_CHUNK - 1) / WALK_CHUNK;

  if (threadIdx.x >= 32) {  // a producer warp: sets i0 .. i0 + SP - 1
    constexpr int SP = WALK_SETS / WALK_PRODUCERS;
    const int i0 = (threadIdx.x / 32 - 1) * SP;
    int32_t at0[SP], cnt[SP];  // each set's first position and count
#pragma unroll
    for (int k = 0; k < SP; ++k) {
      at0[k] = first_sm[i0 + k];
      cnt[k] = count_sm[i0 + k];
    }
    for (int c = 0; c < chunks + WALK_STAGES; ++c) {
      const int slot = c % WALK_STAGES;
      if (c >= WALK_STAGES) {
        const int done = c - WALK_STAGES;
        mbar_wait(&empty[slot], (done / WALK_STAGES) & 1);
        const int32_t r = done * WALK_CHUNK + lane;
#pragma unroll
        for (int k = 0; k < SP; ++k) {
          if (r < cnt[k]) hit_s[at0[k] + r] = hit_sm[slot][i0 + k][lane];
        }
      }
      if (c < chunks) {
        const int32_t r = c * WALK_CHUNK + lane;
#pragma unroll
        for (int k = 0; k < SP; ++k) {
          if (r < cnt[k]) {
            cp_async4(&tag_sm[slot][i0 + k][lane], tag_s + at0[k] + r);
            cp_async4(&acc_sm[slot][i0 + k][lane], acc_s + at0[k] + r);
          }
        }
        mbar_arrive_copies(&full[slot]);
      }
    }
    return;
  }

  int32_t tg[W], ag[W];
  const int64_t row = static_cast<int64_t>(s) * ways;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    tg[q] = real && q < ways ? tags[row + q] : 0;
    ag[q] = real && q < ways ? age[row + q] : 0;
  }
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % WALK_STAGES;
    mbar_wait(&full[slot], (c / WALK_STAGES) & 1);
    const int32_t steps = min(WALK_CHUNK, n - c * WALK_CHUNK);  // this set's, maybe none
    const int32_t* t_row = tag_sm[slot][lane];
    const int32_t* a_row = acc_sm[slot][lane];
    uint8_t* h_row = hit_sm[slot][lane];
#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      h_row[r] = walk_step<W, kExact>(tg, ag, t_row[r], static_cast<uint32_t>(a_row[r]), ways);
    }
    mbar_arrive(&empty[slot]);  // the slot's arrivals read, its hit bits written
  }
  if (!real) return;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    if (q < ways) {
      tags[row + q] = tg[q];
      age[row + q] = ag[q];
    }
  }
}

// ---------------------------------------------------------------------------
// llc_lane_scan: block b walks (bucket, lane, first set) = blocks[b]:
// thread i takes set s = first set + i of the lane's (max_ways, max_sets)
// state and walks every segment in order: rounds[j] rounds of the per-set
// walk, then the closed-form suffix.  State is a global last-touch
// timestamp a way, cold on entry; sets s >= sets_l do nothing.  Ways
// q >= ways_l are padding: their tags stay -1, which no block's tag
// (>= 0) matches, and no miss may allocate into them, so their key is
// INT32_MAX and, lying right of every real way, they never win; the walk
// holds their stamps at INT32_MAX (the victim order of the suffix reads
// them so) and writes them out as the plain version leaves them, 0.
// ---------------------------------------------------------------------------

// The touched way takes the tag and the stamp.  Up to 32 ways a select a
// way, so the state stays in registers (a store to tg[way] would put it in
// local memory); wider sets, in local memory already, store the one way.
template <int W>
__device__ __forceinline__ void touch(int32_t (&tg)[W], int32_t (&st)[W], int way, int32_t t,
                                      int32_t stamp) {
  if constexpr (W <= 32) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      tg[q] = q == way ? t : tg[q];
      st[q] = q == way ? stamp : st[q];
    }
  } else {
    tg[way] = t;
    st[way] = stamp;
  }
}

// one segment of one lane in 32 bits, derived once a block
struct __align__(16) Seg {
  int32_t base, stride, count, n_pre, n_suf, rounds;
  uint32_t b_first, sb_first, counter;
  uint32_t qb, ub;    // b_first over the lane's sets: quotient, remainder
  uint32_t qsb, usb;  // sb_first over the lane's sets
  FastDiv by_stride;
  uint32_t alloc[4];  // the ways a miss may allocate into, a bit a way
};

__device__ __forceinline__ Seg derive(const int64_t (&f)[kFields], int32_t rounds,
                                      const FastDiv& by_sets, uint32_t ways) {
  Seg g;
  g.base = static_cast<int32_t>(f[kBase]);
  g.stride = static_cast<int32_t>(f[kStride]);
  g.count = static_cast<int32_t>(f[kCount]);
  g.n_pre = static_cast<int32_t>(f[kNPre]);
  g.n_suf = static_cast<int32_t>(f[kNSuf]);
  g.rounds = rounds;
  g.b_first = static_cast<uint32_t>(f[kBFirst]);
  g.sb_first = static_cast<uint32_t>(f[kSbFirst]);
  g.counter = static_cast<uint32_t>(static_cast<uint64_t>(f[kCounter]));
  g.qb = by_sets.div(g.b_first);
  g.ub = g.b_first - g.qb * by_sets.d;
  g.qsb = by_sets.div(g.sb_first);
  g.usb = g.sb_first - g.qsb * by_sets.d;
  // a padding segment (count 0) may carry any stride; it is never divided by
  g.by_stride = make_fastdiv(g.stride > 0 ? static_cast<uint32_t>(g.stride) : 1u);
  // bit q of the mask: the int64's bit q, its sign bit past bit 63 (as a
  // shift of an int64 by 64 or more); a zero mask allocates anywhere real
  const int64_t wsel = f[kWsel];
  const uint32_t hi = wsel < 0 ? 0xffffffffu : 0u;
  const uint32_t bits[4] = {static_cast<uint32_t>(static_cast<uint64_t>(wsel)),
                            static_cast<uint32_t>(static_cast<uint64_t>(wsel) >> 32), hi, hi};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int real = min(max(static_cast<int>(ways) - 32 * w, 0), 32);
    const uint32_t in_ways = real == 32 ? 0xffffffffu : (1u << real) - 1u;
    g.alloc[w] = in_ways & (wsel == 0 ? 0xffffffffu : bits[w]);
  }
  return g;
}

// the index of the last access of the segment that lands in the block
// starting `x - (bb - 1)` bytes past its base (x = block * bb - base + bb - 1
// >= 0): utils/address.py::last_access
__device__ __forceinline__ uint32_t last_access(const Seg& g, uint32_t x) {
  return min(g.by_stride.div(x), static_cast<uint32_t>(g.count - 1));
}

template <int W>
__global__ void __launch_bounds__(SCAN_THREADS)
    llc_lane_scan_kernel(const int64_t* __restrict__ buckets, const int32_t* __restrict__ blocks) {
  __shared__ int64_t raw[2][SEG_CHUNK][kFields];
  __shared__ Seg segs[SEG_CHUNK];

  const int b = blocks[3 * blockIdx.x], l = blocks[3 * blockIdx.x + 1];
  const int s = blocks[3 * blockIdx.x + 2] + static_cast<int>(threadIdx.x);
  const int64_t* d = buckets + static_cast<int64_t>(b) * kBucketFields;
  const int n_seg = static_cast<int>(d[kSegs]);
  const int max_sets = static_cast<int>(d[kMaxSets]), max_ways = static_cast<int>(d[kMaxWaysB]);
  const int64_t r_pad = d[kRPad];
  const int suffix = static_cast<int>(d[kSuffix]);
  const auto* table = reinterpret_cast<const int64_t*>(d[kTable]) +
                      static_cast<int64_t>(l) * n_seg * kFields;
  const auto* rounds = reinterpret_cast<const int32_t*>(d[kRounds]);
  const auto* geo = reinterpret_cast<const int64_t*>(d[kGeo]) + 3 * l;
  auto* hits = reinterpret_cast<unsigned long long*>(d[kHits]) + static_cast<int64_t>(l) * n_seg;
  auto* miss = reinterpret_cast<bool*>(d[kMiss]);
  const uint32_t sets = static_cast<uint32_t>(geo[0]), ways = static_cast<uint32_t>(geo[1]);
  const uint32_t bb = static_cast<uint32_t>(geo[2]);
  const FastDiv by_sets = make_fastdiv(sets), by_ways = make_fastdiv(ways);
  const bool in_state = s < max_sets;
  const bool active = in_state && static_cast<uint32_t>(s) < sets;
  const uint32_t su = static_cast<uint32_t>(s);
  const uint32_t step = sets * bb;  // bytes between a set's blocks

  int32_t tg[W], st[W];
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    tg[q] = -1;
    st[q] = q < static_cast<int>(ways) ? 0 : IMAX;
  }

  // thread i copies row chunk * SEG_CHUNK + i of the lane's table
  auto stage = [&](int chunk) {
    const int j = chunk * SEG_CHUNK + static_cast<int>(threadIdx.x);
    if (j < n_seg) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        cp_async8(&raw[chunk & 1][threadIdx.x][f], table + static_cast<int64_t>(j) * kFields + f);
      }
    }
    cp_async_commit();
  };
  const int n_chunks = (n_seg + SEG_CHUNK - 1) / SEG_CHUNK;
  stage(0);
  stage(1);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // this thread's row of chunk c has landed
    __syncthreads();     // every thread is done with the last chunk's segs
    const int j0 = c * SEG_CHUNK;
    if (j0 + static_cast<int>(threadIdx.x) < n_seg) {
      segs[threadIdx.x] = derive(raw[c & 1][threadIdx.x], rounds[j0 + threadIdx.x], by_sets, ways);
    }
    __syncthreads();
    stage(c + 2);  // into the slot this thread just read
    const int j_end = min(n_seg, j0 + SEG_CHUNK);
    for (int j = j0; j < j_end; ++j) {
      const Seg g = segs[j - j0];
      if (g.rounds > 0) {
        uint32_t mine = 0;
        if (active) {
          // the set's first block of the segment: b_first + off, off =
          // (s - b_first) mod sets, its tag (b_first + off) / sets
          const bool wrap = su < g.ub;
          uint32_t i = wrap ? su + sets - g.ub : su - g.ub;  // block ordinal
          uint32_t t = g.qb + wrap;
          uint32_t lo = (g.b_first + i) * bb - static_cast<uint32_t>(g.base);  // int32 bits
          bool* miss_j =
              miss == nullptr
                  ? nullptr
                  : miss + (static_cast<int64_t>(l) * n_seg + j) * r_pad * max_sets + s;

          for (int k = 0; k < g.rounds && i < static_cast<uint32_t>(g.n_pre);
               ++k, i += sets, ++t, lo += step) {
            const uint32_t j_hi = last_access(g, lo + bb - 1);
            const uint32_t j_lo =
                static_cast<int32_t>(lo) <= 0 ? 0 : g.by_stride.div(lo + g.stride - 1);
            // a matching tag wins (key -1), else the oldest way it may
            // allocate into; the first way of least key
            int way = 0;
            int32_t kmin = 0;
            if constexpr (W <= 32) {
              int32_t key[W];
#pragma unroll
              for (int q = 0; q < W; ++q) {
                const bool alloc = (g.alloc[0] >> q) & 1u;
                key[q] = tg[q] == static_cast<int32_t>(t) ? -1 : (alloc ? st[q] : IMAX);
              }
              way = argmin_first<W>(key);
              kmin = key[0];
            } else {
              // a run-time index into the record would put it in local
              // memory: read the mask from shared memory
              const uint32_t* alloc_sm = segs[j - j0].alloc;
              for (int q = 0; q < max_ways; ++q) {
                const bool alloc = (alloc_sm[q >> 5] >> (q & 31)) & 1u;
                const int32_t key =
                    tg[q] == static_cast<int32_t>(t) ? -1 : (alloc ? st[q] : IMAX);
                if (q == 0 || key < kmin) {
                  kmin = key;
                  way = q;
                }
              }
            }
            const bool hit = kmin == -1;
            const int32_t stamp = static_cast<int32_t>(g.counter + j_hi + 1);
            touch<W>(tg, st, way, static_cast<int32_t>(t), stamp);
            mine += j_hi - j_lo + hit;
            if (miss_j != nullptr && !hit) miss_j[static_cast<int64_t>(k) * max_sets] = true;
          }
        }
        // the segment's round hits: a warp's sum, then one exact atomic
        const uint32_t sum = __reduce_add_sync(0xffffffffu, mine);
        if ((threadIdx.x & 31) == 0 && sum != 0) {
          red_add(hits + j, static_cast<unsigned long long>(sum));
        }
      }
      if (!active || suffix == kNone || g.n_suf <= 0) continue;
      // closed-form suffix: every suffix block misses; victims cycle
      // through the real ways oldest-first
      const bool wrap = su < g.usb;
      const uint32_t off_suf = wrap ? su + sets - g.usb : su - g.usb;
      const uint32_t t_suf = g.qsb + wrap;  // the tag of the set's first suffix block
      const uint32_t blk0 = g.sb_first + off_suf;
      if (suffix == kOne) {
        // at most one suffix block a set: it evicts the first oldest way
        if (off_suf >= static_cast<uint32_t>(g.n_suf)) continue;
        int way = 0;
        if constexpr (W <= 32) {
          int32_t key[W];
#pragma unroll
          for (int q = 0; q < W; ++q) key[q] = st[q];
          way = argmin_first<W>(key);
        } else {
          int32_t vmin = 0;
          for (int q = 0; q < max_ways; ++q) {
            if (q == 0 || st[q] < vmin) {
              vmin = st[q];
              way = q;
            }
          }
        }
        const int32_t ts1 =
            static_cast<int32_t>(g.counter + last_access(g, blk0 * bb - g.base + bb - 1) + 1);
        touch<W>(tg, st, way, static_cast<int32_t>(t_suf), ts1);
        continue;
      }
      // the general insert: the set's m suffix blocks land on the ways in
      // oldest-first rank order (ties broken on way index), the last
      // `ways` of them staying.  Way a of rank r takes suffix block
      // jstar - 1 = m - 1 - d, d = (m - 1 - r) mod ways = (e - r) mod ways
      // with e = (m - 1) mod ways, when d < m.
      if (off_suf >= static_cast<uint32_t>(g.n_suf)) continue;  // m = 0
      const uint32_t m = by_sets.div(static_cast<uint32_t>(g.n_suf) - off_suf + sets - 1);
      const uint32_t e = by_ways.mod(m - 1);
      // each way's rank in the stamps' order before the insert (way a
      // precedes way q > a when st[a] <= st[q]): in registers one compare
      // a pair of ways; a wide set counts each real way's predecessors in
      // local memory over its real ways only (padding, at INT32_MAX and
      // to the right, precedes none of them)
      const int span = W <= 32 ? W : static_cast<int>(ways);
      uint32_t rank[W];
      if constexpr (W <= 32) {
#pragma unroll
        for (int q = 0; q < W; ++q) rank[q] = 0;
#pragma unroll
        for (int a = 0; a < W; ++a) {
#pragma unroll
          for (int q = a + 1; q < W; ++q) {
            const bool first = st[a] <= st[q];
            rank[q] += first;
            rank[a] += !first;
          }
        }
      } else {
        for (int a = 0; a < span; ++a) {
          uint32_t r = 0;
          for (int q = 0; q < span; ++q) r += (st[q] < st[a]) || (st[q] == st[a] && q < a);
          rank[a] = r;
        }
      }
#pragma unroll (Unroll<W>::value)
      for (int a = 0; a < span; ++a) {
        const uint32_t dd = e >= rank[a] ? e - rank[a] : e + ways - rank[a];
        const uint32_t back = m - 1 - dd;  // the suffix block's rank in the set
        const uint32_t blk = blk0 + back * sets;
        const bool write = a < static_cast<int>(ways) && dd < m;
        const int32_t stamp =
            static_cast<int32_t>(g.counter + last_access(g, blk * bb - g.base + bb - 1) + 1);
        if constexpr (W <= 32) {
          tg[a] = write ? static_cast<int32_t>(t_suf + back) : tg[a];
          st[a] = write ? stamp : st[a];
        } else if (write) {
          tg[a] = static_cast<int32_t>(t_suf + back);
          st[a] = stamp;
        }
      }
    }
  }
  if (!in_state) return;
  auto* tags_out = reinterpret_cast<int32_t*>(d[kTags]);
  auto* ts_out = reinterpret_cast<int32_t*>(d[kStamps]);
  const int64_t col = static_cast<int64_t>(l) * max_ways * max_sets + s;
#pragma unroll (Unroll<W>::value)
  for (int q = 0; q < W; ++q) {
    if (q < max_ways) {
      tags_out[col + static_cast<int64_t>(q) * max_sets] = tg[q];
      ts_out[col + static_cast<int64_t>(q) * max_sets] = q < static_cast<int>(ways) ? st[q] : 0;
    }
  }
}

template <int W>
cudaError_t set_walk(int32_t* tags, int32_t* age, const int32_t* tag_s, const int32_t* acc_s,
                     const int64_t* per_set, const int64_t* first, bool* hit_s, int sets,
                     int ways, cudaStream_t stream) {
  const dim3 grid((sets + WALK_SETS - 1) / WALK_SETS);
  if constexpr (W <= 32) {
    if (ways == W) {
      llc_set_walk_kernel<W, true><<<grid, WALK_THREADS, 0, stream>>>(
          tags, age, tag_s, acc_s, per_set, first, hit_s, sets, ways);
      return cudaGetLastError();
    }
  }
  llc_set_walk_kernel<W, false><<<grid, WALK_THREADS, 0, stream>>>(
      tags, age, tag_s, acc_s, per_set, first, hit_s, sets, ways);
  return cudaGetLastError();
}

template <int W>
cudaError_t lane_scan(const int64_t* buckets, const int32_t* blocks, int n_blocks,
                      cudaStream_t stream) {
  llc_lane_scan_kernel<W><<<n_blocks, SCAN_THREADS, 0, stream>>>(buckets, blocks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the warp routes: sets wider than kThreadWays, a warp a set (the set walk)
// or a (bucket, lane, set) (the lane scan), way q on lane q % 32.  A lane
// visits its ways in order and keeps the first of its best; the warp's
// best is found by __reduce_{max,min}_sync over the lanes' keys, then the
// first way among the lanes holding it by __reduce_min_sync over their
// ways: the first index of the extreme, as the plain versions take it.
// ---------------------------------------------------------------------------
struct Best {
  int32_t key;
  uint32_t way;  // NO_WAY while the lane has seen no real way
};

__device__ __forceinline__ uint32_t first_max(const Best& b) {
  const int32_t most = __reduce_max_sync(FULL, b.key);
  return __reduce_min_sync(FULL, b.key == most ? b.way : NO_WAY);
}

__device__ __forceinline__ uint32_t first_min(const Best& b) {
  const int32_t least = __reduce_min_sync(FULL, b.key);
  return __reduce_min_sync(FULL, b.key == least ? b.way : NO_WAY);
}

// Walk arrivals first .. first + n - 1 of the set-sorted order, 32 at a
// time: lane i holds arrival c + i (loaded a chunk ahead, coalesced), each
// step takes its arrival by broadcast, and lane i writes arrival c + i's
// hit bit.  step(tag, access count) returns whether the arrival hit.
template <class Step>
__device__ __forceinline__ void walk_warp(const int32_t* __restrict__ tag_s,
                                          const int32_t* __restrict__ acc_s,
                                          bool* __restrict__ hit_s, int64_t first, int32_t n,
                                          Step step) {
  const int lane = threadIdx.x & 31;
  int32_t next_t = lane < n ? tag_s[first + lane] : 0;
  int32_t next_a = lane < n ? acc_s[first + lane] : 0;
  for (int32_t c0 = 0; c0 < n; c0 += 32) {
    const int32_t my_t = next_t, my_a = next_a;
    const int64_t ahead = static_cast<int64_t>(c0) + 32 + lane;
    if (ahead < n) {
      next_t = tag_s[first + ahead];
      next_a = acc_s[first + ahead];
    }
    const int steps = min(32, n - c0);
    bool my_hit = false;
    for (int i = 0; i < steps; ++i) {
      const int32_t t = __shfl_sync(FULL, my_t, i);
      const uint32_t a = static_cast<uint32_t>(__shfl_sync(FULL, my_a, i));
      const bool hit = step(t, a);
      my_hit = lane == i ? hit : my_hit;
    }
    if (lane < steps) hit_s[first + c0 + lane] = my_hit;
  }
}

// llc_set_walk, a warp a set (blockIdx.x), the set's ways in registers:
// K a lane, up to 32 K ways.  Scores as llc_set_walk_kernel's.
template <int K>
__global__ void __launch_bounds__(32)
    llc_set_walk_warp_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ age,
                             const int32_t* __restrict__ tag_s, const int32_t* __restrict__ acc_s,
                             const int64_t* __restrict__ per_set, const int64_t* __restrict__ first,
                             bool* __restrict__ hit_s, int ways) {
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ways;
  int32_t tg[K], ag[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    tg[k] = q < ways ? tags[row + q] : 0;
    ag[k] = q < ways ? age[row + q] : 0;
  }
  walk_warp(tag_s, acc_s, hit_s, first[blockIdx.x], static_cast<int32_t>(per_set[blockIdx.x]),
            [&](int32_t t, uint32_t a) {
              Best b{IMIN, NO_WAY};
              bool match = false;
#pragma unroll
              for (int k = 0; k < K; ++k) {
                const int q = lane + 32 * k;
                if (q < ways) {
                  const bool m = tg[k] == t;
                  match |= m;
                  const int32_t score = m ? IMAX : ag[k];
                  if (b.way == NO_WAY || score > b.key) {
                    b.key = score;
                    b.way = q;
                  }
                }
              }
              const uint32_t way = first_max(b);
#pragma unroll
              for (int k = 0; k < K; ++k) {
                const bool touched = static_cast<uint32_t>(lane + 32 * k) == way;
                tg[k] = touched ? t : tg[k];
                ag[k] = touched ? 0 : static_cast<int32_t>(static_cast<uint32_t>(ag[k]) + a);
              }
              return __any_sync(FULL, match) != 0;
            });
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = lane + 32 * k;
    if (q < ways) {
      tags[row + q] = tg[k];
      age[row + q] = ag[k];
    }
  }
}

// llc_set_walk, a warp a set (blockIdx.x), the set's ways in dynamic shared
// memory (kShared: tags then ages, copied in and out) or walked in place in
// global memory.  A lane reads and writes only its own ways, so the steps
// need no barrier.
template <bool kShared>
__global__ void __launch_bounds__(32)
    llc_set_walk_mem_kernel(int32_t* __restrict__ tags, int32_t* __restrict__ age,
                            const int32_t* __restrict__ tag_s, const int32_t* __restrict__ acc_s,
                            const int64_t* __restrict__ per_set, const int64_t* __restrict__ first,
                            bool* __restrict__ hit_s, int ways) {
  extern __shared__ int32_t walk_sm[];
  const uint32_t lane = threadIdx.x, n_ways = static_cast<uint32_t>(ways);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ways;
  int32_t* tg = kShared ? walk_sm : tags + row;
  int32_t* ag = kShared ? walk_sm + ways : age + row;
  if constexpr (kShared) {
    for (uint32_t q = lane; q < n_ways; q += 32) {
      tg[q] = tags[row + q];
      ag[q] = age[row + q];
    }
  }
  walk_warp(tag_s, acc_s, hit_s, first[blockIdx.x], static_cast<int32_t>(per_set[blockIdx.x]),
            [&](int32_t t, uint32_t a) {
              Best b{IMIN, NO_WAY};
              bool match = false;
#pragma unroll 1
              for (uint32_t q0 = lane; q0 < n_ways; q0 += 32 * kTripWays) {
#pragma unroll
                for (int u = 0; u < kTripWays; ++u) {  // the lane's ways in order
                  const uint32_t q = q0 + 32 * u;
                  if (q < n_ways) {
                    const bool m = tg[q] == t;
                    match |= m;
                    const int32_t score = m ? IMAX : ag[q];
                    if (b.way == NO_WAY || score > b.key) {
                      b.key = score;
                      b.way = q;
                    }
                  }
                }
              }
              const uint32_t way = first_max(b);
#pragma unroll 1
              for (uint32_t q0 = lane; q0 < n_ways; q0 += 32 * kTripWays) {
#pragma unroll
                for (int u = 0; u < kTripWays; ++u) {
                  const uint32_t q = q0 + 32 * u;
                  if (q < n_ways) {
                    const int32_t aged = static_cast<int32_t>(static_cast<uint32_t>(ag[q]) + a);
                    if (q == way) tg[q] = t;
                    ag[q] = q == way ? 0 : aged;
                  }
                }
              }
              return __any_sync(FULL, match) != 0;
            });
  if constexpr (kShared) {
    for (uint32_t q = lane; q < n_ways; q += 32) {
      tags[row + q] = tg[q];
      age[row + q] = ag[q];
    }
  }
}

// A warp-route lane-scan slot: tags and stamps of up to `ways` ways (int32,
// rounded up to an even count) and 64-bit sort keys for pow2(ways) ways
// (kernels/llc/kernel.py::wide_slot_bytes).
__host__ __device__ inline int64_t wide_slot_bytes(int64_t ways) {
  int64_t span = 1;
  while (span < ways) span <<= 1;
  return 8 * ((ways + 1) & ~int64_t{1}) + 8 * span;
}

// llc_lane_scan's warp route: block b walks (bucket, lane, set) =
// blocks[b] with one warp, the set's state in its slot (dynamic shared
// memory, kShared, or slot b of a global scratch of `slot_words` int32
// each).  The segment walk is llc_lane_scan_kernel's; the way a lane
// allocates into is the int64 mask's bit q, its sign bit past bit 63, as
// derive() makes the thread route's words.
template <bool kShared>
__global__ void __launch_bounds__(32)
    llc_lane_scan_wide_kernel(const int64_t* __restrict__ buckets,
                              const int32_t* __restrict__ blocks, int32_t* __restrict__ scratch,
                              int64_t slot_words) {
  extern __shared__ uint64_t scan_sm[];
  const int b = blocks[3 * blockIdx.x], l = blocks[3 * blockIdx.x + 1];
  const int s = blocks[3 * blockIdx.x + 2];
  const uint32_t lane = threadIdx.x;
  const int64_t* d = buckets + static_cast<int64_t>(b) * kBucketFields;
  const int n_seg = static_cast<int>(d[kSegs]);
  const int max_sets = static_cast<int>(d[kMaxSets]), max_ways = static_cast<int>(d[kMaxWaysB]);
  const int64_t r_pad = d[kRPad];
  const int suffix = static_cast<int>(d[kSuffix]);
  const auto* table = reinterpret_cast<const int64_t*>(d[kTable]) +
                      static_cast<int64_t>(l) * n_seg * kFields;
  const auto* rounds = reinterpret_cast<const int32_t*>(d[kRounds]);
  const auto* geo = reinterpret_cast<const int64_t*>(d[kGeo]) + 3 * l;
  auto* hits = reinterpret_cast<unsigned long long*>(d[kHits]) + static_cast<int64_t>(l) * n_seg;
  auto* miss = reinterpret_cast<bool*>(d[kMiss]);
  const uint32_t sets = static_cast<uint32_t>(geo[0]), ways = static_cast<uint32_t>(geo[1]);
  const uint32_t bb = static_cast<uint32_t>(geo[2]);
  const FastDiv by_sets = make_fastdiv(sets), by_ways = make_fastdiv(ways);
  const bool active = static_cast<uint32_t>(s) < sets;
  const uint32_t su = static_cast<uint32_t>(s);
  const uint32_t step = sets * bb;
  const uint32_t ways_r = (ways + 1) & ~1u;
  int32_t* tg = kShared ? reinterpret_cast<int32_t*>(scan_sm)
                        : scratch + static_cast<int64_t>(blockIdx.x) * slot_words;
  int32_t* st = tg + ways_r;
  uint64_t* keys = reinterpret_cast<uint64_t*>(st + ways_r);
  for (uint32_t q = lane; q < ways; q += 32) {
    tg[q] = -1;
    st[q] = 0;
  }

  for (int j = 0; j < n_seg; ++j) {
    int64_t f[kFields];
#pragma unroll
    for (int x = 0; x < kFields; ++x) f[x] = table[static_cast<int64_t>(j) * kFields + x];
    const Seg g = derive(f, rounds[j], by_sets, ways);
    const int64_t wsel = f[kWsel];
    if (g.rounds > 0) {
      uint32_t mine = 0;
      if (active) {
        const bool wrap = su < g.ub;
        uint32_t i = wrap ? su + sets - g.ub : su - g.ub;  // block ordinal
        uint32_t t = g.qb + wrap;
        uint32_t lo = (g.b_first + i) * bb - static_cast<uint32_t>(g.base);
        bool* miss_j =
            miss == nullptr ? nullptr
                            : miss + (static_cast<int64_t>(l) * n_seg + j) * r_pad * max_sets + s;
        for (int k = 0; k < g.rounds && i < static_cast<uint32_t>(g.n_pre);
             ++k, i += sets, ++t, lo += step) {
          const uint32_t j_hi = last_access(g, lo + bb - 1);
          const uint32_t j_lo =
              static_cast<int32_t>(lo) <= 0 ? 0 : g.by_stride.div(lo + g.stride - 1);
          Best best{IMAX, NO_WAY};
#pragma unroll 1
          for (uint32_t q0 = lane; q0 < ways; q0 += 32 * kTripWays) {
#pragma unroll
            for (int u = 0; u < kTripWays; ++u) {  // the lane's ways in order
              const uint32_t q = q0 + 32 * u;
              if (q < ways) {
                const bool alloc = wsel == 0 || (q < 64 ? ((static_cast<uint64_t>(wsel) >> q) & 1u) != 0
                                                        : wsel < 0);
                const int32_t key =
                    tg[q] == static_cast<int32_t>(t) ? -1 : (alloc ? st[q] : IMAX);
                if (best.way == NO_WAY || key < best.key) {
                  best.key = key;
                  best.way = q;
                }
              }
            }
          }
          const int32_t kmin = __reduce_min_sync(FULL, best.key);
          const uint32_t way = __reduce_min_sync(FULL, best.key == kmin ? best.way : NO_WAY);
          const bool hit = kmin == -1;
          if ((way & 31u) == lane) {  // the way's own lane touches it
            tg[way] = static_cast<int32_t>(t);
            st[way] = static_cast<int32_t>(g.counter + j_hi + 1);
          }
          mine += j_hi - j_lo + hit;
          if (miss_j != nullptr && !hit && lane == 0) miss_j[static_cast<int64_t>(k) * max_sets] = true;
        }
      }
      if (lane == 0 && mine != 0) red_add(hits + j, static_cast<unsigned long long>(mine));
    }
    if (!active || suffix == kNone || g.n_suf <= 0) continue;
    const bool wrap = su < g.usb;
    const uint32_t off_suf = wrap ? su + sets - g.usb : su - g.usb;
    if (off_suf >= static_cast<uint32_t>(g.n_suf)) continue;  // no suffix block in this set
    const uint32_t t_suf = g.qsb + wrap;
    const uint32_t blk0 = g.sb_first + off_suf;
    if (suffix == kOne) {  // one suffix block: it evicts the first oldest way
      Best best{IMAX, NO_WAY};
#pragma unroll 1
      for (uint32_t q0 = lane; q0 < ways; q0 += 32 * kTripWays) {
#pragma unroll
        for (int u = 0; u < kTripWays; ++u) {
          const uint32_t q = q0 + 32 * u;
          if (q < ways && (best.way == NO_WAY || st[q] < best.key)) {
            best.key = st[q];
            best.way = q;
          }
        }
      }
      const uint32_t way = first_min(best);
      if ((way & 31u) == lane) {
        tg[way] = static_cast<int32_t>(t_suf);
        st[way] = static_cast<int32_t>(g.counter + last_access(g, blk0 * bb - g.base + bb - 1) + 1);
      }
      continue;
    }
    // the general insert (llc_lane_scan_kernel's): the ways ranked
    // oldest-first by a bitonic sort of (stamp, way) keys, ascending (the
    // stamp's sign flipped so that unsigned order is int32 order; the way
    // breaks ties), pow2(ways) keys with the padding last
    const uint32_t m = by_sets.div(static_cast<uint32_t>(g.n_suf) - off_suf + sets - 1);
    const uint32_t e = by_ways.mod(m - 1);
    uint32_t span = 1;
    while (span < ways) span <<= 1;
    for (uint32_t p = lane; p < span; p += 32) {
      keys[p] = p < ways ? (static_cast<uint64_t>(static_cast<uint32_t>(st[p]) ^ 0x80000000u) << 32) | p
                         : ~uint64_t{0};
    }
    __syncwarp();
    for (uint64_t k2 = 2; k2 <= span; k2 <<= 1) {
      for (uint32_t jj = static_cast<uint32_t>(k2 >> 1); jj > 0; jj >>= 1) {
        for (uint32_t x = lane; x < span / 2; x += 32) {  // pair x: i with bit jj clear
          const uint32_t i = ((x & ~(jj - 1)) << 1) | (x & (jj - 1));
          const uint32_t ixj = i | jj;
          const uint64_t u = keys[i], v = keys[ixj];
          if ((u > v) == ((i & k2) == 0)) {
            keys[i] = v;
            keys[ixj] = u;
          }
        }
        __syncwarp();
      }
    }
    for (uint32_t r = lane; r < ways; r += 32) {  // the way of rank r
      const uint32_t a = static_cast<uint32_t>(keys[r]);
      const uint32_t dd = e >= r ? e - r : e + ways - r;
      if (dd < m) {
        const uint32_t back = m - 1 - dd;  // the suffix block's rank in the set
        const uint32_t blk = blk0 + back * sets;
        tg[a] = static_cast<int32_t>(t_suf + back);
        st[a] = static_cast<int32_t>(g.counter + last_access(g, blk * bb - g.base + bb - 1) + 1);
      }
    }
    __syncwarp();
  }
  auto* tags_out = reinterpret_cast<int32_t*>(d[kTags]);
  auto* ts_out = reinterpret_cast<int32_t*>(d[kStamps]);
  const int64_t col = static_cast<int64_t>(l) * max_ways * max_sets + s;
  for (uint32_t q = lane; q < static_cast<uint32_t>(max_ways); q += 32) {
    tags_out[col + static_cast<int64_t>(q) * max_sets] = q < ways ? tg[q] : -1;
    ts_out[col + static_cast<int64_t>(q) * max_sets] = q < ways ? st[q] : 0;
  }
}

cudaError_t set_walk_wide(int32_t* tags, int32_t* age, const int32_t* tag_s, const int32_t* acc_s,
                          const int64_t* per_set, const int64_t* first, bool* hit_s, int sets,
                          int ways, cudaStream_t stream) {
  const dim3 grid(sets);
  if (ways <= kRegWays) {
    llc_set_walk_warp_kernel<kRegWays / 32><<<grid, 32, 0, stream>>>(tags, age, tag_s, acc_s,
                                                                      per_set, first, hit_s, ways);
    return cudaGetLastError();
  }
  const int64_t bytes = 8LL * ways;
  if (bytes <= kSharedBytes) {
    const int smem = static_cast<int>(bytes);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          llc_set_walk_mem_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    llc_set_walk_mem_kernel<true><<<grid, 32, smem, stream>>>(tags, age, tag_s, acc_s, per_set,
                                                             first, hit_s, ways);
    return cudaGetLastError();
  }
  llc_set_walk_mem_kernel<false><<<grid, 32, 0, stream>>>(tags, age, tag_s, acc_s, per_set, first,
                                                         hit_s, ways);
  return cudaGetLastError();
}

}  // namespace

// The routes' bounds (kernels/llc/kernel.py): the widest set a thread
// walks alone, the widest a warp holds in registers, a block's shared
// memory.
extern "C" int llc_thread_ways() { return kThreadWays; }
extern "C" int llc_reg_ways() { return kRegWays; }
extern "C" int llc_shared_bytes() { return kSharedBytes; }

// The bytes of a lane-scan warp-route slot (kernels/llc/kernel.py::wide_slot_bytes).
extern "C" long long llc_wide_slot_bytes(int ways) { return wide_slot_bytes(ways); }

// Threads a lane-scan block (kernels/llc/kernel.py::SCAN_THREADS).
extern "C" int llc_scan_threads() { return SCAN_THREADS; }

extern "C" int llc_set_walk_launch(void* tags, void* age, const void* tag_s, const void* acc_s,
                                   const void* per_set, const void* first, void* hit_s,
                                   int sets, int ways, void* stream) {
  if (sets < 1 || ways < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* tg = static_cast<int32_t*>(tags);
  auto* ag = static_cast<int32_t*>(age);
  const auto* t = static_cast<const int32_t*>(tag_s);
  const auto* a = static_cast<const int32_t*>(acc_s);
  const auto* n = static_cast<const int64_t*>(per_set);
  const auto* f = static_cast<const int64_t*>(first);
  auto* h = static_cast<bool*>(hit_s);
  auto st = static_cast<cudaStream_t>(stream);
  if (ways > kThreadWays) return static_cast<int>(set_walk_wide(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 2) return static_cast<int>(set_walk<2>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 4) return static_cast<int>(set_walk<4>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 8) return static_cast<int>(set_walk<8>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 16) return static_cast<int>(set_walk<16>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 32) return static_cast<int>(set_walk<32>(tg, ag, t, a, n, f, h, sets, ways, st));
  if (ways <= 64) return static_cast<int>(set_walk<64>(tg, ag, t, a, n, f, h, sets, ways, st));
  return static_cast<int>(set_walk<128>(tg, ag, t, a, n, f, h, sets, ways, st));
}

// buckets: (B, kBucketFields) int64 on the device; blocks: (n_blocks, 3)
// int32 (bucket, lane, first set) of buckets of at most kThreadWays ways;
// max_ways: the largest of their max_ways.
extern "C" int llc_lane_scan_launch(const void* buckets, const void* blocks, int n_blocks,
                                    int max_ways, void* stream) {
  if (n_blocks < 1 || max_ways < 1 || max_ways > kThreadWays) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bk = static_cast<const int64_t*>(buckets);
  const auto* bl = static_cast<const int32_t*>(blocks);
  auto st = static_cast<cudaStream_t>(stream);
  if (max_ways <= 2) return static_cast<int>(lane_scan<2>(bk, bl, n_blocks, st));
  if (max_ways <= 4) return static_cast<int>(lane_scan<4>(bk, bl, n_blocks, st));
  if (max_ways <= 8) return static_cast<int>(lane_scan<8>(bk, bl, n_blocks, st));
  if (max_ways <= 16) return static_cast<int>(lane_scan<16>(bk, bl, n_blocks, st));
  if (max_ways <= 32) return static_cast<int>(lane_scan<32>(bk, bl, n_blocks, st));
  if (max_ways <= 64) return static_cast<int>(lane_scan<64>(bk, bl, n_blocks, st));
  return static_cast<int>(lane_scan<128>(bk, bl, n_blocks, st));
}

// The warp route of the same buckets table: blocks (n_blocks, 3) int32
// (bucket, lane, set), one warp each, of buckets wider than kThreadWays;
// max_ways: the largest of their max_ways; scratch: n_blocks slots of
// wide_slot_bytes(max_ways) in global memory, or null to keep each slot in
// shared memory (it must fit kSharedBytes).
extern "C" int llc_lane_scan_wide_launch(const void* buckets, const void* blocks, int n_blocks,
                                         int max_ways, void* scratch, void* stream) {
  if (n_blocks < 1 || max_ways < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bk = static_cast<const int64_t*>(buckets);
  const auto* bl = static_cast<const int32_t*>(blocks);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t slot = wide_slot_bytes(max_ways);
  if (scratch != nullptr) {
    llc_lane_scan_wide_kernel<false><<<n_blocks, 32, 0, st>>>(
        bk, bl, static_cast<int32_t*>(scratch), slot / 4);
    return static_cast<int>(cudaGetLastError());
  }
  if (slot > kSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(slot);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        llc_lane_scan_wide_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  llc_lane_scan_wide_kernel<true><<<n_blocks, 32, smem, st>>>(bk, bl, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* llc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
