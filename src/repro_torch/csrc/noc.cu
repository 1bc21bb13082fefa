// The cycle-token NoC switch's whole cycle loop for Hopper (sm_90a):
// noc_switch, one launch a simulation, where the plain PyTorch version
// (src/repro_torch/kernels/noc/ref.py) issues about forty small ops a
// target cycle from the host and reads the delivered count back once a
// bundle.
//
// Replaces no Pallas kernel.  The reference runs the loop as one compiled
// device program: the cycle function of src/repro/core/noc.py::
// _switch_program under fame1.chunked_scan (a lax.while_loop over
// lax.scan bundles), all under one jax.jit.  This kernel brings that
// structure to the card.  Its outputs are bit-identical to the plain
// version's: tests/test_torch_noc_kernel.py holds a numpy emulation of
// both routes' per-cycle walks below (the spec to keep in step with this
// file)
// to the per-cycle scheduler, the plain version and the reference on the
// CPU, and its gpu cases and chip_smoke.py hold the kernel to the plain
// version on the card.
//
// The model (src/repro_torch/core/noc.py), per target cycle c:
//   inject     dests[c, p] >= 0 appends the flit (c, dests[c, p]) to
//              ingress FIFO p; a full FIFO sets the overflow flag;
//   arbitrate  against the heads after this cycle's injections, before
//              any pop: a head is eligible when inject + link <= c; each
//              egress takes the first eligible head aimed at it in
//              rotation from its round-robin pointer;
//   deliver    the winner pops; (c, e) records granted, its ingress and
//              its latency c - inject; the pointer moves past the winner.
// The delivered count is tested only at bundle boundaries, as chunked_scan
// tests its continuation before each bundle: `bundles` counts the bundles
// started (at most n_chunks), and a bundle's cycles at or past h_pad are
// no-ops.
//
// What bounds it on the H100: neither bytes nor operations.  A cycle's
// grants depend on the last cycle's pops and pointers, so the loop is one
// dependent chain of cycles; the bytes that must move (the schedule read
// once, three (h_pad, ports) outputs written once) take microseconds at
// 3.35 TB/s.  So one warp walks one switch of up to kWarpPorts ports, and
// every cycle's state stays in registers and shared memory:
//
// * lane p owns ingress FIFO p (head, size, and the head flit's inject
//   cycle and destination cached in registers) and egress p's round-robin
//   pointer; lanes >= ports idle through the collectives;
// * the FIFOs are (ports, depth) rings of (inject, destination) int2 pairs
//   in dynamic shared memory where they fit (SHARED_FIFO_BYTES), else in a
//   global scratch the wrapper allocates; only a push and the read of the
//   next head after a pop touch them;
// * arbitration is three warp collectives: __match_any_sync groups the
//   eligible heads by destination, each lane of a group reads its egress's
//   pointer by __shfl_sync and picks the first member in rotation (a shift
//   and __ffs), and __reduce_or_sync gathers the granted egresses; each
//   winner leaves its ingress and latency for its egress in shared memory
//   (double-buffered by cycle parity, so one __syncwarp a cycle orders it);
// * the schedule is staged STAGE_CYCLES rows at a time into shared memory,
//   coalesced, so a cycle never waits on global memory; outputs are plain
//   stores nothing waits on.
//
// A switch of more ports takes the block route, noc_switch_wide: one block
// a switch of 32 ceil(ports / 32) threads, at most kWideThreads; thread i
// owns ingress and egress ports i, i + blockDim.x, ... (one each up to
// 1,024 ports).  A port's state is a table of int32 arrays (kPortFields of
// them, then the staged schedule, wide_stage_rows(ports) rows), in dynamic
// shared memory where it fits SHARED_FIFO_BYTES, else in a global scratch;
// the rings follow it in shared memory where both fit, else in the global
// scratch.  A cycle is three phases between two __syncthreads: each
// ingress pushes its flit and, if its head is eligible, posts its rotation
// key (p - pointer[e]) mod ports to its egress e by a shared-memory
// atomicMin (the least key is the first eligible head in rotation from the
// pointer, whatever order the posts land in); each egress turns its least
// key into the winner, writes the cycle's row, moves its pointer and
// clears the key; each ingress whose egress named it pops.  The keys take
// one word an egress, where an eligibility bitmask would take ceil(ports /
// 32) words an egress (128 KiB at 1,000 ports) and a scan of them a cycle.
// The delivered count is folded into one shared word at each bundle
// boundary, where it is tested.
//
// Every cycle, inject cycle and latency is below h_pad < 2**31 (the
// wrapper checks), so int32 is exact; the eligibility test is c - inject
// >= link, which cannot overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPorts = 32;                  // the one-warp route: a lane a port
constexpr int kWideThreads = 1024;             // the block route's most threads
constexpr int STAGE_CYCLES = 64;               // schedule rows staged at once
constexpr int STAGE_INTS = 4096;               // the block route's staged entries
constexpr int SHARED_FIFO_BYTES = 200 * 1024;  // largest FIFO ring kept on chip
constexpr unsigned FULL = 0xffffffffu;

// the block route's per-port table: int32 arrays of `ports` each
enum PortField { kHead, kSize, kHeadTs, kHeadDst, kPointer, kBid, kWinner, kPortFields };

// schedule rows the block route stages at once: STAGE_CYCLES, fewer for
// wide switches, at least one (kernels/noc/kernel.py::stage_rows)
__host__ __device__ inline int wide_stage_rows(int ports) {
  const int rows = STAGE_INTS / ports;
  return rows < 1 ? 1 : (rows > STAGE_CYCLES ? STAGE_CYCLES : rows);
}

// the block route's table bytes, 16-byte aligned (kernels/noc/kernel.py::table_bytes)
__host__ __device__ inline long long wide_table_bytes(int ports) {
  return (4LL * ports * (kPortFields + wide_stage_rows(ports)) + 15) / 16 * 16;
}

struct SwitchArgs {
  const int32_t* dests;  // (t_rows, ports) row-major; rows >= t_rows inject nothing
  long long t_rows;
  int ports, link, depth, total, h_pad, n_chunks;
  long long bundle;
  int2* fifo_global;  // (ports, depth) rings, or null: in shared memory
  int32_t* status;    // [delivered, overflow, bundles started]
  bool* granted;      // (h_pad, ports), zero on entry
  int32_t* src;       // (h_pad, ports), zero on entry
  int32_t* lat;       // (h_pad, ports), zero on entry
};

__global__ void __launch_bounds__(32, 1) noc_switch_kernel(const SwitchArgs a) {
  extern __shared__ int2 fifo_shared[];
  __shared__ int32_t stage[STAGE_CYCLES * kMaxPorts];
  __shared__ int32_t win_src[2][kMaxPorts];
  __shared__ int32_t win_lat[2][kMaxPorts];

  const int lane = threadIdx.x;
  const int ports = a.ports;
  const bool real = lane < ports;
  // lanes >= ports never push (their schedule entry reads -1), so their
  // ring pointer is never dereferenced
  int2* ring = (a.fifo_global ? a.fifo_global : fifo_shared) +
               static_cast<long long>(real ? lane : 0) * a.depth;
  const long long sched_end = a.t_rows * ports;

  int head = 0, size = 0, rr = 0;
  int h_ts = 0, h_dst = 0;  // the head flit, valid while size > 0
  int delivered = 0, overflow = 0, bundles = 0;
  int staged = -STAGE_CYCLES;  // first cycle of the staged rows

  for (int b = 0; b < a.n_chunks; ++b) {
    if (delivered >= a.total) break;
    const long long c0 = static_cast<long long>(b) * a.bundle;
    if (c0 >= a.h_pad) {  // the rest are padding bundles: started, no-ops
      bundles = a.n_chunks;
      break;
    }
    ++bundles;
    const int c_end = static_cast<int>(min(c0 + a.bundle, static_cast<long long>(a.h_pad)));
    for (int c = static_cast<int>(c0); c < c_end; ++c) {
      if (c >= staged + STAGE_CYCLES) {
        __syncwarp();
        staged = c;
        const long long base = static_cast<long long>(c) * ports;
        for (int i = lane; i < STAGE_CYCLES * ports; i += 32) {
          stage[i] = base + i < sched_end ? __ldg(a.dests + base + i) : -1;
        }
        __syncwarp();
      }
      // inject
      const int d = real ? stage[(c - staged) * ports + lane] : -1;
      if (d >= 0) {
        if (size < a.depth) {
          int pos = head + size;
          if (pos >= a.depth) pos -= a.depth;
          ring[pos] = make_int2(c, d);
          if (size == 0) {
            h_ts = c;
            h_dst = d;
          }
          ++size;
        } else {
          overflow = 1;
        }
      }
      // arbitrate: the eligible heads grouped by egress, each group's
      // first member in rotation from its egress's pointer
      const bool elig = size > 0 && c - h_ts >= a.link;
      const unsigned group = __match_any_sync(FULL, elig ? h_dst : kMaxPorts + lane);
      const int r = __shfl_sync(FULL, rr, elig ? h_dst : lane);
      bool win = false;
      if (elig) {
        const unsigned from_r = group >> r;
        win = (from_r ? r + __ffs(from_r) - 1 : __ffs(group) - 1) == lane;
      }
      const int buf = c & 1;
      if (win) {
        win_src[buf][h_dst] = lane;
        win_lat[buf][h_dst] = c - h_ts;
      }
      const unsigned grants = __reduce_or_sync(FULL, win ? 1u << h_dst : 0u);
      __syncwarp();
      // deliver: egress lanes write the cycle's row, winners pop
      if (real) {
        const bool g = (grants >> lane) & 1u;
        const int s = g ? win_src[buf][lane] : -1;
        const long long o = static_cast<long long>(c) * ports + lane;
        a.granted[o] = g;
        a.src[o] = s;
        a.lat[o] = g ? win_lat[buf][lane] : 0;
        if (g) rr = s + 1 == ports ? 0 : s + 1;
      }
      delivered += __popc(grants);
      if (win) {
        --size;
        head = head + 1 == a.depth ? 0 : head + 1;
        if (size > 0) {
          const int2 f = ring[head];
          h_ts = f.x;
          h_dst = f.y;
        }
      }
    }
  }
  const bool any_overflow = __any_sync(FULL, overflow);
  if (lane == 0) {
    a.status[0] = delivered;
    a.status[1] = any_overflow;
    a.status[2] = bundles;
  }
}


// The block route: thread i owns ports i, i + blockDim.x, ...; table_global
// is the port table's global scratch, or null (in shared memory).
__global__ void __launch_bounds__(kWideThreads, 1)
    noc_switch_wide_kernel(const SwitchArgs a, int32_t* table_global) {
  extern __shared__ int4 wide_shared[];
  __shared__ int32_t delivered_sm;
  const int ports = a.ports, tid = threadIdx.x, nt = blockDim.x;
  const int rows = wide_stage_rows(ports);
  int32_t* table = table_global ? table_global : reinterpret_cast<int32_t*>(wide_shared);
  int2* rings = a.fifo_global
                    ? a.fifo_global
                    : reinterpret_cast<int2*>(reinterpret_cast<char*>(wide_shared) +
                                              (table_global ? 0 : wide_table_bytes(ports)));
  int32_t* head = table + kHead * ports;
  int32_t* size = table + kSize * ports;
  int32_t* h_ts = table + kHeadTs * ports;
  int32_t* h_dst = table + kHeadDst * ports;
  int32_t* rr = table + kPointer * ports;
  int32_t* bid = table + kBid * ports;        // an egress's least key, ports if none
  int32_t* winner = table + kWinner * ports;  // an egress's granted ingress, -1 if none
  int32_t* stage = table + kPortFields * ports;
  const long long sched_end = a.t_rows * ports;
  for (int p = tid; p < ports; p += nt) {
    head[p] = size[p] = h_ts[p] = h_dst[p] = rr[p] = 0;
    bid[p] = ports;
    winner[p] = -1;
  }
  if (tid == 0) delivered_sm = 0;
  int overflow = 0, granted_here = 0, bundles = 0;
  int staged = -rows;  // first cycle of the staged rows

  for (int b = 0; b < a.n_chunks; ++b) {
    if (granted_here) atomicAdd(&delivered_sm, granted_here);
    granted_here = 0;
    __syncthreads();
    if (delivered_sm >= a.total) break;
    const long long c0 = static_cast<long long>(b) * a.bundle;
    if (c0 >= a.h_pad) {  // the rest are padding bundles: started, no-ops
      bundles = a.n_chunks;
      break;
    }
    ++bundles;
    const int c_end = static_cast<int>(min(c0 + a.bundle, static_cast<long long>(a.h_pad)));
    for (int c = static_cast<int>(c0); c < c_end; ++c) {
      if (c >= staged + rows) {
        __syncthreads();
        staged = c;
        const long long base = static_cast<long long>(c) * ports;
        for (long long i = tid; i < static_cast<long long>(rows) * ports; i += nt) {
          stage[i] = base + i < sched_end ? __ldg(a.dests + base + i) : -1;
        }
        __syncthreads();
      }
      const int32_t* row = stage + static_cast<long long>(c - staged) * ports;
      // inject, then post each eligible head's rotation key to its egress
      for (int p = tid; p < ports; p += nt) {
        const int d = row[p];
        int sz = size[p];
        if (d >= 0) {
          if (sz < a.depth) {
            int pos = head[p] + sz;
            if (pos >= a.depth) pos -= a.depth;
            rings[static_cast<long long>(p) * a.depth + pos] = make_int2(c, d);
            if (sz == 0) {
              h_ts[p] = c;
              h_dst[p] = d;
            }
            size[p] = ++sz;
          } else {
            overflow = 1;
          }
        }
        if (sz > 0 && c - h_ts[p] >= a.link) {
          const int e = h_dst[p];
          int key = p - rr[e];
          if (key < 0) key += ports;
          atomicMin(&bid[e], key);
        }
      }
      __syncthreads();
      // grant: each egress's least key names its winner
      for (int e = tid; e < ports; e += nt) {
        const int key = bid[e];
        const long long o = static_cast<long long>(c) * ports + e;
        if (key < ports) {
          int w = key + rr[e];
          if (w >= ports) w -= ports;
          a.granted[o] = true;
          a.src[o] = w;
          a.lat[o] = c - h_ts[w];
          rr[e] = w + 1 == ports ? 0 : w + 1;
          bid[e] = ports;
          winner[e] = w;
          ++granted_here;
        } else {
          a.granted[o] = false;
          a.src[o] = -1;
          a.lat[o] = 0;
          winner[e] = -1;
        }
      }
      __syncthreads();
      // deliver: winners pop
      for (int p = tid; p < ports; p += nt) {
        int sz = size[p];
        if (sz > 0 && c - h_ts[p] >= a.link && winner[h_dst[p]] == p) {
          size[p] = --sz;
          const int hd = head[p] + 1 == a.depth ? 0 : head[p] + 1;
          head[p] = hd;
          if (sz > 0) {
            const int2 f = rings[static_cast<long long>(p) * a.depth + hd];
            h_ts[p] = f.x;
            h_dst[p] = f.y;
          }
        }
      }
    }
  }
  if (granted_here) atomicAdd(&delivered_sm, granted_here);
  const int any_overflow = __syncthreads_or(overflow);
  if (tid == 0) {
    a.status[0] = delivered_sm;
    a.status[1] = any_overflow != 0;
    a.status[2] = bundles;
  }
}

}  // namespace

// The routes' bounds (kernels/noc/kernel.py): the one-warp route's most
// ports, the block route's most threads and staged schedule entries.
extern "C" int noc_warp_ports() { return kMaxPorts; }
extern "C" int noc_wide_threads() { return kWideThreads; }
extern "C" int noc_stage_ints() { return STAGE_INTS; }

// The block route's port table bytes (kernels/noc/kernel.py::table_bytes).
extern "C" long long noc_table_bytes(int ports) { return wide_table_bytes(ports); }

// The largest FIFO rings (bytes) kept in shared memory
// (kernels/noc/kernel.py::SHARED_FIFO_BYTES).
extern "C" int noc_shared_fifo_bytes() { return SHARED_FIFO_BYTES; }

// One simulation: dests (t_rows, ports) int32; fifo a (ports, depth) int2
// scratch or null (the rings in shared memory); table the block route's
// port table scratch (noc_table_bytes) or null (in shared memory; always
// null up to kMaxPorts ports); status (3,) int32; granted (h_pad, ports)
// bool, src and lat (h_pad, ports) int32, all zero on entry.  Up to
// kMaxPorts ports one warp, else one block.
extern "C" int noc_switch_launch(const void* dests, long long t_rows, int ports, int link,
                                 int depth, int total, int h_pad, long long bundle, int n_chunks,
                                 void* fifo, void* table, void* status, void* granted, void* src,
                                 void* lat, void* stream) {
  if (ports < 1 || depth < 1 || link < 0 || total < 0 || h_pad < 1 || bundle < 1 ||
      n_chunks < 1 || t_rows < 0 || (ports <= kMaxPorts && table != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SwitchArgs a;
  a.dests = static_cast<const int32_t*>(dests);
  a.t_rows = t_rows;
  a.ports = ports;
  a.link = link;
  a.depth = depth;
  a.total = total;
  a.h_pad = h_pad;
  a.n_chunks = n_chunks;
  a.bundle = bundle;
  a.fifo_global = static_cast<int2*>(fifo);
  a.status = static_cast<int32_t*>(status);
  a.granted = static_cast<bool*>(granted);
  a.src = static_cast<int32_t*>(src);
  a.lat = static_cast<int32_t*>(lat);
  const long long ring_bytes = 8LL * ports * depth;
  const auto st = static_cast<cudaStream_t>(stream);
  if (ports <= kMaxPorts) {
    int smem = 0;
    if (fifo == nullptr) {
      if (ring_bytes > SHARED_FIFO_BYTES) return static_cast<int>(cudaErrorInvalidValue);
      smem = static_cast<int>(ring_bytes);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            noc_switch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    noc_switch_kernel<<<1, 32, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = (table ? 0 : wide_table_bytes(ports)) + (fifo ? 0 : ring_bytes);
  if (smem > SHARED_FIFO_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        noc_switch_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = (ports + 31) / 32;
  const int threads = warps * 32 > kWideThreads ? kWideThreads : warps * 32;
  noc_switch_wide_kernel<<<1, threads, static_cast<int>(smem), st>>>(
      a, static_cast<int32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* noc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
