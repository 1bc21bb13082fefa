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
// version's: tests/test_torch_noc_kernel.py holds a numpy emulation of the
// warp's per-cycle walk below (the spec to keep in step with this file)
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
// 3.35 TB/s.  So one warp walks one switch, and every cycle's state stays
// in registers and shared memory:
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
// Every cycle, inject cycle and latency is below h_pad < 2**31 (the
// wrapper checks), so int32 is exact; the eligibility test is c - inject
// >= link, which cannot overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPorts = 32;                  // a lane a port
constexpr int STAGE_CYCLES = 64;               // schedule rows staged at once
constexpr int SHARED_FIFO_BYTES = 200 * 1024;  // largest FIFO ring kept on chip
constexpr unsigned FULL = 0xffffffffu;

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

}  // namespace

// The most ports the kernel takes (kernels/noc/kernel.py::MAX_PORTS).
extern "C" int noc_max_ports() { return kMaxPorts; }

// The largest FIFO rings (bytes) kept in shared memory
// (kernels/noc/kernel.py::SHARED_FIFO_BYTES).
extern "C" int noc_shared_fifo_bytes() { return SHARED_FIFO_BYTES; }

// One simulation, one warp: dests (t_rows, ports) int32; fifo a (ports,
// depth) int2 scratch or null (the rings in shared memory); status (3,)
// int32; granted (h_pad, ports) bool, src and lat (h_pad, ports) int32,
// all zero on entry.
extern "C" int noc_switch_launch(const void* dests, long long t_rows, int ports, int link,
                                 int depth, int total, int h_pad, long long bundle, int n_chunks,
                                 void* fifo, void* status, void* granted, void* src, void* lat,
                                 void* stream) {
  if (ports < 1 || ports > kMaxPorts || depth < 1 || link < 0 || total < 0 || h_pad < 1 ||
      bundle < 1 || n_chunks < 1 || t_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ring_bytes = 8LL * ports * depth;
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
  noc_switch_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* noc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
