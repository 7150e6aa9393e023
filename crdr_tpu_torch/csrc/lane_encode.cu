// E1 — the device wire's lane-interleaved rans32 ENCODER on Hopper (sm_90a),
// plain C interface for ctypes.
//
// A port-only kernel: the JAX package encodes the device wire on the device
// with crdr_tpu/ops/device_rans.py::lane_encode_rounds, a reverse lax.scan
// over the rows of a [T, K] lane grid (no Pallas kernel).  This kernel is
// that scan's serial half; the parallel half (each symbol's slot, low and
// freq laid onto the grid, and the escape fixups) stays in torch gathers and
// cumsums (ops/device_rans.py::lane_encode_operands / lane_fixups), as JAX
// computes it outside its scan.
//
// Semantics (those of ops/device_rans.py::lane_encode_scan, the plain twin):
// lane (b, j) starts at x = 2^16 and walks its grid column last row first.
// At an active entry (freq > 0): if (x >> 16) >= freq, emit the word
// x & 0xFFFF and shift x down by 16 (the state invariant x < 2^32 makes one
// word a symbol enough); then q = x / freq, x = (q << 16) + (x - q*freq) +
// low, in native uint32.  An inactive entry (freq 0) leaves x as it was.
// The word emitted at row t lands at 2 + #(emissions at rows < t): walk
// emission e (counting from the last row) is written at cap - 1 - e while
// walking, and the block of E words is moved down to [2, 2 + E) after it.
// Words 0 and 1 hold the final state's halves, the rest of the lane is
// zeroed, and lens = 2 + E.  Integer arithmetic only, so the kernel equals
// the twin, JAX and the host C++ lane coder (runtime/lane_rans.py) exactly.
//
// Bound.  A batch-4 flagship y encode (K 128, T 3,840, 491,520 symbols an
// image) moves ~24 MB (low and freq in, the words out) and does a few tens
// of integer operations a symbol: ~7 us at 3.35 TB/s.  Neither binds: each
// lane is a chain of T dependent steps (a division by freq on it), and the
// wire fixes the lanes at N x K = 512, so the time is T x one step's
// latency.
//
// Design (v1: a simple kernel that is right).  One thread per lane, x in a
// register.  The loads of low and freq do not depend on x (neighbouring
// lanes read neighbouring addresses): they are issued 8 rows at a time, the
// next 8 in flight while this 8's steps run, so a step waits on its own
// arithmetic, not on L2.  The lane's words are written lane-contiguous
// (stride T+2 between lanes), off the chain, and moved into place 8 at a
// time.  No atomics and no communication between lanes: every launch gives
// the same bits.  (A first build with one load pair a step and a
// word-at-a-time move took 1.59 ms a flagship y call on an H100; PERF.md.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kBlock = 8;  // grid rows whose low / freq are loaded together

// low / freq of the kBlock rows t0, t0 - 1, ... of one lane (freq 0 below
// row 0: inactive)
__device__ __forceinline__ void load_rows(const int* __restrict__ lo_p,
                                          const int* __restrict__ fq_p,
                                          int t0, int k, uint32_t* lo,
                                          uint32_t* fq) {
#pragma unroll
  for (int u = 0; u < kBlock; ++u) {
    const int t = t0 - u;  // the same in every lane: no divergence
    if (t >= 0) {
      const long long at = static_cast<long long>(t) * k;
      fq[u] = static_cast<uint32_t>(__ldg(fq_p + at));
      lo[u] = static_cast<uint32_t>(__ldg(lo_p + at));
    } else {
      fq[u] = 0u;
      lo[u] = 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    lane_encode_kernel(const int* __restrict__ low,
                       const int* __restrict__ freq, int n, int t_steps,
                       int k, int* __restrict__ words,
                       int* __restrict__ lens) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n * k) return;
  const int b = lane / k, j = lane - b * k;
  const long long cap = static_cast<long long>(t_steps) + 2;
  int* out = words + lane * cap;  // [n, k, cap]: lane = b * k + j
  const int* lo_p = low + static_cast<long long>(b) * t_steps * k + j;
  const int* fq_p = freq + static_cast<long long>(b) * t_steps * k + j;
  uint32_t x = 1u << 16;
  int e = 0;
  // the walk, kBlock rows at a time, the next block's loads in flight
  // while this one's steps run
  uint32_t lo[kBlock], fq[kBlock], lo_n[kBlock], fq_n[kBlock];
  load_rows(lo_p, fq_p, t_steps - 1, k, lo, fq);
  for (int t0 = t_steps - 1; t0 >= 0; t0 -= kBlock) {
    load_rows(lo_p, fq_p, t0 - kBlock, k, lo_n, fq_n);
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      if (fq[u] == 0u) continue;  // inactive: past the round's end
      if ((x >> 16) >= fq[u]) {
        out[cap - 1 - e] = static_cast<int>(x & 0xFFFFu);
        ++e;
        x >>= 16;
      }
      const uint32_t q = x / fq[u];
      x = (q << 16) + (x - q * fq[u]) + lo[u];
    }
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      lo[u] = lo_n[u];
      fq[u] = fq_n[u];
    }
  }
  // walk emission i (row descending) sits at cap - 1 - i and belongs at
  // 2 + (e - 1 - i): one shift down by t_steps - e, ascending, kBlock words
  // loaded before they are stored (a source is never below its
  // destination, so a block's stores cannot clobber a later block's loads)
  const long long shift = static_cast<long long>(t_steps) - e;
  int i = 0;
  for (; i + kBlock <= e; i += kBlock) {
    int v[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) v[u] = out[2 + i + u + shift];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) out[2 + i + u] = v[u];
  }
  for (; i < e; ++i) out[2 + i] = out[2 + i + shift];
  for (long long z = 2 + e; z < cap; ++z) out[z] = 0;
  out[0] = static_cast<int>(x >> 16);
  out[1] = static_cast<int>(x & 0xFFFFu);
  lens[lane] = 2 + e;
}

}  // namespace

extern "C" {

// The serial walk of n images x k lanes over t_steps grid rows.
// low / freq [n, t_steps, k] int32 (freq 0 at an inactive entry), words
// [n, k, t_steps + 2] int32 (16-bit values, written whole), lens [n, k]
// int32.  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
int crdr_lane_encode(const int* low, const int* freq, int n, int t_steps,
                     int k, int* words, int* lens, void* stream) {
  if (n < 0 || t_steps < 0 || k <= 0 ||
      static_cast<long long>(n) * k > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n * k + kThreads - 1) / kThreads;
  lane_encode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      low, freq, n, t_steps, k, words, lens);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
