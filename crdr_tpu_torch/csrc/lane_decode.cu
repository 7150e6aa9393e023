// K2 — one round of the lane-interleaved rans32 decoder on Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel crdr_tpu/ops/pallas_lane_decode.py
// (pallas_lane_decode_round, body _kernel).  Semantics are those of
// crdr_tpu/ops/device_rans.py (_decode_step_core, lane_decode_round_instep):
// for image b and lane j, step t decodes flat symbol p = t*K + j of the round
// while p < m: fetch the CDF row idx[b, p]; s = #{q < len-1 : cdf[q] <=
// (x & 0xFFFF)} - 1; value = s + offset; x' = freq * (x >> 16) + (x & 0xFFFF)
// - low with freq = cdf[s+1] - cdf[s], low = cdf[s]; when x' < 2^16 one
// 16-bit word is shifted in from the lane's stream at min(ptr, W-1) and ptr
// advances.  All arithmetic is native uint32, so the kernel is exact by
// construction: it equals the plain twin (ops/device_rans.py) and the host C++
// lane decoder to the bit.
//
// Bound.  A batch-4 flagship y round (K 128 lanes, m 49,152 symbols per
// image) moves ~1.8 MB and does ~5 M integer operations: under 1 us at the
// card's rates.  Neither binds.  Each lane is a chain of T = m/K = 384
// dependent steps (the state x of step t+1 is a function of step t's), and
// the lanes' count is fixed by the wire format, so a round is N*K threads
// running T steps, bound by the latency of one step's dependent chain.
//
// Design (v2).  One thread per lane with x in a register, one block per
// image, the T steps a loop in the thread; no atomics, no inter-lane
// communication, so the output is the same on every launch and at every
// batch.  What sits on a step's chain is only what depends on x:
//   mod = x & 0xFFFF -> the row's coarse lookup (two u16 loads) -> a
//   binary search inside the bucket (on the flagship y table 0.54 levels
//   for a uniform slot, 0.002 on a recorded decode round) -> low and freq
//   (two independent loads) -> the update.
// That is 2 dependent shared-memory loads (plus one a search level) and
// ~15 dependent integer operations a step.  Everything else is loaded ahead:
// * The table is kernel-ready (ops/lane_decode.py::prepare_lane_table, built
//   once at codec_setup): one contiguous int32 buffer of per-row headers
//   (start, len, offset), a per-row lookup of 2^b + 1 u16 counts over the
//   16-bit slot (entry u = #{q < len-1 : cdf[q] <= u * 2^(16-b)}, the last
//   len - 1; the count for any mod in bucket u lies in [lk[u], lk[u+1]]
//   because it never falls as mod grows) and the used CDF entries packed by
//   rows.  The prologue is one bulk copy (cp.async.bulk, the TMA's 1-D
//   copy) of the buffer into shared memory, completing on an mbarrier, with
//   no scan and no per-row loop; the lane rings below fill meanwhile.
// * The search reads shared memory through ld.shared: where the table lives
//   is a template parameter (kSmem), never a generic pointer.  A table that
//   does not fit (with the rings) is read from global memory (L2) by the
//   same code, kSmem = false.
// * Each lane's next D-1 stream words and the CDF rows of its next D steps
//   (D = kRing = 8) sit in two rings in shared memory (slot-major, [D][K]:
//   conflict-free), refilled by 4-byte cp.async D steps ahead: one commit
//   group a step, so cp.async.wait_group<D-2> at the top of step t
//   guarantees the idx of step t+1 and the word at ptr have landed (a lane
//   consumes at most one word a step, so a word is requested at least D-1
//   steps before it is read).
//   Each thread copies only its own slots: no barrier after the prologue.
//   The word is read at the top of every step, off the chain; the next
//   step's row header is read one step ahead.
// kSmem comes from ops/lane_decode.py::lane_plan, a function of the shapes
// and the card's shared-memory limit: the rings of 8 take 64 B a lane, so
// the flagship y table fits beside them at every K up to 1024.  The lookup
// width (kLookupBits = 8: 256 buckets of 256 slots) is fixed at compile
// time, as the wrapper's LOOKUP_BITS.  Escape fixups are applied after the
// kernel, in torch (ops/device_rans.apply_fixups), as JAX does.
//
// What it takes (PERF.md has the runs): a batch-4 flagship y round ~0.052
// ms on an H100, ~250 cycles a step and ~3.5 us of prologue.  A step issues
// ~90 instructions in order around its two dependent shared loads; that
// stream, more likely than any load, now sets the pace (not separated).
// v1 staged the dense table row by row in every block (a scan and 64
// gathers, 46 us), searched through a generic pointer with a full binary
// search (the warp waits for its deepest lane, 12 levels), and loaded the
// renorm word one renorm ahead and the next row one step ahead from global
// memory: 0.2270 ms a y round.  Tried and dropped (no gain or slower):
// rings of 16 (2-3% slower than 8 on the y round), a 9-bit lookup,
// loading low / freq before the bucket test, the renorm as a select, the
// lookup's row offset in the header, unrolling by 2, and lane-major rings
// unrolled by D (the compiler re-derived the thread index each step).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kLaneL = 1u << 16;
constexpr int kRing = 8;         // steps of words and rows staged ahead
constexpr int kLookupBits = 8;   // 2^8 buckets a row (LOOKUP_BITS)
constexpr int kBulkChunk = 32768;  // bytes per bulk copy of the prologue

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared (TMA), completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 4-byte async copy global -> shared; src_bytes 0 writes a zero, reads
// nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const int* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kernel-ready table, in shared memory (ld.shared) or global memory
// (ld.global.nc).  Layout (int32 units): [rows][4] headers (start, len,
// offset, 0), the u16 lookup [rows][2^kLookupBits + 1], the packed
// entries.
template <bool kSmem>
struct Table;

template <>
struct Table<true> {
  uint32_t base;  // shared-memory address of the buffer
  __device__ __forceinline__ int4 header(int r) const {
    int4 h;
    asm("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(h.x), "=r"(h.y), "=r"(h.z), "=r"(h.w)
        : "r"(base + 16u * r));
    return h;
  }
  __device__ __forceinline__ int entry(int i) const {
    int v;
    asm("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(base + 4u * i));
    return v;
  }
  __device__ __forceinline__ int lookup(uint32_t lk_byte, int i) const {
    uint16_t v;
    asm("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(base + lk_byte + 2u * i));
    return v;
  }
};

template <>
struct Table<false> {
  const int* base;
  __device__ __forceinline__ int4 header(int r) const {
    return __ldg(reinterpret_cast<const int4*>(base) + r);
  }
  __device__ __forceinline__ int entry(int i) const { return __ldg(base + i); }
  __device__ __forceinline__ int lookup(uint32_t lk_byte, int i) const {
    return __ldg(reinterpret_cast<const unsigned short*>(
                     reinterpret_cast<const char*>(base) + lk_byte) +
                 i);
  }
};

// Shared memory: [mbarrier, 16 B][idx ring D x kp ints][word ring D x kp
// ints][the table, kSmem only]; kp = blockDim.x (K rounded up to a warp).
template <bool kSmem>
__global__ void __launch_bounds__(1024) lane_decode_round_kernel(
    const int64_t* __restrict__ states_in, const int* __restrict__ ptrs_in,
    const int* __restrict__ words, int k, int w,
    const int* __restrict__ idx, int idx_stride, int m,
    const int* __restrict__ tab, int tab_ints, int rows,
    int* __restrict__ vals, int64_t* __restrict__ states_out,
    int* __restrict__ ptrs_out) {
  constexpr int D = kRing;
  static_assert(D >= 4 && (D & (D - 1)) == 0, "D: a power of two >= 4");
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = threadIdx.x;
  const int kp = blockDim.x;
  const int b = blockIdx.x;
  const uint32_t bar = smem_u32(smem);
  const uint32_t s_idx = bar + 16;
  const uint32_t s_word = s_idx + 4u * D * kp;
  const uint32_t s_tab = s_word + 4u * D * kp;

  if (kSmem) {  // the prologue: one bulk copy of the whole table
    if (j == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (j == 0) {
      const uint32_t bytes = 4u * tab_ints;
      mbar_expect_tx(bar, bytes);
      for (uint32_t o = 0; o < bytes; o += kBulkChunk)
        bulk_load(s_tab + o, reinterpret_cast<const char*>(tab) + o,
                  min(bytes - o, (uint32_t)kBulkChunk), bar);
    }
  }
  if (j >= k) return;

  const size_t lane = (size_t)b * k + j;
  uint32_t x = static_cast<uint32_t>(states_in[lane]);
  int pt = ptrs_in[lane];
  const int wmax = w - 1;
  const int* wrow = words + lane * w;
  const int* irow = idx + (size_t)b * idx_stride;
  int* vrow = vals + (size_t)b * m;
  const int steps = j < m ? (m - 1 - j) / k + 1 : 0;  // p = j + t*k < m

  // fill the rings while the table lands: group g holds the row of step g
  // and (g < D-1) the word at position pt + g
#pragma unroll
  for (int g = 0; g < D; ++g) {
    const int p = j + g * k;
    cp_async4(s_idx + 4u * (g * kp + j), irow + (p < m ? p : 0),
              p < m ? 4 : 0);
    if (g < D - 1) {
      const int q = pt + g;
      cp_async4(s_word + 4u * ((q & (D - 1)) * kp + j),
                wrow + min(q, wmax), 4);
    }
    cp_async_commit();
  }
  Table<kSmem> t_;
  if constexpr (kSmem) {
    mbar_wait(bar, 0);
    // the table's loads are plain asm (no side effects): their base comes
    // out of a volatile move after the wait, so none can be hoisted above it
    asm volatile("mov.b32 %0, %1;\n" : "=r"(t_.base) : "r"(s_tab) : "memory");
  } else {
    t_.base = tab;
  }
  const uint32_t lk_byte = 16u * rows;        // the lookup, in bytes
  constexpr int lk_stride = (1 << kLookupBits) + 1;  // u16 entries a row
  constexpr int shift = 16 - kLookupBits;

  cp_async_wait<D - 2>();  // groups 0 and 1 have landed
  int r = 0;
  if (steps > 0) {
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(s_idx + 4u * j));
  }
  int4 h = t_.header(r);
  for (int t = 0; t < steps; ++t) {
    // the row of step t+1 and the word at pt have landed (see the note)
    cp_async_wait<D - 2>();
    int word, r1 = 0;
    asm volatile("ld.shared.b32 %0, [%1];\n"
                 : "=r"(word)
                 : "r"(s_word + 4u * ((pt & (D - 1)) * kp + j)));
    if (t + 1 < steps)
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(r1)
                   : "r"(s_idx + 4u * (((t + 1) & (D - 1)) * kp + j)));
    const int4 h1 = t_.header(r1);

    // the chain: lookup, search inside the bucket, low / freq, update
    const uint32_t mod = x & 0xFFFFu;
    const int u = r * lk_stride + static_cast<int>(mod >> shift);
    int lo = t_.lookup(lk_byte, u), hi = t_.lookup(lk_byte, u + 1);
    const int start = h.x;
    while (lo < hi) {  // count of entries <= mod, within [lo, hi]
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(t_.entry(start + mid)) <= mod)
        lo = mid + 1;
      else
        hi = mid;
    }
    const uint32_t low =
        lo > 0 ? static_cast<uint32_t>(t_.entry(start + lo - 1)) : 0u;
    const uint32_t freq = static_cast<uint32_t>(t_.entry(start + lo)) - low;
    vrow[j + t * k] = lo - 1 + h.z;
    x = freq * (x >> 16) + mod - low;

    // refill: the row of step t + D into this step's slot (read at t-1)
    const int p2 = j + (t + D) * k;
    cp_async4(s_idx + 4u * ((t & (D - 1)) * kp + j), irow + (p2 < m ? p2 : 0),
              p2 < m ? 4 : 0);
    if (x < kLaneL) {
      x = (x << 16) | static_cast<uint32_t>(word);
      // the word D-1 positions ahead, into the slot of position pt - 1
      // (read at an earlier step)
      const int q = pt + D - 1;
      cp_async4(s_word + 4u * ((q & (D - 1)) * kp + j), wrow + min(q, wmax),
                4);
      ++pt;
    }
    cp_async_commit();
    r = r1;
    h = h1;
  }
  cp_async_wait<0>();
  states_out[lane] = static_cast<int64_t>(x);
  ptrs_out[lane] = pt;
}

template <bool kSmem>
int launch(const int64_t* states_in, const int* ptrs_in, const int* words,
           int n, int k, int w, const int* idx, int idx_stride, int m,
           const int* tab, int tab_ints, int rows, int* vals,
           int64_t* states_out, int* ptrs_out, int threads, size_t smem,
           cudaStream_t stream) {
  auto kern = lane_decode_round_kernel<kSmem>;
  // the block's shared-memory cap, raised once per device to the card's
  // opt-in maximum (227 KB on an H100)
  static int cached[64] = {0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cached[device] == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached[device] = v;
  }
  if (smem > (size_t)cached[device])
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<n, threads, smem, stream>>>(states_in, ptrs_in, words, k, w, idx,
                                     idx_stride, m, tab, tab_ints, rows, vals,
                                     states_out, ptrs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One decode round over n images x k lanes.
// states_in/out [n, k] int64 (uint32 values), ptrs_in/out [n, k] int32,
// words [n, k, w] int32 (16-bit values), idx [n, >= m] int32 (row stride
// idx_stride), tab the kernel-ready table of `rows` CDF rows and a
// 2^kLookupBits-bucket lookup (tab_ints int32, a multiple of 4, 16-byte
// aligned), vals [n, m] int32.  in_smem: the plan (ops/lane_decode.py::
// lane_plan).  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
int crdr_lane_decode_round(const int64_t* states_in, const int* ptrs_in,
                           const int* words, int n, int k, int w,
                           const int* idx, int idx_stride, int m,
                           const int* tab, int tab_ints, int rows, int in_smem,
                           int* vals, int64_t* states_out, int* ptrs_out,
                           void* stream) {
  if (n <= 0 || k <= 0 || k > 1024 || w <= 0 || m < 0 || idx_stride < m ||
      rows <= 0 || tab_ints <= 0 || tab_ints % 4 != 0 ||
      4LL * rows + ((long long)rows * ((1 << kLookupBits) + 1) + 1) / 2 >
          tab_ints ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;  // the ring stride kp
  // as ops/lane_decode.py::lane_plan counts it
  const size_t smem = 16 + 8ull * kRing * threads +
                      (in_smem ? 4ull * tab_ints : 0ull);
  auto s = static_cast<cudaStream_t>(stream);
  return in_smem
             ? launch<true>(states_in, ptrs_in, words, n, k, w, idx,
                            idx_stride, m, tab, tab_ints, rows, vals,
                            states_out, ptrs_out, threads, smem, s)
             : launch<false>(states_in, ptrs_in, words, n, k, w, idx,
                             idx_stride, m, tab, tab_ints, rows, vals,
                             states_out, ptrs_out, threads, smem, s);
}

}  // extern "C"
