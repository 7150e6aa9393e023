// E1 — the device wire's lane-interleaved rans32 ENCODER on Hopper (sm_90a),
// plain C interface for ctypes.
//
// A port-only kernel: the JAX package encodes the device wire on the device
// with crdr_tpu/ops/device_rans.py::lane_encode_rounds, a reverse lax.scan
// over the rows of a [T, K] lane grid (no Pallas kernel), after gathers that
// resolve each symbol's slot.  This kernel is both: it resolves each
// symbol's slot itself and walks the lanes.  The escape fixups (a cumsum
// over the escape flags it writes) stay in torch
// (ops/device_rans.py::lane_fixups), as JAX computes them outside its scan.
//
// Semantics (those of ops/device_rans.py::lane_encode_walk, the plain twin):
// grid entry (t, j) of image b encodes the symbol at pos[t, j] of sym / idx
// (pos is the grid composed with the codec's lane permutation,
// ops/device_rans.py::lane_positions), whose lane-order index is grid[t, j]
// (-1: inactive).  Its slot: folded = sym - offset[row]; an escape when
// folded < 0 or folded >= cdf_len[row] - 2, whose slot is then
// cdf_len[row] - 2; esc[b, grid[t, j]] says which.  Lane (b, j) starts at
// x = 2^16 and walks its grid column last row first.  At an active entry
// with freq > 0: if (x >> 16) >= freq, emit the word x & 0xFFFF and shift x
// down by 16 (the state invariant x < 2^32 makes one word a symbol enough);
// then q = x / freq, x = (q << 16) + (x - q*freq) + low, in native uint32.
// The word emitted at row t lands at 2 + #(emissions at rows < t): walk
// emission e (counting from the last row) is written at cap - 1 - e while
// walking, and the block of E words is moved down to [2, 2 + E) after it.
// Words 0 and 1 hold the final state's halves, the rest of the lane is
// zeroed, and lens = 2 + E.  Integer arithmetic only, so the kernel equals
// the twin, JAX and the host C++ lane coder (runtime/lane_rans.py) exactly.
//
// Bound.  The function of a batch-4 flagship y encode (K 128, T 3,840,
// 491,520 symbols an image) reads ~20 MB (the symbols, their rows, the two
// position tables, the dense CDF table) and writes ~8 MB (the words, the
// lengths, the fixups), and does a few tens of integer operations a symbol:
// ~8.5 us at 3.35 TB/s (chip_smoke.py's e1_bound; this design's 16-byte
// table entries and escape flags are not counted).  Neither binds: each
// lane is a chain of T dependent steps, and the wire fixes the lanes at
// N x K = 512, so the time is T x one step's latency.
//
// What held v1 back (PR 9: one thread a lane reading low and freq, laid
// onto the grid by ~15 torch passes, 8 rows ahead; 0.7331 ms a flagship y
// call on an H100, and 1.1 ms of torch glue around it): its step waits on
// its loads and on x / freq, a 32-bit division the compiler expands into a
// long dependent sequence on the chain of x.  Measured with clock64() on
// its walk (a measurement build of v1, PERF.md, PR 18): v1 255 cycles a step;
// with the division replaced by the reciprocal below 191; with every
// operand read from one precomputed 16-byte entry a step 179: the loads, 8
// rows ahead in one thread, were most of it.  A first v2 that resolved the
// slots in the walking thread itself (a register pipeline of 8-row blocks)
// took 0.9856 ms: three dependent loads a step cannot be hidden by one
// thread.
//
// Design (v2).  A block serves 32 lanes: one walking warp, one thread a
// lane, x in a register, and 8 producer warps that resolve the lanes' grid
// entries into a ring of shared memory ahead of it.
// * The division is a multiply by an exact reciprocal: m = ceil(2^48 /
//   freq) from a table built once per CDF table (ops/device_rans.py::
//   encode_table: low, freq and m's halves, 16 bytes an entry), and
//   q = (x * (m >> 32) + umulhi(x, m & 0xFFFFFFFF)) >> 16 = floor(x * m /
//   2^48) = x / freq for every x < 2^32 and freq <= 2^16 (reciprocal48's
//   note; tests/test_torch_lane_encode.py checks it at every freq).  A step
//   is then a compare, a select, three multiplies and adds and a shift.
// * A producer warp takes a chunk of 16 grid rows for the block's 32 lanes
//   (warp p the chunks p, p + 8, ...): a thread a lane, it loads the 16
//   rows' grid and pos, then their symbols and rows (where the codec
//   produced them: no permuted copy), then each slot's table entry (cdf_len
//   and offset from shared memory), 16 loads in flight at each stage; it
//   writes each escape flag to device memory and the 16-byte entries to the
//   chunk's slot of the ring (16 slots, 128 KB), then arrives on the slot's
//   full mbarrier.  Eight chunks are resolved at once.
// * The walking warp waits on each chunk's full mbarrier in turn, walks its
//   16 rows from shared memory (ld.shared only on the chain), and arrives on
//   the slot's empty mbarrier, which the producer waits on before it reuses
//   the slot.
// * The words are written lane-contiguous (stride T+2 between lanes), off
//   the chain; after the walk the whole block moves each lane's words into
//   place and zero-fills the rest, a warp a lane, 32 words an instruction.
// No atomics and no communication between lanes' states: every launch gives
// the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;                      // lanes a block
constexpr int kProducers = 8;                   // resolving warps a block
constexpr int kThreads = kLanes * (1 + kProducers);
constexpr int kRows = 16;                       // grid rows a chunk
constexpr int kSlots = 2 * kProducers;          // chunks in the ring
constexpr int kMaxRows = 4096;                  // CDF rows whose header fits
constexpr int kMaxDev = 64;
constexpr size_t kRingBytes = sizeof(int4) * kSlots * kRows * kLanes;
constexpr size_t kFixedBytes = kRingBytes + 2 * kSlots * sizeof(uint64_t) +
                               kLanes * sizeof(int);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive, releasing this thread's earlier shared-memory writes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads, 1)
    lane_encode_kernel(const int* __restrict__ sym, long long sym_sn,
                       const int* __restrict__ idx, long long idx_sn,
                       const int* __restrict__ grid,
                       const int* __restrict__ pos,
                       const int4* __restrict__ etab,
                       const int* __restrict__ cdf_len,
                       const int* __restrict__ offset, int rows, int big_l,
                       int n, int m, int t_steps, int k,
                       int* __restrict__ words, int* __restrict__ lens,
                       unsigned char* __restrict__ esc) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);  // [kSlots][kRows][kLanes]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kSlots;
  int* emitted = reinterpret_cast<int*>(empty + kSlots);  // [kLanes]
  int2* row_info = reinterpret_cast<int2*>(smem + kFixedBytes);  // [rows]

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int r = threadIdx.x; r < rows; r += kThreads)
    row_info[r] = make_int2(cdf_len[r], offset[r]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, kLanes);
      mbar_init(empty + s, kLanes);
    }
  }
  __syncthreads();

  const int lanes = n * k;
  const long long cap = static_cast<long long>(t_steps) + 2;
  const int chunks = (t_steps + kRows - 1) / kRows;
  const int lane = blockIdx.x * kLanes + l;
  const bool live = lane < lanes;
  const int b = live ? lane / k : 0, j = live ? lane - b * k : 0;

  if (warp == 0) {  // the walk
    int* out = words + lane * cap;  // [n, k, cap]: lane = b * k + j
    uint32_t x = 1u << 16;
    int e = 0;
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % kSlots;
      mbar_wait(full + slot, (c / kSlots) & 1);
      const int4* ent = ring + slot * kRows * kLanes + l;
      int4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) v[u] = ent[u * kLanes];
      mbar_arrive(empty + slot);  // the chunk is in registers
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const uint32_t f = static_cast<uint32_t>(v[u].y);
        if (f == 0u) continue;  // inactive: past the round's end
        if ((x >> 16) >= f) {
          out[cap - 1 - e] = static_cast<int>(x & 0xFFFFu);
          ++e;
          x >>= 16;
        }
        // q = x / f = floor(x * m / 2^48), m = ceil(2^48 / f) = (hi, lo)
        const uint32_t q = static_cast<uint32_t>(
            (static_cast<uint64_t>(x) * static_cast<uint32_t>(v[u].w) +
             __umulhi(x, static_cast<uint32_t>(v[u].z))) >> 16);
        // (q << 16) + (x - q * f) + low
        x += q * ((1u << 16) - f) + static_cast<uint32_t>(v[u].x);
      }
    }
    emitted[l] = e;
    if (live) {
      out[0] = static_cast<int>(x >> 16);
      out[1] = static_cast<int>(x & 0xFFFFu);
      lens[lane] = 2 + e;
    }
  } else {  // resolve chunks warp - 1, + kProducers, ... for lane l
    const int* sym_b = sym + b * sym_sn;
    const int* idx_b = idx + b * idx_sn;
    unsigned char* esc_b = esc + static_cast<long long>(b) * m;
    const long long last = static_cast<long long>(rows) * big_l - 1;
    for (int c = warp - 1; c < chunks; c += kProducers) {
      const int slot = c % kSlots, use = c / kSlots;
      int g[kRows], r[kRows], sv[kRows], iv[kRows];
      int4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int t = t_steps - 1 - (c * kRows + u);  // the same in a warp
        g[u] = -1;
        r[u] = 0;
        if (live && t >= 0) {
          const long long at = static_cast<long long>(t) * k + j;
          g[u] = __ldg(grid + at);
          r[u] = __ldg(pos + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        sv[u] = 0;
        iv[u] = 0;
        if (g[u] >= 0) {
          sv[u] = __ldg(sym_b + r[u]);
          iv[u] = __ldg(idx_b + r[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        v[u] = make_int4(0, 0, 0, 0);
        if (g[u] >= 0) {
          const int2 info = row_info[iv[u]];
          const int maxv = info.x - 2;
          const int folded = sv[u] - info.y;
          const bool escaped = folded < 0 || folded >= maxv;
          long long flat = static_cast<long long>(iv[u]) * big_l +
                           (escaped ? maxv : folded);
          flat = flat < 0 ? 0 : (flat > last ? last : flat);
          v[u] = __ldg(etab + flat);
          esc_b[g[u]] = escaped ? 1 : 0;
        }
      }
      if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      int4* dst = ring + slot * kRows * kLanes + l;
#pragma unroll
      for (int u = 0; u < kRows; ++u) dst[u * kLanes] = v[u];
      mbar_arrive(full + slot);
    }
  }
  __syncthreads();  // the walk's words and counts are visible to the block

  // walk emission i (row descending) sits at cap - 1 - i and belongs at
  // 2 + (e - 1 - i): one shift down by t_steps - e, ascending, 32 words
  // loaded before they are stored (a source is never below its
  // destination, so a piece's stores cannot clobber a later piece's loads)
  for (int li = warp; li < kLanes; li += kThreads / 32) {
    const int lane2 = blockIdx.x * kLanes + li;
    if (lane2 >= lanes) break;
    int* out = words + lane2 * cap;
    const int e = emitted[li];
    const long long shift = static_cast<long long>(t_steps) - e;
    for (int i = 0; i < e; i += 32) {
      const int v = i + l < e ? out[2 + i + l + shift] : 0;
      __syncwarp();
      if (i + l < e) out[2 + i + l] = v;
      __syncwarp();
    }
    for (long long z = 2 + e + l; z < cap; z += 32) out[z] = 0;
  }
}

// Raises the kernel's dynamic shared-memory cap once per device.
cudaError_t prepare(size_t bytes) {
  static size_t ready[kMaxDev] = {0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDev) return cudaErrorInvalidDevice;
  if (ready[device] < bytes) {
    e = cudaFuncSetAttribute(lane_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ready[device] = bytes;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Resolve and walk n images x k lanes over t_steps grid rows.  sym / idx
// [n, *] int32 with unit stride along a row and sym_sn / idx_sn elements
// between images (idx_sn 0: one row of CDF rows for every image); grid /
// pos [t_steps, k] int32 (grid: lane-order index or -1; pos: where that
// symbol lies in its image's row); etab [rows, big_l] x 16 bytes
// (encode_table), cdf_len / offset [rows] int32, rows <= 4096; outputs
// words [n, k, t_steps + 2] int32 (16-bit values, written whole), lens
// [n, k] int32, esc [n, m] bytes (0 / 1) by lane-order index.  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// shapes the kernel does not take.
int crdr_lane_encode(const int* sym, long long sym_sn, const int* idx,
                     long long idx_sn, const int* grid, const int* pos,
                     const void* etab, const int* cdf_len,
                     const int* offset, int rows, int big_l, int n, int m,
                     int t_steps, int k, int* words, int* lens,
                     unsigned char* esc, void* stream) {
  if (n < 0 || m < 0 || t_steps < 0 || k <= 0 || rows <= 0 ||
      rows > kMaxRows || big_l <= 0 ||
      static_cast<long long>(n) * k > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t bytes = kFixedBytes + rows * sizeof(int2);
  cudaError_t e = prepare(bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n * k + kLanes - 1) / kLanes;
  lane_encode_kernel<<<blocks, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      sym, sym_sn, idx, idx_sn, grid, pos, static_cast<const int4*>(etab),
      cdf_len, offset, rows, big_l, n, m, t_steps, k, words, lens, esc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
