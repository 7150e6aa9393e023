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
// Bound.  A batch-4 flagship round (K 128 lanes, m 49,152 symbols per image)
// moves ~1.6 MB (idx in, values out, the words it consumes, the table once),
// under 1 us at HBM rate, and does a few million integer operations.  Neither
// binds: each lane is a chain of T = m/K = 384 dependent steps, each a
// ~12-deep dependent binary search in shared memory plus the state update, so
// the round is latency-bound at roughly T x (12 + a few) x shared-memory
// latency, ~0.1 ms, whatever the card's rates.  The lanes' count is fixed by
// the wire format (a persistence format), so the parallelism is N*K threads.
//
// Design.  One thread per lane with the state in a register, one block per
// image (grid N, block K), the T steps a loop inside the thread.  The CDF
// table is packed by rows into shared memory (ragged: the flagship y table is
// [64, 3133] dense, 0.8 MB, but 27,256 used entries, 109 KB) with a row-start
// array, so the search's dependent loads hit shared memory; a table whose used
// entries do not fit the block's shared memory is read from global memory
// (it stays in L2) by the same code.  The next symbol's row index and the
// lane's next stream word are loaded one step ahead, so no global load sits
// on the dependent chain.  No one-hot matmul, no int32 emulation of uint32,
// no per-round word window: those were the TPU's.  Escape fixups are applied
// after the kernel, in torch (ops/device_rans.apply_fixups), as JAX does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kLaneL = 1u << 16;

// Shared-memory layout (ints): [start R][len R][off R][total 1][entries ...]
__global__ void lane_decode_round_kernel(
    const int64_t* __restrict__ states_in, const int* __restrict__ ptrs_in,
    const int* __restrict__ words, int k, int w,
    const int* __restrict__ idx, int idx_stride, int m,
    const int* __restrict__ cdf, int rows, int cols,
    const int* __restrict__ cdf_len, const int* __restrict__ cdf_off,
    int* __restrict__ vals, int64_t* __restrict__ states_out,
    int* __restrict__ ptrs_out, int smem_ints) {
  extern __shared__ int smem[];
  int* s_start = smem;
  int* s_len = smem + rows;
  int* s_off = smem + 2 * rows;
  int* s_total = smem + 3 * rows;
  int* s_tab = smem + 3 * rows + 1;
  const int b = blockIdx.x;
  const int j = threadIdx.x;

  for (int r = j; r < rows; r += blockDim.x) {
    // lengths beyond the row width are clamped (memory safety only: the
    // codec's tables always satisfy len <= cols)
    s_len[r] = min(max(cdf_len[r], 0), cols);
    s_off[r] = cdf_off[r];
  }
  __syncthreads();
  if (j < 32) {  // row starts: a warp-wide inclusive scan, 32 rows at a time
    int carry = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + j;
      const int len = r < rows ? s_len[r] : 0;
      int inc = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (j >= d) inc += v;
      }
      if (r < rows) s_start[r] = carry + inc - len;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (j == 0) *s_total = carry;
  }
  __syncthreads();
  // one int of slack: a degenerate row of length 0 still reads row[0]
  const bool in_smem = 3 * rows + 2 + *s_total <= smem_ints;
  if (in_smem) {
    for (int r = 0; r < rows; ++r) {
      const int* src = cdf + (size_t)r * cols;
      int* dst = s_tab + s_start[r];
      const int len = s_len[r];
#pragma unroll 4
      for (int c = j; c < len; c += blockDim.x) dst[c] = src[c];
    }
  }
  __syncthreads();
  if (j >= k) return;

  const size_t lane = (size_t)b * k + j;
  uint32_t x = static_cast<uint32_t>(states_in[lane]);
  int pt = ptrs_in[lane];
  const int wmax = w - 1;
  const int* wrow = words + lane * w;
  const int* irow = idx + (size_t)b * idx_stride;
  int* vrow = vals + (size_t)b * m;
  int word = wrow[min(pt, wmax)];          // the word the next renorm reads
  int r = j < m ? irow[j] : 0;
  for (int p = j; p < m; p += k) {
    const int r_next = p + k < m ? irow[p + k] : 0;
    const int len = s_len[r];
    const int* row = in_smem ? s_tab + s_start[r] : cdf + (size_t)r * cols;
    const uint32_t mod = x & 0xFFFFu;
    // upper bound over row[0 .. len-2]: the count of entries <= mod
    int lo = 0, hi = max(len - 1, 0);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(row[mid]) <= mod)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int s = lo - 1;
    const uint32_t low = s >= 0 ? static_cast<uint32_t>(row[s]) : 0u;
    const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - low;
    vrow[p] = s + s_off[r];
    x = freq * (x >> 16) + mod - low;
    if (x < kLaneL) {
      x = (x << 16) | static_cast<uint32_t>(word);
      ++pt;
      word = wrow[min(pt, wmax)];
    }
    r = r_next;
  }
  states_out[lane] = static_cast<int64_t>(x);
  ptrs_out[lane] = pt;
}

// The block's shared-memory cap (bytes), raised once per device to the
// card's opt-in maximum (227 KB on an H100).  0 on failure.
int smem_cap(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess ||
        cudaFuncSetAttribute(lane_decode_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             v) != cudaSuccess)
      return 0;
    cached[device] = v;
  }
  return cached[device];
}

}  // namespace

extern "C" {

// One decode round over n images x k lanes.
// states_in/out [n, k] int64 (uint32 values), ptrs_in/out [n, k] int32,
// words [n, k, w] int32 (16-bit values), idx [n, >= m] int32 (row stride
// idx_stride), cdf [rows, cols] int32, cdf_len / cdf_off [rows] int32,
// vals [n, m] int32.  Returns the cudaError_t of the launch (0 on success),
// or cudaErrorInvalidValue for shapes the kernel does not take.
int crdr_lane_decode_round(const int64_t* states_in, const int* ptrs_in,
                           const int* words, int n, int k, int w,
                           const int* idx, int idx_stride, int m,
                           const int* cdf, int rows, int cols,
                           const int* cdf_len, const int* cdf_off, int* vals,
                           int64_t* states_out, int* ptrs_out, void* stream) {
  if (n <= 0 || k <= 0 || k > 1024 || w <= 0 || m < 0 || idx_stride < m ||
      rows <= 0 || cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the dense table's size bounds the packed one's (+1 int of slack)
  const long long dense = 3LL * rows + 2 + (long long)rows * cols;
  const long long cap = smem_cap(device) / 4;
  if (cap == 0) {
    e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  if (3LL * rows + 1 > cap) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_ints = static_cast<int>(dense < cap ? dense : cap);
  const size_t smem = (size_t)smem_ints * 4;
  // at least one warp: the row-start scan runs on warp 0
  const int threads = k < 32 ? 32 : k;
  lane_decode_round_kernel<<<n, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      states_in, ptrs_in, words, k, w, idx, idx_stride, m, cdf, rows, cols,
      cdf_len, cdf_off, vals, states_out, ptrs_out, smem_ints);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
