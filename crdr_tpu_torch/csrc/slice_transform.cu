// K1 — the Charm SliceTransform on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel crdr_tpu/ops/pallas_slice_transform.py
// (pallas_slice_transform, body _fused_kernel): conv5x5 pad 2 -> ReLU ->
// conv5x5 pad 2 -> ReLU -> conv3x3 pad 1 on the [N, H, W, Cin] latent, bf16
// operands with f32 accumulation, ReLU and the bf16 cast fused after the
// first two convs, f32 output.
//
// Bound.  At a 768x512 image (latent 32x48) one call costs 10.57 GFLOP per
// image (Cin 480, mean/scale) or 11.12 GFLOP (Cin 512, LRP): about 10.7 us /
// 11.2 us per image at the H100's 989 TFLOP/s bf16 dense rate.  The bytes are
// small beside that (the slice's bf16 weights are ~6.9 MB, the f32 input
// ~3 MB per image), so the call is compute-bound.
//
// Design (v3).  One pass (`k1_prep`) casts x to bf16 into a zero-bordered
// buffer [N, H+4, W+4, Cin] and zeroes the borders of the two intermediates
// [N, H+4, W+4, C0] and [N, H+2, W+2, C1]; then one implicit-GEMM kernel per
// conv writes its bf16 output into the next buffer's interior (the last one
// f32 into `out`).  The intermediates stay in device memory (3.4 MB for the
// padded 224-wide one at batch 4: L2-resident): the TPU kernel keeps ~840 KB
// of them in VMEM, which no block's 227 KB of shared memory can hold.
//
// A block computes a tile of 128 output positions of ONE image: two boxes
// of R x Cw positions (R * Cw = 64), one per consumer warpgroup, over the
// conv's whole Cout.  For tap (dy, dx) and input channels [k0, k0 + 64) the
// A operand of a box is a plain 4-D TMA box [1, R, Cw, 64] of the padded
// buffer at (n, r0 + dy, c0 + dx, k0): no gather, no address arithmetic per
// thread.  B is [64, 64] boxes of the slice's weights, read straight from
// the packed stack [S, k, k, Cin, Cout] (a 4-D map; the slice is a
// coordinate).  Both use the 128-byte swizzle; TMA's zero fill covers the
// ragged bottom / right edges, the channel tail (Cin 480 and 224 are 7.5 and
// 3.5 chunks of 64) and the output columns past Cout.  A producer warp keeps
// a 4-stage mbarrier ring full; each consumer warpgroup runs one
// wgmma.m64nNk16 (N = Cout rounded up to 32, 128 or 224) per
// 16-deep slice, so A is fetched once per tap and chunk and no column tile
// repeats it; the accumulators (N/2 f32 a thread) stay in registers, with
// setmaxnreg moving registers from the producer to the consumers.
//
// Split-K over a thread-block cluster.  The k-steps (taps x 64-channel
// chunks, taps outer) are split into `split` contiguous ranges, one per
// block of a cluster on the same tile.  Each block writes its partial tile
// to its own shared memory and pushes rank r's rows of it into rank r's
// shared memory with one bulk copy (cp.async.bulk shared::cta ->
// shared::cluster, completion on rank r's mbarrier); rank r sums its rows
// over the ranks in order 0, 1, ..., split - 1, adds the bias, applies ReLU
// and stores.  No workspace, no atomics.  Where a step's weight boxes
// outnumber its two A boxes (Cout 224), the cluster also holds two tiles
// that share each weight box by TMA multicast: each loads half the boxes
// into both, and a ring slot is refilled when the consumers of both blocks
// have released it.  The plan picks the largest split that keeps a batch of
// 4 images within one wave of 132 blocks (2 at a 32x48 latent).
//
// Summation order.  Tile shape, split, pairing and k-ranges come from the
// plan (crdr_tpu_torch/ops/slice_transform.py::conv_plan), a function of
// (H, W, Cin, Cout, ksize) only; tiles never span two images (grid.z is the
// image).  So every output's sum has one order fixed by shape, independent
// of the batch size and of which block finishes first: the kernel is
// bit-identical across calls and batch sizes, which is what lets the
// encoder's replay and the decoder agree to the bit.  (The order differs
// from v2's and from the CPU twin's: a stream the card encoded decodes with
// the same kernel build.)
//
// Tried and dropped (PERF.md has the times, from chip_smoke.py's K1 and
// split phases): v1/v2 (WMMA mma.sync, 64x64 tiles, a per-thread cp.async
// gather per k-step; 0.44 ms a batch-4 call); splits of 4 and 8 (they fill
// the card at batch 1, but at batch 4 their clusters run in 2-4 waves and
// more of each block's time goes to the partial tiles crossing the
// cluster); reading the peers' partials with loads through distributed
// shared memory (slower than the bulk copies); multicast on the 128- and
// 32-wide convs (slower there); deeper rings for the narrow convs (6 and 8
// stages: no change).  Not taken: a workspace of per-split partials summed
// by a second pass (an extra launch and ~11 MB of f32 traffic per split of
// the 224-wide conv at batch 4), and TMA's zero fill at negative
// coordinates in place of the padded buffers.
//
// Channel counts must be multiples of 8 (TMA's 16-byte strides), Cout <= 224.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                    // input channels per k-step
constexpr int BOX_M = 64;                 // positions of one A box (one wgmma M)
constexpr int TILE_M = 2 * BOX_M;         // two consumer warpgroups
constexpr int STAGES = 4;                 // TMA ring depth
constexpr int BOX_BYTES = 64 * BK * 2;    // an A box, or a [64 k, 64 n] B box
constexpr int NTHREAD = 384;              // producer warpgroup + 2 consumers
constexpr int MAX_SPLIT = 8;              // a portable cluster
constexpr int PLAN_INTS = 11 + MAX_SPLIT + 1;

// One conv of the SliceTransform: its plan (from the Python plan, see
// crdr_slice_transform) and its buffers' geometry.
struct ConvArgs {
  int h, w;                   // output positions of one image
  int ksize, cin, cout;
  int n_inst;                 // wgmma N: cout rounded up to an instance
  int cw, rb;                 // an A box is rb rows x cw columns
  int tiles_x, tiles_y;       // tiles of 2 * rb rows x cw columns per image
  int kchunks;                // ceil(cin / BK); k-step s = (tap, chunk)
  int split;                  // k-ranks; k-rank r runs k-steps
  int bounds[MAX_SPLIT + 1];  //   [bounds[r], bounds[r + 1])
  int pair;                   // tiles sharing each B box (1 or 2)
  int out_pad, out_hp, out_wp;  // output buffer: border and padded extent
  const float* bias;          // this slice's bias [cout]
};

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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// 4-D TMA tile load global -> shared, completion on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// the address of shared-memory location `addr` in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// bulk copy of `bytes` from this block's shared memory to `dst` in another
// block of the cluster, completion on that block's mbarrier `bar`
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the same load, landing at `dst` and signalling `bar` in every block of
// `mask` in the cluster
__device__ __forceinline__ void tma_load4_mc(uint32_t dst,
                                             const CUtensorMap* map, int c0,
                                             int c1, int c2, int c3,
                                             uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, %4, %5}], "
      "[%6], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar), "h"(mask)
      : "memory");
}

// arrive on an mbarrier of another block of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// cluster-wide barrier, release / acquire (every thread of every block)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in
// 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] . B[16 x N]: bf16 operands from shared memory (A
// K-major, B N-major), f32 accumulators in registers
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<224> {
  __device__ __forceinline__ static void run(float (&d)[112], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, %112, %113, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// Rank `rank` of a cluster of SPLIT blocks stores rows [rank, rank + 1) *
// 128 / SPLIT of the tile: its own partial rows (`part`, [128][CPITCH] f32)
// and the other ranks' (`recv`, one [128 / SPLIT][CPITCH] slot per other
// rank, in rank order), summed in rank order 0..SPLIT-1, + bias (+ ReLU),
// at the output buffer's interior.
template <int SPLIT, int CPITCH, bool RELU, typename TOut>
__device__ __forceinline__ void reduce_rows(const float* part,
                                            const float* recv,
                                            const ConvArgs& a, int rank,
                                            int y0, int x0, int img,
                                            TOut* __restrict__ out) {
  constexpr int ROWS = 2 * 64 / SPLIT;
  const float* src[SPLIT];
#pragma unroll
  for (int q = 0; q < SPLIT; ++q)
    src[q] = q == rank ? part + rank * ROWS * CPITCH
                       : recv + (q - (q > rank)) * ROWS * CPITCH;
  const int c8 = a.cout / 8;
  for (int u = threadIdx.x - 128; u < ROWS * c8; u += 256) {
    const int r = u / c8;
    const int co = (u - r * c8) * 8;
    const int row = rank * ROWS + r;
    const int m = row & 63;
    const int y = y0 + (row >> 6) * a.rb + m / a.cw;
    const int x = x0 + m % a.cw;
    if (y >= a.h || x >= a.w) continue;
    float v[8];
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) {
      const float4* p =
          reinterpret_cast<const float4*>(src[q] + r * CPITCH + co);
      const float4 lo = p[0], hi = p[1];
      if (q == 0) {
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
        v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
        v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
      }
    }
    const float4 b0 = reinterpret_cast<const float4*>(a.bias + co)[0];
    const float4 b1 = reinterpret_cast<const float4*>(a.bias + co)[1];
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] += bb[e];
      if (RELU) v[e] = fmaxf(v[e], 0.0f);
    }
    store8(out + (((size_t)img * a.out_hp + y + a.out_pad) * a.out_wp + x +
                  a.out_pad) * a.cout + co,
           v);
  }
}

// x (f32 [n, h, w, cin]) -> bf16 into the interior of xp [n, h+4, w+4, cin]
// (round to nearest even, as torch's and XLA's casts), zeros on its border;
// zeros on the borders of h0p [n, h+4, w+4, c0] and h1p [n, h+2, w+2, c1].
// blockIdx.y picks the buffer; 8 channels a thread.
__global__ void k1_prep(const float* __restrict__ x, bf16* __restrict__ xp,
                     bf16* __restrict__ h0p, bf16* __restrict__ h1p, int n,
                     int h, int w, int cin, int c0, int c1) {
  const int which = blockIdx.y;
  const int pad = which == 2 ? 1 : 2;
  const int c = which == 0 ? cin : which == 1 ? c0 : c1;
  bf16* buf = which == 0 ? xp : which == 1 ? h0p : h1p;
  const int hp = h + 2 * pad, wp = w + 2 * pad, c8 = c / 8;
  const size_t total = (size_t)n * hp * wp * c8;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t pos = i / c8;
    const int cv = (int)(i - pos * c8) * 8;
    const int xx = (int)(pos % wp);
    const int yy = (int)((pos / wp) % hp);
    const size_t img = pos / ((size_t)wp * hp);
    const bool inside = yy >= pad && yy < h + pad && xx >= pad && xx < w + pad;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (inside) {
      if (which != 0) continue;  // an intermediate's interior: its conv's
      const float* src =         // epilogue writes it
          x + (((img * h) + (yy - pad)) * w + (xx - pad)) * (size_t)cin + cv;
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      v = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                     pack2(b.z, b.w));
    }
    reinterpret_cast<uint4*>(buf)[i] = v;
  }
}

// One conv as an implicit GEMM: out[n, y, x, o] = act(bias[o] + sum over
// (tap, c) of in[n, y + dy, x + dx, c] * w[slice, tap, c, o]) with `in` the
// zero-bordered input buffer.  grid (split, tiles rounded up to `pair`, n),
// cluster (split, pair, 1): block (r, t) runs k-rank r of tile t, and the
// `pair` tiles of a cluster share each B box by multicast (block p of the
// pair loads the boxes b with b % pair == p into both); warpgroup 0
// produces, 1 and 2 consume.
template <int N, bool RELU, typename TOut>
__global__ void __launch_bounds__(NTHREAD, 1)
    k1_conv(const __grid_constant__ CUtensorMap tm_in,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ ConvArgs a, int slice,
               TOut* __restrict__ out) {
  constexpr int NBOX = (N + 63) / 64;  // B boxes of 64 output channels
  constexpr int STAGE_BYTES = (2 + NBOX) * BOX_BYTES;
  constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  constexpr int CPITCH = N + 8;  // floats per partial row (bank spread)
  constexpr int PART_BYTES = TILE_M * CPITCH * 4;
  // the partial tile, then up to MAX_SPLIT - 1 slots of the other ranks'
  // rows for this rank
  constexpr int REDUCE_BYTES = PART_BYTES + PART_BYTES / MAX_SPLIT *
                                                (MAX_SPLIT - 1);
  constexpr int DATA_BYTES =
      RING_BYTES > REDUCE_BYTES ? RING_BYTES : REDUCE_BYTES;

  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + DATA_BYTES;  // STAGES mbarriers, then
  const uint32_t empty = full + 8 * STAGES;  // STAGES more, then the
  const uint32_t recv_bar = empty + 8 * STAGES;  // other ranks' rows

  const int rank = blockIdx.x;               // k-rank
  const int pidx = blockIdx.y % a.pair;      // which tile of the pair
  const int peer = rank + (1 - pidx) * a.split;  // cluster rank of the other
  const int tile = blockIdx.y, img = blockIdx.z;
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int y0 = ty * 2 * a.rb, x0 = tx * a.cw;
  const int kb = a.bounds[rank], ke = a.bounds[rank + 1];
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_in))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_w))
                 : "memory");
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      // one arrival per consumer warpgroup of each block of the pair: a
      // slot is refilled (here and, by multicast, there) when both are done
      mbar_init(empty + 8 * s, 2 * a.pair);
    }
    mbar_init(recv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any peer uses them

  if (wg == 0) {
    // producer: warp 0 keeps the ring full, its lane 0 issuing.  The whole
    // warp runs the loop: lanes left waiting at the cluster barrier below
    // would hold back the issuing lane of their own warp.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const uint16_t mc_mask = (1u << rank) | (1u << (rank + a.split));
      int stage = 0;
      uint32_t phase = 0;
      for (int s = kb; s < ke; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (threadIdx.x == 0) {
          const int t = s / a.kchunks;
          const int k0 = (s - t * a.kchunks) * BK;
          const int dy = t / a.ksize, dx = t - dy * a.ksize;
          const uint32_t dst = sbase + stage * STAGE_BYTES;
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load4(dst, &tm_in, k0, x0 + dx, y0 + dy, img, bar);
          tma_load4(dst + BOX_BYTES, &tm_in, k0, x0 + dx, y0 + a.rb + dy,
                    img, bar);
#pragma unroll
          for (int b = 0; b < NBOX; ++b) {
            if (a.pair == 1)
              tma_load4(dst + (2 + b) * BOX_BYTES, &tm_w, 64 * b, k0, t,
                        slice, bar);
            else if (b % 2 == pidx)
              tma_load4_mc(dst + (2 + b) * BOX_BYTES, &tm_w, 64 * b, k0, t,
                           slice, bar, mc_mask);
          }
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cluster_sync();  // the partials are in shared memory
    cluster_sync();  // every copy between the ranks is done
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // which A box, rows [64 half, 64 half + 64)
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int s = kb; s < ke; ++s) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t st = sbase + stage * STAGE_BYTES;
      // A: K-major, SBO 1024 B (8 rows of 128 B); B: N-major, LBO 8192 B
      // (the next 64-column box), SBO 1024 B (the next 8 k-rows)
      const uint64_t da = smem_desc(st + half * BOX_BYTES, 1, 64);
      const uint64_t db = smem_desc(st + 2 * BOX_BYTES, BOX_BYTES / 16, 64);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // +32 B along k in A, +2 KB in B
        Wgmma<N>::run(acc, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products are done
      fence_regs(acc);
      if (s > kb && threadIdx.x % 128 == 0) {
        mbar_arrive(empty + 8 * prev);
        if (a.pair == 2)
          mbar_arrive_cluster(cluster_addr(empty + 8 * prev, peer));
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // both consumers are done with the ring: it becomes the partial tile
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* part = reinterpret_cast<float*>(smem);
    float* recv = reinterpret_cast<float*>(smem + PART_BYTES);
    {
      const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
      const int row = half * 64 + wq * 16 + (lane >> 2);
      const int col = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        *reinterpret_cast<float2*>(part + row * CPITCH + 8 * j + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (row + 8) * CPITCH + 8 * j + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    // the bulk copies below read `part` through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int split = a.split;
    const uint32_t slot = TILE_M / split * CPITCH * 4;
    if (threadIdx.x == 128 && split > 1)
      mbar_expect_tx(recv_bar, (split - 1) * slot);
    cluster_sync();  // every rank's partial is written, its ring is free
    if (threadIdx.x == 128) {
      // push rank r's rows of this partial into rank r's slot for us
      for (int r = 0; r < split; ++r) {
        if (r == rank) continue;
        const uint32_t dst = smem_u32(recv) + (rank - (rank > r)) * slot;
        const int to = r + pidx * split;  // k-rank r of this tile
        bulk_to_peer(cluster_addr(dst, to), smem_u32(part) + r * slot, slot,
                     cluster_addr(recv_bar, to));
      }
    }
    if (split > 1) mbar_wait(recv_bar, 0);
    switch (split) {  // the rows of this rank, summed in rank order
      case 1: reduce_rows<1, CPITCH, RELU>(part, recv, a, rank, y0, x0, img, out); break;
      case 2: reduce_rows<2, CPITCH, RELU>(part, recv, a, rank, y0, x0, img, out); break;
      case 4: reduce_rows<4, CPITCH, RELU>(part, recv, a, rank, y0, x0, img, out); break;
      default: reduce_rows<8, CPITCH, RELU>(part, recv, a, rank, y0, x0, img, out); break;
    }
    // every block's incoming copies are done, so are its outgoing ones: no
    // block leaves while a copy still reads its shared memory
    cluster_sync();
  }
}

template <int N, bool RELU, typename TOut>
constexpr int smem_bytes() {
  constexpr int ring = STAGES * (2 + (N + 63) / 64) * BOX_BYTES;
  constexpr int part = TILE_M * (N + 8) * 4;
  constexpr int reduce = part + part / MAX_SPLIT * (MAX_SPLIT - 1);
  return (ring > reduce ? ring : reduce) + 16 * STAGES + 8 + 1024;
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {  // libcuda's cuTensorMapEncodeTiled, looked up at run time
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// 4-D bf16 map, dims innermost first, a box of box0 x box1 x box2 x 1
bool encode4(CUtensorMap* m, const void* base, const cuuint64_t dims[4],
             cuuint32_t box0, cuuint32_t box1, cuuint32_t box2) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {box0, box1, box2, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allow an instance its dynamic shared memory on the current device, once
// per instance and device (the call costs host time on every launch
// otherwise).
template <int N, bool RELU, typename TOut>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(k1_conv<N, RELU, TOut>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<N, RELU, TOut>());
  if (e == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return e;
}

template <int N, bool RELU, typename TOut>
cudaError_t launch_inst(const CUtensorMap& tm_in, const CUtensorMap& tm_w,
                        const ConvArgs& a, int n, int slice, TOut* out,
                        cudaStream_t stream) {
  auto kern = k1_conv<N, RELU, TOut>;
  constexpr int smem = smem_bytes<N, RELU, TOut>();
  cudaError_t e = allow_smem<N, RELU, TOut>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  const int tiles = a.tiles_x * a.tiles_y;
  cfg.gridDim = dim3(a.split, (tiles + a.pair - 1) / a.pair * a.pair, n);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = a.pair;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tm_in, tm_w, a, slice, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// blocks resident per SM, and clusters of `split` resident on the card
template <int N, bool RELU, typename TOut>
cudaError_t occupancy_inst(int split, int pair, int* blocks, int* clusters,
                           int* smem) {
  auto kern = k1_conv<N, RELU, TOut>;
  *smem = smem_bytes<N, RELU, TOut>();
  cudaError_t e = allow_smem<N, RELU, TOut>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NTHREAD,
                                                    *smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, pair, 1);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = *smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = pair;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

// the instance for wgmma N: stages 0 and 1 (ReLU, bf16 out) or 2 (f32 out)
template <bool RELU, typename TOut>
cudaError_t launch_conv(const CUtensorMap& tm_in, const CUtensorMap& tm_w,
                        const ConvArgs& a, int n, int slice, TOut* out,
                        cudaStream_t st) {
  switch (a.n_inst) {
    case 32: return launch_inst<32, RELU, TOut>(tm_in, tm_w, a, n, slice, out, st);
    case 128: return launch_inst<128, RELU, TOut>(tm_in, tm_w, a, n, slice, out, st);
    case 224: return launch_inst<224, RELU, TOut>(tm_in, tm_w, a, n, slice, out, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool RELU, typename TOut>
cudaError_t occupancy_conv(int n_inst, int split, int pair, int* blocks,
                           int* clusters,
                           int* smem) {
  switch (n_inst) {
    case 32: return occupancy_inst<32, RELU, TOut>(split, pair, blocks, clusters, smem);
    case 128: return occupancy_inst<128, RELU, TOut>(split, pair, blocks, clusters, smem);
    case 224: return occupancy_inst<224, RELU, TOut>(split, pair, blocks, clusters, smem);
    default: return cudaErrorInvalidValue;
  }
}

// plan ints of one conv (ops/slice_transform.py::conv_plan, `as_ints`):
// ksize, cin, cout, n_inst, cw, rb, tiles_x, tiles_y, kchunks, split, pair,
// bounds[0..MAX_SPLIT]
bool read_plan(const int* p, int h, int w, int ksize, int cin, int cout,
               ConvArgs* a) {
  a->h = h;
  a->w = w;
  a->ksize = p[0];
  a->cin = p[1];
  a->cout = p[2];
  a->n_inst = p[3];
  a->cw = p[4];
  a->rb = p[5];
  a->tiles_x = p[6];
  a->tiles_y = p[7];
  a->kchunks = p[8];
  a->split = p[9];
  a->pair = p[10];
  for (int i = 0; i <= MAX_SPLIT; ++i) a->bounds[i] = p[11 + i];
  // the kernel's own invariants; the plan's tests hold the rest
  const int s = a->split;
  bool ok = a->ksize == ksize && a->cin == cin && a->cout == cout &&
            a->cout <= a->n_inst && a->cw * a->rb == BOX_M && a->cw > 0 &&
            a->cw <= 256 && a->tiles_x * a->cw >= w &&
            a->tiles_y * 2 * a->rb >= h && a->kchunks * BK >= cin &&
            (s == 1 || s == 2 || s == 4 || s == 8) &&
            (a->pair == 1 || a->pair == 2) && s * a->pair <= MAX_SPLIT &&
            a->bounds[0] == 0 &&
            a->bounds[s] == ksize * ksize * a->kchunks;
  for (int r = 0; ok && r < s; ++r) ok = a->bounds[r] < a->bounds[r + 1];
  return ok;
}

constexpr int kPlanError = -1;    // the plan does not fit this call
constexpr int kTensorMapError = -2;  // cuTensorMapEncodeTiled failed

}  // namespace

extern "C" {

// ints per conv of the plan (3 convs per call)
int crdr_slice_transform_plan_ints() { return PLAN_INTS; }

// One SliceTransform of slice `slice` of the packed stacks of `slices`.
// x [n, h, w, cin] f32; w0 [S, 5, 5, cin, c0], w2 [S, 5, 5, c0, c1],
// w4 [S, 3, 3, c1, cout] bf16; b* [S, C] f32; plan: 3 x PLAN_INTS ints;
// scratch xp [n, h+4, w+4, cin], h0p [n, h+4, w+4, c0], h1p [n, h+2, w+2,
// c1] bf16 (borders written here); out [n, h, w, cout] f32.
// Returns 0, a cudaError_t of a launch, or kPlanError / kTensorMapError.
int crdr_slice_transform(const float* x, int n, int h, int w, int cin,
                         const bf16* w0, const float* b0, int c0,
                         const bf16* w2, const float* b2, int c1,
                         const bf16* w4, const float* b4, int cout,
                         int slices, int slice, const int* plan, bf16* xp,
                         bf16* h0p, bf16* h1p, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvArgs a[3];
  const int ks[3] = {5, 5, 3}, ci[3] = {cin, c0, c1}, co[3] = {c0, c1, cout};
  const float* bias[3] = {b0, b2, b4};
  const void* wt[3] = {w0, w2, w4};
  const void* in[3] = {xp, h0p, h1p};
  const int out_pad[3] = {2, 1, 0};
  for (int i = 0; i < 3; ++i) {
    if (!read_plan(plan + i * PLAN_INTS, h, w, ks[i], ci[i], co[i], &a[i]))
      return kPlanError;
    a[i].bias = bias[i] + (size_t)slice * co[i];
    a[i].out_pad = out_pad[i];
    a[i].out_hp = h + 2 * out_pad[i];
    a[i].out_wp = w + 2 * out_pad[i];
  }
  CUtensorMap tm_in[3], tm_w[3];
  for (int i = 0; i < 3; ++i) {
    const int p = ks[i] / 2;
    const cuuint64_t din[4] = {(cuuint64_t)ci[i], (cuuint64_t)(w + 2 * p),
                               (cuuint64_t)(h + 2 * p), (cuuint64_t)n};
    const cuuint64_t dw[4] = {(cuuint64_t)co[i], (cuuint64_t)ci[i],
                              (cuuint64_t)(ks[i] * ks[i]), (cuuint64_t)slices};
    if (!encode4(&tm_in[i], in[i], din, BK, a[i].cw, a[i].rb) ||
        !encode4(&tm_w[i], wt[i], dw, 64, BK, 1))
      return kTensorMapError;
  }

  const size_t most = (size_t)n * (h + 4) * (w + 4) *
                      (cin > c0 ? cin : c0) / 8;
  const unsigned blocks = (unsigned)((most + 255) / 256 < 2048
                                         ? (most + 255) / 256 : 2048);
  k1_prep<<<dim3(blocks, 3), 256, 0, st>>>(x, xp, h0p, h1p, n, h, w, cin, c0,
                                         c1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_conv<true, bf16>(tm_in[0], tm_w[0], a[0], n, slice, h0p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_conv<true, bf16>(tm_in[1], tm_w[1], a[1], n, slice, h1p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_conv<false, float>(tm_in[2], tm_w[2], a[2], n, slice, out, st);
  return static_cast<int>(e);
}

// Residency of one conv instance: blocks per SM, clusters of `split` on the
// card, dynamic shared memory per block.  `last`: the f32-output instance.
int crdr_slice_transform_occupancy(int n_inst, int last, int split,
                                   int pair, int* blocks, int* clusters,
                                   int* smem) {
  const cudaError_t e =
      last ? occupancy_conv<false, float>(n_inst, split, pair, blocks,
                                          clusters, smem)
           : occupancy_conv<true, bf16>(n_inst, split, pair, blocks, clusters,
                                        smem);
  return static_cast<int>(e);
}

}  // extern "C"
