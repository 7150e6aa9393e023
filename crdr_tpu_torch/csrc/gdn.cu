// K3 — GDN / inverse GDN on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel crdr_tpu/ops/pallas_gdn.py (pallas_gdn,
// body _gdn_kernel): out = x * (beta + (x*x) . gamma^T)^(-1/2), or ^(+1/2)
// for the inverse, with gamma [C_out, C_in] (the torch conv1x1 layout of
// nn.norm.GDN) and the product accumulated in f32.  The TPU kernel runs it
// on [M, C] rows with the product on the MXU inside its body; this kernel
// computes the product itself, in f32 FFMA (no TF32: the Balle18 transforms
// run at `highest`).
//
// Layout.  x and out are NCHW f32, read and written as they lie: for image n,
// out[:, p] = x[:, p] * rsqrt(beta + gamma . x[:, p]^2), a [C x C] . [C x P]
// product per image with the pixels contiguous, so there is no permute.  The
// wrapper hands the kernel gamma^T [C_in, C_out] (one 37K-float copy a call
// at C = 192), so a chunk of input channels is a contiguous block of rows.
//
// Bound.  At the Balle18 path's largest call ([4, 192, 256, 384]) the
// product is 2 * M * C^2 = 29.0 GFLOP against 604 MB moved (x read once,
// out written once): about 0.43 ms at the H100's ~67 TFLOP/s f32 rate and
// 0.18 ms at 3.35 TB/s, so the call is bound by operations.
//
// What held v1 back (one block per 64-pixel tile, the tile's x^2 resident
// in shared memory, gamma re-staged for every tile in 32-column chunks
// through a transposing store, two barriers a chunk and no copy in flight
// meanwhile), measured on v1 at [4, 192, 256, 384] (PERF.md, section 7;
// NVIDIA H100 80GB HBM3, 700 W): 1.363 ms as it was; 0.874 with gamma staged
// once instead of six times; 1.923 at 1 block an SM instead of 2; 1.614 with
// a store mapping free of bank conflicts (its global reads in 4-row pieces).
// So the serialised re-staging and too little in flight to hide it were the
// cost, not the store's 4-way conflict.
//
// Design (v2).  One block of 256 threads per (64-pixel tile, image),
// whatever C (the plan is a function of C alone).  The k loop runs in
// 16-row chunks: a chunk is 16 rows of gamma^T ([16, C]) and the tile's 16
// x rows ([16, 64]), copied with 16-byte cp.async into a 4-stage ring, so
// the copies of chunks j + 1..j + 3 overlap the FFMAs on chunk j, with one
// barrier a chunk and no transposing store.  The thread that copied an x float4
// squares it in place (one rounded f32 product) once its copy has landed,
// before the chunk's barrier.  Threads are 16 pixel groups x 16 channel
// groups; each holds a (C/16 output channels x 4 pixels) register tile (48
// f32 accumulators at C = 192): the x float4s of a warp are conflict-free,
// its gamma^T float4s broadcasts.  A 128-pixel tile (96 accumulators at
// C = 192) halves gamma's L2 reads but spills at the 128 registers that 2
// blocks an SM allow, and measured 0.80 ms against 0.65 for 64 pixels.
// Measured at 64 pixels (six calls of the path): 2, 3 and 4 stages 1.710,
// 1.744 and 1.705 ms; 3 blocks an SM (at most 85 registers) 1.852.
// The epilogue re-reads x (from L2), applies + beta, rsqrt / sqrt and * x,
// and stores along the pixels (float4 when the pixel count and the
// pointers allow it), masking the ragged tail.
//
// Arithmetic, identical to v1's: acc = 0, then acc = fmaf(gamma[o][k],
// x[k]^2, acc) for k = 0..C-1 in order, then acc + beta[o], then rsqrtf or
// sqrtf, times x.  No split-K, no atomics: a pixel's result depends neither
// on its tile nor on the batch, so a batch-1 stream equals its batch-4 one.
//
// The bf16 mode (transform_dtype: bfloat16 on the GDN families), a kernel of
// its own (gdn_bf16_kernel).  x, out, beta and gamma are bf16, gamma as it
// is stored ([C_out, C_in]).  It computes the JAX package's bf16 composite
// (crdr_tpu/nn/norm.py's einsum path in bf16: JAX's Pallas kernel cannot
// store bf16), each step rounded to bf16 to nearest even: xx = bf16(x * x);
// n = bf16(sum_c xx_c * gamma[o][c]), the sum in f32; n = bf16(n + beta[o]);
// r = bf16(rsqrt(n)) or bf16(sqrt(n)), correctly rounded in f32
// (__frsqrt_rn / __fsqrt_rn: rsqrtf is up to 2 ulp off, and XLA's bf16
// rsqrt is the correctly rounded one); out = bf16(x * r).
//
// Bound of the bf16 mode at [4, 192, 256, 384]: 302 MB of bf16 in and out,
// about 0.090 ms at 3.35 TB/s; the 29.0 GFLOP of the product take 0.029 ms
// at the bf16 tensor-core rate, so the bound is bytes.  Its first version
// (PR 17) ran the f32 mode's FFMA plan on bf16 tiles: bound by its own FFMA,
// 0.73 ms, 0.12 of its bound.
//
// Design of the bf16 mode (v3): the product on the tensor cores.  Every
// term xx_c * gamma[o][c] is a product of two bf16 values, exact in f32, so
// a bf16 product with f32 accumulation computes the same terms; all terms
// are >= 0, so the order of the f32 sum moves it by far less than a bf16 ulp
// and the checks hold each output to the composite of a sum within 1 ulp of
// the twin's (ops/gdn.py::bf16_unexplained).  Per image the product is
// D[o, p] = gamma[o, :] . XX[:, p]: M = C_out, K = C_in, N = the pixels of
// a tile; A = gamma as stored (K-major), B = the tile's xx (pixels
// contiguous, MN-major).  It runs as mma.sync.m16n8k16 (bf16 in, f32
// accumulators) with A through ldmatrix and B through ldmatrix.trans, not
// wgmma: the product takes a third of the bytes bound even at mma.sync's
// rate (measured ~2.2 us of tensor work a 128-pixel tile an SM), and its
// fragments let each thread square its own B registers (mul.rn.bf16x2:
// bf16(x * x), one rounding of the exact product) and run the epilogue on
// its own accumulators.
// * A persistent block a resident slot (grid = SMs, or fewer), 512 threads
//   in two groups of 8 warps (one group at C = 256, for shared memory).
//   gamma (bf16, its 16-byte chunks XOR-swizzled by row so ldmatrix is
//   free of bank conflicts) and beta (f32) go into shared memory once a
//   block, shared by the groups.
// * A group walks its own tiles (group q of block b: tiles 2b + q, + 2 x
//   the grid, ...) with its own barriers (bar.sync on a named barrier of
//   its 256 threads), so one group's epilogue and copies run beside the
//   other's product.  A tile is 64 pixels of one image, all C channels: one
//   TMA box [C][64] of the 2-D map [n * C][P], in the TMA's 128-byte
//   swizzle, which keeps ldmatrix and the epilogue free of bank conflicts;
//   pixels past P read as zeros and are not written.
// * A group holds three tiles: one computed, the next landing (its TMA load
//   completing on the buffer's mbarrier), the last one's out being stored by
//   a TMA store.  One thread of the group issues the copies: after a tile's
//   store it waits for the store before it to have read its buffer
//   (cp.async.bulk.wait_group.read 1), then loads the tile after next into
//   it.  The first tiles load while gamma does.
// * 8 warps a group as 4 (output channels) x 2 (pixels), 8 x 2 at C = 256:
//   a warp holds MT m16 x 4 n8 accumulator tiles (48 f32 at C = 192).  The
//   k loop runs over C in 16-channel steps, in order: one summation order
//   per output, fixed by C alone, no split-K, no atomics, so a pixel's
//   result depends neither on its tile nor on the batch.
// * The epilogue reads x from the tile in shared memory and writes the bf16
//   result over it (each element read and written by one thread): x is
//   read from device memory once and out written once, by the TMA.  The
//   roots are the hardware's approximations, taken only where they round
//   to the correctly rounded root's bf16 (epilogue_row), and the bf16
//   roundings run two elements an instruction.
// * P % 8 != 0 or an x / out not 16-byte aligned (no TMA map) takes the
//   scalar path: the same plan with 2-byte loads and stores in the group's
//   threads, the tile's tail zero-filled.
// What the stores cost (PERF.md, PR 18, runs A-C and scratch builds on the
// way here, [4, 192, 256, 384] GDN / IGDN): a first build (8 warps, two
// 128-pixel cp.async buffers, the roots __frsqrt_rn / __fsqrt_rn, the
// output staged in shared memory and stored 16 bytes a thread after two
// more barriers) took 0.2964 / 0.2638 ms; 16 warps and the approximate
// roots 0.1982 / 0.1925; each thread's accumulator pairs stored from
// registers after one barrier a tile 0.1794 / 0.1915, where those 4-byte
// stores alone took about as long as the whole kernel.  16-byte stores
// after a shuffle, streaming stores, per-row 1-D bulk copies and other tile
// orders did no better; TMA loads and stores of 128-pixel tiles by the
// whole block took 0.176 both ways, and the two groups above 0.170 / 0.166.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TP = 64;      // pixels a block (one image)
constexpr int PG = TP / 4;  // pixel groups of 4
constexpr int CG = 16;      // channel groups
constexpr int NT = PG * CG; // threads a block
constexpr int KC = 16;      // input channels (rows of gamma^T and x) a chunk
constexpr int STAGES = 4;   // ring depth: chunk j + STAGES - 1 copies during j
constexpr int MAX_DEV = 64;

// A ring stage: [KC][C] of gamma^T and [KC][TP] of squared x, in f32.
template <int C>
struct Plan {
  static constexpr int CPT = C / CG;              // output channels a thread
  static constexpr int STAGE = KC * (C + TP);
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE *
                                 sizeof(float);
  static constexpr int GSLOTS = KC * C / 4 / NT;  // gamma^T float4s a thread
  static_assert(C % (4 * CG) == 0 && C % KC == 0, "channel plan");
  static_assert(GSLOTS * 4 * NT == KC * C, "gamma^T copy plan");
  static_assert(KC * TP == 4 * NT, "x copy plan: one float4 a thread");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
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

template <int C, bool VEC>
__global__ void __launch_bounds__(NT, 2)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ beta,
           const float* __restrict__ gamma_t, float* __restrict__ out, int P,
           bool inverse) {
  using PL = Plan<C>;
  constexpr int CPT = PL::CPT;
  constexpr int NCHUNK = C / KC;
  // STAGES x {[KC][C] gamma^T, [KC][TP] x^2}
  extern __shared__ __align__(16) float smem[];
  // x float4 (row tid / PG, pixels 4 * pg) of a chunk is this thread's copy

  const int tid = threadIdx.x;
  const int pg = tid % PG;
  const int cg = tid / PG;
  const int p0 = blockIdx.x * TP;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * P;
  const float* xn = x + base;
  float* on = out + base;

  // chunk j: gamma^T rows j*KC.. (contiguous) and the tile's x rows j*KC..;
  // pixels past P are zero-filled (src size 0, from an in-range address)
  auto issue = [&](int j) {
    float* gs = smem + (j % STAGES) * PL::STAGE;
    float* xs = gs + KC * C;
    const float* gsrc = gamma_t + static_cast<size_t>(j) * KC * C;
#pragma unroll
    for (int i = 0; i < PL::GSLOTS; ++i) {
      const int f = tid + i * NT;
      cp_async16(gs + 4 * f, gsrc + 4 * f, 16);
    }
    const int p = p0 + 4 * pg;
    const float* src = xn + static_cast<size_t>(j * KC + cg) * P + p;
    if constexpr (VEC) {
      cp_async16(xs + 4 * tid, p < P ? src : xn, p < P ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(xs + 4 * tid + e, p + e < P ? src + e : xn,
                  p + e < P ? 4 : 0);
    }
  };

  float acc[CPT][4];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NCHUNK) issue(s);
    cp_async_commit();  // one group a chunk, empty past the end
  }

  for (int j = 0; j < NCHUNK; ++j) {
    const int stage = j % STAGES;
    float* gs = smem + stage * PL::STAGE;
    float* xs = gs + KC * C;
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk j landed
    {  // square its x float4 in place
      float4* v = reinterpret_cast<float4*>(xs) + tid;
      float4 t = *v;
      t.x = __fmul_rn(t.x, t.x);
      t.y = __fmul_rn(t.y, t.y);
      t.z = __fmul_rn(t.z, t.z);
      t.w = __fmul_rn(t.w, t.w);
      *v = t;
    }
    // chunk j is visible to all; every thread is done with chunk j - 1,
    // whose stage the next copy reuses
    __syncthreads();
    if (j + STAGES - 1 < NCHUNK) issue(j + STAGES - 1);
    cp_async_commit();

    const float* g = gs + cg * CPT;
    const float* xr = xs + 4 * pg;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 t = *reinterpret_cast<const float4*>(xr + k * TP);
      const float xv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < CPT; u += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g + k * C + u);
        const float gu[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[u + a][e] = fmaf(gu[a], xv[e], acc[u + a][e]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int o = cg * CPT + j;
    const float b = beta[o];
    const size_t row = static_cast<size_t>(o) * P;
    const int pp = p0 + 4 * pg;
    if constexpr (VEC) {
      if (pp < P) {  // P % 4 == 0: the group's 4 pixels are all in range
        const float4 xv = *reinterpret_cast<const float4*>(xn + row + pp);
        const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float nrm = acc[j][e] + b;
          r[e] = inverse ? xe[e] * sqrtf(nrm) : xe[e] * rsqrtf(nrm);
        }
        *reinterpret_cast<float4*>(on + row + pp) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (pp + e < P) {
          const float nrm = acc[j][e] + b;
          const float xe = xn[row + pp + e];
          on[row + pp + e] = inverse ? xe * sqrtf(nrm) : xe * rsqrtf(nrm);
        }
      }
    }
  }
}

// ---------------- the bf16 mode (v3, tensor cores) -------------------------

constexpr int BT = 512;  // threads a bf16-mode block: 16 warps
constexpr uint32_t GUARD = 8;  // f32 ulps around a bf16 rounding midpoint

template <int C>
struct Bf16Plan {
  static constexpr int GROUPS = C == 256 ? 1 : 2;  // independent warp groups
  static constexpr int GT = BT / GROUPS;           // threads a group
  static constexpr int TP = 64;       // pixels a tile: one 128-byte TMA box
  static constexpr int WN = 2;                     // a group's warps: pixels
  static constexpr int WM = GT / 32 / WN;          // ... output channels
  static constexpr int MT = C / (16 * WM);         // m16 tiles a warp
  static constexpr int NTW = TP / (8 * WN);        // n8 tiles a warp: 4
  static constexpr int NBUF = 3;                   // a group's x tiles
  static constexpr int BUF_ELEMS = C * TP;
  static constexpr size_t BUF_BYTES = static_cast<size_t>(BUF_ELEMS) * 2;
  static constexpr size_t GAMMA_BYTES = static_cast<size_t>(C) * C * 2;
  // 1024 of slack to align the buffers to the swizzle's 1024-byte period,
  // the buffers, gamma, beta (f32), the buffers' mbarriers
  static constexpr size_t SMEM = 1024 + GROUPS * NBUF * BUF_BYTES +
                                 GAMMA_BYTES + C * 4 + GROUPS * NBUF * 8;
  static_assert(MT * 16 * WM == C && NTW * 8 * WN == TP, "warp plan");
  static_assert(NTW % 2 == 0, "B fragments come two n8 tiles a ldmatrix");
  static_assert(BUF_BYTES % 1024 == 0, "buffers on the swizzle's period");
  static_assert(C <= 256, "a TMA box holds at most 256 rows");
  static_assert(SMEM <= 232448, "shared memory a block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices, row addresses from lanes 0-7, 8-15, 16-23, 24-31
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// bf16(v * v) of both halves, each the nearest bf16 of the exact product
__device__ __forceinline__ uint32_t square_bf16x2(uint32_t v) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still reading their source
// (READ) or still running
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory, visible to the bulk copies after
// the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the issuing thread's arrival, with the bytes the copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: box {c0 (pixel), c1 (row of [n * C])} of `map` into shared memory,
// completing on `bar`; and the reverse, in this thread's bulk group
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store2(const CUtensorMap* map, int c0,
                                           int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group [%0, {%1, "
      "%2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_addr(src))
      : "memory");
}

// element (row k, pixel p) of a tile buffer: a 64-pixel box [C][64] of
// bf16, each 128-byte row's 16-byte chunks XOR-swizzled by the row (the
// TMA's 128-byte swizzle)
__device__ __forceinline__ int x_at(int k, int p) {
  return k * 64 + ((((p >> 3) ^ (k & 7)) << 3) | (p & 7));
}

// a barrier of the `count` threads that name barrier `id`
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// gamma's 16-byte chunk q of row r, XOR-swizzled within its 8 chunks: the
// 8 rows of a ldmatrix phase land in 8 different bank groups
__device__ __forceinline__ int gamma_at(int r, int q, int c) {
  return r * c + ((q ^ (r & 7)) << 3);
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sqrt(v) or 1 / sqrt(v) in f32, to be rounded to bf16 at once.  The
// hardware's approximation (rsqrt.approx, and v times it for the root:
// within 3 ulps of the correctly rounded f32 value) rounds to the same bf16
// as the correctly rounded root unless it lies within GUARD ulps of a bf16
// rounding midpoint (its low 16 bits near 0x8000); `exact` says where the
// correctly rounded root (__fsqrt_rn / __frsqrt_rn, a software sequence)
// must be taken instead: there, and for v not positive and finite (about
// 2^-12 of the elements).
__device__ __forceinline__ float approx_root(float v, bool inverse,
                                             bool* exact) {
  float r;
  asm("rsqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  if (inverse) r = __fmul_rn(v, r);
  *exact = (__float_as_uint(r) & 0xFFFFu) - (0x8000u - GUARD) <= 2 * GUARD ||
           !(v > 0.0f && v < INFINITY);
  return r;
}

// the bf16 composite after the sum for the NTW pixel pairs of one row of a
// thread's accumulator tiles: bf16(x * bf16(rsqrt or sqrt of bf16(bf16(acc)
// + beta))), each rounding to nearest even (cvt.rn.bf16x2.f32: two at a
// time).  The roots are all approximated first, with no branch between
// them, then the rare exact ones are taken.
template <int NTW>
__device__ __forceinline__ void epilogue_row(const float (*acc)[4], int h,
                                             float b, __nv_bfloat16* cur,
                                             int o, int q0, bool inverse) {
  float nv[NTW][2], rv[NTW][2];
  bool ex[NTW][2], any = false;
#pragma unroll
  for (int c = 0; c < NTW; ++c) {
    const float2 s = __bfloat1622float2(
        __floats2bfloat162_rn(acc[c][2 * h], acc[c][2 * h + 1]));
    const float2 n = __bfloat1622float2(
        __floats2bfloat162_rn(__fadd_rn(s.x, b), __fadd_rn(s.y, b)));
    nv[c][0] = n.x;
    nv[c][1] = n.y;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rv[c][e] = approx_root(nv[c][e], inverse, &ex[c][e]);
      any |= ex[c][e];
    }
  }
  if (any) {
#pragma unroll
    for (int c = 0; c < NTW; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (ex[c][e])
          rv[c][e] = inverse ? __fsqrt_rn(nv[c][e]) : __frsqrt_rn(nv[c][e]);
  }
#pragma unroll
  for (int c = 0; c < NTW; ++c) {  // the pair at pixel q0 + 8c of row o
    __nv_bfloat162* cell =
        reinterpret_cast<__nv_bfloat162*>(cur + x_at(o, q0 + 8 * c));
    const float2 r = __bfloat1622float2(
        __floats2bfloat162_rn(rv[c][0], rv[c][1]));
    const float2 xf = __bfloat1622float2(*cell);
    *cell = __floats2bfloat162_rn(__fmul_rn(xf.x, r.x),
                                  __fmul_rn(xf.y, r.y));
  }
}

template <int C, bool VEC>
__global__ void __launch_bounds__(BT, 1)
gdn_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_out,
                const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ beta,
                const __nv_bfloat16* __restrict__ gamma,
                __nv_bfloat16* __restrict__ out, int n, int P, bool inverse) {
  using PL = Bf16Plan<C>;
  constexpr int TPX = PL::TP, NBUF = PL::NBUF, GROUPS = PL::GROUPS;
  constexpr int GT = PL::GT;
  constexpr int MT = PL::MT, NTW = PL::NTW, WM = PL::WM;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* xbufs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* gs = xbufs + GROUPS * NBUF * PL::BUF_ELEMS;
  float* bs = reinterpret_cast<float*>(gs + C * C);
  uint64_t* fulls = reinterpret_cast<uint64_t*>(bs + C);

  const int tid = threadIdx.x;
  const int grp = tid / GT, gt = tid % GT;  // the group, its thread
  const int lane = tid & 31;
  const int gw = gt >> 5;                   // the warp within its group
  const int m0 = (gw % WM) * MT * 16;       // the warp's first channel
  const int n0 = (gw / WM) * NTW * 8;       // the warp's first pixel
  const int g = lane >> 2, t = lane & 3;    // the fragment's row / col
  __nv_bfloat16* xbuf = xbufs + grp * NBUF * PL::BUF_ELEMS;  // NBUF tiles
  uint64_t* full = fulls + grp * NBUF;                       // theirs
  const int per_image = (P + TPX - 1) / TPX;
  const int tiles = n * per_image;
  // group q of block b walks the tiles GROUPS * b + q, + GROUPS *
  // gridDim.x, ...
  const int step = GROUPS * gridDim.x;
  const int first = GROUPS * blockIdx.x + grp;

  // one thread's TMA load of a tile (a box) into buffer s, on its mbarrier
  auto load = [&](int tile, int s) {
    if (tile >= tiles) return;
    const int img = tile / per_image;
    mbar_expect_tx(full + s, C * 128);
    tma_load2(xbuf + s * PL::BUF_ELEMS, &tm_x,
              (tile - img * per_image) * TPX, img * C, full + s);
  };
  if (tid == 0) {
    for (int s = 0; s < GROUPS * NBUF; ++s) mbar_init(fulls + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (VEC) {  // each group's first tiles, while gamma loads
    if (gt == 0)
      for (int s = 0; s < NBUF - 1; ++s) load(first + s * step, s);
  }
  // gamma [C][C], swizzled (gamma_at); beta -> f32
  for (int f = tid; f < C * (C / 8); f += BT) {
    const int r = f / (C / 8), q = f - r * (C / 8);
    cp_async16(gs + gamma_at(r, q, C),
               gamma + static_cast<size_t>(r) * C + 8 * q, 16);
  }
  cp_async_commit();
  for (int o = tid; o < C; o += BT) bs[o] = __bfloat162float(beta[o]);
  cp_async_wait<0>();
  __syncthreads();

  int tile = first;
  for (int i = 0; tile < tiles; ++i, tile += step) {
    const int s = i % NBUF;
    __nv_bfloat16* cur = xbuf + s * PL::BUF_ELEMS;
    const int img = tile / per_image;
    const int p0 = (tile - img * per_image) * TPX;
    if constexpr (VEC) {
      mbar_wait(full + s, (i / NBUF) & 1);  // the tile landed
    } else {  // plain loads, zero past P
      const __nv_bfloat16* src = x + static_cast<size_t>(img) * C * P + p0;
      for (int f = gt; f < C * TPX; f += GT) {
        const int r = f / TPX, q = f - r * TPX;
        cur[x_at(r, q)] = p0 + q < P ? src[static_cast<size_t>(r) * P + q]
                                     : __float2bfloat16_rn(0.0f);
      }
      named_barrier(1 + grp, GT);
    }

    float acc[MT][NTW][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < NTW; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;

#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t af[MT][4], bf[NTW][2];
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        const int r = m0 + a * 16 + (lane & 15);
        ldmatrix_x4(af[a], gs + gamma_at(r, k0 / 8 + (lane >> 4), C));
      }
#pragma unroll
      for (int b = 0; b < NTW; b += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, cur + x_at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                          n0 + b * 8 + (lane >> 4) * 8));
        bf[b][0] = square_bf16x2(r[0]);
        bf[b][1] = square_bf16x2(r[1]);
        bf[b + 1][0] = square_bf16x2(r[2]);
        bf[b + 1][1] = square_bf16x2(r[3]);
      }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NTW; ++b) mma_bf16(acc[a][b], af[a], bf[b]);
    }
    named_barrier(1 + grp, GT);  // every warp of the group has read the x

    // epilogue: out over x in place (the element's own thread)
#pragma unroll
    for (int a = 0; a < MT; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = m0 + a * 16 + g + 8 * h;
        epilogue_row<NTW>(acc[a], h, bs[o], cur, o, n0 + 2 * t, inverse);
      }
    }
    if constexpr (VEC) fence_proxy_async();
    named_barrier(1 + grp, GT);  // the tile's out is complete

    if constexpr (VEC) {
      if (gt == 0) {  // the tile out; then the next tile but one into the
                      // buffer whose store has read it
        tma_store2(&tm_out, p0, img * C, cur);
        bulk_commit();
        bulk_wait<1, true>();
        load(tile + (NBUF - 1) * step, (i + NBUF - 1) % NBUF);
      }
    } else {
      __nv_bfloat16* dst = out + static_cast<size_t>(img) * C * P + p0;
      for (int f = gt; f < C * TPX; f += GT) {
        const int r = f / TPX, q = f - r * TPX;
        if (p0 + q < P) dst[static_cast<size_t>(r) * P + q] = cur[x_at(r, q)];
      }
    }
  }
  if constexpr (VEC) {
    if (gt == 0) bulk_wait<0, false>();  // the stores are done before exit
  }
}

// ---------------- launches -------------------------------------------------

// Raises a kernel's dynamic shared-memory cap once per device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* ready) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  return cudaSuccess;
}

template <int C, bool VEC>
cudaError_t prepare() {
  static bool ready[MAX_DEV] = {false};
  return allow_smem(gdn_kernel<C, VEC>, Plan<C>::SMEM, ready);
}

template <int C, bool VEC>
cudaError_t prepare_bf16() {
  static bool ready[MAX_DEV] = {false};
  return allow_smem(gdn_bf16_kernel<C, VEC>, Bf16Plan<C>::SMEM, ready);
}

template <int C, bool VEC>
cudaError_t launch(const float* x, const float* beta, const float* gamma_t,
                   float* out, int n, int P, bool inverse,
                   cudaStream_t stream) {
  cudaError_t e = prepare<C, VEC>();
  if (e != cudaSuccess) return e;
  const dim3 grid((P + TP - 1) / TP, n);
  gdn_kernel<C, VEC><<<grid, NT, Plan<C>::SMEM, stream>>>(
      x, beta, gamma_t, out, P, inverse);
  return cudaGetLastError();
}

// resident bf16-mode blocks of the whole device: the persistent grid's cap
template <int C, bool VEC>
cudaError_t bf16_slots(int* slots) {
  static int cached[MAX_DEV] = {0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!cached[device]) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gdn_bf16_kernel<C, VEC>, BT, Bf16Plan<C>::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = sms * per_sm;
  }
  *slots = cached[device];
  return cudaSuccess;
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

// [rows][P] bf16 as a 2-D map of 64-pixel x `box_rows` boxes, 128-byte
// swizzle; pixels past P read as zeros and are not written
bool encode_rows(CUtensorMap* m, const void* ptr, int P, long long rows,
                 int box_rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(P) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C, bool VEC>
cudaError_t launch_bf16(const void* x, const void* beta, const void* gamma,
                        void* out, int n, int P, bool inverse,
                        cudaStream_t stream) {
  cudaError_t e = prepare_bf16<C, VEC>();
  if (e != cudaSuccess) return e;
  int slots = 0;
  e = bf16_slots<C, VEC>(&slots);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>(n) *
                          ((P + Bf16Plan<C>::TP - 1) / Bf16Plan<C>::TP);
  if (tiles > (1LL << 30)) return cudaErrorInvalidValue;
  CUtensorMap tm_x{}, tm_out{};  // the vector path's TMA maps
  if (VEC && (!encode_rows(&tm_x, x, P, static_cast<long long>(n) * C, C) ||
              !encode_rows(&tm_out, out, P, static_cast<long long>(n) * C,
                           C)))
    return cudaErrorInvalidValue;
  // a block's groups walk a tile each at a time
  const long long groups = (tiles + Bf16Plan<C>::GROUPS - 1) /
                           Bf16Plan<C>::GROUPS;
  const int grid = static_cast<int>(groups < slots ? groups : slots);
  gdn_bf16_kernel<C, VEC><<<grid, BT, Bf16Plan<C>::SMEM, stream>>>(
      tm_x, tm_out, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<__nv_bfloat16*>(out), n, P, inverse);
  return cudaGetLastError();
}

// blocks resident an SM (vector path), pixels a block (a tile), shared
// bytes a block
template <int C>
cudaError_t occupancy(bool bf16, int* res) {
  cudaError_t e;
  if (bf16) {
    e = prepare_bf16<C, true>();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        res, gdn_bf16_kernel<C, true>, BT, Bf16Plan<C>::SMEM);
    res[1] = Bf16Plan<C>::TP;
    res[2] = static_cast<int>(Bf16Plan<C>::SMEM);
    return e;
  }
  e = prepare<C, true>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      res, gdn_kernel<C, true>, NT, Plan<C>::SMEM);
  res[1] = TP;
  res[2] = static_cast<int>(Plan<C>::SMEM);
  return e;
}

template <int C>
cudaError_t dispatch(const float* x, const float* beta, const float* gamma_t,
                     float* out, int n, int P, bool inverse, bool vec,
                     cudaStream_t stream) {
  return vec ? launch<C, true>(x, beta, gamma_t, out, n, P, inverse, stream)
             : launch<C, false>(x, beta, gamma_t, out, n, P, inverse, stream);
}

template <int C>
cudaError_t dispatch_bf16(const void* x, const void* beta, const void* gamma,
                          void* out, int n, int P, bool inverse, bool vec,
                          cudaStream_t stream) {
  return vec ? launch_bf16<C, true>(x, beta, gamma, out, n, P, inverse,
                                    stream)
             : launch_bf16<C, false>(x, beta, gamma, out, n, P, inverse,
                                     stream);
}

}  // namespace

extern "C" {

// GDN (inverse = 0) or inverse GDN (inverse = 1) of x [n, c, P] (NCHW with
// P = H * W) into out [n, c, P], f32; beta [c] and gamma_t [c, c] =
// gamma^T ([C_in, C_out]), all contiguous, gamma_t 16-byte aligned.  vec = 1
// takes float4 pixel copies, loads and stores (P % 4 == 0 and x, out
// 16-byte aligned).  Returns the cudaError_t of the launch (0 on success),
// or cudaErrorInvalidValue for shapes the kernel does not take (c not in
// {64, 128, 192, 256}).
int crdr_gdn(const float* x, const float* beta, const float* gamma_t,
             float* out, int n, int c, int P, int inverse, int vec,
             void* stream) {
  if (n <= 0 || n > 65535 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  const bool v = vec != 0;
  cudaError_t e;
  switch (c) {
    case 64: e = dispatch<64>(x, beta, gamma_t, out, n, P, inv, v, st); break;
    case 128: e = dispatch<128>(x, beta, gamma_t, out, n, P, inv, v, st); break;
    case 192: e = dispatch<192>(x, beta, gamma_t, out, n, P, inv, v, st); break;
    case 256: e = dispatch<256>(x, beta, gamma_t, out, n, P, inv, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The bf16 mode: x, out [n, c, P], beta [c] and gamma [c, c] as stored
// ([C_out, C_in]), all bf16 and contiguous, gamma 16-byte aligned.  vec = 1
// moves the tiles with TMA (P % 8 == 0 and x, out 16-byte aligned; a map
// that cannot be encoded returns cudaErrorInvalidValue).  Returns as
// crdr_gdn.
int crdr_gdn_bf16(const void* x, const void* beta, const void* gamma,
                  void* out, int n, int c, int P, int inverse, int vec,
                  void* stream) {
  if (n <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  const bool v = vec != 0;
  cudaError_t e;
  switch (c) {
    case 64: e = dispatch_bf16<64>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 128: e = dispatch_bf16<128>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 192: e = dispatch_bf16<192>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 256: e = dispatch_bf16<256>(x, beta, gamma, out, n, P, inv, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The plan of channel count c in the f32 (bf16 = 0) or bf16 mode: res[0]
// blocks resident an SM (the occupancy calculator's, with the kernel's
// shared memory), res[1] pixels a block (a tile), res[2] shared-memory bytes
// a block.  Returns a cudaError_t.
int crdr_gdn_occupancy(int c, int bf16, int* res) {
  cudaError_t e;
  const bool b = bf16 != 0;
  switch (c) {
    case 64: e = occupancy<64>(b, res); break;
    case 128: e = occupancy<128>(b, res); break;
    case 192: e = occupancy<192>(b, res); break;
    case 256: e = occupancy<256>(b, res); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
