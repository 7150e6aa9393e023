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
// The bf16 mode (transform_dtype: bfloat16 on the GDN families).  x and out
// are bf16; beta and gamma^T come in f32 (the wrapper upcasts the bf16
// parameters, exactly).  It computes the JAX package's bf16 composite
// (crdr_tpu/nn/norm.py's einsum path in bf16: JAX's Pallas kernel cannot
// store bf16), each step rounded to bf16 to nearest even: xx = bf16(x * x);
// n = bf16(sum_c xx_c * gamma[o][c]), the sum in f32 in the f32 mode's order;
// n = bf16(n + beta[o]); r = bf16(rsqrt(n)) or bf16(sqrt(n)), correctly
// rounded in f32 (__frsqrt_rn / __fsqrt_rn: rsqrtf is up to 2 ulp off, and
// XLA's bf16 rsqrt is the correctly rounded one); out = bf16(x * r).  Every
// product of two bf16 values is exact in f32, so each rounding is a single
// one.  The tile plan is the f32 mode's: a thread's x copy is 4 bf16 (an
// 8-byte cp.async into a bf16 staging row of the stage), squared into the
// stage's f32 x rows before the chunk's barrier, so the FFMA loop is the
// f32 mode's; the epilogue reads and writes bf16.
//
// Bound of the bf16 mode at [4, 192, 256, 384]: 302 MB of bf16 in and out,
// about 0.090 ms at 3.35 TB/s; the 29.0 GFLOP of the product take 0.029 ms
// at the bf16 tensor-core rate, so the bound is bytes.  This kernel runs the
// product in f32 FFMA, so it stays near the f32 mode's time, bound by its
// own operations.  The redesign: since every product xx_c * gamma[o][c] is
// of two bf16 values and exact in f32, a bf16 mma / wgmma with f32
// accumulation computes the same terms (in another summation order, which
// the twin then has to follow), and the kernel becomes memory-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TP = 64;      // pixels a block (one image)
constexpr int PG = TP / 4;  // pixel groups of 4
constexpr int CG = 16;      // channel groups
constexpr int NT = PG * CG; // threads a block
constexpr int KC = 16;      // input channels (rows of gamma^T and x) a chunk
constexpr int STAGES = 4;   // ring depth: chunk j + STAGES - 1 copies during j
constexpr int MAX_DEV = 64;

// A ring stage: [KC][C] of gamma^T and [KC][TP] of squared x, in f32; the
// bf16 mode adds the [KC][TP] bf16 rows its copies land in.
template <int C, bool BF16 = false>
struct Plan {
  static constexpr int CPT = C / CG;              // output channels a thread
  static constexpr int STAGE = KC * (C + TP) + (BF16 ? KC * TP / 2 : 0);
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE *
                                 sizeof(float);
  static constexpr int GSLOTS = KC * C / 4 / NT;  // gamma^T float4s a thread
  static_assert(C % (4 * CG) == 0 && C % KC == 0, "channel plan");
  static_assert(GSLOTS * 4 * NT == KC * C, "gamma^T copy plan");
  static_assert(KC * TP == 4 * NT, "x copy plan: one float4 a thread");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// f32 -> the nearest bf16 (ties to even), back in f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x^2 of a bf16 value, rounded to bf16 (the product is exact in f32)
__device__ __forceinline__ float square_bf16(__nv_bfloat16 v) {
  const float f = __bfloat162float(v);
  return round_bf16(__fmul_rn(f, f));
}

// the bf16 mode's epilogue for one pixel: bf16(x * bf16(rsqrt or sqrt of
// bf16(bf16(acc) + beta)))
__device__ __forceinline__ __nv_bfloat16 epilogue_bf16(float acc, float b,
                                                       float xe,
                                                       bool inverse) {
  const float nrm = round_bf16(__fadd_rn(round_bf16(acc), b));
  const float r = round_bf16(inverse ? __fsqrt_rn(nrm) : __frsqrt_rn(nrm));
  return __float2bfloat16_rn(__fmul_rn(xe, r));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int C, bool VEC, bool BF16>
__global__ void __launch_bounds__(NT, 2)
gdn_kernel(const void* __restrict__ x_, const float* __restrict__ beta,
           const float* __restrict__ gamma_t, void* __restrict__ out_, int P,
           bool inverse) {
  using PL = Plan<C, BF16>;
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int CPT = PL::CPT;
  constexpr int NCHUNK = C / KC;
  // STAGES x {[KC][C] gamma^T, [KC][TP] x^2 f32, bf16 mode: [KC][TP] x bf16}
  extern __shared__ __align__(16) float smem[];
  // x float4 (row tid / PG, pixels 4 * pg) of a chunk is this thread's copy

  const int tid = threadIdx.x;
  const int pg = tid % PG;
  const int cg = tid / PG;
  const int p0 = blockIdx.x * TP;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * P;
  const T* xn = static_cast<const T*>(x_) + base;
  T* on = static_cast<T*>(out_) + base;

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
    const T* src = xn + static_cast<size_t>(j * KC + cg) * P + p;
    if constexpr (BF16) {
      __nv_bfloat16* xb =
          reinterpret_cast<__nv_bfloat16*>(xs + KC * TP) + 4 * tid;
      if constexpr (VEC) {
        cp_async8(xb, p < P ? src : xn, p < P ? 8 : 0);
      } else {  // no 2-byte cp.async: plain loads, this thread's own slots
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xb[e] = p + e < P ? src[e] : __float2bfloat16_rn(0.0f);
      }
    } else if constexpr (VEC) {
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
    {  // square its x float4 (bf16 mode: its 4 bf16) into the f32 rows
      float4* v = reinterpret_cast<float4*>(xs) + tid;
      float4 t;
      if constexpr (BF16) {
        const __nv_bfloat16* xb =
            reinterpret_cast<const __nv_bfloat16*>(xs + KC * TP) + 4 * tid;
        t = make_float4(square_bf16(xb[0]), square_bf16(xb[1]),
                        square_bf16(xb[2]), square_bf16(xb[3]));
      } else {
        t = *v;
        t.x = __fmul_rn(t.x, t.x);
        t.y = __fmul_rn(t.y, t.y);
        t.z = __fmul_rn(t.z, t.z);
        t.w = __fmul_rn(t.w, t.w);
      }
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
    if constexpr (BF16) {
      if constexpr (VEC) {
        if (pp < P) {  // 4 bf16 = 8 bytes, aligned: P % 4 == 0
          const uint2 raw = *reinterpret_cast<const uint2*>(xn + row + pp);
          const __nv_bfloat16* xe =
              reinterpret_cast<const __nv_bfloat16*>(&raw);
          uint2 res;
          __nv_bfloat16* r = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[e] = epilogue_bf16(acc[j][e], b, __bfloat162float(xe[e]),
                                 inverse);
          *reinterpret_cast<uint2*>(on + row + pp) = res;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pp + e < P)
            on[row + pp + e] = epilogue_bf16(
                acc[j][e], b, __bfloat162float(xn[row + pp + e]), inverse);
      }
    } else if constexpr (VEC) {
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

// Raises the kernel's dynamic shared-memory cap once per device.
template <int C, bool VEC, bool BF16>
cudaError_t prepare() {
  static bool ready[MAX_DEV] = {false};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    e = cudaFuncSetAttribute(gdn_kernel<C, VEC, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Plan<C, BF16>::SMEM));
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  return cudaSuccess;
}

template <int C, bool VEC, bool BF16>
cudaError_t launch(const void* x, const float* beta, const float* gamma_t,
                   void* out, int n, int P, bool inverse,
                   cudaStream_t stream) {
  cudaError_t e = prepare<C, VEC, BF16>();
  if (e != cudaSuccess) return e;
  const dim3 grid((P + TP - 1) / TP, n);
  gdn_kernel<C, VEC, BF16><<<grid, NT, Plan<C, BF16>::SMEM, stream>>>(
      x, beta, gamma_t, out, P, inverse);
  return cudaGetLastError();
}

// blocks resident an SM (float4 path), pixels a block, shared bytes a block
template <int C, bool BF16>
cudaError_t occupancy(int* res) {
  cudaError_t e = prepare<C, true, BF16>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      res, gdn_kernel<C, true, BF16>, NT, Plan<C, BF16>::SMEM);
  res[1] = TP;
  res[2] = static_cast<int>(Plan<C, BF16>::SMEM);
  return e;
}

template <int C>
cudaError_t dispatch(const void* x, const float* beta, const float* gamma_t,
                     void* out, int n, int P, bool inverse, bool vec,
                     bool bf16, cudaStream_t stream) {
  if (bf16)
    return vec ? launch<C, true, true>(x, beta, gamma_t, out, n, P, inverse,
                                       stream)
               : launch<C, false, true>(x, beta, gamma_t, out, n, P, inverse,
                                        stream);
  return vec ? launch<C, true, false>(x, beta, gamma_t, out, n, P, inverse,
                                      stream)
             : launch<C, false, false>(x, beta, gamma_t, out, n, P, inverse,
                                       stream);
}

template <int C>
cudaError_t occupancy_of(bool bf16, int* res) {
  return bf16 ? occupancy<C, true>(res) : occupancy<C, false>(res);
}

}  // namespace

extern "C" {

// GDN (inverse = 0) or inverse GDN (inverse = 1) of x [n, c, P] (NCHW with
// P = H * W) into out [n, c, P], both f32 (bf16 = 0) or both bf16 (bf16 =
// 1); beta [c] and gamma_t [c, c] = gamma^T ([C_in, C_out]) f32 in either
// mode, all contiguous, gamma_t 16-byte aligned.  vec = 1 takes vector pixel
// copies, loads and stores (P % 4 == 0 and x, out 16-byte aligned in f32,
// 8-byte aligned in bf16).  Returns the cudaError_t of the launch (0 on
// success), or cudaErrorInvalidValue for shapes the kernel does not take (c
// not in {64, 128, 192, 256}).
int crdr_gdn(const void* x, const float* beta, const float* gamma_t,
             void* out, int n, int c, int P, int inverse, int vec, int bf16,
             void* stream) {
  if (n <= 0 || n > 65535 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  const bool v = vec != 0;
  const bool b = bf16 != 0;
  cudaError_t e;
  switch (c) {
    case 64: e = dispatch<64>(x, beta, gamma_t, out, n, P, inv, v, b, st); break;
    case 128: e = dispatch<128>(x, beta, gamma_t, out, n, P, inv, v, b, st); break;
    case 192: e = dispatch<192>(x, beta, gamma_t, out, n, P, inv, v, b, st); break;
    case 256: e = dispatch<256>(x, beta, gamma_t, out, n, P, inv, v, b, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The plan of channel count c in the f32 (bf16 = 0) or bf16 mode: res[0]
// blocks resident an SM (the occupancy calculator's, with the kernel's
// shared memory), res[1] pixels a block, res[2] shared-memory bytes a block.
// Returns a cudaError_t.
int crdr_gdn_occupancy(int c, int bf16, int* res) {
  cudaError_t e;
  const bool b = bf16 != 0;
  switch (c) {
    case 64: e = occupancy_of<64>(b, res); break;
    case 128: e = occupancy_of<128>(b, res); break;
    case 192: e = occupancy_of<192>(b, res); break;
    case 256: e = occupancy_of<256>(b, res); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
