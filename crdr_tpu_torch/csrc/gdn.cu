// K3 — GDN / inverse GDN on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel crdr_tpu/ops/pallas_gdn.py (pallas_gdn,
// body _gdn_kernel): out = x * (beta + (x*x) . gamma^T)^(-1/2), or ^(+1/2)
// for the inverse, with gamma stored [C_out, C_in] (the torch conv1x1
// layout of nn.norm.GDN) and the product accumulated in f32.  The TPU kernel
// runs it on [M, C] rows with the product on the MXU inside its body; this
// kernel computes the product itself, in f32 FFMA (no TF32: the Balle18
// transforms run at `highest`).
//
// Layout.  x and out are NCHW f32, read and written as they lie: for image n,
// out[:, p] = x[:, p] * rsqrt(beta + gamma . x[:, p]^2), a [C x C] . [C x P]
// product per image with the pixels contiguous, so there is no permute.
//
// Bound.  At the Balle18 path's largest call ([4, 192, 256, 384]) the
// product is 2 * M * C^2 = 29.0 GFLOP against 604 MB moved (x read once,
// out written once): about 0.43 ms at the H100's ~67 TFLOP/s f32 rate and
// 0.18 ms at 3.35 TB/s, so the call is bound by operations.
//
// Design (simple and right first).  One block per (64-pixel tile, image),
// 256 threads as 16 pixel groups x 16 channel groups.  The tile's x^2
// ([C x 64] f32, 48 KB at C = 192) sits in shared memory for the whole
// block; gamma is staged in 32-column chunks, transposed to [k][o] so that a
// thread reads its output channels as float4s.  Each thread accumulates a
// (C/16 out-channels x 4 pixels) register tile, then applies + beta,
// rsqrt / sqrt and * x, and stores along the pixels (float4 when the pixel
// count and the pointers allow it).  Every output sums c = 0..C-1 in one
// fixed order, with no split-K and no atomics, so a pixel's result does not
// depend on its tile, its image or the batch size: a batch-1 stream equals
// its batch-4 stream.  C is a multiple of 64, at most 256 (the shared-memory
// plan: 97 KB at C = 256).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TP = 64;                 // pixels per block (one image)
constexpr int KC = 32;                 // gamma columns (input channels) a chunk
constexpr int PG = TP / 4;             // pixel groups of 4
constexpr int CG = 16;                 // channel groups
constexpr int NT = PG * CG;            // threads per block
constexpr int MAX_DEV = 64;

__host__ __device__ constexpr int gamma_pitch(int c) { return c + 4; }

__host__ __device__ constexpr size_t smem_bytes(int c) {
  return (static_cast<size_t>(c) * TP + static_cast<size_t>(KC) *
          gamma_pitch(c)) * sizeof(float);
}

template <int CPT, bool VEC>
__global__ void __launch_bounds__(NT)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ beta,
           const float* __restrict__ gamma, float* __restrict__ out, int P,
           bool inverse) {
  constexpr int C = CPT * CG;
  constexpr int GP = gamma_pitch(C);
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [C][TP]   x^2 of the tile
  float* gs = smem + C * TP;      // [KC][GP]  gamma[o][c0 + k] at gs[k][o]

  const int tid = threadIdx.x;
  const int pg = tid % PG;
  const int cg = tid / PG;
  const int p0 = blockIdx.x * TP;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * P;
  const float* xn = x + base;
  float* on = out + base;

  for (int i = tid; i < C * TP; i += NT) {
    const int c = i / TP;
    const int p = p0 + i % TP;
    const float v = p < P ? xn[static_cast<size_t>(c) * P + p] : 0.0f;
    xs[i] = v * v;
  }

  float acc[CPT][4];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the tile is written; the previous chunk is consumed
    for (int i = tid; i < KC * C; i += NT) {
      const int o = i / KC;
      const int k = i % KC;
      gs[k * GP + o] = gamma[static_cast<size_t>(o) * C + c0 + k];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + (c0 + k) * TP + pg * 4);
      const float* g = gs + k * GP + cg * CPT;
#pragma unroll
      for (int j = 0; j < CPT; j += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g + j);
        const float gj[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[j + u][0] = fmaf(gj[u], xv.x, acc[j + u][0]);
          acc[j + u][1] = fmaf(gj[u], xv.y, acc[j + u][1]);
          acc[j + u][2] = fmaf(gj[u], xv.z, acc[j + u][2]);
          acc[j + u][3] = fmaf(gj[u], xv.w, acc[j + u][3]);
        }
      }
    }
  }

  const int pp = p0 + pg * 4;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int o = cg * CPT + j;
    const float b = beta[o];
    const size_t row = static_cast<size_t>(o) * P;
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

// Raises the kernel's dynamic shared-memory cap once per device.
template <int CPT, bool VEC>
cudaError_t launch(const float* x, const float* beta, const float* gamma,
                   float* out, int n, int P, bool inverse,
                   cudaStream_t stream) {
  static bool ready[MAX_DEV] = {false};
  constexpr int C = CPT * CG;
  const size_t smem = smem_bytes(C);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    e = cudaFuncSetAttribute(gdn_kernel<CPT, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  const dim3 grid((P + TP - 1) / TP, n);
  gdn_kernel<CPT, VEC><<<grid, NT, smem, stream>>>(x, beta, gamma, out, P,
                                                    inverse);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t dispatch(const float* x, const float* beta, const float* gamma,
                     float* out, int n, int P, bool inverse, bool vec,
                     cudaStream_t stream) {
  return vec ? launch<CPT, true>(x, beta, gamma, out, n, P, inverse, stream)
             : launch<CPT, false>(x, beta, gamma, out, n, P, inverse, stream);
}

}  // namespace

extern "C" {

// GDN (inverse = 0) or inverse GDN (inverse = 1) of x [n, c, P] f32 (NCHW
// with P = H * W) into out [n, c, P]; beta [c], gamma [c, c] ([C_out, C_in])
// f32, all contiguous.  vec = 1 takes float4 pixel loads and stores (P % 4
// == 0 and x, out 16-byte aligned).  Returns the cudaError_t of the launch
// (0 on success), or cudaErrorInvalidValue for shapes the kernel does not
// take (c not in {64, 128, 192, 256}).
int crdr_gdn(const float* x, const float* beta, const float* gamma,
             float* out, int n, int c, int P, int inverse, int vec,
             void* stream) {
  if (n <= 0 || n > 65535 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  const bool v = vec != 0;
  cudaError_t e;
  switch (c) {
    case 64: e = dispatch<4>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 128: e = dispatch<8>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 192: e = dispatch<12>(x, beta, gamma, out, n, P, inv, v, st); break;
    case 256: e = dispatch<16>(x, beta, gamma, out, n, P, inv, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
