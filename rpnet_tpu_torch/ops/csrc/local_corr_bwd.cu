// Backward of the local correlation, hand-written for Hopper (sm_90a).
// Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py with nvcc
// and loaded with ctypes.
//
// Replaces: rpnet_tpu/ops/pallas/correlation.py::_corr_bwd_kernel (:776),
// the TPU kernel behind local_correlation_pallas_bwd (RPNET_CORR_BWD=pallas),
// and the XLA banded-matmul backward that the TPU runs by default,
// rpnet_tpu/ops/correlation.py::local_correlation_mxu_bwd (:91-140). With
// d = 2r+1, delta = (dy-r, dx-r), zero outside the image and quirk channel
// order k = dx*d + dy, it computes both input gradients in the GATHERED form
// (no scatter, no atomics, the same result on every run):
//
//   dfm1[b,p,c] = cast(scale * sum_k g[b,p,k]         * fm2[b,p+delta,c])
//   dfm2[b,q,c] = cast(scale * sum_k g[b,q-delta,k]   * fm1[b,q-delta,c])
//
// with the sums in f32 and scale = f32(1/sqrt(C)) applied once before the one
// rounding to the input dtype (f32 on the training path, bf16 as well).
// Writing dx' = 2r-dx, dy' = 2r-dy, the second is the first with fm1 as the
// slab and the weights w2[q,dx',dy'] = g[q+(dy'-r,dx'-r), (2r-dx')*d+2r-dy'],
// so one kernel body computes either gradient; blockIdx.z picks which.
//
// Bound at the training shape (48 slices, 64x64, C=256, r=5, f32): it reads
// g (48x64x64x121) and fm1, fm2 once and writes dfm1, dfm2 once, about
// 900 MB, 0.27 ms at 3.35 TB/s; it does 22.3 GFLOP of in-image products
// (twice the forward's), 0.33 ms on the 67 TFLOP/s of the FP32 FMA units it
// uses. So it is bound by operations near 0.33 ms. The training step
// launches it once per CRE call (5 per step at n_iter_refinement 4).
//
// Design (simple and right first): one block per (image, gradient,
// 4-row x 32-column tile), 128 threads. The block stages its tile's d x d
// weights per pixel in shared memory once, as f32 (dfm1: a straight copy of
// g's pixel rows; dfm2: a gather from the haloed neighbourhood). Then it
// walks the channels 16 at a time: the source's haloed (4+2r) x (32+2r)
// slab of 16 channels goes through registers (16-byte loads, issued one
// step ahead so they are in flight while the current step computes) into
// shared memory, pixel-major with a 20-float pitch so that a quarter warp's
// 16-byte reads fall on distinct banks. Thread (channel quad, column group,
// row) owns 4 adjacent pixels x 4 channels: per vertical shift dy it loads
// the 4 pixels' d weights (3 16-byte reads each) and the slab row's
// 4+2r pixels' 4 channels (one 16-byte read each), and does 4*d*4 FMAs,
// about 7 FMAs per shared read. g is read with its pixel stride, so the
// CRE's concat gradient (121 of 377 channels per pixel) is taken without a
// copy. Tensor cores (band products) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 4;          // output rows per block
constexpr int P = 4;           // adjacent output columns per thread
constexpr int XG = 8;          // column groups per block
constexpr int TX = P * XG;     // output columns per block
constexpr int CC = 16;         // channels staged per step; C must be a multiple
constexpr int Q = 4;           // channels per thread
constexpr int CG = CC / Q;     // channel quads per step
constexpr int NT = CG * XG * TY;   // threads per block
constexpr int SPITCH = CC + 4;     // floats per slab pixel (banks)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The V = 16 / sizeof(T) channels of one 16-byte load, as f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 is the high half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Four channels of one pixel, rounded once to T.
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);   // round to nearest even
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

template <int R> struct Geometry {
  static constexpr int D = 2 * R + 1;
  static constexpr int DP = (D + 3) / 4 * 4;     // weights per (pixel, dy), padded
  static constexpr int SR = TY + 2 * R;          // slab rows
  static constexpr int SC = TX + 2 * R;          // slab columns
  static constexpr int WFLOATS = TY * TX * D * DP;
  static constexpr int SFLOATS = SR * SC * SPITCH;
  static constexpr int SMEM = (WFLOATS + SFLOATS) * 4;
};

template <typename T, int R>
__global__ void __launch_bounds__(NT)
local_corr_bwd_kernel(const T* __restrict__ g, int g_pitch,
                      const T* __restrict__ fm1, const T* __restrict__ fm2,
                      T* __restrict__ dfm1, T* __restrict__ dfm2,
                      int H, int W, int C, float scale) {
  using G = Geometry<R>;
  constexpr int D = G::D, DP = G::DP, SR = G::SR, SC = G::SC;
  constexpr int V = 16 / sizeof(T);        // channels per 16-byte load
  constexpr int PARTS = CC / V;            // 16-byte loads per pixel and step
  constexpr int U = SR * SC * PARTS;       // loads of the slab per step
  constexpr int NU = (U + NT - 1) / NT;    // loads per thread per step
  extern __shared__ float4 smem4[];
  float* wts = reinterpret_cast<float*>(smem4);   // [TY*TX][D][DP]
  float* slab = wts + G::WFLOATS;                  // [SR][SC][SPITCH]

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int xg = (tid / CG) % XG;
  const int ty = tid / (CG * XG);

  const int second = blockIdx.z & 1;       // 0: dfm1, 1: dfm2
  const int b = blockIdx.z >> 1;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const size_t img = static_cast<size_t>(b) * H * W;
  const T* src = second ? fm1 : fm2;
  T* dst = second ? dfm2 : dfm1;

  // ---- the tile's weights, once: wts[pix][dy][dx], zero outside ----
  for (int u = tid; u < TY * TX * D * D; u += NT) {
    const int pix = u / (D * D), k = u % (D * D);
    const int dx = k / D, dy = k % D;
    int y = y0 + pix / TX, x = x0 + pix % TX, kg = k;
    if (second) {   // g[q + (dy-R, dx-R), (2R-dx)*D + (2R-dy)]
      y += dy - R;
      x += dx - R;
      kg = (2 * R - dx) * D + (2 * R - dy);
    }
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = to_f32(g[(img + static_cast<size_t>(y) * W + x) * g_pitch + kg]);
    wts[(pix * D + dy) * DP + dx] = v;
  }
  for (int u = tid; u < TY * TX * D * (DP - D); u += NT) {   // the pad
    const int row = u / (DP - D);
    wts[row * DP + D + u % (DP - D)] = 0.f;
  }

  // ---- the slab of CC channels: fetch to registers, stash to shared ----
  uint4 buf[NU];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = tid + k * NT;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (u < U) {
        const int part = u % PARTS, px = u / PARTS;
        const int y = y0 - R + px / SC, x = x0 - R + px % SC;
        if (y >= 0 && y < H && x >= 0 && x < W)   // zero outside the image
          v = *reinterpret_cast<const uint4*>(
              src + (img + static_cast<size_t>(y) * W + x) * C + c0 + part * V);
      }
      buf[k] = v;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = tid + k * NT;
      if (u < U) {
        const int part = u % PARTS, px = u / PARTS;
        float f[V];
        unpack(buf[k], f);
        float* s = slab + px * SPITCH + part * V;
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(s + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  const int y = y0 + ty;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const bool more = c0 + CC < C;
    if (more) fetch(c0 + CC);   // in flight while this step computes

    float acc[P][Q];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[p][q] = 0.f;

#pragma unroll 1
    for (int dy = 0; dy < D; ++dy) {
      float w[P][DP];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* wp = wts + ((ty * TX + xg * P + p) * D + dy) * DP;
#pragma unroll
        for (int i = 0; i < DP; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wp + i);
          w[p][i] = v.x; w[p][i + 1] = v.y; w[p][i + 2] = v.z; w[p][i + 3] = v.w;
        }
      }
      const float* srow = slab + ((ty + dy) * SC + xg * P) * SPITCH + cg * Q;
      // slab column xg*P + j holds the source at dx = j - p for output column p
#pragma unroll
      for (int j = 0; j < P + 2 * R; ++j) {
        const float4 s = *reinterpret_cast<const float4*>(srow + j * SPITCH);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int dx = j - p;
          if (dx >= 0 && dx < D) {
            acc[p][0] = fmaf(w[p][dx], s.x, acc[p][0]);
            acc[p][1] = fmaf(w[p][dx], s.y, acc[p][1]);
            acc[p][2] = fmaf(w[p][dx], s.z, acc[p][2]);
            acc[p][3] = fmaf(w[p][dx], s.w, acc[p][3]);
          }
        }
      }
    }

    if (y < H) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int x = x0 + xg * P + p;
        if (x < W) {
          float v[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) v[q] = acc[p][q] * scale;
          store4(dst + (img + static_cast<size_t>(y) * W + x) * C + c0 + cg * Q, v);
        }
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* g, int g_pitch, const void* fm1, const void* fm2,
                   void* dfm1, void* dfm2, int B, int H, int W, int C,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Geometry<R>::SMEM;
  auto kernel = local_corr_bwd_kernel<T, R>;
  static bool configured = false;   // above 48 KB needs the opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, 2 * B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(g), g_pitch, static_cast<const T*>(fm1),
      static_cast<const T*>(fm2), static_cast<T*>(dfm1), static_cast<T*>(dfm2),
      H, W, C, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* g, int g_pitch, const void* fm1, const void* fm2,
             void* dfm1, void* dfm2, int B, int H, int W, int C, int r,
             float scale, void* stream) {
  // 16-byte loads and stores of CC-channel steps: aligned tensors, C a
  // multiple of CC; g's pixel pitch covers its d*d channels
  const int d = 2 * r + 1;
  if (C % CC != 0 || g_pitch < d * d || B < 1 || 2 * B > 65535 ||
      reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fm2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dfm1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dfm2) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<T, 1>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, scale, s);
    case 2: return launch<T, 2>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, scale, s);
    case 3: return launch<T, 3>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, scale, s);
    case 4: return launch<T, 4>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, scale, s);
    case 5: return launch<T, 5>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched). g is (B, H, W, d*d)
// with pixel pitch g_pitch elements and unit channel stride; fm1, fm2, dfm1
// and dfm2 are contiguous (B, H, W, C).
extern "C" int local_corr_bwd_f32(const void* g, int g_pitch, const void* fm1,
                                  const void* fm2, void* dfm1, void* dfm2,
                                  int B, int H, int W, int C, int r,
                                  float scale, void* stream) {
  return dispatch<float>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C, r,
                         scale, stream);
}

extern "C" int local_corr_bwd_bf16(const void* g, int g_pitch, const void* fm1,
                                   const void* fm2, void* dfm1, void* dfm2,
                                   int B, int H, int W, int C, int r,
                                   float scale, void* stream) {
  return dispatch<__nv_bfloat16>(g, g_pitch, fm1, fm2, dfm1, dfm2, B, H, W, C,
                                 r, scale, stream);
}

extern "C" const char* local_corr_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
