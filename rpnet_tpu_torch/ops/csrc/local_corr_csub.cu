// Local correlation on the C-strided layout, hand-written for Hopper
// (sm_90a). Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py
// with nvcc and loaded with ctypes.
//
// Replaces: rpnet_tpu/ops/pallas/correlation.py::_corr_csub_kernel
// (local_correlation_pallas_csub, RPNET_CORR_IMPL=csub). That kernel takes
// fm1 and fm2 transposed to (B, H, C, W), W on the TPU's lanes and C on its
// sublanes, so that the channel reduction is plain vector adds. This one
// takes the same layout, W contiguous, and computes
//
//   out[b,y,x,dx*d+dy] = cast(scale * sum_c f32(fm1[b,y,c,x])
//                                         * f32(fm2[b,y+dy-r,c,x+dx-r]))
//
// d = 2r+1, zero outside the image, f32 FMA sums, one rounding to the input
// dtype, written in the usual (B, H, W, d^2) quirk order. The row and column
// pads are virtual (bounds checks on load); the TPU's 128-lane column pad is
// not materialised.
//
// Hopper reading of "channel reduction as plain adds": threads run along W,
// so every global load of a staged channel row is coalesced (consecutive
// threads, consecutive columns), and each thread reduces over C in its own
// registers, with no reduction across threads.
//
// Bound at the training shape (48 slices, 64x64, C=256, r=5, f32): the
// function reads 2 x 201 MB and writes 95 MB, 0.149 ms at 3.35 TB/s; its
// 11.2 GFLOP of in-image products take 0.167 ms on the FP32 units it uses,
// so it is bound by operations. At the eval shape (26 slices, bf16) it is
// bound by its 135 MB (40 us).
//
// Design (simple and right first): one block per (image, 4-row x 32-column
// output tile), local_corr.cu's design on this layout. Channels are staged
// 8 at a time as f32 in shared memory, channel-major: the fm1 tile and
// fm2's haloed (4+2r) x (32+2*8) slab (the halo rounded up to whole
// vectors), with an odd slab row pitch so that a warp's reads fall on
// different banks. Global memory is read in vectors of 4 columns (16 bytes
// of f32, 8 of bf16; W must be a multiple of 4), consecutive threads on
// consecutive vectors, and the next step's loads start into registers
// before the current step is used. Thread (column group, dy, row) owns
// one vertical shift dy and 4 adjacent output pixels, keeps the 4 x d sums
// in registers and reads each slab value once for up to 4 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 4;        // output rows per block
constexpr int P = 4;         // adjacent output columns per thread
constexpr int XG = 8;        // column groups per block
constexpr int TX = P * XG;   // output columns per block
constexpr int CC = 8;        // channels staged per step (48 KB of static shared
                             // memory hold 8 of the r=5 slab); C a multiple
constexpr int V = 4;         // columns per vector load; W must be a multiple

// V columns: 16 bytes of f32, 8 of bf16
template <typename T> struct Vec;
template <> struct Vec<float> { using type = uint4; };
template <> struct Vec<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[V]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint2& u, float (&f)[V]) {
  f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

template <typename T, int R>
__global__ void __launch_bounds__((2 * R + 1) * XG * TY)
local_corr_csub_kernel(const T* __restrict__ fm1, const T* __restrict__ fm2,
                       T* __restrict__ out, int H, int W, int C, float scale) {
  using VT = typename Vec<T>::type;
  constexpr int D = 2 * R + 1;
  constexpr int HALO = (R + V - 1) / V * V;   // staged columns each side, whole vectors
  constexpr int OFF = HALO - R;               // slab column of displacement dx=0, p=0
  constexpr int SR = TY + 2 * R;              // slab rows
  constexpr int SC = TX + 2 * HALO;           // slab columns
  constexpr int SP = SC + 1;                  // slab row pitch, odd (banks)
  constexpr int NT = D * XG * TY;             // threads per block
  constexpr int U1 = CC * TY * (TX / V);      // vector loads of the fm1 tile per step
  constexpr int U = U1 + CC * SR * (SC / V);  // ... and of the fm2 slab
  constexpr int NU = (U + NT - 1) / NT;       // vector loads per thread per step
  __shared__ float s1[CC][TY][TX];
  __shared__ float s2[CC][SR][SP];

  const int xg = threadIdx.x;
  const int dy = threadIdx.y;
  const int ty = threadIdx.z;
  const int tid = threadIdx.x + XG * (threadIdx.y + D * threadIdx.z);

  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const size_t img = static_cast<size_t>(blockIdx.z) * H;

  // Load u of a step: the fm1 tile's (channel, row, vector) first, then the
  // slab's, vectors fastest (consecutive threads, consecutive addresses). A
  // vector lies wholly inside or outside the image (W % V == 0).
  VT buf[NU];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = tid + k * NT;
      VT v = {};
      if (u < U1) {
        const int x = x0 + V * (u % (TX / V)), rest = u / (TX / V);
        const int y = y0 + rest % TY, c = c0 + rest / TY;
        if (y < H && x < W)
          v = *reinterpret_cast<const VT*>(fm1 + ((img + y) * C + c) * W + x);
      } else if (u < U) {
        const int u2 = u - U1;
        const int x = x0 - HALO + V * (u2 % (SC / V)), rest = u2 / (SC / V);
        const int y = y0 - R + rest % SR, c = c0 + rest / SR;
        if (y >= 0 && y < H && x >= 0 && x < W)   // zero outside the image
          v = *reinterpret_cast<const VT*>(fm2 + ((img + y) * C + c) * W + x);
      }
      buf[k] = v;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = tid + k * NT;
      float f[V];
      unpack(buf[k], f);
      if (u < U1) {
        const int xv = u % (TX / V), rest = u / (TX / V);
#pragma unroll
        for (int e = 0; e < V; ++e) s1[rest / TY][rest % TY][V * xv + e] = f[e];
      } else if (u < U) {
        const int u2 = u - U1, xv = u2 % (SC / V), rest = u2 / (SC / V);
#pragma unroll
        for (int e = 0; e < V; ++e) s2[rest / SR][rest % SR][V * xv + e] = f[e];
      }
    }
  };

  float acc[P][D];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < D; ++k) acc[p][k] = 0.f;

  fetch(0);
  stash();
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += CC) {
    const bool more = c0 + CC < C;
    if (more) fetch(c0 + CC);   // in flight while this step computes

#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      float a[P];
#pragma unroll
      for (int p = 0; p < P; ++p) a[p] = s1[c][ty][xg * P + p];
      // slab column OFF + xg*P + j holds fm2 at dx = j - p for output column p
#pragma unroll
      for (int j = 0; j < P + 2 * R; ++j) {
        const float v = s2[c][ty + dy][OFF + xg * P + j];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int dx = j - p;
          if (dx >= 0 && dx < D) acc[p][dx] = fmaf(a[p], v, acc[p][dx]);
        }
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int x = x0 + xg * P + p;
    if (x < W) {
      T* o = out + ((img + y) * W + x) * (D * D) + dy;
#pragma unroll
      for (int dx = 0; dx < D; ++dx) o[dx * D] = from_f32<T>(acc[p][dx] * scale);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* fm1, const void* fm2, void* out, int B, int H,
                   int W, int C, float scale, cudaStream_t stream) {
  const dim3 block(XG, 2 * R + 1, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  local_corr_csub_kernel<T, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fm1), static_cast<const T*>(fm2),
      static_cast<T*>(out), H, W, C, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* fm1, const void* fm2, void* out, int B, int H, int W,
             int C, int r, float scale, void* stream) {
  // vector loads of V columns: W a multiple of V, aligned tensors
  if (C % CC != 0 || W % V != 0 || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fm2) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<T, 1>(fm1, fm2, out, B, H, W, C, scale, s);
    case 2: return launch<T, 2>(fm1, fm2, out, B, H, W, C, scale, s);
    case 3: return launch<T, 3>(fm1, fm2, out, B, H, W, C, scale, s);
    case 4: return launch<T, 4>(fm1, fm2, out, B, H, W, C, scale, s);
    case 5: return launch<T, 5>(fm1, fm2, out, B, H, W, C, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point takes fm1, fm2 as (B, H, C, W) and writes out as
// (B, H, W, (2r+1)^2); it launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int local_corr_csub_f32(const void* fm1, const void* fm2, void* out,
                                   int B, int H, int W, int C, int r, float scale,
                                   void* stream) {
  return dispatch<float>(fm1, fm2, out, B, H, W, C, r, scale, stream);
}

extern "C" int local_corr_csub_bf16(const void* fm1, const void* fm2, void* out,
                                    int B, int H, int W, int C, int r, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(fm1, fm2, out, B, H, W, C, r, scale, stream);
}

extern "C" const char* local_corr_csub_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
