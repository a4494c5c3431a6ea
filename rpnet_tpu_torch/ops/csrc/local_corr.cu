// Local correlation for the context relation encoder, hand-written for Hopper
// (sm_90a). Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py
// with nvcc and loaded with ctypes.
//
// Replaces: rpnet_tpu/ops/pallas/correlation.py::_corr_rot_kernel (select
// mode), the TPU kernel that local_correlation_pallas_rot launches on the
// eval path. It computes what that kernel computes, in the order the
// consumer (the CRE's 1x1 conv) wants, with none of the TPU layout devices
// (column-reversed fm2, 128-lane pad, dy-major dx-reversed channels):
//
//   out[b,y,x,dx*d+dy] = cast(scale * sum_c f32(fm1[b,y,x,c])
//                                         * f32(fm2[b,y+dy-r,x+dx-r,c]))
//
// d = 2r+1, zero outside the image, f32 accumulation, one rounding to the
// input dtype (bf16 on the eval path, f32 under compute_dtype: float32).
//
// Bound at the eval shape (B=32 slices, 64x64, C=256, r=5, bf16): the
// function reads fm1 and fm2 once (2 x 67.1 MB) and writes 31.7 MB, 166 MB
// in all, about 50 us at the H100 SXM's 3.35 TB/s. It does 8.1 GFLOP: about
// 8 us on bf16 tensor cores, but about 120 us on the FP32 FMA units this
// kernel uses, so it is arithmetic-bound near 120 us; the memory bound of
// about 50 us is the floor a tensor-core version could approach. The eval
// main path launches it 11 times per episode (once per support, once per
// refinement iteration).
//
// Design (simple and right first): one block per (image, 4-row x 32-column
// output tile). Channels are staged through shared memory 16 at a time as
// f32: the fm1 tile and fm2's haloed (4+2r) x (32+2r) slab, channel-major,
// with an odd slab row pitch so that a warp's 32 reads (8 column groups x 4
// shifts dy) fall on 32 different banks. Global memory is read in 16-byte
// loads (one pixel's 16 channels are 32 or 64 contiguous bytes), and the
// loads of the next 16 channels are issued before the current ones are used,
// so their latency hides behind the FMAs. Thread (column group, dy, row)
// owns one vertical shift dy and 4 adjacent output pixels; it keeps the
// 4 x d sums in registers and reads each slab value once for up to 4 FMAs
// (register blocking along x). Tensor cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 4;        // output rows per block
constexpr int P = 4;         // adjacent output columns per thread
constexpr int XG = 8;        // column groups per block
constexpr int TX = P * XG;   // output columns per block
constexpr int CC = 16;       // channels staged per step; C must be a multiple

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

template <typename T, int R>
__global__ void __launch_bounds__((2 * R + 1) * XG * TY)
local_corr_kernel(const T* __restrict__ fm1, const T* __restrict__ fm2,
                  T* __restrict__ out, int H, int W, int C, float scale) {
  constexpr int D = 2 * R + 1;
  constexpr int SR = TY + 2 * R;           // slab rows
  constexpr int SC = TX + 2 * R;           // slab columns
  constexpr int SP = SC + 1;               // slab row pitch, odd (banks)
  constexpr int NT = D * XG * TY;          // threads per block
  constexpr int V = 16 / sizeof(T);        // channels per 16-byte load
  constexpr int PARTS = CC / V;            // 16-byte loads per pixel and step
  constexpr int U1 = TY * TX * PARTS;      // loads of the fm1 tile per step
  constexpr int U = U1 + SR * SC * PARTS;  // ... and of the fm2 slab
  constexpr int NU = (U + NT - 1) / NT;    // loads per thread per step
  __shared__ float s1[CC][TY][TX];
  __shared__ float s2[CC][SR][SP];

  const int xg = threadIdx.x;
  const int dy = threadIdx.y;
  const int ty = threadIdx.z;
  const int tid = threadIdx.x + XG * (threadIdx.y + D * threadIdx.z);

  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;

  // Load u of a step: the fm1 tile's pixels first, then the slab's, each
  // pixel's PARTS loads adjacent (consecutive threads, consecutive bytes).
  uint4 buf[NU];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = tid + k * NT;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (u < U1) {
        const int part = u % PARTS, px = u / PARTS;
        const int y = y0 + px / TX, x = x0 + px % TX;
        if (y < H && x < W)
          v = *reinterpret_cast<const uint4*>(
              fm1 + (img + static_cast<size_t>(y) * W + x) * C + c0 + part * V);
      } else if (u < U) {
        const int part = (u - U1) % PARTS, px = (u - U1) / PARTS;
        const int y = y0 - R + px / SC, x = x0 - R + px % SC;
        if (y >= 0 && y < H && x >= 0 && x < W)   // zero outside the image
          v = *reinterpret_cast<const uint4*>(
              fm2 + (img + static_cast<size_t>(y) * W + x) * C + c0 + part * V);
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
        const int part = u % PARTS, px = u / PARTS;
#pragma unroll
        for (int e = 0; e < V; ++e) s1[part * V + e][px / TX][px % TX] = f[e];
      } else if (u < U) {
        const int part = (u - U1) % PARTS, px = (u - U1) / PARTS;
#pragma unroll
        for (int e = 0; e < V; ++e) s2[part * V + e][px / SC][px % SC] = f[e];
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
      // slab column xg*P + j holds fm2 at dx = j - p for output column p
#pragma unroll
      for (int j = 0; j < P + 2 * R; ++j) {
        const float v = s2[c][ty + dy][xg * P + j];
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
      T* o = out + (img + static_cast<size_t>(y) * W + x) * (D * D) + dy;
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
  local_corr_kernel<T, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fm1), static_cast<const T*>(fm2),
      static_cast<T*>(out), H, W, C, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* fm1, const void* fm2, void* out, int B, int H, int W,
             int C, int r, float scale, void* stream) {
  // 16-byte loads of CC-channel steps: aligned inputs, C a multiple of CC
  if (C % CC != 0 || reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
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

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int local_corr_f32(const void* fm1, const void* fm2, void* out,
                              int B, int H, int W, int C, int r, float scale,
                              void* stream) {
  return dispatch<float>(fm1, fm2, out, B, H, W, C, r, scale, stream);
}

extern "C" int local_corr_bf16(const void* fm1, const void* fm2, void* out,
                               int B, int H, int W, int C, int r, float scale,
                               void* stream) {
  return dispatch<__nv_bfloat16>(fm1, fm2, out, B, H, W, C, r, scale, stream);
}

extern "C" const char* local_corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
