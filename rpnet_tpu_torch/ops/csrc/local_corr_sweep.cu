// The local-correlation kernel sweep's two own kernels, hand-written for
// Hopper (sm_90a). Plain C entry points, built by
// rpnet_tpu_torch/ops/kernels.py with nvcc and loaded with ctypes.
//
// Both compute the CRE's local correlation,
//
//   S[b,y,x,dx*d+dy] = sum_c f32(fm1[b,y,x,c]) * f32(fm2[b,y+dy-r,x+dx-r,c]),
//
// d = 2r+1, zero outside the image, summed in f32 and scaled by f32(1/sqrt C),
// in the layouts and loop orders of the two variants that
// bench_tools/corr_sweep.py writes for the TPU:
//
// * corr_swapped (local_corr_swapped_{f32,bf16}) replaces
//   _corr_kernel_swapped (bench_tools/corr_sweep.py:37): FP32 FMAs with the
//   horizontal shift dx outermost, writing planar (B, d^2, H, W) f32.
//   Bound at the sweep shape (32 slices, 64x64, C=256, r=5): the function
//   reads fm1 and fm2 once and writes d^2 planes, 0.0991 ms f32 / 0.0495 ms
//   bf16 at 3.35 TB/s. This body is bound by its loop order instead: dx
//   outermost makes a block read its fm1 tile and fm2 window once per dx,
//   and the inputs (268 MB f32) do not stay in the 50 MB L2 between dx, so
//   it moves d x the input bytes from device memory (3.9 GB f32, 1.16 ms at
//   3.35 TB/s). PERF.md has the versions and readings.
//   Design. A block owns HT = h_tile query rows x 64 columns of one image;
//   256 threads, thread (column, row group) keeps HT/4 vertically adjacent
//   queries. The full output tile (HT x 64 x 121 values: 484 a thread at
//   HT=16) does not fit in registers; one dx's share (HT/4 x d: 44 a thread)
//   does, so dx runs outermost, as on the TPU: for each dx the block streams
//   C through shared memory (a cp.async ring of up to 4 stages, 32 channel
//   bytes a pixel a stage at HT <= 16, 16 at HT = 32), each stage holding
//   the fm1 tile and the dx-shifted fm2 window (HT+2r rows x 64 columns,
//   zero outside the image) in 16-byte channel planes (a warp's 16-byte
//   reads are 32 consecutive pixels: no bank conflicts). Each thread's
//   copies are planned once per dx (source addresses and a validity mask);
//   a step only adds its channel offset. A thread reads
//   HT/4 fm1 vectors and HT/4+2r fm2 vectors per piece for HT/4 x d dot
//   products (reuse along y within the thread). After the last channel of a
//   dx it stores its d sums a query as d planes of the output: a warp
//   writes 32 consecutive columns of one (channel, row), 128-byte coalesced
//   stores. bf16 inputs are widened to f32 in registers (exact products).
//   The wrapper transposes and casts, as the TPU variant's does.
//
// * corr_rotmxu (local_corr_rotmxu_{f32,bf16}) replaces _corr_rot_kernel
//   (bench_tools/corr_sweep.py:100): a tensor-core band product per (image,
//   query column w, horizontal shift du), the TPU variant's (B, W, H, C)
//   space read straight from NHWC (a column's pixels are W*C elements
//   apart; no transpose copy). Output (B, H, W, lanes) in fm1's dtype, the
//   f32 sum scaled and rounded once: lanes = 128 with channels d^2..127
//   written as zeros (full_lanes, the next 1x1 conv's K = 128), or d^2.
//   Bound as corr_swapped's (full_lanes adds 7/121 output bytes; the bound
//   stays the function's); what bounds this body is the bytes its blocks
//   pull through L2 (each source column is staged by (4+2r)/4 blocks).
//   Design. A block owns 4 query columns w0..w0+3 x 16 query rows h0..h0+15
//   (one m-tile) of one image, with one warp per shift du (d warps). Per
//   64-byte channel step (two MMA k-steps) a 6-stage cp.async ring stages
//   the 64 queries and the 32 source rows h0-r .. h0-r+31 of the 4+2r
//   source columns w0-r .. w0+3+r (zero outside the image; rows past the
//   band only pad the n-tiles), 64 bytes a pixel with the 16-byte chunks
//   swizzled so fragment reads hit 32 banks; each thread's copies are
//   planned once per block. Warp du multiplies each query column c (16
//   queries) against the four n8 tiles of source column c+du's 32 rows (the
//   band j in [h, h+2r] of every query lies inside them: the TPU's N = 128
//   padded rows cut to 32): 64 accumulators a thread. bf16: mma.sync
//   m16n8k16, f32 accumulators (exact products). f32: 3xTF32 on m16n8k8,
//   each operand split by masking into a TF32 value and its exact f32
//   remainder (the dropped small*small term leaves about 2^-19 of each
//   product). The band element (query m, source row j) lands at channel
//   du*d + (j - m) of a (16, 4, 128) output tile in shared memory, zeroed
//   first so unused lanes are zero, never stale; the block then stores each
//   query row's 4 pixels as one run (with lanes = 128: aligned 16-byte
//   pieces, 1 KB in bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// 16 bytes of shared memory as NV floats (bf16 widened exactly)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int NV = 4;
  __device__ __forceinline__ static void load(const unsigned char* p, float (&v)[NV]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int NV = 8;
  __device__ __forceinline__ static void load(const unsigned char* p, float (&v)[NV]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i is the low half of word i
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// ------------------------------------------------------------ corr_swapped

constexpr int SW_COLS = 64;                 // query columns a block
constexpr int SW_ROWG = 4;                  // thread row groups
constexpr int SW_NT = SW_COLS * SW_ROWG;    // threads a block

template <int HT, int R>
struct SwGeometry {
  static constexpr int D = 2 * R + 1;
  static constexpr int QPT = HT / SW_ROWG;           // queries a thread (along y)
  static constexpr int KP = HT <= 16 ? 2 : 1;        // 16-byte channel pieces a stage
  static constexpr int WROWS = HT + 2 * R;           // fm2 window rows
  static constexpr int NPX = (HT + WROWS) * SW_COLS; // staged pixels
  static constexpr int PLANE = NPX * 16;             // bytes of one piece plane
  static constexpr int STAGE = KP * PLANE;
  static constexpr int FIT = 232448 / STAGE;         // stages in 227 KB
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;   // the cp.async ring
  static constexpr int SMEM = NSTAGE * STAGE;
  static constexpr int NIT = (NPX * KP + SW_NT - 1) / SW_NT;   // copies a thread a stage
  static_assert(HT % SW_ROWG == 0, "rows a block split over the row groups");
  static_assert(NSTAGE >= 2, "a stage in flight while one computes");
  static_assert(NIT <= 32, "one validity bit a copy");
};

template <typename T, int R, int HT>
__global__ void __launch_bounds__(SW_NT, 1)
local_corr_swapped_kernel(const T* __restrict__ fm1, const T* __restrict__ fm2,
                          float* __restrict__ out, int H, int W, int C, float scale) {
  using G = SwGeometry<HT, R>;
  constexpr int D = G::D, QPT = G::QPT, KP = G::KP, NS = G::NSTAGE, NV = Vec<T>::NV;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tx = threadIdx.x % SW_COLS, tr = threadIdx.x / SW_COLS;
  const int x0 = blockIdx.x * SW_COLS, y0 = blockIdx.y * HT;
  const size_t img = static_cast<size_t>(blockIdx.z) * H;
  const uint32_t smem_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int cbytes = C * static_cast<int>(sizeof(T));
  const int nk = cbytes / (16 * KP);   // channel steps a dx (C*sizeof(T) % 32 == 0)
  const int nsteps = D * nk;

  // A thread's copies are the same pieces (u = tid + 256*it: pixel u / KP,
  // piece u % KP) at every step; only the channel offset and, between dx,
  // the window's columns change. So the source addresses and their
  // validity are planned once per dx, and a step adds its channel offset.
  const unsigned char* src[G::NIT];
  uint32_t valid = 0;
  auto plan = [&](int dx) {
    valid = 0;
#pragma unroll
    for (int it = 0; it < G::NIT; ++it) {
      const int u = threadIdx.x + it * SW_NT, px = u / KP, p = u % KP;
      int row, col;
      const T* src_t;
      if (px < HT * SW_COLS) {
        row = y0 + px / SW_COLS;
        col = x0 + px % SW_COLS;
        src_t = fm1;
      } else {
        const int q = px - HT * SW_COLS;
        row = y0 - R + q / SW_COLS;
        col = x0 + q % SW_COLS + dx - R;
        src_t = fm2;
      }
      src[it] = reinterpret_cast<const unsigned char*>(fm1);   // any valid address
      if (u < G::NPX * KP && row >= 0 && row < H && col >= 0 && col < W) {   // zero outside
        src[it] = reinterpret_cast<const unsigned char*>(src_t + ((img + row) * W + col) * C) + p * 16;
        valid |= 1u << it;
      }
    }
  };
  // step s = dx * nk + k: channel bytes [16*KP*k, 16*KP*(k+1)) of the fm1
  // tile and of fm2's window shifted by dx (planned for s's dx)
  auto load_stage = [&](int buf, int s) {
    if (s % nk == 0) plan(s / nk);
    const int cbyte = (s % nk) * 16 * KP;
    const uint32_t base = smem_u32 + buf * G::STAGE;
#pragma unroll
    for (int it = 0; it < G::NIT; ++it) {
      const int u = threadIdx.x + it * SW_NT;
      if (it == G::NIT - 1 && u >= G::NPX * KP) break;
      const bool v = (valid >> it) & 1u;
      cp_async16(base + (u % KP) * G::PLANE + (u / KP) * 16, src[it] + (v ? cbyte : 0), v);
    }
  };

  float acc[QPT][D];
#pragma unroll
  for (int q = 0; q < QPT; ++q)
#pragma unroll
    for (int dy = 0; dy < D; ++dy) acc[q][dy] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();   // possibly empty: keeps the group count uniform
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<NS - 2>();   // step s has landed (for this thread) ...
    __syncthreads();   // ... for every thread, and all are done with step s-1
    if (s + NS - 1 < nsteps) load_stage((s + NS - 1) % NS, s + NS - 1);
    cp_async_commit();

    const unsigned char* st = smem + (s % NS) * G::STAGE;
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const unsigned char* pl = st + p * G::PLANE;
      float f1[QPT][NV];
#pragma unroll
      for (int q = 0; q < QPT; ++q)
        Vec<T>::load(pl + ((tr * QPT + q) * SW_COLS + tx) * 16, f1[q]);
#pragma unroll
      for (int i = 0; i < QPT + 2 * R; ++i) {   // window row tr*QPT + i
        float f2[NV];
        Vec<T>::load(pl + ((HT + tr * QPT + i) * SW_COLS + tx) * 16, f2);
#pragma unroll
        for (int dy = 0; dy < D; ++dy) {
          const int q = i - dy;   // the query this row is shift dy of
          if (q < 0 || q >= QPT) continue;
#pragma unroll
          for (int v = 0; v < NV; ++v) acc[q][dy] = fmaf(f1[q][v], f2[v], acc[q][dy]);
        }
      }
    }

    if (s % nk == nk - 1) {   // dx complete (uniform over the block)
      const int dx = s / nk, x = x0 + tx;
#pragma unroll
      for (int q = 0; q < QPT; ++q) {
        const int y = y0 + tr * QPT + q;
        if (x < W && y < H) {
          float* o = out + ((static_cast<size_t>(blockIdx.z) * D * D + dx * D) * H + y) * W + x;
#pragma unroll
          for (int dy = 0; dy < D; ++dy) o[static_cast<size_t>(dy) * H * W] = acc[q][dy] * scale;
        }
#pragma unroll
        for (int dy = 0; dy < D; ++dy) acc[q][dy] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int R, int HT>
cudaError_t launch_swapped(const void* fm1, const void* fm2, void* out, int B, int H,
                           int W, int C, float scale, cudaStream_t stream) {
  constexpr int smem = SwGeometry<HT, R>::SMEM;
  auto kernel = local_corr_swapped_kernel<T, R, HT>;
  static bool configured = false;   // above 48 KB needs the opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((W + SW_COLS - 1) / SW_COLS, (H + HT - 1) / HT, B);
  kernel<<<grid, SW_NT, smem, stream>>>(static_cast<const T*>(fm1),
                                        static_cast<const T*>(fm2),
                                        static_cast<float*>(out), H, W, C, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t swapped_rows(const void* fm1, const void* fm2, void* out, int B, int H,
                         int W, int C, int h_tile, float scale, cudaStream_t s) {
  switch (h_tile) {
    case 8: return launch_swapped<T, R, 8>(fm1, fm2, out, B, H, W, C, scale, s);
    case 16: return launch_swapped<T, R, 16>(fm1, fm2, out, B, H, W, C, scale, s);
    case 32: return launch_swapped<T, R, 32>(fm1, fm2, out, B, H, W, C, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- corr_rotmxu

constexpr int RM_COLS = 4;       // query columns a block
constexpr int RM_ROWS = 16;      // query rows a block (one m-tile)
constexpr int RM_SROWS = 32;     // staged source rows a column: h0-R+j, j < 32
constexpr int RM_LANES = 128;    // the output tile's channels (full lanes)
constexpr int KBYTES = 64;       // channel bytes a pixel and stage
constexpr int KSTEP = 32;        // channel bytes an MMA k-step
constexpr int RM_NSTAGE = 6;     // shared buffers in the cp.async ring

template <int R>
struct RmGeometry {
  static constexpr int D = 2 * R + 1;
  static constexpr int NT = 32 * D;                          // one warp a shift
  static constexpr int QPX = RM_COLS * RM_ROWS;              // staged queries
  static constexpr int SCOLS = RM_COLS + 2 * R;              // staged source columns
  static constexpr int PIXELS = QPX + SCOLS * RM_SROWS;      // staged pixels a stage
  static constexpr int STAGE = PIXELS * KBYTES;
  static constexpr int PIECES = PIXELS * (KBYTES / 16);
  static_assert(2 * R + RM_ROWS <= RM_SROWS, "four n8 tiles cover the m-tile's band");
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = big + small: big keeps x's top 11 significant bits (a TF32 value),
// small = x - big is exact in f32; the tensor core reads small's top 11
// bits, which drops at most 2^-20 |x|
__device__ __forceinline__ void split(uint32_t w, uint32_t& big, uint32_t& small) {
  big = w & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(w) - __uint_as_float(big));
}

// Shared placement of 16-byte chunk `chunk` of staged pixel `px` (64 bytes
// a pixel): the chunk index is XORed with bits 1-2 of the pixel index, so a
// fragment read (8 consecutive pixels from a multiple of 8, one word of each
// of 4 threads, one chunk) hits 32 different banks.
__device__ __forceinline__ int swizzle(int px, int chunk) {
  return (chunk ^ ((px >> 1) & 3)) * 16;
}

template <typename T, int R>
__global__ void __launch_bounds__(RmGeometry<R>::NT, 1)
local_corr_rotmxu_kernel(const T* __restrict__ fm1, const T* __restrict__ fm2,
                         T* __restrict__ out, int H, int W, int C, int lanes,
                         float scale) {
  using G = RmGeometry<R>;
  constexpr int D = G::D;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, du = threadIdx.x >> 5;   // warp = shift du
  const int g = lane >> 2, t = lane & 3;                       // fragment coordinates
  const int w0 = blockIdx.x * RM_COLS, h0 = blockIdx.y * RM_ROWS;
  const size_t img = static_cast<size_t>(blockIdx.z) * H;
  const uint32_t smem_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // every pixel a fragment reads has swizzle bits (g >> 1) & 3 (16, 32, 64
  // and 8 are multiples of 8): its chunk c sits at byte (c ^ sw) * 16
  const int sw = (g >> 1) & 3;
  const int cbytes = C * static_cast<int>(sizeof(T));

  // one stage: channel bytes [k*KBYTES, (k+1)*KBYTES) of the queries (pixel
  // 16c + m: column w0+c, row h0+m) and of the source columns (pixel
  // QPX + 32sc + j: column w0-R+sc, row h0-R+j). A thread's copies are the
  // same pieces (u = tid + NT*it: pixel u/4, chunk u%4) at every stage, so
  // their source addresses and validity (zero outside the image) are
  // planned once; a stage adds its channel offset.
  constexpr int NIT = (G::PIECES + G::NT - 1) / G::NT;
  static_assert(NIT <= 32, "one validity bit a copy");
  const unsigned char* src[NIT];
  uint32_t inside = 0;
#pragma unroll
  for (int it = 0; it < NIT; ++it) {
    const int u = threadIdx.x + it * G::NT, px = u >> 2, chunk = u & 3;
    int row, col;
    const T* src_t;
    if (px < G::QPX) {
      row = h0 + px % RM_ROWS;
      col = w0 + px / RM_ROWS;
      src_t = fm1;
    } else {
      const int q = px - G::QPX;
      row = h0 - R + q % RM_SROWS;
      col = w0 - R + q / RM_SROWS;
      src_t = fm2;
    }
    src[it] = reinterpret_cast<const unsigned char*>(fm1);   // any valid address
    if (u < G::PIECES && row >= 0 && row < H && col >= 0 && col < W) {
      src[it] = reinterpret_cast<const unsigned char*>(src_t + ((img + row) * W + col) * C) + chunk * 16;
      inside |= 1u << it;
    }
  }
  auto load_stage = [&](int buf, int k) {
    const uint32_t base = smem_u32 + buf * G::STAGE;
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int u = threadIdx.x + it * G::NT, px = u >> 2, chunk = u & 3;
      if (it == NIT - 1 && u >= G::PIECES) break;
      // a last step of 32 bytes reads zeros after C
      const bool v = ((inside >> it) & 1u) && k * KBYTES + chunk * 16 < cbytes;
      cp_async16(base + px * KBYTES + swizzle(px, chunk), src[it] + (v ? k * KBYTES : 0), v);
    }
  };

  float acc[RM_COLS][4][4];   // (query column, n-tile, fragment element)
#pragma unroll
  for (int c = 0; c < RM_COLS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  const int nk = (cbytes + KBYTES - 1) / KBYTES;
#pragma unroll
  for (int k = 0; k < RM_NSTAGE - 1; ++k) {
    if (k < nk) load_stage(k, k);
    cp_async_commit();   // possibly empty: keeps the group count uniform
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<RM_NSTAGE - 2>();   // stage k has landed (for this thread) ...
    __syncthreads();   // ... for every thread, and all are done with stage k-1
    if (k + RM_NSTAGE - 1 < nk) load_stage((k + RM_NSTAGE - 1) % RM_NSTAGE, k + RM_NSTAGE - 1);
    cp_async_commit();

    const unsigned char* st = smem + (k % RM_NSTAGE) * G::STAGE;
#pragma unroll
    for (int kk = 0; kk < KBYTES / KSTEP; ++kk) {
      const int c0 = ((2 * kk) ^ sw) * 16, c1 = ((2 * kk + 1) ^ sw) * 16;
#pragma unroll
      for (int c = 0; c < RM_COLS; ++c) {
        // A: queries g (+8) of column c, words at bytes 4t of the k-step's
        // two chunks: (g, k 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, ..) for
        // bf16 and (g, t), (g+8, t), (g, t+4), (g+8, t+4) for TF32
        const unsigned char* pa = st + (RM_ROWS * c + g) * KBYTES + 4 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(pa + c0);
        a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * KBYTES + c0);
        a[2] = *reinterpret_cast<const uint32_t*>(pa + c1);
        a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * KBYTES + c1);
        uint32_t ab[4], as[4];
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split(a[e], ab[e], as[e]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B: source row 8j + g of column w0+c+du-R (staged column c+du)
          const unsigned char* pb =
              st + (G::QPX + (c + du) * RM_SROWS + 8 * j + g) * KBYTES + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb + c0);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + c1);
          if constexpr (std::is_same<T, float>::value) {
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
            mma_tf32(acc[c][j], as, bb0, bb1);
            mma_tf32(acc[c][j], ab, bs0, bs1);
            mma_tf32(acc[c][j], ab, bb0, bb1);
          } else {
            mma_bf16(acc[c][j], a, b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages before they are reused

  // (16 rows, 4 columns, 128 lanes) output tile over the stages, zeroed
  // first: the lanes past d^2 are written as zeros, never as stale memory
  T* so = reinterpret_cast<T*>(smem);
  constexpr int TILE_PIECES = RM_ROWS * RM_COLS * RM_LANES * static_cast<int>(sizeof(T)) / 16;
  for (int e = threadIdx.x; e < TILE_PIECES; e += G::NT)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // Band extraction: element e of tile (c, j) is (query m, source row jl) =
  // (g + 8*(e>>1), 8j + 2t + (e&1)); its vertical shift is dy = jl - m
  // (source row h0+jl-R = query row h0+m + dy-R)
#pragma unroll
  for (int c = 0; c < RM_COLS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1);
        const int dy = 8 * j + 2 * t + (e & 1) - m;
        if (dy < 0 || dy >= D) continue;
        so[(m * RM_COLS + c) * RM_LANES + du * D + dy] = from_f32<T>(acc[c][j][e] * scale);
      }
  __syncthreads();

  // a row's columns w0.. are consecutive pixels: one run of ncols * lanes
  const int nrows = min(RM_ROWS, H - h0), ncols = min(RM_COLS, W - w0);
  if (lanes == RM_LANES) {   // 16-byte pieces, aligned (128 lanes a pixel)
    constexpr int PPX = RM_LANES * static_cast<int>(sizeof(T)) / 16;   // pieces a pixel
    for (int e = threadIdx.x; e < nrows * ncols * PPX; e += G::NT) {
      const int m = e / (ncols * PPX), p = e % (ncols * PPX);
      uint4* dst = reinterpret_cast<uint4*>(out + ((img + h0 + m) * W + w0) * RM_LANES);
      dst[p] = reinterpret_cast<const uint4*>(so + m * RM_COLS * RM_LANES)[p];
    }
  } else {                   // d^2 lanes a pixel
    for (int e = threadIdx.x; e < nrows * ncols * D * D; e += G::NT) {
      const int m = e / (ncols * D * D), rest = e % (ncols * D * D);
      const int c = rest / (D * D), ch = rest % (D * D);
      out[((img + h0 + m) * W + w0 + c) * (D * D) + ch] =
          so[(m * RM_COLS + c) * RM_LANES + ch];
    }
  }
}

template <typename T, int R>
cudaError_t launch_rotmxu(const void* fm1, const void* fm2, void* out, int B, int H,
                          int W, int C, int lanes, float scale, cudaStream_t stream) {
  using G = RmGeometry<R>;
  constexpr int tile = RM_ROWS * RM_COLS * RM_LANES * static_cast<int>(sizeof(T));
  constexpr int smem = RM_NSTAGE * G::STAGE > tile ? RM_NSTAGE * G::STAGE : tile;
  if (lanes != RM_LANES && lanes != G::D * G::D) return cudaErrorInvalidValue;
  auto kernel = local_corr_rotmxu_kernel<T, R>;
  static bool configured = false;   // above 48 KB needs the opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((W + RM_COLS - 1) / RM_COLS, (H + RM_ROWS - 1) / RM_ROWS, B);
  kernel<<<grid, G::NT, smem, stream>>>(static_cast<const T*>(fm1),
                                        static_cast<const T*>(fm2),
                                        static_cast<T*>(out), H, W, C, lanes, scale);
  return cudaGetLastError();
}

// 16-byte copies, whole MMA k-steps: aligned inputs, C*sizeof(T) a
// multiple of 32
template <typename T>
bool valid_inputs(const void* fm1, const void* fm2, int B, int H, int W, int C) {
  return (C * static_cast<int>(sizeof(T))) % KSTEP == 0 && C > 0 && B >= 1 &&
         B <= 65535 && H >= 1 && H <= 65535 && W >= 1 &&
         reinterpret_cast<uintptr_t>(fm1) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(fm2) % 16 == 0;
}

template <typename T>
int swapped(const void* fm1, const void* fm2, void* out, int B, int H, int W, int C,
            int r, int h_tile, float scale, void* stream) {
  if (!valid_inputs<T>(fm1, fm2, B, H, W, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return swapped_rows<T, 1>(fm1, fm2, out, B, H, W, C, h_tile, scale, s);
    case 2: return swapped_rows<T, 2>(fm1, fm2, out, B, H, W, C, h_tile, scale, s);
    case 3: return swapped_rows<T, 3>(fm1, fm2, out, B, H, W, C, h_tile, scale, s);
    case 4: return swapped_rows<T, 4>(fm1, fm2, out, B, H, W, C, h_tile, scale, s);
    case 5: return swapped_rows<T, 5>(fm1, fm2, out, B, H, W, C, h_tile, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int rotmxu(const void* fm1, const void* fm2, void* out, int B, int H, int W, int C,
           int r, int lanes, float scale, void* stream) {
  if (!valid_inputs<T>(fm1, fm2, B, H, W, C) || H + 2 * r > 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch_rotmxu<T, 1>(fm1, fm2, out, B, H, W, C, lanes, scale, s);
    case 2: return launch_rotmxu<T, 2>(fm1, fm2, out, B, H, W, C, lanes, scale, s);
    case 3: return launch_rotmxu<T, 3>(fm1, fm2, out, B, H, W, C, lanes, scale, s);
    case 4: return launch_rotmxu<T, 4>(fm1, fm2, out, B, H, W, C, lanes, scale, s);
    case 5: return launch_rotmxu<T, 5>(fm1, fm2, out, B, H, W, C, lanes, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
//
// corr_swapped: out is planar (B, d^2, H, W) float32, channel dx*d + dy;
// h_tile (8, 16 or 32) is the query rows a block.
extern "C" int local_corr_swapped_f32(const void* fm1, const void* fm2, void* out,
                                      int B, int H, int W, int C, int r, int h_tile,
                                      float scale, void* stream) {
  return swapped<float>(fm1, fm2, out, B, H, W, C, r, h_tile, scale, stream);
}

extern "C" int local_corr_swapped_bf16(const void* fm1, const void* fm2, void* out,
                                       int B, int H, int W, int C, int r, int h_tile,
                                       float scale, void* stream) {
  return swapped<__nv_bfloat16>(fm1, fm2, out, B, H, W, C, r, h_tile, scale, stream);
}

// corr_rotmxu: out is (B, H, W, lanes) in the inputs' dtype, lanes 128
// (channels d^2..127 zero) or d^2; needs H + 2r <= 128.
extern "C" int local_corr_rotmxu_f32(const void* fm1, const void* fm2, void* out,
                                     int B, int H, int W, int C, int r, int lanes,
                                     float scale, void* stream) {
  return rotmxu<float>(fm1, fm2, out, B, H, W, C, r, lanes, scale, stream);
}

extern "C" int local_corr_rotmxu_bf16(const void* fm1, const void* fm2, void* out,
                                      int B, int H, int W, int C, int r, int lanes,
                                      float scale, void* stream) {
  return rotmxu<__nv_bfloat16>(fm1, fm2, out, B, H, W, C, r, lanes, scale, stream);
}

extern "C" const char* local_corr_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
