// Local correlation as a tensor-core band product, hand-written for Hopper
// (sm_90a). Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py
// with nvcc and loaded with ctypes.
//
// Replaces three opt-in forwards of rpnet_tpu/ops/pallas/correlation.py,
// all of one function, in the quirk order the CRE's 1x1 conv consumes:
//
//   out[b,y,x,dx*d+dy] = cast(scale * S),
//   S = sum_c f32(fm1[b,y,x,c]) * f32(fm2[b,y+dy-r,x+dx-r,c]),
//
// d = 2r+1, zero outside the image, S summed in f32, one rounding.
//   * local_corr_band_{f32,bf16}: _corr_mxu_kernel (RPNET_CORR_IMPL=
//     pallas_mxu), a per-dy matmul of a row of queries against a row of
//     sources followed by a band (diagonal) extraction.
//   * local_corr_pdot_bf16: _corr_rot_kernel with pdot=True
//     (RPNET_ROT_EXTRACT=pdot). On the TPU the main dot rounds S to bf16 and
//     the extraction is a second matmul against a placement matrix holding
//     bf16(scale), so its value is bf16(f32(bf16(S)) * f32(bf16(scale))); the
//     epilogue here applies those two roundings in registers. For C = 4^k
//     (scale a power of two) this equals the band value bit for bit.
//   * local_corr_pack_{f32,bf16}: _corr_rot2_kernel (RPNET_ROT_PACK=1). The
//     input is slice pairs packed side by side, (B/2, H, 2W, C); a query's
//     source columns that fall into the partner slice must count as zero,
//     which a per-(query, dx) validity mask on the slice width does.
// None of the TPU layout devices (column-reversed fm2, 128-lane rot layout,
// dy-major dx-reversed channels) is carried.
//
// Precision. bf16: mma.sync m16n8k16 with f32 accumulators; products are
// exact, so only the order of the f32 sum differs from the FMA kernels.
// f32: 3xTF32 on m16n8k8 TF32 tensor cores. Each operand x splits into
// big (x's top 11 significant bits) and small = x - big; small*big +
// big*small + big*big is summed in f32. The dropped small*small term and
// the truncation of small leave about 2^-19 of each product, so f32 results
// stay within the 1e-4 of the FMA kernels' check (closer than the TPU
// kernel, whose f32 inputs run at its default bf16-product precision).
//
// Bound at the eval shape (26 slices, 64x64, C=256, r=5, bf16): the function
// reads fm1 and fm2 once (2 x 54.5 MB) and writes 25.8 MB, 40 us at the H100
// SXM's 3.35 TB/s; its 6.1 GFLOP of in-image products take 6 us on bf16
// tensor cores. So it is memory-bound, and the design's cost is the bytes it
// moves through L2 and shared memory, not the tensor-core work (which wastes
// 2.9x on products outside the band).
//
// Design (simple and right first). One block per (image, pair of rows
// y0, y0+1, 64-query strip); 16 warps: 4 strips of 16 queries x 2 groups of
// vertical shifts (dy <= r, dy > r) x 2 rows. Channels are staged 64 bytes
// per pixel at a time (two MMA k-steps of 16 bf16 or 8 f32 channels; a last
// step of 32 bytes is zero-filled) with 16-byte cp.async into a ring of
// three shared buffers, two stages in flight while one computes: the 2 x 64
// queries of fm1, and fm2's rows y0-r..y0+1+r at columns x0-r..x0-r+79,
// zero-filled outside the image. The two query rows share 11 of their 12
// source rows, which halves what the blocks pull from L2 (each fm2 row is
// still read by d/2 blocks). Pixels sit 64 bytes apart with their four
// 16-byte chunks swizzled, so fragment reads hit 32 different banks (204 KB
// of shared memory at r=5). 96 accumulators a thread keep it at 128
// registers, one block an SM. For each of its shifts dy a warp multiplies
// its 16 queries (A, row-major straight from NHWC) against the 32 source
// columns x0+16s-r .. x0+16s-r+31 (B, column-major straight from NHWC):
// four n8 tiles. Accumulator (query g, column n) holds displacement
// dx = n - g; those with 0 <= dx < d go, scaled and rounded, into a
// (2, 64, d^2) tile in shared memory, which the block writes out as one
// contiguous run per row. wgmma, TMA and more rows per block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NSTRIP = 4;               // 16-query strips per block (warps along x)
constexpr int NDYG = 2;                 // groups of vertical shifts (warps along dy)
constexpr int NROW = 2;                 // query rows per block (warps along y)
constexpr int NT = 32 * NSTRIP * NDYG * NROW;   // threads per block
constexpr int TX = 16 * NSTRIP;         // queries per block and row
constexpr int SC = TX + 16;             // staged source columns x0-R .. x0-R+SC-1
constexpr int KBYTES = 64;              // channel bytes per pixel and stage
constexpr int KSTEP = 32;               // channel bytes per MMA k-step
constexpr int NSTAGE = 3;               // shared buffers in the cp.async ring

enum Mode { BAND = 0, PACK = 1, PDOT = 2 };

template <int R>
struct Geometry {
  static constexpr int D = 2 * R + 1;
  static constexpr int DYH = R + 1;                        // shifts per dy group
  static constexpr int SROWS = NROW + 2 * R;               // staged fm2 rows
  static constexpr int PIXELS = NROW * TX + SROWS * SC;    // staged pixels per stage
  static constexpr int STAGE = PIXELS * KBYTES;            // bytes per stage
  static constexpr int PIECES = PIXELS * (KBYTES / 16);    // 16-byte copies per stage
  static_assert(KBYTES == 64, "swizzle() spreads 4 chunks of 16 bytes");
};

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
// bits (it ignores the low 13 of a TF32 operand), which drops at most
// 2^-20 |x|
__device__ __forceinline__ void split(uint32_t w, uint32_t& big, uint32_t& small) {
  big = w & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(w) - __uint_as_float(big));
}

// Shared placement of 16-byte chunk `chunk` of staged pixel `px` (64 bytes
// a pixel, no padding): the chunk index is XORed with bits 1-2 of the pixel
// index, so a fragment read (8 consecutive pixels, one word of each of 4
// threads, one chunk) hits 32 different banks.
__device__ __forceinline__ int swizzle(int px, int chunk) {
  return (chunk ^ ((px >> 1) & 3)) * 16;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

template <typename T, int R, int MODE>
__global__ void __launch_bounds__(NT, 1)   // at most 128 registers a thread
local_corr_band_kernel(const T* __restrict__ fm1, const T* __restrict__ fm2,
                       T* __restrict__ out, int H, int W, int C, int width,
                       float scale) {
  using G = Geometry<R>;
  constexpr int D = G::D;
  constexpr int DYH = G::DYH;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;        // MMA fragment coordinates
  const int strip = warp % NSTRIP, dyg = (warp / NSTRIP) % NDYG;
  const int row = warp / (NSTRIP * NDYG);      // query row y0 + row
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * NROW;
  const size_t img = static_cast<size_t>(blockIdx.z) * H;
  const uint32_t smem_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // every pixel a fragment reads has swizzle bits (g >> 1) & 3 (TX, SC, 16
  // and 8 are multiples of 8): its chunk c sits at byte (c ^ sw) * 16
  const int sw = (g >> 1) & 3;

  const int cbytes = C * static_cast<int>(sizeof(T));   // channel bytes a pixel
  // one stage: channel bytes [k*KBYTES, (k+1)*KBYTES) of every staged pixel
  auto load_stage = [&](int buf, int k) {
    const uint32_t base = smem_u32 + buf * G::STAGE;
    for (int u = threadIdx.x; u < G::PIECES; u += NT) {
      const int px = u >> 2, chunk = u & 3;
      const int cbyte = k * KBYTES + chunk * 16;
      const void* src = fm1;   // any valid address when nothing is read
      bool valid = cbyte < cbytes;   // a last step of 32 bytes reads zeros after them
      if (px < NROW * TX) {
        const int y = y0 + px / TX, x = x0 + px % TX;
        valid = valid && y < H && x < W;
        if (valid)
          src = reinterpret_cast<const unsigned char*>(fm1 + ((img + y) * W + x) * C) + cbyte;
      } else {
        const int i = (px - NROW * TX) / SC, j = (px - NROW * TX) % SC;
        const int sy = y0 + i - R, sx = x0 - R + j;
        // zero outside the image
        valid = valid && sy >= 0 && sy < H && sx >= 0 && sx < W;
        if (valid)
          src = reinterpret_cast<const unsigned char*>(fm2 + ((img + sy) * W + sx) * C) + cbyte;
      }
      cp_async16(base + px * KBYTES + swizzle(px, chunk), src, valid);
    }
  };

  float acc[DYH][4][4];
#pragma unroll
  for (int i = 0; i < DYH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (cbytes + KBYTES - 1) / KBYTES;
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nk) load_stage(k, k);
    cp_async_commit();   // possibly empty: keeps the group count uniform
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<NSTAGE - 2>();   // stage k has landed (for this thread) ...
    __syncthreads();   // ... for every thread, and all are done with stage k-1
    if (k + NSTAGE - 1 < nk) load_stage((k + NSTAGE - 1) % NSTAGE, k + NSTAGE - 1);
    cp_async_commit();

    const unsigned char* st = smem + (k % NSTAGE) * G::STAGE;
#pragma unroll
    for (int kk = 0; kk < KBYTES / KSTEP; ++kk) {
      // this k-step's two chunks of every pixel
      const int h0 = ((2 * kk) ^ sw) * 16, h1 = ((2 * kk + 1) ^ sw) * 16;
      // A: queries 16*strip + g (+8), words at bytes 4t of the k-step's two
      // chunks: (g, k 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, ..) for bf16
      // and (g, t), (g+8, t), (g, t+4), (g+8, t+4) for TF32
      const unsigned char* pa = st + (row * TX + 16 * strip + g) * KBYTES + 4 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa + h0);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * KBYTES + h0);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + h1);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * KBYTES + h1);
      uint32_t ab[4], as[4];
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
      }
#pragma unroll
      for (int i = 0; i < DYH; ++i) {
        const int dy = dyg * DYH + i;
        if (dy >= D) break;   // warp-uniform
        // B: source column 16*strip + 8j + g of staged row dy
        const unsigned char* pb =
            st + (NROW * TX + (row + dy) * SC + 16 * strip + g) * KBYTES + 4 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb + 8 * j * KBYTES + h0);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 8 * j * KBYTES + h1);
          if constexpr (std::is_same<T, float>::value) {
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
            mma_tf32(acc[i][j], as, bb0, bb1);
            mma_tf32(acc[i][j], ab, bs0, bs1);
            mma_tf32(acc[i][j], ab, bb0, bb1);
          } else {
            mma_bf16(acc[i][j], a, b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages before they are reused

  // Band extraction: accumulator element e of tile j is (query row, column
  // n) = (g + 8*(e>>1), 8j + 2t + (e&1)); its displacement is dx = n - row.
  T* so = reinterpret_cast<T*>(smem);   // (NROW, TX, D*D) output tile, reusing the stages
  float scale_bf = 0.f;
  if constexpr (MODE == PDOT) scale_bf = __bfloat162float(__float2bfloat16(scale));
#pragma unroll
  for (int i = 0; i < DYH; ++i) {
    const int dy = dyg * DYH + i;
    if (dy >= D) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1);
        const int dx = 8 * j + 2 * t + (e & 1) - m;
        if (dx < 0 || dx >= D) continue;
        const int q = 16 * strip + m;
        float v = acc[i][j][e];
        T o;
        if constexpr (MODE == PDOT) {
          o = from_f32<T>(__bfloat162float(__float2bfloat16(v)) * scale_bf);
        } else {
          if constexpr (MODE == PACK) {
            // the source column must lie in the query's own slice
            const int src = (x0 + q) % width + dx - R;
            if (src < 0 || src >= width) v = 0.f;
          }
          o = from_f32<T>(v * scale);
        }
        so[(row * TX + q) * (D * D) + dx * D + dy] = o;
      }
  }
  __syncthreads();
  const int nq = min(TX, W - x0);
#pragma unroll
  for (int rr = 0; rr < NROW; ++rr) {   // each row's tile is one contiguous run
    if (y0 + rr >= H) break;
    T* dst = out + ((img + y0 + rr) * W + x0) * (D * D);
    for (int e = threadIdx.x; e < nq * D * D; e += NT) dst[e] = so[rr * TX * D * D + e];
  }
}

template <typename T, int R, int MODE>
cudaError_t launch(const void* fm1, const void* fm2, void* out, int B, int H,
                   int W, int C, int width, float scale, cudaStream_t stream) {
  using G = Geometry<R>;
  constexpr int out_bytes = NROW * TX * G::D * G::D * static_cast<int>(sizeof(T));
  constexpr int smem = NSTAGE * G::STAGE > out_bytes ? NSTAGE * G::STAGE : out_bytes;
  auto kernel = local_corr_band_kernel<T, R, MODE>;
  static bool configured = false;   // above 48 KB needs the opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((W + TX - 1) / TX, (H + NROW - 1) / NROW, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(fm1),
                                     static_cast<const T*>(fm2),
                                     static_cast<T*>(out), H, W, C, width, scale);
  return cudaGetLastError();
}

template <typename T, int MODE>
int dispatch(const void* fm1, const void* fm2, void* out, int B, int H, int W,
             int C, int r, int width, float scale, void* stream) {
  // 16-byte copies, whole MMA k-steps: aligned inputs, C*sizeof(T) a
  // multiple of 32
  if ((C * static_cast<int>(sizeof(T))) % KSTEP != 0 || B < 1 || B > 65535 ||
      H < 1 || H > 65535 || width < 1 || W % width != 0 ||
      reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fm2) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<T, 1, MODE>(fm1, fm2, out, B, H, W, C, width, scale, s);
    case 2: return launch<T, 2, MODE>(fm1, fm2, out, B, H, W, C, width, scale, s);
    case 3: return launch<T, 3, MODE>(fm1, fm2, out, B, H, W, C, width, scale, s);
    case 4: return launch<T, 4, MODE>(fm1, fm2, out, B, H, W, C, width, scale, s);
    case 5: return launch<T, 5, MODE>(fm1, fm2, out, B, H, W, C, width, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched). `width` is the slice
// width: W for band and pdot, the width of one slice of a pair for pack.
extern "C" int local_corr_band_f32(const void* fm1, const void* fm2, void* out,
                                   int B, int H, int W, int C, int r, int width,
                                   float scale, void* stream) {
  return dispatch<float, BAND>(fm1, fm2, out, B, H, W, C, r, width, scale, stream);
}

extern "C" int local_corr_band_bf16(const void* fm1, const void* fm2, void* out,
                                    int B, int H, int W, int C, int r, int width,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16, BAND>(fm1, fm2, out, B, H, W, C, r, width, scale,
                                       stream);
}

extern "C" int local_corr_pack_f32(const void* fm1, const void* fm2, void* out,
                                   int B, int H, int W, int C, int r, int width,
                                   float scale, void* stream) {
  return dispatch<float, PACK>(fm1, fm2, out, B, H, W, C, r, width, scale, stream);
}

extern "C" int local_corr_pack_bf16(const void* fm1, const void* fm2, void* out,
                                    int B, int H, int W, int C, int r, int width,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16, PACK>(fm1, fm2, out, B, H, W, C, r, width, scale,
                                       stream);
}

extern "C" int local_corr_pdot_bf16(const void* fm1, const void* fm2, void* out,
                                    int B, int H, int W, int C, int r, int width,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16, PDOT>(fm1, fm2, out, B, H, W, C, r, width, scale,
                                       stream);
}

extern "C" const char* local_corr_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
