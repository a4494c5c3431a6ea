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
// so one kernel body computes either gradient; blockIdx.z picks which:
//
//   out[y,x,c] = sum_{dy,dx} w[y,x,dy,dx] * src[y+dy-r, x+dx-r, c].
//
// Bound at the training shape (48 slices, 64x64, C=256, r=5, f32): it reads
// g (48x64x64x121) and fm1, fm2 once and writes dfm1, dfm2 once, about
// 900 MB, 0.27 ms at 3.35 TB/s; its 22.3 GFLOP of in-image products take
// 0.135 ms as three TF32 tensor-core passes (0.333 ms on the FP32 FMA
// units, which is why the products run on the tensor cores). The training
// step launches it once per CRE call (5 per step at n_iter_refinement 4).
//
// Design: a transposed band product on the tensor cores. For one output
// row y, one vertical shift dy and a tile of 8 queries x0..x0+7,
//
//   out^T[c, x] += sum_j src[y+dy-r, x0-r+j, c] * band[j, x],
//   band[j, x] = w[y, x, dy, j-(x-x0)] where 0 <= j-(x-x0) < d, else 0:
//
// channels on M, queries on N, the tile's 8+2r source columns on K, padded
// to KT (24 for f32 at r=5: three k8 steps; 32 for bf16: two k16 steps), so
// the band wastes KT/d of the products. f32 runs as 3xTF32 (each operand
// split into a TF32 big part and the rest by masking, as local_corr_band.cu
// does; the small*small term is dropped); bf16 as one exact bf16 pass with
// f32 accumulators.
//
// One block per (image, gradient, 4 output rows, 32 query columns, 256
// channels), 16 warps, one block an SM. The block first stages its 4x32
// pixels' d*d weights in shared memory as f32 (dfm1: g's pixel rows; dfm2:
// gathered from the haloed neighbourhood, four lanes on four adjacent
// channels of one g pixel; g is read with its pixel stride, so the CRE's
// concat gradient needs no copy and no TMA, whose 16-byte strides it does
// not meet). Then it walks the 4+2r source rows once, each staged by
// 16-byte cp.async (addresses planned once a thread) into a 2-row ring,
// zero-filled outside the image, NHWC as it lies, channels padded so that
// fragment reads fall on distinct banks. A source row feeds every output
// row with a shift dy onto it (up to 4): per source row the block builds
// the bands of all 4 rows x 4 query tiles once, into a double buffer.
//   f32: wgmma m64n32k8 TF32. A warpgroup owns 64 channels; N = 4 output
//     rows x 8 queries, so one wgmma serves all four rows (a row with no
//     shift onto the source row carries a zero band). A (the source
//     window, split once) comes from registers, two buffers deep; B is a
//     K-major tile in the 32-byte swizzle, big and small parts apart.
//     (mma.sync m16n8k8 ran at a quarter of the TF32 peak here: 1.34 ms.)
//   bf16: mma.sync m16n8k16. A warp owns 2 query tiles x 4 rows x 2
//     channel tiles; A windows by ldmatrix.trans, B fragments read from
//     the shared buffer in lane order.
// Accumulators are scaled, rounded once and stored straight from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Dynamic shared memory above 48 KB needs an opt-in, which acts on the
// current device only: each kernel instance keeps the size allowed so far
// per device, and a launch on another card opts in there first.
constexpr int MAX_DEVICES = 64;

cudaError_t allow_smem(const void* kernel, int smem, int* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed[dev] = smem;
  return e;
}

constexpr int TY = 4;              // output rows per block
constexpr int NQT = 4;             // query tiles of 8 per block
constexpr int XT = 8 * NQT;        // query columns per block
constexpr int NW = 16;             // warps: 2 halves of the query tiles x 8 pairs of channel tiles
constexpr int CB = NW / 2 * 32;    // channels per block
constexpr int NT = 32 * NW;        // threads per block
constexpr int NS = 2;              // source rows in the cp.async ring

template <typename T, int R>
struct Geometry {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int D = 2 * R + 1;
  static constexpr int KS = F32 ? 8 : 16;             // MMA depth
  static constexpr int KT = (8 + 2 * R + KS - 1) / KS * KS;   // band depth
  static constexpr int NKS = KT / KS;
  static constexpr int SCOL = XT - 8 + KT;            // staged source columns
  static constexpr int CP = CB + 8;                   // elements a staged column
  static constexpr int ROW = SCOL * CP;               // elements a staged row
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  // weights: [pixel][dy][dx], pixel stride P >= d*d with P % 32 == 5, so
  // that reads of pixel g at dx = t - g + const (lane (g, t)) fall on
  // distinct banks
  static constexpr int P = (D * D + 26) / 32 * 32 + 5;
  static constexpr int WFLOATS = TY * XT * P;
  // f32: the bands of one source row as wgmma B tiles, (query tile, big or
  // small part, k step) -> 32 rows (8 yy + n) of 32 bytes, 32-byte swizzle
  static constexpr int BT_BYTES = NQT * 2 * NKS * 1024;
  // bf16: the B fragments of one source row in lane order, (query tile,
  // output row, k step, lane) -> two packed pairs (8 bytes)
  static constexpr int FRAGS = NQT * TY * NKS * 32;
  static constexpr int NWIN = 2 + 2 * (NKS - 1);   // bf16 A windows a warp and row
  static constexpr int EXTRA = F32 ? 2 * BT_BYTES : 2 * FRAGS * 8;
  static constexpr int SMEM = 256 + EXTRA + WFLOATS * 4 + NS * ROW * static_cast<int>(sizeof(T));
  static_assert((CP * sizeof(T)) % 16 == 0, "16-byte aligned staged columns");
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
// x = big + small: big keeps x's top 11 significant bits (a TF32 value),
// small = x - big is exact in f32; the tensor core reads small's top 11
// bits, which drops at most 2^-20 |x|
__device__ __forceinline__ void split(uint32_t w, uint32_t& big, uint32_t& small) {
  big = w & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(w) - __uint_as_float(big));
}
// two f32 values that are bf16 numbers, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// wgmma (f32 as 3xTF32). Shared-memory descriptor of a K-major operand in
// the 32-byte swizzle: rows of 32 bytes (8 TF32 values, one k step), 8-row
// groups 256 bytes apart (SBO), leading offset unused (1)
__device__ __forceinline__ uint64_t wgmma_desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
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
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// D[64 x 32] += A[64 x 8] * B[32 x 8]^T in TF32, A from registers (the
// mma.sync m16n8k8 layout, one 16-row slice a warp), B K-major in shared
// memory; f32 accumulators
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);   // round to nearest even
}

template <typename T, int R>
__global__ void __launch_bounds__(NT, 1)
local_corr_bwd_kernel(const T* __restrict__ g, int g_pitch,
                      const T* __restrict__ fm1, const T* __restrict__ fm2,
                      T* __restrict__ dfm1, T* __restrict__ dfm2,
                      int H, int W, int C, int nxt, float scale) {
  using G = Geometry<T, R>;
  constexpr int D = G::D, P = G::P, CP = G::CP, KS = G::KS;
  constexpr int NSR = TY + 2 * R;          // source rows a block walks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the B tiles' swizzle repeats every 256 bytes: align the carve-up to it
  const uint32_t raw_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw_u32 + 255) & ~255u) - raw_u32);
  unsigned char* frags = smem;   // [2][EXTRA / 2]: B tiles (f32) or fragments (bf16)
  const uint32_t frags_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(frags));
  float* wts = reinterpret_cast<float*>(smem + G::EXTRA);              // [TY*XT][P]
  T* slab = reinterpret_cast<T*>(smem + G::EXTRA + G::WFLOATS * 4);   // [NS][SCOL][CP]
  const uint32_t slab_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(slab));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // MMA fragment coordinates

  const int second = blockIdx.z & 1;           // 0: dfm1, 1: dfm2
  const int b = blockIdx.z >> 1;
  const int x0 = (blockIdx.x % nxt) * XT;
  const int c0 = (blockIdx.x / nxt) * CB;
  const int y0 = blockIdx.y * TY;
  const size_t img = static_cast<size_t>(b) * H * W;
  const T* src = second ? fm1 : fm2;
  T* dst = second ? dfm2 : dfm1;

  // one staged source row (si = 0 .. NSR-1 is row y0-R+si): channels
  // [c0, c0+CB) of columns x0-R .. x0-R+SCOL-1, zero outside the image and
  // past C. A thread copies the same 16 channel bytes (part) of every
  // CSTEP-th column, so its column offsets and their validity are planned
  // once.
  constexpr int PARTS = CB / G::V, CSTEP = NT / PARTS;
  constexpr int NCOPY = (G::SCOL + CSTEP - 1) / CSTEP;
  const int part = tid % PARTS, col0 = tid / PARTS;
  const bool c_ok = c0 + part * G::V < C;
  uint32_t x_ok = 0;   // bit k: column col0 + k*CSTEP lies inside the image
#pragma unroll
  for (int k = 0; k < NCOPY; ++k) {
    const int x = x0 - R + col0 + k * CSTEP;
    if (x >= 0 && x < W && col0 + k * CSTEP < G::SCOL) x_ok |= 1u << k;
  }
  const T* src_part = src + img * C + static_cast<ptrdiff_t>(x0 - R + col0) * C + c0 + part * G::V;
  const uint32_t dst_part = slab_u32 + (col0 * CP + part * G::V) * static_cast<int>(sizeof(T));
  auto load_row = [&](int si) {
    const uint32_t base = dst_part + (si % NS) * G::ROW * static_cast<int>(sizeof(T));
    const int y = y0 - R + si;
    const bool row_ok = c_ok && y >= 0 && y < H;
    const T* row = src_part + static_cast<ptrdiff_t>(y) * W * C;
#pragma unroll
    for (int k = 0; k < NCOPY; ++k) {
      if (col0 + k * CSTEP >= G::SCOL) break;
      const bool valid = row_ok && (x_ok >> k & 1u);
      cp_async16(base + k * CSTEP * CP * static_cast<int>(sizeof(T)),
                 valid ? row + static_cast<ptrdiff_t>(k) * CSTEP * C : src, valid);
    }
  };
#pragma unroll
  for (int si = 0; si < NS - 1; ++si) {
    load_row(si);
    cp_async_commit();
  }

  // the tile's weights, once: wts[pix][dy*D + dx], zero outside the image.
  // dfm1 reads each pixel's d*d channels in a run. dfm2's weights
  // w2[q][dx'][dy'] = g[q + (dy'-R, dx'-R), (2R-dx')*D + 2R-dy'] are walked
  // with the output row yy fastest at fixed s = yy + dy', so that four
  // lanes read four adjacent channels of one source pixel.
  // All of a thread's loads are in flight at once (the accumulators are
  // not live yet).
  constexpr int NSW = TY + D - 1;                       // values of s
  constexpr int NL = (TY * XT * D * NSW + NT - 1) / NT;  // loads a thread, at most
  {
    float v[NL];
    int at[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int u = tid + i * NT;
      v[i] = 0.f;
      at[i] = -1;
      int y, x, kg;
      if (!second) {
        if (u >= TY * XT * D * D) continue;
        const int pix = u / (D * D), k = u % (D * D);
        y = y0 + pix / XT;
        x = x0 + pix % XT;
        kg = k;
        at[i] = pix * P + (k % D) * D + k / D;   // g's channel k = dx*D + dy
      } else {
        if (u >= TY * XT * D * NSW) continue;
        const int yy = u % TY, xq = u / TY % XT, dx = u / (TY * XT) % D;
        const int dy = u / (TY * XT * D) - yy;
        if (dy < 0 || dy >= D) continue;
        y = y0 + yy + dy - R;
        x = x0 + xq + dx - R;
        kg = (2 * R - dx) * D + (2 * R - dy);
        at[i] = (yy * XT + xq) * P + dy * D + dx;
      }
      if (y >= 0 && y < H && x >= 0 && x < W)
        v[i] = to_f32(g[(img + static_cast<size_t>(y) * W + x) * g_pitch + kg]);
    }
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (at[i] >= 0) wts[at[i]] = v[i];
  }
  __syncthreads();   // the weights are staged

  // the bands of source row si into buffer si & 1, zero for an output row
  // yy with no shift dy = si - yy onto it. f32: wgmma B tiles, element
  // (row 8yy + n, k) of tile (qt, part, ks) = band[8ks + k][n] of row yy.
  // bf16: mma.sync B fragments in lane order: lane (gq, tq) of (qt, yy,
  // ks) holds query gq's band rows 2tq, 2tq+1, 2tq+8, 2tq+9.
  auto build = [&](int si) {
    if constexpr (G::F32) {
      unsigned char* buf = frags + (si & 1) * G::BT_BYTES;
      for (int u = tid; u < NQT * G::NKS * 64; u += NT) {
        const int half = u & 1, np = (u >> 1) & 31;   // k 4half .. 4half+3 of row np
        const int ks = (u >> 6) % G::NKS, qt = (u >> 6) / G::NKS;
        const int yy = np >> 3, n = np & 7, dy = si - yy;
        const bool live = dy >= 0 && dy < D;
        const float* wrow = wts + (yy * XT + qt * 8 + n) * P + (live ? dy : 0) * D;
        uint32_t big[4], small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dx = ks * 8 + half * 4 + e - n;
          split(__float_as_uint(live && dx >= 0 && dx < D ? wrow[dx] : 0.f), big[e], small[e]);
        }
        const int off = np * 32 + ((half ^ ((np >> 2) & 1)) << 4);   // 32-byte swizzle
        *reinterpret_cast<uint4*>(buf + ((qt * 2 + 0) * G::NKS + ks) * 1024 + off) =
            make_uint4(big[0], big[1], big[2], big[3]);
        *reinterpret_cast<uint4*>(buf + ((qt * 2 + 1) * G::NKS + ks) * 1024 + off) =
            make_uint4(small[0], small[1], small[2], small[3]);
      }
      fence_proxy_async();   // visible to the tensor cores' reads after the barrier
    } else {
      unsigned char* buf = frags + (si & 1) * G::FRAGS * 8;
      for (int f = tid; f < G::FRAGS; f += NT) {
        const int fl = f & 31, ks = (f >> 5) % G::NKS;
        const int yy = (f >> 5) / G::NKS % TY, qt = (f >> 5) / (G::NKS * TY);
        const int fg = fl >> 2, ft = fl & 3;
        const int dy = si - yy;
        const bool live = dy >= 0 && dy < D;
        const float* wrow = wts + (yy * XT + qt * 8 + fg) * P + (live ? dy : 0) * D;
        const int dx0 = ks * KS + 2 * ft - fg;
        auto w = [&](int dx) { return live && dx >= 0 && dx < D ? wrow[dx] : 0.f; };
        reinterpret_cast<uint2*>(buf)[f] =
            make_uint2(pack_bf16(w(dx0), w(dx0 + 1)), pack_bf16(w(dx0 + 8), w(dx0 + 9)));
      }
    }
  };
  build(0);

  // f32: warpgroup wg = warp >> 2 owns channels c0 + 64wg + (0..63) of every
  // query tile and output row (warp: its 16-row slice of A); acc[16qt + t]
  // is (channel 16(warp&3) + gq + 8((t>>1)&1), output row t>>2, query
  // 8qt + 2tq + (t&1)).
  // bf16: warp w owns query tiles 2qh, 2qh+1 (qh = w & 1) x every output
  // row x channels c0 + ch + (0..31), ch = 32 (w >> 1); acc[((j TY + yy) 2
  // + m) 4 + e] is (channel 16m + gq + 8(e>>1), query 8(2qh+j) + 2tq + (e&1)).
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int qh = warp & 1, ch = G::F32 ? (warp >> 2) * 64 + (warp & 3) * 16 : (warp >> 1) * 32;
  // bf16: channel tiles past C skip the products (f32: the warpgroup's
  // products run on the zero-filled rows, which keeps the wgmmas off
  // divergent paths)
  const bool live_warp = G::F32 || c0 + ch < C;

  for (int si = 0; si < NSR; ++si) {
    cp_async_wait<0>();   // row si has landed (for this thread) ...
    __syncthreads();      // ... and its bands, for all; row si-1 and band
                          // buffer (si+1) & 1 are free again
    if (si + 1 < NSR) load_row(si + 1);
    cp_async_commit();

    const int ring = (si % NS) * G::ROW;
    if constexpr (G::F32) {
      // A window c covers staged columns 8c .. 8c+7; it serves query tile
      // qt at k step c - qt. Two A buffers: a window's registers are
      // rewritten only after the wgmmas of the window before the last
      // have retired. That wait also retires the previous source row's
      // wgmmas before this row's second window, so its band buffer is free
      // when build() refills it below; the tensor cores are never drained
      // inside the row loop.
      const uint32_t bt = frags_u32 + (si & 1) * G::BT_BYTES;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int c = 0; c < NQT + G::NKS - 1; ++c) {
        wgmma_wait<1>();
        const float* pa = reinterpret_cast<const float*>(slab) + ring + (8 * c + tq) * CP + ch + gq;
        uint32_t raw[4];
        raw[0] = __float_as_uint(pa[0]);
        raw[1] = __float_as_uint(pa[8]);
        raw[2] = __float_as_uint(pa[4 * CP]);
        raw[3] = __float_as_uint(pa[4 * CP + 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(raw[i], ab[c & 1][i], as[c & 1][i]);
        wgmma_fence();
#pragma unroll
        for (int qt = 0; qt < NQT; ++qt) {
          const int ks = c - qt;
          if (ks < 0 || ks >= G::NKS) continue;   // static
          const uint32_t big = bt + ((qt * 2 + 0) * G::NKS + ks) * 1024;
          const uint32_t small = bt + ((qt * 2 + 1) * G::NKS + ks) * 1024;
          wgmma_tf32(acc + 16 * qt, as[c & 1], wgmma_desc32(big));
          wgmma_tf32(acc + 16 * qt, ab[c & 1], wgmma_desc32(small));
          wgmma_tf32(acc + 16 * qt, ab[c & 1], wgmma_desc32(big));
        }
        wgmma_commit();
      }
    } else if (live_warp) {
      const unsigned char* buf = frags + (si & 1) * G::FRAGS * 8;
      // A window 2qh + c covers staged columns 8(2qh+c) .. +15: it serves
      // query tile 2qh + j at k step ks where j + 2 ks == c, for every
      // output row and both channel tiles
#pragma unroll
      for (int c = 0; c < G::NWIN; ++c) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // matrix lane >> 3: (m 0-7 | 8-15) x (k 0-7 | 8-15); row lane & 7
          const int mat = lane >> 3;
          const int row = 8 * (2 * qh + c) + (mat >> 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(a[m], slab_u32 + (ring + row * CP + ch + 16 * m + (mat & 1) * 8) * 2);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (c < j || (c - j) % 2 != 0 || (c - j) / 2 >= G::NKS) continue;   // static
          const int ks = (c - j) / 2;
#pragma unroll
          for (int yy = 0; yy < TY; ++yy) {
            const int dy = si - yy;
            if (dy < 0 || dy >= D) continue;   // warp-uniform
            const int f = (((2 * qh + j) * TY + yy) * G::NKS + ks) * 32 + lane;
            const uint2 b = reinterpret_cast<const uint2*>(buf)[f];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_bf16(*reinterpret_cast<float(*)[4]>(acc + ((j * TY + yy) * 2 + m) * 4),
                       a[m], b.x, b.y);
          }
        }
      }
    }
    if (si + 1 < NSR) build(si + 1);
  }
  cp_async_wait<0>();
  if constexpr (G::F32) {
    wgmma_wait<0>();
    fence_acc<64>(acc);
  }

  if (!live_warp) return;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    int y, x, c;
    if constexpr (G::F32) {
      const int qt = i >> 4, t = i & 15;
      y = y0 + (t >> 2);
      x = x0 + qt * 8 + 2 * tq + (t & 1);
      c = c0 + ch + gq + 8 * ((t >> 1) & 1);
    } else {
      const int e = i & 3, m = (i >> 2) & 1, yy = (i >> 3) % TY, j = (i >> 3) / TY;
      y = y0 + yy;
      x = x0 + (2 * qh + j) * 8 + 2 * tq + (e & 1);
      c = c0 + ch + 16 * m + gq + 8 * (e >> 1);
    }
    if (y < H && x < W && c < C)
      store(dst + (img + static_cast<size_t>(y) * W + x) * C + c, acc[i] * scale);
  }
}

template <typename T, int R>
cudaError_t launch(const void* g, int g_pitch, const void* fm1, const void* fm2,
                   void* dfm1, void* dfm2, int B, int H, int W, int C,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Geometry<T, R>::SMEM;
  auto kernel = local_corr_bwd_kernel<T, R>;
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (e != cudaSuccess) return e;
  const int nxt = (W + XT - 1) / XT;
  const int ncb = (C + CB - 1) / CB;
  const dim3 grid(nxt * ncb, (H + TY - 1) / TY, 2 * B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(g), g_pitch, static_cast<const T*>(fm1),
      static_cast<const T*>(fm2), static_cast<T*>(dfm1), static_cast<T*>(dfm2),
      H, W, C, nxt, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* g, int g_pitch, const void* fm1, const void* fm2,
             void* dfm1, void* dfm2, int B, int H, int W, int C, int r,
             float scale, void* stream) {
  // 16-byte copies of whole 16-channel MMA tiles: aligned tensors, C a
  // multiple of 16; g's pixel pitch covers its d*d channels
  const int d = 2 * r + 1;
  if (C % 16 != 0 || C < 16 || g_pitch < d * d || B < 1 || 2 * B > 65535 ||
      H < 1 || (H + TY - 1) / TY > 65535 ||
      reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(fm2) % 16 != 0)
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

// The launch plan at radius r: shared memory a block (bytes), resident
// blocks an SM (the CUDA occupancy calculator), registers a thread and
// local memory a thread (bytes; above 0 means ptxas spilled), of the f32
// (bf16 = 0) or bf16 instance.
extern "C" int local_corr_bwd_plan(int bf16, int r, int* smem, int* blocks_per_sm,
                                   int* regs, int* local_bytes) {
  auto plan = [&](auto kernel, int bytes) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NT, bytes);
    *smem = bytes;
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return e;
  };
  switch (r * 2 + (bf16 ? 1 : 0)) {
    case 2: return plan(local_corr_bwd_kernel<float, 1>, Geometry<float, 1>::SMEM);
    case 3: return plan(local_corr_bwd_kernel<__nv_bfloat16, 1>, Geometry<__nv_bfloat16, 1>::SMEM);
    case 4: return plan(local_corr_bwd_kernel<float, 2>, Geometry<float, 2>::SMEM);
    case 5: return plan(local_corr_bwd_kernel<__nv_bfloat16, 2>, Geometry<__nv_bfloat16, 2>::SMEM);
    case 6: return plan(local_corr_bwd_kernel<float, 3>, Geometry<float, 3>::SMEM);
    case 7: return plan(local_corr_bwd_kernel<__nv_bfloat16, 3>, Geometry<__nv_bfloat16, 3>::SMEM);
    case 8: return plan(local_corr_bwd_kernel<float, 4>, Geometry<float, 4>::SMEM);
    case 9: return plan(local_corr_bwd_kernel<__nv_bfloat16, 4>, Geometry<__nv_bfloat16, 4>::SMEM);
    case 10: return plan(local_corr_bwd_kernel<float, 5>, Geometry<float, 5>::SMEM);
    case 11: return plan(local_corr_bwd_kernel<__nv_bfloat16, 5>, Geometry<__nv_bfloat16, 5>::SMEM);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* local_corr_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
