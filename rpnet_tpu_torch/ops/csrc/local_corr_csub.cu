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
// d = 2r+1, zero outside the image, f32 sums, one rounding to the input
// dtype, written in the usual (B, H, W, d^2) quirk order.
//
// bf16 (local_corr_csub_bf16): wgmma band products on W-major operands.
//   Bound at the eval shape (26 slices, 64x64, C=256, r=5): the function
//   reads 2 x 54.5 MB and writes 25.8 MB, 40 us at 3.35 TB/s; its 6.1
//   GFLOP of in-image products take 6 us on the bf16 tensor cores. So it is
//   memory-bound, and the design has to keep down what each block pulls
//   through L2 and the tensor work it wastes outside the band.
//   Products. local_corr.cu's band product on this layout. A block owns
//   QR = 4 query rows and a 32-query strip of one image, as two 16-query
//   sub-strips, one consumer warpgroup each. For each source row s and
//   sub-strip j, wgmma m64n32k16 forms D[64 x 32] = A[64 x C] * B[32 x C]^T:
//   A's rows the sub-strip's 16 queries of the 4 query rows (row 16q + m),
//   B's rows 32 source columns of row s from x0 + 16j - 8. Element
//   (16q + m, n) is the product at dy = s - (y0+q) + r, dx = n - m - (8-r);
//   the epilogue keeps those with both in [0, d).
//   Operands. Channels (K) are not innermost here, W is: both operands are
//   MN-major, which wgmma reads for bf16 with its transpose bits, so TMA
//   boxes feed it as they land, with no transpose pass. A: boxes of 16
//   columns x 64 channels x 4 rows in the 32-byte swizzle (an MN atom of 16
//   queries a query row, atoms 2 KB apart). B: one box of 64 columns x 64
//   channels from x0 - 16 in the 128-byte swizzle, one MN atom a stage; the
//   two 32-column windows start at 8 and 24 columns into it (16-byte
//   aligned descriptor starts inside the atom). Staging from x0 - 16 puts
//   every box's first column on 16 bytes, which TMA requires (a box from
//   x0 - r traps), and every box row on whole 32-byte sectors.
//   Loads. TMA, one producer warp, boxes zero-filled outside the image and
//   past C, which replaces every halo predicate; source rows wholly outside
//   the image are skipped (their band is written as zeros). For C <= 512
//   fm1 is loaded once a block and stays resident (64 KB at C=256, one
//   barrier a 64-channel chunk); fm2 streams one source row's chunk (8 KB)
//   a stage through a ring of mbarrier-guarded stages (16 at C=256). For
//   C > 512 fm1's chunk rides in each stage beside fm2's. TMA needs 16-byte
//   strides, W % 8 == 0 in bf16: for other W the producer warp stages the
//   same swizzled layout with plain loads (bounds-checked, 2 bytes a lane),
//   fences them for the async proxy and arrives on the same barriers.
//   Epilogue. After each source row a warpgroup writes its band, scaled and
//   rounded once, into a (4, 32, d^2) output tile in shared memory, which
//   the block stores in contiguous 16-byte runs at the end.
//   Budget at C=256, r=5: 64 KB of fm1 + 16 x 8 KB of stages + a 31 KB tile
//   + 1 KB of alignment, one block an SM, 9 warps, 94 registers a thread.
//   Per block 64 KB of fm1 and 32 KB of fm2 a source row through L2 (13.25
//   rows on average at H=64; 24 KB where 16 of the staged columns lie
//   outside W=64): 0.33 to 0.42 GB a launch at the eval shape.
//
// f32 (local_corr_csub_f32): TMA staging and register-blocked FP32 FMAs.
//   Bound at the training shape (48 slices, 64x64, C=256, r=5): the function
//   reads 2 x 201 MB and writes 95 MB, 0.149 ms at 3.35 TB/s; its 11.2 GFLOP
//   of in-image products take 0.167 ms on the FP32 units. Tensor cores are
//   not used: tf32 wgmma reads only K-major shared-memory operands, which
//   this layout is not (row 4's NHWC design, which is, takes 0.69 ms at this
//   shape on an H100 SXM at 700 W).
//   Products. A block owns QR = 4 query rows x 32 queries. Consumer thread
//   (xg, s) owns queries x0 + 2xg, x0 + 2xg + 1 and source row y0 - r + s,
//   i.e. the outputs (q, dy = s - q) of all 4 query rows at every dx: 4 x 2
//   x d accumulators. A channel costs it 4 + r+1 (r+2 for odd r) 8-byte
//   shared loads (fm1 of its 4 rows, 2r+2 slab values) for 8d FMAs, one slab
//   row feeding all four query rows; pairs with dy outside [0, d) are
//   computed and dropped (79% of the FMAs are kept at r=5). A half-warp
//   reads 128 contiguous bytes of one row: no bank conflicts.
//   Loads. One producer warp; per stage of 8 channels a TMA box of the fm1
//   tile (32 x 8 x 4) and one of the slab (32 + 2h x 8 x 4+2r from x0 - h,
//   y0 - r, h = r rounded up to 4: a box's first column must lie on 16
//   bytes, or the load traps), zero-filled outside the image, through a
//   ring of 4 mbarrier-guarded stages (25.6 KB each at r=5). TMA needs
//   16-byte strides, W % 4 == 0: for other W the producer warp stages the
//   same layout with plain loads.
//   Epilogue. The consumers write their kept sums, scaled, into a (4, 32,
//   d^2) f32 tile over the ring (62 KB) and the block stores it in 16-byte
//   runs.
//   Budget at r=5: 8 warps, 128 registers a thread, 102 KB of shared memory,
//   two blocks an SM; per block 128 KB of fm1 and 14 x 48 KB of slab
//   through L2 (1.25 GB a launch at the training shape). On an H100 SXM,
//   against one block an SM with 9 stages (160 registers) two blocks
//   measured 8% faster; a warp skipping the query rows its source rows do
//   not reach measured 3% slower, 64-query blocks the same (PERF.md has
//   the readings).

#include <cuda.h>   // CUtensorMap and its enums only: the driver entry point
                    // is fetched at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma on MN-major operands
// ---------------------------------------------------------------------------

constexpr int QR = 4;                  // query rows per block, one per warp of a warpgroup
constexpr int SUB = 16;                // queries per sub-strip: one 32-byte swizzle atom
constexpr int NSUB = 2;                // sub-strips per block, one per consumer warpgroup
constexpr int TXW = SUB * NSUB;        // queries per block and row
constexpr int NB = 32;                 // source columns per product (16 + 2r <= 32)
constexpr int LEAD = 16;               // fm2 is staged from column x0 - LEAD
constexpr int WIN = 8;                // sub-strip j's window starts WIN + 16j columns in
constexpr int SCOLS = 64;              // staged fm2 columns: one 128-byte swizzle atom
constexpr int CK = 64;                 // channels per chunk
constexpr int A_ATOM = CK * SUB * 2;   // 16 columns x 64 channels, 32-byte rows: 2 KB
constexpr int A_BYTES = QR * A_ATOM;   // one sub-strip's fm1 chunk, 8 KB
constexpr int B_BYTES = CK * SCOLS * 2;   // one source row's fm2 chunk, 8 KB
constexpr int MAX_RES_C = 512;         // fm1 stays resident up to this C
constexpr int MAX_RES_NK = MAX_RES_C / CK;
constexpr int MAX_STAGES = 16;
constexpr int NCONS = 128 * NSUB;      // two consumer warpgroups
constexpr int NT = NCONS + 32;         // + one producer warp
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on the H100
constexpr int STATIC_RESERVE = 1024;   // the barriers (static shared memory)
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 1 KB
static_assert(WIN + SUB + NB <= SCOLS && WIN >= 5 && SCOLS - LEAD - TXW >= 5,
              "both windows lie in the staged atom, with a halo of r <= 5 each side");
static_assert(A_BYTES % ALIGN == 0 && B_BYTES % ALIGN == 0, "swizzle alignment");

struct Plan {
  int nk;         // channel chunks
  int resident;   // fm1 loaded once a block (C <= MAX_RES_C)
  int stage_bytes, nstage, fm1_bytes, out_bytes, smem;
};

Plan make_plan(int C, int r) {
  Plan p;
  const int dd = (2 * r + 1) * (2 * r + 1);
  p.nk = (C + CK - 1) / CK;
  p.resident = C <= MAX_RES_C;
  p.fm1_bytes = p.resident ? p.nk * NSUB * A_BYTES : 0;
  p.stage_bytes = B_BYTES + (p.resident ? 0 : NSUB * A_BYTES);
  p.out_bytes = (QR * TXW * dd * 2 + 15) / 16 * 16;
  const int avail = SMEM_LIMIT - STATIC_RESERVE - ALIGN - p.fm1_bytes - p.out_bytes;
  p.nstage = avail / p.stage_bytes < MAX_STAGES ? avail / p.stage_bytes : MAX_STAGES;
  p.smem = ALIGN + p.fm1_bytes + p.nstage * p.stage_bytes + p.out_bytes;
  return p;
}

struct Args {
  int H, W, C, r, nk, nstage;
  float scale;
  const uint16_t* fm1;   // the raw inputs, for the staging path without TMA
  const uint16_t* fm2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the schedule) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// 4-d TMA load of the box at (x, c, y, b) of `map` into shared `dst`,
// completion reported on `bar` (out-of-bounds elements arrive as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int c,
                                         int y, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(c), "r"(y), "r"(b),
        "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptors of MN-major operands (CUTLASS's canonical
// forms): A in the 32-byte swizzle, MN atoms of 16 elements LBO = 2 KB
// apart, 8-channel groups SBO = 256 bytes apart; B in the 128-byte swizzle,
// one MN atom of 64 elements (LBO unused), 8-channel groups 1 KB apart
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(A_ATOM >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32) |
         (3ull << 62);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 32] (+)= A[64 x 16] * B[32 x 16]^T, bf16 in, f32 accumulators, both
// operands MN-major (transpose bits set); accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_tt(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The staging path without TMA: lanes of the producer warp copy a box of
// `outer` x CK channels x `width` columns (columns fastest) into the
// swizzled layout a TMA box of the same shape would give: 2*width-byte rows,
// one a channel, `outer` blocks of CK rows; 16-byte unit u of a row's
// address is XORed with bits 7.. of the address (1 bit for 32-byte rows, 3
// for 128-byte rows). Element (o, c, e) is read at column x + e (+ 16 o when
// the outer index walks columns) of row y (+ o when it walks rows).
// Out-of-bounds elements are zeros.
template <int WIDTH>
__device__ __forceinline__ void stage_box(uint32_t dst, const uint16_t* src, const Args& a,
                                          int b, int x, int c0, int y, int outer,
                                          bool outer_rows, int lane) {
  constexpr int SHIFT = WIDTH == 16 ? 1 : 7;   // the swizzle's mask of row bits
  for (int i = lane; i < outer * CK * WIDTH; i += 32) {
    const int e = i % WIDTH, c = (i / WIDTH) % CK, o = i / (WIDTH * CK);
    const int col = x + e + (outer_rows ? 0 : 16 * o);
    const int row = y + (outer_rows ? o : 0), ch = c0 + c;
    uint16_t v = 0;
    if (col >= 0 && col < a.W && row >= 0 && row < a.H && ch < a.C)
      v = src[((static_cast<size_t>(b) * a.H + row) * a.C + ch) * a.W + col];
    uint32_t off = o * (CK * WIDTH * 2) + c * (WIDTH * 2) + e * 2;
    off ^= ((off >> 7) & SHIFT) << 4;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst + off), "h"(v) : "memory");
  }
}
// the plain stores above become visible to the tensor cores and TMA's
// async proxy, then lane 0 arrives on `bar`
__device__ __forceinline__ void publish(uint32_t bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// RES: fm1 resident (C <= MAX_RES_C), else streamed in each stage. TMA:
// staged by TMA (W % 8 == 0), else by the producer warp's plain loads.
template <bool RES, bool TMA>
__global__ void __launch_bounds__(NT, 1)
csub_tc_kernel(const __grid_constant__ CUtensorMap map1,
               const __grid_constant__ CUtensorMap map2,
               __nv_bfloat16* __restrict__ out, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES],
      fm1_ready[MAX_RES_NK];

  const int D = 2 * a.r + 1, DD = D * D;
  const int x0 = blockIdx.x * TXW, y0 = blockIdx.y * QR, b = blockIdx.z;
  // source rows y0-r .. y0+QR-1+r; those inside the image are s_lo .. s_hi
  const int s_lo = max(0, y0 - a.r), s_hi = min(a.H - 1, y0 + QR - 1 + a.r);
  const int stage_bytes = B_BYTES + (RES ? 0 : NSUB * A_BYTES);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t fm1_s = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t ring_s = fm1_s + (RES ? a.nk * NSUB * A_BYTES : 0);
  const uint32_t out_s = ring_s + a.nstage * stage_bytes;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem_raw + (out_s - raw));

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nstage; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), NCONS / 32);   // one arrival per consumer warp
    }
    for (int k = 0; k < MAX_RES_NK; ++k) mbar_init(smem_u32(&fm1_ready[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role as a value ptxas can see is warp-uniform (a branch on
  // threadIdx alone reads as divergent, and wgmmas under it serialize)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == NSUB) {
    // ---- producer warp: lane 0 issues every TMA load of the block, or
    // all lanes stage with plain loads ----
    if (TMA && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map1)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map2)) : "memory");
    }
    if constexpr (RES) {
      for (int k = 0; k < a.nk; ++k) {
        const uint32_t bar = smem_u32(&fm1_ready[k]);
        if (TMA) {
          if (lane == 0) {
            mbar_expect_tx(bar, NSUB * A_BYTES);
            for (int j = 0; j < NSUB; ++j)
              tma_load(fm1_s + (k * NSUB + j) * A_BYTES, &map1, x0 + SUB * j, k * CK, y0, b, bar);
          }
        } else {
          for (int j = 0; j < NSUB; ++j)
            stage_box<SUB>(fm1_s + (k * NSUB + j) * A_BYTES, a.fm1, a, b, x0 + SUB * j, k * CK,
                           y0, QR, true, lane);
          publish(bar, lane);
        }
      }
    }
    int stage = 0, phase = 0;
    for (int s = s_lo; s <= s_hi; ++s) {   // rows outside the image: nothing to load
      for (int k = 0; k < a.nk; ++k) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t st = ring_s + stage * stage_bytes;
        if (TMA) {
          if (lane == 0) {
            mbar_expect_tx(bar, stage_bytes);
            tma_load(st, &map2, x0 - LEAD, k * CK, s, b, bar);
            if (!RES)
              for (int j = 0; j < NSUB; ++j)
                tma_load(st + B_BYTES + j * A_BYTES, &map1, x0 + SUB * j, k * CK, y0, b, bar);
          }
        } else {
          stage_box<SCOLS>(st, a.fm2, a, b, x0 - LEAD, k * CK, s, 1, false, lane);
          if (!RES)
            for (int j = 0; j < NSUB; ++j)
              stage_box<SUB>(st + B_BYTES + j * A_BYTES, a.fm1, a, b, x0 + SUB * j, k * CK, y0,
                             QR, true, lane);
          publish(bar, lane);
        }
        if (++stage == a.nstage) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warpgroup `role` computes sub-strip j = role; its warp w
  // the query row y0 + w. Every wgmma is issued on a path all 128 threads of
  // the warpgroup take (ptxas serializes them otherwise): a sub-strip past
  // the image edge, or channels past C, are computed on zeros and dropped.
  const int j = role, w = (threadIdx.x >> 5) & 3;
  float acc[16];
  // the band of source row s for query row y0 + w: accumulator element t is
  // (query m, window column n) with m = lane/4 + 8*((t>>1)&1), n = 8*(t>>2)
  // + 2*(lane%4) + (t&1), displacement dx = n - m - (WIN - r)
  auto band = [&](int s, bool zero) {
    const int dy = s - (y0 + w) + a.r;
    if (dy < 0 || dy >= D) return;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int m = (lane >> 2) + 8 * ((t >> 1) & 1);
      const int dx = 8 * (t >> 2) + 2 * (lane & 3) + (t & 1) - m - (WIN - a.r);
      if (dx >= 0 && dx < D)
        so[(w * TXW + SUB * j + m) * DD + dx * D + dy] =
            __float2bfloat16(zero ? 0.f : acc[t] * a.scale);
    }
  };
  for (int s = y0 - a.r; s < y0 + QR + a.r; ++s)
    if (s < s_lo || s > s_hi) band(s, true);   // zero outside the image

  // B: sub-strip j's window, WIN + 16j columns (2 bytes each) into the atom
  const uint32_t b_off = (WIN + SUB * j) * 2;
  int stage = 0, phase = 0, prev = -1;
  for (int s = s_lo; s <= s_hi; ++s) {
    for (int k = 0; k < a.nk; ++k) {
      if constexpr (RES) mbar_wait(smem_u32(&fm1_ready[k]), 0);
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t st = ring_s + stage * stage_bytes;
      const uint32_t a_s = RES ? fm1_s + (k * NSUB + j) * A_BYTES : st + B_BYTES + j * A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)   // 16 channels: two 8-channel groups
        wgmma_tt(acc, desc_a(a_s + kk * 2 * 256), desc_b(st + b_off + kk * 2 * 1024),
                 (k | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products have retired
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = stage;
      if (++stage == a.nstage) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
    prev = -1;
    band(s, false);
  }

  // every consumer warp's band is in the tile: store each query row's run
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  const int nq = min(TXW, a.W - x0);
  for (int q = 0; q < QR; ++q) {
    const int y = y0 + q;
    if (y >= a.H) break;
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * a.H + y) * a.W + x0) * DD;
    const __nv_bfloat16* src = so + q * TXW * DD;
    const int n = nq * DD;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {   // W % 8 == 0: 16-byte runs
      const int nv = n / 8;
      for (int e = threadIdx.x; e < nv; e += NCONS)
        reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
      done = nv * 8;
    }
    for (int e = done + threadIdx.x; e < n; e += NCONS) dst[e] = src[e];
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (B, H, C, W) tensor as a 4-d map (W, C, H, B), boxes of bw columns x
// bc channels x bh rows of one image, zeros out of bounds
bool encode_map(CUtensorMap* map, const void* ptr, bool f32, int B, int H, int W, int C,
                int bw, int bc, int bh, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(W) * (f32 ? 4 : 2);
  const cuuint64_t strides[3] = {row, row * C, row * C * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bc),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

typedef void (*TcKernel)(CUtensorMap, CUtensorMap, __nv_bfloat16*, Args);

// the kernel instance for a plan, its dynamic shared memory allowed
template <bool RES, bool TMA>
cudaError_t tc_kernel(const Plan& p, TcKernel* fn) {
  static int allowed[MAX_DEVICES] = {};
  *fn = csub_tc_kernel<RES, TMA>;
  return allow_smem(reinterpret_cast<const void*>(*fn), p.smem, allowed);
}

cudaError_t select_kernel(const Plan& p, bool tma, TcKernel* fn) {
  if (p.nstage < 2) return cudaErrorInvalidValue;
  if (p.resident) return tma ? tc_kernel<true, true>(p, fn) : tc_kernel<true, false>(p, fn);
  return tma ? tc_kernel<false, true>(p, fn) : tc_kernel<false, false>(p, fn);
}

cudaError_t launch_tc(const void* fm1, const void* fm2, void* out, int B, int H, int W,
                      int C, int r, float scale, cudaStream_t stream) {
  const Plan p = make_plan(C, r);
  const bool tma = W % 8 == 0;   // TMA needs 16-byte strides between channel rows
  TcKernel fn;
  cudaError_t e = select_kernel(p, tma, &fn);
  if (e != cudaSuccess) return e;
  CUtensorMap map1 = {}, map2 = {};
  if (tma && (!encode_map(&map1, fm1, false, B, H, W, C, SUB, CK, QR,
                          CU_TENSOR_MAP_SWIZZLE_32B) ||
              !encode_map(&map2, fm2, false, B, H, W, C, SCOLS, CK, 1,
                          CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const Args a{H, W, C, r, p.nk, p.nstage, scale, static_cast<const uint16_t*>(fm1),
               static_cast<const uint16_t*>(fm2)};
  const dim3 grid((W + TXW - 1) / TXW, (H + QR - 1) / QR, B);
  fn<<<grid, NT, p.smem, stream>>>(map1, map2, static_cast<__nv_bfloat16*>(out), a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: TMA staging, register-blocked FP32 FMAs
// ---------------------------------------------------------------------------

constexpr int F_TX = 32;          // queries per block and row
constexpr int F_XG = F_TX / 2;    // column pairs: a thread owns two adjacent queries
constexpr int F_CC = 8;           // channels per stage
constexpr int F_MAX_STAGES = 4;
constexpr int F_MIN_BLOCKS = 2;   // blocks an SM the registers must allow

template <int R>
struct FShape {
  static constexpr int D = 2 * R + 1;
  static constexpr int SR = QR + 2 * R;                    // slab rows, from y0 - R
  // slab columns from x0 - HALO: a TMA box's first column must lie on 16 bytes
  static constexpr int HALO = (R + 3) / 4 * 4;
  static constexpr int OFF = HALO - R;                     // slab column of x0 - R
  static constexpr int SCW = F_TX + 2 * HALO;
  static constexpr int NCONS = F_XG * SR;                  // consumer threads
  static constexpr int NT = NCONS + 32;                    // + one producer warp
  static constexpr int A_FLOATS = QR * F_CC * F_TX;        // a stage's fm1 tile [q][c][x]
  static constexpr int STAGE = (A_FLOATS + SR * F_CC * SCW) * 4;   // + the slab [s][c][x]
  static constexpr int TILE = QR * F_TX * D * D * 4;       // the output tile, over the ring
  static_assert(STAGE % 128 == 0 && NCONS % 32 == 0, "TMA destinations, whole warps");
  static_assert(2 * (F_XG - 1) + OFF + 2 * R + 2 <= SCW, "the last pair's loads lie in the slab");
};

struct FArgs {
  int H, W, C, nstage;
  float scale;
  const float* fm1;   // the raw inputs, for the staging path without TMA
  const float* fm2;
};

template <int R>
int f32_stages() {
  const int n = (SMEM_LIMIT - STATIC_RESERVE - 128) / FShape<R>::STAGE;
  return n < F_MAX_STAGES ? n : F_MAX_STAGES;
}
template <int R>
int f32_smem(int nstage) {
  const int ring = nstage * FShape<R>::STAGE;
  return 128 + (ring > FShape<R>::TILE ? ring : FShape<R>::TILE);
}

// R: radius. TMA: staged by TMA (W % 4 == 0), else by the producer warp's
// plain loads into the same layout.
template <int R, bool TMA>
__global__ void __launch_bounds__(FShape<R>::NT, F_MIN_BLOCKS)
csub_f32_kernel(const __grid_constant__ CUtensorMap map1,
                const __grid_constant__ CUtensorMap map2, float* __restrict__ out,
                const FArgs a) {
  using S = FShape<R>;
  constexpr int D = S::D, DD = D * D, SR = S::SR, SCW = S::SCW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F_MAX_STAGES], empty[F_MAX_STAGES];

  const int x0 = blockIdx.x * F_TX, y0 = blockIdx.y * QR, b = blockIdx.z;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring_s = (raw + 127) & ~127u;
  float* ring = reinterpret_cast<float*>(smem_raw + (ring_s - raw));
  const int nsteps = a.C / F_CC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nstage; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), S::NCONS / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x & 31;
  if (warp == S::NCONS / 32) {
    // ---- producer warp: per stage the fm1 tile (4 rows x 32 columns) and
    // the slab (4+2R rows x SCW columns from x0 - HALO) of 8 channels ----
    if (TMA && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map1)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map2)) : "memory");
    }
    int stage = 0, phase = 0;
    for (int t = 0; t < nsteps; ++t) {
      const int c0 = t * F_CC;
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t bar = smem_u32(&full[stage]);
      const uint32_t st = ring_s + stage * S::STAGE;
      if (TMA) {
        if (lane == 0) {
          mbar_expect_tx(bar, S::STAGE);
          tma_load(st, &map1, x0, c0, y0, b, bar);
          tma_load(st + S::A_FLOATS * 4, &map2, x0 - S::HALO, c0, y0 - R, b, bar);
        }
      } else {
        float* sa = ring + stage * (S::STAGE / 4);
        for (int i = lane; i < S::A_FLOATS; i += 32) {
          const int x = x0 + i % F_TX, c = c0 + (i / F_TX) % F_CC, y = y0 + i / (F_TX * F_CC);
          sa[i] = x < a.W && y < a.H
                      ? a.fm1[((static_cast<size_t>(b) * a.H + y) * a.C + c) * a.W + x] : 0.f;
        }
        float* sb = sa + S::A_FLOATS;
        for (int i = lane; i < SR * F_CC * SCW; i += 32) {
          const int x = x0 - S::HALO + i % SCW, c = c0 + (i / SCW) % F_CC;
          const int y = y0 - R + i / (SCW * F_CC);
          sb[i] = x >= 0 && x < a.W && y >= 0 && y < a.H
                      ? a.fm2[((static_cast<size_t>(b) * a.H + y) * a.C + c) * a.W + x] : 0.f;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      }
      if (++stage == a.nstage) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer (xg, s): queries x0 + 2xg + p (p = 0, 1) against source
  // row y0 - R + s, i.e. the outputs (q, dy = s - q) of the 4 query rows.
  // Pairs with dy outside [0, D) are computed and dropped (uniform work). ----
  const int xg = threadIdx.x % F_XG, s = threadIdx.x / F_XG;
  float acc[QR][2][D];
#pragma unroll
  for (int q = 0; q < QR; ++q)
#pragma unroll
    for (int dx = 0; dx < D; ++dx) acc[q][0][dx] = acc[q][1][dx] = 0.f;

  // the slab is read in 8-byte pairs from an even column: from OFF - E,
  // one column early where OFF is odd
  constexpr int E = S::OFF & 1, NV = (2 * R + 2 + E + 1) / 2;
  int stage = 0, phase = 0;
  for (int t = 0; t < nsteps; ++t) {
    mbar_wait(smem_u32(&full[stage]), phase);
    const float* sa = ring + stage * (S::STAGE / 4) + 2 * xg;
    const float* sb = ring + stage * (S::STAGE / 4) + S::A_FLOATS + s * F_CC * SCW + 2 * xg +
                      S::OFF - E;
#pragma unroll
    for (int c = 0; c < F_CC; ++c) {
      float2 av[QR];
#pragma unroll
      for (int q = 0; q < QR; ++q)
        av[q] = *reinterpret_cast<const float2*>(sa + (q * F_CC + c) * F_TX);
      // v[j + E]: fm2 at column x0 + 2xg - R + j, i.e. dx = j - p for query p
      float v[2 * NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float2 u = *reinterpret_cast<const float2*>(sb + c * SCW + 2 * j);
        v[2 * j] = u.x;
        v[2 * j + 1] = u.y;
      }
#pragma unroll
      for (int q = 0; q < QR; ++q)
#pragma unroll
        for (int dx = 0; dx < D; ++dx) {
          acc[q][0][dx] = fmaf(av[q].x, v[E + dx], acc[q][0][dx]);
          acc[q][1][dx] = fmaf(av[q].y, v[E + dx + 1], acc[q][1][dx]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == a.nstage) { stage = 0; phase ^= 1; }
  }

  // the output tile (4, 32, d^2) over the ring, which every stage has left
  asm volatile("bar.sync 1, %0;\n" ::"n"(S::NCONS) : "memory");
#pragma unroll
  for (int q = 0; q < QR; ++q) {
    const int dy = s - q;
    if (dy < 0 || dy >= D) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int dx = 0; dx < D; ++dx)
        ring[(q * F_TX + 2 * xg + p) * DD + dx * D + dy] = acc[q][p][dx] * a.scale;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(S::NCONS) : "memory");
  const int nq = min(F_TX, a.W - x0);
  for (int q = 0; q < QR; ++q) {
    const int y = y0 + q;
    if (y >= a.H) break;
    float* dst = out + ((static_cast<size_t>(b) * a.H + y) * a.W + x0) * DD;
    const float* src = ring + q * F_TX * DD;
    const int n = nq * DD;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {   // W % 4 == 0: 16-byte runs
      const int nv = n / 4;
      for (int e = threadIdx.x; e < nv; e += S::NCONS)
        reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
      done = nv * 4;
    }
    for (int e = done + threadIdx.x; e < n; e += S::NCONS) dst[e] = src[e];
  }
}

typedef void (*F32Kernel)(CUtensorMap, CUtensorMap, float*, FArgs);

// the kernel instance for radius R, its dynamic shared memory allowed
template <int R, bool TMA>
cudaError_t f32_kernel(F32Kernel* fn, int* nstage, int* smem, int* threads) {
  static int allowed[MAX_DEVICES] = {};
  *fn = csub_f32_kernel<R, TMA>;
  *nstage = f32_stages<R>();
  *smem = f32_smem<R>(*nstage);
  *threads = FShape<R>::NT;
  return allow_smem(reinterpret_cast<const void*>(*fn), *smem, allowed);
}

cudaError_t select_f32_kernel(int r, bool tma, F32Kernel* fn, int* nstage, int* smem,
                              int* threads) {
  switch (r) {
    case 1: return tma ? f32_kernel<1, true>(fn, nstage, smem, threads)
                       : f32_kernel<1, false>(fn, nstage, smem, threads);
    case 2: return tma ? f32_kernel<2, true>(fn, nstage, smem, threads)
                       : f32_kernel<2, false>(fn, nstage, smem, threads);
    case 3: return tma ? f32_kernel<3, true>(fn, nstage, smem, threads)
                       : f32_kernel<3, false>(fn, nstage, smem, threads);
    case 4: return tma ? f32_kernel<4, true>(fn, nstage, smem, threads)
                       : f32_kernel<4, false>(fn, nstage, smem, threads);
    default: return tma ? f32_kernel<5, true>(fn, nstage, smem, threads)
                        : f32_kernel<5, false>(fn, nstage, smem, threads);
  }
}

cudaError_t launch_f32(const void* fm1, const void* fm2, void* out, int B, int H, int W,
                       int C, int r, float scale, cudaStream_t stream) {
  const bool tma = W % 4 == 0;   // TMA needs 16-byte strides between channel rows
  F32Kernel fn;
  int nstage, smem, threads;
  cudaError_t e = select_f32_kernel(r, tma, &fn, &nstage, &smem, &threads);
  if (e != cudaSuccess) return e;
  const int scw = F_TX + 2 * ((r + 3) / 4 * 4);   // FShape<r>::SCW
  CUtensorMap map1 = {}, map2 = {};
  if (tma && (!encode_map(&map1, fm1, true, B, H, W, C, F_TX, F_CC, QR,
                          CU_TENSOR_MAP_SWIZZLE_NONE) ||
              !encode_map(&map2, fm2, true, B, H, W, C, scw, F_CC, QR + 2 * r,
                          CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  const FArgs a{H, W, C, nstage, scale, static_cast<const float*>(fm1),
                static_cast<const float*>(fm2)};
  const dim3 grid((W + F_TX - 1) / F_TX, (H + QR - 1) / QR, B);
  fn<<<grid, threads, smem, stream>>>(map1, map2, static_cast<float*>(out), a);
  return cudaGetLastError();
}

bool valid_inputs(const void* fm1, const void* fm2, int B, int H, int W, int C, int r) {
  // 16-byte aligned inputs, C a multiple of 16 (whole stages of channels)
  return C > 0 && C % 16 == 0 && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 * QR &&
         W >= 1 && r >= 1 && r <= 5 && reinterpret_cast<uintptr_t>(fm1) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(fm2) % 16 == 0;
}

}  // namespace

// Each entry point takes fm1, fm2 as (B, H, C, W) and writes out as
// (B, H, W, (2r+1)^2); it launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int local_corr_csub_f32(const void* fm1, const void* fm2, void* out,
                                   int B, int H, int W, int C, int r, float scale,
                                   void* stream) {
  if (!valid_inputs(fm1, fm2, B, H, W, C, r)) return cudaErrorInvalidValue;
  return launch_f32(fm1, fm2, out, B, H, W, C, r, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int local_corr_csub_bf16(const void* fm1, const void* fm2, void* out,
                                    int B, int H, int W, int C, int r, float scale,
                                    void* stream) {
  if (!valid_inputs(fm1, fm2, B, H, W, C, r)) return cudaErrorInvalidValue;
  return launch_tc(fm1, fm2, out, B, H, W, C, r, scale, static_cast<cudaStream_t>(stream));
}

// The launch plan at (C, r) of the bf16 design (bf16 != 0) or the f32 one,
// on the TMA path: shared memory a block (bytes), resident blocks an SM (the
// CUDA occupancy calculator), registers a thread and local memory a thread
// (bytes; above 0 means ptxas spilled); returns a cudaError_t.
extern "C" int local_corr_csub_plan(int C, int r, int bf16, int* smem, int* blocks_per_sm,
                                    int* regs, int* local_bytes) {
  if (C <= 0 || C % 16 != 0 || r < 1 || r > 5) return cudaErrorInvalidValue;
  const void* fn;
  int threads, dyn;
  cudaError_t e;
  if (bf16) {
    const Plan p = make_plan(C, r);
    TcKernel k;
    e = select_kernel(p, true, &k);
    fn = reinterpret_cast<const void*>(k);
    threads = NT;
    dyn = p.smem;
  } else {
    F32Kernel k;
    int nstage;
    e = select_f32_kernel(r, true, &k, &nstage, &dyn, &threads);
    fn = reinterpret_cast<const void*>(k);
  }
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  *smem = static_cast<int>(attr.sharedSizeBytes) + dyn;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, dyn);
}

extern "C" const char* local_corr_csub_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
