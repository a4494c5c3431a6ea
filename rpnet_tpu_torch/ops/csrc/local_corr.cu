// Local correlation for the context relation encoder, hand-written for Hopper
// (sm_90a). Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py
// with nvcc and loaded with ctypes.
//
// Replaces two TPU kernels of rpnet_tpu/ops/pallas/correlation.py that
// compute one function: _corr_rot_kernel in select mode (the eval path,
// bf16) and _corr_kernel (the training forward, f32). It computes what they
// compute, in the order the consumer (the CRE's 1x1 conv) wants, with none
// of the TPU layout devices (column-reversed fm2, 128-lane pad, dy-major
// dx-reversed channels):
//
//   out[b,y,x,dx*d+dy] = cast(scale * sum_c f32(fm1[b,y,x,c])
//                                         * f32(fm2[b,y+dy-r,x+dx-r,c]))
//
// d = 2r+1, zero outside the image, f32 accumulation, one rounding to the
// input dtype.
//
// bf16 (local_corr_bf16): TMA staging and wgmma band products.
//   Bound at the eval shape (26 slices, 64x64, C=256, r=5): the function
//   reads fm1 and fm2 once (2 x 54.5 MB) and writes 25.8 MB, 40 us at the
//   H100 SXM's 3.35 TB/s; its 6.1 GFLOP of in-image products take 6 us on
//   bf16 tensor cores. So it is memory-bound. What the design has to keep
//   down is what each block pulls through L2 (every fm2 row is needed by
//   2r+1 query rows), and the tensor work it wastes on products outside the
//   band, which must stay below the memory time.
//   Products. A block owns QR = 4 query rows and a 64-query strip of one
//   image. The TPU kernel's row-against-row product becomes, for each
//   source row s (y0-r .. y0+3+r) and each 16-query sub-strip j, one wgmma
//   product D[64 x 32] = A[64 x C] * B[32 x C]^T: A's 64 rows are the
//   sub-strip's 16 queries of all 4 query rows, B's 32 rows the source
//   columns x0+16j-r .. x0+16j-r+31 of row s. Element (query row q, query
//   m, column n) is the product at dy = s-(y0+q)+r, dx = n-m; the epilogue
//   keeps those with both in [0, d). That wastes 32/11 in columns and 14/11
//   in rows (3.7x, about 24 GFLOP at the eval shape), against 7.3x for a
//   64 x 80 product per query row.
//   Loads. Operands reach shared memory by TMA only, in 128-byte channel
//   chunks (64 bf16) with the 128-byte swizzle the wgmma descriptors name;
//   NHWC is K-major for both operands as it is. Boxes that reach outside
//   the image or past C arrive zero-filled, which replaces every halo
//   predicate; source rows wholly outside the image are skipped (their
//   band is written as zeros). fm2 streams one source row's chunk (80
//   columns, 10 KB) per stage through a ring of mbarrier-guarded stages.
//   Roles. One producer warp: its thread 0 issues every TMA load. Four
//   consumer warpgroups, one per sub-strip; warp w of a warpgroup owns query
//   row y0 + w in the epilogue. For C <= 256 each warpgroup loads its
//   sub-strip's fm1 once (staged over ring stages 3.., then freed) into
//   registers with ldmatrix (64 registers a thread) and issues its products
//   with A in registers: the SM then reads only B from shared memory (16 KB
//   a stage instead of 48), and the ring gets the 160 KB fm1 would have
//   held (16 stages at r=5). For C > 256 fm1's chunk rides in each stage
//   beside fm2's and A is read from shared memory (3 stages; more L2
//   traffic, same products). 17 warps put 5 on one SM sub-partition, which
//   caps registers at 96 a thread: at C=256 ptxas spills 96 bytes and
//   serializes the products. Versions without the spill (no producer warp,
//   thread 0 loading from the product loop) measured slower; PERF.md has
//   the readings.
//   Epilogue. Each warpgroup releases a stage as soon as the products that
//   read it retire; after each source row it writes its band, scaled and
//   rounded once, into a (4, 64, d^2) output tile in shared memory, which
//   the block stores in contiguous 16-byte runs at the end. Per block that
//   is 128 KB of fm1 and 14 x 40 KB of fm2 through L2 (286 MB at the eval
//   shape, against 0.8 GB for the band kernel). A wait on a barrier that
//   never completes traps instead of hanging the card.
//
// f32 (local_corr_f32): TMA staging and wgmma band products in 3xTF32.
//   Bound at the training shape (48 slices, 64x64, C=256, r=5): the function
//   reads 402 MB and writes 95 MB, 149 us at 3.35 TB/s; its 11.2 GFLOP of
//   in-image products take 68 us as three TF32 passes. The band tiling
//   below multiplies the products by 32/11 x 14/11 (128 GFLOP with the rows
//   outside the image skipped): 0.26 ms at the TF32 peak.
//   Products. The bf16 band product on a 32-query strip: a block owns QR = 4
//   query rows and two 16-query sub-strips, one consumer warpgroup each. For
//   each source row s and sub-strip j, wgmma m64n32k8 TF32 forms D[64 x 32]
//   = A[64 x C] * B[32 x C]^T with the bf16 row and column maps, in three
//   passes: small(A) big(B) + big(A) small(B) + big(A) big(B), big = the
//   value with its low 13 bits masked, small = the rest (exact in f32). A raw
//   f32 operand serves as its own big part: the tensor core ignores a TF32
//   operand's low 13 bits. A comes from registers, B from shared memory.
//   Registers. Nine warps put three on one SM sub-partition, which caps a
//   thread at 168 registers (a producer warpgroup that gives registers back
//   with setmaxnreg does not raise ptxas' budget). So of each 256-channel
//   group, 4 chunks of 32 channels sit in registers as raw fragments (64 a
//   thread) and the other 4 stay resident in shared memory, their fragments
//   read per k step. A source row's products are unrolled over the register
//   chunks only: unrolled to 96 wgmmas, ptxas serializes every one of them
//   (C7512, whatever the registers). C > 256 runs in groups of 256 channels,
//   each group's band added into the output tile.
//   Loads. TMA only, 4-d tensor maps as bf16, boxes of 32 channels (128
//   bytes, the 128-byte swizzle), zero-filled outside the image and past C.
//   One producer warp issues, in order, through one ring of 12 KB stages:
//   per group the register chunks (one sub-strip's 4 rows x 16 queries a
//   stage), then for each source row inside the image and each chunk the
//   row's 48 staged columns (6 KB); the resident chunks go to their own area
//   once a group. Two splitter warps write each landed row chunk's small
//   parts (the same swizzled layout, 6 KB further on) and publish the stage
//   on a `ready` barrier, which the consumers wait on.
//   Epilogue. As bf16, in f32: after each source row a warpgroup writes its
//   band, scaled, into a (4, 32, d^2) f32 output tile (62 KB at r=5), stored
//   in 16-byte runs at the end.
//   Budget at C=256, r=5: 8 stages x 12 KB + 64 KB of resident fm1 + the
//   tile + 1 KB of alignment = 226,816 bytes of shared memory, one block an
//   SM; per block 128 KB of fm1 and 14 x 8 x 6 KB of fm2 through L2 (1.23 GB
//   a launch at the training shape). What holds it (PERF.md has the
//   readings): the loads alone take 0.30 ms, the loads with the consumers'
//   other work 0.44, and the products add their whole tensor floor on top.

#include <cuda.h>   // CUtensorMap and its enums only: the driver entry point
                    // is fetched at run time, so no -lcuda
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

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int QR = 4;                  // query rows per block, one per warp of a warpgroup
constexpr int SUB = 16;                // queries per sub-strip
constexpr int NSUB = 4;                // sub-strips per block, one per consumer warpgroup
constexpr int TXW = SUB * NSUB;        // queries per block and row
constexpr int NB = 32;                 // source columns per product (16 + 2r <= 32)
constexpr int SCOLS = TXW - SUB + NB;  // staged source columns x0-r .. x0-r+79
constexpr int CK = 64;                 // channels per chunk: one 128-byte swizzle row
constexpr int ROWB = 128;              // shared bytes per staged pixel and chunk
constexpr int A_BYTES = QR * SUB * ROWB;   // one sub-strip's fm1 chunk, 8 KB
constexpr int B_BYTES = SCOLS * ROWB;      // one source row's fm2 chunk, 10 KB
constexpr int MAX_REG_CHUNKS = 4;      // fm1 held in registers for C <= 256
constexpr int FM1_AT = 3;              // fm1 is staged over the ring from this stage on
constexpr int MAX_STAGES = 20;
constexpr int NCONS = 128 * NSUB;      // four consumer warpgroups
constexpr int NTC = NCONS + 32;        // + one producer warp
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on the H100
constexpr int STATIC_RESERVE = 1024;   // the barriers (static shared memory)
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 1 KB

struct Plan {
  int nk;        // channel chunks
  int reg_nk;    // = nk when fm1 is held in registers (C <= 256), else 0
  int nstage;    // ring stages
  int stage_bytes, out_bytes, smem;
};

Plan make_plan(int C, int r) {
  Plan p;
  const int dd = (2 * r + 1) * (2 * r + 1);
  p.nk = (C + CK - 1) / CK;
  p.reg_nk = p.nk <= MAX_REG_CHUNKS ? p.nk : 0;
  p.stage_bytes = B_BYTES + (p.reg_nk ? 0 : NSUB * A_BYTES);
  p.out_bytes = (QR * TXW * dd * 2 + 15) / 16 * 16;
  const int avail = SMEM_LIMIT - STATIC_RESERVE - ALIGN - p.out_bytes;
  p.nstage = avail / p.stage_bytes < MAX_STAGES ? avail / p.stage_bytes : MAX_STAGES;
  p.smem = ALIGN + p.nstage * p.stage_bytes + p.out_bytes;
  if (p.reg_nk && p.nstage * B_BYTES < FM1_AT * B_BYTES + p.nk * NSUB * A_BYTES)
    p.nstage = 0;   // fm1 must fit over the ring's stages FM1_AT..
  return p;
}

struct Args {
  int H, W, C, r, nk, nstage;
  float scale;
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

// 4-d TMA load of box (c, x, y, b) of `map` into shared `dst`, completion
// reported on `bar` (out-of-bounds elements arrive as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c,
                                         int x, int y, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
        "r"(bar)
      : "memory");
}

// four 8x8 b16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), leading
// offset unused for this layout (1)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
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

#define WGMMA_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D16_ARGS(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// D[64 x 32] (+)= A[64 x 16] * B[32 x 16]^T, bf16 in, f32 accumulators,
// accumulate = 0 overwrites D. A from shared memory (ss) or registers (rs).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D16_ARGS(d) : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&fa)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : WGMMA_D16_ARGS(d)
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "l"(db), "r"(accumulate));
}

// REG_NK > 0: C <= 64*REG_NK, each consumer warpgroup holds its sub-strip's
// fm1 in registers (staged once over ring stages FM1_AT..). REG_NK = 0:
// C > 256, fm1's chunk rides in every stage and is read from shared memory.
template <int REG_NK>
__global__ void __launch_bounds__(NTC, 1)
local_corr_tc_kernel(const __grid_constant__ CUtensorMap map1,
                     const __grid_constant__ CUtensorMap map2,
                     __nv_bfloat16* __restrict__ out, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES],
      fm1_ready[MAX_REG_CHUNKS], fm1_free;

  const int D = 2 * a.r + 1, DD = D * D;
  const int x0 = blockIdx.x * TXW, y0 = blockIdx.y * QR, b = blockIdx.z;
  const int nj = min(NSUB, (a.W - x0 + SUB - 1) / SUB);   // sub-strips inside the image
  // source rows y0-r .. y0+QR-1+r; those inside the image are s_lo .. s_hi
  const int s_lo = max(0, y0 - a.r), s_hi = min(a.H - 1, y0 + QR - 1 + a.r);
  const int stage_bytes = B_BYTES + (REG_NK ? 0 : NSUB * A_BYTES);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring_s = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t fm1_s = ring_s + FM1_AT * B_BYTES;   // REG_NK > 0: staged once
  const uint32_t out_s = ring_s + a.nstage * stage_bytes;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem_raw + (out_s - raw));

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nstage; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), NCONS / 32);   // one arrival per consumer warp
    }
    for (int k = 0; k < MAX_REG_CHUNKS; ++k) mbar_init(smem_u32(&fm1_ready[k]), 1);
    mbar_init(smem_u32(&fm1_free), NCONS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role as a value ptxas can see is warp-uniform (a branch on
  // threadIdx alone reads as divergent, and wgmmas under it serialize)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == NSUB) {
    // ---- producer: one thread issues every TMA load of the block ----
    if (threadIdx.x == NCONS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map1)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map2)) : "memory");
      if (REG_NK) {
        for (int k = 0; k < REG_NK; ++k) {
          const uint32_t bar = smem_u32(&fm1_ready[k]);
          mbar_expect_tx(bar, nj * A_BYTES);
          for (int j = 0; j < nj; ++j)
            tma_load(fm1_s + (k * NSUB + j) * A_BYTES, &map1, k * CK, x0 + SUB * j, y0, b, bar);
        }
      }
      bool fm1_gone = REG_NK == 0;
      int stage = 0, phase = 0;
      for (int s = s_lo; s <= s_hi; ++s) {   // rows outside the image: nothing to load
        for (int k = 0; k < a.nk; ++k) {
          if (!fm1_gone && stage == FM1_AT) {   // every warp holds its fm1 fragments
            mbar_wait(smem_u32(&fm1_free), 0);
            fm1_gone = true;
          }
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t st = ring_s + stage * stage_bytes;
          mbar_expect_tx(bar, B_BYTES + (REG_NK ? 0 : nj * A_BYTES));
          tma_load(st, &map2, k * CK, x0 - a.r, s, b, bar);
          if (!REG_NK)
            for (int j = 0; j < nj; ++j)
              tma_load(st + B_BYTES + j * A_BYTES, &map1, k * CK, x0 + SUB * j, y0, b, bar);
          if (++stage == a.nstage) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup `role` computes sub-strip j = role; its warp w
  // the query row y0 + w. Every wgmma is issued on a path all 128 threads of
  // the warpgroup take (ptxas serializes them otherwise): a sub-strip past
  // the image edge, or channels past C, are computed on stale data or zeros
  // and dropped.
  const int j = role, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  uint32_t fa[REG_NK ? REG_NK * 4 : 1][4];   // A fragments, one set per 16-channel step
  if constexpr (REG_NK > 0) {
    // ldmatrix.x4 lane l addresses row 16w + l%8 + 8*((l/8)&1), 16-byte
    // chunk 2*kk + l/16: the four 8x8 blocks of the fragment's 16 x 16
    const int row = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int k = 0; k < REG_NK; ++k) {
      mbar_wait(smem_u32(&fm1_ready[k]), 0);
      const uint32_t tile = fm1_s + (k * NSUB + j) * A_BYTES + row * ROWB;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)
        ldmatrix_x4(fa[k * 4 + kk], tile + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&fm1_free));
  }

  float acc[16];
  // the band of source row s for query row y0 + w: accumulator element t is
  // (query m, column n) with m = lane/4 + 8*((t>>1)&1), n = 8*(t>>2) +
  // 2*(lane%4) + (t&1), displacement dx = n - m
  auto band = [&](int s, bool zero) {
    const int dy = s - (y0 + w) + a.r;
    if (dy < 0 || dy >= D || j >= nj) return;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int m = (lane >> 2) + 8 * ((t >> 1) & 1);
      const int dx = 8 * (t >> 2) + 2 * (lane & 3) + (t & 1) - m;
      if (dx >= 0 && dx < D)
        so[(w * TXW + SUB * j + m) * DD + dx * D + dy] =
            __float2bfloat16(zero ? 0.f : acc[t] * a.scale);
    }
  };
  for (int s = y0 - a.r; s < y0 + QR + a.r; ++s)
    if (s < s_lo || s > s_hi) band(s, true);   // zero outside the image

  int stage = 0, phase = 0, prev = -1;
  // one stage: channel chunk k of source row s
  auto step = [&](int k) {
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t st = ring_s + stage * stage_bytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint64_t db = wgmma_desc(st + j * SUB * ROWB + kk * 32);
      if constexpr (REG_NK > 0)
        wgmma_rs(acc, fa[k * 4 + kk], db, (k | kk) != 0);
      else
        wgmma_ss(acc, wgmma_desc(st + B_BYTES + j * A_BYTES + kk * 32), db, (k | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products have retired
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
    prev = stage;
    if (++stage == a.nstage) { stage = 0; phase ^= 1; }
  };
  for (int s = s_lo; s <= s_hi; ++s) {
    if constexpr (REG_NK > 0) {
#pragma unroll
      for (int k = 0; k < REG_NK; ++k) step(k);
    } else {
      for (int k = 0; k < a.nk; ++k) step(k);
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

// ---------------------------------------------------------------------------
// f32: TMA + wgmma, 3xTF32
// ---------------------------------------------------------------------------

constexpr int F_NSUB = 2;                      // sub-strips per block, one per consumer warpgroup
constexpr int F_TXW = SUB * F_NSUB;            // queries per block and row
constexpr int F_SCOLS = F_TXW - SUB + NB;      // staged source columns x0-r .. x0-r+47
constexpr int F_CK = 32;                       // channels per chunk: one 128-byte swizzle row
constexpr int F_GROUP = 8;                     // chunks a group (256 channels)
constexpr int F_REG = 4;                       // chunks of a group held in registers
constexpr int F_RAW = F_SCOLS * ROWB;          // one source row's chunk, 6 KB
constexpr int F_A = QR * SUB * ROWB;           // one sub-strip's fm1 chunk, 8 KB
constexpr int F_STAGE = 2 * F_RAW;             // the raw chunk and its small parts, 12 KB
                                               // (or one sub-strip's fm1 chunk)
constexpr int F_NCONS = 128 * F_NSUB;
constexpr int F_NSPLIT = 2;                    // splitter warps
constexpr int F_NT = F_NCONS + 32 * (1 + F_NSPLIT);   // + a producer warp and the splitters
static_assert(F_A <= F_STAGE && F_STAGE % ALIGN == 0 && F_RAW % ALIGN == 0,
              "stages keep the 128-byte swizzle's 1 KB alignment");

struct F32Plan {
  int nk;        // channel chunks
  int group_nk;  // chunks a group (the kernel instance: 1, 2, 4 or 8)
  int nstage;    // ring stages
  int res_bytes, out_bytes, smem;   // res: the group's fm1 chunks past F_REG
};

F32Plan make_f32_plan(int C, int r) {
  F32Plan p;
  const int dd = (2 * r + 1) * (2 * r + 1);
  p.nk = (C + F_CK - 1) / F_CK;
  p.group_nk = p.nk >= F_GROUP ? F_GROUP : p.nk > 2 ? 4 : p.nk;
  p.res_bytes = (p.group_nk > F_REG ? p.group_nk - F_REG : 0) * F_NSUB * F_A;
  p.out_bytes = (QR * F_TXW * dd * 4 + 15) / 16 * 16;
  const int avail = SMEM_LIMIT - STATIC_RESERVE - ALIGN - p.res_bytes - p.out_bytes;
  p.nstage = avail / F_STAGE < MAX_STAGES ? avail / F_STAGE : MAX_STAGES;
  p.smem = ALIGN + p.nstage * F_STAGE + p.res_bytes + p.out_bytes;
  return p;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// x = big + small: big keeps x's top 11 significant bits (a TF32 value),
// small = x - big is exact in f32; the tensor core reads small's top 11
// bits, which drops at most 2^-20 |x|
__device__ __forceinline__ uint32_t tf32_big(uint32_t w) { return w & 0xffffe000u; }
__device__ __forceinline__ uint32_t tf32_small(uint32_t w) {
  return __float_as_uint(__uint_as_float(w) - __uint_as_float(tf32_big(w)));
}
// D[64 x 32] (+)= A[64 x 8] * B[32 x 8]^T in TF32, A from registers (the
// mma.sync m16n8k8 layout, one 16-row slice a warp), B K-major in shared
// memory; f32 accumulators, accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&fa)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WGMMA_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WGMMA_D16_ARGS(d)
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "l"(db), "r"(accumulate));
}

// NK: chunks a group; C > 32*NK runs in groups of NK chunks (NK = 8). Of a
// group, the first NKR = min(NK, F_REG) chunks are held in registers, the
// rest resident in shared memory
template <int NK>
__global__ void __launch_bounds__(F_NT, 1)
local_corr_f32_kernel(const __grid_constant__ CUtensorMap map1,
                      const __grid_constant__ CUtensorMap map2,
                      float* __restrict__ out, const Args a) {
  constexpr int NKR = NK < F_REG ? NK : F_REG, NKS = NK - NKR;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], ready[MAX_STAGES], empty[MAX_STAGES],
      res_full, res_empty;

  const int D = 2 * a.r + 1, DD = D * D;
  const int x0 = blockIdx.x * F_TXW, y0 = blockIdx.y * QR, b = blockIdx.z;
  const int nj = min(F_NSUB, (a.W - x0 + SUB - 1) / SUB);   // sub-strips inside the image
  const int s_lo = max(0, y0 - a.r), s_hi = min(a.H - 1, y0 + QR - 1 + a.r);
  const int ngroups = (a.nk + NK - 1) / NK;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring_s = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t res_s = ring_s + a.nstage * F_STAGE;   // [chunk - NKR][sub-strip]: 8 KB each
  float* so = reinterpret_cast<float*>(smem_raw + (res_s + NKS * F_NSUB * F_A - raw));

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nstage; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&ready[i]), F_NSPLIT);       // one arrival per splitter warp
      mbar_init(smem_u32(&empty[i]), F_NCONS / 32);   // one arrival per consumer warp
    }
    mbar_init(smem_u32(&res_full), 1);
    mbar_init(smem_u32(&res_empty), F_NCONS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role as a value ptxas can see is warp-uniform (see bf16)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp > F_NCONS / 32) {
    // ---- splitters: as each stage lands, the small parts of its 48 raw
    // columns (the same swizzled layout, F_RAW further on), for both
    // consumer warpgroups; then `ready`. fm1 stages pass through.
    const int lane = threadIdx.x & 31, sp = warp - F_NCONS / 32 - 1;
    int stage = 0, phase = 0;
    auto pass = [&](bool split) {
      mbar_wait(smem_u32(&full[stage]), phase);
      if (split) {
        const uint32_t st = ring_s + stage * F_STAGE;
        constexpr int PER = F_RAW / 16 / (32 * F_NSPLIT);   // 16-byte units a lane
        uint4 v[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i)
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v[i].x), "=r"(v[i].y), "=r"(v[i].z), "=r"(v[i].w)
                       : "r"(st + 16 * ((sp * PER + i) * 32 + lane)));
#pragma unroll
        for (int i = 0; i < PER; ++i)
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(st + F_RAW + 16 * ((sp * PER + i) * 32 + lane)),
                         "r"(tf32_small(v[i].x)), "r"(tf32_small(v[i].y)),
                         "r"(tf32_small(v[i].z)), "r"(tf32_small(v[i].w)) : "memory");
        fence_proxy_async();   // visible to the tensor cores' reads
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&ready[stage]));
      if (++stage == a.nstage) { stage = 0; phase ^= 1; }
    };
    for (int g = 0; g < ngroups; ++g) {
      const int nkg = min(NK, a.nk - g * NK);
      for (int i = 0; i < min(nkg, NKR) * F_NSUB; ++i) pass(false);
      for (int i = 0; i < (s_hi - s_lo + 1) * nkg; ++i) pass(true);
    }
    return;
  }
  if (role == F_NSUB) {
    // ---- producer: one thread issues every TMA load, in the order the
    // consumers take the stages ----
    if (threadIdx.x == F_NCONS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map1)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map2)) : "memory");
      int stage = 0, phase = 0;
      for (int g = 0; g < ngroups; ++g) {
        const int nkg = min(NK, a.nk - g * NK);
        if (nkg > NKR) {   // the resident chunks, once the last group's products are done
          if (g > 0) mbar_wait(smem_u32(&res_empty), (g - 1) & 1);
          const uint32_t bar = smem_u32(&res_full);
          mbar_expect_tx(bar, (nkg - NKR) * nj * F_A);
          for (int k = NKR; k < nkg; ++k)
            for (int jj = 0; jj < nj; ++jj)
              tma_load(res_s + ((k - NKR) * F_NSUB + jj) * F_A, &map1, (g * NK + k) * F_CK,
                       x0 + SUB * jj, y0, b, bar);
        }
        for (int k = 0; k < min(nkg, NKR); ++k)
          for (int jj = 0; jj < F_NSUB; ++jj) {   // fm1 for registers: one sub-strip's chunk a stage
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t bar = smem_u32(&full[stage]);
            if (jj < nj) {
              mbar_expect_tx(bar, F_A);
              tma_load(ring_s + stage * F_STAGE, &map1, (g * NK + k) * F_CK, x0 + SUB * jj, y0,
                       b, bar);
            } else {
              mbar_arrive(bar);   // past the image: nothing to load
            }
            if (++stage == a.nstage) { stage = 0; phase ^= 1; }
          }
        for (int s = s_lo; s <= s_hi; ++s)   // rows outside the image: nothing to load
          for (int k = 0; k < nkg; ++k) {
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t bar = smem_u32(&full[stage]);
            mbar_expect_tx(bar, F_RAW);
            tma_load(ring_s + stage * F_STAGE, &map2, (g * NK + k) * F_CK, x0 - a.r, s, b, bar);
            if (++stage == a.nstage) { stage = 0; phase ^= 1; }
          }
      }
    }
    return;
  }

  // ---- consumer warpgroup `role` computes sub-strip j = role; its warp w
  // the query row y0 + w. Every wgmma is issued on a path all 128 threads of
  // the warpgroup take: a sub-strip past the image edge, or channels past
  // C, are computed on stale data or zeros and dropped.
  const int j = role, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // A fragments, raw f32: chunk k, k step kk holds rows 16w + gq (+8) x
  // channels 8kk + tq (+4) of the sub-strip's A, as wgmma reads A; the
  // swizzled 128-byte row of an fm1 pixel puts them in 16-byte chunks 2kk
  // (+1), XORed with the row (gq)
  auto load_a = [&](uint32_t (&f)[4], uint32_t row, int kk) {
    f[0] = lds32(row + (((2 * kk) ^ gq) << 4));
    f[1] = lds32(row + 8 * ROWB + (((2 * kk) ^ gq) << 4));
    f[2] = lds32(row + (((2 * kk + 1) ^ gq) << 4));
    f[3] = lds32(row + 8 * ROWB + (((2 * kk + 1) ^ gq) << 4));
  };
  const uint32_t a_row = (16 * w + gq) * ROWB + 4 * tq;
  uint32_t fa[NKR * 4][4];
  float acc[16] = {};
  // the band of source row s for query row y0 + w (mode 0: zeros, 1: set,
  // 2: add to the tile); accumulator element i is (query m, column n) with
  // m = lane/4 + 8*((i>>1)&1), n = 8*(i>>2) + 2*(lane%4) + (i&1), dx = n - m
  auto band = [&](int s, int mode) {
    const int dy = s - (y0 + w) + a.r;
    if (dy < 0 || dy >= D || j >= nj) return;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = gq + 8 * ((i >> 1) & 1);
      const int dx = 8 * (i >> 2) + 2 * tq + (i & 1) - m;
      if (dx >= 0 && dx < D) {
        float* o = so + (w * F_TXW + SUB * j + m) * DD + dx * D + dy;
        const float v = acc[i] * a.scale;
        *o = mode == 0 ? 0.f : mode == 1 ? v : *o + v;
      }
    }
  };
  for (int s = y0 - a.r; s < y0 + QR + a.r; ++s)
    if (s < s_lo || s > s_hi) band(s, 0);   // zero outside the image

  int stage = 0, phase = 0;
  auto advance = [&]() {
    if (++stage == a.nstage) { stage = 0; phase ^= 1; }
  };
  // the warpgroup's 32 columns start at column 16j of the raw chunk and of
  // its small parts (1 KB-aligned, so the 128-byte swizzle holds)
  const uint32_t col_off = j * SUB * ROWB;
  for (int g = 0; g < ngroups; ++g) {
    const int nkg = min(NK, a.nk - g * NK);
    // the register chunks of the group, one sub-strip's chunk a stage
#pragma unroll
    for (int k = 0; k < NKR; ++k) {
      if (k >= nkg) break;
#pragma unroll
      for (int jj = 0; jj < F_NSUB; ++jj) {
        mbar_wait(smem_u32(&ready[stage]), phase);
        if (jj == j) {
#pragma unroll
          for (int kk = 0; kk < F_CK / 8; ++kk)
            load_a(fa[k * 4 + kk], ring_s + stage * F_STAGE + a_row, kk);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
        advance();
      }
    }
    if (nkg > NKR) mbar_wait(smem_u32(&res_full), g & 1);   // the resident chunks

    int prev = -1;
    // the products of chunk k of one source row, fm1 from registers
    // (`regs` true: k < NKR, a static index) or from the resident chunks
    auto chunk = [&](int k, auto regs) {
      mbar_wait(smem_u32(&ready[stage]), phase);   // landed, small parts written
      const uint32_t st = ring_s + stage * F_STAGE;
#pragma unroll
      for (int kk = 0; kk < F_CK / 8; ++kk) {
        // the small parts are double-buffered: those of the k step before
        // last are rewritten only after its products have retired
        wgmma_wait<1>();
        if (kk == 1) {   // every product of the previous stage has retired
          if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
          prev = -1;
        }
        // A's big part is the raw fragment (the tensor core ignores a TF32
        // operand's low 13 bits), its small part split here. A resident
        // chunk's fragment is read here too: registers that in-flight
        // products read are rewritten only after a wait retires them
        uint32_t fk[4];
        if constexpr (decltype(regs)::value) {
#pragma unroll
          for (int e = 0; e < 4; ++e) fk[e] = fa[k * 4 + kk][e];
        } else {
          load_a(fk, res_s + ((k - NKR) * F_NSUB + j) * F_A + a_row, kk);
        }
        uint32_t small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) small[e] = tf32_small(fk[e]);
        wgmma_fence();
        const uint64_t db_big = wgmma_desc(st + col_off + kk * 32);
        const uint64_t db_small = wgmma_desc(st + F_RAW + col_off + kk * 32);
        wgmma_tf32(acc, small, db_big, (k | kk) != 0);
        wgmma_tf32(acc, fk, db_small, 1);
        wgmma_tf32(acc, fk, db_big, 1);
        wgmma_commit();
      }
      prev = stage;
      advance();
    };
    for (int s = s_lo; s <= s_hi; ++s) {
      // unrolled over the register chunks only: ptxas serializes every
      // wgmma of a source row unrolled to 96 (C7512) but pipelines 48, and
      // a loop of resident chunks
#pragma unroll
      for (int k = 0; k < NKR; ++k) {
        if (k >= nkg) break;
        chunk(k, std::true_type());
      }
#pragma unroll 1
      for (int k = NKR; k < nkg; ++k) chunk(k, std::false_type());
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = -1;
      band(s, g == 0 ? 1 : 2);
    }
    __syncwarp();
    if (nkg > NKR && lane == 0) mbar_arrive(smem_u32(&res_empty));   // resident chunks free
  }

  // every consumer warp's band is in the tile: store each query row's run
  asm volatile("bar.sync 3, %0;\n" ::"n"(F_NCONS) : "memory");
  const int nq = min(F_TXW, a.W - x0);
  for (int q = 0; q < QR; ++q) {
    const int y = y0 + q;
    if (y >= a.H) break;
    float* dst = out + ((static_cast<size_t>(b) * a.H + y) * a.W + x0) * DD;
    const float* src = so + q * F_TXW * DD;
    const int n = nq * DD;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {   // W % 4 == 0: 16-byte runs
      const int nv = n / 4;
      for (int e = threadIdx.x; e < nv; e += F_NCONS)
        reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
      done = nv * 4;
    }
    for (int e = done + threadIdx.x; e < n; e += F_NCONS) dst[e] = src[e];
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

// the NHWC tensor as a 4-d map (C, W, H, B), boxes of bc channels (128
// bytes) x bw columns x bh rows of one image, 128-byte swizzle, zeros out of
// bounds
bool encode_map(CUtensorMap* map, const void* ptr, bool f32, int B, int H, int W, int C,
                int bc, int bw, int bh) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t pix = static_cast<cuuint64_t>(C) * (f32 ? 4 : 2);
  const cuuint64_t strides[3] = {pix, pix * W, pix * W * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bc), static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*TcKernel)(CUtensorMap, CUtensorMap, __nv_bfloat16*, Args);

// the kernel instance for a plan, its dynamic shared memory allowed
template <int REG_NK>
cudaError_t tc_kernel(const Plan& p, TcKernel* fn) {
  static int allowed[MAX_DEVICES] = {};
  *fn = local_corr_tc_kernel<REG_NK>;
  return allow_smem(reinterpret_cast<const void*>(*fn), p.smem, allowed);
}

cudaError_t select_kernel(const Plan& p, TcKernel* fn) {
  if (p.nstage < 2) return cudaErrorInvalidValue;
  switch (p.reg_nk) {
    case 1: return tc_kernel<1>(p, fn);
    case 2: return tc_kernel<2>(p, fn);
    case 3: return tc_kernel<3>(p, fn);
    case 4: return tc_kernel<4>(p, fn);
    default: return tc_kernel<0>(p, fn);
  }
}

cudaError_t launch_tc(const void* fm1, const void* fm2, void* out, int B, int H, int W,
                      int C, int r, float scale, cudaStream_t stream) {
  const Plan p = make_plan(C, r);
  TcKernel fn;
  cudaError_t e = select_kernel(p, &fn);
  if (e != cudaSuccess) return e;
  CUtensorMap map1, map2;
  if (!encode_map(&map1, fm1, false, B, H, W, C, CK, SUB, QR) ||
      !encode_map(&map2, fm2, false, B, H, W, C, CK, SCOLS, 1))
    return cudaErrorInvalidValue;
  const Args a{H, W, C, r, p.nk, p.nstage, scale};
  const dim3 grid((W + TXW - 1) / TXW, (H + QR - 1) / QR, B);
  fn<<<grid, NTC, p.smem, stream>>>(map1, map2, static_cast<__nv_bfloat16*>(out), a);
  return cudaGetLastError();
}

typedef void (*F32Kernel)(CUtensorMap, CUtensorMap, float*, Args);

template <int NK>
cudaError_t f32_kernel(const F32Plan& p, F32Kernel* fn) {
  static int allowed[MAX_DEVICES] = {};
  *fn = local_corr_f32_kernel<NK>;
  return allow_smem(reinterpret_cast<const void*>(*fn), p.smem, allowed);
}

cudaError_t select_f32_kernel(const F32Plan& p, F32Kernel* fn) {
  if (p.nstage < 2) return cudaErrorInvalidValue;
  switch (p.group_nk) {
    case 1: return f32_kernel<1>(p, fn);
    case 2: return f32_kernel<2>(p, fn);
    case 4: return f32_kernel<4>(p, fn);
    default: return f32_kernel<8>(p, fn);
  }
}

cudaError_t launch_f32(const void* fm1, const void* fm2, void* out, int B, int H, int W,
                       int C, int r, float scale, cudaStream_t stream) {
  const F32Plan p = make_f32_plan(C, r);
  F32Kernel fn;
  cudaError_t e = select_f32_kernel(p, &fn);
  if (e != cudaSuccess) return e;
  CUtensorMap map1, map2;
  if (!encode_map(&map1, fm1, true, B, H, W, C, F_CK, SUB, QR) ||
      !encode_map(&map2, fm2, true, B, H, W, C, F_CK, F_SCOLS, 1))
    return cudaErrorInvalidValue;
  const Args a{H, W, C, r, p.nk, p.nstage, scale};
  const dim3 grid((W + F_TXW - 1) / F_TXW, (H + QR - 1) / QR, B);
  fn<<<grid, F_NT, p.smem, stream>>>(map1, map2, static_cast<float*>(out), a);
  return cudaGetLastError();
}

bool valid_inputs(const void* fm1, const void* fm2, int B, int H, int W, int C, int r) {
  // TMA boxes: 16-byte aligned inputs and pixel strides, C a multiple of 16
  return C > 0 && C % 16 == 0 && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 * QR &&
         W >= 1 && r >= 1 && r <= 5 && reinterpret_cast<uintptr_t>(fm1) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(fm2) % 16 == 0;
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int local_corr_f32(const void* fm1, const void* fm2, void* out,
                              int B, int H, int W, int C, int r, float scale,
                              void* stream) {
  if (!valid_inputs(fm1, fm2, B, H, W, C, r)) return cudaErrorInvalidValue;
  return launch_f32(fm1, fm2, out, B, H, W, C, r, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int local_corr_bf16(const void* fm1, const void* fm2, void* out,
                               int B, int H, int W, int C, int r, float scale,
                               void* stream) {
  if (!valid_inputs(fm1, fm2, B, H, W, C, r)) return cudaErrorInvalidValue;
  return launch_tc(fm1, fm2, out, B, H, W, C, r, scale, static_cast<cudaStream_t>(stream));
}

// The bf16 design's shared memory a block (bytes), ring stages and blocks an
// SM at (C, r); returns a cudaError_t.
extern "C" int local_corr_bf16_plan(int C, int r, int* smem, int* stages,
                                    int* blocks_per_sm) {
  const Plan p = make_plan(C, r);
  *smem = p.smem;
  *stages = p.nstage;
  TcKernel fn;
  const cudaError_t e = select_kernel(p, &fn);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, NTC, p.smem);
}

// The f32 design's launch plan at (C, r): shared memory a block (bytes),
// resident blocks an SM (the CUDA occupancy calculator), registers a thread
// and local memory a thread (bytes; above 0 means ptxas spilled); returns a
// cudaError_t.
extern "C" int local_corr_f32_plan(int C, int r, int* smem, int* blocks_per_sm, int* regs,
                                   int* local_bytes) {
  const F32Plan p = make_f32_plan(C, r);
  F32Kernel fn;
  cudaError_t e = select_f32_kernel(p, &fn);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  *smem = p.smem;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, F_NT, p.smem);
}

extern "C" const char* local_corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
