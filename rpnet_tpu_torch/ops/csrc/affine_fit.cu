// The affine registration fit, hand-written for Hopper (sm_90a): every Adam
// step of rpnet_tpu_torch/registration/affine.py::fit_affine in one launch.
// Plain C entry points, built by rpnet_tpu_torch/ops/kernels.py with nvcc and
// loaded with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves the fit to XLA
// (rpnet_tpu/registration/affine.py::fit_affine, a lax.scan over
// value_and_grad of the warp and the MSE, sampled by the one-hot `matmul`
// sampler). Its plain version, registration/affine.py::fit_affine_plain, is
// the fit as autograd runs it over F.affine_grid and F.grid_sample: ~30
// launches a step on the card, theta's gradient a (2 x 3) output over
// K = H*W a slice that cuBLAS runs as an FFMA GEMM with a 32 x 32 tile.
//
// This kernel gives that fit's theta bit for bit on the card, for two slices
// or more (a batch of one goes to another cuBLAS GEMM, which reduces theta's
// gradient in another order; there the two part by rounding). For slice s
// and pixel p = i*W + j, with (xn, yn) = base_x[j], base_y[i] (the wrapper
// takes them from F.affine_grid's grid of the identity) and N = H*W, each
// step repeats, in their roundings, the operations the card runs:
//
//   affine_grid (its bmm over K = 3):   gx = fma(yn, t01, xn*t00) + t02
//   grid_sample, forward:               ix = fma(gx + 1, W, -1) / 2,
//       x0 = floor(ix), wx0 = (x0 + 1) - ix, wx1 = ix - x0 (and in y),
//       w  = fma over the taps inside the image, nw ne sw se, of
//            value * (wx * wy), from 0
//   the MSE's gradient in w:            gout = -((1/N) * (2 * (f - w)))
//   grid_sample, grid gradient:         gix = fma over the taps inside of
//       -+ (value * wy) * gout, from 0 (nw -, ne +, sw -, se +), giy likewise
//       with wx (nw -, ne -, sw +, se +); gGx = (W/2) * gix, gGy = (H/2) * giy
//   affine_grid's backward (its bmm over K = H*W): theta's gradient
//       g[r][k] = one FMA chain over the pixels in order, from 0, of
//       b_k[p] * gG_r[p], b = (xn, yn, 1)
//
// then adam_update as torch runs it on the card (a tensor divided by a
// Python number is multiplied by the number's reciprocal, rounded to f32).
// The losses are the mean of r^2, summed in f64 over exact products (not
// autograd's order, which the trajectory does not read). The fit's trajectory parts at the
// slightest difference where a sample coordinate crosses an integer (ROADMAP
// queue 3 item 3), so giving the plain version's theta exactly is what keeps
// the program on the trajectory the autograd fit took.
//
// Bound: f32 operations on paper (77 a pixel-step, an FMA as two, the six
// chains' included; ~15 GFLOP an eval episode of ~59 slices x 50 steps x
// 65,536 pixels, ~0.22 ms at the 67 TFLOP/s of the FP32 units; the two
// images, ~30 MB an episode, stay in the 50 MB L2). In fact the latency of
// the FMA chain: H*W dependent FMAs a step and slice, ~65,536 x 4 cycles at
// 256 x 256, ~0.13 ms a step, ~7 ms a fit.
// The design keeps every intermediate on the chip and the fit in one launch:
//
// * One block of 512 threads a slice for the whole fit (clusters never help:
//   the chain is one slice's and sequential); S slices run side by side.
// * Each step walks the slice in chunks of CHUNK pixels. Warps 1.. make a
//   chunk's chain operands (gGx, gGy and the base coordinates) into shared
//   memory, the grid point, taps and residual made on the fly from theta and
//   the base tables, while warp 0 runs the six chains (lanes 0..5, g[r][k];
//   the third column's base from a table of ones) over the chunk before,
//   double-buffered, one barrier a chunk; its 16-byte operand loads run 64
//   pixels ahead of the chain (1.5x faster than 16 at 256 x 256). No grid,
//   warped image or residual is written to device memory.
// * Lanes 0..5 of warp 0 own theta's entries with their mu and nu and apply
//   Adam; the loss is a fixed-order f64 reduction. No atomics: the same
//   inputs give the same theta, run after run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PRODUCERS = THREADS - 32;   // warps 1..: the grid gradients
constexpr int CHUNK = 1024;               // pixels a chunk, double-buffered: 32 KB
// the limits, which ops/kernels.py repeats (AFFINE_FIT_MAX_SIDE, _SLICES)
constexpr int MAX_SIDE = 1024;            // the base tables in shared memory: 8 KB
constexpr int MAX_SLICES = 65535;

// torch.optim.Adam's defaults, as registration/affine.py rounds them
constexpr float ADAM_C1 = static_cast<float>(1.0 - 0.9);
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_C2 = static_cast<float>(1.0 - 0.999);
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;

__global__ void __launch_bounds__(THREADS, 1)
affine_fit_kernel(const float* __restrict__ moving, const float* __restrict__ fixed,
                  const float* __restrict__ base_x, const float* __restrict__ base_y,
                  float* __restrict__ theta_out, float* __restrict__ losses, int S,
                  int H, int W, int iters, float lr, float inv_n) {
  extern __shared__ float tables[];                 // base_x (W), then base_y (H)
  // [buffer][gGx, gGy, xn, yn][pixel of the chunk]: the chains' operands
  __shared__ __align__(16) float operands[2][4][CHUNK];
  __shared__ __align__(16) float ones[CHUNK];       // the third chain's base, b = 1
  __shared__ double warp_loss[WARPS];
  __shared__ float theta[6];

  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* xs = tables;
  float* ys = tables + W;
  for (int k = tid; k < W; k += THREADS) xs[k] = base_x[k];
  for (int k = tid; k < H; k += THREADS) ys[k] = base_y[k];
  for (int k = tid; k < CHUNK; k += THREADS) ones[k] = 1.f;
  // lane k < 6 of warp 0 owns theta entry k (row-major 2 x 3), from the identity
  float param = (tid == 0 || tid == 4) ? 1.f : 0.f, mu = 0.f, nu = 0.f;
  if (tid < 6) theta[tid] = param;
  __syncthreads();

  const int HW = H * W;
  const int chunks = (HW + CHUNK - 1) / CHUNK;
  const float* mv = moving + static_cast<size_t>(s) * HW;
  const float* fx = fixed + static_cast<size_t>(s) * HW;
  const float Wf = static_cast<float>(W), Hf = static_cast<float>(H);
  const float half_w = Wf / 2.f, half_h = Hf / 2.f;
  const unsigned uW = static_cast<unsigned>(W), uH = static_cast<unsigned>(H);
  const int row = lane / 3, col = lane % 3;          // a chain lane's g[row][col]

  for (int t = 1; t <= iters; ++t) {
    const float t00 = theta[0], t01 = theta[1], t02 = theta[2];
    const float t10 = theta[3], t11 = theta[4], t12 = theta[5];
    double loss = 0.0;
    float chain = 0.f;
    for (int c = 0; c <= chunks; ++c) {
      if (warp > 0 && c < chunks) {   // make chunk c
        float* ops = operands[c & 1][0];
        const int p0 = c * CHUNK, n = min(CHUNK, HW - p0);
        for (int q = tid - 32; q < n; q += PRODUCERS) {
          const int p = p0 + q, i = p / W, j = p - i * W;
          const float xn = xs[j], yn = ys[i];
          const float gx = __fadd_rn(__fmaf_rn(yn, t01, __fmul_rn(xn, t00)), t02);
          const float gy = __fadd_rn(__fmaf_rn(yn, t11, __fmul_rn(xn, t10)), t12);
          const float ix = __fmul_rn(__fmaf_rn(__fadd_rn(gx, 1.f), Wf, -1.f), 0.5f);
          const float iy = __fmul_rn(__fmaf_rn(__fadd_rn(gy, 1.f), Hf, -1.f), 0.5f);
          const float fx0 = floorf(ix), fy0 = floorf(iy);
          const float wx0 = __fsub_rn(__fadd_rn(fx0, 1.f), ix), wx1 = __fsub_rn(ix, fx0);
          const float wy0 = __fsub_rn(__fadd_rn(fy0, 1.f), iy), wy1 = __fsub_rn(iy, fy0);
          // the taps: floor saturates, and the unsigned compares reject what
          // lies outside; the index wraps mod 2^32, right wherever a tap is read
          const unsigned ux = static_cast<unsigned>(__float2int_rd(ix));
          const unsigned uy = static_cast<unsigned>(__float2int_rd(iy));
          const bool in00 = uy < uH && ux < uW, in01 = uy < uH && ux + 1u < uW;
          const bool in10 = uy + 1u < uH && ux < uW, in11 = uy + 1u < uH && ux + 1u < uW;
          const unsigned idx = uy * uW + ux;
          const float v00 = in00 ? __ldg(mv + idx) : 0.f;
          const float v01 = in01 ? __ldg(mv + (idx + 1u)) : 0.f;
          const float v10 = in10 ? __ldg(mv + (idx + uW)) : 0.f;
          const float v11 = in11 ? __ldg(mv + (idx + uW + 1u)) : 0.f;
          float w = 0.f;
          if (in00) w = __fmaf_rn(v00, __fmul_rn(wx0, wy0), w);
          if (in01) w = __fmaf_rn(v01, __fmul_rn(wx1, wy0), w);
          if (in10) w = __fmaf_rn(v10, __fmul_rn(wx0, wy1), w);
          if (in11) w = __fmaf_rn(v11, __fmul_rn(wx1, wy1), w);
          const float d = __fsub_rn(__ldg(fx + p), w);                  // fixed - warp
          const float gout = -__fmul_rn(inv_n, __fmul_rn(2.f, d));
          float gix = 0.f, giy = 0.f;
          if (in00) {
            gix = __fmaf_rn(-__fmul_rn(v00, wy0), gout, gix);
            giy = __fmaf_rn(-__fmul_rn(v00, wx0), gout, giy);
          }
          if (in01) {
            gix = __fmaf_rn(__fmul_rn(v01, wy0), gout, gix);
            giy = __fmaf_rn(-__fmul_rn(v01, wx1), gout, giy);
          }
          if (in10) {
            gix = __fmaf_rn(-__fmul_rn(v10, wy1), gout, gix);
            giy = __fmaf_rn(__fmul_rn(v10, wx0), gout, giy);
          }
          if (in11) {
            gix = __fmaf_rn(__fmul_rn(v11, wy1), gout, gix);
            giy = __fmaf_rn(__fmul_rn(v11, wx1), gout, giy);
          }
          ops[q] = __fmul_rn(half_w, gix);
          ops[CHUNK + q] = __fmul_rn(half_h, giy);
          ops[2 * CHUNK + q] = xn;
          ops[3 * CHUNK + q] = yn;
          const double dd = d;
          loss += dd * dd;                                              // exact product
        }
      }
      if (warp == 0 && c > 0 && lane < 6) {   // the chains over chunk c - 1
        const float* gg = operands[(c - 1) & 1][row];
        const float* bb = col == 2 ? ones : operands[(c - 1) & 1][2 + col];
        const int n = min(CHUNK, HW - (c - 1) * CHUNK);
        int q = 0;
#pragma unroll 16
        for (; q + 4 <= n; q += 4) {   // 16-byte loads, issued ahead of the chain
          const float4 g4 = *reinterpret_cast<const float4*>(gg + q);
          const float4 b4 = *reinterpret_cast<const float4*>(bb + q);
          chain = __fmaf_rn(b4.x, g4.x, chain);
          chain = __fmaf_rn(b4.y, g4.y, chain);
          chain = __fmaf_rn(b4.z, g4.z, chain);
          chain = __fmaf_rn(b4.w, g4.w, chain);
        }
        for (; q < n; ++q) chain = __fmaf_rn(bb[q], gg[q], chain);
      }
      __syncthreads();   // chunk c made, chunk c - 1 consumed
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) loss += __shfl_down_sync(0xffffffffu, loss, off);
    if (lane == 0) warp_loss[warp] = loss;
    __syncthreads();
    if (tid < 6) {
      const float g = chain;
      mu = __fadd_rn(__fmul_rn(ADAM_C1, g), __fmul_rn(ADAM_B1, mu));
      nu = __fadd_rn(__fmul_rn(__fmul_rn(ADAM_C2, g), g), __fmul_rn(ADAM_B2, nu));
      // mu / (1 - b1^t) as torch divides by a Python number on the card: times
      // the reciprocal, taken in f64 and rounded to f32
      const double td = static_cast<double>(t);
      const float mu_hat = __fmul_rn(mu, static_cast<float>(1.0 / (1.0 - pow(0.9, td))));
      const float nu_hat = __fmul_rn(nu, static_cast<float>(1.0 / (1.0 - pow(0.999, td))));
      const float step = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), ADAM_EPS));
      param = __fsub_rn(param, __fmul_rn(lr, step));
      theta[tid] = param;
    } else if (tid == 6) {
      double total = 0.0;
      for (int k = 0; k < WARPS; ++k) total += warp_loss[k];
      losses[static_cast<size_t>(t - 1) * S + s] = __fmul_rn(__double2float_rn(total), inv_n);
    }
    __syncthreads();   // the new theta, before the next step reads it
  }
  if (tid < 6) theta_out[static_cast<size_t>(s) * 6 + tid] = param;
}

}  // namespace

// The whole fit: moving, fixed (S, H, W) f32; base_x (W), base_y (H);
// theta_out (S, 2, 3); losses (iters, S), step t's loss at theta before its
// update; inv_n = f32(1 / f32(H*W)). Returns a cudaError_t.
extern "C" int affine_fit_f32(const void* moving, const void* fixed, const void* base_x,
                              const void* base_y, void* theta_out, void* losses, int S,
                              int H, int W, int iters, float lr, float inv_n,
                              void* stream) {
  if (S < 1 || S > MAX_SLICES || H < 1 || W < 1 || H > MAX_SIDE || W > MAX_SIDE || iters < 0)
    return cudaErrorInvalidValue;
  affine_fit_kernel<<<S, THREADS, static_cast<size_t>(H + W) * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(moving), static_cast<const float*>(fixed),
      static_cast<const float*>(base_x), static_cast<const float*>(base_y),
      static_cast<float*>(theta_out), static_cast<float*>(losses), S, H, W, iters, lr, inv_n);
  return cudaGetLastError();
}

// The launch plan at H x W: threads a block (one block a slice), pixels a
// chunk, resident blocks an SM (the CUDA occupancy calculator), registers a
// thread and local memory a thread (bytes; above 0 means ptxas spilled).
extern "C" int affine_fit_plan(int H, int W, int* threads, int* chunk, int* blocks_per_sm,
                               int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, affine_fit_kernel);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, affine_fit_kernel, THREADS, static_cast<size_t>(H + W) * sizeof(float));
  if (e != cudaSuccess) return e;
  *threads = THREADS;
  *chunk = CHUNK;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

extern "C" const char* affine_fit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
