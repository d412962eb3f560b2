// The dense multivariate-Normal quadratic form of the flat-buffer log-joint.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/fused_logpdf/kernel.py:
//   mvn_quadform_sum <- _mvn_quad_kernel (:220) / mvn_quad_sum_2d (:319)
//
// What it computes, for every row b (an HMC chain) of centred rows
// xc (B, N, D) and a precision P (B, D, D):
//   out[b] = -1/2 sum_n xc[b, n]^T P[b] xc[b, n]
//          = -1/2 sum_{n, j} (xc[b] P[b])[n, j] * xc[b, n, j].
// Either input may have batch stride 0: one P shared by the chains (a
// constant Cholesky factor, the `mixed` model's) or one per chain (a factor
// that depends on a parameter), and shared data rows.
//
// What bounds it on an H100: float operations once D is more than a few
// dozen. The product is 2 N D^2 flops per row against 4 (N D + D^2) bytes
// read: at 4 x 4,096 x 256 that is 2.1 GFLOP, 32 us at the 67 TFLOP/s of
// float32 on the CUDA cores, against 5 us of reading. The TPU kernel feeds
// its MXU; this one stays on the CUDA cores in full float32 FMAs (no TF32,
// no tensor cores) so that it holds rtol 1e-5 against the plain version. A
// tensor-core design (3xTF32 or similar) is later work. At the `mixed`
// model's 4 x 1 x 5 the time is launch latency.
//
// Design. The TPU kernel keeps a block of xc rows in VMEM and streams
// column blocks of P through the MXU, carrying one accumulator over a
// sequential grid. Here a block owns a 64 x 64 output tile (64 rows of one
// chain's xc against 64 columns of P): 256 threads, each 4 x 4 outputs,
// walk the shared dimension in steps of 16, with the xc tile (transposed)
// and the P tile staged in shared memory; each thread reads 4 consecutive
// values of each as one 16-byte load and does 16 FMAs. At the end each
// thread multiplies its 4 x 4 outputs by the matching xc entries on the
// fly (the product xc P never goes to memory), the block reduces the
// tile's sum in a fixed order into partials[b, tile], and a second launch
// sums each row's partials in a fixed order. No float atomics: reruns are
// bit-identical. The ragged edges (N and D not multiples of 64 or 16) are
// masked as zeros when the tiles are staged, the TPU kernel's zero padding.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // rows of xc and columns of P per block
constexpr int kDepth = 16;    // the shared dimension per step
constexpr int kPad = 4;       // keeps the float4 rows of xs 16-byte aligned

// Sum over the block; the result is valid in thread 0. Fixed order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kThreads / 32) ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid (row tiles * column tiles, B); partials[b, tile]
__global__ void __launch_bounds__(kThreads)
mvn_quad_partials(const float* __restrict__ xc, long long x_batch_stride,
                  const float* __restrict__ prec, long long p_batch_stride,
                  int n, int d, int col_tiles, float* __restrict__ partials) {
  __shared__ __align__(16) float xs[kDepth][kTile + kPad];  // xs[k][r] = xc[r0 + r, k0 + k]
  __shared__ __align__(16) float ps[kDepth][kTile];         // ps[k][j] = P[k0 + k, j0 + j]
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = (tile / col_tiles) * kTile;
  const int j0 = (tile % col_tiles) * kTile;
  const float* x = xc + static_cast<long long>(b) * x_batch_stride;
  const float* p = prec + static_cast<long long>(b) * p_batch_stride;
  const int tx = threadIdx.x & 15;  // output columns j0 + 4 tx .. + 3
  const int ty = threadIdx.x >> 4;  // output rows r0 + 4 ty .. + 3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    // stage 64 x 16 of xc (16 consecutive floats of a row per 16 threads)
    // and 16 x 64 of P (64 consecutive floats of a row per 64 threads)
#pragma unroll
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth, k = e % kDepth;
      const int gr = r0 + r, gk = k0 + k;
      xs[k][r] = (gr < n && gk < d) ? x[static_cast<long long>(gr) * d + gk] : 0.0f;
      const int kk = e / kTile, j = e % kTile;
      const int pk = k0 + kk, pj = j0 + j;
      ps[kk][j] = (pk < d && pj < d) ? p[static_cast<long long>(pk) * d + pj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&ps[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // (xc P)[r, c] * xc[r, c] on the fly, in a fixed order
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + 4 * tx + j;
      if (c < d) sum = fmaf(acc[i][j], x[static_cast<long long>(r) * d + c], sum);
    }
  }
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(b) * gridDim.x + tile] = sum;
  }
}

// out[b] = -1/2 * (sum of row b's partials, in a fixed order)
__global__ void __launch_bounds__(kThreads)
finish_rows_half(const float* __restrict__ partials, int nparts,
                 float* __restrict__ out) {
  const float* row = partials + static_cast<long long>(blockIdx.x) * nparts;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += row[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = -0.5f * acc;
}

}  // namespace

// C interface, loaded with ctypes; returns a cudaError_t (0 = success).
// xc (rows, n, d) with rows of d floats, batch stride n*d or 0; prec
// (rows, d, d) row-major, batch stride d*d or 0. `partials` holds
// rows * tiles floats, tiles = ceil(n / 64) * ceil(d / 64), and `out` rows
// floats, both allocated by the caller. Launches go on the caller's stream
// and do not synchronise.
extern "C" int repro_mvn_quadform_sum(const float* xc, long long x_batch_stride,
                                      const float* prec, long long p_batch_stride,
                                      int rows, int n, int d, float* partials,
                                      int tiles, float* out, void* stream) {
  const int col_tiles = (d + kTile - 1) / kTile;
  const long long want = static_cast<long long>((n + kTile - 1) / kTile) * col_tiles;
  if (rows <= 0 || rows > 65535 || n <= 0 || d <= 0 || tiles != want) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mvn_quad_partials<<<dim3(tiles, rows), kThreads, 0, s>>>(
      xc, x_batch_stride, prec, p_batch_stride, n, d, col_tiles, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_rows_half<<<rows, kThreads, 0, s>>>(partials, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_mvn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
