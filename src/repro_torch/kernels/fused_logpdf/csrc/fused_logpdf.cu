// Row-wise fused log-density reductions for the flat-buffer log-joint.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/fused_logpdf/kernel.py:
//   std_normal_sum       <- _std_normal_kernel (:54) / std_normal_sum_2d (:266)
//   bernoulli_logit_sum  <- _bernoulli_logit_kernel (:97) / bernoulli_logit_sum_2d (:283)
//
// What each computes, for every row b of a (B, n) float32 input:
//   std_normal_sum:      out[b] = sum_i (-z_i^2 / 2 - log(2 pi) / 2)
//   bernoulli_logit_sum: out[b] = sum_i (-softplus(-l_i) - (1 - y_i) l_i)
// The B rows are HMC chains: torch.func.vmap over the chain axis hands the
// whole batch to one launch. Each input carries its own row stride; a
// stride of 0 reads one shared row for every b (logreg's observed y), so
// unbatched data is never copied per chain.
//
// What bounds them on an H100: bytes. Each element is read once and costs
// a handful of flops (bernoulli adds one expf and one log1pf), far below
// the ~20 flops per byte where float32 arithmetic would be the limit. At
// the main path's shapes (4 x 101, 4 x 10,000, 4 x 40,000) the data is
// tens to hundreds of KB, so the time is launch latency, not bandwidth.
//
// Design. The TPU kernel walks an (R, 128) tiling of the input in a
// sequential grid and carries a VMEM accumulator from step to step. Hopper
// runs blocks in parallel in no order, so nothing carries over between
// blocks. Instead there is a deterministic two-stage reduction:
//   stage 1: grid (nparts, B). Block (p, b) strides over row b with a
//            grid-stride loop, masks the ragged end by index (no padding
//            to tiles), and reduces its 256 thread sums with warp shuffles
//            and one shared-memory step into partials[b, p].
//   stage 2: grid (B). One block per row sums its nparts partials in a
//            fixed order into out[b].
// There are no float atomics, and every thread's share of the work is a
// function of (n, nparts) alone, so two runs give bit-identical sums.
// Loads are scalar and coalesced; 16-byte vector loads would need
// row starts aligned to 4 floats, which a stride of n does not give.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kHalfLog2Pi = 0.91893853320467274178f;

__device__ __forceinline__ float std_normal_term(float z) {
  return -0.5f * z * z - kHalfLog2Pi;
}

// y log sigmoid(l) + (1 - y) log sigmoid(-l) = -softplus(-l) - (1 - y) l,
// with softplus(-l) = max(-l, 0) + log1p(exp(-|l|)) (stable for any l).
__device__ __forceinline__ float bernoulli_logit_term(float l, float y) {
  return -(fmaxf(-l, 0.0f) + log1pf(expf(-fabsf(l)))) - (1.0f - y) * l;
}

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

__global__ void __launch_bounds__(kThreads)
std_normal_partials(const float* __restrict__ z, long long z_row_stride,
                    long long n, float* __restrict__ partials) {
  const float* row = z + static_cast<long long>(blockIdx.y) * z_row_stride;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  float acc = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    acc += std_normal_term(row[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
bernoulli_logit_partials(const float* __restrict__ l, long long l_row_stride,
                         const float* __restrict__ y, long long y_row_stride,
                         long long n, float* __restrict__ partials) {
  const float* lrow = l + static_cast<long long>(blockIdx.y) * l_row_stride;
  const float* yrow = y + static_cast<long long>(blockIdx.y) * y_row_stride;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  float acc = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    acc += bernoulli_logit_term(lrow[i], yrow[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
finish_rows(const float* __restrict__ partials, int nparts,
            float* __restrict__ out) {
  const float* row = partials + static_cast<long long>(blockIdx.x) * nparts;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += row[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

bool bad_shape(int rows, long long n, int nparts) {
  return rows <= 0 || rows > 65535 || n <= 0 || nparts <= 0 || nparts > 65535;
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = success);
// launches go on the caller's stream and do not synchronise. `partials`
// holds rows * nparts floats and `out` rows floats, both allocated by the
// caller.
extern "C" int repro_std_normal_sum(const float* z, long long z_row_stride,
                                    int rows, long long n, float* partials,
                                    int nparts, float* out, void* stream) {
  if (bad_shape(rows, n, nparts)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std_normal_partials<<<dim3(nparts, rows), kThreads, 0, s>>>(z, z_row_stride, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_rows<<<rows, kThreads, 0, s>>>(partials, nparts, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bernoulli_logit_sum(const float* l, long long l_row_stride,
                                         const float* y, long long y_row_stride,
                                         int rows, long long n, float* partials,
                                         int nparts, float* out, void* stream) {
  if (bad_shape(rows, n, nparts)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bernoulli_logit_partials<<<dim3(nparts, rows), kThreads, 0, s>>>(
      l, l_row_stride, y, y_row_stride, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_rows<<<rows, kThreads, 0, s>>>(partials, nparts, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
