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
// its MXU. This one feeds the tensor cores in "3xTF32": each operand a is
// split into a TF32 high part hi (a rounded to 10 mantissa bits, ties
// away from zero) and a low part lo = a - hi (exact; the tensor cores read
// its top 10 mantissa bits), and the product is accumulated in float32 as
// lo*hi + hi*lo + hi*hi (the lo*lo term, about 2^-22 of the product, is
// dropped). That holds rtol 1e-5 against the float32 plain version; three
// TF32 products at 495 TFLOP/s bound the call at about 13 us. The split
// is integer work on the CUDA cores (cvt.rna.tf32.f32 was slower on the
// card), done for every fragment a warp loads. At the `mixed` model's 4 x
// 1 x 5 the time is launch latency, and a call is one launch.
//
// Design. The quadratic form is the same for P and its transpose, so the
// kernel forms xc P^T, whose B operand is P's rows: both operands are then
// rows of floats contiguous along the shared dimension. A block owns a
// 128 x BN output tile (128 rows of one chain's xc against BN = 128 rows
// of P, 64 when D <= 64): 8 warps, each 64 x 32 (BN 128) or 32 x 32 (BN
// 64) of it as mma.sync m16n8k8 TF32 tiles. The shared dimension is
// walked in steps of 32 through a three-stage ring of shared-memory tiles
// filled by cp.async (16-byte copies when D is a multiple of 4 and the
// bases are 16-byte aligned, else 4-byte ones); both tiles are padded to
// a pitch of 36 floats, so the ldmatrix loads of the fragments (an 8 x 4
// block of floats is an 8 x 8 block of 16-bit halves) hit 32 distinct
// banks. Rows past N and D and columns past D are copied as zeros (the
// TPU kernel's zero padding). At the end each thread multiplies its
// outputs by the matching xc entries on the fly (xc P^T never goes to
// memory) and the block reduces the tile's sum in a fixed order into
// partials[b, tile]. The last block of a row to finish (an integer count
// per row, set back to zero by that block) sums the row's partials in a
// fixed order. No float atomics: reruns are bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32.cuh"  // split_tf32, split4, mma3

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;   // rows of xc per block
constexpr int kDepth = 32;   // the shared dimension per stage
constexpr int kStages = 3;
constexpr int kPitch = kDepth + 4;  // floats per staged row of xc or P

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN == 128 ? 4 : 2;  // warps along columns
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMT = kRows / (kWarpsM * 16);  // m-tiles a warp
  static constexpr int kNT = BN / (kWarpsN * 8);      // n-tiles a warp
  static constexpr int kXStage = kRows * kPitch;      // floats a stage
  static constexpr int kPStage = BN * kPitch;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * (kXStage + kPStage) * sizeof(float);
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// src_bytes 0 fills the destination with zeros (past N or D)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 4 blocks of floats (8 x 8 blocks of 16-bit halves): thread
// lane gets element (lane / 4, lane % 4) of block i in r[i]
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// Stage kt's slice of the shared dimension: xs[r][k] = xc[r0 + r, k0 + k]
// and ps[j][k] = P[j0 + j, k0 + k], zeros past N and D.
template <int BN, bool kVec>
__device__ __forceinline__ void load_stage(const float* x, const float* p,
                                           int n, int d, int r0, int j0,
                                           int k0, float* xs, float* ps) {
  const int tid = threadIdx.x;
  if (kVec) {  // 16-byte copies: D is a multiple of 4, so a copy is all in or out
#pragma unroll
    for (int e = tid; e < kRows * (kDepth / 4); e += kThreads) {
      const int r = e / (kDepth / 4), c = 4 * (e % (kDepth / 4));
      const bool in = r0 + r < n && k0 + c < d;
      const float* src = in ? x + static_cast<long long>(r0 + r) * d + k0 + c : x;
      cp_async16(smem_addr(xs + r * kPitch + c), src, in ? 16 : 0);
    }
#pragma unroll
    for (int e = tid; e < BN * (kDepth / 4); e += kThreads) {
      const int j = e / (kDepth / 4), c = 4 * (e % (kDepth / 4));
      const bool in = j0 + j < d && k0 + c < d;
      const float* src = in ? p + static_cast<long long>(j0 + j) * d + k0 + c : p;
      cp_async16(smem_addr(ps + j * kPitch + c), src, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, k = e % kDepth;
      const bool in = r0 + r < n && k0 + k < d;
      const float* src = in ? x + static_cast<long long>(r0 + r) * d + k0 + k : x;
      cp_async4(smem_addr(xs + r * kPitch + k), src, in ? 4 : 0);
    }
#pragma unroll 4
    for (int e = tid; e < BN * kDepth; e += kThreads) {
      const int j = e / kDepth, k = e % kDepth;
      const bool in = j0 + j < d && k0 + k < d;
      const float* src = in ? p + static_cast<long long>(j0 + j) * d + k0 + k : p;
      cp_async4(smem_addr(ps + j * kPitch + k), src, in ? 4 : 0);
    }
  }
}

// grid (row tiles * column tiles, B); partials[b, tile]; counts[b] zero
// between calls
template <int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
mvn_quad_tc(const float* __restrict__ xc, long long x_batch_stride,
            const float* __restrict__ prec, long long p_batch_stride, int n,
            int d, int col_tiles, float* __restrict__ partials,
            int* __restrict__ counts, float* __restrict__ out) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  float* xs_base = smem;                            // [kStages][128][36]
  float* ps_base = smem + kStages * T::kXStage;     // [kStages][BN][36]
  __shared__ bool merge_last;

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = (tile / col_tiles) * kRows;
  const int j0 = (tile % col_tiles) * BN;
  const float* x = xc + static_cast<long long>(b) * x_batch_stride;
  const float* p = prec + static_cast<long long>(b) * p_batch_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = lane & 3;    // fragment row, column
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix block, its row
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int wr = wm * T::kMT * 16;  // the warp's first row in the tile
  const int wc = wn * T::kNT * 8;   // and first column

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ktiles = (d + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_stage<BN, kVec>(x, p, n, d, r0, j0, s * kDepth,
                           xs_base + s * T::kXStage, ps_base + s * T::kPStage);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();               // every thread's part; stage kt - 1 is free
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      load_stage<BN, kVec>(x, p, n, d, r0, j0, nk * kDepth,
                           xs_base + s * T::kXStage, ps_base + s * T::kPStage);
    }
    cp_async_commit();
    const float* xs = xs_base + (kt % kStages) * T::kXStage;
    const float* ps = ps_base + (kt % kStages) * T::kPStage;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      // B fragments (P^T[k][j] = ps[j][k]: k = gc (+4), j = the n-tile's
      // gr), two n-tiles an ldmatrix
      uint32_t bh[T::kNT][2], bl[T::kNT][2];
#pragma unroll
      for (int j = 0; j < T::kNT; j += 2) {
        uint32_t b[4];
        ldsm_x4(ps + (wc + j * 8 + (mat >> 1) * 8 + mrow) * kPitch + kk +
                    (mat & 1) * 4, b);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(b[e]), bh[j + (e >> 1)][e & 1],
                     bl[j + (e >> 1)][e & 1]);
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        // A fragment (xc[r][k]: r = gr (+8), k = gc (+4))
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(xs + (wr + i * 16 + (mat & 1) * 8 + mrow) * kPitch + kk +
                    (mat >> 1) * 4, a);
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < T::kNT; ++j)
          mma3(acc[i][j], ah, al, bh[j][0], bh[j][1], bl[j][0], bl[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // (xc P^T)[r, c] * xc[r, c] on the fly, in a fixed order
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wr + i * 16 + gr + 8 * h;
      if (r >= n) continue;
      const float* xrow = x + static_cast<long long>(r) * d;
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j0 + wc + j * 8 + 2 * gc + e;
          if (c < d) sum = fmaf(acc[i][j][2 * h + e], xrow[c], sum);
        }
      }
    }
  }
  sum = block_sum(sum);
  const int tiles = gridDim.x;
  if (tiles == 1) {
    if (threadIdx.x == 0) out[b] = -0.5f * sum;
    return;
  }
  // the last block of row b to finish sums its partials (an integer count;
  // the sum reads the partials in a fixed order whichever block does it)
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(b) * tiles + tile] = sum;
    __threadfence();
    merge_last = atomicAdd(counts + b, 1) == tiles - 1;
    if (merge_last) __threadfence();
  }
  __syncthreads();
  if (!merge_last) return;
  const float* row = partials + static_cast<long long>(b) * tiles;
  float total = 0.0f;
  for (int i = threadIdx.x; i < tiles; i += kThreads) total += __ldcg(row + i);
  total = block_sum(total);
  if (threadIdx.x == 0) {
    out[b] = -0.5f * total;
    counts[b] = 0;
  }
}

template <int BN, bool kVec>
int launch(const float* xc, long long xs, const float* prec, long long ps,
           int rows, int n, int d, float* partials, int tiles, int* counts,
           float* out, cudaStream_t s) {
  constexpr size_t smem = Tile<BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      mvn_quad_tc<BN, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mvn_quad_tc<BN, kVec><<<dim3(tiles, rows), kThreads, smem, s>>>(
      xc, xs, prec, ps, n, d, (d + BN - 1) / BN, partials, counts, out);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_vec(const float* xc, long long xs, const float* prec, long long ps,
               int rows, int n, int d, float* partials, int tiles,
               int* counts, float* out, cudaStream_t s) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(xc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(prec) % 16 == 0 &&
                   xs % 4 == 0 && ps % 4 == 0;
  return vec ? launch<BN, true>(xc, xs, prec, ps, rows, n, d, partials, tiles,
                                counts, out, s)
             : launch<BN, false>(xc, xs, prec, ps, rows, n, d, partials, tiles,
                                 counts, out, s);
}

}  // namespace

// C interface, loaded with ctypes; returns a cudaError_t (0 = success).
// xc (rows, n, d) with rows of d floats, batch stride n*d or 0; prec
// (rows, d, d) row-major, batch stride d*d or 0. Tiles are 128 rows by
// 128 columns (64 when d <= 64): tiles = ceil(n / 128) * ceil(d / width).
// `partials` holds rows * tiles floats and `out` rows floats, `counts`
// rows ints that are zero (the kernel leaves them zero), all allocated by
// the caller. One launch on the caller's stream; it does not synchronise.
extern "C" int repro_mvn_quadform_sum(const float* xc, long long x_batch_stride,
                                      const float* prec, long long p_batch_stride,
                                      int rows, int n, int d, float* partials,
                                      int tiles, int* counts, float* out,
                                      void* stream) {
  const int width = d <= 64 ? 64 : 128;
  const long long want = static_cast<long long>((n + kRows - 1) / kRows) *
                         ((d + width - 1) / width);
  if (rows <= 0 || rows > 65535 || n <= 0 || d <= 0 || tiles != want) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return width == 64
             ? launch_vec<64>(xc, x_batch_stride, prec, p_batch_stride, rows,
                              n, d, partials, tiles, counts, out, s)
             : launch_vec<128>(xc, x_batch_stride, prec, p_batch_stride, rows,
                               n, d, partials, tiles, counts, out, s);
}

extern "C" const char* repro_mvn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
