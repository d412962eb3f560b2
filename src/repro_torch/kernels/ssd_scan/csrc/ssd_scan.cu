// Mamba-2 chunked SSD scan for Hopper (sm_90a), three kernels with a plain
// C interface for ctypes: ssd_scan_tc, bf16 on the tensor cores;
// ssd_scan_tf32 (and its pre-pass), float32 on the tensor cores in 3xTF32;
// and ssd_scan_kernel, float32 on the CUDA cores for every other call (the
// wrapper's plan picks).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// _ssd_kernel (:31), reached through ssd_scan_bh (:77, the pallas_call at
// :86). For each (batch, head) a state S (n x p, float32) is carried across
// chunks of L positions; for each chunk, with cum = cumsum(dt * a),
//
//   y   = [(C B^T) o exp(cum_i - cum_j)|causal o dt_j] x + (e^{cum} o C) S
//   S  <- e^{cum_L} S + B^T (e^{cum_L - cum} dt o x)
//
// B and C are grouped: head h reads group h / (H / G). x, B, C and y are
// float32 or bf16, dt and A float32.
//
// ssd_scan_tc (bf16 x, B, C; chunk, n and p each 64 or 128). What bounds
// it: at mamba2-1.3b's call (4 x 2,048 tokens, 64 heads of 64, n 128, L
// 128) the inputs and output are 140.5 MB, 42 us at 3.35 TB/s, against
// about 11 GFLOP of bf16 products (11 us on the tensor cores): bytes. The
// TPU kernel fed the same four products to its MXU in bf16 passes. Design:
// one block (8 warps) per (batch, group, 128 output columns: two heads at
// p 64, one at p 128) walks the chunks in order, so B and C are read once
// for both heads. The next chunk's C, B and x come in by 16-byte cp.async
// into the other stage of a two-stage ring while this one computes (dt a
// chunk ahead in registers), all tiles XOR-swizzled so ldmatrix and the
// fragment stores are free of bank conflicts. Per chunk one warp per head
// scans cum (kept in log2 units); then each warp takes the row tiles m
// and L/16 - 1 - m (equal causal work for all) over its 64 (or 32)
// columns of one head: acc = C S (S in bf16 from shared memory) scaled by
// e^{cum_i}, then over the causal 16-column tiles G = C B^T (exact: bf16
// inputs, float32 sums), W = G o exp(cum_i - cum_j) o dt_j with the mask
// inside the exponent (anticausal differences are positive and overflow),
// rounded to bf16 as the A operand of acc += W x; y is stored in bf16.
// Then S <- e^{cum_L} S + (B o segdt)^T x, with S held in float32 in the
// registers of the warps that own its rows and columns (the segdt scaling
// folded into the B^T fragments, rounded to bf16) and written to shared
// memory in bf16 for the next chunk. G is formed once per warp's head,
// not once per chunk: sharing it between the heads would need an L x L
// tile beside the ring (there is about 1 KB left at L = n = 128) or one
// warp per row tile for both heads, which unbalances the causal work.
// mma.sync m16n8k16 bf16 with float32 accumulation; no atomics: reruns
// are bit-identical.
//
// ssd_scan_tf32 (float32 x, B, C; n and p each 64 or 128). What
// bounds it: at mamba2-1.3b's call the inputs and output are 279 MB, 83 us
// at 3.35 TB/s, against 19.4 GFLOP of products at its 64-position
// sub-chunks, three TF32 passes of them 118 us on the tensor cores:
// operations. Each product is 3xTF32 (as in
// mvn_quad.cu): an operand a is split into hi (a rounded to 10 mantissa
// bits, ties away from zero) and lo = a - hi, and lo*hi + hi*lo + hi*hi is
// accumulated in float32 by mma.sync m16n8k8, which keeps the float32
// gates (2e-4 here, 1e-4 on the scoring log-likelihood) where one TF32
// pass (about 1e-3) would not. Design: float32 tiles are twice bf16's, so
// ssd_scan_tc's ring of C, B and x for 128 positions and 128 columns
// (384 KB in float32) cannot stay. The kernel walks sub-chunks of 64
// positions whatever the chunk (the chunked scan's result does not depend
// on the chunk length), and one block of 8 warps serves (batch, head, 64
// output columns): a two-stage cp.async ring of C, B [64][n], x [64][64]
// and dt (160 KB at n 128, XOR-swizzled) and S's hi and lo (64 KB) fill
// the 227 KB, so sub-chunk c + 1 lands while c computes. G = C B^T is the
// same for every head of a group, so a pre-pass (ssd_scan_tf32_gram, a
// block a (batch, group, sub-chunk)) forms its causal 16 x 16 tiles once
// into scratch (2 MB at mamba2's call, read back from L2): formed in each
// block, by both warps of a row tile, it was 35 % of the products and
// most of the warps' imbalance (a row tile's causal tiles run 1 to 4).
// Per sub-chunk one warp scans cum; each warp takes one row tile of y and
// 32 columns: y_inter = C S (C's fragment split once a warp) while its G
// tiles load, then W = G o exp(cum_i - cum_j) o dt_j (the mask inside the
// exponent), split once as it leaves the registers, is the A operand of W
// x as it is (its keys taken in the order 2 gc, 2 gc + 1, and x's rows in
// the same order). Then S <- e^{cum_L} S + (B o segdt)^T x on 16 rows of
// S a warp, S in float32 in the registers of the warp that owns it, split
// once into the B fragments of the next sub-chunk's C S in shared memory.
// x and B are split as a warp loads them (no room for their hi and lo
// beside the ring). No atomics: reruns are bit-identical.
//
// ssd_scan_kernel (float32, and every call the tensor-core kernels do not
// take).
// What bounds it: at mamba2-1.3b's shape a chunk is about 4 M
// multiply-adds on 80 KB of inputs: operations, not bytes.
//
// Design. One block (256 threads) per (batch, head) walks the chunks in
// order with S resident in shared memory: the loop takes the place of the
// TPU kernel's sequential chunk axis and its VMEM scratch. Shared memory
// cannot hold B, C, x and the L x L weights of a chunk in float32 (227 KB
// a block), so the weights are built 32 rows at a time: C, B (pitch n + 1,
// so the column reads are free of bank conflicts), x, S and one 32 x L
// tile of weights, about 211 KB at L = n = 128, p = 64. Per chunk:
// load C, B, x and dt (zeros and dt = 0 past the sequence, as the JAX
// wrapper pads); one warp scans cum; y_inter = e^{cum_i} (C_i . S) into
// registers (L/16 rows x p/16 columns a thread); for each 32-row tile,
// the weights W = (C B^T) o decay o dt with the causal mask applied
// INSIDE the exponent (anticausal differences are positive and overflow),
// then y += W x over the causal columns only; y is written; then each
// thread updates its own elements of S. No atomics: reruns are
// bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32.cuh"  // split_tf32, split4, mma_tf32, mma3

namespace {

constexpr int kThreads = 256;
constexpr int kWRows = 32;  // rows of the weight tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x; const float* dt; const float* A; const void* B; const void* C;
  void* y;
  long long x_sb, x_ss, x_sh;   // x (b, s, h, p), last axis dense
  long long dt_sb, dt_ss;       // dt (b, s, h), head axis dense
  long long b_sb, b_ss, b_sg;   // B (b, s, g, n), last axis dense
  long long c_sb, c_ss, c_sg;   // C (b, s, g, n)
  long long y_sb, y_ss, y_sh;   // y (b, s, h, p)
  int s, h, g, n;
  float* gram;  // ssd_scan_tf32: G = C B^T [b][g][sub-chunk][64][64]
};

// C and B [L][n + 1], x [L][P], S [n][P], W [32][L + 1], cum, dt and
// segdt [L], e^{cum_L} [1]
size_t smem_floats(int L, int n, int P) {
  return 2ull * L * (n + 1) + static_cast<size_t>(L) * P +
         static_cast<size_t>(n) * P + static_cast<size_t>(kWRows) * (L + 1) +
         3ull * L + 1;
}

template <typename T, int L, int P>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params a) {
  constexpr int LR = L / 16;  // y rows a thread owns: ty + 16 r
  constexpr int PC = P / 16;  // y / S columns a thread owns: tx + 16 c
  constexpr int WC = L / 32;  // weight-tile columns a thread owns: tx2 + 32 c
  const int n = a.n, np = n + 1;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                 // [L][n + 1]
  float* Bs = Cs + L * np;          // [L][n + 1]
  float* xs = Bs + L * np;          // [L][P]
  float* Ss = xs + L * P;           // [n][P]
  float* Ws = Ss + n * P;           // [kWRows][L + 1]
  float* cum = Ws + kWRows * (L + 1);
  float* dtv = cum + L;
  float* segdt = dtv + L;
  float* decay_last = segdt + L;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ Bg = static_cast<const T*>(a.B);
  const T* __restrict__ Cg = static_cast<const T*>(a.C);
  T* __restrict__ y = static_cast<T*>(a.y);

  const int t = threadIdx.x, lane = t & 31;
  const int tx = t & 15, ty = t >> 4;    // y and S mapping
  const int tx2 = t & 31, ty2 = t >> 5;  // weight-tile mapping
  const int hi = blockIdx.x;
  const long long bi = blockIdx.y;
  const int gi = hi / (a.h / a.g);
  const float av = a.A[hi];

  for (int idx = t; idx < n * P; idx += kThreads) Ss[idx] = 0.0f;

  const int nchunks = (a.s + L - 1) / L;
  for (int ch = 0; ch < nchunks; ++ch) {
    const long long s0 = static_cast<long long>(ch) * L;
    // C, B, x and dt of the chunk; zeros (and dt = 0) past the sequence
    for (int idx = t; idx < L * n; idx += kThreads) {
      const int i = idx / n, nn = idx - i * n;
      const long long si = s0 + i;
      float cv = 0.0f, bv = 0.0f;
      if (si < a.s) {
        cv = to_f(Cg[bi * a.c_sb + si * a.c_ss + gi * a.c_sg + nn]);
        bv = to_f(Bg[bi * a.b_sb + si * a.b_ss + gi * a.b_sg + nn]);
      }
      Cs[i * np + nn] = cv;
      Bs[i * np + nn] = bv;
    }
    for (int idx = t; idx < L * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      const long long si = s0 + j;
      xs[idx] = si < a.s ? to_f(x[bi * a.x_sb + si * a.x_ss + hi * a.x_sh + p])
                         : 0.0f;
    }
    for (int i = t; i < L; i += kThreads) {
      const long long si = s0 + i;
      dtv[i] = si < a.s ? a.dt[bi * a.dt_sb + si * a.dt_ss + hi] : 0.0f;
    }
    __syncthreads();

    if (t < 32) {  // cum = cumsum(dt * a): a warp scan, L / 32 per lane
      constexpr int per = L / 32;
      float local[per];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        run += dtv[lane * per + e] * av;
        local[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += other;
      }
      const float before = incl - run;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int e = 0; e < per; ++e) {
        const int i = lane * per + e;
        const float c = before + local[e];
        cum[i] = c;
        segdt[i] = expf(last - c) * dtv[i];
      }
      if (lane == 0) decay_last[0] = expf(last);
    }
    __syncthreads();

    // y_inter = e^{cum_i} (C_i . S): rows ty + 16 r, columns tx + 16 c
    float acc[LR][PC];
#pragma unroll
    for (int r = 0; r < LR; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] = 0.0f;
    for (int nn = 0; nn < n; ++nn) {
      float cv[LR], sv[PC];
#pragma unroll
      for (int r = 0; r < LR; ++r) cv[r] = Cs[(ty + 16 * r) * np + nn];
#pragma unroll
      for (int c = 0; c < PC; ++c) sv[c] = Ss[nn * P + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < LR; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const float e = expf(cum[ty + 16 * r]);
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] *= e;
    }

    // y_intra, one 32-row tile of weights at a time
#pragma unroll
    for (int wb = 0; wb < L / kWRows; ++wb) {
      const int ncols = (wb + 1) * kWRows;  // causal: later columns are 0
      float w[4][WC];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < WC; ++c) w[rr][c] = 0.0f;
      for (int nn = 0; nn < n; ++nn) {
        float cv[4], bv[WC];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          cv[rr] = Cs[(wb * kWRows + ty2 * 4 + rr) * np + nn];
#pragma unroll
        for (int c = 0; c < WC; ++c)
          bv[c] = c <= wb ? Bs[(tx2 + 32 * c) * np + nn] : 0.0f;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < WC; ++c) w[rr][c] = fmaf(cv[rr], bv[c], w[rr][c]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int ii = ty2 * 4 + rr, i = wb * kWRows + ii;
#pragma unroll
        for (int c = 0; c < WC; ++c) {
          const int j = tx2 + 32 * c;
          if (j >= ncols) continue;
          const bool causal = i >= j;
          const float decay = expf(causal ? cum[i] - cum[j] : 0.0f);
          Ws[ii * (L + 1) + j] = (causal ? w[rr][c] * decay : 0.0f) * dtv[j];
        }
      }
      __syncthreads();
      // rows ty + 16 r of this tile are r = 2 wb and 2 wb + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 2 * wb + half;
        const int ii = ty + 16 * half;
        float part[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) part[c] = 0.0f;
        for (int j = 0; j < ncols; ++j) {
          const float wv = Ws[ii * (L + 1) + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) part[c] = fmaf(wv, xs[j * P + tx + 16 * c], part[c]);
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] += part[c];
      }
      __syncthreads();  // before the next tile overwrites Ws
    }

#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const long long si = s0 + ty + 16 * r;
      if (si >= a.s) continue;
      T* yrow = y + bi * a.y_sb + si * a.y_ss + hi * a.y_sh;
#pragma unroll
      for (int c = 0; c < PC; ++c) store(yrow + tx + 16 * c, acc[r][c]);
    }

    // S <- e^{cum_L} S + B^T (segdt o x): each thread its own elements
    const float dl = decay_last[0];
    for (int nb = 0; nb < n; nb += 64) {
      float sacc[4][PC];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < PC; ++c) sacc[rr][c] = 0.0f;
      for (int j = 0; j < L; ++j) {
        const float sd = segdt[j];
        float bv[4], xv[PC];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int nn = nb + ty + 16 * rr;
          bv[rr] = nn < n ? Bs[j * np + nn] * sd : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < PC; ++c) sacc[rr][c] = fmaf(bv[rr], xv[c], sacc[rr][c]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int nn = nb + ty + 16 * rr;
        if (nn >= n) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          float* sp = &Ss[nn * P + tx + 16 * c];
          *sp = *sp * dl + sacc[rr][c];
        }
      }
    }
    __syncthreads();  // before the next chunk's loads and its reads of S
  }
}

// ---------------------------------------------------------------------------
// ssd_scan_tc: bf16 x, B and C on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 256;
constexpr int kTcCols = 128;  // output columns a block: 128 / p heads
constexpr float kLog2e = 1.4426950408889634f;

template <int L, int N>
struct TcShape {
  static constexpr int kMT = L / 16;                // row tiles of a chunk
  static constexpr int kPairs = kMT / 2;            // pairs (m, kMT - 1 - m)
  static constexpr int kGroups = 8 / kPairs;        // column groups, y phase
  static constexpr int kYCols = kTcCols / kGroups;  // a warp's y columns
  static constexpr int kYN = kYCols / 8;            // and their n-tiles
  static constexpr int kKS = N / 16;                // k-steps over the state
  static constexpr int kSM = N / 64;                // S row tiles a warp
  static constexpr int kStage = 2 * L * N + L * kTcCols;  // bf16 a stage
  // two stages of C, B [L][N] and x [L][128]; S [N][128] in bf16; cum
  // (log2 units) and dt [2][L] in float32
  static constexpr size_t kSmem =
      (2ull * kStage + static_cast<size_t>(N) * kTcCols) * 2 +
      2ull * 2 * L * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 fills the 16 bytes with zeros (positions past the sequence)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// a bf16 pair times (lo, hi), rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * lo, f.y * hi);
}
__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// element offset of (row, col) in a [rows][cols] bf16 tile whose 16-byte
// chunks are XOR-swizzled by the row: ldmatrix's 8 row addresses and the
// fragment stores fall on 32 distinct banks
template <int kCols>
__device__ __forceinline__ int swz(int row, int col) {
  return row * kCols + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// cp.async of chunk ch's C, B [L][N] and the block's heads' x [L][128]
template <int L, int N, int P>
__device__ __forceinline__ void tc_load_chunk(const Params& a, long long bi,
                                              int gi, int h0, int ch,
                                              __nv_bfloat16* cs, int tid) {
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.C);
  const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(a.B);
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* bs = cs + L * N;
  __nv_bfloat16* xs = bs + L * N;
  const long long s0 = static_cast<long long>(ch) * L;
  constexpr int kNC = N / 8;  // 16-byte copies a row of C or B
#pragma unroll 4
  for (int idx = tid; idx < L * kNC; idx += kTcThreads) {
    const int i = idx / kNC, c = idx - i * kNC;
    const bool in = s0 + i < a.s;
    const long long si = in ? s0 + i : 0;
    const int o = swz<N>(i, 8 * c);
    cp_async16(smem_addr(cs + o), Cg + bi * a.c_sb + si * a.c_ss + gi * a.c_sg + 8 * c,
               in ? 16 : 0);
    cp_async16(smem_addr(bs + o), Bg + bi * a.b_sb + si * a.b_ss + gi * a.b_sg + 8 * c,
               in ? 16 : 0);
  }
  constexpr int kXC = kTcCols / 8;  // 16-byte copies a row of x
  constexpr int kPC = P / 8;        // of them a head
#pragma unroll 4
  for (int idx = tid; idx < L * kXC; idx += kTcThreads) {
    const int j = idx / kXC, c = idx - j * kXC;
    const int hl = c / kPC, pc = c - hl * kPC;
    const bool in = s0 + j < a.s;
    const long long sj = in ? s0 + j : 0;
    cp_async16(smem_addr(xs + swz<kTcCols>(j, 8 * c)),
               xg + bi * a.x_sb + sj * a.x_ss +
                   static_cast<long long>(h0 + hl) * a.x_sh + 8 * pc,
               in ? 16 : 0);
  }
}

// grid (h / (128 / P), batch): one block a (batch, group, head pair at P
// 64 or head at P 128), walking the chunks in order
template <int L, int N, int P>
__global__ void __launch_bounds__(kTcThreads, 1) ssd_scan_tc(Params a) {
  using S = TcShape<L, N>;
  constexpr int kHB = kTcCols / P;  // heads a block
  constexpr int kPer = L / 32;      // positions a lane scans
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ss = ring + 2 * S::kStage;  // S [N][128], bf16
  float* cum2 = reinterpret_cast<float*>(ss + N * kTcCols);  // [2][L]
  float* dtv = cum2 + 2 * L;                                 // [2][L]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3;    // fragment row, column pair
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix matrix, its row
  const int h0 = blockIdx.x * kHB;
  const long long bi = blockIdx.y;
  const int gi = h0 / (a.h / a.g);
  const int nchunks = (a.s + L - 1) / L;
  __nv_bfloat16* __restrict__ y = static_cast<__nv_bfloat16*>(a.y);

  // y phase: row tiles pr and kMT - 1 - pr (equal causal work in all),
  // columns yc0 .. yc0 + kYCols of head yh
  const int pr = warp / S::kGroups;
  const int yc0 = (warp % S::kGroups) * S::kYCols;
  const int yh = yc0 / P;
  // state phase: rows sr0 .. sr0 + N / 4 of S, columns sc0 .. sc0 + 64
  const int sr0 = (warp >> 1) * (N / 4);
  const int sc0 = (warp & 1) * 64;
  const int sh = sc0 / P;

  // warp w < kHB scans head h0 + w: its dt, kPer positions a lane, one
  // chunk ahead
  float dreg[kPer];
  float av = 0.0f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) dreg[e] = 0.0f;
  if (warp < kHB) {
    av = a.A[h0 + warp];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const long long si = lane * kPer + e;
      if (si < a.s) dreg[e] = a.dt[bi * a.dt_sb + si * a.dt_ss + h0 + warp];
    }
  }
  float sacc[S::kSM][8][4];
#pragma unroll
  for (int m = 0; m < S::kSM; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[m][n][e] = 0.0f;

  tc_load_chunk<L, N, P>(a, bi, gi, h0, 0, ring, tid);
  cp_async_commit();

  for (int ch = 0; ch < nchunks; ++ch) {
    const long long s0 = static_cast<long long>(ch) * L;
    const __nv_bfloat16* cs = ring + (ch & 1) * S::kStage;
    const __nv_bfloat16* bs = cs + L * N;
    const __nv_bfloat16* xs = bs + L * N;
    if (ch + 1 < nchunks) {
      tc_load_chunk<L, N, P>(a, bi, gi, h0, ch + 1,
                             ring + ((ch + 1) & 1) * S::kStage, tid);
    }
    cp_async_commit();

    if (warp < kHB) {  // cum = cumsum(dt * a), kept in log2 units
      float local[kPer];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        run += dreg[e] * av;
        local[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += other;
      }
      const float before = incl - run;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = lane * kPer + e;
        cum2[warp * L + i] = (before + local[e]) * kLog2e;
        dtv[warp * L + i] = dreg[e];
      }
      if (ch + 1 < nchunks) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const long long si = s0 + L + lane * kPer + e;
          dreg[e] = si < a.s ? a.dt[bi * a.dt_sb + si * a.dt_ss + h0 + warp]
                             : 0.0f;
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // the chunk's tiles, cum and dt, and S are in place

    // y = e^{cum_i} (C S)_i + (W x)_i, W = (C B^T) o exp(cum_i - cum_j) o
    // dt_j over the causal tiles, on the warp's two row tiles
    const float* cy = cum2 + yh * L;
    const float* dy = dtv + yh * L;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int m = half == 0 ? pr : S::kMT - 1 - pr;
      const int i0 = 16 * m;
      uint32_t cf[S::kKS][4];  // C's A fragments, rows i0 .. i0 + 15
#pragma unroll
      for (int ks = 0; ks < S::kKS; ++ks) {
        const int row = i0 + (mat & 1) * 8 + mrow;
        ldsm_x4(smem_addr(cs + swz<N>(row, ks * 16 + (mat >> 1) * 8)), cf[ks]);
      }
      float acc[S::kYN][4];
#pragma unroll
      for (int n = 0; n < S::kYN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      const float ci0 = cy[i0 + gr], ci1 = cy[i0 + gr + 8];
      if (ch > 0) {  // y_inter (S is zero before the first chunk)
#pragma unroll
        for (int ks = 0; ks < S::kKS; ++ks) {
#pragma unroll
          for (int np = 0; np < S::kYN / 2; ++np) {
            const int krow = ks * 16 + (mat & 1) * 8 + mrow;
            uint32_t b[4];
            ldsm_x4_t(smem_addr(ss + swz<kTcCols>(krow, yc0 + np * 16 + (mat >> 1) * 8)), b);
            mma_bf16(acc[2 * np], cf[ks], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], cf[ks], b[2], b[3]);
          }
        }
        const float e0 = ex2_fast(ci0), e1 = ex2_fast(ci1);
#pragma unroll
        for (int n = 0; n < S::kYN; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
      }
#pragma unroll 1
      for (int kb = 0; kb <= m; ++kb) {  // y_intra over the causal tiles
        const int j0 = 16 * kb;
        float g[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[t][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < S::kKS; ++ks) {
          const int jrow = j0 + (mat >> 1) * 8 + mrow;
          uint32_t b[4];
          ldsm_x4(smem_addr(bs + swz<N>(jrow, ks * 16 + (mat & 1) * 8)), b);
          mma_bf16(g[0], cf[ks], b[0], b[1]);
          mma_bf16(g[1], cf[ks], b[2], b[3]);
        }
        // the causal mask inside the exponent: anticausal differences are
        // positive and overflow
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + t * 8 + 2 * gc + e;
            const float cj = cy[j], dj = dy[j];
            const bool k0 = i0 + gr >= j, k1 = i0 + gr + 8 >= j;
            const float d0 = ex2_fast(k0 ? ci0 - cj : 0.0f);
            const float d1 = ex2_fast(k1 ? ci1 - cj : 0.0f);
            g[t][e] = k0 ? g[t][e] * d0 * dj : 0.0f;
            g[t][2 + e] = k1 ? g[t][2 + e] * d1 * dj : 0.0f;
          }
        }
        const uint32_t wa[4] = {pack_bf16(g[0][0], g[0][1]),
                                pack_bf16(g[0][2], g[0][3]),
                                pack_bf16(g[1][0], g[1][1]),
                                pack_bf16(g[1][2], g[1][3])};
#pragma unroll
        for (int np = 0; np < S::kYN / 2; ++np) {
          const int jrow = j0 + (mat & 1) * 8 + mrow;
          uint32_t b[4];
          ldsm_x4_t(smem_addr(xs + swz<kTcCols>(jrow, yc0 + np * 16 + (mat >> 1) * 8)), b);
          mma_bf16(acc[2 * np], wa, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], wa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < S::kYN; ++n) {
        const int col = yc0 + n * 8 + 2 * gc;
        const int hl = col / P, pc = col - hl * P;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long si = s0 + i0 + gr + 8 * r;
          if (si >= a.s) continue;
          *reinterpret_cast<uint32_t*>(
              y + bi * a.y_sb + si * a.y_ss +
              static_cast<long long>(h0 + hl) * a.y_sh + pc) =
              pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
        }
      }
    }

    // S <- e^{cum_L} S + B^T (segdt o x) on the warp's rows and columns,
    // segdt_j = exp(cum_L - cum_j) dt_j folded into the B^T fragments
    {
      const float* cz = cum2 + sh * L;
      const float* dz = dtv + sh * L;
      const float cl = cz[L - 1];
      const float dl = ex2_fast(cl);
#pragma unroll
      for (int m = 0; m < S::kSM; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[m][n][e] *= dl;
#pragma unroll 2
      for (int ks = 0; ks < L / 16; ++ks) {
        float sd[4];  // j = 16 ks + 2 gc, + 1, + 8, + 9
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = ks * 16 + 2 * gc + (q & 1) + (q >> 1) * 8;
          sd[q] = ex2_fast(cl - cz[j]) * dz[j];
        }
        uint32_t af[S::kSM][4];
#pragma unroll
        for (int m = 0; m < S::kSM; ++m) {
          const int jrow = ks * 16 + (mat >> 1) * 8 + mrow;
          ldsm_x4_t(smem_addr(bs + swz<N>(jrow, sr0 + 16 * m + (mat & 1) * 8)), af[m]);
          af[m][0] = scale_bf16(af[m][0], sd[0], sd[1]);
          af[m][1] = scale_bf16(af[m][1], sd[0], sd[1]);
          af[m][2] = scale_bf16(af[m][2], sd[2], sd[3]);
          af[m][3] = scale_bf16(af[m][3], sd[2], sd[3]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int jrow = ks * 16 + (mat & 1) * 8 + mrow;
          uint32_t b[4];
          ldsm_x4_t(smem_addr(xs + swz<kTcCols>(jrow, sc0 + np * 16 + (mat >> 1) * 8)), b);
#pragma unroll
          for (int m = 0; m < S::kSM; ++m) {
            mma_bf16(sacc[m][2 * np], af[m], b[0], b[1]);
            mma_bf16(sacc[m][2 * np + 1], af[m], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // S, cum, dt and this stage are no longer read
    if (ch + 1 < nchunks) {  // S in bf16 for the next chunk's y_inter
#pragma unroll
      for (int m = 0; m < S::kSM; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = sr0 + 16 * m + gr + 8 * r;
            *reinterpret_cast<uint32_t*>(ss + swz<kTcCols>(row, sc0 + n * 8 + 2 * gc)) =
                pack_bf16(sacc[m][n][2 * r], sacc[m][n][2 * r + 1]);
          }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// ssd_scan_tf32: float32 x, B and C on the tensor cores in 3xTF32
// (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
constexpr int kTfThreads = 256;
constexpr int kTfRows = 64;  // positions a sub-chunk
constexpr int kTfCols = 64;  // output columns a block (one head's, or half)

template <int N>
struct TfShape {
  static constexpr int kSMT = N / 16;               // S row tiles
  static constexpr int kSG = 8 / kSMT;              // column groups, state phase
  static constexpr int kSN = kTfCols / 8 / kSG;     // a warp's S n-tiles
  // a stage: C, B [64][N], x [64][64] and dt [64], in float32
  static constexpr int kStage = 2 * kTfRows * N + kTfRows * kTfCols + kTfRows;
  // two stages; S hi and lo [N][64] in fragment order; cum and segdt [64]
  static constexpr size_t kSmem =
      (2ull * kStage + 2ull * N * kTfCols + 2ull * kTfRows) * sizeof(float);
};

// element offset of (row, col) in a [rows][kCols] float tile whose 16-byte
// chunks are XOR-swizzled by the row: ldmatrix's 8 row addresses, and the
// scalar fragment loads below, fall on distinct banks
template <int kCols>
__device__ __forceinline__ int swz4(int row, int col) {
  return row * kCols + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// cp.async of sub-chunk sc's C and B [64][N] into cs and cs + 64 N, by
// kT threads; zeros past the sequence
template <int N, int kT>
__device__ __forceinline__ void tf_load_cb(const Params& a, long long bi,
                                           int gi, int sc, float* cs,
                                           int tid) {
  const float* Cg = static_cast<const float*>(a.C);
  const float* Bg = static_cast<const float*>(a.B);
  float* bs = cs + kTfRows * N;
  const long long s0 = static_cast<long long>(sc) * kTfRows;
  constexpr int kNC = N / 4;  // 16-byte copies a row of C or B
#pragma unroll 4
  for (int idx = tid; idx < kTfRows * kNC; idx += kT) {
    const int i = idx / kNC, c = idx - i * kNC;
    const bool in = s0 + i < a.s;
    const long long si = in ? s0 + i : 0;
    const int o = swz4<N>(i, 4 * c);
    cp_async16(smem_addr(cs + o), Cg + bi * a.c_sb + si * a.c_ss + gi * a.c_sg + 4 * c,
               in ? 16 : 0);
    cp_async16(smem_addr(bs + o), Bg + bi * a.b_sb + si * a.b_ss + gi * a.b_sg + 4 * c,
               in ? 16 : 0);
  }
}

// cp.async of sub-chunk sc's C, B [64][N], x [64][64] (the block's columns)
// and dt [64]; zeros (dt = 0) past the sequence
template <int N>
__device__ __forceinline__ void tf_load(const Params& a, long long bi, int gi,
                                        int hi, int pc0, int sc, float* st,
                                        int tid) {
  const float* xg = static_cast<const float*>(a.x);
  float* xs = st + 2 * kTfRows * N;
  float* dts = xs + kTfRows * kTfCols;
  const long long s0 = static_cast<long long>(sc) * kTfRows;
  tf_load_cb<N, kTfThreads>(a, bi, gi, sc, st, tid);
  constexpr int kXC = kTfCols / 4;
#pragma unroll 4
  for (int idx = tid; idx < kTfRows * kXC; idx += kTfThreads) {
    const int j = idx / kXC, c = idx - j * kXC;
    const bool in = s0 + j < a.s;
    const long long sj = in ? s0 + j : 0;
    cp_async16(smem_addr(xs + swz4<kTfCols>(j, 4 * c)),
               xg + bi * a.x_sb + sj * a.x_ss +
                   static_cast<long long>(hi) * a.x_sh + pc0 + 4 * c,
               in ? 16 : 0);
  }
  if (tid < kTfRows) {
    const bool in = s0 + tid < a.s;
    const long long si = in ? s0 + tid : 0;
    cp_async4(smem_addr(dts + tid), a.dt + bi * a.dt_sb + si * a.dt_ss + hi,
              in ? 4 : 0);
  }
}

// ssd_scan_tf32's pre-pass: G = C B^T of one sub-chunk of one group (its
// causal 16 x 16 tiles, in 3xTF32) into gram, once for all the group's
// heads; grid (sub-chunks, groups, batch), warp m the row tile m
constexpr int kGramThreads = 128;

template <int N>
__global__ void __launch_bounds__(kGramThreads) ssd_scan_tf32_gram(Params a) {
  extern __shared__ __align__(128) float smem_f[];
  float* cs = smem_f;              // C, B [64][N], swizzled
  float* bs = cs + kTfRows * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int sc = blockIdx.x, gi = blockIdx.y;
  const long long bi = blockIdx.z;
  tf_load_cb<N, kGramThreads>(a, bi, gi, sc, cs, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int m = warp, i0 = 16 * warp;
  float g[4][2][4];
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[kb][t][e] = 0.0f;
#pragma unroll 2
  for (int ks = 0; ks < N / 8; ++ks) {
    uint32_t cr[4], ch[4], cl[4];  // C's A fragment, rows i0 .. i0 + 15
    ldsm_x4(smem_addr(cs + swz4<N>(i0 + (mat & 1) * 8 + mrow,
                                   8 * ks + (mat >> 1) * 4)), cr);
    split4(cr, ch, cl);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb > m) continue;  // uniform over the warp
      uint32_t br[4], bh[4], bl[4];  // B^T for keys 16 kb .. + 8, + 16
      ldsm_x4(smem_addr(bs + swz4<N>(16 * kb + (mat >> 1) * 8 + mrow,
                                     8 * ks + (mat & 1) * 4)), br);
      split4(br, bh, bl);
      mma3(g[kb][0], ch, cl, bh[0], bh[1], bl[0], bl[1]);
      mma3(g[kb][1], ch, cl, bh[2], bh[3], bl[2], bl[3]);
    }
  }
  float* out = a.gram +
               ((bi * a.g + gi) * gridDim.x + sc) * (kTfRows * kTfRows);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    if (kb > m) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (i0 + gr + 8 * r) * kTfRows + 16 * kb +
                                   8 * t + 2 * gc) =
            make_float2(g[kb][t][2 * r], g[kb][t][2 * r + 1]);
  }
}

// grid (h * (P / 64), batch): one block a (batch, head, 64 output columns),
// walking the sequence in sub-chunks of 64 positions
template <int N>
__global__ void __launch_bounds__(kTfThreads, 1) ssd_scan_tf32(Params a, int p) {
  using S = TfShape<N>;
  extern __shared__ __align__(128) float smem_f[];
  float* ring = smem_f;                    // [2][kStage]
  float4* sf = reinterpret_cast<float4*>(ring + 2 * S::kStage);  // S hi/lo
  float* cum = ring + 2 * S::kStage + 2 * N * kTfCols;  // [64], natural log
  float* segdt = cum + kTfRows;                          // [64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3;     // fragment row, column
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix matrix, its row
  const int slabs = p / kTfCols;
  const int hi = blockIdx.x / slabs;
  const int pc0 = (blockIdx.x - hi * slabs) * kTfCols;
  const long long bi = blockIdx.y;
  const int gi = hi / (a.h / a.g);
  const int nsub = (a.s + kTfRows - 1) / kTfRows;
  const float av = a.A[hi];
  float* __restrict__ y = static_cast<float*>(a.y);

  // y phase: row tile ym, columns yc0 .. yc0 + 32
  const int ym = warp >> 1, yc0 = (warp & 1) * 32, i0 = 16 * ym;
  // state phase: rows n0 .. n0 + 16 of S, columns sc0 .. sc0 + 8 kSN
  const int n0 = 16 * (warp / S::kSG);
  const int sc0 = (warp % S::kSG) * (8 * S::kSN);

  float sacc[S::kSN][4];
#pragma unroll
  for (int t = 0; t < S::kSN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[t][e] = 0.0f;

  tf_load<N>(a, bi, gi, hi, pc0, 0, ring, tid);
  cp_async_commit();

  for (int sc = 0; sc < nsub; ++sc) {
    const long long s0 = static_cast<long long>(sc) * kTfRows;
    const float* cs = ring + (sc & 1) * S::kStage;
    const float* bs = cs + kTfRows * N;
    const float* xs = bs + kTfRows * N;
    const float* dts = xs + kTfRows * kTfCols;
    cp_async_wait<0>();
    __syncthreads();  // the stage, and S from the last sub-chunk, in place
    if (warp == 0) {  // cum = cumsum(dt * a), two positions a lane
      const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
      const float v0 = d0 * av, v1 = v0 + d1 * av;
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += other;
      }
      const float before = incl - v1;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float c0 = before + v0, c1 = before + v1;
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      segdt[2 * lane] = expf(last - c0) * d0;
      segdt[2 * lane + 1] = expf(last - c1) * d1;
    }
    if (sc + 1 < nsub) {
      tf_load<N>(a, bi, gi, hi, pc0, sc + 1, ring + ((sc + 1) & 1) * S::kStage,
                 tid);
    }
    cp_async_commit();
    __syncthreads();  // cum and segdt in place

    // y = e^{cum_i} (C S)_i + (W x)_i, W = G o exp(cum_i - cum_j) o dt_j
    // over the causal 16-column tiles kb <= ym, G = C B^T from the
    // pre-pass (its loads in flight during C S)
    {
      const float* gm = a.gram +
                        ((bi * a.g + gi) * nsub + sc) * (kTfRows * kTfRows);
      float g[4][2][4];
      float acc[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 v = make_float2(0.0f, 0.0f);
            if (kb <= ym)
              v = *reinterpret_cast<const float2*>(
                  gm + (i0 + gr + 8 * r) * kTfRows + 16 * kb + 8 * t + 2 * gc);
            g[kb][t][2 * r] = v.x;
            g[kb][t][2 * r + 1] = v.y;
          }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
      if (sc > 0) {  // y_inter (S is zero before the first sub-chunk)
#pragma unroll 2
        for (int ks = 0; ks < N / 8; ++ks) {
          uint32_t cr[4], ch[4], cl[4];  // C's A fragment, rows i0 .. i0 + 15
          ldsm_x4(smem_addr(cs + swz4<N>(i0 + (mat & 1) * 8 + mrow,
                                         8 * ks + (mat >> 1) * 4)), cr);
          split4(cr, ch, cl);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma3(acc[t], ch, cl, sf[(ks * 8 + (yc0 >> 3) + t) * 32 + lane]);
        }
      }
      const float ci0 = cum[i0 + gr], ci1 = cum[i0 + gr + 8];
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb > ym) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          // W on the tile's keys j0 + 2 gc (+ 1), the causal mask inside
          // the exponent (anticausal differences are positive and
          // overflow); the keys taken in the order 2 gc, 2 gc + 1 make
          // the accumulator the A fragment of W x as it is
          const int j0 = 16 * kb + 8 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 2 * gc + e;
            const float cj = cum[j], dj = dts[j];
            const bool k0 = i0 + gr >= j, k1 = i0 + gr + 8 >= j;
            const float d0 = expf(k0 ? ci0 - cj : 0.0f);
            const float d1 = expf(k1 ? ci1 - cj : 0.0f);
            g[kb][t][e] = k0 ? g[kb][t][e] * d0 * dj : 0.0f;
            g[kb][t][2 + e] = k1 ? g[kb][t][2 + e] * d1 * dj : 0.0f;
          }
          const uint32_t wr[4] = {__float_as_uint(g[kb][t][0]),
                                  __float_as_uint(g[kb][t][2]),
                                  __float_as_uint(g[kb][t][1]),
                                  __float_as_uint(g[kb][t][3])};
          uint32_t wh[4], wl[4];
          split4(wr, wh, wl);
          const int ja = j0 + 2 * gc;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = yc0 + 8 * nt + gr;
            uint32_t xh0, xl0, xh1, xl1;
            split_tf32(xs[swz4<kTfCols>(ja, col)], xh0, xl0);
            split_tf32(xs[swz4<kTfCols>(ja + 1, col)], xh1, xl1);
            mma3(acc[nt], wh, wl, xh0, xh1, xl0, xl1);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = pc0 + yc0 + 8 * t + 2 * gc;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long si = s0 + i0 + gr + 8 * r;
          if (si >= a.s) continue;
          *reinterpret_cast<float2*>(y + bi * a.y_sb + si * a.y_ss +
                                     static_cast<long long>(hi) * a.y_sh + col) =
              make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
        }
      }
    }

    // S <- e^{cum_L} S + B^T (segdt o x) on the warp's rows and columns,
    // the keys in the order 2 gc, 2 gc + 1 (as for W x)
    {
      const float dl = expf(cum[kTfRows - 1]);
#pragma unroll
      for (int t = 0; t < S::kSN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[t][e] *= dl;
#pragma unroll 2
      for (int ks = 0; ks < kTfRows / 8; ++ks) {
        const int ja = 8 * ks + 2 * gc;
        const float sa = segdt[ja], sb = segdt[ja + 1];
        const uint32_t br[4] = {
            __float_as_uint(bs[swz4<N>(ja, n0 + gr)] * sa),
            __float_as_uint(bs[swz4<N>(ja, n0 + gr + 8)] * sa),
            __float_as_uint(bs[swz4<N>(ja + 1, n0 + gr)] * sb),
            __float_as_uint(bs[swz4<N>(ja + 1, n0 + gr + 8)] * sb)};
        uint32_t bh[4], bl[4];
        split4(br, bh, bl);
#pragma unroll
        for (int t = 0; t < S::kSN; ++t) {
          const int col = sc0 + 8 * t + gr;
          uint32_t xh0, xl0, xh1, xl1;
          split_tf32(xs[swz4<kTfCols>(ja, col)], xh0, xl0);
          split_tf32(xs[swz4<kTfCols>(ja + 1, col)], xh1, xl1);
          mma3(sacc[t], bh, bl, xh0, xh1, xl0, xl1);
        }
      }
    }
    __syncthreads();  // S, cum, segdt and this stage are no longer read
    if (sc + 1 < nsub) {
      // S, split once, into the B fragments of the next sub-chunk's C S:
      // element (r, c) goes to k-step r / 8, n-tile c / 8, lane (c % 8) * 4
      // + r % 4, slot r % 8 / 4 (hi) or 2 + r % 8 / 4 (lo)
      float* sfl = reinterpret_cast<float*>(sf);
#pragma unroll
      for (int t = 0; t < S::kSN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n0 + gr + 8 * (e >> 1);
          const int c = sc0 + 8 * t + 2 * gc + (e & 1);
          uint32_t h, l;
          split_tf32(sacc[t][e], h, l);
          const int o = (((r >> 3) * 8 + (c >> 3)) * 32 + (c & 7) * 4 + (r & 3)) * 4 +
                        ((r >> 2) & 1);
          sfl[o] = __uint_as_float(h);
          sfl[o + 2] = __uint_as_float(l);
        }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int L, int P>
int launch(const Params& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(L, a.n, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, L, P><<<dim3(a.h, batch), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_p(const Params& a, int p, int batch, cudaStream_t stream) {
  switch (p) {
    case 32: return launch<T, L, 32>(a, batch, stream);
    case 64: return launch<T, L, 64>(a, batch, stream);
    case 128: return launch<T, L, 128>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_l(const Params& a, int chunk, int p, int batch, cudaStream_t stream) {
  switch (chunk) {
    case 32: return launch_p<T, 32>(a, p, batch, stream);
    case 64: return launch_p<T, 64>(a, p, batch, stream);
    case 128: return launch_p<T, 128>(a, p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int L, int N, int P>
int launch_tc(const Params& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = TcShape<L, N>::kSmem;
  static_assert(smem <= 232448, "ssd_scan_tc: more shared memory than a block has");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc<L, N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_tc<L, N, P><<<dim3(a.h / (kTcCols / P), batch), kTcThreads, smem,
                         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int N>
int launch_tc_p(const Params& a, int p, int batch, cudaStream_t stream) {
  return p == 64 ? launch_tc<L, N, 64>(a, batch, stream)
                 : launch_tc<L, N, 128>(a, batch, stream);
}

template <int L>
int launch_tc_n(const Params& a, int p, int batch, cudaStream_t stream) {
  return a.n == 64 ? launch_tc_p<L, 64>(a, p, batch, stream)
                   : launch_tc_p<L, 128>(a, p, batch, stream);
}

template <int N>
int launch_tf(const Params& a, int p, int batch, cudaStream_t stream) {
  constexpr size_t smem = TfShape<N>::kSmem;
  constexpr size_t gram_smem = 2ull * kTfRows * N * sizeof(float);
  static_assert(smem <= 232448, "ssd_scan_tf32: more shared memory than a block has");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tf32_gram<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gram_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsub = (a.s + kTfRows - 1) / kTfRows;
  ssd_scan_tf32_gram<N><<<dim3(nsub, a.g, batch), kGramThreads, gram_smem,
                          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      ssd_scan_tf32<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_tf32<N><<<dim3(a.h * (p / kTfCols), batch), kTfThreads, smem,
                     stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. chunk in {32, 64, 128},
// p in {32, 64, 128}, h a multiple of g. Returns a cudaError_t.
extern "C" int repro_ssd_scan(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y, int dtype,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int g, int n, int p, int chunk, void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || h <= 0 || g <= 0 || h % g != 0 ||
      n <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a{x, dt, A, B, C, y, x_sb, x_ss, x_sh, dt_sb, dt_ss,
           b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh, s, h, g, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_l<float>(a, chunk, p, batch, st)
                    : launch_l<__nv_bfloat16>(a, chunk, p, batch, st);
}

// ssd_scan_tc: bf16 x, B, C and y; chunk, n and p each 64 or 128; the
// block's 128 / p heads in one group ((h / g) a multiple of 128 / p); x, B
// and C 16-byte aligned with strides of whole 16-byte chunks (8 elements).
// Returns a cudaError_t.
extern "C" int repro_ssd_scan_tc(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int g, int n, int p, int chunk, void* stream) {
  const auto aligned = [](const void* ptr, long long s0, long long s1,
                          long long s2) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 &&
           s1 % 8 == 0 && s2 % 8 == 0;
  };
  if (batch <= 0 || batch > 65535 || s <= 0 || h <= 0 || g <= 0 ||
      h % g != 0 || (p != 64 && p != 128) || (n != 64 && n != 128) ||
      (chunk != 64 && chunk != 128) || (h / g) % (kTcCols / p) != 0 ||
      !aligned(x, x_sb, x_ss, x_sh) || !aligned(B, b_sb, b_ss, b_sg) ||
      !aligned(C, c_sb, c_ss, c_sg) || !aligned(y, y_sb, y_ss, y_sh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a{x, dt, A, B, C, y, x_sb, x_ss, x_sh, dt_sb, dt_ss,
           b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh, s, h, g, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return chunk == 64 ? launch_tc_n<64>(a, p, batch, st)
                     : launch_tc_n<128>(a, p, batch, st);
}

// ssd_scan_tf32: float32 x, B, C and y; n and p each 64 or 128, chunk 32,
// 64 or 128 (the kernel walks sub-chunks of 64 whatever the chunk: the
// scan's result does not depend on it); x, B, C and y 16-byte aligned with strides of whole
// 16-byte chunks (4 floats); gram, scratch of batch * g * ceil(s / 64) *
// 4,096 floats, 16-byte aligned. Two launches: the pre-pass that forms G
// = C B^T, then the scan. Returns a cudaError_t.
extern "C" int repro_ssd_scan_tf32(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y, float* gram,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int g, int n, int p, int chunk, void* stream) {
  const auto aligned = [](const void* ptr, long long s0, long long s1,
                          long long s2) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 4 == 0 &&
           s1 % 4 == 0 && s2 % 4 == 0;
  };
  if (batch <= 0 || batch > 65535 || s <= 0 || h <= 0 || g <= 0 ||
      h % g != 0 || (p != 64 && p != 128) || (n != 64 && n != 128) ||
      (chunk != 32 && chunk != 64 && chunk != 128) ||
      !aligned(x, x_sb, x_ss, x_sh) ||
      !aligned(B, b_sb, b_ss, b_sg) || !aligned(C, c_sb, c_ss, c_sg) ||
      !aligned(y, y_sb, y_ss, y_sh) || gram == nullptr ||
      !aligned(gram, 0, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a{x, dt, A, B, C, y, x_sb, x_ss, x_sh, dt_sb, dt_ss,
           b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh, s, h, g, n,
           gram};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n == 64 ? launch_tf<64>(a, p, batch, st)
                 : launch_tf<128>(a, p, batch, st);
}

extern "C" const char* repro_ssd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
