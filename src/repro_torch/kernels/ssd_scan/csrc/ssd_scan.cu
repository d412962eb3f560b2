// Mamba-2 chunked SSD scan for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// _ssd_kernel (:31), reached through ssd_scan_bh (:77, the pallas_call at
// :86). For each (batch, head) a state S (n x p, float32) is carried across
// chunks of L positions; for each chunk, with cum = cumsum(dt * a),
//
//   y   = [(C B^T) o exp(cum_i - cum_j)|causal o dt_j] x + (e^{cum} o C) S
//   S  <- e^{cum_L} S + B^T (e^{cum_L - cum} dt o x)
//
// B and C are grouped: head h reads group h / (H / G). All arithmetic is
// float32; x, B, C and y are float32 or bf16, dt and A float32.
//
// What bounds it. At mamba2-1.3b's shape (L 128, n 128, p 64) a chunk is
// about 4 M multiply-adds on 80 KB of inputs: operations, not bytes.
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
// bit-identical. Later work: bf16 tensor-core products, several heads of
// a group per block so B and C are read once, double-buffered loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" const char* repro_ssd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
