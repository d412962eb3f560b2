// Row-wise fused log-density reductions for the flat-buffer log-joint.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/fused_logpdf/kernel.py:
//   std_normal_sum       <- _std_normal_kernel (:54) / std_normal_sum_2d (:266)
//   bernoulli_logit_sum  <- _bernoulli_logit_kernel (:97) / bernoulli_logit_sum_2d (:283)
//   categorical_logits_sum <- _categorical_kernel (:120) / categorical_sum_2d (:343)
//   gamma_unnorm_sum     <- _gamma_kernel (:154) / gamma_sum_2d (:292)
//   normal_sum           <- _normal_kernel (:75) / normal_sum_2d (:274)
//   beta_unnorm_sum      <- _beta_kernel (:174) / beta_sum_2d (:301)
//   student_t_unnorm_sum <- _student_t_kernel (:194) / student_t_sum_2d (:310)
// (mvn_quadform_sum, the dense quadratic form, is in mvn_quad.cu.)
//
// What each computes, for every row b of a (B, n) float32 input:
//   std_normal_sum:      out[b] = sum_i (-z_i^2 / 2 - log(2 pi) / 2)
//   bernoulli_logit_sum: out[b] = sum_i (-softplus(-l_i) - (1 - y_i) l_i)
//   gamma_unnorm_sum:    out[b] = sum_i (am1_i log x_i - rate_i x_i)
//   normal_sum:          out[b] = sum_i (-z_i^2 / 2 - log sig_i - log(2 pi) / 2),
//                        z_i = (x_i - mu_i) / sig_i
//   beta_unnorm_sum:     out[b] = sum_i (am1_i log x_i + bm1_i log1p(-x_i))
//   student_t_unnorm_sum: out[b] = sum_i (-(df_i + 1) / 2 log1p(z_i^2 / df_i))
// and, for (B, n, C) float32 logits with int32 labels (B, n):
//   categorical_logits_sum: out[b] = sum_i (l_i[y_i] - logsumexp_c l_i[c])
// The B rows are HMC chains: torch.func.vmap over the chain axis hands the
// whole batch to one launch. Each input carries its own row stride; a
// stride of 0 reads one shared row for every b (logreg's observed y), so
// unbatched data is never copied per chain. The normal, beta and student_t
// kernels also take an element stride per input, 0 or 1: gauss_unknown's
// per-array route hands normal_sum the shared data x (row stride 0) and
// one mu and one sigma per chain (element stride 0), so neither the data
// nor the parameters are materialised as 4 x 10,000 arrays. The TPU
// kernels pad x with 0.5 (beta), df and sigma with 1 to keep the padded
// lanes finite; here the ragged end is masked by index and never read.
//
// What bounds them on an H100: bytes. Each element is read once and costs
// a handful of flops (bernoulli adds one expf and one log1pf, categorical
// one expf per class, normal a divide and a logf, beta a logf and a log1pf,
// student_t a divide and a log1pf), far below the ~20 flops per byte where float32
// arithmetic would be the limit. At most of the main paths' shapes
// (4 x 101, 4 x 10,000, 4 x 40,000; hier_poisson's gamma block is 4 x 1,
// family_mix_8k's beta and student_t blocks 4 x 1,024 and 4 x 2,048,
// gauss_unknown's normal 4 x 10,000 of which it reads 10,000 + 8 floats)
// the data is bytes to hundreds of KB, so the time is launch latency, not
// bandwidth; lda's categorical block (4 x 10,176 x 100, 16 MB) and mamba2
// scoring's (8,192 x 50,280, 1.65 GB) are the ones that reach the
// bandwidth. Beta's logf and log1pf and student_t's
// divide and log1pf are some dozens of instructions an element in
// software: where a row is one block, the SM that holds it issues them
// all, which adds 0.3-0.9 us to one launch at 4 x 1,024 and 4 x 2,048,
// and at 4 x 40,000 beta takes 1.1 us more than std_normal on the same
// grid (chip_compare.py, H100 80GB HBM3 at 700 W), far above the bytes.
//
// Design. The TPU kernel walks an (R, 128) tiling of the input in a
// sequential grid and carries a VMEM accumulator from step to step. Hopper
// runs blocks in parallel in no order, so nothing carries over between
// blocks. Every family but the small-C categorical takes ONE launch a call:
// the blocks of a row each sum a fixed share, and the last block of the
// row to finish merges the shares in index order (finish_row). There are
// no float atomics, and every thread's share of the work is a function of
// the plan (from n, C and the addresses alone), so two runs give
// bit-identical sums.
//
// std_normal_sum (TPU: kernel.py:54 / :266), gamma_unnorm_sum (:154 /
// :292), beta_unnorm_sum (:174 / :301), student_t_unnorm_sum (:194 /
// :310), normal_sum (:75 / :274) and bernoulli_logit_sum (:97 / :283) are
// row_sum. At the main paths' shapes (std_normal 4 x 11, 4 x 101, 4 x 400;
// hier_poisson's gamma 4 x 1; mixed's beta 4 x 1 and student_t 4 x 8;
// family_mix_8k's 4 x 1,024 and 4 x 2,048; gauss_unknown's normal 4 x
// 10,000 of shared data, 40 KB; logreg's bernoulli 4 x 10,000 with y
// shared) their bytes take 0.00001-0.06 us at 3.35
// TB/s, so what bounds them on this card is one launch's latency; bytes
// bound them only past about a megabyte (4 x 40,000 is 0.64-0.96 MB, 0.19-0.29 us). A
// second launch per call (a finishing kernel) doubled the launch floor, so here:
//   - a block's share of a row is 2,048 floats a round: 256 threads with
//     two 16-byte loads each (8 KB) in flight at once, about one round trip
//     to L2 (~0.3-0.5 us; more from HBM). A merge across blocks costs a
//     store, an acq_rel atomic and an L2 read of the partials, more than a
//     round, so a row of at most 2,048 floats is one block (grid (1, B))
//     that writes out[b] itself: no partials, no count.
//   - a longer row is cut into ceil(n / 2,048) parts (at most 1,024, in
//     rounds beyond), one block each; at 1 x 1,000,003 that is 489 blocks
//     with 4 MB in flight, above the ~2.3 MB that 3.35 TB/s at ~0.7 us of
//     latency needs. Each block writes partials[b, p] and takes a ticket
//     from an int count of row b (one atom.acq_rel); the block that draws
//     nparts - 1 sums the row's partials in index order, writes out[b] and
//     resets the count to 0 (mvn_quad.cu's pattern). No float atomics, a
//     fixed order. Against shares of 4,096 and 1,024 floats (chip_compare.py
//     on an H100 80GB HBM3 at 700 W), 2,048 is the fastest at 4 x 40,000
//     (std_normal 2.72 us; 2.77 and 2.91; gamma 3.27; 4.2-4.5 and 3.39);
//     4,096 is faster at 1 x 1,000,003 (3.37 against 3.64) and 1,024 by
//     0.02-0.14 us at the main paths' short rows.
//   - loads are 16 bytes when every input's row starts are 16-byte aligned
//     (base aligned, row stride a multiple of 4 floats or 0), else scalar
//     (a z[:, 1:] view, n = 101). Normal's, beta's, student_t's and
//     bernoulli's inputs
//     each have an element stride of 0 or 1. An element-stride-0 input is
//     one value a row (a per-chain scalar under vmap: row stride 1, as
//     gauss_unknown's mu and sigma on the switch route); each thread
//     reads it once, before its loop, it stands for all four lanes of a
//     vector and it never takes a 16-byte load, so only the dense inputs
//     decide the load width. Its flag is uniform over the grid, so the
//     branch on it does not diverge. (A template flag per input instead,
//     28 row_sum instances against 8 and a 31 % larger library, ran
//     0.2 us faster on one-value-a-row parameters and 0.07 us slower to
//     0.08 us faster on the main paths' shared rows: chip_compare.py on
//     an H100 80GB HBM3 at 700 W.) The caller (ops.reduce_plan) picks
//     parts and width from n and the addresses, so reruns are
//     bit-identical; the two load widths sum in different orders, each
//     fixed.
// The wrapper keeps `partials` and the counts once per (device, stream),
// so a call allocates only `out`.
//
// categorical_logits_sum (TPU: kernel.py:120 / :343) reduces over items,
// not elements. Above 256 classes (the LM vocabularies, 49,152 and 50,280)
// categorical_sum gives each item (b, i) one warp and reads each logit
// ONCE: a lane keeps a running (m, s = sum exp(l - m)) over the
// classes it loads, rescaling s when its max grows, and the lanes merge
// their pairs by an xor butterfly in a fixed order. The design it replaces
// read each item twice (a max pass, then the sum of exp "from L1"): at
// 50,280 classes an item is 201 KB and a block had 8 items in flight,
// 1.6 MB, where an SM's L1 holds at most 256 KB, so the second pass went
// back to L2 and HBM. Two reads of mamba2 scoring's 1.65 GB take at least
// 983.6 us at 3.35 TB/s, one read 491.8 us. Loads are 16 bytes (two a lane
// a round, eight logits) when every item starts 16-byte aligned (C a
// multiple of 4, base aligned: both LM vocabularies), else 4 bytes
// (eight a lane a round); either way a warp's loads are coalesced, 1 KB a
// warp a round, and 8,192 items are 1,024 blocks, every item in flight at
// once. At 8,192 x 50,280 it takes 533 us, 92 % of the one-read bound,
// where the two-pass design took 1,240 (chip_compare.py on an H100 80GB
// HBM3 at 700 W). The label's logit stays with the lane that loaded it. Items are cut into ceil(n / items a block) parts (at most
// 1,024, rounds beyond) and merged as row_sum's, in one launch. At most
// 256 classes (lda's 100, hmm_semisup's 5 and 20) a warp an item would idle
// most lanes, so categorical_small_partials gives each item a group of 4
// to 32 lanes and reads the row once into registers, several items in
// flight per warp, then finish_rows (a second launch) sums the blocks; its
// time at lda's 4 x 10,176 x 100 (16.3 MB) is bound by those bytes. The
// edges follow log_softmax's own arithmetic: a label outside [0, C) gives
// NaN, a -inf logit adds exp(-inf) = 0, a row of -inf logits gives NaN
// (-inf - -inf), and a +inf or NaN logit gives NaN.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// C <= 256 classes: a group of GS lanes (4 up to C = 32, then 8, 16 and
// 32: at most 8 classes a lane) serves one item, so a warp has 32 / GS
// items in flight. The row is read once into registers and each class's
// exp is taken once. The order of the sum is log_softmax's own on the card
// (ATen's softmax_warp_forward for rows of at most 1,024 classes): "torch
// lane" j of WS = min(NP2, 32) lanes (NP2 the power of two >= C) sums the
// classes j, j + WS, ... in order, then an xor butterfly over the WS lanes.
// Real lane s holds torch lanes s, s + GS, ... and takes the butterfly's
// steps of offset >= GS in its registers, the rest by shuffles inside the
// group; so every item's term equals the plain version's bit for bit,
// which the rtol 1e-6 gate needs at one item (where l[y] - m - log s
// cancels). Loads are 4 bytes, strided by lane: coalesced over a group
// (16-byte loads would give each lane 4 adjacent classes, not torch's
// order). Same edges as categorical_sum.
template <int NP2>
__global__ void __launch_bounds__(kThreads)
categorical_small_partials(const float* __restrict__ logits,
                           long long l_row_stride,
                           const int* __restrict__ labels,
                           long long y_row_stride, long long n, int c,
                           float* __restrict__ partials) {
  constexpr int WS = NP2 < 32 ? NP2 : 32;     // torch's lanes
  constexpr int IT = NP2 / WS;                // classes a torch lane sums
  constexpr int GS = NP2 <= 32 ? 4 : NP2 / 8; // lanes an item
  constexpr int KJ = WS >= GS ? WS / GS : 1;  // torch lanes a real lane
  constexpr int kGroups = kThreads / GS;      // items a block has in flight
  constexpr unsigned kAll = 0xffffffffu;
  const float* lrow = logits + static_cast<long long>(blockIdx.y) * l_row_stride;
  const int* yrow = labels + static_cast<long long>(blockIdx.y) * y_row_stride;
  const int lane = threadIdx.x & 31;
  const int sub = lane % GS;
  const int gbase = lane - sub;               // the group's first lane
  const long long step = static_cast<long long>(gridDim.x) * kGroups;
  float acc = 0.0f;
  // the loop bound is uniform over a warp (its groups start together), so
  // every lane reaches the shuffles; an item past n adds nothing
  const long long first = static_cast<long long>(blockIdx.x) * kGroups +
                          (threadIdx.x - lane) / GS;
  for (long long i0 = first; i0 < n; i0 += step) {
    const long long i = i0 + lane / GS;
    const bool real = i < n;
    const float* item = lrow + (real ? i : 0) * c;
    const int y = real ? yrow[i] : -1;
    float x[KJ][IT];
    bool mine = false;  // this lane holds class y
#pragma unroll
    for (int k = 0; k < KJ; ++k) {
      const int j = sub + GS * k;
#pragma unroll
      for (int t = 0; t < IT; ++t) {
        const int cls = j + WS * t;
        const bool in = j < WS && cls < c;
        x[k][t] = in ? item[cls] : -INFINITY;
        mine = mine || (in && cls == y);
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < KJ; ++k)
#pragma unroll
      for (int t = 0; t < IT; ++t) m = m > x[k][t] ? m : x[k][t];
#pragma unroll
    for (int off = 1; off < GS; off <<= 1) {
      const float o = __shfl_xor_sync(kAll, m, off);
      m = m > o ? m : o;
    }
    float sum[KJ], picked = 0.0f;
#pragma unroll
    for (int k = 0; k < KJ; ++k) {
      sum[k] = 0.0f;
#pragma unroll
      for (int t = 0; t < IT; ++t) {
        sum[k] += expf(x[k][t] - m);
        if (sub + GS * k + WS * t == y) picked = x[k][t];
      }
    }
    // the butterfly: offsets >= GS pair torch lanes held by this lane
#pragma unroll
    for (int off = WS / 2; off >= GS; off >>= 1) {
      float nxt[KJ];
#pragma unroll
      for (int k = 0; k < KJ; ++k) nxt[k] = sum[k] + sum[k ^ (off / GS)];
#pragma unroll
      for (int k = 0; k < KJ; ++k) sum[k] = nxt[k];
    }
    float s = sum[0];
#pragma unroll
    for (int off = (WS < GS ? WS : GS) / 2; off > 0; off >>= 1)
      s = s + __shfl_xor_sync(kAll, s, off);
    // the group's lane holding class y (none when y is outside [0, C))
    const unsigned holders = __ballot_sync(kAll, mine) >> gbase;
    const unsigned own = GS == 32 ? holders : holders & ((1u << GS) - 1u);
    picked = __shfl_sync(kAll, picked, gbase + (own ? __ffs(own) - 1 : 0));
    if (sub == 0 && real) {
      const bool valid = y >= 0 && y < c;
      // log_softmax's order: (l[y] - m) - log s
      acc += valid ? (picked - m) - logf(s) : __int_as_float(0x7fc00000);
    }
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

// ---- the one-launch reductions (row_sum) ----------------------------
// A block's share of a row in one round: 256 threads x 8 floats, two
// 16-byte loads a thread (eight 4-byte ones on the scalar path), all
// issued before the first add.
constexpr int kLoads = 2;
constexpr int kShare = kThreads * 4 * kLoads;  // 2,048 floats
constexpr int kMaxShareParts = 1024;           // blocks a row; rounds beyond
// categorical_sum: one warp an item, so a block has 8 in flight (ops.py
// CAT_ITEMS)
constexpr int kCatItems = kThreads / 32;

// The terms of one family. at(b) is row b as one thread reads it; its
// one(i) is the term of element i, its four(j) the terms of 16-byte vector
// j (elements 4j .. 4j + 3), summed in that order.
struct StdNormalRow {
  const float* z;
  long long zs;
  struct At {
    const float* z;
    __device__ __forceinline__ float one(long long i) const {
      return std_normal_term(__ldg(z + i));
    }
    __device__ __forceinline__ float four(long long j) const {
      const float4 v = __ldg(reinterpret_cast<const float4*>(z) + j);
      float s = std_normal_term(v.x);
      s += std_normal_term(v.y);
      s += std_normal_term(v.z);
      s += std_normal_term(v.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const { return {z + b * zs}; }
};

// am1 log x - rate x; x <= 0 gives what logf gives (-inf at 0, NaN below)
__device__ __forceinline__ float gamma_term(float am1, float x, float rate) {
  return am1 * logf(x) - rate * x;
}

struct GammaRow {
  const float* x;
  long long xs;
  const float* am1;
  long long as;
  const float* rate;
  long long rs;
  struct At {
    const float* x;
    const float* am1;
    const float* rate;
    __device__ __forceinline__ float one(long long i) const {
      return gamma_term(__ldg(am1 + i), __ldg(x + i), __ldg(rate + i));
    }
    __device__ __forceinline__ float four(long long j) const {
      using V = const float4*;
      const float4 xv = __ldg(reinterpret_cast<V>(x) + j);
      const float4 av = __ldg(reinterpret_cast<V>(am1) + j);
      const float4 rv = __ldg(reinterpret_cast<V>(rate) + j);
      float s = gamma_term(av.x, xv.x, rv.x);
      s += gamma_term(av.y, xv.y, rv.y);
      s += gamma_term(av.z, xv.z, rv.z);
      s += gamma_term(av.w, xv.w, rv.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const {
    return {x + b * xs, am1 + b * as, rate + b * rs};
  }
};

// One input of normal_sum, beta_unnorm_sum and student_t_unnorm_sum: base,
// row stride,
// and whether its elements are dense (element stride 1) or one value a row
// (element stride 0). The flag is the same for every thread of the grid.
struct Elem {
  const float* p;
  long long rs;
  bool dense;
  // row b: its start, or its one value, read once
  struct At {
    const float* p;
    float v;
    bool dense;
    __device__ __forceinline__ float one(long long i) const {
      return dense ? __ldg(p + i) : v;
    }
    __device__ __forceinline__ float4 four(long long j) const {
      return dense ? __ldg(reinterpret_cast<const float4*>(p) + j)
                   : make_float4(v, v, v, v);
    }
  };
  __device__ __forceinline__ At at(int b) const {
    const float* row = p + b * rs;
    return {row, dense ? 0.0f : __ldg(row), dense};
  }
};

// am1 log x + bm1 log1p(-x); x outside (0, 1) gives what logf and log1pf
// give (-inf at the ends, NaN beyond)
__device__ __forceinline__ float beta_term(float x, float am1, float bm1) {
  return am1 * logf(x) + bm1 * log1pf(-x);
}

struct BetaRow {
  Elem x, am1, bm1;
  struct At {
    Elem::At x, am1, bm1;
    __device__ __forceinline__ float one(long long i) const {
      return beta_term(x.one(i), am1.one(i), bm1.one(i));
    }
    __device__ __forceinline__ float four(long long j) const {
      const float4 xv = x.four(j), av = am1.four(j), bv = bm1.four(j);
      float s = beta_term(xv.x, av.x, bv.x);
      s += beta_term(xv.y, av.y, bv.y);
      s += beta_term(xv.z, av.z, bv.z);
      s += beta_term(xv.w, av.w, bv.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const {
    return {x.at(b), am1.at(b), bm1.at(b)};
  }
};

// -(df + 1) / 2 log1p(z^2 / df)
__device__ __forceinline__ float student_t_term(float z, float df) {
  return -0.5f * (df + 1.0f) * log1pf(z * z / df);
}

struct StudentTRow {
  Elem z, df;
  struct At {
    Elem::At z, df;
    __device__ __forceinline__ float one(long long i) const {
      return student_t_term(z.one(i), df.one(i));
    }
    __device__ __forceinline__ float four(long long j) const {
      const float4 zv = z.four(j), dv = df.four(j);
      float s = student_t_term(zv.x, dv.x);
      s += student_t_term(zv.y, dv.y);
      s += student_t_term(zv.z, dv.z);
      s += student_t_term(zv.w, dv.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const { return {z.at(b), df.at(b)}; }
};

// (-z^2 / 2 - log s) - log(2 pi) / 2 with z = (x - mu) / s, in this order
__device__ __forceinline__ float normal_term(float x, float mu, float s) {
  const float z = (x - mu) / s;
  return (-0.5f * z * z - logf(s)) - kHalfLog2Pi;
}

struct NormalRow {
  Elem x, mu, sig;
  struct At {
    Elem::At x, mu, sig;
    __device__ __forceinline__ float one(long long i) const {
      return normal_term(x.one(i), mu.one(i), sig.one(i));
    }
    __device__ __forceinline__ float four(long long j) const {
      const float4 xv = x.four(j), mv = mu.four(j), sv = sig.four(j);
      float s = normal_term(xv.x, mv.x, sv.x);
      s += normal_term(xv.y, mv.y, sv.y);
      s += normal_term(xv.z, mv.z, sv.z);
      s += normal_term(xv.w, mv.w, sv.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const {
    return {x.at(b), mu.at(b), sig.at(b)};
  }
};

// -softplus(-l) - (1 - y) l, with l and y each one value a row or dense
struct BernoulliRow {
  Elem l, y;
  struct At {
    Elem::At l, y;
    __device__ __forceinline__ float one(long long i) const {
      return bernoulli_logit_term(l.one(i), y.one(i));
    }
    __device__ __forceinline__ float four(long long j) const {
      const float4 lv = l.four(j), yv = y.four(j);
      float s = bernoulli_logit_term(lv.x, yv.x);
      s += bernoulli_logit_term(lv.y, yv.y);
      s += bernoulli_logit_term(lv.z, yv.z);
      s += bernoulli_logit_term(lv.w, yv.w);
      return s;
    }
  };
  __device__ __forceinline__ At at(int b) const { return {l.at(b), y.at(b)}; }
};

// The end of a block of grid (nparts, rows) that holds `acc`, its sum of
// row b (valid in thread 0): with one part it writes out[b] itself.
// Otherwise it writes partials[b, p], and the block that draws the last
// ticket of counts[b] sums the row's partials in index order, writes out[b]
// and sets the count back to 0.
__device__ __forceinline__ void finish_row(float acc, int b, float* partials,
                                           int* counts, float* __restrict__ out) {
  __shared__ bool merge_last;
  const int parts = gridDim.x;
  if (parts == 1) {
    if (threadIdx.x == 0) out[b] = acc;
    return;
  }
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(b) * parts + blockIdx.x] = acc;
    // release this block's partial, acquire the others' (one atom.acq_rel;
    // two __threadfence() around a plain atomicAdd took 0.3-0.5 us more at
    // 4 x 40,000 and 1 x 1,000,003)
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(counts[b]);
    merge_last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == parts - 1;
  }
  __syncthreads();
  if (!merge_last) return;
  const float* prow = partials + static_cast<long long>(b) * parts;
  float total = 0.0f;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    total += __ldcg(prow + i);
  }
  total = block_sum(total);
  if (threadIdx.x == 0) {
    out[b] = total;
    counts[b] = 0;
  }
}

// Grid (nparts, rows). Block (p, b) sums its shares of row b, rounds p,
// p + nparts, ..., then finish_row merges the row.
template <bool kVec, class Row>
__global__ void __launch_bounds__(kThreads)
row_sum(Row row, long long n, float* partials, int* counts,
        float* __restrict__ out) {
  constexpr int kPer = kVec ? kLoads : 4 * kLoads;
  const int b = blockIdx.y;
  const int parts = gridDim.x;
  const auto r = row.at(b);
  float acc = 0.0f;
  for (long long base = static_cast<long long>(blockIdx.x) * kShare; base < n;
       base += static_cast<long long>(parts) * kShare) {
    float part[kPer];
    if constexpr (kVec) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long j = (base >> 2) + threadIdx.x + k * kThreads;
        part[k] = j < (n >> 2) ? r.four(j) : 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long i = base + threadIdx.x + k * kThreads;
        part[k] = i < n ? r.one(i) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc += part[k];
  }
  if (kVec && blockIdx.x == 0 && threadIdx.x == 0) {
    // the 0-3 floats past the last whole vector
    for (long long i = n & ~3LL; i < n; ++i) acc += r.one(i);
  }
  finish_row(block_sum(acc), b, partials, counts, out);
}

// ---- categorical_logits_sum above 256 classes -----------------------
// A running (m, s) of one lane, s = sum exp(l - m) over the classes it has
// read: fold in eight more logits x. Exponents are taken against
// base = m' (m' the new max), or 0 while m' is -inf (every logit so far
// -inf: each adds exp(-inf) = 0, not exp(-inf - -inf) = NaN). A +inf logit
// makes m' = +inf and exp(+inf - +inf) = NaN, as log_softmax gives; a NaN
// logit adds exp(NaN) (fmaxf drops it from the max, not from the sum).
// s is rescaled only when the max grows, by exp(m - base) (0 when m was
// -inf); the eight terms are summed as a tree, then added.
__device__ __forceinline__ void online_fold(float& m, float& s, const float (&x)[8]) {
  float cm = x[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) cm = fmaxf(cm, x[k]);
  const float mm = fmaxf(m, cm);
  const float base = mm == -INFINITY ? 0.0f : mm;
  float e[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = expf(x[k] - base);
  const float t = ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]));
  if (mm > m) s *= expf(m - base);
  s += t;
  m = mm;
}

// Merge another lane's (om, os) into (m, s): the same two products in
// either lane, so both hold the same bits after a butterfly step.
__device__ __forceinline__ void online_merge(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  const float base = mm == -INFINITY ? 0.0f : mm;
  s = __fmul_rn(s, expf(m - base)) + __fmul_rn(os, expf(om - base));
  m = mm;
}

// Element r of v, by selects (an index into a register array would put the
// array in local memory)
__device__ __forceinline__ float lane_of(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Grid (nparts, rows); warp w of block p serves items p * 8 + w,
// (p + nparts) * 8 + w, ... Lane t reads the classes (vectors of 4 with
// kVec) t, t + 32, t + 64, ..., eight a round in two 16-byte loads (eight
// 4-byte ones otherwise), each once, into its running (m, s); the lane
// whose stride holds class y keeps l[y]. Lanes merge by an xor butterfly;
// lane 0 adds (l[y] - m) - log s to its sum, which finish_row merges as
// row_sum's. (Four and eight warps an item, merging through shared memory,
// took 601-603 and 533-534 us against this layout's 533-535 at 8,192 x
// 50,280: chip_compare.py on an H100 80GB HBM3 at 700 W.)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
categorical_sum(const float* __restrict__ logits, long long l_row_stride,
                const int* __restrict__ labels, long long y_row_stride,
                long long n, int c, float* partials, int* counts,
                float* __restrict__ out) {
  constexpr unsigned kAll = 0xffffffffu;
  const int b = blockIdx.y;
  const float* lrow = logits + static_cast<long long>(b) * l_row_stride;
  const int* yrow = labels + static_cast<long long>(b) * y_row_stride;
  const int t = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kCatItems;
  float acc = 0.0f;
  // the loop bound is uniform over the block, so every lane reaches the
  // shuffles; an item past n adds nothing
  for (long long i0 = static_cast<long long>(blockIdx.x) * kCatItems; i0 < n;
       i0 += step) {
    const long long i = i0 + (threadIdx.x >> 5);
    const bool real = i < n;
    const float* item = lrow + (real ? i : 0) * static_cast<long long>(c);
    const int y = real ? __ldg(yrow + i) : -1;
    float m = -INFINITY, s = 0.0f, picked = 0.0f;
    if constexpr (kVec) {
      const float4* v = reinterpret_cast<const float4*>(item);
      const int nv = real ? c >> 2 : 0;
      for (int j = t; j < nv; j += 64) {
        const int j2 = j + 32;
        const float4 a = __ldg(v + j);
        const float4 q = j2 < nv ? __ldg(v + j2)
                                 : make_float4(-INFINITY, -INFINITY,
                                               -INFINITY, -INFINITY);
        const float x[8] = {a.x, a.y, a.z, a.w, q.x, q.y, q.z, q.w};
        if ((y >> 2) == j) picked = lane_of(a, y & 3);
        if ((y >> 2) == j2) picked = lane_of(q, y & 3);
        online_fold(m, s, x);
      }
    } else {
      const int nc = real ? c : 0;
      for (int k = t; k < nc; k += 256) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int cls = k + u * 32;
          x[u] = cls < nc ? __ldg(item + cls) : -INFINITY;
          if (cls == y) picked = x[u];
        }
        online_fold(m, s, x);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kAll, m, off);
      const float os = __shfl_xor_sync(kAll, s, off);
      online_merge(m, s, om, os);
    }
    const bool valid = y >= 0 && y < c;
    picked = __shfl_sync(kAll, picked, valid ? (kVec ? y >> 2 : y) & 31 : 0);
    if (t == 0 && real) {
      // log_softmax's order: (l[y] - m) - log s
      acc += valid ? (picked - m) - logf(s) : __int_as_float(0x7fc00000);
    }
  }
  finish_row(block_sum(acc), b, partials, counts, out);
}

int share_parts(long long n) {
  const long long p = (n + kShare - 1) / kShare;
  return static_cast<int>(p < kMaxShareParts ? p : kMaxShareParts);
}

// 16-byte loads need every row start 16-byte aligned: the base and a row
// stride of a multiple of 4 floats (0 included)
bool aligned16(const float* p, long long row_stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_stride % 4 == 0;
}

template <class Row>
int launch_row_sum(const Row& row, bool vec, int rows, long long n,
                   int nparts, float* partials, int* counts, float* out,
                   void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || nparts != share_parts(n) ||
      (nparts > 1 && (partials == nullptr || counts == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nparts, rows);
  if (vec) {
    row_sum<true><<<grid, kThreads, 0, s>>>(row, n, partials, counts, out);
  } else {
    row_sum<false><<<grid, kThreads, 0, s>>>(row, n, partials, counts, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// An input of normal_sum, beta_unnorm_sum, student_t_unnorm_sum or
// bernoulli_logit_sum: an element stride of 0 or 1, and, with 16-byte loads, a dense one starting every row
// 16-byte aligned (a one-value-a-row input takes no vector load)
bool elem_ok(const float* p, long long rs, long long es, bool vec) {
  return (es == 0 || es == 1) && (!vec || es == 0 || aligned16(p, rs));
}

bool bad_shape(int rows, long long n, int nparts) {
  return rows <= 0 || rows > 65535 || n <= 0 || nparts <= 0 || nparts > 65535;
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = success);
// launches go on the caller's stream and do not synchronise. `out` holds
// rows floats, allocated by the caller, as is every scratch buffer.

// std_normal_sum, gamma_unnorm_sum, beta_unnorm_sum, student_t_unnorm_sum,
// normal_sum and bernoulli_logit_sum: one launch. nparts must be
// ceil(n / 2048) capped at 1024 (ops.reduce_plan); with one part
// `partials` and `counts` may be null, else `partials` holds rows * nparts
// floats and `counts` rows ints that are zero (the kernel leaves them
// zero). `vec` asks for 16-byte loads: every input 16-byte aligned with a
// row stride of a multiple of 4 floats, or the call is refused.
extern "C" int repro_std_normal_sum(const float* z, long long z_row_stride,
                                    int rows, long long n, int nparts, int vec,
                                    float* partials, int* counts, float* out,
                                    void* stream) {
  if (vec && !aligned16(z, z_row_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(StdNormalRow{z, z_row_stride}, vec != 0, rows, n,
                        nparts, partials, counts, out, stream);
}

extern "C" int repro_gamma_unnorm_sum(const float* x, long long x_row_stride,
                                     const float* am1, long long a_row_stride,
                                     const float* rate, long long r_row_stride,
                                     int rows, long long n, int nparts,
                                     int vec, float* partials, int* counts,
                                     float* out, void* stream) {
  if (vec && !(aligned16(x, x_row_stride) && aligned16(am1, a_row_stride) &&
               aligned16(rate, r_row_stride))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(
      GammaRow{x, x_row_stride, am1, a_row_stride, rate, r_row_stride},
      vec != 0, rows, n, nparts, partials, counts, out, stream);
}

// Beta, student_t, normal and bernoulli take (pointer, row stride, element
// stride) for each input; an element stride is 0 (one value a row) or 1.
extern "C" int repro_beta_unnorm_sum(const float* x, long long x_rs, long long x_es,
                                     const float* am1, long long a_rs, long long a_es,
                                     const float* bm1, long long b_rs, long long b_es,
                                     int rows, long long n, int nparts, int vec,
                                     float* partials, int* counts, float* out,
                                     void* stream) {
  if (!(elem_ok(x, x_rs, x_es, vec) && elem_ok(am1, a_rs, a_es, vec) &&
        elem_ok(bm1, b_rs, b_es, vec))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(BetaRow{{x, x_rs, x_es == 1}, {am1, a_rs, a_es == 1},
                                {bm1, b_rs, b_es == 1}},
                        vec != 0, rows, n, nparts, partials, counts, out, stream);
}

extern "C" int repro_student_t_unnorm_sum(const float* z, long long z_rs,
                                          long long z_es, const float* df,
                                          long long d_rs, long long d_es,
                                          int rows, long long n, int nparts,
                                          int vec, float* partials, int* counts,
                                          float* out, void* stream) {
  if (!(elem_ok(z, z_rs, z_es, vec) && elem_ok(df, d_rs, d_es, vec))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(StudentTRow{{z, z_rs, z_es == 1}, {df, d_rs, d_es == 1}},
                        vec != 0, rows, n, nparts, partials, counts, out, stream);
}

extern "C" int repro_normal_sum(const float* x, long long x_rs, long long x_es,
                                const float* mu, long long m_rs, long long m_es,
                                const float* sig, long long s_rs, long long s_es,
                                int rows, long long n, int nparts, int vec,
                                float* partials, int* counts, float* out,
                                void* stream) {
  if (!(elem_ok(x, x_rs, x_es, vec) && elem_ok(mu, m_rs, m_es, vec) &&
        elem_ok(sig, s_rs, s_es, vec))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(NormalRow{{x, x_rs, x_es == 1}, {mu, m_rs, m_es == 1},
                                  {sig, s_rs, s_es == 1}},
                        vec != 0, rows, n, nparts, partials, counts, out, stream);
}

extern "C" int repro_bernoulli_logit_sum(const float* l, long long l_rs, long long l_es,
                                         const float* y, long long y_rs, long long y_es,
                                         int rows, long long n, int nparts, int vec,
                                         float* partials, int* counts, float* out,
                                         void* stream) {
  if (!(elem_ok(l, l_rs, l_es, vec) && elem_ok(y, y_rs, y_es, vec))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row_sum(BernoulliRow{{l, l_rs, l_es == 1}, {y, y_rs, y_es == 1}},
                        vec != 0, rows, n, nparts, partials, counts, out, stream);
}

// categorical_logits_sum (any C; ops.py sends it C > 256): one launch.
// logits (rows, n, c) with the class axis dense and items c apart; labels
// (rows, n) with the item axis dense; row strides may be 0 (shared).
// nparts must be ceil(n / items a block) capped at 1024
// (ops.categorical_plan), with scratch as for the one-launch reductions;
// `vec` asks for 16-byte loads: c a multiple of 4 and the logits 16-byte
// aligned with a row stride of a multiple of 4 floats, or the call is
// refused.
extern "C" int repro_categorical_logits_sum(const float* logits,
                                            long long l_row_stride,
                                            const int* labels,
                                            long long y_row_stride, int rows,
                                            long long n, int c, int nparts,
                                            int vec, float* partials,
                                            int* counts, float* out,
                                            void* stream) {
  const long long want = (n + kCatItems - 1) / kCatItems;
  if (rows <= 0 || rows > 65535 || n <= 0 || c <= 0 ||
      nparts != (want < kMaxShareParts ? want : kMaxShareParts) ||
      (nparts > 1 && (partials == nullptr || counts == nullptr)) ||
      (vec && (c % 4 != 0 || !aligned16(logits, l_row_stride)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nparts, rows);
  if (vec) {
    categorical_sum<true><<<grid, kThreads, 0, s>>>(
        logits, l_row_stride, labels, y_row_stride, n, c, partials, counts, out);
  } else {
    categorical_sum<false><<<grid, kThreads, 0, s>>>(
        logits, l_row_stride, labels, y_row_stride, n, c, partials, counts, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The C <= 256 path, stage 1 then finish_rows; `partials` holds rows *
// nparts floats. `group` is the lanes an item takes (ops.py
// categorical_group), checked against the kernel's own choice.
extern "C" int repro_categorical_logits_sum_small(
    const float* logits, long long l_row_stride, const int* labels,
    long long y_row_stride, int rows, long long n, int c, int group,
    float* partials, int nparts, float* out, void* stream) {
  if (bad_shape(rows, n, nparts) || c <= 0 || c > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int np2 = 1;
  while (np2 < c) np2 <<= 1;
  if (group != (np2 <= 32 ? 4 : np2 / 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nparts, rows);
#define REPRO_CAT_SMALL(N)                                                 \
  case N:                                                                 \
    categorical_small_partials<N><<<grid, kThreads, 0, s>>>(              \
        logits, l_row_stride, labels, y_row_stride, n, c, partials);      \
    break;
  switch (np2) {
    REPRO_CAT_SMALL(1)
    REPRO_CAT_SMALL(2)
    REPRO_CAT_SMALL(4)
    REPRO_CAT_SMALL(8)
    REPRO_CAT_SMALL(16)
    REPRO_CAT_SMALL(32)
    REPRO_CAT_SMALL(64)
    REPRO_CAT_SMALL(128)
    REPRO_CAT_SMALL(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CAT_SMALL
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_rows<<<rows, kThreads, 0, s>>>(partials, nparts, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
