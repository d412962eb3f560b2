// GQA flash attention for Hopper (sm_90a), with a plain C interface for
// ctypes: four forward kernels and the merge of a key split.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// _flash_kernel (:34), reached through flash_attention_bhd (:99, the
// pallas_call at :117). Computes, for every query row of every head,
//
//   out = softmax_j(mask(cap * tanh(q . k_j * scale / cap))) @ v
//
// with the masks taken from position arrays: causal (kp <= qp), sliding
// window (qp - kp < window) and kv validity. Scores, softcap, softmax and
// the running sums are float32 whatever the input type (float32 or bf16);
// the output is written in the input type. NEG_INF is the finite -1e30, and
// a masked key adds exactly 0, so a fully masked row gives exact zeros.
//
// Rows are numbered r = q * G + g over the G query heads that share a kv
// head, so a block serving rows of one (batch, kv head) reads each key
// once for the whole group. The kernels read q, k, v, positions and
// validity through their strides and mask ragged Sq and Sk themselves; the
// caller pads nothing. A call with too few blocks to fill the card splits
// its keys over nsplit blocks per row tile; each writes its rows'
// unnormalised (m, l, acc) to scratch, and the splits are merged in a
// fixed order: by flash_combine after flash_fwd, flash_fwd_tc and
// flash_fwd_tf32, by the last split to finish (an integer count) in
// flash_decode. No float
// atomics: reruns are bit-identical.
// ops.plan picks the kernel from the shapes, the type and the head dim:
//
// flash_fwd_tc (bf16, hd 64 or 128, Sq * G >= 64): prefill on the tensor
// cores. Bound: operations, 4 hd flops per kept (query, key) pair at the
// bf16 rate; at gemma2's local call the softcap's tanh and the softmax's
// exp put ~2 special-function operations per kept pair (~1.1 G at 16 a
// clock per SM, ~280 us) beside its 287 us tensor bound, so both use the
// approximate unit (tanh.approx, ex2.approx), on this path only. Design:
// one block of 4 warps serves 64 rows (16 a warp) of one (batch, kv head);
// its Q fragments stay in registers. K and V tiles of 64 keys go through
// a two-stage ring in shared memory, filled by 16-byte cp.async copies in
// a 128-byte XOR swizzle (chunk c of key row j at chunk c ^ (j & 7)), so
// ldmatrix reads them without bank conflicts; tile k + 1 is in flight
// while tile k computes. S = Q K^T is mma.sync m16n8k16 bf16 with float32
// accumulators; softcap, masks and the online softmax (in the log2 domain)
// run on those registers; P is rounded to bf16 and moved straight from
// the S accumulators into the A fragments of P V (the layouts agree, as in
// FlashAttention-2), V read by ldmatrix.trans. A pre-pass (flash_tiles)
// sums up each tile of 64 keys once per batch row (least and greatest
// valid position, count) and writes each key's position with a sentinel
// where it is masked out; a block turns its tiles' summaries into states
// in shared memory, skipping a tile by the TPU kernel's predicates
// (kernel.py:51-62: any valid key; causal and some valid key at or before
// the last query; window and some valid key inside the first query's
// window) and masking pair by pair only where some pair of the tile is
// masked. Later work: wgmma from shared memory with TMA and a producer
// warp, the route to the bf16 peak.
//
// flash_decode (Sq * G < 64, both types): bound by bytes, every key and
// value of the cache read once per kv head. One block of 4 warps serves R
// rows (R the power of two >= G, at most 8; more rows take more row
// tiles) of one (batch, kv head, key split). Each key row is read by a
// group of 16 / (hd * size) lanes with 16-byte loads (8 lanes for hd 64 in
// bf16, 16 for hd 128); the group's R query rows stay in registers, the dot
// products are reduced by shuffles inside the group, and each group carries
// its own online softmax over a strided slice of the split's keys, with
// U keys in flight: their positions, validity, K and V rows are loaded
// together (no branch between them), so an iteration waits on memory once.
// The groups
// merge by xor shuffles (symmetric, so every lane holds the same sums),
// the warps through shared memory in a fixed order.
//
// flash_fwd_tf32 (float32, hd 64 or 128, Sq * G >= 64): the float32
// prefill on the tensor cores. Bound: operations, 4 hd flops per kept pair,
// three TF32 passes of them (3xTF32, as in mvn_quad.cu: each operand a
// split into hi, a rounded to 10 mantissa bits, and lo = a - hi, and lo*hi
// + hi*lo + hi*hi accumulated in float32) at the TF32 rate; one TF32 pass
// (about 1e-3) would miss the float32 gates' 2e-5. Design: flash_fwd_tc's
// blocks, skip predicates, masks and online softmax on the accumulators,
// in mma.sync m16n8k8. A float32 ring of two K and V tiles beside their
// hi/lo copies does not leave room for two blocks an SM, so one raw tile
// is the cp.async target: when tile k lands, the block splits its K and V
// once into the fragments every warp reads (hi and lo of a thread's two
// B-fragment values in one 16-byte load), then starts tile k + 1's copy
// into the raw tile and computes on the fragments. m16n8k8 has no
// ldmatrix.trans for 32-bit values and its accumulator layout is not its
// A layout; taking V's keys in the order 2 gc, 2 gc + 1 within each 8
// makes P's accumulators the A fragment of P V as they are. Q is split
// once into registers at hd 64; at hd 128 (128 registers for hi and lo) Q
// stays as it is in registers and each k-step splits its fragment once for
// a tile's eight key n-tiles. The softmax keeps float32 accuracy (exp2f,
// tanhf). 101 KB of shared memory a block at hd 64 (two blocks an SM),
// 199 KB at hd 128.
//
// flash_fwd (every other head dim up to 256: 16, 20, 256, ..., in either
// type): the FP32 kernel on the CUDA cores. One block serves one (batch, kv
// head, tile of BM rows), BM 64 (16 when there are fewer rows), and walks
// the keys in tiles of 64 with the online-softmax recurrence (running max
// m, sum l and accumulator per row in registers), which takes the place of
// the TPU kernel's sequential "arbitrary" grid axis and its VMEM scratch.
// Each tile of scores is a 64 x BM x hd product in float32 (4 x 4 outputs
// a thread from float4 loads of the transposed Q tile); P goes through
// shared memory for P @ V (4 rows x hd/16 columns a thread). It skips a
// tile by the same predicates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32.cuh"  // split_tf32, split4, mma_tf32, mma3

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;          // keys per tile
constexpr int kBig = 1 << 30;    // position of a key past Sk (never <= qp)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* q; const void* k; const void* v; void* out;
  const int* qpos; const int* kpos; const unsigned char* kvalid;
  long long q_sb, q_ss, q_sh;     // strides of q viewed as (B, Sq, KV*G, hd)
  long long k_sb, k_ss, k_sh;     // strides of k (B, Sk, KV, hd)
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;     // strides of out (B, Sq, KV*G, hd)
  long long qp_sb, kp_sb, kv_sb;  // batch strides of the positions, validity
  int sq, sk, kvh, g, hd;
  int causal, window;             // window <= 0: no window
  float cap, scale;               // cap <= 0: no softcap
  int nsplit;                     // key splits per row tile
  float* part_acc;                // nsplit > 1: [B][KV][tiles][nsplit][BM][hd]
  float* part_ml;                 // and (m, l) per row: [...][BM][2]
  int bm;                         // rows per block of the kernel that ran
  int* kpm;                       // flash_fwd_tc: [B][ktiles * 64] key
                                  // positions, kBig where masked out
  int4* tsum;                     // and [B][ktiles] (kmin, kmax, count)
  int* sem;                       // flash_decode with nsplit > 1: a count
                                  // per (B, KV, row tile), zero between
                                  // calls
};

template <int BM>
struct Layout {
  static constexpr int kThreads = (BM / 4) * 16;
};

// smem (floats): Qt [HD][BM+4], Kt [HD][kBK+4], Vs [kBK][HD+4],
// Ps [kBK][BM+4]; then ints: qp [BM], kp [kBK], ok [kBK], flags [4]
template <int HD, int BM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HD) * (BM + 4) +
                          static_cast<size_t>(HD) * (kBK + 4) +
                          static_cast<size_t>(kBK) * (HD + 4) +
                          static_cast<size_t>(kBK) * (BM + 4)) +
         sizeof(int) * (BM + 2 * kBK + 4);
}

template <typename T, int HD, int BM>
__global__ void __launch_bounds__(Layout<BM>::kThreads)
flash_fwd(Params a) {
  constexpr int kThreads = Layout<BM>::kThreads;
  constexpr int QP = BM + 4, KP = kBK + 4, VP = HD + 4, PP = BM + 4;
  constexpr int NC = HD / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * QP;
  float* Vs = Kt + HD * KP;
  float* Ps = Vs + kBK * VP;
  int* qp_s = reinterpret_cast<int*>(Ps + kBK * PP);
  int* kp_s = qp_s + BM;
  int* ok_s = kp_s + kBK;
  int* flag = ok_s + kBK;  // [0] qmin, [1] qmax, [2] compute this tile

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int lane = t & 31;
  const long long b = blockIdx.z;
  const int kv = blockIdx.y;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long tile = blockIdx.x / a.nsplit;
  const int split = blockIdx.x - static_cast<int>(tile) * a.nsplit;
  const long long r0 = tile * BM;
  // this split's key tiles
  const int ktiles = (a.sk + kBK - 1) / kBK;
  const int per = (ktiles + a.nsplit - 1) / a.nsplit;
  const int k_begin = split * per * kBK;
  const int k_end = min(a.sk, (split + 1) * per * kBK);

  // the Q tile, transposed (Qt[d][row]); rows past Sq * G are zeros
  for (int idx = t; idx < BM * HD; idx += kThreads) {
    const int row = idx / HD, d = idx - row * HD;
    const long long r = r0 + row;
    float val = 0.0f;
    if (r < rows && d < a.hd) {
      const long long qi = r / a.g;
      const int head = kv * a.g + static_cast<int>(r - qi * a.g);
      val = to_f(q[b * a.q_sb + qi * a.q_ss + head * a.q_sh + d]);
    }
    Qt[d * QP + row] = val;
  }
  for (int row = t; row < BM; row += kThreads) {
    const long long r = r0 + row;
    qp_s[row] = r < rows ? a.qpos[b * a.qp_sb + r / a.g] : 0;
  }
  __syncthreads();
  if (t < 32) {  // qmin, qmax over the block's real rows
    int qmin = kBig, qmax = -kBig;
    for (int row = lane; row < BM; row += 32) {
      if (r0 + row < rows) {
        qmin = min(qmin, qp_s[row]);
        qmax = max(qmax, qp_s[row]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
    if (lane == 0) { flag[0] = qmin; flag[1] = qmax; }
  }
  __syncthreads();
  const int qmin = flag[0], qmax = flag[1];

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  int qrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qrow[i] = qp_s[ty * 4 + i];

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // the tile's positions and validity, then the skip predicates
    for (int j = t; j < kBK; j += kThreads) {
      const int col = k0 + j;
      int kp = kBig, ok = 0;
      if (col < a.sk) {
        kp = a.kpos[b * a.kp_sb + col];
        ok = a.kvalid == nullptr ? 1 : (a.kvalid[b * a.kv_sb + col] != 0);
      }
      kp_s[j] = kp;
      ok_s[j] = ok;
    }
    __syncthreads();
    if (t < 32) {
      int any = 0, kmin = kBig, kmax_valid = -kBig;
      for (int j = lane; j < kBK; j += 32) {
        any |= ok_s[j];
        kmin = min(kmin, kp_s[j]);
        if (ok_s[j]) kmax_valid = max(kmax_valid, kp_s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        any |= __shfl_xor_sync(0xffffffffu, any, off);
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
        kmax_valid = max(kmax_valid, __shfl_xor_sync(0xffffffffu, kmax_valid, off));
      }
      if (lane == 0) {
        bool compute = any != 0;
        if (a.causal) compute = compute && kmin <= qmax;
        if (a.window > 0) {
          compute = compute && static_cast<long long>(kmax_valid) >
                                   static_cast<long long>(qmin) - a.window;
        }
        flag[2] = compute;
      }
    }
    __syncthreads();
    if (!flag[2]) continue;  // uniform over the block

    // K (transposed, Kt[d][j]) and V (Vs[j][d]) tiles, zeros past Sk and hd
    for (int idx = t; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx - j * HD;
      const long long col = k0 + j;
      float kval = 0.0f, vval = 0.0f;
      if (col < a.sk && d < a.hd) {
        kval = to_f(k[b * a.k_sb + col * a.k_ss + kv * a.k_sh + d]);
        vval = to_f(v[b * a.v_sb + col * a.v_ss + kv * a.v_sh + d]);
      }
      Kt[d * KP + j] = kval;
      Vs[j * VP + d] = vval;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 e
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QP + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kb[e] = Kt[d * KP + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = fmaf(qv[i], kb[e], s[i][e]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = kNegInf;
      bool keep[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = tx + 16 * e;
        float x = s[i][e] * a.scale;
        if (a.cap > 0.0f) x = a.cap * tanhf(x / a.cap);
        const int kp = kp_s[j];
        bool msk = ok_s[j] != 0;
        if (a.causal) msk = msk && kp <= qrow[i];
        if (a.window > 0) msk = msk && qrow[i] - kp < a.window;
        keep[e] = msk;
        s[i][e] = msk ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][e]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[i][e] = keep[e] ? expf(s[i][e] - m_new) : 0.0f;
        rsum += p[i][e];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * e) * PP + ty * 4]) =
          make_float4(p[0][e], p[1][e], p[2][e], p[3][e]);
    }
    __syncthreads();

    // acc += P @ V: rows ty*4 + i, columns c4 * 64 + tx * 4 + e
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j * PP + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c4 = 0; c4 < HD / 64; ++c4) {
        const float4 vb =
            *reinterpret_cast<const float4*>(&Vs[j * VP + c4 * 64 + tx * 4]);
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c4 * 4 + e] = fmaf(pv[i], vv[e], acc[i][c4 * 4 + e]);
      }
    }
    __syncthreads();  // before the next tile overwrites Kt, Vs and Ps
  }

  if (a.nsplit > 1) {  // unnormalised partials, merged by flash_combine
    const long long base =
        (((b * a.kvh + kv) * gridDim.x + blockIdx.x) * BM + ty * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tx == 0) {
        a.part_ml[2 * (base + i)] = m[i];
        a.part_ml[2 * (base + i) + 1] = l[i];
      }
#pragma unroll
      for (int c4 = 0; c4 < HD / 64; ++c4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = c4 * 64 + tx * 4 + e;
          if (d < a.hd) a.part_acc[(base + i) * a.hd + d] = acc[i][c4 * 4 + e];
        }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    const long long qi = r / a.g;
    const int head = kv * a.g + static_cast<int>(r - qi * a.g);
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    T* orow = out + b * a.o_sb + qi * a.o_ss + head * a.o_sh;
#pragma unroll
    for (int c4 = 0; c4 < HD / 64; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c4 * 64 + tx * 4 + e;
        if (d < a.hd) store(orow + d, acc[i][c4 * 4 + e] * inv);
      }
  }
}

// Merges the nsplit partials of one row tile of one (batch, kv head):
// out[row] = sum_s acc_s e^{m_s - M} / sum_s l_s e^{m_s - M}, M = max_s m_s;
// a row no split saw (l = 0) gives zeros. First a warp a row takes M and
// the denominator, its lanes striding over the splits, then a butterfly
// (a fixed order); then one thread an output element sums its splits in
// order, the loop unrolled so that their loads are in flight together.
// The partials are read past L1 (__ldcg): other blocks wrote them.
template <typename T, int NT>
__device__ void merge_tile(const Params& a, long long b, int kv,
                           long long tile, long long tiles, float* mrow,
                           float* lrow) {
  T* __restrict__ out = static_cast<T*>(a.out);
  const int bm = a.bm;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long first = ((b * a.kvh + kv) * tiles + tile) * a.nsplit * bm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < bm; row += NT / 32) {
    float mx = kNegInf;
    for (int sp = lane; sp < a.nsplit; sp += 32)
      mx = fmaxf(mx, __ldcg(a.part_ml + 2 * (first + sp * bm + row)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.0f;
    for (int sp = lane; sp < a.nsplit; sp += 32) {
      const long long pr = first + sp * bm + row;
      ls += __ldcg(a.part_ml + 2 * pr + 1) *
            expf(__ldcg(a.part_ml + 2 * pr) - mx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (lane == 0) {
      mrow[row] = mx;
      lrow[row] = ls;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bm * a.hd; idx += NT) {
    const int row = idx / a.hd, d = idx - row * a.hd;
    const long long r = tile * bm + row;
    if (r >= rows) continue;
    const float mx = mrow[row], ls = lrow[row];
    float o = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const long long pr = first + sp * bm + row;
      o += __ldcg(a.part_acc + pr * a.hd + d) *
           expf(__ldcg(a.part_ml + 2 * pr) - mx);
    }
    const long long qi = r / a.g;
    const int head = kv * a.g + static_cast<int>(r - qi * a.g);
    store(out + b * a.o_sb + qi * a.o_ss + head * a.o_sh + d,
          o / (ls == 0.0f ? 1.0f : ls));
  }
}

// the merge as a kernel of its own, after flash_fwd and flash_fwd_tc: one
// block a (row tile, kv head, batch)
constexpr int kCombineThreads = 256;
constexpr int kCombineRows = 64;  // rows per block, at most (BM)

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) flash_combine(Params a) {
  __shared__ float mrow[kCombineRows], lrow[kCombineRows];
  merge_tile<T, kCombineThreads>(a, blockIdx.z, blockIdx.y, blockIdx.x,
                                 gridDim.x, mrow, lrow);
}

// ---------------------------------------------------------------------------
// shared pieces of flash_fwd_tc and flash_decode
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the key masks for one (query position, key) pair
__device__ __forceinline__ bool keep_pair(const Params& a, int qp, int kp) {
  return (!a.causal || kp <= qp) &&
         (a.window <= 0 ||
          static_cast<long long>(qp) - kp < static_cast<long long>(a.window));
}

__device__ __forceinline__ int key_pos(const Params& a, long long b, int col) {
  return a.kpos[b * a.kp_sb + col];
}
__device__ __forceinline__ bool key_ok(const Params& a, long long b, int col) {
  return a.kvalid == nullptr || a.kvalid[b * a.kv_sb + col] != 0;
}

// ---------------------------------------------------------------------------
// flash_fwd_tc: bf16 prefill on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;     // rows per block, 16 per warp
constexpr int kTcKeys = 64;     // keys per tile
constexpr int kTcThreads = 128;

template <int HD>
constexpr size_t tc_smem_bytes() {
  // K and V tiles, two stages each, then each stage's key positions
  return 2 * 2 * static_cast<size_t>(kTcKeys) * HD * sizeof(__nv_bfloat16) +
         2 * kTcKeys * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 fills the 16 bytes with zeros (keys past Sk)
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
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

// flash_tiles, the pre-pass of flash_fwd_tc: for each (batch, tile of 64
// keys) the valid keys' least and greatest position and their count, and
// each key's position with kBig where the key is invalid or past Sk. The
// summaries are shared by every (kv head, row tile) block of the batch, so
// a block decides which tiles to skip from a few loads, and the masks of a
// tile come in with its K and V as one 256-byte copy.
__global__ void __launch_bounds__(kTcKeys) flash_tiles(Params a) {
  __shared__ int red[3][kTcKeys / 32];
  const int t = blockIdx.x, j = threadIdx.x, lane = j & 31, w = j >> 5;
  const long long b = blockIdx.y;
  const int col = t * kTcKeys + j;
  const bool ok = col < a.sk && key_ok(a, b, col);
  const int kp = ok ? key_pos(a, b, col) : kBig;
  a.kpm[b * gridDim.x * kTcKeys + col] = kp;
  int kmin = kp, kmax = ok ? kp : -kBig, cnt = ok;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    red[0][w] = kmin;
    red[1][w] = kmax;
    red[2][w] = cnt;
  }
  __syncthreads();
  if (j == 0) {
    a.tsum[b * gridDim.x + t] = make_int4(min(red[0][0], red[0][1]),
                                          max(red[1][0], red[1][1]),
                                          red[2][0] + red[2][1], 0);
  }
}

// 0: the masks keep no pair of the tile; 1: some; 2: every pair of every
// real row (then no per-pair mask), from its summary and the block's rows'
// least and greatest query position
__device__ __forceinline__ unsigned char tile_state(const Params& a, int4 ts,
                                                   int qmin, int qmax) {
  const int kmin = ts.x, kmax = ts.y, cnt = ts.z;
  const long long w = a.window;
  if (cnt == 0) return 0;
  if (a.causal && kmin > qmax) return 0;
  if (a.window > 0 && static_cast<long long>(kmax) <= qmin - w) return 0;
  const bool full = cnt == kTcKeys && (!a.causal || kmax <= qmin) &&
                    (a.window <= 0 || static_cast<long long>(kmin) > qmax - w);
  return full ? 2 : 1;
}

template <int HD>
__device__ __forceinline__ void tc_load_tile(const Params& a, long long b,
                                             int kv, int t,
                                             __nv_bfloat16* ks,
                                             __nv_bfloat16* vs, int* kp_s,
                                             int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per key row
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
#pragma unroll
  for (int idx = tid; idx < kTcKeys * kChunks; idx += kTcThreads) {
    const int j = idx / kChunks, c = idx - j * kChunks;
    const int col = t * kTcKeys + j;
    const bool in = col < a.sk;
    const long long cc = in ? col : 0;
    const int sw = j * HD + ((c ^ (j & 7)) << 3);
    cp_async16(smem_addr(ks + sw), k + b * a.k_sb + cc * a.k_ss + kv * a.k_sh + c * 8,
               in ? 16 : 0);
    cp_async16(smem_addr(vs + sw), v + b * a.v_sb + cc * a.v_ss + kv * a.v_sh + c * 8,
               in ? 16 : 0);
  }
  if (tid < kTcKeys / 4) {  // the tile's 64 positions, 16 bytes a thread
    const int ktiles = (a.sk + kTcKeys - 1) / kTcKeys;
    cp_async16(smem_addr(kp_s + 4 * tid),
               a.kpm + b * ktiles * kTcKeys + t * kTcKeys + 4 * tid, 16);
  }
}

constexpr int kStateChunk = 512;  // tiles whose states a block holds at once

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(Params a) {
  constexpr int BM = kTcRows;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int DN = HD / 8;       // n-tiles of the output
  constexpr int SN = kTcKeys / 8;  // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned char st_s[kStateChunk];
  __nv_bfloat16* ks_base = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs_base = ks_base + 2 * kTcKeys * HD;
  int* kp_base = reinterpret_cast<int*>(vs_base + 2 * kTcKeys * HD);

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(a.q);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3;  // fragment row, column pair
  const long long b = blockIdx.z;
  const int kv = blockIdx.y;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long tile = blockIdx.x / a.nsplit;
  const int split = blockIdx.x - static_cast<int>(tile) * a.nsplit;
  const long long r0 = tile * BM;

  // this thread's two rows: gr and gr + 8 of its warp's 16
  long long rr[2];
  int qp[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = r0 + warp * 16 + gr + 8 * i;
    qrow[i] = nullptr;
    qp[i] = 0;
    if (rr[i] < rows) {
      const long long qi = rr[i] / a.g;
      const int head = kv * a.g + static_cast<int>(rr[i] - qi * a.g);
      qrow[i] = q + b * a.q_sb + qi * a.q_ss + head * a.q_sh;
      qp[i] = a.qpos[b * a.qp_sb + qi];
    }
  }
  // Q fragments (A of m16n8k16: rows gr / gr + 8, columns 2 gc (+ 8))
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int d = s * 16 + 2 * gc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qf[s][2 * h + i] =
            qrow[i] ? *reinterpret_cast<const uint32_t*>(qrow[i] + d + 8 * h)
                    : 0u;
      }
    }
  }
  // qmin, qmax over the block's real rows (every warp the same)
  int qmin = kBig, qmax = -kBig;
#pragma unroll
  for (int h = 0; h < BM / 32; ++h) {
    const long long r = r0 + lane + 32 * h;
    if (r < rows) {
      const int p = a.qpos[b * a.qp_sb + r / a.g];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }

  // this split's key tiles
  const int ktiles = (a.sk + kTcKeys - 1) / kTcKeys;
  const int per = (ktiles + a.nsplit - 1) / a.nsplit;
  const int t_begin = split * per;
  const int t_end = min(ktiles, t_begin + per);

  const bool capped = a.cap > 0.0f;
  const float s_mul = capped ? a.scale / a.cap : a.scale * kLog2e;
  const float cap_l2 = a.cap * kLog2e;

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int mat = lane >> 3, mrow = lane & 7;

  for (int c0 = t_begin; c0 < t_end; c0 += kStateChunk) {
    const int c1 = min(t_end, c0 + kStateChunk);
    __syncthreads();  // the previous chunk's states are no longer read
    for (int t = c0 + tid; t < c1; t += kTcThreads)
      st_s[t - c0] = tile_state(a, a.tsum[b * ktiles + t], qmin, qmax);
    __syncthreads();
    int t = c0;
    while (t < c1 && st_s[t - c0] == 0) ++t;
    int buf = 0;
    if (t < c1) tc_load_tile<HD>(a, b, kv, t, ks_base, vs_base, kp_base, tid);
    cp_async_commit();

    while (t < c1) {
      const int st = st_s[t - c0];
      int nt = t + 1;
      while (nt < c1 && st_s[nt - c0] == 0) ++nt;
      if (nt < c1) {
        const int nb = buf ^ 1;
        tc_load_tile<HD>(a, b, kv, nt, ks_base + nb * kTcKeys * HD,
                         vs_base + nb * kTcKeys * HD, kp_base + nb * kTcKeys,
                         tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      const __nv_bfloat16* ks = ks_base + buf * kTcKeys * HD;
      const __nv_bfloat16* vs = vs_base + buf * kTcKeys * HD;
      const int* kp_s = kp_base + buf * kTcKeys;

      // S = Q K^T over the tile's 64 keys
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ksx = 0; ksx < KSTEPS; ++ksx) {
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          const int j = np * 16 + (mat >> 1) * 8 + mrow;
          const int c = ksx * 2 + (mat & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(ks + j * HD + ((c ^ (j & 7)) << 3)), b0, b1, b2, b3);
          mma_bf16(s[2 * np], qf[ksx], b0, b1);
          mma_bf16(s[2 * np + 1], qf[ksx], b2, b3);
        }
      }

      // softcap and scale into the log2 domain, masks, online softmax
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * s_mul;
          if (capped) x = cap_l2 * tanh_fast(x);
          if (st != 2) {
            const int j = n * 8 + 2 * gc + (e & 1);
            const int kp = kp_s[j];
            const bool keep = kp != kBig && keep_pair(a, qp[e >> 1], kp);
            x = keep ? x : kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2_fast(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float p = x == kNegInf ? 0.0f : ex2_fast(x - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: P from the S accumulators as the A fragments
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          const int j = kk * 16 + (mat & 1) * 8 + mrow;
          const int c = dp * 2 + (mat >> 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_addr(vs + j * HD + ((c ^ (j & 7)) << 3)), b0, b1, b2, b3);
          mma_bf16(o[2 * dp], pa, b0, b1);
          mma_bf16(o[2 * dp + 1], pa, b2, b3);
        }
      }
      __syncthreads();  // before the next load overwrites this stage
      t = nt;
      buf ^= 1;
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (a.nsplit > 1) {  // unnormalised partials (m in natural-log units)
    const long long base =
        ((b * a.kvh + kv) * gridDim.x + blockIdx.x) * BM + warp * 16 + gr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long pr = base + 8 * i;
      if (gc == 0) {
        a.part_ml[2 * pr] = m[i] * kLn2;
        a.part_ml[2 * pr + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        float* dst = a.part_acc + pr * a.hd + n * 8 + 2 * gc;
        dst[0] = o[n][2 * i];
        dst[1] = o[n][2 * i + 1];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rr[i] >= rows) continue;
    const long long qi = rr[i] / a.g;
    const int head = kv * a.g + static_cast<int>(rr[i] - qi * a.g);
    __nv_bfloat16* orow = out + b * a.o_sb + qi * a.o_ss + head * a.o_sh;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * gc) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_tf32: float32 prefill on the tensor cores in 3xTF32 (mma.sync
// m16n8k8)
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t tf_smem_bytes() {
  // K and V fragments (hi and lo) of one tile, one raw tile of K and V
  // (the cp.async target), and the positions of each
  return sizeof(float) * (4 * static_cast<size_t>(kTcKeys) * HD +
                          2 * static_cast<size_t>(kTcKeys) * (HD + 4)) +
         2 * kTcKeys * sizeof(int);
}

// cp.async of key tile t's raw K and V rows (pitch HD + 4 floats) and its
// 64 positions
template <int HD>
__device__ __forceinline__ void tf_load_tile(const Params& a, long long b,
                                             int kv, int t, float* kr,
                                             float* vr, int* kp_s, int tid) {
  constexpr int kChunks = HD / 4;  // 16-byte chunks per key row
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
#pragma unroll 4
  for (int idx = tid; idx < kTcKeys * kChunks; idx += kTcThreads) {
    const int j = idx / kChunks, c = idx - j * kChunks;
    const int col = t * kTcKeys + j;
    const bool in = col < a.sk;
    const long long cc = in ? col : 0;
    const int o = j * (HD + 4) + 4 * c;
    cp_async16(smem_addr(kr + o), k + b * a.k_sb + cc * a.k_ss + kv * a.k_sh + 4 * c,
               in ? 16 : 0);
    cp_async16(smem_addr(vr + o), v + b * a.v_sb + cc * a.v_ss + kv * a.v_sh + 4 * c,
               in ? 16 : 0);
  }
  if (tid < kTcKeys / 4) {
    const int ktiles = (a.sk + kTcKeys - 1) / kTcKeys;
    cp_async16(smem_addr(kp_s + 4 * tid),
               a.kpm + b * ktiles * kTcKeys + t * kTcKeys + 4 * tid, 16);
  }
}

// one block of 4 warps serves 64 rows (16 a warp) of one (batch, kv head,
// key split), as flash_fwd_tc's blocks do; kCap: the softcap, a template
// argument so that the softmax's loops hold no branch
template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, HD <= 64 ? 2 : 1)
flash_fwd_tf32(Params a) {
  constexpr int BM = kTcRows;
  constexpr int KS = HD / 8;       // k-steps of Q K^T
  constexpr int DN = HD / 8;       // n-tiles of the output
  constexpr int SN = kTcKeys / 8;  // n-tiles of S, k-steps of P V
  constexpr int RP = HD + 4;       // floats a raw key row
  constexpr bool kQSplit = HD <= 64;  // Q's hi and lo stay in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned char st_s[kStateChunk];
  float4* kf = reinterpret_cast<float4*>(smem_raw);  // [SN][KS][32]
  float4* vf = kf + SN * KS * 32;                    // [SN][DN][32]
  float* kr = reinterpret_cast<float*>(vf + SN * DN * 32);  // [64][RP]
  float* vr = kr + kTcKeys * RP;                             // [64][RP]
  int* kp_raw = reinterpret_cast<int*>(vr + kTcKeys * RP);   // [64]
  int* kp_s = kp_raw + kTcKeys;                              // [64]

  const float* __restrict__ q = static_cast<const float*>(a.q);
  float* __restrict__ out = static_cast<float*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3;  // fragment row, column
  const long long b = blockIdx.z;
  const int kv = blockIdx.y;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long tile = blockIdx.x / a.nsplit;
  const int split = blockIdx.x - static_cast<int>(tile) * a.nsplit;
  const long long r0 = tile * BM;

  // this thread's two rows: gr and gr + 8 of its warp's 16
  long long rr[2];
  int qp[2];
  const float* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = r0 + warp * 16 + gr + 8 * i;
    qrow[i] = nullptr;
    qp[i] = 0;
    if (rr[i] < rows) {
      const long long qi = rr[i] / a.g;
      const int head = kv * a.g + static_cast<int>(rr[i] - qi * a.g);
      qrow[i] = q + b * a.q_sb + qi * a.q_ss + head * a.q_sh;
      qp[i] = a.qpos[b * a.qp_sb + qi];
    }
  }
  // Q's A fragments (rows gr / gr + 8, columns gc / gc + 4 of each k-step):
  // split once into hi (qa) and lo (qb) at hd 64; at hd 128 (128 registers
  // for both) qa holds Q as it is and each k-step splits it as it is used,
  // once for the eight key n-tiles of a tile
  uint32_t qa[KS][4];
  uint32_t qb[kQSplit ? KS : 1][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int d = 8 * s + gc;
    const float v[4] = {qrow[0] ? qrow[0][d] : 0.0f,
                        qrow[1] ? qrow[1][d] : 0.0f,
                        qrow[0] ? qrow[0][d + 4] : 0.0f,
                        qrow[1] ? qrow[1][d + 4] : 0.0f};
    if constexpr (kQSplit) {
      split4(v, qa[s], qb[s]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[s][e] = __float_as_uint(v[e]);
    }
  }
  // qmin, qmax over the block's real rows (every warp the same)
  int qmin = kBig, qmax = -kBig;
#pragma unroll
  for (int h = 0; h < BM / 32; ++h) {
    const long long r = r0 + lane + 32 * h;
    if (r < rows) {
      const int p = a.qpos[b * a.qp_sb + r / a.g];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }

  // this split's key tiles
  const int ktiles = (a.sk + kTcKeys - 1) / kTcKeys;
  const int per = (ktiles + a.nsplit - 1) / a.nsplit;
  const int t_begin = split * per;
  const int t_end = min(ktiles, t_begin + per);

  // scores in the log2 domain; the softmax keeps float32 accuracy
  // (exp2f, tanhf: not the approximate unit of flash_fwd_tc)
  const float s_mul = kCap ? a.scale / a.cap : a.scale * kLog2e;
  const float cap_l2 = a.cap * kLog2e;

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int c0 = t_begin; c0 < t_end; c0 += kStateChunk) {
    const int c1 = min(t_end, c0 + kStateChunk);
    __syncthreads();  // the previous chunk's states are no longer read
    for (int t = c0 + tid; t < c1; t += kTcThreads)
      st_s[t - c0] = tile_state(a, a.tsum[b * ktiles + t], qmin, qmax);
    __syncthreads();
    int t = c0;
    while (t < c1 && st_s[t - c0] == 0) ++t;
    if (t < c1) tf_load_tile<HD>(a, b, kv, t, kr, vr, kp_raw, tid);
    cp_async_commit();

    while (t < c1) {
      const int st = st_s[t - c0];
      int nt = t + 1;
      while (nt < c1 && st_s[nt - c0] == 0) ++nt;
      cp_async_wait<0>();
      __syncthreads();  // tile t landed; the last tile's fragments are free
      // split K and V once, into the fragments every warp reads: K's
      // (keys 8 j + gr, columns 8 s + gc, + 4) and V's with its keys in the
      // order 2 gc, 2 gc + 1, which makes P's accumulators its A fragment
      // as they are (columns 8 d + gr); one 16-byte load a fragment
#pragma unroll
      for (int idx = tid; idx < SN * KS * 32; idx += kTcThreads) {
        const int ln = idx & 31, blk = idx >> 5;
        const int j = blk / KS, s = blk - j * KS;
        const float* src = kr + (8 * j + (ln >> 2)) * RP + 8 * s + (ln & 3);
        uint32_t h0, l0, h1, l1;
        split_tf32(src[0], h0, l0);
        split_tf32(src[4], h1, l1);
        kf[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                              __uint_as_float(l0), __uint_as_float(l1));
      }
#pragma unroll
      for (int idx = tid; idx < SN * DN * 32; idx += kTcThreads) {
        const int ln = idx & 31, blk = idx >> 5;
        const int n = blk / DN, dn = blk - n * DN;
        const float* src = vr + (8 * n + 2 * (ln & 3)) * RP + 8 * dn + (ln >> 2);
        uint32_t h0, l0, h1, l1;
        split_tf32(src[0], h0, l0);
        split_tf32(src[RP], h1, l1);
        vf[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                              __uint_as_float(l0), __uint_as_float(l1));
      }
      if (tid < kTcKeys) kp_s[tid] = kp_raw[tid];
      __syncthreads();  // fragments in place; the raw tile is free
      if (nt < c1) tf_load_tile<HD>(a, b, kv, nt, kr, vr, kp_raw, tid);
      cp_async_commit();

      // S = Q K^T over the tile's 64 keys
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
        if constexpr (kQSplit) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qa[ks][e];
            al[e] = qb[ks][e];
          }
        } else {
          const float v[4] = {__uint_as_float(qa[ks][0]), __uint_as_float(qa[ks][1]),
                              __uint_as_float(qa[ks][2]), __uint_as_float(qa[ks][3])};
          split4(v, ah, al);
        }
#pragma unroll
        for (int j = 0; j < SN; ++j) mma3(s[j], ah, al, kf[(j * KS + ks) * 32 + lane]);
      }

      // softcap and scale into the log2 domain, masks (every pair kept
      // in a tile of state 2), online softmax
      const bool all_kept = st == 2;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * s_mul;
          if constexpr (kCap) x = cap_l2 * tanhf(x);
          const int kp = kp_s[n * 8 + 2 * gc + (e & 1)];
          const bool keep = all_kept ||
                            (kp != kBig && keep_pair(a, qp[e >> 1], kp));
          x = keep ? x : kNegInf;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float p = x == kNegInf ? 0.0f : exp2f(x - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: P's accumulators (keys 2 gc, 2 gc + 1 of each 8) split
      // once as the A fragments
#pragma unroll
      for (int kk = 0; kk < SN; ++kk) {
        const float pv[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t ph[4], pl[4];
        split4(pv, ph, pl);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) mma3(o[dn], ph, pl, vf[(kk * DN + dn) * 32 + lane]);
      }
      t = nt;
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (a.nsplit > 1) {  // unnormalised partials (m in natural-log units)
    const long long base =
        ((b * a.kvh + kv) * gridDim.x + blockIdx.x) * BM + warp * 16 + gr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long pr = base + 8 * i;
      if (gc == 0) {
        a.part_ml[2 * pr] = m[i] * kLn2;
        a.part_ml[2 * pr + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        float* dst = a.part_acc + pr * a.hd + n * 8 + 2 * gc;
        dst[0] = o[n][2 * i];
        dst[1] = o[n][2 * i + 1];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rr[i] >= rows) continue;
    const long long qi = rr[i] / a.g;
    const int head = kv * a.g + static_cast<int>(rr[i] - qi * a.g);
    float* orow = out + b * a.o_sb + qi * a.o_ss + head * a.o_sh;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * gc) =
          make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_decode: few rows (Sq * G < 64), bound by the cache's bytes
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;

// A lane's E elements of a key row held as 32-bit words, two bf16 or one
// float each (a bf16 array of its own would take a register an element):
// element e of the row as float.
template <typename T, int W>
__device__ __forceinline__ float word_elem(const uint32_t (&w)[W], int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  } else {
    return __uint_as_float(w[e]);
  }
}

// the words of E elements from element d0 of a row, zeros past hd, by
// scalar loads (any alignment)
template <typename T, int W>
__device__ __forceinline__ void load_words(const T* row, int d0, int hd,
                                           uint32_t (&w)[W]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int e = 2 * i;
      const uint32_t lo = d0 + e < hd ? __bfloat16_as_ushort(row[e]) : 0u;
      const uint32_t hi =
          d0 + e + 1 < hd ? __bfloat16_as_ushort(row[e + 1]) : 0u;
      w[i] = lo | (hi << 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = d0 + i < hd ? __float_as_uint(row[i]) : 0u;
  }
}

// (three blocks an SM up to 4 rows: at most 170 registers a thread)
template <typename T, int HD, int R>
__global__ void __launch_bounds__(kDecWarps * 32, R <= 4 ? 3 : 2)
flash_decode(Params a, int vec) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a load
  constexpr int L = HD / VEC < 32 ? HD / VEC : 32;       // lanes a key row
  constexpr int E = HD / L;                              // elements a lane
  constexpr int NG = 32 / L;                             // groups a warp
  constexpr int GROUPS = kDecWarps * NG;
  constexpr int CH = E / VEC;                            // chunks a lane
  constexpr int W = 4 * CH;                              // words a lane
  // keys in flight a group: as many as the registers of three blocks an
  // SM allow (two at 8 rows), fewer where a row takes 8 words (float32 at
  // hd 256). ops.decode_pass_keys mirrors GROUPS * U.
  constexpr int U = (R <= 2 ? 8 : (R == 4 ? 4 : 2)) * 4 / W;
  constexpr bool kFast = sizeof(T) == 2;
  __shared__ float red_ml[kDecWarps][R][2];
  __shared__ float red_acc[kDecWarps][R][HD];
  __shared__ float merge_m[R], merge_l[R];
  __shared__ int merge_last;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % L, grp = lane / L;
  const int d0 = sub * E;
  // this lane reads whole 16-byte chunks (the rows allow it, and its
  // elements lie below hd)
  const bool chunked = vec && d0 + E <= a.hd;
  const long long b = blockIdx.z;
  const int kv = blockIdx.y;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long tile = blockIdx.x / a.nsplit;
  const int split = blockIdx.x - static_cast<int>(tile) * a.nsplit;
  const long long r0 = tile * R;
  const int kps = (a.sk + a.nsplit - 1) / a.nsplit;
  const int k_begin = split * kps;
  const int k_end = min(a.sk, k_begin + kps);

  // the R query rows, packed as the key rows are (scaled after the dot,
  // as the plain version does)
  uint32_t qw[R][W];
  int qp[R];
  bool real[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long rr = r0 + r;
    real[r] = rr < rows;
    qp[r] = 0;
    const long long qi = real[r] ? rr / a.g : 0;
    const int head = kv * a.g + static_cast<int>(real[r] ? rr - qi * a.g : 0);
    const T* qrow = q + b * a.q_sb + qi * a.q_ss + head * a.q_sh + d0;
    if (chunked && real[r]) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 qc = __ldg(reinterpret_cast<const uint4*>(qrow) + c);
        qw[r][4 * c] = qc.x;
        qw[r][4 * c + 1] = qc.y;
        qw[r][4 * c + 2] = qc.z;
        qw[r][4 * c + 3] = qc.w;
      }
    } else {
      load_words<T, W>(qrow, d0, real[r] ? a.hd : 0, qw[r]);
    }
    if (real[r]) qp[r] = a.qpos[b * a.qp_sb + qi];
  }
  const int* kpos_b = a.kpos + b * a.kp_sb;
  const bool has_mask = a.kvalid != nullptr;
  // without a mask, any readable bytes (the positions') stand in for it
  const unsigned char* kvalid_b =
      has_mask ? a.kvalid + b * a.kv_sb
               : reinterpret_cast<const unsigned char*>(kpos_b);
  const bool capped = a.cap > 0.0f;
  const float s_mul = capped ? a.scale / a.cap : a.scale * kLog2e;
  const float cap_l2 = a.cap * kLog2e;

  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  // the bound is uniform over the warp, so every lane reaches the shuffles;
  // group warp * NG + grp takes every GROUPS-th key from k_begin + itself
  for (int jw = k_begin + warp * NG; jw < k_end; jw += GROUPS * U) {
    // the U keys' positions, validity, K and V rows are all loaded at
    // once (one memory latency an iteration); a key the masks drop for
    // every row adds nothing, whatever its K and V hold
    // (the rows stay in registers as packed words, converted as they are
    // used, so many keys fit in flight)
    uint32_t kw[U][W], vw[U][W];
    int kp[U];
    bool ok[U];
    const T* krow[U];
    const T* vrow[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jw + grp + u * GROUPS;
      const long long jj = j < k_end ? j : k_begin;
      kp[u] = kpos_b[jj];
      // no branch on the mask's presence: a branch would wait for each
      // key's byte before the next key's loads are issued
      ok[u] = (j < k_end) & (!has_mask | (kvalid_b[jj] != 0));
      krow[u] = k + b * a.k_sb + jj * a.k_ss + kv * a.k_sh + d0;
      vrow[u] = v + b * a.v_sb + jj * a.v_ss + kv * a.v_sh + d0;
    }
    if (chunked) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint4 kc = __ldg(reinterpret_cast<const uint4*>(krow[u]) + c);
          const uint4 vc = __ldg(reinterpret_cast<const uint4*>(vrow[u]) + c);
          kw[u][4 * c] = kc.x;
          kw[u][4 * c + 1] = kc.y;
          kw[u][4 * c + 2] = kc.z;
          kw[u][4 * c + 3] = kc.w;
          vw[u][4 * c] = vc.x;
          vw[u][4 * c + 1] = vc.y;
          vw[u][4 * c + 2] = vc.z;
          vw[u][4 * c + 3] = vc.w;
        }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_words<T, W>(krow[u], d0, a.hd, kw[u]);
        load_words<T, W>(vrow[u], d0, a.hd, vw[u]);
      }
    }
    unsigned keep[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      keep[u] = 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (ok[u] && real[r] && keep_pair(a, qp[r], kp[u])) keep[u] |= 1u << r;
    }
    float x[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          dot = fmaf(word_elem<T, W>(qw[r], e), word_elem<T, W>(kw[u], e),
                     dot);
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float s2;
        if (capped)
          s2 = cap_l2 * (kFast ? tanh_fast(dot * s_mul) : tanhf(dot * s_mul));
        else
          s2 = dot * s_mul;
        x[u][r] = (keep[u] >> r) & 1u ? s2 : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, x[u][r]);
      const float alpha = kFast ? ex2_fast(m[r] - mx) : exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!((keep[u] >> r) & 1u)) continue;
        const float p = kFast ? ex2_fast(x[u][r] - mx) : exp2f(x[u][r] - mx);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p, word_elem<T, W>(vw[u], e), acc[r][e]);
      }
    }
  }

  // merge the warp's groups (xor shuffles: symmetric, every lane the same)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float wa = exp2f(m[r] - mm), wb = exp2f(mo - mm);
      m[r] = mm;
      l[r] = l[r] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * wa + ao * wb;
      }
    }
  }
  // then the warps, in order, through shared memory
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sub == 0) {
        red_ml[warp][r][0] = m[r];
        red_ml[warp][r][1] = l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) red_acc[warp][r][d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * HD; idx += kDecWarps * 32) {
    const int r = idx / HD, d = idx - r * HD;
    if (d >= a.hd) continue;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, red_ml[w][r][0]);
    float ls = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2f(red_ml[w][r][0] - mm);
      ls += red_ml[w][r][1] * wt;
      o += red_acc[w][r][d] * wt;
    }
    if (a.nsplit > 1) {
      const long long pr =
          ((b * a.kvh + kv) * gridDim.x + blockIdx.x) * R + r;
      if (d == 0) {
        a.part_ml[2 * pr] = mm * kLn2;
        a.part_ml[2 * pr + 1] = ls;
      }
      a.part_acc[pr * a.hd + d] = o;
      continue;
    }
    const long long rr = r0 + r;
    if (rr >= rows) continue;
    const long long qi = rr / a.g;
    const int head = kv * a.g + static_cast<int>(rr - qi * a.g);
    store(out + b * a.o_sb + qi * a.o_ss + head * a.o_sh + d,
          o / (ls == 0.0f ? 1.0f : ls));
  }
  if (a.nsplit == 1) return;
  // the last split of this row tile to finish merges all of them (its
  // count is an integer atomic; the merge reads the splits in a fixed
  // order whichever block does it, so reruns are bit-identical), then
  // sets the count back to zero for the next call
  // (the barrier orders the block's partial writes before thread 0's
  // fence, which is cumulative: it publishes them with its count)
  __syncthreads();
  const long long tiles = gridDim.x / a.nsplit;
  int* sem = a.sem + (b * a.kvh + kv) * tiles + tile;
  if (tid == 0) {
    __threadfence();
    merge_last = atomicAdd(sem, 1) == a.nsplit - 1;
    if (merge_last) __threadfence();
  }
  __syncthreads();
  if (!merge_last) return;
  merge_tile<T, kDecWarps * 32>(a, b, kv, tile, tiles, merge_m, merge_l);
  if (tid == 0) *sem = 0;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T>
int launch_combine(const Params& a, unsigned tiles, int batch,
                   cudaStream_t stream) {
  flash_combine<T><<<dim3(tiles, a.kvh, batch), kCombineThreads, 0,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

unsigned row_tiles(const Params& a) {
  const long long rows = static_cast<long long>(a.sq) * a.g;
  return static_cast<unsigned>((rows + a.bm - 1) / a.bm);
}

template <typename T, int HD, int BM>
int launch_fwd(const Params& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = row_tiles(a);
  flash_fwd<T, HD, BM><<<dim3(tiles * a.nsplit, a.kvh, batch),
                         Layout<BM>::kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return launch_combine<T>(a, tiles, batch, stream);
}

template <typename T, int HD>
int launch_fwd_bm(const Params& a, int batch, cudaStream_t stream) {
  return a.bm == 16 ? launch_fwd<T, HD, 16>(a, batch, stream)
                    : launch_fwd<T, HD, 64>(a, batch, stream);
}

template <typename T>
int launch_fwd_hd(const Params& a, int batch, cudaStream_t stream) {
  if (a.hd <= 64) return launch_fwd_bm<T, 64>(a, batch, stream);
  if (a.hd <= 128) return launch_fwd_bm<T, 128>(a, batch, stream);
  return launch_fwd_bm<T, 256>(a, batch, stream);
}

template <int HD>
int launch_tc(const Params& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ktiles = static_cast<unsigned>((a.sk + kTcKeys - 1) / kTcKeys);
  flash_tiles<<<dim3(ktiles, batch), kTcKeys, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = row_tiles(a);
  flash_fwd_tc<HD><<<dim3(tiles * a.nsplit, a.kvh, batch), kTcThreads,
                     smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return launch_combine<__nv_bfloat16>(a, tiles, batch, stream);
}

template <int HD>
int launch_tf32(const Params& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = tf_smem_bytes<HD>();
  static_assert(smem + kStateChunk <= 232448,
                "flash_fwd_tf32: more shared memory than a block has");
  const bool capped = a.cap > 0.0f;
  auto kernel = capped ? flash_fwd_tf32<HD, true> : flash_fwd_tf32<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ktiles = static_cast<unsigned>((a.sk + kTcKeys - 1) / kTcKeys);
  flash_tiles<<<dim3(ktiles, batch), kTcKeys, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = row_tiles(a);
  kernel<<<dim3(tiles * a.nsplit, a.kvh, batch), kTcThreads, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return launch_combine<float>(a, tiles, batch, stream);
}

template <typename T, int HD, int R>
int launch_decode(const Params& a, int vec, int batch, cudaStream_t stream) {
  const unsigned tiles = row_tiles(a);
  flash_decode<T, HD, R><<<dim3(tiles * a.nsplit, a.kvh, batch),
                           kDecWarps * 32, 0, stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_decode_r(const Params& a, int vec, int batch, cudaStream_t stream) {
  switch (a.bm) {
    case 1: return launch_decode<T, HD, 1>(a, vec, batch, stream);
    case 2: return launch_decode<T, HD, 2>(a, vec, batch, stream);
    case 4: return launch_decode<T, HD, 4>(a, vec, batch, stream);
    default: return launch_decode<T, HD, 8>(a, vec, batch, stream);
  }
}

template <typename T>
int launch_decode_hd(const Params& a, int vec, int batch, cudaStream_t stream) {
  if (a.hd <= 64) return launch_decode_r<T, 64>(a, vec, batch, stream);
  if (a.hd <= 128) return launch_decode_r<T, 128>(a, vec, batch, stream);
  return launch_decode_r<T, 256>(a, vec, batch, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// kernel: 0 flash_fwd (bm 16 or 64), 1 flash_fwd_tc (bf16, hd 64 or 128,
// bm 64; q, k, v 16-byte aligned with strides of whole 16-byte chunks;
// kpm holds B * ceil(sk / 64) * 64 ints and tsum 4 ints for each of B *
// ceil(sk / 64) tiles, 16-byte aligned), 2 flash_decode (bm 1, 2, 4 or 8
// rows per block; nsplit > 1 needs sem, B * KV * tiles ints, zero, which
// the kernel leaves zero), 3 flash_fwd_tf32 (float32, otherwise as
// flash_fwd_tc: 16-byte chunks are 4 floats). dtype: 0 float32, 1
// bfloat16. nsplit > 1 needs part_acc (B * KV * tiles * nsplit * bm * hd
// floats) and part_ml (twice B * KV * tiles * nsplit * bm), tiles =
// ceil(sq * g / bm). Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a shape or layout the kernel does not take.
extern "C" int repro_flash_attention(
    int kernel, const void* q, const void* k, const void* v, void* out,
    int dtype, const int* qpos, const int* kpos, const unsigned char* kvalid,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long qp_sb, long long kp_sb, long long kv_sb,
    int batch, int sq, int sk, int kvh, int g, int hd,
    int causal, int window, float cap, float scale, int bm, int nsplit,
    float* part_acc, float* part_ml, int* kpm, void* tsum, int* sem,
    void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (batch <= 0 || batch > 65535 || kvh <= 0 || kvh > 65535 || g <= 0 ||
      sq <= 0 || sk <= 0 || hd <= 0 || hd > 256 || (dtype != 0 && dtype != 1) ||
      bm <= 0 || nsplit <= 0 ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (static_cast<long long>(sq) * g + bm - 1) / bm * nsplit > 0x7fffffffLL) {
    return static_cast<int>(bad);
  }
  Params a{q, k, v, out, qpos, kpos, kvalid,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, qp_sb, kp_sb, kv_sb,
           sq, sk, kvh, g, hd, causal, window, cap, scale,
           nsplit, part_acc, part_ml, bm, kpm, static_cast<int4*>(tsum),
           sem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    if (bm != 16 && bm != 64) return static_cast<int>(bad);
    return dtype == 0 ? launch_fwd_hd<float>(a, batch, s)
                      : launch_fwd_hd<__nv_bfloat16>(a, batch, s);
  }
  if (kernel == 1) {
    const bool chunks = q_sb % 8 == 0 && q_ss % 8 == 0 && q_sh % 8 == 0 &&
                        k_sb % 8 == 0 && k_ss % 8 == 0 && k_sh % 8 == 0 &&
                        v_sb % 8 == 0 && v_ss % 8 == 0 && v_sh % 8 == 0 &&
                        o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
    if (dtype != 1 || bm != kTcRows || (hd != 64 && hd != 128) || !chunks ||
        !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
        !aligned16(kpm) || !aligned16(tsum)) {
      return static_cast<int>(bad);
    }
    return hd == 64 ? launch_tc<64>(a, batch, s) : launch_tc<128>(a, batch, s);
  }
  if (kernel == 3) {
    const bool chunks = q_sb % 4 == 0 && q_ss % 4 == 0 && q_sh % 4 == 0 &&
                        k_sb % 4 == 0 && k_ss % 4 == 0 && k_sh % 4 == 0 &&
                        v_sb % 4 == 0 && v_ss % 4 == 0 && v_sh % 4 == 0 &&
                        o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
    if (dtype != 0 || bm != kTcRows || (hd != 64 && hd != 128) || !chunks ||
        !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
        !aligned16(kpm) || !aligned16(tsum)) {
      return static_cast<int>(bad);
    }
    return hd == 64 ? launch_tf32<64>(a, batch, s) : launch_tf32<128>(a, batch, s);
  }
  if (kernel == 2) {
    if ((bm != 1 && bm != 2 && bm != 4 && bm != 8) ||
        (nsplit > 1 && sem == nullptr)) {
      return static_cast<int>(bad);
    }
    const long long w = dtype == 0 ? 4 : 8;  // elements in 16 bytes
    const int vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                    q_sb % w == 0 && q_ss % w == 0 && q_sh % w == 0 &&
                    k_sb % w == 0 && k_ss % w == 0 && k_sh % w == 0 &&
                    v_sb % w == 0 && v_ss % w == 0 && v_sh % w == 0;
    return dtype == 0 ? launch_decode_hd<float>(a, vec, batch, s)
                      : launch_decode_hd<__nv_bfloat16>(a, vec, batch, s);
  }
  return static_cast<int>(bad);
}

extern "C" const char* repro_flash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
