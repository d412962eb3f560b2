// GQA flash attention for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// _flash_kernel (:34), reached through flash_attention_bhd (:99, the
// pallas_call at :117). Computes, for every query row of every head,
//
//   out = softmax_j(mask(cap * tanh(q . k_j * scale / cap))) @ v
//
// with the masks taken from position arrays: causal (kp <= qp), sliding
// window (qp - kp < window) and kv validity. Scores, softcap, softmax and
// the accumulator are float32 whatever the input type (float32 or bf16);
// the output is written in the input type. NEG_INF is the finite -1e30, so
// a fully masked row gives exact zeros.
//
// What bounds it. Prefill (Sq in the thousands) is bound by operations:
// 4 hd flops per (query, key) pair that the masks keep. Decode (Sq = 1) is
// bound by bytes: every key and value of the cache is read once per kv head.
//
// Design. One block serves one (batch, kv head, tile of BM rows), where a
// row is one (query position, query head of the group): rows are numbered
// r = q * G + g, so the G query heads that share a kv head share the K and
// V tiles in shared memory and each key is read once per group. The block
// walks the keys in tiles of 64 with the online-softmax recurrence (running
// max m, sum l and accumulator per row, all in registers), which takes the
// place of the TPU kernel's sequential "arbitrary" grid axis and its VMEM
// scratch. Each tile of scores is a 64 x BM x hd product on the CUDA cores
// in float32 (4 x 4 outputs a thread from float4 loads of the transposed Q
// tile); P goes through shared memory for P @ V (4 rows x hd/16 columns a
// thread). The block reads the tile's positions and validity itself and
// skips a tile by the TPU kernel's predicates (kernel.py:51-62): no valid
// key; causal and every key after every query; window and every valid key
// out of every query's window. Ragged Sq and Sk are masked in the kernel
// (rows past Sq * G are not written, keys past Sk are invalid), so the
// caller pads nothing. BM is 64 for prefill and 16 when there are fewer
// than 64 rows (decode: G rows). A call with too few blocks to fill the
// card (decode: batch x kv heads) also splits the key tiles over nsplit
// blocks per row tile; each writes its rows' unnormalised (m, l, acc) to
// scratch and flash_combine merges the splits in a fixed order. No
// atomics: reruns are bit-identical. Later work: bf16 tensor-core products
// (wgmma), double-buffered tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// out[row] = sum_s acc_s e^{m_s - M} / sum_s l_s e^{m_s - M}, M = max_s m_s,
// the splits taken in order; a row no split saw (l = 0) gives zeros
template <typename T, int BM>
__global__ void __launch_bounds__(128) flash_combine(Params a) {
  T* __restrict__ out = static_cast<T*>(a.out);
  const long long b = blockIdx.z;
  const int kv = blockIdx.y;
  const long long tile = blockIdx.x;
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const long long first =
      ((b * a.kvh + kv) * gridDim.x + tile) * a.nsplit * BM;
  for (int idx = threadIdx.x; idx < BM * a.hd; idx += blockDim.x) {
    const int row = idx / a.hd, d = idx - row * a.hd;
    const long long r = tile * BM + row;
    if (r >= rows) continue;
    float mx = kNegInf;
    for (int sp = 0; sp < a.nsplit; ++sp)
      mx = fmaxf(mx, a.part_ml[2 * (first + sp * BM + row)]);
    float lsum = 0.0f, o = 0.0f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const long long pr = first + sp * BM + row;
      const float w = expf(a.part_ml[2 * pr] - mx);
      lsum += a.part_ml[2 * pr + 1] * w;
      o += a.part_acc[pr * a.hd + d] * w;
    }
    const long long qi = r / a.g;
    const int head = kv * a.g + static_cast<int>(r - qi * a.g);
    store(out + b * a.o_sb + qi * a.o_ss + head * a.o_sh + d,
          o / (lsum == 0.0f ? 1.0f : lsum));
  }
}

template <typename T, int HD, int BM>
int launch(const Params& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.sq) * a.g;
  const unsigned tiles = static_cast<unsigned>((rows + BM - 1) / BM);
  flash_fwd<T, HD, BM><<<dim3(tiles * a.nsplit, a.kvh, batch),
                         Layout<BM>::kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  flash_combine<T, BM><<<dim3(tiles, a.kvh, batch), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bm(const Params& a, int bm, int batch, cudaStream_t stream) {
  return bm == 16 ? launch<T, HD, 16>(a, batch, stream)
                  : launch<T, HD, 64>(a, batch, stream);
}

template <typename T>
int launch_hd(const Params& a, int bm, int batch, cudaStream_t stream) {
  if (a.hd <= 64) return launch_bm<T, 64>(a, bm, batch, stream);
  if (a.hd <= 128) return launch_bm<T, 128>(a, bm, batch, stream);
  return launch_bm<T, 256>(a, bm, batch, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; bm (rows per block): 16 or 64; nsplit > 1
// needs part_acc (B * KV * tiles * nsplit * bm * hd floats) and part_ml
// (twice B * KV * tiles * nsplit * bm), tiles = ceil(sq * g / bm). Returns
// a cudaError_t (0 on success); cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    const int* qpos, const int* kpos, const unsigned char* kvalid,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long qp_sb, long long kp_sb, long long kv_sb,
    int batch, int sq, int sk, int kvh, int g, int hd,
    int causal, int window, float cap, float scale, int bm, int nsplit,
    float* part_acc, float* part_ml, void* stream) {
  if (batch <= 0 || batch > 65535 || kvh <= 0 || kvh > 65535 || g <= 0 ||
      sq <= 0 || sk <= 0 || hd <= 0 || hd > 256 || (dtype != 0 && dtype != 1) ||
      (bm != 16 && bm != 64) || nsplit <= 0 ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (static_cast<long long>(sq) * g + bm - 1) / bm * nsplit > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a{q, k, v, out, qpos, kpos, kvalid,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, qp_sb, kp_sb, kv_sb,
           sq, sk, kvh, g, hd, causal, window, cap, scale,
           nsplit, part_acc, part_ml};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_hd<float>(a, bm, batch, s)
                    : launch_hd<__nv_bfloat16>(a, bm, batch, s);
}

extern "C" const char* repro_flash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
