// The whole n-step leapfrog, and a one-shot potential value + gradient, for
// a separable potential given as an opcode table.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/fused_leapfrog/kernel.py:
//   fused_leapfrog      <- _make_leapfrog_kernel (:38) / leapfrog_2d (:92)
//   fused_potential_vg  <- _make_potential_vg_kernel (:130) / potential_vg_2d (:159)
//
// What each computes, for every chain c of a (C, dim) float32 state, with
// the opcode table op, c0..c3 of length dim shared by every chain (read
// with stride 0 over chains, never copied per chain):
//   fused_leapfrog:     n_steps of velocity Verlet in the order of
//                       repro_torch.infer.hmc._leapfrog,
//                         p_half = p + 0.5 eps[c] g
//                         q      = q + eps[c] (inv_mass * p_half)
//                         g      = dv/du at q       (analytic, elementwise)
//                         p      = p_half + 0.5 eps[c] g
//                       then out[c] = sum_i v_op(q_i) + const at the
//                       final q.
//   fused_potential_vg: g = dv/du at q and out[c] = sum_i v_op(q_i) + const.
// The spec's const is added in float32 after the sum, as the JAX package's
// wrappers add it (fused_leapfrog/ops.py:127,164).
// The opcode forms are those of kernels/fused_leapfrog/spec.py, with the
// overflow-safe softplus and logistic.
//
// What bounds them on an H100: bytes, and below about a megabyte one
// launch's latency. The leapfrog reads q, p, g and writes them back (24 B
// per element) and reads the table once: 4 B per coordinate for each
// coefficient array the opcode uses, plus 4 B for op in the any-opcode
// kernel (kCoeffsRead below). For gaussian_10k (uniform NORMAL: c0, c1) at
// 4 x 10,000 that is ~1.04 MB, ~0.31 us at 3.35 TB/s, against ~40 float
// ops per element (~0.02 us at 67 TFLOP/s); family_mix_8k's mixed table
// at 4 x 8,192 moves ~0.95 MB. The potential moves ~0.40 MB, ~0.12 us. At
// the main paths' shapes both are near a launch's latency (~1 us), so the
// number of launches a call and the time to the first load set the pace.
//
// Design. The gradient is elementwise, so no coordinate ever reads another:
// each thread owns one coordinate of one chain and keeps its q, p, g in
// registers through all n_steps (the property that makes the TPU kernel a
// single launch; here it also needs no shared memory). The ragged end is
// masked by index: the TPU kernel pads to (R, 128) tiles with zero
// coefficients, a TPU layout rule with no use here. The opcode and the
// inverse mass are template parameters: a table with one opcode runs an
// instantiation without the per-element switch, and a table with several
// switches per element (the Pallas kernel evaluates every branch under
// `where` instead; family_mix_8k's opcodes change only every 512 or more
// coordinates, so a warp's switch does not diverge).
//
// Both are ONE launch a call, of one kernel: fused_potential_vg is a mode
// of leapfrog_kernel (kPotential) that evaluates g at q and neither reads
// nor writes p. A block holds kLfThreads coordinates of one chain (grid
// (ceil(dim / kLfThreads), C)); a chain of at most kLfThreads coordinates
// is one block that writes out[c] itself. A longer chain's blocks each
// write a partial sum of the potential and take a ticket from an int
// count of the chain (one atom.acq_rel); the block that draws the last
// ticket sums the chain's partials in index order, adds const, writes
// out[c] and resets the count to 0 (fused_logpdf.cu's row_sum,
// mvn_quad.cu's). No float atomics, and a thread's coordinate and the
// order of every sum are functions of dim alone, so reruns are
// bit-identical; the potential keeps the partition and order of its
// former kernel and per-chain finish (two launches), so it gives their
// bits. The wrapper keeps the partials and counts once per (device,
// stream), so a call allocates only its outputs. At the main paths'
// shapes the time is latency: loads, the n dependent steps, the block sum
// and the merge. Device time on an H100 80GB HBM3 at 700 W
// (chip_compare.py leapfrog, against the parent's in one process): the
// leapfrog 3.0 us at gaussian_10k's 4 x 10,000 x 4 steps, 3.6 at
// family_mix_8k's 4 x 8,192; the potential 2.74-2.76 and 3.02 us by the
// profiler's kernel time (2.77 and 3.14 for the two launches), 3.77 and
// 3.93 us a call issued behind a spin (4.72-4.85 and 5.09: the gap
// between the two launches); the host issues a call in 0.57-0.64 of the
// parent's time.
// Ablations, at those shapes: the leapfrog with four consecutive
// coordinates a thread and 16-byte loads in blocks of 1,024, 3.7 and 7.0
// us (family_mix_8k's four switched coordinates a thread run one after
// another); blocks of 128 and 512 of one coordinate a thread within 0.25
// us of 256 each way. The potential as one thread-block cluster of 8 or
// 16 blocks a chain merging in distributed shared memory
// (probes/potential_vg_cluster.cu, chip_compare.py cluster): 2.28 and
// 2.33 us at the first shape, 3.60-3.63 and 3.16 at the second (mixed
// opcodes, several switched coordinates a thread); it would leave a chain
// of 10^6 coordinates to 16 blocks, and is not used. Built without
// --use_fast_math: expf and log1pf are the accurate versions.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

// Coordinates of one chain a block holds, one a thread, in every mode
// (ops.LEAPFROG_SHARE mirrors it)
constexpr int kLfThreads = 256;
constexpr int kAnyOp = -1;
constexpr int kZero = 0, kNormal = 1, kExp = 2, kSoftplus = 3, kTlog = 4;

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

__device__ __forceinline__ float logistic(float x) {
  const float e = expf(-fabsf(x));
  return x >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

// v_op(u) and dv/du. With OP fixed at compile time the switch folds away
// and the unused coefficient loads are dropped.
template <int OP>
__device__ __forceinline__ float elem_value(int op, float u, float c0, float c1,
                                            float c2, float c3) {
  switch (OP == kAnyOp ? op : OP) {
    case kNormal: {
      const float z = (u - c0) * c1;
      return -0.5f * z * z;
    }
    case kExp:
      return c0 * u - c1 * expf(c2 * u);
    case kSoftplus:
      return -c0 * softplus(-u) - c1 * softplus(u);
    case kTlog: {
      const float zt = (u - c2) * c3;
      return -c0 * log1pf(c1 * zt * zt);
    }
    default:
      return 0.0f;
  }
}

template <int OP>
__device__ __forceinline__ float elem_grad(int op, float u, float c0, float c1,
                                           float c2, float c3) {
  switch (OP == kAnyOp ? op : OP) {
    case kNormal:
      return -(u - c0) * (c1 * c1);
    case kExp:
      return c0 - c1 * c2 * expf(c2 * u);
    case kSoftplus:
      return c0 * logistic(-u) - c1 * logistic(u);
    case kTlog: {
      const float zt = (u - c2) * c3;
      return -2.0f * c0 * c1 * zt * c3 / (1.0f + c1 * zt * zt);
    }
    default:
      return 0.0f;
  }
}

// Sum over a block of T threads; the result is valid in thread 0. Fixed
// order.
template <int T>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[T / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = (threadIdx.x < T / 32) ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

struct Table {
  const int* op;
  const float* c0;
  const float* c1;
  const float* c2;
  const float* c3;
};

struct Coeffs {
  int op;
  float c0, c1, c2, c3;
};

// Coefficient arrays each opcode reads: NORMAL and SOFTPLUS c0 c1, EXP
// c0..c2, TLOG c0..c3, ZERO none; the any-opcode kernel reads all four.
template <int OP>
constexpr int kCoeffsRead = OP == kAnyOp || OP == kTlog ? 4
                            : OP == kExp                ? 3
                            : OP == kZero               ? 0
                                                        : 2;

// A table with one opcode reads neither op nor the arrays it does not use.
template <int OP>
__device__ __forceinline__ Coeffs load_coeffs(const Table& t, long long i) {
  constexpr int n = kCoeffsRead<OP>;
  Coeffs c;
  c.op = OP == kAnyOp ? t.op[i] : OP;
  c.c0 = n > 0 ? t.c0[i] : 0.0f;
  c.c1 = n > 1 ? t.c1[i] : 0.0f;
  c.c2 = n > 2 ? t.c2[i] : 0.0f;
  c.c3 = n > 3 ? t.c3[i] : 0.0f;
  return c;
}

struct LeapfrogArgs {
  const float* q;
  long long q_rs;  // row strides, in elements (0: one row for every chain)
  const float* p;
  long long p_rs;
  const float* g;
  long long g_rs;
  const float* eps;     // chain c's step at eps[c * eps_stride], or null:
  long long eps_stride; // eps_value for every chain
  float eps_value;
  const float* inv_mass;  // (dim,) or null
  Table table;
  long long dim;
  int n_steps;
  float* state_out;  // (3, C, dim), dense: q, p, g; the potential's g (C, dim)
  float* partials;   // (C, gridDim.x) when a chain takes several blocks
  int* counts;       // (C,), zero between calls
  float const_term;
  float* out;        // (C,)
};

// What a launch computes: the n steps with a unit or a diagonal inverse
// mass, or fused_potential_vg's g at q (which neither reads p nor writes it).
constexpr int kUnitMass = 0, kMass = 1, kPotential = 2;

// Grid (nparts, C). Block (b, c) takes coordinates [b kLfThreads,
// (b + 1) kLfThreads) of chain c, one a thread; the potential at the final
// q is summed in a fixed order, and the chain's sum is written by its only
// block or by the block that draws its last ticket.
template <int OP, int MODE>
__global__ void __launch_bounds__(kLfThreads) leapfrog_kernel(LeapfrogArgs a) {
  __shared__ bool merge_last;
  const int c = blockIdx.y;
  const int parts = gridDim.x;
  const long long dim = a.dim;
  const long long i = static_cast<long long>(blockIdx.x) * kLfThreads + threadIdx.x;
  float v = 0.0f;
  if (i < dim) {
    const Coeffs k = load_coeffs<OP>(a.table, i);
    float q = a.q[c * a.q_rs + i];
    if (MODE == kPotential) {
      a.state_out[c * dim + i] = elem_grad<OP>(k.op, q, k.c0, k.c1, k.c2, k.c3);
    } else {
      const float eps = a.eps != nullptr ? a.eps[c * a.eps_stride] : a.eps_value;
      const float half_eps = 0.5f * eps;
      const float im = MODE == kMass ? a.inv_mass[i] : 1.0f;
      float p = a.p[c * a.p_rs + i];
      float g = a.g[c * a.g_rs + i];
      for (int s = 0; s < a.n_steps; ++s) {
        const float p_half = p + half_eps * g;
        const float vel = MODE == kMass ? im * p_half : p_half;
        q = q + eps * vel;
        g = elem_grad<OP>(k.op, q, k.c0, k.c1, k.c2, k.c3);
        p = p_half + half_eps * g;
      }
      const long long plane = static_cast<long long>(gridDim.y) * dim;
      float* qo = a.state_out + c * dim + i;
      qo[0] = q;
      qo[plane] = p;
      qo[2 * plane] = g;
    }
    v = elem_value<OP>(k.op, q, k.c0, k.c1, k.c2, k.c3);
  }
  v = block_sum<kLfThreads>(v);
  if (parts == 1) {
    if (threadIdx.x == 0) a.out[c] = v + a.const_term;
    return;
  }
  if (threadIdx.x == 0) {
    a.partials[static_cast<long long>(c) * parts + blockIdx.x] = v;
    // release this block's partial, acquire the others' (one atom.acq_rel)
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(a.counts[c]);
    merge_last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == parts - 1;
  }
  __syncthreads();
  if (!merge_last) return;
  const float* prow = a.partials + static_cast<long long>(c) * parts;
  float total = 0.0f;
  for (int j = threadIdx.x; j < parts; j += kLfThreads) total += __ldcg(prow + j);
  total = block_sum<kLfThreads>(total);
  if (threadIdx.x == 0) {
    a.out[c] = total + a.const_term;
    a.counts[c] = 0;
  }
}

template <int MODE>
void launch(int uniform_op, int nparts, int rows, cudaStream_t s, const LeapfrogArgs& a) {
  const dim3 grid(nparts, rows);
  switch (uniform_op) {
    case kZero: leapfrog_kernel<kZero, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
    case kNormal: leapfrog_kernel<kNormal, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
    case kExp: leapfrog_kernel<kExp, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
    case kSoftplus: leapfrog_kernel<kSoftplus, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
    case kTlog: leapfrog_kernel<kTlog, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
    default: leapfrog_kernel<kAnyOp, MODE><<<grid, kLfThreads, 0, s>>>(a); break;
  }
}

// A plan the kernel refuses: nparts must be ceil(dim / kLfThreads), and a
// chain of several blocks needs scratch to merge in.
bool bad_plan(int rows, long long dim, int nparts, int uniform_op,
              const float* partials, const int* counts) {
  return rows <= 0 || rows > 65535 || dim <= 0 ||
         nparts != (dim + kLfThreads - 1) / kLfThreads || uniform_op < kAnyOp ||
         uniform_op > kTlog || (nparts > 1 && (partials == nullptr || counts == nullptr));
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = success);
// launches go on the caller's stream and do not synchronise. Each is one
// launch: the caller allocates the outputs, `out` rows floats. nparts must
// be ceil(dim / 256) (ops.leapfrog_parts); with one part `partials` and
// `counts` may be null, else `partials` holds rows * nparts floats and
// `counts` rows ints that are zero (the kernel leaves them zero).
// `uniform_op` is the table's one opcode, or -1 when it holds several;
// `const_term` is the spec's const in float32.
//
// fused_leapfrog: `state_out` holds 3 * rows * dim floats (q, p, g, each
// dense). `eps` is chain c's step at eps[c * eps_stride], or null for
// `eps_value` in every chain.
extern "C" int repro_fused_leapfrog(const float* q, long long q_rs, const float* p,
                                    long long p_rs, const float* g, long long g_rs,
                                    const float* eps, long long eps_stride,
                                    float eps_value, const int* op, const float* c0,
                                    const float* c1, const float* c2, const float* c3,
                                    const float* inv_mass, int uniform_op, int rows,
                                    long long dim, int n_steps, int nparts,
                                    float* state_out, float* partials, int* counts,
                                    float const_term, float* out, void* stream) {
  if (n_steps < 0 || bad_plan(rows, dim, nparts, uniform_op, partials, counts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LeapfrogArgs a{q, q_rs, p, p_rs, g, g_rs, eps, eps_stride, eps_value,
                 inv_mass, Table{op, c0, c1, c2, c3}, dim, n_steps, state_out,
                 partials, counts, const_term, out};
  if (inv_mass != nullptr) {
    launch<kMass>(uniform_op, nparts, rows, s, a);
  } else {
    launch<kUnitMass>(uniform_op, nparts, rows, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// fused_potential_vg: `g_out` holds rows * dim floats (dense).
extern "C" int repro_fused_potential_vg(const float* q, long long q_rs, const int* op,
                                        const float* c0, const float* c1,
                                        const float* c2, const float* c3,
                                        int uniform_op, int rows, long long dim,
                                        int nparts, float* g_out, float* partials,
                                        int* counts, float const_term, float* out,
                                        void* stream) {
  if (bad_plan(rows, dim, nparts, uniform_op, partials, counts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeapfrogArgs a{q, q_rs, nullptr, 0, nullptr, 0, nullptr, 0, 0.0f, nullptr,
                 Table{op, c0, c1, c2, c3}, dim, 0, g_out, partials, counts,
                 const_term, out};
  launch<kPotential>(uniform_op, nparts, rows, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_fused_leapfrog_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
