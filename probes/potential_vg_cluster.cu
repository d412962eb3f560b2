// An alternative design of fused_potential_vg, kept for the comparison that
// chose between the two (chip_compare.py cluster); the port does not use it.
//
// The port's kernel (src/repro_torch/kernels/fused_leapfrog/csrc/
// fused_leapfrog.cu) gives a chain ceil(dim / 256) blocks of one coordinate
// a thread and merges their sums in the block that draws the chain's last
// ticket from a count in device memory. Here a chain is one thread-block
// cluster of CLUSTER blocks (8, the portable size, or 16): thread t of
// block b takes coordinates b 256 + t + k CLUSTER 256, k = 0, 1, ..., up
// to kPer of them at a time (their loads issued together), and each block
// writes its sum into the shared memory of the cluster's first block
// (distributed shared memory), which sums them in rank order after one
// cluster barrier. No partials, counts or atomics in device memory; the
// partition, and so the order of the sum, differs from the port's kernel,
// so the bits may differ within the plain version's tolerances.
#include <cooperative_groups.h>

#include "../src/repro_torch/kernels/fused_leapfrog/csrc/fused_leapfrog.cu"

namespace {

namespace cg = cooperative_groups;
constexpr int kPer = 8;  // coordinates a thread loads before it computes

template <int OP, int CLUSTER>
__global__ void __launch_bounds__(kLfThreads) potential_cluster_kernel(LeapfrogArgs a) {
  __shared__ float sums[CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long dim = a.dim;
  const long long step = static_cast<long long>(CLUSTER) * kLfThreads;
  float v = 0.0f;
  for (long long base = static_cast<long long>(rank) * kLfThreads + threadIdx.x;
       base < dim; base += kPer * step) {
    Coeffs k[kPer];
    float q[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = base + j * step;
      q[j] = 0.0f;
      k[j] = Coeffs{kZero, 0.0f, 0.0f, 0.0f, 0.0f};
      if (i < dim) {
        k[j] = load_coeffs<OP>(a.table, i);
        q[j] = a.q[c * a.q_rs + i];
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = base + j * step;
      if (i < dim) {
        a.state_out[c * dim + i] =
            elem_grad<OP>(k[j].op, q[j], k[j].c0, k[j].c1, k[j].c2, k[j].c3);
        v += elem_value<OP>(k[j].op, q[j], k[j].c0, k[j].c1, k[j].c2, k[j].c3);
      }
    }
  }
  v = block_sum<kLfThreads>(v);
  if (threadIdx.x == 0) *cluster.map_shared_rank(&sums[rank], 0) = v;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (int j = 0; j < CLUSTER; ++j) total += sums[j];
    a.out[c] = total + a.const_term;
  }
}

template <int OP, int CLUSTER>
cudaError_t launch_cluster(int rows, cudaStream_t s, const LeapfrogArgs& a) {
  auto kern = potential_cluster_kernel<OP, CLUSTER>;
  static bool allowed = CLUSTER <= 8;  // 16 is a non-portable size
  if (!allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, rows);
  cfg.blockDim = dim3(kLfThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <int CLUSTER>
cudaError_t launch_any(int uniform_op, int rows, cudaStream_t s, const LeapfrogArgs& a) {
  switch (uniform_op) {
    case kZero: return launch_cluster<kZero, CLUSTER>(rows, s, a);
    case kNormal: return launch_cluster<kNormal, CLUSTER>(rows, s, a);
    case kExp: return launch_cluster<kExp, CLUSTER>(rows, s, a);
    case kSoftplus: return launch_cluster<kSoftplus, CLUSTER>(rows, s, a);
    case kTlog: return launch_cluster<kTlog, CLUSTER>(rows, s, a);
    default: return launch_cluster<kAnyOp, CLUSTER>(rows, s, a);
  }
}

}  // namespace

// repro_fused_potential_vg's arguments without nparts and the scratch, and
// the cluster's blocks (8 or 16); one launch on the caller's stream.
extern "C" int repro_potential_vg_cluster(const float* q, long long q_rs, const int* op,
                                          const float* c0, const float* c1,
                                          const float* c2, const float* c3,
                                          int uniform_op, int rows, long long dim,
                                          int cluster, float* g_out, float const_term,
                                          float* out, void* stream) {
  if (rows <= 0 || rows > 65535 || dim <= 0 || uniform_op < kAnyOp ||
      uniform_op > kTlog || (cluster != 8 && cluster != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeapfrogArgs a{q, q_rs, nullptr, 0, nullptr, 0, nullptr, 0, 0.0f, nullptr,
                 Table{op, c0, c1, c2, c3}, dim, 0, g_out, nullptr, nullptr,
                 const_term, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cluster == 8 ? launch_any<8>(uniform_op, rows, s, a)
                                 : launch_any<16>(uniform_op, rows, s, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
