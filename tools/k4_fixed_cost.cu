// Probes of the int4 GEMV's (K4's) fixed cost on an H100, for
// tools/k4_fixed_cost.py: kernels with the launch geometry of a K4 design of
// 128-column tiles in clusters of up to 8 CTAs splitting I (grid = tiles x
// cluster, 256 threads), each doing one part of that design's work and no
// arithmetic:
// - empty: the launch alone, with or without the cluster barriers;
// - staged: that design's loads in its order (x staged in shared memory and
//   a block barrier, the group sums of x, the packed rows four at a time with
//   each row's scales, then the cluster wait, the mins and a cluster.sync);
// - at_once: the same bytes issued before any is consumed (each thread's
//   packed rows, its (group, column) scales and mins, its x), with or
//   without the cluster barriers.
// A result is stored only if an impossible value turns up, so no load is
// dropped. Plain C interface, bound with ctypes.

#include <cooperative_groups.h>

#include <cstdint>

#include "../faster_qwen3_tts_tpu_torch/csrc/common.cuh"

namespace cg = cooperative_groups;
using namespace fq3t;

namespace {

constexpr int kThreads = 256, kColLanes = 8, kCols = 128, kRowLanes = 32;
constexpr unsigned kNever = 0x9E3779B9u;

template <bool kCluster>
__global__ void __launch_bounds__(kThreads) empty_kernel() {
  if (kCluster) {
    cluster_arrive_relaxed();
    cluster_wait();
    cg::this_cluster().sync();
  }
}

__global__ void __launch_bounds__(kThreads) staged_kernel(const __nv_bfloat16* x, const uint8_t* packed,
                                                          const float* scale, const float* wmin, unsigned* y,
                                                          int I, int O, int group, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int c = cluster.num_blocks(), rank = cluster.block_rank();
  const int col_base = (blockIdx.x / c) * kCols;
  const int g0 = rank * per, ng = max(0, min(per, I / group - g0));
  const int row0 = g0 * group, prows = ng * group / 2, half = group / 2;
  const int tid = threadIdx.x, col = col_base + (tid % kColLanes) * 16, rl = tid / kColLanes;
  extern __shared__ float smem[];
  float* x_s = smem;
  float* xsum = x_s + per * group;
  for (int i = tid; i < per * group; i += kThreads) x_s[i] = i < ng * group ? to_float(x[row0 + i]) : 0.f;
  __syncthreads();
  for (int i = tid; i < per; i += kThreads) {
    float s = 0.f;
    for (int k = 0; k < group; ++k) s += x_s[i * group + k];
    xsum[i] = s;
  }
  unsigned acc = 0;
  const uint8_t* base = packed + (size_t)(row0 / 2) * O + col;
  for (int j0 = rl; j0 < prows; j0 += 4 * kRowLanes) {
    uint4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kRowLanes;
      w[u] = j < prows ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)j * O)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kRowLanes;
      if (j < prows) {
        const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)(g0 + j / half) * O + col);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc ^= __float_as_uint(__ldg(sp + q).x);
        acc ^= w[u].x ^ w[u].y ^ w[u].z ^ w[u].w;
      }
    }
  }
  cluster_wait();
  for (int gl = 0; gl < ng; ++gl) acc ^= __float_as_uint(wmin[(size_t)(g0 + gl) * O + col_base + tid % kCols] * xsum[gl]);
  cluster.sync();
  if (acc == kNever) y[blockIdx.x * kThreads + tid] = acc;
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads) at_once_kernel(const __nv_bfloat16* x, const uint8_t* packed,
                                                           const float* scale, const float* wmin, unsigned* y,
                                                           int I, int O, int group, int per, int c) {
  if (kCluster) cluster_arrive_relaxed();
  const int rank = blockIdx.x % c, col_base = (blockIdx.x / c) * kCols;
  const int g0 = rank * per, ng = max(0, min(per, I / group - g0));
  const int row0 = g0 * group, prows = ng * group / 2;
  const int tid = threadIdx.x, col = col_base + (tid % kColLanes) * 16, rl = tid / kColLanes;
  const uint8_t* base = packed + (size_t)(row0 / 2) * O + col;
  unsigned acc = 0;
  for (int j0 = rl; j0 < prows; j0 += 8 * kRowLanes) {
    uint4 w[8];
    float s[8], m[8];
    __nv_bfloat16 xv[2];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kRowLanes;
      w[u] = j < prows ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)j * O)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {  // each (group, column) of the slab once, on the first pass
      const int i = tid + u * kThreads, gl = i / kCols, cc = i % kCols;
      const bool ok = j0 == rl && gl < ng;
      s[u] = ok ? __ldg(scale + (size_t)(g0 + gl) * O + col_base + cc) : 0.f;
      m[u] = ok ? __ldg(wmin + (size_t)(g0 + gl) * O + col_base + cc) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      xv[u] = j0 == rl && tid + u * kThreads < ng * group ? x[row0 + tid + u * kThreads] : __float2bfloat16(0.f);
    float f = to_float(xv[0]) + to_float(xv[1]);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc ^= w[u].x ^ w[u].y ^ w[u].z ^ w[u].w;
      f += s[u] * m[u];
    }
    acc ^= __float_as_uint(f);
  }
  if (kCluster) {
    cluster_wait();
    cg::this_cluster().sync();
  }
  if (acc == kNever) y[blockIdx.x * kThreads + tid] = acc;
}

}  // namespace

// Each returns a cudaError_t. grid = (O / 128) * cluster CTAs; `per` groups
// of I per CTA; cluster 1 launches without one.
extern "C" int k4p_empty(int grid, int cluster, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (cluster > 1) return launch_cluster<empty_kernel<true>>(dim3(grid), kThreads, 0, cluster, st);
  empty_kernel<false><<<grid, kThreads, 0, st>>>();
  return cudaGetLastError();
}

extern "C" int k4p_staged(const void* x, const void* packed, const void* scale, const void* wmin, void* y, int I,
                          int O, int group, int per, int cluster, void* stream) {
  const int grid = ((O + kCols - 1) / kCols) * cluster;
  return launch_cluster<staged_kernel>(dim3(grid), kThreads, (per * group + per) * 4, cluster,
                                       static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                                       static_cast<const float*>(wmin), static_cast<unsigned*>(y), I, O, group, per);
}

extern "C" int k4p_at_once(int with_cluster, const void* x, const void* packed, const void* scale, const void* wmin,
                           void* y, int I, int O, int group, int per, int cluster, void* stream) {
  const int grid = ((O + kCols - 1) / kCols) * cluster;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  const auto* m = static_cast<const float*>(wmin);
  auto* out = static_cast<unsigned*>(y);
  if (with_cluster)
    return launch_cluster<at_once_kernel<true>>(dim3(grid), kThreads, 0, cluster, st, xb, p, s, m, out, I, O, group,
                                                per, cluster);
  at_once_kernel<false><<<grid, kThreads, 0, st>>>(xb, p, s, m, out, I, O, group, per, cluster);
  return cudaGetLastError();
}
