// K4: weight-only int4 GEMV with group-wise scale and min,
//   y[m, o] = sum_g ( scale[g, o] * sum_{i in g} x[m, i] * nib[i, o] + wmin[g, o] * sum_{i in g} x[m, i] )
// for x [M <= 16, I] (bf16 or f32), packed uint8 [I/2, O] (high nibble = even
// row, low nibble = odd row), scale and wmin f32 [I/group, O].
//
// Replaces no Pallas kernel: its spec is `_dot4` of
// faster_qwen3_tts_tpu/ops/quant.py:87, which XLA computes. It serves every
// Q4_K_M projection at decode (M <= 16 rows) and, in Q8_4, every predictor
// projection (layers, lm_heads, mtp_proj).
//
// What bounds it on an H100: device memory. Per weight it reads half a byte
// of nibbles plus 8 bytes of f32 scale and min per group of 32 weights, 0.75
// bytes against K2's 1.0: the 1.7B gate/up (2048 x 6144) is 9.44 MB, 2.82 us
// at 3.35 TB/s, the 0.6B gate/up (1024 x 3072) 2.36 MB, 0.70 us. For M <= 16
// the tensor cores would have nothing to do.
//
// Design (simple first; one launch, no global scratch, no counters):
// - Grid and clusters, as K2 (csrc/int8_gemv.cu): each 128-column tile of y
//   gets a thread-block cluster of c <= 8 CTAs that split I into slabs of
//   whole quantization groups; grid.y covers groups of up to 4 rows of x.
//   The wrapper (ops/quant.py `_int4_plan`) picks c so that tiles x c fills
//   the card about twice: at O = 1024 there are only 8 tiles.
// - Staging x. The CTA's slice of x (at most 4 rows) goes to shared memory
//   once, as f32, and each group's sum of x is taken there once, in order.
// - The weight stream. 256 threads: 8 across the 128 columns (16 packed
//   bytes, 16 columns, each) and 32 down the packed rows. Each thread reads
//   its 16 bytes of a packed row with one read-only load, coalesced with its
//   neighbours, four rows in flight; both nibbles are unpacked in registers
//   (a mask, a shift and a permute into the mantissa of 2^23, no
//   int-to-float unit), and the row pair's sum x_even * hi + x_odd * lo is
//   scaled by its group's scale as it is added. The min term, the group's
//   sum of x times wmin, is added once per group and output in the merge.
//   (Adding it in the stream instead, by the thread that takes a group's
//   first packed row, was measured no faster at 1-2 rows and slower at
//   8-16: PERF.md, section 6, K4.)
// - The reduction, through distributed shared memory, as K2: the 32 row
//   lanes are summed with shuffles and across the 8 warps in shared memory
//   in order; each CTA writes its partial of every output into the shared
//   memory of the CTA that stores it; after one cluster.sync() each CTA sums
//   its outputs over the cluster in rank order and rounds once to the
//   activation dtype. The sum is deterministic and the call capture-safe.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fq3t {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColLanes = 8;                       // threads across columns
constexpr int kColsPerThread = 16;                 // 16 packed bytes, 16 columns
constexpr int kCols = kColLanes * kColsPerThread;  // 128 columns per tile
constexpr int kRowLanes = kThreads / kColLanes;    // 32
constexpr int kUnroll = 4;                         // packed rows a thread has in flight
constexpr int kMaxRows = 4;                        // rows of x per CTA
constexpr int kMaxCluster = 8;                     // portable cluster size

// Dynamic shared memory of one CTA (floats: warp partials, the cluster's
// partials, x's slice, the group sums); ops/quant.py::_int4_plan computes the
// same sum, and the launch refuses a smaller one.
__host__ __device__ constexpr int smem_bytes(int mr, int groups_per_cta, int group) {
  return (kWarps * mr * kCols + mr * kCols + kMaxCluster + mr * groups_per_cta * group +
          mr * groups_per_cta) * 4;
}

// The four nibbles of `bits` (0x0F0F0F0F-masked bytes) as floats, exactly.
__device__ __forceinline__ void nibbles_to_floats(unsigned bits, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(bits, 0x4B000000u, 0x7540u + j)) - 8388608.f;
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads) int4_gemv_kernel(
    const T* __restrict__ x,              // [M, I]
    const uint8_t* __restrict__ packed,   // [I/2, O]
    const float* __restrict__ scale,      // [I/group, O]
    const float* __restrict__ wmin,       // [I/group, O]
    T* __restrict__ y,                    // [M, O]
    int M, int I, int O, int group, int groups_per_cta) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int col_base = (blockIdx.x / c) * kCols;
  const int m0 = blockIdx.y * MR;
  const int mcount = min(MR, M - m0);
  const int per = groups_per_cta;
  const int g0 = rank * per;
  const int ng = max(0, min(per, I / group - g0));  // groups this CTA reduces
  const int row0 = g0 * group, rows = ng * group;
  const int half = group / 2;  // packed rows per group
  const int prows = rows / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid % kColLanes, rl = tid / kColLanes;
  const int col = col_base + cl * kColsPerThread;
  const int n_out = mcount * kCols;
  const int per_out = (n_out + c - 1) / c;  // outputs stored by each CTA of the cluster

  extern __shared__ __align__(16) float smem[];
  float* wpart = smem;                           // [kWarps][MR][kCols]
  float* gpart = wpart + kWarps * MR * kCols;    // [c][per_out]
  float* x_s = gpart + MR * kCols + kMaxCluster; // [MR][per * group]
  float* xsum = x_s + MR * per * group;          // [MR][per]
  const int xs_stride = per * group;

  for (int i = tid; i < MR * xs_stride; i += kThreads) {
    const int m = i / xs_stride, r = i - m * xs_stride;
    x_s[i] = (m < mcount && r < rows) ? to_float(x[(size_t)(m0 + m) * I + row0 + r]) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < MR * per; i += kThreads) {  // read in the merge, after a barrier
    const float* xp = x_s + (i / per) * xs_stride + (i % per) * group;
    float s = 0.f;
    for (int k = 0; k < group; ++k) s += xp[k];
    xsum[i] = s;
  }

  float acc[MR][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  if (col < O) {
    const uint8_t* pbase = packed + (size_t)(row0 / 2) * O + col;
    for (int j0 = rl; j0 < prows; j0 += kUnroll * kRowLanes) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kRowLanes;
        w[u] = j < prows ? __ldg(reinterpret_cast<const uint4*>(pbase + (size_t)j * O))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kRowLanes;
        if (j < prows) {
          const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)(g0 + j / half) * O + col);
          float s[kColsPerThread];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = __ldg(sp + q);
            s[4 * q] = v.x;
            s[4 * q + 1] = v.y;
            s[4 * q + 2] = v.z;
            s[4 * q + 3] = v.w;
          }
          float hi[kColsPerThread], lo[kColsPerThread];
          const unsigned words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            nibbles_to_floats((words[q] >> 4) & 0x0F0F0F0Fu, hi + 4 * q);
            nibbles_to_floats(words[q] & 0x0F0F0F0Fu, lo + 4 * q);
          }
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float2 xv = reinterpret_cast<const float2*>(x_s + m * xs_stride)[j];
#pragma unroll
            for (int k = 0; k < kColsPerThread; ++k)
              acc[m][k] = fmaf(s[k], fmaf(xv.y, lo[k], xv.x * hi[k]), acc[m][k]);
          }
        }
      }
    }
  }

  // the 4 row lanes of a warp (lanes l, l^8, l^16, l^24) share their columns
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 8);
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
  if (lane < kColLanes) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; j += 4)
        *reinterpret_cast<float4*>(wpart + (warp * MR + m) * kCols + cl * kColsPerThread + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();
  // this CTA's partial of each output, its groups' min terms included, goes
  // straight into the shared memory of the CTA that stores that output
  cluster_wait();  // every CTA of the cluster is running: its shared memory may be written
  for (int i = tid; i < n_out; i += kThreads) {
    const int m = i / kCols, oc = col_base + (i - m * kCols);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wpart[w * MR * kCols + i];
    if (oc < O)
      for (int gl = 0; gl < ng; ++gl) s = fmaf(wmin[(size_t)(g0 + gl) * O + oc], xsum[m * per + gl], s);
    const int j = i / per_out;
    cluster.map_shared_rank(gpart, j)[rank * per_out + (i - j * per_out)] = s;
  }
  cluster.sync();  // every partial has reached its CTA

  // this CTA's outputs, summed over the cluster in rank order
  const int end = min(n_out, (rank + 1) * per_out);
  for (int i = rank * per_out + tid; i < end; i += kThreads) {
    const int m = i / kCols, oc = col_base + (i - m * kCols);
    if (oc < O) {
      float s = 0.f;
      for (int r = 0; r < c; ++r) s += gpart[r * per_out + (i - rank * per_out)];
      y[(size_t)(m0 + m) * O + oc] = from_float<T>(s);
    }
  }
}

template <typename T, int MR>
cudaError_t launch_mr(const void* x, const void* packed, const void* scale, const void* wmin, void* y,
                      int M, int I, int O, int group, int groups_per_cta, int cluster, int smem,
                      cudaStream_t stream) {
  if (smem < smem_bytes(MR, groups_per_cta, group) || smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  const dim3 grid(((O + kCols - 1) / kCols) * cluster, (M + MR - 1) / MR);
  return launch_cluster<int4_gemv_kernel<T, MR>>(
      grid, kThreads, smem, cluster, stream, static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(wmin), static_cast<T*>(y), M, I, O,
      group, groups_per_cta);
}

template <typename T>
cudaError_t launch(const void* x, const void* packed, const void* scale, const void* wmin, void* y, int M,
                   int I, int O, int group, int groups_per_cta, int cluster, int smem, cudaStream_t stream) {
  if (M == 1)
    return launch_mr<T, 1>(x, packed, scale, wmin, y, M, I, O, group, groups_per_cta, cluster, smem, stream);
  if (M == 2)
    return launch_mr<T, 2>(x, packed, scale, wmin, y, M, I, O, group, groups_per_cta, cluster, smem, stream);
  return launch_mr<T, kMaxRows>(x, packed, scale, wmin, y, M, I, O, group, groups_per_cta, cluster, smem,
                                stream);
}

}  // namespace
}  // namespace fq3t

// Returns a cudaError_t; 0 on success. x [M, I] and y [M, O] in `dtype`,
// packed uint8 [I/2, O], scale and wmin f32 [I/group, O] (all three 16-byte
// aligned, O % 16 == 0, group even and dividing I). `cluster` CTAs of
// `groups_per_cta` groups split I, with `smem` bytes of dynamic shared
// memory each: all from ops/quant.py::_int4_plan.
extern "C" int fq3t_int4_gemv(int dtype, const void* x, const void* packed, const void* scale,
                              const void* wmin, void* y, int M, int I, int O, int group,
                              int groups_per_cta, int cluster, int smem, void* stream) {
  using namespace fq3t;
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (M <= 0 || M > 16 || I <= 0 || O <= 0 || O % 16 != 0 || group < 2 || group % 2 != 0 ||
      I % group != 0 || misaligned(packed) || misaligned(scale) || misaligned(wmin) ||
      groups_per_cta <= 0 || cluster < 1 || cluster > kMaxCluster ||
      (long long)groups_per_cta * cluster < I / group ||
      (long long)groups_per_cta * (cluster - 1) >= I / group)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, packed, scale, wmin, y, M, I, O, group, groups_per_cta, cluster, smem, st);
  if (dtype == kFloat32)
    return launch<float>(x, packed, scale, wmin, y, M, I, O, group, groups_per_cta, cluster, smem, st);
  return cudaErrorInvalidValue;
}
