// K2: weight-only int8 GEMV, y[M, O] = (x[M, I] @ q[I, O]) * scale[O].
//
// Replaces the TPU kernel `qmatvec` of faster_qwen3_tts_tpu/ops/matvec_pallas.py
// (git: f94c020^), whose spec today is the int8 branch of
// faster_qwen3_tts_tpu/ops/quant.py::dot. It serves every Q8_0 projection at
// decode (M <= 16 rows): q/k/v/o, gate/up/down, codec_head, the predictor's
// lm_heads and mtp_proj.
//
// What bounds it on an H100: device memory. The I * O int8 weight bytes are
// read once and each feeds M multiply-adds, so for M <= 16 the tensor cores
// have nothing to do; the goal is to keep enough bytes in flight to stream
// the weight at the HBM rate, and to spend few instructions per byte. The
// matrices are small (1-13 MB, 0.3-3.8 us at 3.35 TB/s), so a call's fixed
// costs (its launches, serial tails, dependent round trips) weigh as much as
// its bytes.
//
// Design: one launch, no global scratch, no counters.
// - Grid and clusters. Each 128-column tile of y gets a thread-block cluster
//   of c CTAs that split the reduction dim I (grid.y covers groups of up to 4
//   rows of x). The wrapper (ops/quant.py `_gemv_plan`) picks c <= 8 (the
//   portable maximum; 16 was measured slower) from (M, I, O) so that tiles x
//   c fills the card about once or twice where there are enough tiles; each
//   CTA owns a slab of rows_per_cta (a multiple of 64) rows.
// - The weight stream. A CTA streams its [rows_per_cta, 128] int8 slab
//   through a ring of 8 stages of 8 KB (up to 64 KB in flight per CTA, two
//   or more CTAs per SM): a main-path slab is at most 12 stages (the 1.7B
//   down projection; 7 or fewer elsewhere), so few stages wait for a refill
//   round trip. The ring is filled by TMA: one 2D box of 64 rows x 128
//   columns per stage, from a CUtensorMap over the whole [I, O] matrix that
//   is built once per weight pointer and cached. TMA was chosen over
//   per-row cp.async.bulk copies because a 128-column row is only 128 bytes:
//   one box per stage is one instruction from one thread instead of 64, and
//   the hardware zero-fills rows past I and columns past O, so no tail code.
//   Each stage completes on its own mbarrier; a stage is refilled as soon as
//   every thread has consumed it.
// - Byte conversion. Bytes become floats by K3's permute into the mantissa of
//   2^23 and one subtraction (common.cuh `bytes_to_floats`), not the
//   quarter-rate int-to-float unit.
// - Staging x. The CTA's slice of x (at most 4 rows) is copied to shared
//   memory once, in its own dtype, while the first stages are in flight.
// - The math. 256 threads: 8 across the 128 columns (16 bytes each) and 32
//   down the rows, f32 accumulators for 16 columns x up to 4 rows of x.
// - The reduction, through distributed shared memory. The 32 row lanes are
//   summed with warp shuffles and then across the 8 warps in shared memory
//   (in order). Each CTA of the cluster stores one slice of the tile's
//   outputs; every CTA writes its f32 partial of that slice straight into
//   the shared memory of the CTA that stores it (cluster.map_shared_rank):
//   remote stores, which do not wait for a round trip as remote loads
//   would. After one cluster.sync() each CTA sums its slice over the c
//   partials in rank order, applies the scale once, rounds to the
//   activation dtype and stores y. A relaxed cluster arrive at the start,
//   waited on before the first remote store, makes sure every CTA of the
//   cluster is running. The sum is deterministic, and the call is
//   capture-safe with no per-graph state.
// - Tensor cores are not used: at M = 1 or 2, the decode path's row counts,
//   they would have nothing to do.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fq3t {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColLanes = 8;                            // threads across columns
constexpr int kColsPerThread = 16;                      // 16 int8 weights, 16 bytes
constexpr int kCols = kColLanes * kColsPerThread;       // 128 columns per tile
constexpr int kRowLanes = kThreads / kColLanes;         // 32
constexpr int kChunkRows = 64;                          // rows per TMA box and ring stage
constexpr int kStages = 8;                              // 64 KB of a slab in flight
constexpr int kStageBytes = kChunkRows * kCols;         // 8 KB
constexpr int kMaxRows = 4;                             // rows of x per CTA
constexpr int kMaxCluster = 8;   // portable cluster size

// Dynamic shared memory of one CTA; ops/quant.py::_gemv_plan computes the
// same sum, and the launch refuses a smaller one.
__host__ __device__ constexpr int smem_bytes(int mr, int rows_per_cta, int elt) {
  return 128 + kStages * kStageBytes + (mr * kCols + kMaxCluster) * 4 + kStages * 8 +
         ((mr * rows_per_cta * elt + 15) / 16) * 16;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box (64 rows x 128 columns of the [I, O] matrix) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads) int8_gemv_kernel(
    const __grid_constant__ CUtensorMap wmap,  // q [I, O] int8, box [64 rows, 128 columns]
    const T* __restrict__ x,                   // [M, I]
    const float* __restrict__ scale,           // [O]
    T* __restrict__ y,                         // [M, O]
    int M, int I, int O, int rows_per_cta) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int col_base = (blockIdx.x / c) * kCols;
  const int m0 = blockIdx.y * MR;
  const int mcount = min(MR, M - m0);
  const int row0 = rank * rows_per_cta;
  const int rows = max(0, min(rows_per_cta, I - row0));
  const int nchunks = (rows + kChunkRows - 1) / kChunkRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid % kColLanes, rl = tid / kColLanes;
  const int n_out = mcount * kCols;
  const int per = (n_out + c - 1) / c;  // outputs stored by each CTA of the cluster
  // the scale of this thread's first output, loaded now rather than at the end
  const int first = rank * per + tid, first_col = col_base + first % kCols;
  const float first_scale = first < min(n_out, (rank + 1) * per) && first_col < O ? scale[first_col] : 0.f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  // [c][per]: the cluster's partials of the outputs this CTA stores
  float* gpart = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(gpart + MR * kCols + kMaxCluster);  // one per stage
  T* x_s = reinterpret_cast<T*>(full + kStages);                            // [MR][rows_per_cta]

  auto issue = [&](int k) {
    uint64_t* bar = full + k % kStages;
    mbar_expect_tx(bar, kStageBytes);
    tma_load(ring + (k % kStages) * kStageBytes, &wmap, bar, col_base, row0 + k * kChunkRows);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(nchunks, kStages); ++k) issue(k);
  }
  // x's slice, zero past I and past M (the box rows past I arrive as zeros
  // too); kXLoads loads a thread in flight together
  constexpr int kXLoads = 8;
  for (int base = 0; base < MR * rows_per_cta; base += kThreads * kXLoads) {
    T xv[kXLoads];
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = base + u * kThreads + tid;
      const int m = i / rows_per_cta, r = i - m * rows_per_cta;
      xv[u] = (m < mcount && r < rows) ? x[(size_t)(m0 + m) * I + row0 + r] : from_float<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < MR * rows_per_cta) x_s[i] = xv[u];
    }
  }
  __syncthreads();

  float acc[MR][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  for (int k = 0; k < nchunks; ++k) {
    mbar_wait(full + k % kStages, (k / kStages) & 1);
    const unsigned char* stage = ring + (k % kStages) * kStageBytes;
#pragma unroll
    for (int j = 0; j < kChunkRows / kRowLanes; ++j) {
      const int r = j * kRowLanes + rl;
      const int4 w = *reinterpret_cast<const int4*>(stage + r * kCols + cl * kColsPerThread);
      float wf[kColsPerThread];
      bytes_to_floats(w.x, wf);
      bytes_to_floats(w.y, wf + 4);
      bytes_to_floats(w.z, wf + 8);
      bytes_to_floats(w.w, wf + 12);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = to_float(x_s[m * rows_per_cta + k * kChunkRows + r]);
#pragma unroll
        for (int jj = 0; jj < kColsPerThread; ++jj) acc[m][jj] = fmaf(xv, wf[jj], acc[m][jj]);
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && k + kStages < nchunks) issue(k + kStages);
  }

  // the 4 row lanes of a warp (lanes l, l^8, l^16, l^24) share their columns
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 8);
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
  float* wpart = reinterpret_cast<float*>(ring);  // [kWarps][MR][kCols], over the drained ring
  if (lane < kColLanes) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; j += 4)
        *reinterpret_cast<float4*>(wpart + (warp * MR + m) * kCols + cl * kColsPerThread + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();
  // this CTA's partial of each output goes straight into the shared memory
  // of the CTA that stores that output: remote stores, no round trips
  cluster_wait();  // every CTA of the cluster is running: its shared memory may be written
  for (int i = tid; i < n_out; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wpart[w * MR * kCols + i];
    const int j = i / per;
    cluster.map_shared_rank(gpart, j)[rank * per + (i - j * per)] = s;
  }
  cluster.sync();  // every partial has reached its CTA

  // this CTA's outputs, summed over the cluster in rank order
  const int end = min(n_out, (rank + 1) * per);
  for (int i = rank * per + tid; i < end; i += kThreads) {
    const int m = i / kCols, col = col_base + (i - m * kCols);
    if (col < O) {
      float s = 0.f;
      for (int r = 0; r < c; ++r) s += gpart[r * per + (i - rank * per)];
      y[(size_t)(m0 + m) * O + col] = from_float<T>(s * (i == first ? first_scale : scale[col]));
    }
  }
}

// The tensor map of a weight: the [I, O] int8 matrix, boxes of 64 x 128.
// Built once per (pointer, shape) and cached; the map depends on nothing
// else, so a reused address with the same shape gets the same, right map.
cudaError_t weight_map(const void* q, int I, int O, CUtensorMap* out) {
  static std::mutex mu;
  static std::unordered_map<uint64_t, CUtensorMap> cache;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const uint64_t key = reinterpret_cast<uint64_t>(q) ^ ((uint64_t)I << 48) ^ ((uint64_t)O << 32) ^
                       ((uint64_t)I * 0x9E3779B97F4A7C15ull);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)I};
  const cuuint64_t strides[1] = {(cuuint64_t)O};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kChunkRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), dims,
                              strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();  // weights are few; copies made for timing are not
  cache.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

template <typename T, int MR>
cudaError_t launch_mr(const CUtensorMap& map, const void* x, const void* scale, void* y, int M, int I,
                      int O, int rows_per_cta, int cluster, int smem, cudaStream_t stream) {
  if (smem < smem_bytes(MR, rows_per_cta, sizeof(T)) || smem > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  const dim3 grid(((O + kCols - 1) / kCols) * cluster, (M + MR - 1) / MR);
  return launch_cluster<int8_gemv_kernel<T, MR>>(grid, kThreads, smem, cluster, stream, map,
                                                 static_cast<const T*>(x),
                                                 static_cast<const float*>(scale),
                                                 static_cast<T*>(y), M, I, O, rows_per_cta);
}

template <typename T>
cudaError_t launch(const CUtensorMap& map, const void* x, const void* scale, void* y, int M, int I,
                   int O, int rows_per_cta, int cluster, int smem, cudaStream_t stream) {
  if (M == 1) return launch_mr<T, 1>(map, x, scale, y, M, I, O, rows_per_cta, cluster, smem, stream);
  if (M == 2) return launch_mr<T, 2>(map, x, scale, y, M, I, O, rows_per_cta, cluster, smem, stream);
  return launch_mr<T, kMaxRows>(map, x, scale, y, M, I, O, rows_per_cta, cluster, smem, stream);
}

}  // namespace
}  // namespace fq3t

// Returns a cudaError_t; 0 on success. x [M, I] and y [M, O] in `dtype`, q
// int8 [I, O] (16-byte aligned, O % 16 == 0), scale f32 [O]. `cluster` CTAs
// of `rows_per_cta` rows (a multiple of 64) split I, with `smem` bytes of
// dynamic shared memory each: all from ops/quant.py::_gemv_plan.
extern "C" int fq3t_int8_gemv(int dtype, const void* x, const void* q, const void* scale, void* y,
                              int M, int I, int O, int rows_per_cta, int cluster, int smem,
                              void* stream) {
  using namespace fq3t;
  if (M <= 0 || M > 16 || I <= 0 || O <= 0 || O % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(q) & 15) != 0 || rows_per_cta <= 0 ||
      rows_per_cta % kChunkRows != 0 || cluster < 1 || cluster > kMaxCluster ||
      (long long)rows_per_cta * cluster < I || (long long)rows_per_cta * (cluster - 1) >= I)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = weight_map(q, I, O, &map);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(map, x, scale, y, M, I, O, rows_per_cta, cluster, smem, st);
  if (dtype == kFloat32)
    return launch<float>(map, x, scale, y, M, I, O, rows_per_cta, cluster, smem, st);
  return cudaErrorInvalidValue;
}
