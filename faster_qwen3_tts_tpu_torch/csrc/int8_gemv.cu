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
// have nothing to do; the goal is to keep enough 16-byte loads in flight to
// stream the weight at full bandwidth. A 0.6B gate projection is 3 MB, a few
// microseconds at 3.35 TB/s, so one block per column tile (8 blocks for
// O = 1024) would leave most SMs idle and far too few loads in flight.
//
// Design: q is read in its [I, O] layout. A block of 256 threads owns 128
// output columns: 8 threads across the columns, each loading 16 neighbouring
// int8 weights with one 16-byte load, and 32 threads down the rows, so a warp
// reads four 128-byte row segments per step. The reduction dim I is split
// across those 32 row lanes (4 per warp, 8 warps) and, through grid.y, across
// blocks (split-K) so that a launch has a few hundred blocks. Each thread keeps
// f32 sums for its 16 columns and up to 4 rows of x (grid.z covers more rows);
// the block reduces its 32 row lanes in shared memory. With one split the
// block applies the scale and writes y. With several, each block stores its
// f32 partial; the last block of a column tile to finish (counted with an
// atomic, after a fence) sums the partials in split order, applies the scale
// once, rounds to the activation dtype, and resets the counter to 0 for the
// next launch. The sum is therefore deterministic.

#include <cstdint>

#include "common.cuh"

namespace fq3t {
namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 8;                           // threads across columns
constexpr int kColsPerThread = 16;                     // one 16-byte int8 load
constexpr int kBlockCols = kColLanes * kColsPerThread; // 128
constexpr int kRowLanes = kThreads / kColLanes;        // 32
constexpr int kRowsPerBlock = 4;                       // rows of x per block

// sign-extended byte j (0..3) of a 32-bit word, as float
__device__ __forceinline__ float sbyte(int word, int j) {
  return static_cast<float>((word << (24 - 8 * j)) >> 24);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) int8_gemv_kernel(
    const T* __restrict__ x,              // [M, I]
    const int8_t* __restrict__ q,         // [I, O], 16-byte aligned rows
    const float* __restrict__ scale,      // [O]
    T* __restrict__ y,                    // [M, O]
    float* __restrict__ partial,          // [ksplit, M, O] (ksplit > 1)
    unsigned int* __restrict__ counters,  // [n_row_groups * n_col_tiles], all 0
    int M, int I, int O, int rows_per_split) {
  const int tile = blockIdx.x, ks = blockIdx.y, rg = blockIdx.z;
  const int ksplit = gridDim.y;
  const int tid = threadIdx.x;
  const int cl = tid % kColLanes, rl = tid / kColLanes;
  const int col0 = tile * kBlockCols + cl * kColsPerThread;
  const int m0 = rg * kRowsPerBlock;
  const int mcount = min(kRowsPerBlock, M - m0);
  const int i_begin = ks * rows_per_split;
  const int i_end = min(I, i_begin + rows_per_split);

  float acc[kRowsPerBlock][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerBlock; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;

  if (col0 < O) {
#pragma unroll 4
    for (int i = i_begin + rl; i < i_end; i += kRowLanes) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(q + (size_t)i * O + col0));
      float wf[kColsPerThread];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wf[j] = sbyte(w.x, j);
        wf[4 + j] = sbyte(w.y, j);
        wf[8 + j] = sbyte(w.z, j);
        wf[12 + j] = sbyte(w.w, j);
      }
#pragma unroll
      for (int m = 0; m < kRowsPerBlock; ++m) {
        if (m < mcount) {
          const float xv = to_float(x[(size_t)(m0 + m) * I + i]);
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) acc[m][c] += xv * wf[c];
        }
      }
    }
  }

  // reduce the 32 row lanes: thread c < 128 ends up with column (tile*128 + c)
  __shared__ float red[kRowLanes][kBlockCols];
  __shared__ bool is_last;
  float res[kRowsPerBlock];
#pragma unroll
  for (int m = 0; m < kRowsPerBlock; ++m) {
    res[m] = 0.f;
    if (m < mcount) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) red[rl][cl * kColsPerThread + c] = acc[m][c];
      __syncthreads();
      if (tid < kBlockCols) {
        float s = 0.f;
        for (int r = 0; r < kRowLanes; ++r) s += red[r][tid];
        res[m] = s;
      }
      __syncthreads();
    }
  }

  const int col = tile * kBlockCols + tid;
  const bool owns_col = tid < kBlockCols && col < O;
  if (ksplit == 1) {
    if (owns_col) {
      const float sc = scale[col];
#pragma unroll
      for (int m = 0; m < kRowsPerBlock; ++m)
        if (m < mcount) y[(size_t)(m0 + m) * O + col] = from_float<T>(res[m] * sc);
    }
    return;
  }

  if (owns_col) {
#pragma unroll
    for (int m = 0; m < kRowsPerBlock; ++m)
      if (m < mcount) partial[((size_t)ks * M + m0 + m) * O + col] = res[m];
  }
  __threadfence();
  __syncthreads();
  unsigned int* counter = counters + (size_t)rg * gridDim.x + tile;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == (unsigned int)(ksplit - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (owns_col) {
    const float sc = scale[col];
#pragma unroll
    for (int m = 0; m < kRowsPerBlock; ++m) {
      if (m < mcount) {
        float s = 0.f;
        for (int k = 0; k < ksplit; ++k) s += __ldcg(&partial[((size_t)k * M + m0 + m) * O + col]);
        y[(size_t)(m0 + m) * O + col] = from_float<T>(s * sc);
      }
    }
  }
  if (tid == 0) *counter = 0u;
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, void* partial,
                   void* counters, int M, int I, int O, int rows_per_split, int ksplit,
                   cudaStream_t stream) {
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit,
                  (M + kRowsPerBlock - 1) / kRowsPerBlock);
  int8_gemv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(y), static_cast<float*>(partial), static_cast<unsigned int*>(counters), M,
      I, O, rows_per_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fq3t

extern "C" int fq3t_int8_gemv_block_cols() { return fq3t::kBlockCols; }
extern "C" int fq3t_int8_gemv_rows_per_block() { return fq3t::kRowsPerBlock; }

// Returns a cudaError_t; 0 on success. The caller guarantees O % 16 == 0, a
// 16-byte aligned q, ksplit * rows_per_split >= I, and, when ksplit > 1, a
// partial buffer of ksplit * M * O floats and zeroed counters for every
// (row group, column tile).
extern "C" int fq3t_int8_gemv(int dtype, const void* x, const void* q, const void* scale,
                              void* y, void* partial, void* counters, int M, int I, int O,
                              int rows_per_split, int ksplit, void* stream) {
  using namespace fq3t;
  if (M <= 0 || I <= 0 || O <= 0 || O % kColsPerThread != 0 || ksplit <= 0 ||
      rows_per_split <= 0 || (long long)rows_per_split * ksplit < I)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, q, scale, y, partial, counters, M, I, O, rows_per_split,
                                 ksplit, st);
  if (dtype == kFloat32)
    return launch<float>(x, q, scale, y, partial, counters, M, I, O, rows_per_split, ksplit,
                         st);
  return cudaErrorInvalidValue;
}
