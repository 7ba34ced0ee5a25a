// K3: stacked-layer int8 weight streaming,
//   y[O] (f32) = sum_l sum_i x[i] * w[l, i, o],  x [I] bf16, w [L, I, O] int8.
//
// Replaces the TPU kernel `kern` of benchmarks/pallas_bw_probe.py (git:
// 4565532, l.73; its pallas_call at l.87), a probe of how fast the chip can
// stream the decode step's stacked int8 layer weights through one matvec
// each. Its default geometry, L=28, I=2048, O=12288 (704 MB), is the 1.7B
// talker's gate+up stack; the int8 values are exact in bf16 and in f32, so
// the result differs from the probe's only in the order of the f32 sums.
//
// What bounds it on an H100: device memory, and nothing else. Every weight
// byte is read once and feeds one multiply-add, so the aim is to keep enough
// 16-byte loads in flight to stream at the HBM rate, and to spend few
// instructions per byte on the way: at 3.35 TB/s an SM has ~15 bytes to turn
// into floats each clock, about what its quarter-rate int-to-float unit
// manages, so bytes become floats by a byte permute into the mantissa of 2^23
// and one full-rate subtraction instead.
//
// Design: the weight is read as one [R = L * I, O] matrix whose row r meets
// x[r % I]. A block of 256 threads owns 128 output columns: 8 threads across
// the columns, each loading 16 neighbouring int8 weights with one 16-byte
// load, and 32 threads down the rows; each thread issues 4 such loads before
// it uses any. grid.y splits the rows into a few thousand blocks in all, so
// every SM holds several blocks at once and the last wave is short. The
// Pallas kernel carried its [1, O] sum across its sequential grid; Hopper
// blocks run in no order, so each block reduces its 32 row lanes in shared
// memory and stores one f32 partial per column, and a second small kernel
// sums the partials in split order. The result is deterministic.

#include <cstdint>

#include "common.cuh"

namespace fq3t {
namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 8;                           // threads across columns
constexpr int kColsPerThread = 16;                     // one 16-byte int8 load
constexpr int kBlockCols = kColLanes * kColsPerThread; // 128
constexpr int kRowLanes = kThreads / kColLanes;        // 32
constexpr int kLoads = 4;                              // loads a thread keeps in flight
constexpr int kRowStep = kRowLanes * kLoads;           // rows a block covers per step
constexpr int kSumThreads = 256;

// The four signed bytes of a word as floats, exactly: byte b + 128 becomes
// the low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void bytes_to_floats(int word, float* out) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
}

__device__ __forceinline__ void fma16(float* acc, float xv, const int4& w) {
  float wf[kColsPerThread];
  bytes_to_floats(w.x, wf);
  bytes_to_floats(w.y, wf + 4);
  bytes_to_floats(w.z, wf + 8);
  bytes_to_floats(w.w, wf + 12);
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) acc[c] = fmaf(xv, wf[c], acc[c]);
}

__device__ __forceinline__ int next_x(int xi, int I) {
  xi += kRowLanes;
  while (xi >= I) xi -= I;
  return xi;
}

__global__ void __launch_bounds__(kThreads) weight_stream_kernel(
    const __nv_bfloat16* __restrict__ x,  // [I]
    const int8_t* __restrict__ w,         // [R, O], 16-byte aligned rows
    float* __restrict__ out,              // [ksplit, O]; y itself when ksplit == 1
    int R, int I, int O, int rows_per_split) {
  const int tile = blockIdx.x, ks = blockIdx.y, tid = threadIdx.x;
  const int cl = tid % kColLanes, rl = tid / kColLanes;
  const int col0 = tile * kBlockCols + cl * kColsPerThread;
  const int r_end = min(R, (ks + 1) * rows_per_split);

  float acc[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) acc[c] = 0.f;

  if (col0 < O) {
    int r = ks * rows_per_split + rl;
    int xi = r % I;
    for (; r + (kLoads - 1) * kRowLanes < r_end; r += kRowStep) {
      int4 wv[kLoads];
      float xv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        wv[u] = __ldg(reinterpret_cast<const int4*>(w + (size_t)(r + u * kRowLanes) * O + col0));
        xv[u] = __bfloat162float(x[xi]);
        xi = next_x(xi, I);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) fma16(acc, xv[u], wv[u]);
    }
    for (; r < r_end; r += kRowLanes) {
      const int4 wv = __ldg(reinterpret_cast<const int4*>(w + (size_t)r * O + col0));
      fma16(acc, __bfloat162float(x[xi]), wv);
      xi = next_x(xi, I);
    }
  }

  // reduce the 32 row lanes: thread c < 128 ends up with column tile*128 + c
  __shared__ float red[kRowLanes][kBlockCols];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) red[rl][cl * kColsPerThread + c] = acc[c];
  __syncthreads();
  const int col = tile * kBlockCols + tid;
  if (tid < kBlockCols && col < O) {
    float s = 0.f;
    for (int r = 0; r < kRowLanes; ++r) s += red[r][tid];
    out[(size_t)ks * O + col] = s;
  }
}

// y[o] = sum over the splits k, in order, of partial[k, o]
__global__ void __launch_bounds__(kSumThreads) weight_stream_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ y, int ksplit, int O) {
  const int col = blockIdx.x * kSumThreads + threadIdx.x;
  if (col >= O) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * O + col];
  y[col] = s;
}

}  // namespace
}  // namespace fq3t

extern "C" int fq3t_weight_stream_block_cols() { return fq3t::kBlockCols; }
extern "C" int fq3t_weight_stream_row_step() { return fq3t::kRowStep; }

// Returns a cudaError_t; 0 on success. x is bf16 [I], w int8 [R, O] with R a
// multiple of I (L stacked [I, O] layers). The caller guarantees O % 16 == 0,
// a 16-byte aligned w, ksplit * rows_per_split >= R, and, when ksplit > 1, a
// partial buffer of ksplit * O floats.
extern "C" int fq3t_weight_stream(const void* x, const void* w, void* partial, void* y, int R,
                                  int I, int O, int rows_per_split, int ksplit, void* stream) {
  using namespace fq3t;
  if (R <= 0 || I <= 0 || R % I != 0 || O <= 0 || O % kColsPerThread != 0 || ksplit <= 0 ||
      rows_per_split <= 0 || (long long)rows_per_split * ksplit < R)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit);
  float* out = static_cast<float*>(ksplit > 1 ? partial : y);
  weight_stream_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const int8_t*>(w), out, R, I, O,
                                                  rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  weight_stream_sum_kernel<<<(O + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
      out, static_cast<float*>(y), ksplit, O);
  return cudaGetLastError();
}
