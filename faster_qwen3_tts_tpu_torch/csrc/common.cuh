// Shared helpers for the port's Hopper kernels (plain C interface, bound with
// ctypes by faster_qwen3_tts_tpu_torch/ops/kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace fq3t {

// dtype codes passed from Python (ops/kernels.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Dynamic shared memory a block may use on an H100 (227 KB).
constexpr int kMaxDynamicSmem = 232448;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The four signed bytes of a word as floats, exactly, without the
// quarter-rate int-to-float unit: byte b + 128 becomes the low mantissa byte
// of 2^23, and 2^23 + 128 is subtracted (one permute and one full-rate
// subtraction a byte).
__device__ __forceinline__ void bytes_to_floats(int word, float* out) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
}

// 16 bytes of shared or global memory as floats: 8 bf16 or 4 f32 values.
template <typename T>
struct Vec16 {
  static constexpr int kCount = 16 / sizeof(T);
  static __device__ __forceinline__ void load(const void* p, float* out);
};
template <>
__device__ __forceinline__ void Vec16<__nv_bfloat16>::load(const void* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void Vec16<float>::load(const void* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only); zero-fills
// the destination when `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0..3) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Cluster barrier halves: a kernel arrives (relaxed) at its start and waits
// before its first store into another CTA's shared memory, so every CTA of
// the cluster is known to be running by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launch `Kernel` on a grid whose x extent is split into thread-block
// clusters of `cluster_x` (at most 8) blocks (cudaLaunchKernelEx). The first
// launch of each kernel lets it use all of an SM's shared memory.
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(dim3 grid, int threads, int smem, int cluster_x, cudaStream_t stream,
                           Args&&... args) {
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace fq3t
