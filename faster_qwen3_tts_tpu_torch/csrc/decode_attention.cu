// K1: single-token GQA decode attention against the static KV cache.
//
// Replaces the TPU kernel `decode_attention_pallas` / `_kernel` of
// faster_qwen3_tts_tpu/ops/decode_attn_pallas.py (git: ce388ee^), whose spec
// today is faster_qwen3_tts_tpu/ops/attention.py::decode_attention_xla.
//
//   out[b, h] = softmax_s( (q[b, h] . k[b, s, h/G]) * D^-0.5  | mask[b, s] > 0 ) @ v[b, :, h/G]
//
// What bounds it on an H100: device memory. A call reads 2 * live * Hkv * D
// cache elements and does 4 flops per element, far below the tensor-core
// ridge. At B = 1 there are only Hkv = 8 (batch, kv head) pairs, so one block
// per pair would leave 124 of 132 SMs idle.
//
// Design: split-S flash decoding. Pass 1 runs one block per (32-slot tile,
// kv head, batch). A block reads its 32 mask entries and exits at once when
// none is live: this is the Pallas kernel's block skip, decided per tile from
// the mask itself, so the (lo, hi) range never has to be derived on the host
// or in a separate launch. A live tile computes its G = Hq / Hkv query heads'
// scores (one warp per slot, lanes across D), a tile-local f32 softmax, and
// the partial (max, sum, acc[D]). Pass 2 runs one block per (query head,
// batch) and merges the partials of the live tiles with the usual rescaling.
// All arithmetic is f32; only the final output is rounded to the activation
// dtype, as the XLA reference rounds after its f32 einsum.
//
// A mask with no live slot at all gives 0 here; the masked softmax of the
// reference would average every slot. The engine never asks for that: the
// current token is always live.

#include <math_constants.h>

#include "common.cuh"

namespace fq3t {
namespace {

constexpr int kTile = 32;       // cache slots per pass-1 block (one per lane)
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const T* __restrict__ q,        // [B, Hq, D]
    const T* __restrict__ k,        // [B, S, Hkv, D]
    const T* __restrict__ v,        // [B, S, Hkv, D]
    const int* __restrict__ mask,   // [B, S]
    float* __restrict__ part_m,     // [B, Hq, n_split]
    float* __restrict__ part_l,     // [B, Hq, n_split]
    float* __restrict__ part_acc,   // [B, Hq, n_split, D]
    int S, int Hkv, int G, int D, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int Hq = Hkv * G;
  const int s0 = split * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G;  // first query head of the group

  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ int live_s[kTile];
  __shared__ int any_live;

  if (tid < kTile) {
    const int s = s0 + tid;
    live_s[tid] = (s < S) && (mask[(size_t)b * S + s] > 0);
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int t = 0; t < kTile; ++t) any |= live_s[t];
    any_live = any;
  }
  __syncthreads();
  if (!any_live) {
    if (tid < G) {
      part_m[(head0 + tid) * n_split + split] = -CUDART_INF_F;
      part_l[(head0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    q_s[g][d] = to_float(q[(head0 + g) * D + d]);
  }
  __syncthreads();

  // scores: one warp per slot, lanes across D
  for (int t = warp; t < kTile; t += kWarps) {
    if (!live_s[t]) continue;
    const T* krow = k + (((size_t)b * S + s0 + t) * Hkv + kvh) * D;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kd = to_float(krow[d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += q_s[g][d] * kd;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float sc = warp_sum(acc[g]);
        if (lane == 0) p_s[g][t] = sc * scale;
      }
    }
  }
  __syncthreads();

  // tile-local softmax: one warp per query head, one lane per slot
  for (int g = warp; g < G; g += kWarps) {
    const bool live = live_s[lane];
    const float x = live ? p_s[g][lane] : -CUDART_INF_F;
    const float m = warp_max(x);  // finite: the tile has a live slot
    const float e = live ? expf(x - m) : 0.f;
    const float l = warp_sum(e);
    p_s[g][lane] = e;
    if (lane == 0) {
      part_m[(head0 + g) * n_split + split] = m;
      part_l[(head0 + g) * n_split + split] = l;
    }
  }
  __syncthreads();

  // unnormalised p @ v: threads across D
  for (int d = tid; d < D; d += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int t = 0; t < kTile; ++t) {
      if (!live_s[t]) continue;
      const float vd = to_float(v[(((size_t)b * S + s0 + t) * Hkv + kvh) * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += p_s[g][t] * vd;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) part_acc[((head0 + g) * n_split + split) * D + d] = acc[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out,  // out [B, Hq, D]
    int n_split, int D) {
  const int h = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const size_t row = (size_t)b * Hq + h;
  const int tid = threadIdx.x;

  __shared__ float w_s[kMaxSplits];
  __shared__ float red_s[kWarps];
  __shared__ float big_m, big_l;

  // global max over the live splits
  float m = -CUDART_INF_F;
  for (int s = tid; s < n_split; s += kThreads) m = fmaxf(m, part_m[row * n_split + s]);
  m = warp_max(m);
  if ((tid & 31) == 0) red_s[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = red_s[0];
    for (int i = 1; i < kWarps; ++i) mm = fmaxf(mm, red_s[i]);
    big_m = mm;
  }
  __syncthreads();
  const float M = big_m;

  // per-split weights and the global denominator
  float l = 0.f;
  for (int s = tid; s < n_split; s += kThreads) {
    const float ls = part_l[row * n_split + s];
    const float w = ls > 0.f ? expf(part_m[row * n_split + s] - M) : 0.f;
    w_s[s] = w;
    l += w * ls;
  }
  l = warp_sum(l);
  __syncthreads();
  if ((tid & 31) == 0) red_s[tid >> 5] = l;
  __syncthreads();
  if (tid == 0) {
    float ll = 0.f;
    for (int i = 0; i < kWarps; ++i) ll += red_s[i];
    big_l = ll;
  }
  __syncthreads();
  const float L = big_l;

  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = w_s[s];
      if (w > 0.f) o += w * part_acc[(row * n_split + s) * D + d];
    }
    out[row * D + d] = from_float<T>(L > 0.f ? o / L : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* part_m, void* part_l, void* part_acc, void* out, int B, int S,
                   int Hq, int Hkv, int D, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_split = (S + kTile - 1) / kTile;
  decode_attn_split_kernel<T><<<dim3(n_split, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hkv, G, D, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine_kernel<T><<<dim3(Hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), n_split, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fq3t

extern "C" int fq3t_decode_attention_tile() { return fq3t::kTile; }

// Returns a cudaError_t; 0 on success. Partials hold ceil(S / tile) splits.
extern "C" int fq3t_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                     const void* mask, void* part_m, void* part_l,
                                     void* part_acc, void* out, int B, int S, int Hq, int Hkv,
                                     int D, float scale, void* stream) {
  using namespace fq3t;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || D <= 0 ||
      D > kMaxD || (S + kTile - 1) / kTile > kMaxSplits)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, mask, part_m, part_l, part_acc, out, B, S, Hq, Hkv,
                                 D, scale, st);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, mask, part_m, part_l, part_acc, out, B, S, Hq, Hkv, D,
                         scale, st);
  return cudaErrorInvalidValue;
}
