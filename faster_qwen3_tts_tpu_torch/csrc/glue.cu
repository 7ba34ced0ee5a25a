// K5, K6, K7: the decoder layer's elementwise glue between its products.
//
//   K5 add_rms_norm:    s = x + residual (rounded to the activation dtype),
//                       y = rmsnorm(s) * w; over rows of up to 2048.
//   K6 qk_norm_rope_kv: per-head RMSNorm of q and k, RoPE (HF "cat" layout) of
//                       both, k and v written into the KV cache at each lane's
//                       write position; one decode token a lane.
//   K7 silu_mul:        silu(g) (rounded) * u.
//
// They replace no TPU kernel. On the TPU, XLA fuses this elementwise code
// into its neighbours by itself; in PyTorch every operator is a launch of its
// own (an RMSNorm was 9 launches, a RoPE 7, the cache write 2 index_put_ and
// an arange), so a 0.6B frame ran ~6,700 glue launches around ~850 launches
// of K1 and K2. The plain versions of ops/glue.py keep that composition for
// CPU tensors and state the rounding each kernel reproduces.
//
// What bounds them on an H100: launch latency. A call moves kilobytes (a
// 2048-wide bf16 row is 4 KB; K6 at 24 heads of 128 reads ~7 KB and writes
// ~6 KB), far under a microsecond at 3.35 TB/s, and does a few flops a byte.
// So each is one launch with every load of a thread issued before its first
// use, no global scratch and no second pass over device memory: a row's
// values stay in registers from the load to the store.
//
// Rounding, the plain code's: the residual sum rounds to the activation dtype
// and the norm runs in f32 over the rounded values; the norm is
// w * (x * rsqrt(mean(x^2) + eps)), rounded once; K6 rounds the normed q / k
// to the dtype before RoPE, as the plain rms_norm then apply_rope do, and
// RoPE (x * cos + rotate_half(x) * sin in f32) rounds once. Products and sums
// are written with the _rn intrinsics, so that nvcc contracts none of them
// into an fma the plain code does not have. Only the f32 sum of squares is
// taken in another order than PyTorch's reduction, so a normed value may
// differ by one ulp of the activation dtype; the residual sums and K7 are the
// plain code's bit for bit.

#include "common.cuh"

namespace fq3t {
namespace {

constexpr int kThreads = 128;  // K7, and K5's CTAs of one-warp rows
constexpr int kHeadWarps = 8;  // K6: one warp a head, 8 heads a CTA
constexpr int kMaxPairs = 4;   // K6: head_dim <= 256

// K5. Row r = m * heads + h of x starts at x + m * ldx + h * W (a hidden row:
// heads = 1; the per-head norm of a fused-layout column view: heads > 1, ldx
// the fused row); the residual, the sum and the output are dense [N, W].
// TPR threads a row (one warp, 4 rows a CTA; or a CTA of TPR threads), each
// holding PER values. Every load (x, residual, weight) is issued before the
// reduction, so a call waits for one round trip to memory, not three.
template <typename T, int TPR, int PER>
__global__ void __launch_bounds__(TPR < kThreads ? kThreads : TPR) add_rms_norm_kernel(
    const T* __restrict__ x, long long ldx, const T* __restrict__ res, T* __restrict__ sum,
    const T* __restrict__ w, T* __restrict__ out, int N, int heads, int W, float eps) {
  static_assert(TPR == 32 || TPR % kThreads == 0, "a row is one warp or one CTA");
  const int t = threadIdx.x % TPR;
  const int r = blockIdx.x * (TPR < kThreads ? kThreads / TPR : 1) + threadIdx.x / TPR;
  if (TPR == 32 && r >= N) return;  // a whole warp leaves; a CTA-wide row always exists
  const T* xr = x + (size_t)(r / heads) * ldx + (size_t)(r % heads) * W;
  const size_t o = (size_t)r * W;

  float v[PER], wv[PER], rv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = i * TPR + t;
    const bool in = c < W;
    v[i] = in ? to_float(xr[c]) : 0.f;
    wv[i] = in ? to_float(w[c]) : 0.f;
    rv[i] = in && res != nullptr ? to_float(res[o + c]) : 0.f;
  }
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = i * TPR + t;
      if (c < W) {
        const T s = from_float<T>(__fadd_rn(v[i], rv[i]));
        sum[o + c] = s;
        v[i] = to_float(s);
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  ss = warp_sum(ss);
  if (TPR > 32) {
    __shared__ float part[TPR / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) ss += part[i];
  }
  const float rr = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / static_cast<float>(W)), eps));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = i * TPR + t;
    if (c < W) out[o + c] = from_float<T>(__fmul_rn(wv[i], __fmul_rn(v[i], rr)));
  }
}

// K6. Grid (ceil((Hq + Hkv) / 8), B), one warp a head: heads [0, Hq) are q's,
// [Hq, Hq + Hkv) k's, whose warp also copies v's head. Lane l holds the RoPE
// pairs (j, j + D / 2) for j = l, l + 32, ...: both halves of a pair in one
// thread, so rotate_half needs no exchange. q / k / v rows of lane b start at
// b * ld (column views of the fused projection's output are fine; heads are
// dense); cos / sin f32 [B, D]; caches [B, S, Hkv, D].
template <typename T>
__global__ void __launch_bounds__(kHeadWarps * 32) qk_norm_rope_kv_kernel(
    const T* __restrict__ q, long long ldq, const T* __restrict__ k, long long ldk,
    const T* __restrict__ v, long long ldv, const T* __restrict__ qw, const T* __restrict__ kw,
    const float* __restrict__ cos, const float* __restrict__ sin, T* __restrict__ kc,
    T* __restrict__ vc, const int* __restrict__ write_pos, T* __restrict__ q_out, int Hq, int Hkv,
    int D, int S, float eps) {
  const int lane = threadIdx.x & 31;
  const int hh = blockIdx.x * kHeadWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (hh >= Hq + Hkv) return;
  const bool is_q = hh < Hq;
  const int h = is_q ? hh : hh - Hq;
  const int half = D / 2;
  const T* src = is_q ? q + (size_t)b * ldq + (size_t)h * D : k + (size_t)b * ldk + (size_t)h * D;
  const T* w = is_q ? qw : kw;
  const float* cr = cos + (size_t)b * D;
  const float* sr = sin + (size_t)b * D;
  size_t dst = 0;
  if (!is_q) {
    // the engine clamps the position of a finished lane to the last slot; so does this
    const int p = min(max(write_pos[b], 0), S - 1);
    dst = (((size_t)b * S + p) * Hkv + h) * D;
    const T* vs = v + (size_t)b * ldv + (size_t)h * D;
    for (int j = lane; j < D; j += 32) vc[dst + j] = vs[j];
  }

  // every load of the head (its values, the weight, cos and sin) before the reduction
  float lo[kMaxPairs], hi[kMaxPairs], wlo[kMaxPairs], whi[kMaxPairs];
  float clo[kMaxPairs], chi[kMaxPairs], slo[kMaxPairs], shi[kMaxPairs];
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int j = lane + 32 * p;
    const bool in = j < half;
    lo[p] = in ? to_float(src[j]) : 0.f;
    hi[p] = in ? to_float(src[j + half]) : 0.f;
    wlo[p] = in ? to_float(w[j]) : 0.f;
    whi[p] = in ? to_float(w[j + half]) : 0.f;
    clo[p] = in ? cr[j] : 0.f;
    chi[p] = in ? cr[j + half] : 0.f;
    slo[p] = in ? sr[j] : 0.f;
    shi[p] = in ? sr[j + half] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p)
    ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(lo[p], lo[p]), __fmul_rn(hi[p], hi[p])));
  ss = warp_sum(ss);
  const float rr = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / static_cast<float>(D)), eps));
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int j = lane + 32 * p;
    if (j >= half) break;
    // the norm, rounded to the dtype as the plain rms_norm's output
    const float a = to_float(from_float<T>(__fmul_rn(wlo[p], __fmul_rn(lo[p], rr))));
    const float z = to_float(from_float<T>(__fmul_rn(whi[p], __fmul_rn(hi[p], rr))));
    // x * cos + rotate_half(x) * sin, rotate_half(x) = (-x[half:], x[:half])
    const T y_lo = from_float<T>(__fadd_rn(__fmul_rn(a, clo[p]), __fmul_rn(-z, slo[p])));
    const T y_hi = from_float<T>(__fadd_rn(__fmul_rn(z, chi[p]), __fmul_rn(a, shi[p])));
    if (is_q) {
      T* qo = q_out + ((size_t)b * Hq + h) * D;
      qo[j] = y_lo;
      qo[j + half] = y_hi;
    } else {
      kc[dst + j] = y_lo;
      kc[dst + j + half] = y_hi;
    }
  }
}

// K7. Grid (ceil(I / 128), min(N, 65535)): row r of g and u starts at r * ldg / r * ldu
// (the halves of the fused gate/up output are column views); out is [N, I].
// silu(x) = x / (1 + exp(-x)) in f32 as PyTorch's CUDA silu computes it,
// rounded to the dtype, times u, rounded.
template <typename T>
__global__ void __launch_bounds__(kThreads) silu_mul_kernel(const T* __restrict__ g, long long ldg,
                                                            const T* __restrict__ u, long long ldu,
                                                            T* __restrict__ out, int N, int I) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= I) return;
  for (int r = blockIdx.y; r < N; r += gridDim.y) {
    const float x = to_float(g[(size_t)r * ldg + c]);
    const float s = to_float(from_float<T>(x / (1.f + expf(-x))));
    out[(size_t)r * I + c] = from_float<T>(__fmul_rn(s, to_float(u[(size_t)r * ldu + c])));
  }
}

template <typename T, int TPR, int PER>
cudaError_t norm_launch(const void* x, long long ldx, const void* res, void* sum, const void* w,
                        void* out, int N, int heads, int W, float eps, cudaStream_t stream) {
  const int rows_per_cta = TPR < kThreads ? kThreads / TPR : 1;
  const int threads = TPR < kThreads ? kThreads : TPR;
  add_rms_norm_kernel<T, TPR, PER><<<(N + rows_per_cta - 1) / rows_per_cta, threads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(res), static_cast<T*>(sum),
      static_cast<const T*>(w), static_cast<T*>(out), N, heads, W, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t norm_dispatch(const void* x, long long ldx, const void* res, void* sum, const void* w,
                          void* out, int N, int heads, int W, float eps, cudaStream_t st) {
  // a warp a row for the heads (128) and the tiny geometry's rows; a CTA a
  // row for the 0.6B (1024) and 1.7B (2048) hidden rows
  if (W <= 128) return norm_launch<T, 32, 4>(x, ldx, res, sum, w, out, N, heads, W, eps, st);
  if (W <= 1024) return norm_launch<T, 128, 8>(x, ldx, res, sum, w, out, N, heads, W, eps, st);
  return norm_launch<T, 256, 8>(x, ldx, res, sum, w, out, N, heads, W, eps, st);
}

}  // namespace
}  // namespace fq3t

// Every entry point returns a cudaError_t, 0 on success, and launches on
// `stream` without synchronising. Checked by ops/glue.py before the call:
// shapes, dtypes, strides and devices.

// K5: x rows as above, width W <= 2048 (the widest hidden row); res / sum null
// for a norm alone.
extern "C" int fq3t_add_rms_norm(int dtype, const void* x, long long ldx, const void* res, void* sum,
                                 const void* w, void* out, int N, int heads, int W, float eps,
                                 void* stream) {
  using namespace fq3t;
  if (N <= 0 || heads <= 0 || N % heads != 0 || W <= 0 || W > 8 * 256 ||
      (res == nullptr) != (sum == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return norm_dispatch<__nv_bfloat16>(x, ldx, res, sum, w, out, N, heads, W, eps, st);
  if (dtype == kFloat32) return norm_dispatch<float>(x, ldx, res, sum, w, out, N, heads, W, eps, st);
  return cudaErrorInvalidValue;
}

// K6: q [B, Hq, D] / k, v [B, Hkv, D] rows at ldq / ldk / ldv, D even and <= 256.
extern "C" int fq3t_qk_norm_rope_kv(int dtype, const void* q, long long ldq, const void* k,
                                    long long ldk, const void* v, long long ldv, const void* qw,
                                    const void* kw, const void* cos, const void* sin, void* kc,
                                    void* vc, const void* write_pos, void* q_out, int B, int Hq,
                                    int Hkv, int D, int S, float eps, void* stream) {
  using namespace fq3t;
  if (B <= 0 || B > 65535 || Hq <= 0 || Hkv <= 0 || D <= 0 || D % 2 != 0 || D > 64 * kMaxPairs ||
      S <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((Hq + Hkv + kHeadWarps - 1) / kHeadWarps, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto pos = static_cast<const int*>(write_pos);
  auto c = static_cast<const float*>(cos);
  auto s = static_cast<const float*>(sin);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    qk_norm_rope_kv_kernel<T><<<grid, kHeadWarps * 32, 0, st>>>(
        static_cast<const T*>(q), ldq, static_cast<const T*>(k), ldk, static_cast<const T*>(v), ldv,
        static_cast<const T*>(qw), static_cast<const T*>(kw), c, s, static_cast<T*>(kc),
        static_cast<T*>(vc), pos, static_cast<T*>(q_out), Hq, Hkv, D, S, eps);
  } else if (dtype == kFloat32) {
    qk_norm_rope_kv_kernel<float><<<grid, kHeadWarps * 32, 0, st>>>(
        static_cast<const float*>(q), ldq, static_cast<const float*>(k), ldk,
        static_cast<const float*>(v), ldv, static_cast<const float*>(qw),
        static_cast<const float*>(kw), c, s, static_cast<float*>(kc), static_cast<float*>(vc), pos,
        static_cast<float*>(q_out), Hq, Hkv, D, S, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K7: g / u [N, I] rows at ldg / ldu, out dense [N, I].
extern "C" int fq3t_silu_mul(int dtype, const void* g, long long ldg, const void* u, long long ldu,
                             void* out, int N, int I, void* stream) {
  using namespace fq3t;
  if (N <= 0 || I <= 0) return cudaErrorInvalidValue;
  const dim3 grid((I + kThreads - 1) / kThreads, N < 65535 ? N : 65535);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    silu_mul_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(g), ldg,
                                                  static_cast<const T*>(u), ldu, static_cast<T*>(out), N, I);
  } else if (dtype == kFloat32) {
    silu_mul_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(g), ldg,
                                                      static_cast<const float*>(u), ldu,
                                                      static_cast<float*>(out), N, I);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
