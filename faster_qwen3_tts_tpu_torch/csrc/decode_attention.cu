// K1: single-token GQA decode attention against the static KV cache.
//
// Replaces the TPU kernel `decode_attention_pallas` / `_kernel` of
// faster_qwen3_tts_tpu/ops/decode_attn_pallas.py (git: ce388ee^), whose spec
// today is faster_qwen3_tts_tpu/ops/attention.py::decode_attention_xla.
//
//   out[b, h] = softmax_s( (q[b, h] . k[b, s, h/G]) * D^-0.5  | mask[b, s] > 0 ) @ v[b, :, h/G]
//
// What bounds it on an H100: device memory in principle, latency in
// practice. A call reads 2 * live * Hkv * D cache elements and does 4 flops
// per element, far below the tensor-core ridge; but the talker's live range
// is usually a few hundred slots of a 2048-slot cache (a few hundred KB, well
// under a microsecond at 3.35 TB/s) and the predictor's is at most 17 slots,
// so what a call costs is its launches and its chains of dependent memory
// round trips, not its bytes.
//
// Design: one launch, grid (c, Hkv, B), one thread-block cluster of c CTAs
// per (kv head, batch); the wrapper picks c from S_max (ops/attention.py
// `_decode_plan`): 1 for the predictor's 17 slots, 8 (the portable maximum)
// for the talker's 2048, so that 8 kv heads x 8 CTAs share a long live range.
// - Live tiles. Every CTA reads the mask row with 16-byte loads (one thread
//   per 32-slot tile) and compacts the tiles that hold a live slot into a
//   list with a ballot scan. CTA r takes live tiles r, r + c, ..., so the
//   work is balanced for any mask: a prefix, a left-padded range, holes.
//   This is the Pallas kernel's block skip, decided from the mask itself.
// - Loading K and V. A tile's K and V rows (256 bytes per slot at D = 128,
//   bf16, with a stride of Hkv * D) are brought into a 4-stage shared-memory
//   ring by 16-byte cp.async copies: a CTA's first four tiles are requested
//   at once, and each stage is refilled as soon as its tile is done, so the
//   loads overlap the math. Rows are padded so that the score loop reads
//   them without bank conflicts; slots past S_max are zero-filled.
// - The math, all in f32, unrolled for the GQA ratio G and the head size D
//   (template parameters: fewer instructions a phase, which is what a
//   latency-bound call pays for). q is loaded once with D^-0.5 folded in,
//   its loads in flight with the mask's. Scores:
//   four threads per slot split D, reading K with 16-byte vector loads, and
//   every query head of the GQA group shares each K read. An online softmax
//   runs over the CTA's tiles (one warp per query head keeps the running max
//   and sum). p.v: threads across D (16 bytes each) and across slot groups,
//   so the tile's slots are summed in parallel, again one V read for all G
//   heads; the slot groups are summed in shared memory at the end.
// - The merge, through distributed shared memory. Each CTA of the cluster
//   merges one slice of the G * D outputs. When a CTA has its (m, l,
//   acc[G][D]) partial, it stores each slice, and (m, l), into the shared
//   memory of the CTA that merges it (cluster.map_shared_rank): remote
//   stores, which do not wait for a round trip as remote loads would. After
//   one cluster.sync() each CTA merges its slice from its own shared memory,
//   in rank order, so the result is deterministic, and writes it rounded
//   once to the activation dtype. A relaxed cluster arrive at the start,
//   waited on before the first remote store, makes sure every CTA of the
//   cluster is running. No global scratch, no second kernel: the call is
//   capture-safe with no per-graph state.
//
// A mask with no live slot at all gives 0 here; the masked softmax of the
// reference would average every slot. The engine never asks for that: the
// current token is always live.

#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fq3t {
namespace {

constexpr int kTile = 32;       // cache slots per tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;      // K/V tiles in flight per CTA
constexpr int kMaxG = 8;        // query heads per kv head
constexpr int kMaxGD = 2048;    // G * D
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxTiles = 1024; // S_max <= 32768

// Row pitch of a K/V tile in shared memory: the row, padded so that slot
// rows start 16 banks apart (the score loop's 8 threads of a 16-byte phase
// then hit distinct banks).
__host__ __device__ constexpr int row_pitch(int row_bytes) {
  return row_bytes + ((16 - (row_bytes / 4) % 32 + 32) % 32) * 4;
}

// Dynamic shared memory of one CTA; ops/attention.py::_decode_plan computes
// the same sum, and the launch refuses a smaller one.
__host__ __device__ constexpr int smem_bytes(int G, int D, int elt, int n_tiles) {
  const int row = D * elt;
  const int ring = kStages * 2 * kTile * row_pitch(row);
  const int red = (kThreads / (row / 16)) * G * D * 4;
  return (ring > red ? ring : red) + G * D * 4 + (G * D + kMaxCluster) * 4 +
         2 * kMaxG * kTile * 4 + 4 * kMaxG * 4 + 3 * kMaxCluster * kMaxG * 4 +
         2 * ((n_tiles * 4 + 15) / 16) * 16 + 16;
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const T* __restrict__ q,        // [B, Hq, D]
    const T* __restrict__ k,        // [B, S, Hkv, D]
    const T* __restrict__ v,        // [B, S, Hkv, D]
    const int* __restrict__ mask,   // [B, S]
    T* __restrict__ out,            // [B, Hq, D]
    int S, int Hkv, float scale) {
  constexpr int kElt = Vec16<T>::kCount;  // elements per 16-byte chunk
  constexpr int GD = G * D;
  constexpr int kQPer = (GD + kThreads - 1) / kThreads;
  constexpr int row = D * static_cast<int>(sizeof(T));
  constexpr int pitch = row_pitch(row);
  constexpr int n16 = row / 16;           // 16-byte chunks per K/V row
  constexpr int n_sg = kThreads / n16;    // slot groups of the p.v loop
  static_assert(n16 >= 4 && n16 <= 32 && kThreads % n16 == 0, "a K/V row of 64 to 512 bytes");
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (GD + c - 1) / c;   // outputs merged by each CTA of the cluster
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t head0 = ((size_t)b * Hkv + kvh) * G;  // first query head of the group

  // shared memory: the K/V ring (reused for the slot-group sums), then the
  // small arrays
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ring_bytes = kStages * 2 * kTile * pitch;
  constexpr int red_bytes = n_sg * GD * 4;
  float* q_s = reinterpret_cast<float*>(smem + (ring_bytes > red_bytes ? ring_bytes : red_bytes));
  float* gacc = q_s + GD;               // [c][per]: the cluster's partials of my outputs
  float* s_s = gacc + GD + kMaxCluster; // scores [kMaxG][kTile]
  float* p_s = s_s + kMaxG * kTile;     // probabilities [kMaxG][kTile]
  float* m_s = p_s + kMaxG * kTile;     // running max per head
  float* l_s = m_s + kMaxG;             // running sum per head
  float* alpha_s = l_s + kMaxG;         // rescale factor of the current tile
  float* L_s = alpha_s + kMaxG;         // merged denominators
  float* gm = L_s + kMaxG;              // [kMaxCluster][kMaxG]: the cluster's running maxima
  float* gl = gm + kMaxCluster * kMaxG; // [kMaxCluster][kMaxG]: ... and sums
  float* w_s = gl + kMaxCluster * kMaxG;  // merge weights [kMaxCluster][kMaxG]
  const int list_len = ((n_tiles + 3) / 4) * 4;
  int* list_s = reinterpret_cast<int*>(w_s + kMaxCluster * kMaxG);  // live tiles, in order
  unsigned* bits_s = reinterpret_cast<unsigned*>(list_s + list_len);  // live slots of each tile
  int* count_s = reinterpret_cast<int*>(bits_s + list_len);

  // q (scaled) is loaded to registers first, so its loads fly with the mask's
  float qv[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int e = u * kThreads + tid;
    qv[u] = e < GD ? to_float(q[head0 * D + e]) * scale : 0.f;
  }
  if (tid < kMaxG) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }

  // live tiles, compacted in order: one thread per tile (its 32 live bits),
  // a ballot per warp
  const int* mrow = mask + (size_t)b * S;
  const bool vec_mask = (S % 4 == 0) && ((reinterpret_cast<uintptr_t>(mrow) & 15) == 0);
  int n_live = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int t = base + tid;
    unsigned bits = 0;
    if (t < n_tiles) {
      const int s0 = t * kTile;
      if (vec_mask && s0 + kTile <= S) {
        const int4* p = reinterpret_cast<const int4*>(mrow + s0);
#pragma unroll
        for (int i = 0; i < kTile / 4; ++i) {
          const int4 m4 = __ldg(p + i);
          bits |= ((m4.x > 0) | (m4.y > 0) << 1 | (m4.z > 0) << 2 | (m4.w > 0) << 3) << (4 * i);
        }
      } else {  // unrolled, so the 32 loads are in flight together
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (s0 + i < S) bits |= static_cast<unsigned>(__ldg(mrow + s0 + i) > 0) << i;
      }
      bits_s[t] = bits;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, bits != 0);
    if (lane == 0) count_s[warp] = __popc(bal);
    __syncthreads();
    int off = n_live;
    for (int w = 0; w < warp; ++w) off += count_s[w];
    if (bits) list_s[off + __popc(bal & ((1u << lane) - 1u))] = t;
    for (int w = 0; w < kWarps; ++w) n_live += count_s[w];
    __syncthreads();
  }
  const int count = rank < n_live ? (n_live - rank + c - 1) / c : 0;

  auto issue = [&](int it) {  // copy the it-th tile of this CTA into its ring stage
    const int t = list_s[rank + it * c];
    unsigned char* kd = smem + (it % kStages) * 2 * kTile * pitch;
    unsigned char* vd = kd + kTile * pitch;
    for (int i = tid; i < kTile * n16; i += kThreads) {
      const int slot = i / n16, ch = i - slot * n16;
      const int s = t * kTile + slot;
      const bool ok = s < S;
      const size_t r = (((size_t)b * S + (ok ? s : 0)) * Hkv + kvh) * D;
      cp_async16(kd + slot * pitch + ch * 16, reinterpret_cast<const unsigned char*>(k + r) + ch * 16, ok);
      cp_async16(vd + slot * pitch + ch * 16, reinterpret_cast<const unsigned char*>(v + r) + ch * 16, ok);
    }
    cp_async_commit();
  };
  for (int it = 0; it < min(count, kStages); ++it) issue(it);
#pragma unroll
  for (int u = 0; u < kQPer; ++u)
    if (u * kThreads + tid < GD) q_s[u * kThreads + tid] = qv[u];

  float acc[G][kElt];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElt; ++e) acc[g][e] = 0.f;
  const int slot = tid >> 2, quarter = tid & 3;  // score loop: 4 threads per slot
  const int ch = tid % n16, sg = tid / n16;      // p.v loop: a 16-byte chunk, a slot group

  for (int it = 0; it < count; ++it) {
    cp_async_wait(min(count - 1 - it, kStages - 1));
    __syncthreads();
    const int t = list_s[rank + it * c];
    const unsigned char* kd = smem + (it % kStages) * 2 * kTile * pitch;
    const unsigned char* vd = kd + kTile * pitch;

    // scores of this thread's slot for every head of the group
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    for (int c16 = quarter; c16 < n16; c16 += 4) {
      float kf[kElt];
      Vec16<T>::load(kd + slot * pitch + c16 * 16, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * D + c16 * kElt;
#pragma unroll
        for (int e = 0; e < kElt; ++e) sc[g] = fmaf(qg[e], kf[e], sc[g]);
      }
    }
    const bool live = (bits_s[t] >> slot) & 1u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
      sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 2);
      if (quarter == 0) s_s[g * kTile + slot] = live ? sc[g] : -CUDART_INF_F;
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per slot
    for (int g = warp; g < G; g += kWarps) {
      const float x = s_s[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));  // finite: the tile has a live slot
      const float p = expf(x - m_new);                // 0 for a dead slot
      const float ps = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);      // 0 before the first tile
        alpha_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + ps;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, slot groups in parallel
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < kElt; ++e) acc[g][e] *= a;
    }
    for (int sl = sg; sl < kTile; sl += n_sg) {
      float vf[kElt];
      Vec16<T>::load(vd + sl * pitch + ch * 16, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g * kTile + sl];
#pragma unroll
        for (int e = 0; e < kElt; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();  // the stage and s_s / p_s are free again
    if (it + kStages < count) issue(it + kStages);
  }

  // sum the slot groups (in order) into this CTA's partial acc[G][D], and
  // store each output's partial, and (m, l), into the shared memory of the
  // CTA that merges it: remote stores do not wait for a round trip
  float* red = reinterpret_cast<float*>(smem);  // [n_sg][G * D], over the drained ring
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElt; ++e) red[sg * GD + g * D + ch * kElt + e] = acc[g][e];
  __syncthreads();
  cluster_wait();  // every CTA of the cluster is running: its shared memory may be written
  for (int e = tid; e < GD; e += kThreads) {
    float sum = 0.f;
    for (int i = 0; i < n_sg; ++i) sum += red[i * GD + e];
    const int j = e / per;
    cluster.map_shared_rank(gacc, j)[rank * per + (e - j * per)] = sum;
  }
  if (tid < c * G) {
    const int j = tid / G, g = tid - j * G;
    cluster.map_shared_rank(gm, j)[rank * kMaxG + g] = m_s[g];
    cluster.map_shared_rank(gl, j)[rank * kMaxG + g] = l_s[g];
  }
  cluster.sync();  // every partial has reached its merging CTA

  // merge this CTA's outputs from local shared memory, in rank order
  if (tid < G) {
    float M = -CUDART_INF_F;
    for (int r = 0; r < c; ++r) M = fmaxf(M, gm[r * kMaxG + tid]);
    float L = 0.f;
    for (int r = 0; r < c; ++r) {
      const float w = M == -CUDART_INF_F ? 0.f : expf(gm[r * kMaxG + tid] - M);
      w_s[r * kMaxG + tid] = w;
      L += w * gl[r * kMaxG + tid];
    }
    L_s[tid] = L;
  }
  __syncthreads();
  const int e_end = min(GD, (rank + 1) * per);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int g = e / D, j_off = e - rank * per;
    float o = 0.f;
    for (int r = 0; r < c; ++r) o = fmaf(w_s[r * kMaxG + g], gacc[r * per + j_off], o);
    const float L = L_s[g];
    out[head0 * D + e] = from_float<T>(L > 0.f ? o / L : 0.f);
  }
}

template <typename T, int G, int D>
cudaError_t launch_gd(const void* q, const void* k, const void* v, const void* mask, void* out,
                      int B, int S, int Hkv, float scale, int cluster, int smem, cudaStream_t stream) {
  return launch_cluster<decode_attn_kernel<T, G, D>>(
      dim3(cluster, Hkv, B), kThreads, smem, cluster, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<T*>(out), S, Hkv, scale);
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                     int S, int Hkv, int D, float scale, int cluster, int smem, cudaStream_t stream) {
  switch (D * static_cast<int>(sizeof(T))) {  // a K/V row of 64, 128, 256 or 512 bytes
    case 64: return launch_gd<T, G, 64 / sizeof(T)>(q, k, v, mask, out, B, S, Hkv, scale, cluster, smem, stream);
    case 128: return launch_gd<T, G, 128 / sizeof(T)>(q, k, v, mask, out, B, S, Hkv, scale, cluster, smem, stream);
    case 256: return launch_gd<T, G, 256 / sizeof(T)>(q, k, v, mask, out, B, S, Hkv, scale, cluster, smem, stream);
    case 512: return launch_gd<T, G, 512 / sizeof(T)>(q, k, v, mask, out, B, S, Hkv, scale, cluster, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                   int S, int Hq, int Hkv, int D, float scale, int cluster, int smem,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_tiles = (S + kTile - 1) / kTile;
  if (D > 256 || G * D > kMaxGD || smem < smem_bytes(G, D, sizeof(T), n_tiles) ||
      smem > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  switch (G) {  // the GQA ratio and the head size are unrolled into the kernel
    case 1: return launch_g<T, 1>(q, k, v, mask, out, B, S, Hkv, D, scale, cluster, smem, stream);
    case 2: return launch_g<T, 2>(q, k, v, mask, out, B, S, Hkv, D, scale, cluster, smem, stream);
    case 4: return launch_g<T, 4>(q, k, v, mask, out, B, S, Hkv, D, scale, cluster, smem, stream);
    case 8: return launch_g<T, 8>(q, k, v, mask, out, B, S, Hkv, D, scale, cluster, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fq3t

// Returns a cudaError_t; 0 on success. q [B, Hq, D], k/v [B, S, Hkv, D] and
// out [B, Hq, D] in `dtype`, mask int32 [B, S], all contiguous with 16-byte
// aligned k and v. `cluster` CTAs per (kv head, batch), `smem` bytes of
// dynamic shared memory: both from ops/attention.py::_decode_plan.
extern "C" int fq3t_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int S, int Hq, int Hkv,
                                     int D, float scale, int cluster, int smem, void* stream) {
  using namespace fq3t;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || D <= 0 ||
      (S + kTile - 1) / kTile > kMaxTiles || cluster < 1 || cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, S, Hq, Hkv, D, scale, cluster, smem, st);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, mask, out, B, S, Hq, Hkv, D, scale, cluster, smem, st);
  return cudaErrorInvalidValue;
}
