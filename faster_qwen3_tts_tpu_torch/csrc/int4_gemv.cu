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
// What bounds it on an H100. Bytes: half a byte of nibbles a weight plus 8
// bytes of f32 scale and min per group of 32 weights, 0.75 B a weight: the
// 1.7B gate/up (2048 x 6144) is 9.44 MB, 2.82 us at 3.35 TB/s; the 0.6B
// 1024 x 1024 is 0.79 MB, 0.24 us, far below the ~1.2 us a launch costs under
// graph replay. So at the 0.6B shapes a call is its fixed cost: the launch,
// the dependent round trips to device memory, a cluster barrier. Operations:
// at 0.75 B a weight HBM delivers 4.5e12 weights/s, which needs 2 x M x
// 4.5e12 flop/s, 72 TFLOP/s at M = 8 and 143 at M = 16 against 67 TFLOP/s of
// f32 outside the tensor cores: from 8 rows on only the tensor cores keep up
// with memory.
//
// Design (one launch, no global scratch, no atomics, sums in a fixed order).
// Under graph replay a warp's instructions run one after another with few
// other warps to hide their latency, so the design keeps each thread's path
// short: no runtime division, loops with compile-time trip counts where the
// shapes allow, one wait for data, one pass of partial sums.
// - Tiles. A CTA owns `cols` (32, 64 or 128) output columns, up to 16 rows
//   of x and a slab of whole quantization groups of I; the `cluster` CTAs of
//   a column tile split I and merge through distributed shared memory. The
//   wrapper (ops/quant.py `_int4_plan`) gives every main-path shape at least
//   132 CTAs, all resident at once, with the fewest CTAs a cluster (its
//   barrier costs ~0.5 us; none where the column tiles alone fill the card).
// - One round trip. At the start every thread issues its share of 16-byte
//   cp.async copies of the CTA's whole slab and of x's slice: the packed
//   rows go to their places in the 32/64/128-byte swizzle pattern (so that
//   the reads below hit 32 different banks), the groups' scale and min rows
//   are read once per (group, column), not once per packed row. Then one
//   wait and one block barrier; each warp along I reduces a contiguous run
//   of the slab's groups. (TMA boxes fed per warp through mbarriers were
//   measured no faster: PERF.md, K4.)
// - CUDA cores (f32 x; bf16 below `_K4_MMA_MIN_ROWS` rows; groups that are
//   not a multiple of 16): 8 columns a thread, the warp's lanes across the
//   tile's columns and down a group's rows; both nibbles become floats by a
//   permute into the mantissa of 2^23; a group's x_even * hi + x_odd * lo and
//   its x sum are summed in f32, then scaled once by the group's scale and
//   min.
// - Tensor cores (bf16 x from `_K4_MMA_MIN_ROWS` rows, groups a multiple of
//   16): the weight passes once for all rows. mma.sync.m16n8k16 with the
//   operands swapped: the weight is A (16 output columns x 16 of the
//   reduction; a packed byte is exactly the (even, odd) pair an A register
//   holds, made the exact bf16 pair (128 + hi, 128 + lo) by one permute and
//   one LOP3), x is B (8 rows an n-tile, two at 16 rows); a third mma with
//   an A of ones gives each group's sum of x in the same layout. Each
//   group's partial is multiplied by its f32 scale into the f32 sum, and
//   (wmin - 128 scale) times its sum of x takes off the 128 and adds the min
//   term: `_dot4`'s function, with no weight rounded to bf16.
// - Merge. The warps' partials meet in shared memory and are summed in
//   order; with a cluster, each CTA writes its sum of every output straight
//   into the shared memory of the CTA that stores it (st.async, counted on
//   that CTA's mbarrier), waits for the sums of its own outputs only (no
//   cluster-wide barrier) and adds them in rank order. Deterministic,
//   so a repeat and a CUDA-graph replay give the eager call's bits, and
//   capture-safe: a launch keeps no state.

#include <cstdint>

#include "common.cuh"

namespace fq3t {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // portable cluster size

// Launch geometry, from ops/quant.py::_int4_plan.
struct Geometry {
  int M, I, O, group, n_groups;
  int per;       // groups of I per CTA
  int cluster;   // CTAs splitting I (one column tile)
  int gpw;       // groups per warp along I
  int xs_pitch;  // elements per staged row of x
  int slots;     // outputs each CTA of the cluster stores: ceil(mr * cols / cluster)
  int inv_c;     // ceil(65536 / cluster): i / cluster == (i * inv_c) >> 16 for the outputs' indices
};

__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }

// warps along I: the tensor-core path puts cols / 32 warps across the columns
__host__ __device__ constexpr int warps_along_i(bool mma, int cols) { return mma ? kWarps / (cols / 32) : kWarps; }

// Byte offsets of the shared-memory regions from the 1024-aligned base;
// ops/quant.py::_int4_smem computes the same, and the launch refuses less.
struct Layout {
  int scale, wmin, xs, wpart, gpart, bars, total;
};
__host__ __device__ constexpr Layout layout(const Geometry& g, int elt, int mr, bool mma, int cols) {
  const int scale = round_up(g.per * (g.group / 2) * cols, 1024);  // the slab's packed rows come first
  const int wmin = scale + g.per * cols * 4;
  const int xs = wmin + g.per * cols * 4;
  const int wpart = xs + round_up(mr * g.xs_pitch * elt, 128);
  const int gpart = wpart + warps_along_i(mma, cols) * mr * cols * 4;
  const int bars = gpart + round_up(g.cluster * g.slots * 4, 16);
  return {scale, wmin, xs, wpart, gpart, bars, bars + 16 + 1024};
}

// Where byte `off` of the slab's `cols`-byte packed rows lives in shared
// memory: bits 7.. of the offset are XORed into its 16-byte chunk index (the
// pattern of TMA's 32/64/128-byte swizzle).
template <int COLS>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ ((off >> 3) & ((COLS / 16 - 1) << 4));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
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

// The shared::cluster address of `p`'s counterpart in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// A 4-byte store into another CTA's shared memory that counts its bytes on
// that CTA's mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }

// The four nibbles of `bits` (0x0F0F0F0F-masked bytes) as floats, exactly.
__device__ __forceinline__ void nibbles_to_floats(unsigned bits, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(bits, 0x4B000000u, 0x7540u + j)) - 8388608.f;
}

// Byte J of the packed word w (w4 = w >> 4) as a bf16x2 A-operand register
// holding 128 + nibble, exactly (0x4300 | n is the bf16 of 128 + n): the high
// nibble (even row) in the low half, the low nibble (odd row) in the high
// half. One permute and one LOP3; the 128 comes off once per group, as 128
// times the group's sum of x.
template <int J>
__device__ __forceinline__ uint32_t nibble_pair_bf16(uint32_t w, uint32_t w4) {
  const uint32_t r = __byte_perm(w4, w, J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
  return (r & 0x000F000Fu) | 0x43004300u;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's pair (x[2p], x[2p + 1]) of staged row `row` as floats
__device__ __forceinline__ float2 x_pair(const float* row, int p) {
  return reinterpret_cast<const float2*>(row)[p];
}
__device__ __forceinline__ float2 x_pair(const __nv_bfloat16* row, int p) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(row)[p];
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// MR rows of x and COLS output columns per CTA; kMma: the tensor-core path
// (bf16 only, MR = 8 or 16). Grid: (cluster, column tiles, row groups).
template <typename T, int MR, bool kMma, int COLS>
__global__ void __launch_bounds__(kThreads, 2) int4_gemv_kernel(
    const T* __restrict__ x,              // [M, I]
    const uint8_t* __restrict__ packed,   // [I/2, O]
    const float* __restrict__ scale,      // [I/group, O]
    const float* __restrict__ wmin,       // [I/group, O]
    T* __restrict__ y,                    // [M, O]
    const Geometry geo) {
  constexpr int kSub = kMma ? COLS / 32 : 1;  // warps across the columns
  constexpr int kKs = kWarps / kSub;          // warps along I
  constexpr int kOut = MR * COLS;             // outputs of a CTA
  const int c = geo.cluster;
  const int rank = blockIdx.x, col_base = blockIdx.y * COLS, m0 = blockIdx.z * MR;
  const int mcount = min(MR, geo.M - m0);
  const int half = geo.group >> 1;
  const int g0 = rank * geo.per;
  const int ng = min(geo.per, geo.n_groups - g0);  // groups this CTA reduces
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = warp % kSub, ks = warp / kSub;
  const int wg0 = ks * geo.gpw;                          // this warp's groups: [wg0, wg0 + wng) of the slab
  const int wng = max(0, min(geo.gpw, ng - wg0));
  const Layout L = layout(geo, sizeof(T), MR, kMma, COLS);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* sc_s = reinterpret_cast<float*>(smem + L.scale);  // [per][COLS]
  float* mn_s = reinterpret_cast<float*>(smem + L.wmin);
  T* x_s = reinterpret_cast<T*>(smem + L.xs);                     // [MR][xs_pitch]
  float* wpart = reinterpret_cast<float*>(smem + L.wpart);        // [kKs][MR][COLS]
  float* gpart = reinterpret_cast<float*>(smem + L.gpart);        // [c][slots]
  uint64_t* mrg = reinterpret_cast<uint64_t*>(smem + L.bars);     // the cluster's sums, arriving

  // with a cluster: the merge's mbarrier expects c sums of each output this
  // CTA stores (output i is stored by rank i % c, in slot i / c); the
  // arrival releases its initialisation to the other CTAs
  if (c > 1) {
    if (tid == 0) {
      mbar_init(mrg, 1);
      mbar_expect_tx(mrg, c * (((kOut - rank + c - 1) * geo.inv_c) >> 16) * 4);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive();
  }

  // every byte of the slab and of x's slice, issued by all threads before
  // any waits: 16-byte cp.async into shared memory (the packed rows into
  // their swizzled places; pieces past O are zero-filled and not read), one
  // wait, one barrier
  constexpr int kRowPieces = COLS / 16, kScalePieces = COLS / 4;
  const int row0 = g0 * geo.group, xn = ng * geo.group;
  {
    const int pieces = ng * half * kRowPieces;
    const uint8_t* src = packed + (size_t)g0 * half * geo.O + col_base;
    for (int p = tid; p < pieces; p += kThreads) {
      const int r = p / kRowPieces, q = p % kRowPieces;
      cp_async16(smem + swizzle<COLS>(r * COLS + 16 * q), src + (size_t)r * geo.O + 16 * q,
                 col_base + 16 * q < geo.O);
    }
    const int spieces = ng * kScalePieces;
    const size_t so = (size_t)g0 * geo.O + col_base;
    for (int p = tid; p < spieces; p += kThreads) {
      const int g = p / kScalePieces, q = p % kScalePieces;
      const bool ok = col_base + 4 * q < geo.O;
      cp_async16(sc_s + g * COLS + 4 * q, scale + so + (size_t)g * geo.O + 4 * q, ok);
      cp_async16(mn_s + g * COLS + 4 * q, wmin + so + (size_t)g * geo.O + 4 * q, ok);
    }
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (geo.I * (int)sizeof(T)) % 16 == 0 &&
                   (geo.per * geo.group * (int)sizeof(T)) % 16 == 0;
  if (vec) {
    const int pieces = xn * (int)sizeof(T) / 16;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x + (size_t)(m0 + min(m, mcount - 1)) * geo.I + row0);
      unsigned char* dst = reinterpret_cast<unsigned char*>(x_s + m * geo.xs_pitch);
      for (int v = tid; v < pieces; v += kThreads) cp_async16(dst + 16 * v, src + 16 * v, m < mcount);
    }
  } else {  // rows or slab not 16-byte aligned (tiny layers): element by element; rows past M are zero
#pragma unroll
    for (int m = 0; m < MR; ++m)
      for (int r = tid; r < xn; r += kThreads)
        x_s[m * geo.xs_pitch + r] = m < mcount ? x[(size_t)(m0 + m) * geo.I + row0 + r] : from_float<T>(0.f);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();  // the slab and x are in shared memory

  if constexpr (!kMma) {
    // 8 columns a lane: kLanes lanes across the tile, kRL down a group's rows
    constexpr int kLanes = COLS / 8, kRL = 32 / kLanes;
    const int cl = lane % kLanes, rl = lane / kLanes;
    float acc[MR][8];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
    {
#pragma unroll 2
      for (int g = wg0; g < wg0 + wng; ++g) {  // group in the slab
        float p[MR][8], xs[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          xs[m] = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) p[m][q] = 0.f;
        }
#pragma unroll 2
        for (int j = rl; j < half; j += kRL) {
          const int off = (g * half + j) * COLS + cl * 8;
          const uint2 w = *reinterpret_cast<const uint2*>(smem + swizzle<COLS>(off));
          float hi[8], lo[8];
          nibbles_to_floats((w.x >> 4) & 0x0F0F0F0Fu, hi);
          nibbles_to_floats((w.y >> 4) & 0x0F0F0F0Fu, hi + 4);
          nibbles_to_floats(w.x & 0x0F0F0F0Fu, lo);
          nibbles_to_floats(w.y & 0x0F0F0F0Fu, lo + 4);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float2 xv = x_pair(x_s + m * geo.xs_pitch, g * half + j);
            xs[m] += xv.x + xv.y;
#pragma unroll
            for (int q = 0; q < 8; ++q) p[m][q] = fmaf(xv.y, lo[q], fmaf(xv.x, hi[q], p[m][q]));
          }
        }
        const int so = g * COLS + cl * 8;
        const float4 s0 = *reinterpret_cast<const float4*>(sc_s + so);
        const float4 s1 = *reinterpret_cast<const float4*>(sc_s + so + 4);
        const float4 n0 = *reinterpret_cast<const float4*>(mn_s + so);
        const float4 n1 = *reinterpret_cast<const float4*>(mn_s + so + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(nv[q], xs[m], fmaf(sv[q], p[m][q], acc[m][q]));
      }
    }
    // lanes sharing their columns (same cl) differ in the bits of rl
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] += __shfl_xor_sync(0xffffffffu, acc[m][q], o);
    if (rl == 0) {
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        float* dst = wpart + (ks * MR + m) * COLS + cl * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
  } else {
    // warp = (sub, ks): a 32-column sub-tile (two 16-column m-tiles) and its
    // run of groups. Lane (gq, t) holds A rows gq and gq + 8 of both m-tiles,
    // i.e. columns 4 gq .. 4 gq + 3 of the sub-tile (one 32-bit word of a
    // packed row), and k-pairs t and t + 4 of each 16-deep step: packed rows
    // ra and rb of the step's 8, chosen per swizzle so that the 4 rows of a
    // load land in 4 different bank groups.
    constexpr int NT = MR / 8;
    const int gq = lane >> 2, t = lane & 3;
    const int ra = COLS == 32 ? t : COLS == 64 ? ((t & 1) | ((t >> 1) << 2)) : 2 * t;
    const int rb = COLS == 32 ? t + 4 : COLS == 64 ? ra + 2 : ra + 1;
    // a step starts on an 8-row swizzle atom, so its rows' swizzled column
    // offsets are the same in every step
    const int offa = swizzle<COLS>(ra * COLS + sub * 32 + 4 * gq);
    const int offb = swizzle<COLS>(rb * COLS + sub * 32 + 4 * gq);
    const int xw = geo.xs_pitch / 2;  // 32-bit words per staged row of x
    const uint32_t* xrow[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) xrow[nt] = reinterpret_cast<const uint32_t*>(x_s) + (8 * nt + gq) * xw;
    const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};  // bf16x2 (1, 1)
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    {
#pragma unroll 2
      for (int g = wg0; g < wg0 + wng; ++g) {
        float part[2][NT][4], xsum[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[0][nt][i] = part[1][nt][i] = xsum[nt][i] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < half; kk += 8) {
          const unsigned char* step = smem + (g * half + kk) * COLS;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(step + offa);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(step + offb);
          const uint32_t w04 = w0 >> 4, w14 = w1 >> 4;
          const uint32_t a0[4] = {nibble_pair_bf16<0>(w0, w04), nibble_pair_bf16<1>(w0, w04),
                                  nibble_pair_bf16<0>(w1, w14), nibble_pair_bf16<1>(w1, w14)};
          const uint32_t a1[4] = {nibble_pair_bf16<2>(w0, w04), nibble_pair_bf16<3>(w0, w04),
                                  nibble_pair_bf16<2>(w1, w14), nibble_pair_bf16<3>(w1, w14)};
          const int xp = g * half + kk;  // the step's first packed row in x's slice
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t b0 = xrow[nt][xp + ra], b1 = xrow[nt][xp + rb];
            mma_bf16(part[0][nt], a0, b0, b1);
            mma_bf16(part[1][nt], a1, b0, b1);
            mma_bf16(xsum[nt], ones, b0, b1);
          }
        }
        // C rows gq / gq + 8 of m-tile mt are columns 4 gq + 2 mt + 0 / 1;
        // C columns 2 t, 2 t + 1 of n-tile nt are rows 8 nt + 2 t (+ 1) of x.
        // part holds sum x (128 + n): y += scale * part + (wmin - 128 scale) * sum x
        const int so = g * COLS + sub * 32 + 4 * gq;
        const float4 s4 = *reinterpret_cast<const float4*>(sc_s + so);
        const float4 n4 = *reinterpret_cast<const float4*>(mn_s + so);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float nv[4] = {fmaf(-128.f, s4.x, n4.x), fmaf(-128.f, s4.y, n4.y), fmaf(-128.f, s4.z, n4.z),
                             fmaf(-128.f, s4.w, n4.w)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 2 * mt + (i >> 1);
              acc[mt][nt][i] = fmaf(nv[j], xsum[nt][i & 1], fmaf(sv[j], part[mt][nt][i], acc[mt][nt][i]));
            }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = sub * 32 + 4 * gq + 2 * mt + (i >> 1), m = 8 * nt + 2 * t + (i & 1);
          wpart[(ks * MR + m) * COLS + col] = acc[mt][nt][i];
        }
  }
  __syncthreads();

  // this CTA's sum of each output over its warps along I, in order
  constexpr int kPer = (kOut + kThreads - 1) / kThreads;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    v[u] = 0.f;
    if (kOut % kThreads == 0 || i < kOut) {
#pragma unroll
      for (int p = 0; p < kKs; ++p) v[u] += wpart[p * kOut + i];
    }
  }
  if (c == 1) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads, m = i / COLS, oc = col_base + i % COLS;
      if ((kOut % kThreads == 0 || i < kOut) && m < mcount && oc < geo.O)
        y[(size_t)(m0 + m) * geo.O + oc] = from_float<T>(v[u]);
    }
    return;
  }
  // each CTA's sum goes straight into the shared memory of the CTA that
  // stores the output (itself included), counted on that CTA's mbarrier; a
  // CTA waits for its own outputs' sums only, not for the whole cluster
  cluster_wait();  // every CTA of the cluster is running, its mbarrier initialised
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    if (kOut % kThreads == 0 || i < kOut) {
      const int slot = (i * geo.inv_c) >> 16, owner = i - slot * c;
      st_async(cluster_addr(gpart + rank * geo.slots + slot, owner), v[u], cluster_addr(mrg, owner));
    }
  }
  mbar_wait(mrg, 0);  // every sum of this CTA's outputs has arrived
  for (int slot = tid; slot < geo.slots; slot += kThreads) {
    const int i = slot * c + rank, m = i / COLS, oc = col_base + i % COLS;
    if (i < kOut && m < mcount && oc < geo.O) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < c) s += gpart[r * geo.slots + slot];
      y[(size_t)(m0 + m) * geo.O + oc] = from_float<T>(s);
    }
  }
}

template <typename T, int MR, bool kMma, int COLS>
cudaError_t launch_cols(const void* x, const void* packed, const void* scale, const void* wmin, void* y,
                        const Geometry& g, int smem, cudaStream_t stream) {
  if (smem < layout(g, sizeof(T), MR, kMma, COLS).total || smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  const dim3 grid(g.cluster, (g.O + COLS - 1) / COLS, (g.M + MR - 1) / MR);
  auto kernel = int4_gemv_kernel<T, MR, kMma, COLS>;
  const auto* xt = static_cast<const T*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  const auto* m = static_cast<const float*>(wmin);
  auto* yt = static_cast<T*>(y);
  if (g.cluster > 1)
    return launch_cluster<int4_gemv_kernel<T, MR, kMma, COLS>>(grid, kThreads, smem, g.cluster, stream, xt, p, s, m,
                                                               yt, g);
  // one CTA a column tile: a plain launch, no cluster
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr_err != cudaSuccess) return attr_err;
  kernel<<<grid, kThreads, smem, stream>>>(xt, p, s, m, yt, g);
  return cudaGetLastError();
}

template <typename T, int MR, bool kMma>
cudaError_t launch_mr(const void* x, const void* packed, const void* scale, const void* wmin, void* y,
                      const Geometry& g, int cols, int smem, cudaStream_t stream) {
  if (cols == 32) return launch_cols<T, MR, kMma, 32>(x, packed, scale, wmin, y, g, smem, stream);
  if (cols == 64) return launch_cols<T, MR, kMma, 64>(x, packed, scale, wmin, y, g, smem, stream);
  return launch_cols<T, MR, kMma, 128>(x, packed, scale, wmin, y, g, smem, stream);
}

}  // namespace
}  // namespace fq3t

// Returns a cudaError_t; 0 on success. x [M, I] and y [M, O] in `dtype`,
// packed uint8 [I/2, O], scale and wmin f32 [I/group, O] (all three 16-byte
// aligned, O % 16 == 0, group even and dividing I). The geometry and `smem`
// come from ops/quant.py::_int4_plan: `cluster` CTAs of `groups_per_cta`
// groups split I; column tiles of `cols`; each warp along I takes `gpw`
// groups; x staged at `xs_pitch` elements a row; `mr` rows of x a CTA;
// `mma` selects the tensor-core path.
extern "C" int fq3t_int4_gemv(int dtype, const void* x, const void* packed, const void* scale,
                              const void* wmin, void* y, int M, int I, int O, int group, int groups_per_cta,
                              int cluster, int cols, int gpw, int xs_pitch, int mr, int mma, int smem,
                              void* stream) {
  using namespace fq3t;
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  const int elt = dtype == kBFloat16 ? 2 : 4;
  if (M <= 0 || M > 16 || I <= 0 || O <= 0 || O % 16 != 0 || group < 2 || group % 2 != 0 || I % group != 0 ||
      misaligned(packed) || misaligned(scale) || misaligned(wmin) || groups_per_cta <= 0 || cluster < 1 ||
      cluster > kMaxCluster || (cols != 32 && cols != 64 && cols != 128) || gpw < 1 ||
      xs_pitch < groups_per_cta * group || (xs_pitch * elt) % 16 != 0)
    return cudaErrorInvalidValue;
  const int n_groups = I / group;
  if ((long long)groups_per_cta * cluster < n_groups || (long long)groups_per_cta * (cluster - 1) >= n_groups ||
      (long long)warps_along_i(mma, cols) * gpw < groups_per_cta)
    return cudaErrorInvalidValue;
  if (mma ? (dtype != kBFloat16 || group % 16 != 0 || (mr != 8 && mr != 16))
          : ((mr != 1 && mr != 2 && mr != 4) || (mr < 4 && M > mr)))
    return cudaErrorInvalidValue;
  const int slots = (mr * cols + cluster - 1) / cluster;
  const Geometry g{M, I, O, group, n_groups, groups_per_cta, cluster, gpw, xs_pitch, slots,
                   (65536 + cluster - 1) / cluster};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    if (mma)
      return mr == 8 ? launch_mr<B, 8, true>(x, packed, scale, wmin, y, g, cols, smem, st)
                     : launch_mr<B, 16, true>(x, packed, scale, wmin, y, g, cols, smem, st);
    if (mr == 1) return launch_mr<B, 1, false>(x, packed, scale, wmin, y, g, cols, smem, st);
    if (mr == 2) return launch_mr<B, 2, false>(x, packed, scale, wmin, y, g, cols, smem, st);
    return launch_mr<B, 4, false>(x, packed, scale, wmin, y, g, cols, smem, st);
  }
  if (mr == 1) return launch_mr<float, 1, false>(x, packed, scale, wmin, y, g, cols, smem, st);
  if (mr == 2) return launch_mr<float, 2, false>(x, packed, scale, wmin, y, g, cols, smem, st);
  return launch_mr<float, 4, false>(x, packed, scale, wmin, y, g, cols, smem, st);
}
