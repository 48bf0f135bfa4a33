// flash_star: fused causal/ragged attention with the STAR integer-grid
// online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_star/kernel.py
// (flash_star_attention / _kernel, with and without pv_int8).  The TPU grid
// (B, Hq, nq, nk) runs its innermost KV axis in order and carries (m, l, acc)
// in VMEM scratch; here one CTA owns one (batch, q head, 64-row q block) and
// walks the KV tiles in a loop, so nothing carries between CTAs.
//
// STAR arithmetic matches the TPU kernel: score s = (q.k) * sm_scale snaps
// to j = rint(s * 2^frac) (round half to even, as jnp.round), saturated to
// [GRID_SENTINEL, -GRID_SENTINEL] before the int cast (NaN -> sentinel) so an
// infinite score cannot wrap; the running max is an int32, and both the
// rescale factor and the probabilities are entries of the exp LUT
// (core/lut.py) that the wrapper passes in.  lut == nullptr selects the
// exact float softmax.  All softmax arithmetic is float32 (block_softmax,
// shared by every kernel here); the output has the input's type.  Built
// without fast math.
//
// Every product runs on the tensor cores (mma.sync).  The kernels, chosen by
// type and variant (the wrapper routes; each entry point refuses the others'
// types):
//   flash_star_mma_kernel         bfloat16 q/k/v (flash_star_mma_launch);
//   flash_star_tf32_kernel        float32 q/k/v, products as 3xTF32
//                                 (flash_star_tf32_launch);
//   flash_star_quantize_v_kernel  the int8 P.V variant (pv_int8=True in the
//   + flash_star_pv_int8_kernel   TPU kernel, kernel.py:129-141), either
//                                 type: V's codes once per block, then the
//                                 attention with s8 P.V
//                                 (flash_star_quantize_v_launch, then
//                                 flash_star_pv_int8_launch);
//   flash_star_blocked_kernel     STAR at 2 to 5 bits, either type: the TPU
//                                 kernel's block_k blocks, each block's max
//                                 before its P (flash_star_blocked_launch;
//                                 "The block route" below).
// flash_star_tf32_kernel, flash_star_pv_int8_kernel and
// flash_star_blocked_kernel share one body, tc_attention, a sibling of the
// bf16 kernel rather than a template of it: their K and V tiles go through a split into
// tf32 planes (float32) or their P.V through a block of int8 codes, so tile
// sizes, shared memory and the P.V step all differ, while the score tiles'
// layout and the softmax (block_softmax) are the same in all three.
//
// Head dims 8, 16, 32, 64, 128 and 256 (recurrentgemma-2b) on every kernel:
// at 256 the bf16 kernel reads Q's fragments from shared memory (see
// flash_star_mma_kernel) and the float32 and int8 P.V kernels take 32 q rows
// a CTA, each row's output columns split between two warps (see
// tc_attention).  At D 8 (the smoke configs of
// deepseek-coder-33b and llama3-405b) a bf16 QK^T still needs k in steps of
// 16 (m16n8k16): the bf16 kernels keep Q and K rows of DK = 16 columns in
// shared memory, the last 8 zero-filled by the same cp.async copies (a
// source size of 0), so every dot product is the 8-term one exactly; the
// wrapper's sm_scale keeps the true D.  V and the output stay 8 wide: one n8
// tile, NO = 1, its B fragments by ldmatrix .x2.  The float32 kernel's
// m16n8k8 tf32 step fits D 8 as it is; the int8 P.V variant folds its s8
// sums into 8 features (V's codes keep their layout).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int GRID_SENTINEL = -(1 << 24);
constexpr float NEG_BIG = -1e30f;
constexpr int MQ = 64;              // q rows per CTA, 16 per warp
constexpr int MT = 128;             // four warps
constexpr int LUT_SMEM_MAX = 4096;  // larger LUTs are read from global memory

template <int N>
using Int = std::integral_constant<int, N>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  const void* q; const void* k; const void* v; void* o;
  const int32_t* info;  // [1 + B]: q_offset, kv_valid per batch
  const float* lut;     // [num_levels], nullptr = exact softmax
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  int B, Hq, Hkv, Tq, Tk;
  int causal, window;   // window <= 0: no sliding window
  float sm_scale, grid_scale;
  int num_levels;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // all but the newest N groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 16-byte matrices: register i of lane l holds 4 bytes (2 bf16, 1
// float, 4 int8) of matrix i, row l / 4, bytes 4 (l % 4) .. + 3.  Lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}
// Two matrices: lanes 0-15 give the addresses (those of lanes 16-31 are not
// read), register i as in ldsm_x4.  The B fragments of one n8 tile at D 8.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(ptr)));
}

// The k width of a bf16 QK^T: D, or 16 at D 8 (columns D .. 15 zero)
__host__ __device__ constexpr int kdim(int d) { return d < 16 ? 16 : d; }

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators.  Lane
// 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B (t,
// g), (t + 4, g).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulators.  Lane 4 g +
// t holds A rows g (a0, a2) and g + 8 (a1, a3) at k = 4 t + i (a0, a1) and
// 16 + 4 t + i (a2, a3), byte i; B column g at the same k (b0, b1).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to nearest as bf16, x in the low half: an mma fragment
// register holding columns c, c + 1
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Two neighbouring p (columns c, c + 1 of one row) as three packed bf16
// pieces each: hi + mid + lo == p (the differences are exact in float32).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float2 h = unpack_bf16(hi);
  const float xr = __fsub_rn(x, h.x), yr = __fsub_rn(y, h.y);
  mid = pack_bf16(xr, yr);
  const float2 m = unpack_bf16(mid);
  lo = pack_bf16(__fsub_rn(xr, m.x), __fsub_rn(yr, m.y));
}

// x rounded to the nearest tf32 (ties away), as a float32 bit pattern
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x = hi + lo as two tf32 values (3xTF32: hi.hi + hi.lo + lo.hi of two such
// operands is their float32 product up to ~2^-21 of it; ref.split_tf32 is
// the plain copy)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(__fsub_rn(x, h)));
}

// snap's grid index with one F2I.RNI: rint(s * scale) saturated to the
// sentinel range, NaN -> sentinel (fmaxf returns the bound for a NaN)
__device__ __forceinline__ int snap_rn(float s, float scale) {
  const float lim = static_cast<float>(-GRID_SENTINEL);
  return __float2int_rn(fminf(fmaxf(s * scale, -lim), lim));
}

// The online softmax of one block of scores for this thread's rows g and g
// + 8 of its warp, as every kernel here forms it, in three steps that the
// int8 P.V variant also takes apart (tile_scores over all of a block's
// tiles, running_max once, tile_probs over the tiles again).  Element e of
// n-tile j of s is column cb + 8 j + (e & 1) (cb = c0 + 2 tg) of row g (e <
// 2) or g + 8; it is live when lo[e / 2] <= column <= hi[e / 2] (FULL: all
// are).  s = fl(acc * sm_scale), a separate multiply (sm_scale and log2(e)
// are not folded into q or an exp2: the grid index is rint(fl(s *
// grid_scale)) as in the plain version); masked entries never enter the max
// and give p = 0.  STAR: the int32 row max is reduced across the four
// threads that share a row of the fragment, r and p are LUT entries (a live
// j is at most the row max).  Exact: expf, no fast math.  s becomes p, r
// the rescale of the running state, and l = fl(fl(l r) + the row sum of the
// unsplit p).
template <bool FULL>
struct Live {
  int dlo[2] = {0, 0}, dhi[2] = {0, 0};
  __device__ __forceinline__ Live(const int (&lo)[2], const int (&hi)[2], int cb) {
    if constexpr (!FULL) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dlo[hr] = lo[hr] - cb;
        dhi[hr] = hi[hr] - cb;
      }
    }
  }
  __device__ __forceinline__ bool operator()(int j, int e) const {
    const int c = 8 * j + (e & 1);
    return FULL || (c >= dlo[e >> 1] && c <= dhi[e >> 1]);
  }
};

// s = fl(s * sm_scale); STAR: each s becomes its grid index (as float bits),
// a masked one the sentinel; exact: a masked s becomes NEG_BIG.  mi / mf
// take this thread's max of the tile's rows.
template <int NS, bool STAR, bool FULL>
__device__ __forceinline__ void tile_scores(float (&s)[NS][4], const Live<FULL>& is_live,
                                            const Params& p, int (&mi)[2], float (&mf)[2]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], p.sm_scale);
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (STAR) {  // the grid index takes the score's register
        const int jg = is_live(j, e) ? snap_rn(s[j][e], p.grid_scale) : GRID_SENTINEL;
        s[j][e] = __int_as_float(jg);
        mi[e >> 1] = max(mi[e >> 1], jg);
      } else {
        if (!is_live(j, e)) s[j][e] = NEG_BIG;
        mf[e >> 1] = fmaxf(mf[e >> 1], s[j][e]);
      }
    }
}

// The rows' running max after a tile's (or a whole block's) max mi / mf,
// reduced across the four threads of a row; r the rescale of the running
// state (STAR: a LUT entry, m_new >= m_i).
template <bool STAR>
__device__ __forceinline__ void running_max(int (&mi)[2], float (&mf)[2], const Params& p,
                                            const float* lut, int (&m_i)[2], float (&m_f)[2],
                                            float (&r)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if constexpr (STAR) {
      mi[hr] = max(mi[hr], __shfl_xor_sync(0xffffffffu, mi[hr], 1));
      mi[hr] = max(mi[hr], __shfl_xor_sync(0xffffffffu, mi[hr], 2));
      const int m_new = max(m_i[hr], mi[hr]);
      r[hr] = lut[min(m_new - m_i[hr], p.num_levels - 1)];
      m_i[hr] = m_new;
    } else {
      mf[hr] = fmaxf(mf[hr], __shfl_xor_sync(0xffffffffu, mf[hr], 1));
      mf[hr] = fmaxf(mf[hr], __shfl_xor_sync(0xffffffffu, mf[hr], 2));
      const float m_new = fmaxf(m_f[hr], mf[hr]);
      r[hr] = expf(__fsub_rn(m_f[hr], m_new));
      m_f[hr] = m_new;
    }
  }
}

// tile_scores' s -> p against the running max (0 where masked); then ps +=
// this thread's row sums of the tile, in n-tile order
template <int NS, bool STAR, bool FULL>
__device__ __forceinline__ void tile_probs(float (&s)[NS][4], const Live<FULL>& is_live,
                                           const Params& p, const float* lut,
                                           const int (&m_i)[2], const float (&m_f)[2],
                                           float (&ps)[2]) {
  const int top = p.num_levels - 1;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (STAR)
        s[j][e] = is_live(j, e) ? lut[min(m_i[e >> 1] - __float_as_int(s[j][e]), top)] : 0.f;
      else
        s[j][e] = is_live(j, e) ? expf(__fsub_rn(s[j][e], m_f[e >> 1])) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[e >> 1] = __fadd_rn(ps[e >> 1], s[j][e]);
}

template <int NS, bool STAR, bool FULL>
__device__ __forceinline__ void block_softmax(float (&s)[NS][4], const int (&lo)[2],
                                              const int (&hi)[2], int cb, const Params& p,
                                              const float* lut, int (&m_i)[2], float (&m_f)[2],
                                              float (&l)[2], float (&r)[2]) {
  const Live<FULL> is_live(lo, hi, cb);
  int mi[2] = {GRID_SENTINEL, GRID_SENTINEL};
  float mf[2] = {NEG_BIG, NEG_BIG};
  tile_scores<NS, STAR, FULL>(s, is_live, p, mi, mf);
  running_max<STAR>(mi, mf, p, lut, m_i, m_f, r);
  float ps[2] = {0.f, 0.f};
  tile_probs<NS, STAR, FULL>(s, is_live, p, lut, m_i, m_f, ps);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = __fadd_rn(__fmul_rn(l[hr], r[hr]), ps[hr]);
}

// o *= r for the rows whose max moved; a row whose max held has r == 1
// exactly, and a warp whose rows all held skips the multiplies
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], const float (&r)[2]) {
  if (__any_sync(0xffffffffu, r[0] != 1.f || r[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] = __fmul_rn(o[n][0], r[0]);
      o[n][1] = __fmul_rn(o[n][1], r[0]);
      o[n][2] = __fmul_rn(o[n][2], r[1]);
      o[n][3] = __fmul_rn(o[n][3], r[1]);
    }
  }
}

// Block -> (q block of mq rows, head, batch), the longest causal rows
// first.  When the grid is one wave of two CTAs per SM, the second CTA of
// each SM (blocks from first_round on, dispatched in the first round's SM
// order) takes the lightest remaining work, so heavy and light q blocks
// pair up.
struct Tile {
  int iq, h, b, hk;
};
__device__ __forceinline__ Tile tile_of_block(const Params& p, int first_round, int mq) {
  const int nq = (p.Tq + mq - 1) / mq, hb = p.Hq * p.B;
  const int blk = blockIdx.x;
  const int rank = first_round > 0 && blk >= first_round
      ? static_cast<int>(gridDim.x) - 1 - (blk - first_round) : blk;
  Tile t;
  t.iq = nq - 1 - rank / hb;
  t.h = rank % hb % p.Hq;
  t.b = rank % hb / p.Hq;
  t.hk = t.h / (p.Hq / p.Hkv);
  return t;
}

// The epilogue of every kernel here: o / den (a true division, den = the
// row sum, or 1 where it is <= 0) in the output's type, columns c0 + 8 n +
// 2 tg, + 1 of rows r0 + g and r0 + g + 8 of the CTA's MQ_ rows, where warp
// w owns rows r0 = 16 (w % RG) and columns c0 = DW (w / RG) (the warp index
// taken here from threadIdx: a kernel at its register limit keeps nothing
// live for the epilogue)
template <typename T, int MQ_, int RG, int DW, int NO>
__device__ __forceinline__ void store_rows(const Params& p, const Tile& tl,
                                           const float (&o)[NO][4], const float (&l)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = RG == MT / 32 ? 16 * warp : 16 * (warp % RG);
  const int c0 = RG == MT / 32 ? 0 : DW * (warp / RG);
  T* og = static_cast<T*>(p.o) + tl.b * p.o_sb + tl.h * p.o_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float den = l[hr];
    den = __fadd_rn(den, __shfl_xor_sync(0xffffffffu, den, 1));
    den = __fadd_rn(den, __shfl_xor_sync(0xffffffffu, den, 2));
    if (den <= 0.f) den = 1.f;
    const int t = tl.iq * MQ_ + r0 + g + 8 * hr;
    if (t < p.Tq) {
      T* orow = og + t * p.o_st + c0 + 2 * tg;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float x = __fdiv_rn(o[n][2 * hr], den), y = __fdiv_rn(o[n][2 * hr + 1], den);
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(x, y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 kernel on the tensor cores, flash_star_mma_kernel.
//
// Replaces the same TPU kernel (src/repro/kernels/flash_star/kernel.py:216,
// flash_star_attention / _kernel without pv_int8) for bf16 q/k/v, the type
// the models serve in.  What bounds it: at a 512-token causal prefill (q
// [1, 32, 512, 128], kv [1, 8, 512, 128]) the live work is 1.07 GFLOP of
// QK^T and 1.07 GFLOP of P.V; the bytes take 3.1 us at 3.35 TB/s and the
// tensor work 2.2 us at 989 TFLOP/s (4.3 us with P.V done three times, as
// below), so the card's rates allow a few microseconds and what is left is
// latency: tile loads, the softmax's scalar work and a grid of 256 CTAs.
//
// Design (FlashAttention-2's shape): one CTA of 4 warps owns (batch, q head,
// 64 q rows), 16 rows per warp.  The grid is one-dimensional and hands out
// the longest causal rows first (tile_of_block).  Each warp keeps its Q
// fragments in registers (ldmatrix once; not at D 256, below).  K and V tiles
// of 64 rows pass through a two-stage ring in shared memory filled by 16-byte
// cp.async copies (rows past Tk zero-filled): tile i + 1 loads while tile i
// computes, and the first tile's V lands while its QK^T runs. Rows are padded
// by 16 bytes, so the eight row addresses of each ldmatrix (K) and
// ldmatrix.trans (V) fall on distinct banks.  Tiles outside the causal /
// window / ragged range are skipped by the CTA, and by a warp whose 16 rows
// see none of the tile; the mask is built only in tiles that are not wholly
// live for the warp, and a row whose max held (r == 1 exactly) skips the
// rescale. mma.sync.m16n8k16 (bf16 in, float32 accumulators) is far faster
// than this shape needs; wgmma with TMA is the step after, once a profile
// shows the tensor pipe as the limit.  On an H100 80GB HBM3 at 700 W it runs
// ~27 us at the shape above, ~9x its bound: each warp streams the whole K and
// V tile from shared memory for its 16 rows, and startup, softmax and P.V's
// three products each take a share (PERF.md).
//
// D 256 (recurrentgemma-2b's 10 q heads over one KV head): a warp's 16 rows
// of O are NO = 32 n-tiles, 128 float32 registers a thread, and the scores
// of a 64-row tile 32 more; Q's fragments held as at D <= 128 would add 64,
// past what a thread may hold without spilling.  So at D > 128 the warp
// reads Q's fragment of each 16-column step from shared memory with
// ldmatrix as the QK^T reaches it (Q stays in shared memory for the CTA's
// life), and the KV tile is halved to MK = mk_of(256) = 32 rows (16 score
// registers): with 64-row tiles ptxas still spilled 20-40 bytes at 255
// registers; at 32 it spills none (252-254 registers, PERF.md).  Shared
// memory at D 256: (64 + 2 x 2 x 32) rows of 264 bf16, 101,376 bytes
// (117,760 with a LUT of 4096 levels).
//
// Arithmetic, as the reference's: bf16 x bf16 products are exact in
// float32, so QK^T differs from the float32 dot only in the order of its
// sums; the softmax is block_softmax.  P is float32 (a LUT entry or an
// expf), and rounding it to bf16 would break the outputs' float32 rounding,
// so each p is split in registers into three bf16 pieces, hi = bf16(p),
// mid = bf16(p - hi), lo = bf16(p - hi - mid), which sum to p exactly for
// p >= 2^-100 (within 2^-134 below; ref.split_bf16x3 is the plain copy);
// V is bf16 already, so three mma's into one float32 accumulator give the
// float32 P.V up to the order of its sums.  The A operands come straight
// from the score accumulators' registers.

constexpr int MSTAGES = 2;          // K/V ring depth

// KV rows per tile
__host__ __device__ constexpr int mk_of(int d) { return d > 128 ? 32 : 64; }

template <int D>
constexpr size_t smem_bytes_mma() {
  return sizeof(__nv_bfloat16) * (MQ + 2 * MSTAGES * mk_of(D)) * (kdim(D) + 8);
}

// minBlocks 1: without it ptxas caps small-D instantiations at 128
// registers (four CTAs an SM) and spills
template <int D, bool STAR>
__global__ void __launch_bounds__(MT, 1) flash_star_mma_kernel(Params p, int first_round) {
  constexpr int DK = kdim(D);     // columns of a shared row (D 8: 8 of them zero)
  constexpr int MK = mk_of(D);    // KV rows per tile
  constexpr bool Q_SMEM = D > 128;  // Q's fragments read from shared memory at each step
  constexpr int PITCH = DK + 8;   // bf16 per shared row: 16 bytes of padding
  constexpr int TILE = MK * PITCH;
  constexpr int CH = DK / 8;      // 16-byte chunks per row (past D: zero-filled)
  constexpr int NS = MK / 8;      // score n-tiles per warp
  constexpr int NO = D / 8;       // output n-tiles per warp
  constexpr int VG = D >= 32 ? 2 : 1;  // V column groups per P.V step
  constexpr int QK_STEPS = (DK / 16) * (NS / 2);
  static_assert(D % 8 == 0 && DK % 16 == 0, "head_dim 8 or a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MQ][PITCH]
  __nv_bfloat16* ring = Qs + MQ * PITCH;  // stage s: K at ring + 2 s TILE, V after it
  float* lut_s = reinterpret_cast<float*>(ring + 2 * MSTAGES * TILE);

  const Tile tl = tile_of_block(p, first_round, MQ);
  const int iq = tl.iq, b = tl.b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  const int q_offset = p.info[0];
  const int kv_lim = min(p.info[1 + b], p.Tk);
  const int row0 = iq * MQ + q_offset;  // absolute position of the CTA's row 0
  const int wr0 = row0 + warp * 16;     // ... of the warp's row 0

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + tl.h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + tl.hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + tl.hk * p.v_sh;

  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, row0 + MQ);
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, row0 - p.window + 1) / MK * MK;
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + MK - 1) / MK : 0;

  // a thread copies the 16-byte chunk tid % CH of rows tid / CH + i * RS
  constexpr int RS = MT / CH;
  const int r_t = tid / CH, c_t = 8 * (tid % CH);
  auto load_k = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long st, int c0) {
    const __nv_bfloat16* row = src + (c0 + r_t) * st + c_t;
#pragma unroll
    for (int i = 0; i < MK / RS; ++i) {
      const bool in = c0 + r_t + i * RS < p.Tk && c_t < D;
      cp_async16(dst + (r_t + i * RS) * PITCH + c_t, in ? row + i * RS * st : src, in ? 16 : 0);
    }
  };
  // Copy groups: [Q, K0, LUT], [V0], then [K, V] of each later tile, one
  // tile ahead of the tile being computed.
  const float* lut = p.lut;
  if (n_tiles > 0) {
#pragma unroll
    for (int i = 0; i < MQ / RS; ++i) {
      const int t = iq * MQ + r_t + i * RS;
      const bool in = t < p.Tq && c_t < D;
      cp_async16(Qs + (r_t + i * RS) * PITCH + c_t, in ? qg + t * p.q_st + c_t : qg, in ? 16 : 0);
    }
    load_k(ring, kg, p.k_st, kv_start);
    if constexpr (STAR) {
      if (p.num_levels <= LUT_SMEM_MAX) {
        for (int i = tid; i < p.num_levels; i += MT) cp_async4(lut_s + i, p.lut + i);
        lut = lut_s;
      }
    }
    cp_async_commit();
    load_k(ring + TILE, vg, p.v_st, kv_start);
    cp_async_commit();
  }

  uint32_t qa[Q_SMEM ? 1 : DK / 16][4];
  // this lane's ldmatrix row of the warp's Q fragments
  const __nv_bfloat16* qfrag =
      Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH + 8 * (lane >> 4);
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums (rows g, g + 8)
  int m_i[2] = {GRID_SENTINEL, GRID_SENTINEL};
  float m_f[2] = {NEG_BIG, NEG_BIG};
  // the live columns of this thread's rows g, g + 8: lo[hr] <= col <= hi[hr];
  // of the warp's 16 rows: w_lo <= col <= w_hi
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = wr0 + g + 8 * hr;
    hi[hr] = p.causal ? min(kv_lim - 1, pos) : kv_lim - 1;
    lo[hr] = p.window > 0 ? pos - p.window + 1 : 0;
  }
  const int w_hi = p.causal ? min(kv_lim - 1, wr0 + 15) : kv_lim - 1;
  const int w_lo = p.window > 0 ? wr0 - p.window + 1 : 0;

  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = kv_start + it * MK;
    if (it == 0)
      cp_async_wait<1>();  // Q, K0 and the LUT; V0 may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();  // tile it's K landed for every thread; tile it - 1 consumed
    if (it + 1 < n_tiles) {
      __nv_bfloat16* next = ring + 2 * ((it + 1) % MSTAGES) * TILE;
      load_k(next, kg, p.k_st, c0 + MK);
      load_k(next + TILE, vg, p.v_st, c0 + MK);
    }
    cp_async_commit();  // empty past the last tile: V0's wait below stays exact
    if (!Q_SMEM && it == 0) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) ldsm_x4(qa[kk], qfrag + 16 * kk);
    }
    // the tile's live columns for some row of this warp, relative to c0
    const int t_lo = w_lo - c0, t_hi = w_hi - c0;
    const bool warp_live = t_hi >= 0 && t_lo <= MK - 1;
    const __nv_bfloat16* ks = ring + 2 * (it % MSTAGES) * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    float s[NS][4];

    // this warp's rows see nothing of the tile: p = 0 and r = 1, skip it
    if (warp_live) {
      // S = Q K^T: n-tile j holds columns c0 + 8 j + 2 tg + {0, 1} of rows g
      // (elements 0, 1) and g + 8 (elements 2, 3).  K fragments one step
      // ahead of their products; at D > 128 Q's fragment of each 16-column
      // step from shared memory as the step begins.
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kfrag =
          ks + (8 * (lane >> 4) + (lane & 7)) * PITCH + 8 * ((lane >> 3) & 1);
      uint32_t kb[2][4];
      ldsm_x4(kb[0], kfrag);
#pragma unroll
      for (int step = 0; step < QK_STEPS; ++step) {
        const int kk = step / (NS / 2), j = 2 * (step % (NS / 2));
        if (step + 1 < QK_STEPS) {
          const int kk1 = (step + 1) / (NS / 2), j1 = 2 * ((step + 1) % (NS / 2));
          ldsm_x4(kb[(step + 1) & 1], kfrag + 8 * j1 * PITCH + 16 * kk1);
        }
        if (Q_SMEM && step % (NS / 2) == 0) ldsm_x4(qa[0], qfrag + 16 * kk);
        const uint32_t(&qf)[4] = qa[Q_SMEM ? 0 : kk];
        mma_bf16(s[j], qf, kb[step & 1][0], kb[step & 1][1]);
        mma_bf16(s[j + 1], qf, kb[step & 1][2], kb[step & 1][3]);
      }
    }
    if (it == 0) {
      cp_async_wait<1>();  // V0 (the next tile may be in flight)
      __syncthreads();
    }
    if (!warp_live) continue;

    // the softmax of the tile, with the mask only where the tile is not
    // wholly live for this warp's rows
    float r[2];
    const bool full = c0 + MK <= kv_lim && (!p.causal || c0 + MK - 1 <= wr0) &&
                      (p.window <= 0 || c0 > wr0 + 15 - p.window);
    if (full)
      block_softmax<NS, STAR, true>(s, lo, hi, c0 + 2 * tg, p, lut, m_i, m_f, l, r);
    else
      block_softmax<NS, STAR, false>(s, lo, hi, c0 + 2 * tg, p, lut, m_i, m_f, l, r);
    rescale(o, r);

    // O += P V over 16-column steps; the A fragment of step kk is the score
    // n-tiles 2 kk and 2 kk + 1, split into three bf16 pieces.  VG 16-wide
    // column groups of V at a time, so that 2 VG independent accumulators
    // separate two products into the same one.
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pc[3][4];  // hi, mid, lo
      split3(s[2 * kk][0], s[2 * kk][1], pc[0][0], pc[1][0], pc[2][0]);
      split3(s[2 * kk][2], s[2 * kk][3], pc[0][1], pc[1][1], pc[2][1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pc[0][2], pc[1][2], pc[2][2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pc[0][3], pc[1][3], pc[2][3]);
      if constexpr (D < 16) {  // one n8 tile: V's columns 0 .. 7 of the 16 keys
        uint32_t vb[2];
        ldsm_x2_trans(vb, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH);
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) mma_bf16(o[0], pc[piece], vb[0], vb[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < D / 16; dp += VG) {
          uint32_t vb[VG][4];
#pragma unroll
          for (int u = 0; u < VG; ++u)
            ldsm_x4_trans(vb[u], vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH +
                                     16 * (dp + u) + 8 * (lane >> 4));
#pragma unroll
          for (int piece = 0; piece < 3; ++piece)
#pragma unroll
            for (int u = 0; u < VG; ++u) {
              mma_bf16(o[2 * (dp + u)], pc[piece], vb[u][0], vb[u][1]);
              mma_bf16(o[2 * (dp + u) + 1], pc[piece], vb[u][2], vb[u][3]);
            }
        }
      }
    }
  }
  store_rows<__nv_bfloat16, MQ, MQ / 16, D>(p, tl, o, l);
}

// ---------------------------------------------------------------------------
// The float32 kernel and the int8 P.V variant on the tensor cores,
// flash_star_tf32_kernel and flash_star_pv_int8_kernel (body tc_attention).
//
// What bounds them.  Float32: at the 512-token causal prefill the live
// products are 2.15 GFLOP; as 3xTF32 (hi.hi + hi.lo + lo.hi of the tf32
// pieces of each float32 operand, on mma.sync.m16n8k8 tf32 with float32
// accumulators) they are 6.4 GFLOP at 495 TFLOP/s, 0.013 ms, against 0.032
// ms on FP32 FMAs and 0.006 ms for the bytes.  int8 P.V: QK^T as in the
// float kernels (bf16 mma, or 3xTF32), P.V on mma.sync.m16n8k32 s8 at 1979
// TOP/s: a few microseconds; the bytes bound it.  Latency is what is left,
// as in the bf16 kernel.
//
// Shape (TcSmem): one CTA of 4 warps owns (batch, q head, MQ q rows), the
// longest causal rows first; the softmax and its arithmetic are
// block_softmax's (the int8 variant takes its three steps apart, below);
// whole tiles outside the causal / window / ragged range are skipped by the
// CTA and by a warp whose rows see none of them.  At D <= 128, MQ = 64: a
// warp owns 16 rows and all D output columns.  At D 256 a warp's 16 rows of
// O would be 32 n-tiles, 128 float32 registers a thread (and the int8
// variant's int32 sums as many again), and 64 rows' Q planes do not fit
// beside the ring: so MQ = 32, two row groups of 16, and each row group's D
// output columns split between two warps, which both form the group's
// scores (the QK^T done twice; the softmax state is the same bits in both).
// K (and, in the float32 kernel, V) come in sub-tiles of SUB rows through a
// two-stage cp.async ring, sub-tile i + 1 loading while sub-tile i computes:
// SUB = 32, and 16 for the float32 kernel at D 256 (its shared memory).
//
// Float32 (tf32 kernel).  A block is one sub-tile.  Q is split once into
// tf32 hi and lo planes in shared memory, each K sub-tile once per CTA (not
// per warp) into hi (in place, over the ring stage) and lo planes
// (split_rows), each V sub-tile into hi and lo planes of V^T (split_vt), so
// every warp reads ready operands with ldmatrix (32-bit elements: a row of 4
// floats is a row of 8 bf16).  V^T holds features as rows, and within each
// 8 keys the order 0 2 4 6 1 3 5 7: the A fragment of P.V is then the score
// tile's accumulator registers as they are (columns 2 tg and 2 tg + 1 of a
// lane are slots tg and tg + 4), and the B fragments come from ldmatrix too.
// P is split in registers.  Each product is three mma's into one float32
// accumulator, issued for four (P.V: four to eight) accumulators in turn.
// Rows are padded by 16 bytes (Q, K: D + 4 floats; V^T: SUB + 4), so each
// ldmatrix falls on distinct banks.  Shared memory: 188,928 bytes at D 128,
// 190,720 at D 256 (and the LUT): one CTA an SM.
//
// int8 P.V (pv_int8 kernel).  As the TPU kernel, per KV block of bk =
// min(block_k, Tk) rows from row 0, any bk: P as p8 = rint(fl(p * 127))
// against the running max after the whole block, V as rint(fl(v * fl(127 /
// vamax))) with vamax the block's absmax over every row inside Tk, and acc
// = fl(fl(acc * r) + fl(float(int32 P8.V8) * fl(vamax / 16129))), the
// denominator over the unquantized p.  V's codes depend only on the block,
// so flash_star_quantize_v_kernel writes them once per (batch, KV head,
// block) to a workspace, each feature's codes k-contiguous in 32-key
// groups, in the order that lets the attention kernel pack its own p8 into
// the s8 A fragment with no shuffle: logical k = 16 h + 4 t + i of a group is
// key 16 h + 8 (i / 2) + 2 t + i % 2, the keys that lane t's score fragments
// hold (ref.v8_perm).  Since p8 needs the block's max and a block may be
// longer than registers can hold scores for, the kernel walks each block's K
// twice, in sub-tiles of one 32-key group: pass 0 forms the scores and
// keeps only their row max (the int32 grid max, or the float max; the same
// bits that one pass over the whole block gives, since a max is exact in any
// order), then the running max moves once; pass 1 forms the scores again
// (the same products in the same order: the same bits), takes p against the
// new max, packs p8, and meets the sub-tile's codes (ldmatrix from a
// double-buffered copy, loaded with the sub-tile's K) in s8 mma's into int32
// sums that run over the whole block.  int32 sums are exact in any order, so
// the codes' products are the plain version's bit for bit; they fold into
// the float accumulator once a block.
//
// On an H100 80GB HBM3 at 700 W, at the shape above: float32 ~0.108 ms, 12 %
// of its tf32 bound (one CTA of 4 warps an SM, a split pass and two barriers
// per 32-row tile); pv_int8 with bf16 q/k ~0.038 ms before its QK^T was
// done twice (PERF.md).
//
// The block route (flash_star_blocked_kernel, STAR, float32 or bf16; body
// tc_attention with BLK).  The TPU kernel walks KV blocks of block_k rows
// from row 0, takes each block's P against the running max after the whole
// block and rescales the running state by lut[min(shift, top)]; the one-pass
// kernels do the same over their own tiles (32 or 64 rows).  The two agree
// only while lut[a] * lut[b] == lut[a + b], which fails once a + b passes
// the deepest level top = L - 1, where the table clamps: a key's weight
// then depends on the schedule, by at most lut[top] each, so by at most
// Tk * lut[top] of the output (the denominator is at least 1).  At 6 bits
// (5i.1f) and up that is under 2^-24, float32 rounding, and the one-pass
// kernels stand; at 2 to 5 bits (lut[top] = e^-1.5 .. e^-15.5) it is not,
// and the wrapper routes STAR calls to this kernel, chosen on the host from
// the format and Tk alone (kernel.py, lut.clamp_is_negligible).  It walks
// each block of bk rows twice as the int8 P.V variant does, in 32-row
// sub-tiles: pass 0 forms the scores and keeps their row max, the running
// max moves once and the running state is rescaled once, pass 1 forms the
// same scores again, takes p against the new max and runs P.V into O as the
// one-pass kernel of its type does (pv_tf32: V^T split into tf32 planes,
// loaded in pass 1 only; pv_bf16: flash_star_mma_kernel's three-piece P and
// V through ldmatrix.trans), and l = fl(fl(l r) + the block's sum of p).
// It costs the QK^T twice (PERF.md).

constexpr int V8_GROUP = 32;               // keys of one s8 k-step
constexpr int V8_PITCH = V8_GROUP + 16;    // bytes per feature row of a sub-tile's codes

// the codes' workspace: per (batch, KV head, block) D rows of kpad bytes
struct V8Args {
  const int8_t* codes;  // [B, Hkv, nblk, D, kpad]
  const float* scales;  // [B, Hkv, nblk]: vamax / 16129
  int bk, kpad, nblk;
};

__host__ __device__ constexpr int pad32(int bk) { return (bk + 31) / 32 * 32; }

template <typename T, int D, bool PV8>
struct TcSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool WIDE = D > 128;
  static constexpr int MQ = WIDE ? 32 : 64;      // q rows a CTA
  static constexpr int RG = MQ / 16;             // row groups of 16, one warp each ...
  static constexpr int CG = (MT / 32) / RG;      // ... times CG warps along the columns
  static constexpr int DW = D / CG;              // output columns a warp
  static constexpr int SUB = PV8 ? V8_GROUP : WIDE && F32 ? 16 : 32;  // KV rows a ring stage
  static constexpr int DK = F32 ? D : kdim(D);  // row width in shared memory (bf16 D 8: 16)
  static constexpr int QP = F32 ? D + 4 : DK + 8;  // elements per row of Q and the ring
  static constexpr int VTP = SUB + 4;             // floats per row of the split V^T
  static constexpr size_t q = sizeof(T) * (F32 ? 2 : 1) * MQ * QP;        // Q (hi, lo)
  static constexpr size_t stage = sizeof(T) * (PV8 ? 1 : 2) * SUB * QP;   // K (and V)
  static constexpr size_t klo = F32 ? sizeof(float) * SUB * QP : 0;       // K's lo plane
  static constexpr size_t vsplit = F32 && !PV8 ? sizeof(float) * 2 * D * VTP : 0;
  static constexpr size_t v8 = PV8 ? 2 * D * V8_PITCH : 0;
  static constexpr size_t bytes = q + 2 * stage + klo + vsplit + v8;
  static_assert(bytes + sizeof(float) * LUT_SMEM_MAX <= 232448,
                "a CTA's shared memory (with the largest LUT held there) exceeds 227 KB");
};

// ROWS x D floats at src (row pitch QP) as tf32 hi and lo planes of the same
// pitch; src may be hi (each thread splits in place what it reads)
template <int ROWS, int D, int QP>
__device__ __forceinline__ void split_rows(const float* src, float* hi, float* lo) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * C4; idx += MT) {
    const int r = idx / C4, c = 4 * (idx - r * C4);
    const float4 x = *reinterpret_cast<const float4*>(src + r * QP + c);
    float4 h, e;
    h.x = tf32_rna(x.x); e.x = tf32_rna(__fsub_rn(x.x, h.x));
    h.y = tf32_rna(x.y); e.y = tf32_rna(__fsub_rn(x.y, h.y));
    h.z = tf32_rna(x.z); e.z = tf32_rna(__fsub_rn(x.z, h.z));
    h.w = tf32_rna(x.w); e.w = tf32_rna(__fsub_rn(x.w, h.w));
    *reinterpret_cast<float4*>(hi + r * QP + c) = h;
    *reinterpret_cast<float4*>(lo + r * QP + c) = e;
  }
}

// SUB x D floats of V at src (row pitch QP) as tf32 hi and lo planes of V^T
// (D rows of VTP), key 8 a + k at slot 8 a + 4 (k % 2) + k / 2.  A warp reads
// 8 keys x 4 features at a time.
template <int SUB, int D, int QP, int VTP>
__device__ __forceinline__ void split_vt(const float* src, float* hi, float* lo) {
  for (int idx = threadIdx.x; idx < SUB * D; idx += MT) {
    const int w = idx >> 5, ln = idx & 31;
    const int key = 8 * (w % (SUB / 8)) + (ln & 7), f = 4 * (w / (SUB / 8)) + (ln >> 3);
    const int slot = (key & ~7) + 4 * (key & 1) + ((key & 7) >> 1);
    const float x = src[key * QP + f];
    const float h = tf32_rna(x);
    hi[f * VTP + slot] = h;
    lo[f * VTP + slot] = tf32_rna(__fsub_rn(x, h));
  }
}

// p in [0, 1] as its int8 code rint(fl(p * 127)), four to a register, byte i
// from the i-th argument
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c, float d) {
  auto q = [](float x) { return static_cast<uint32_t>(static_cast<int>(rintf(__fmul_rn(x, 127.f)))); };
  return q(a) | q(b) << 8 | q(c) << 16 | q(d) << 24;
}

// O += P V of one sub-tile in the float32 kernel: k-step j is score n-tile
// j, its registers the A fragment as they are (V^T's key order), split into
// tf32 hi and lo; vt is this lane's B row of the V^T hi plane (lo D VTP on)
template <int D, int DW, int NS, int VTP>
__device__ __forceinline__ void pv_tf32(float (&o)[DW / 8][4], const float (&s)[NS][4],
                                        const float* vt) {
  constexpr int VG = DW >= 32 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t ph[4], pl[4];
    split_tf32(s[j][0], ph[0], pl[0]);
    split_tf32(s[j][2], ph[1], pl[1]);
    split_tf32(s[j][1], ph[2], pl[2]);
    split_tf32(s[j][3], ph[3], pl[3]);
    if constexpr (D < 16) {  // one n8 tile: V^T's 8 feature rows
      uint32_t vh[2], vl[2];
      ldsm_x2(vh, vt + 8 * j);
      ldsm_x2(vl, vt + D * VTP + 8 * j);
      mma_tf32(o[0], pl, vh[0], vh[1]);
      mma_tf32(o[0], ph, vl[0], vl[1]);
      mma_tf32(o[0], ph, vh[0], vh[1]);
    }
#pragma unroll
    for (int dp = 0; dp < DW / 16; dp += VG) {
      uint32_t vh[VG][4], vl[VG][4];
#pragma unroll
      for (int uu = 0; uu < VG; ++uu) {
        ldsm_x4(vh[uu], vt + 16 * (dp + uu) * VTP + 8 * j);
        ldsm_x4(vl[uu], vt + D * VTP + 16 * (dp + uu) * VTP + 8 * j);
      }
#pragma unroll
      for (int uu = 0; uu < VG; ++uu) {
        mma_tf32(o[2 * (dp + uu)], pl, vh[uu][0], vh[uu][1]);
        mma_tf32(o[2 * (dp + uu) + 1], pl, vh[uu][2], vh[uu][3]);
      }
#pragma unroll
      for (int uu = 0; uu < VG; ++uu) {
        mma_tf32(o[2 * (dp + uu)], ph, vl[uu][0], vl[uu][1]);
        mma_tf32(o[2 * (dp + uu) + 1], ph, vl[uu][2], vl[uu][3]);
      }
#pragma unroll
      for (int uu = 0; uu < VG; ++uu) {
        mma_tf32(o[2 * (dp + uu)], ph, vh[uu][0], vh[uu][1]);
        mma_tf32(o[2 * (dp + uu) + 1], ph, vh[uu][2], vh[uu][3]);
      }
    }
  }
}

// O += P V of one sub-tile in the bf16 block route, as flash_star_mma_kernel
// forms it: 16-key steps, the A fragment of step kk the score n-tiles 2 kk
// and 2 kk + 1 in three bf16 pieces, V's bf16 rows (pitch QP) through
// ldmatrix.trans; vs points at the warp's first output column
template <int D, int DW, int NS, int QP>
__device__ __forceinline__ void pv_bf16(float (&o)[DW / 8][4], const float (&s)[NS][4],
                                        const __nv_bfloat16* vs, int lane) {
  constexpr int VG = DW >= 32 ? 2 : 1;
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    uint32_t pc[3][4];  // hi, mid, lo
    split3(s[2 * kk][0], s[2 * kk][1], pc[0][0], pc[1][0], pc[2][0]);
    split3(s[2 * kk][2], s[2 * kk][3], pc[0][1], pc[1][1], pc[2][1]);
    split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pc[0][2], pc[1][2], pc[2][2]);
    split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pc[0][3], pc[1][3], pc[2][3]);
    const __nv_bfloat16* vrow = vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * QP;
    if constexpr (D < 16) {  // one n8 tile: V's columns 0 .. 7 of the 16 keys
      uint32_t vb[2];
      ldsm_x2_trans(vb, vrow);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) mma_bf16(o[0], pc[piece], vb[0], vb[1]);
    } else {
#pragma unroll
      for (int dp = 0; dp < DW / 16; dp += VG) {
        uint32_t vb[VG][4];
#pragma unroll
        for (int u = 0; u < VG; ++u) ldsm_x4_trans(vb[u], vrow + 16 * (dp + u) + 8 * (lane >> 4));
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)
#pragma unroll
          for (int u = 0; u < VG; ++u) {
            mma_bf16(o[2 * (dp + u)], pc[piece], vb[u][0], vb[u][1]);
            mma_bf16(o[2 * (dp + u) + 1], pc[piece], vb[u][2], vb[u][3]);
          }
      }
    }
  }
}

// BLK: the block route (STAR only, either type), see "The block route" above.
template <typename T, int D, bool STAR, bool PV8, bool BLK = false>
__device__ __forceinline__ void tc_attention(const Params& p, int first_round, const V8Args& w) {
  using S = TcSmem<T, D, PV8>;
  constexpr bool F32 = S::F32;
  constexpr int MQ_ = S::MQ, QP = S::QP, VTP = S::VTP, DK = S::DK, SUB = S::SUB, DW = S::DW;
  constexpr int NS = SUB / 8;                   // score n-tiles of a sub-tile
  constexpr int NO = DW / 8;                    // output n-tiles per warp
  constexpr int CH = DK * (int)sizeof(T) / 16;  // 16-byte chunks per row (past D: zero)
  constexpr bool TWO = PV8 || BLK;             // each block walked twice: its max, then P
  constexpr int PASSES = TWO ? 2 : 1;
  static_assert(D % 8 == 0 && (F32 || DK % 16 == 0), "head_dim 8 or a multiple of 16");
  static_assert(DW % 16 == 0 || D < 16, "a warp's columns are whole 16-column groups");
  static_assert(!BLK || (STAR && !PV8), "the block route is the STAR float P.V's");
  static_assert(F32 || TWO, "bf16 one-pass attention is flash_star_mma_kernel's");
  constexpr int STAGE = (int)(S::stage / sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);                 // [MQ][QP] (F32: then lo)
  T* ring = reinterpret_cast<T*>(smem_raw + S::q);        // stage s: K, then V (!PV8)
  float* Klo = reinterpret_cast<float*>(smem_raw + S::q + 2 * S::stage);  // K's lo plane
  float* Vtp = Klo + (S::klo / sizeof(float));            // V^T hi, lo
  int8_t* V8s = reinterpret_cast<int8_t*>(Vtp + S::vsplit / sizeof(float));  // 2 sub-tiles
  float* lut_s = reinterpret_cast<float*>(smem_raw + S::bytes);

  const Tile tl = tile_of_block(p, first_round, MQ_);
  const int iq = tl.iq, b = tl.b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rg = warp % S::RG, cg = warp / S::RG;  // the warp's rows 16 rg .. and columns cg DW ..
  const int q_offset = p.info[0];
  const int kv_lim = min(p.info[1 + b], p.Tk);
  const int row0 = iq * MQ_ + q_offset;
  const int wr0 = row0 + 16 * rg;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + tl.h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + tl.hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + tl.hk * p.v_sh;

  // blocks of blk_rows KV rows from `start`, each walked PASSES times in
  // nsub ring sub-tiles
  const int blk_rows = TWO ? w.bk : SUB;
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, row0 + MQ_);
  const int start = p.window > 0 ? max(0, row0 - p.window + 1) / blk_rows * blk_rows : 0;
  const int n_blocks = kv_end > start ? (kv_end - start + blk_rows - 1) / blk_rows : 0;
  const int nsub = TWO ? (w.bk + SUB - 1) / SUB : 1;
  const int per_blk = PASSES * nsub;
  const int n_it = n_blocks * per_blk;

  // ROWS rows of src (row stride st) from row r0 into dst (pitch QP), 16
  // bytes a copy; rows at or past lim, and columns past D, zero-filled
  auto load_rows = [&](T* dst, const T* src, long long st, int r0, int lim, auto rows) {
    constexpr int ROWS = decltype(rows)::value;
#pragma unroll
    for (int i = 0; i < (ROWS * CH + MT - 1) / MT; ++i) {
      const int idx = tid + i * MT;
      if ((ROWS * CH) % MT == 0 || idx < ROWS * CH) {
        const int r = idx / CH, c = (16 / (int)sizeof(T)) * (idx - r * CH);
        const bool in = r0 + r < lim && c < D;
        cp_async16(dst + r * QP + c, in ? src + (r0 + r) * st + c : src, in ? 16 : 0);
      }
    }
  };
  // one copy group per sub-tile: its K, and in pass 1 its V (in the one-pass
  // kernel at once), or the int8 variant's codes (D rows of 32 bytes)
  auto issue = [&](int it) {
    if (it < n_it) {
      const int blk = it / per_blk, rem = it - blk * per_blk;
      const int u = rem % nsub;
      const int r0 = start + blk * blk_rows + SUB * u;
      T* st = ring + (it & 1) * STAGE;
      load_rows(st, kg, p.k_st, r0, p.Tk, Int<SUB>{});
      if constexpr (!PV8) {
        if (!BLK || rem >= nsub) load_rows(st + SUB * QP, vg, p.v_st, r0, p.Tk, Int<SUB>{});
      }
      if constexpr (PV8) {
        if (rem >= nsub) {
          const int8_t* src = w.codes + (((long long)b * p.Hkv + tl.hk) * w.nblk + start / w.bk +
                                         blk) * D * w.kpad + SUB * u;
          int8_t* dst = V8s + (it & 1) * D * V8_PITCH;
          for (int idx = tid; idx < 2 * D; idx += MT) {
            const int f = idx >> 1, c = 16 * (idx & 1);
            cp_async16(dst + f * V8_PITCH + c, src + (long long)f * w.kpad + c, 16);
          }
        }
      }
    }
    cp_async_commit();
  };

  const float* lut = p.lut;
  if (n_it > 0) {  // the first group: Q, the LUT and sub-tile 0
    load_rows(Qs, qg, p.q_st, iq * MQ_, p.Tq, Int<MQ_>{});
    if constexpr (STAR) {
      if (p.num_levels <= LUT_SMEM_MAX) {
        for (int i = tid; i < p.num_levels; i += MT) cp_async4(lut_s + i, p.lut + i);
        lut = lut_s;
      }
    }
    issue(0);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l[2] = {0.f, 0.f};
  int m_i[2] = {GRID_SENTINEL, GRID_SENTINEL};
  float m_f[2] = {NEG_BIG, NEG_BIG};
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = wr0 + g + 8 * hr;
    hi[hr] = p.causal ? min(kv_lim - 1, pos) : kv_lim - 1;
    lo[hr] = p.window > 0 ? pos - p.window + 1 : 0;
  }
  const int w_hi = p.causal ? min(kv_lim - 1, wr0 + 15) : kv_lim - 1;
  const int w_lo = p.window > 0 ? wr0 - p.window + 1 : 0;

  // fragment addresses: A rows of Q; B rows of K (n-tiles j, j + 1), of V^T
  // (n-tiles of this warp's features), of the codes
  const int a_row = 16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_half = (lane >> 3) & 1;

  int it = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int c0 = start + blk * blk_rows, c_last = c0 + blk_rows - 1;
    const bool warp_live = w_hi >= c0 && w_lo <= c_last;
    const int hb[2] = {min(hi[0], c_last), min(hi[1], c_last)};  // columns past the block's end
    // the int8 variant: the block's row max (pass 0), the rescale, the row
    // sums of p and the int32 sums of P8.V8 (pass 1)
    int mbi[2] = {GRID_SENTINEL, GRID_SENTINEL};
    float mbf[2] = {NEG_BIG, NEG_BIG};
    float r[2] = {1.f, 1.f}, ps[2] = {0.f, 0.f};
    int acc8[PV8 ? NO : 1][4];
#pragma unroll
    for (int n = 0; n < (PV8 ? NO : 1); ++n) acc8[n][0] = acc8[n][1] = acc8[n][2] = acc8[n][3] = 0;

    for (int pass = 0; pass < PASSES; ++pass) {
      if (TWO && pass == 1 && warp_live) {
        running_max<STAR>(mbi, mbf, p, lut, m_i, m_f, r);
        if constexpr (BLK) rescale(o, r);
      }
      for (int u = 0; u < nsub; ++u, ++it) {
        cp_async_wait<0>();
        __syncthreads();  // sub-tile it landed for every thread; it - 1 consumed
        issue(it + 1);
        T* ks = ring + (it & 1) * STAGE;
        if constexpr (F32) {
          if (it == 0) split_rows<MQ_, D, QP>(Qs, Qs, Qs + MQ_ * QP);
          split_rows<SUB, D, QP>(ks, ks, Klo);
          if constexpr (!PV8) {
            if (!BLK || pass == 1) split_vt<SUB, D, QP, VTP>(ks + SUB * QP, Vtp, Vtp + D * VTP);
          }
          __syncthreads();  // the tf32 planes are complete
        }
        // the sub-tile's columns cu .. cu_last; none live for this warp: p = 0
        const int cu = c0 + SUB * u, cu_last = min(cu + SUB - 1, c_last);
        if (!warp_live || w_hi < cu || w_lo > cu_last) continue;
        // S = Q K^T of the sub-tile: n-tile j holds columns cu + 8 j + 2 tg + {0, 1}
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if constexpr (F32) {
          const float* qh = Qs + a_row * QP + 4 * (lane >> 4);
          const float* kh = ks + b_row * QP + 4 * b_half;
          const float* kl = Klo + b_row * QP + 4 * b_half;
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) {
            uint32_t ah[4], al[4], bh[NS / 2][4], bl[NS / 2][4];
            ldsm_x4(ah, qh + 8 * kk);
            ldsm_x4(al, qh + MQ_ * QP + 8 * kk);
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
              ldsm_x4(bh[jp], kh + 16 * jp * QP + 8 * kk);
              ldsm_x4(bl[jp], kl + 16 * jp * QP + 8 * kk);
            }
#pragma unroll
            for (int j = 0; j < NS; ++j)
              mma_tf32(s[j], al, bh[j >> 1][2 * (j & 1)], bh[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
            for (int j = 0; j < NS; ++j)
              mma_tf32(s[j], ah, bl[j >> 1][2 * (j & 1)], bl[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
            for (int j = 0; j < NS; ++j)
              mma_tf32(s[j], ah, bh[j >> 1][2 * (j & 1)], bh[j >> 1][2 * (j & 1) + 1]);
          }
        } else {
          const T* qf = Qs + a_row * QP + 8 * (lane >> 4);
          const T* kf = ks + b_row * QP + 8 * b_half;
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            uint32_t qa[4];
            ldsm_x4(qa, qf + 16 * kk);
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
              uint32_t kb[4];
              ldsm_x4(kb, kf + 16 * jp * QP + 16 * kk);
              mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
              mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
            }
          }
        }
        // the mask only where the sub-tile is not wholly live for this warp's rows
        const bool full = cu + SUB - 1 <= c_last && cu + SUB <= kv_lim &&
                          (!p.causal || cu + SUB - 1 <= wr0) &&
                          (p.window <= 0 || cu > wr0 + 15 - p.window);
        const int cb = cu + 2 * tg;

        // P.V reads the split V^T planes (float32) or V's bf16 rows
        const float* vt = Vtp + (cg * DW + b_row) * VTP + 4 * b_half;
        const T* vrows = ks + SUB * QP + cg * DW;
        if constexpr (!TWO) {
          if (full)
            block_softmax<NS, STAR, true>(s, lo, hb, cb, p, lut, m_i, m_f, l, r);
          else
            block_softmax<NS, STAR, false>(s, lo, hb, cb, p, lut, m_i, m_f, l, r);
          rescale(o, r);
          if constexpr (F32)
            pv_tf32<D, DW, NS, VTP>(o, s, vt);
          else
            pv_bf16<D, DW, NS, QP>(o, s, vrows, lane);
        } else if (pass == 0) {  // the block's max only
          if (full)
            tile_scores<NS, STAR, true>(s, Live<true>(lo, hb, cb), p, mbi, mbf);
          else
            tile_scores<NS, STAR, false>(s, Live<false>(lo, hb, cb), p, mbi, mbf);
        } else if constexpr (BLK) {  // p against the block's max, and P.V of the sub-tile
          int xi[2] = {GRID_SENTINEL, GRID_SENTINEL};
          float xf[2] = {NEG_BIG, NEG_BIG};
          if (full) {
            const Live<true> is_live(lo, hb, cb);
            tile_scores<NS, STAR, true>(s, is_live, p, xi, xf);
            tile_probs<NS, STAR, true>(s, is_live, p, lut, m_i, m_f, ps);
          } else {
            const Live<false> is_live(lo, hb, cb);
            tile_scores<NS, STAR, false>(s, is_live, p, xi, xf);
            tile_probs<NS, STAR, false>(s, is_live, p, lut, m_i, m_f, ps);
          }
          if constexpr (F32)
            pv_tf32<D, DW, NS, VTP>(o, s, vt);
          else
            pv_bf16<D, DW, NS, QP>(o, s, vrows, lane);
        } else {  // p against the block's max, p8, and P8.V8 of the sub-tile
          int xi[2] = {GRID_SENTINEL, GRID_SENTINEL};
          float xf[2] = {NEG_BIG, NEG_BIG};
          if (full) {
            const Live<true> is_live(lo, hb, cb);
            tile_scores<NS, STAR, true>(s, is_live, p, xi, xf);
            tile_probs<NS, STAR, true>(s, is_live, p, lut, m_i, m_f, ps);
          } else {
            const Live<false> is_live(lo, hb, cb);
            tile_scores<NS, STAR, false>(s, is_live, p, xi, xf);
            tile_probs<NS, STAR, false>(s, is_live, p, lut, m_i, m_f, ps);
          }
          // lane t's p8 of the 4 n-tiles, packed as logical k = 16 h + 4 t +
          // i <- key 16 h + 8 (i / 2) + 2 t + i % 2
          uint32_t pa[4];
          pa[0] = pack_p8(s[0][0], s[0][1], s[1][0], s[1][1]);
          pa[1] = pack_p8(s[0][2], s[0][3], s[1][2], s[1][3]);
          pa[2] = pack_p8(s[2][0], s[2][1], s[3][0], s[3][1]);
          pa[3] = pack_p8(s[2][2], s[2][3], s[3][2], s[3][3]);
          const int8_t* vf =
              V8s + (it & 1) * D * V8_PITCH + (cg * DW + b_row) * V8_PITCH + 16 * b_half;
          if constexpr (D < 16) {  // the fold cut to 8 features: one n8 tile of codes
            uint32_t vb[2];
            ldsm_x2(vb, vf);
            mma_s8(acc8[0], pa, vb[0], vb[1]);
          } else {
#pragma unroll
            for (int np = 0; np < DW / 16; ++np) {
              uint32_t vb[4];
              ldsm_x4(vb, vf + 16 * np * V8_PITCH);
              mma_s8(acc8[2 * np], pa, vb[0], vb[1]);
              mma_s8(acc8[2 * np + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
    }
    if constexpr (TWO) {
      if (warp_live) {  // the block into the running state, as the TPU kernel folds it
        if constexpr (PV8) {
          const float vs =
              __ldg(w.scales + ((long long)b * p.Hkv + tl.hk) * w.nblk + start / w.bk + blk);
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[n][e] = __fadd_rn(__fmul_rn(o[n][e], r[e >> 1]),
                                  __fmul_rn(static_cast<float>(acc8[n][e]), vs));
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) l[hr] = __fadd_rn(__fmul_rn(l[hr], r[hr]), ps[hr]);
      }
    }
  }
  store_rows<T, MQ_, S::RG, DW>(p, tl, o, l);
}

template <int D, bool STAR>
__global__ void __launch_bounds__(MT, 1) flash_star_tf32_kernel(Params p, int first_round) {
  tc_attention<float, D, STAR, false>(p, first_round, V8Args{});
}

template <typename T, int D, bool STAR>
__global__ void __launch_bounds__(MT, 1) flash_star_pv_int8_kernel(Params p, int first_round,
                                                                   V8Args w) {
  tc_attention<T, D, STAR, true>(p, first_round, w);
}

// the block route: w carries the block's rows (bk) only
template <typename T, int D>
__global__ void __launch_bounds__(MT, 1) flash_star_blocked_kernel(Params p, int first_round,
                                                                   V8Args w) {
  tc_attention<T, D, true, false, true>(p, first_round, w);
}

// V's codes and scales for the int8 P.V variant, once per (block, KV head,
// batch), for any block size bk: vamax = max(absmax of the block's rows
// inside Tk, 1e-6), codes rint(fl(v * fl(127 / vamax))) (true divisions, as
// the TPU kernel's jnp.round(vf * (127.0 / vamax))), in the attention
// kernel's k order, zero past the block's rows; scale fl(vamax / 16129).
// The block is read twice, in 16-byte pieces: once for its absmax (QV_BATCH
// pieces in flight per thread), then one 32-key group at a time into shared
// memory as float32 (pitch D + 1), from where each feature's codes are
// gathered: a grid of a few dozen CTAs waits on memory latency, not bytes.
constexpr int QV_THREADS = 1024;
constexpr int QV_BATCH = 4;
constexpr int QV_MAX_D = 256;

template <typename T>
__global__ void __launch_bounds__(QV_THREADS) flash_star_quantize_v_kernel(
    const T* v, long long v_sb, long long v_sh, long long v_st, int Hkv, int Tk, int D,
    int bk, int kpad, int nblk, int8_t* codes, float* scales) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte piece
  __shared__ float vsm[V8_GROUP * (QV_MAX_D + 1)];  // one 32-key group, [32][D + 1]
  __shared__ float red[QV_THREADS / 32];
  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(bk, Tk - blk * bk);
  const T* vb = v + b * v_sb + h * v_sh + static_cast<long long>(blk) * bk * v_st;
  const int cpr = D / EPC;
  float amax = 0.f;
  for (int base = tid; base < rows * cpr; base += QV_BATCH * QV_THREADS) {
    uint4 piece[QV_BATCH];
#pragma unroll
    for (int u = 0; u < QV_BATCH; ++u) {
      const int idx = base + u * QV_THREADS, r = idx / cpr, c = EPC * (idx - r * cpr);
      if (idx < rows * cpr) piece[u] = *reinterpret_cast<const uint4*>(vb + r * v_st + c);
    }
#pragma unroll
    for (int u = 0; u < QV_BATCH; ++u) {
      if (base + u * QV_THREADS >= rows * cpr) break;
      const T* e = reinterpret_cast<const T*>(&piece[u]);
#pragma unroll
      for (int i = 0; i < EPC; ++i) amax = fmaxf(amax, fabsf(to_f32(e[i])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();  // red
  float vamax = red[0];
#pragma unroll
  for (int i = 1; i < QV_THREADS / 32; ++i) vamax = fmaxf(vamax, red[i]);
  vamax = fmaxf(vamax, 1e-6f);
  const float vq = __fdiv_rn(127.f, vamax);
  const long long slot = (static_cast<long long>(b) * Hkv + h) * nblk + blk;
  if (tid == 0) scales[slot] = __fdiv_rn(vamax, 16129.f);
  uint32_t* out = reinterpret_cast<uint32_t*>(codes + slot * D * kpad);
  constexpr int WPG = V8_GROUP / 4;  // 32-bit words of a feature's group
  for (int k0 = 0; k0 < kpad; k0 += V8_GROUP) {
    const int grows = min(V8_GROUP, rows - k0);  // the group's rows inside the block
    __syncthreads();  // the previous group's codes are out of vsm
    for (int idx = tid; idx < grows * cpr; idx += QV_THREADS) {
      const int r = idx / cpr, c = EPC * (idx - r * cpr);
      const uint4 piece = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_st + c);
      const T* e = reinterpret_cast<const T*>(&piece);
#pragma unroll
      for (int i = 0; i < EPC; ++i) vsm[r * (D + 1) + c + i] = to_f32(e[i]);
    }
    __syncthreads();  // the group in vsm
    for (int idx = tid; idx < D * WPG; idx += QV_THREADS) {
      const int f = idx / WPG, wd = idx - f * WPG;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * wd + i;  // logical k in the 32-key group
        const int key = 16 * (k >> 4) + 8 * (i >> 1) + 2 * ((k >> 2) & 3) + (i & 1);
        const int code = key < grows
            ? static_cast<int>(rintf(__fmul_rn(vsm[key * (D + 1) + f], vq))) : 0;
        word |= (static_cast<uint32_t>(code) & 0xffu) << (8 * i);
      }
      out[(f * kpad + k0) / 4 + wd] = word;
    }
  }
}

template <typename T>
cudaError_t launch_quantize_v(const T* v, long long v_sb, long long v_sh, long long v_st,
                              int B, int Hkv, int Tk, int D, int bk, int8_t* codes,
                              float* scales, cudaStream_t s) {
  const int nblk = (Tk + bk - 1) / bk;
  flash_star_quantize_v_kernel<T><<<dim3(nblk, Hkv, B), QV_THREADS, 0, s>>>(
      v, v_sb, v_sh, v_st, Hkv, Tk, D, bk, pad32(bk), nblk, codes, scales);
  return cudaSuccess;
}

// Launch kernel (MT threads a CTA, smem bytes of shared memory, a STAR LUT
// of up to LUT_SMEM_MAX levels on top) over (q blocks of mq rows x heads x
// batch), with first_round as tile_of_block reads it.  cache: the kernel's
// own.
struct LaunchCache {
  static constexpr int MAX_DEVICES = 64;
  int sms[MAX_DEVICES] = {}, per_sm[MAX_DEVICES] = {};
};

template <class Kernel, class... Extra>
cudaError_t launch_rows_first(Kernel kernel, int mq, size_t smem, bool star, LaunchCache& cache,
                              const Params& p, cudaStream_t stream, Extra... extra) {
  size_t bytes = smem;
  if (star && p.num_levels <= LUT_SMEM_MAX) bytes += sizeof(float) * p.num_levels;
  // once per device: the largest shared-memory request of this kernel (it
  // bounds what a launch may ask; occupancy follows what it does ask), the
  // SM count and the CTAs an SM holds at that request
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= LaunchCache::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache.sms[dev] == 0) {
    const int most = (int)(smem + (star ? sizeof(float) * LUT_SMEM_MAX : 0));
    int n_sm = 0, n_cta = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_cta, kernel, MT, most);
    if (err != cudaSuccess) return err;
    cache.per_sm[dev] = n_cta;
    cache.sms[dev] = n_sm;
  }
  const int sms = cache.sms[dev];
  const long long blocks = (long long)((p.Tq + mq - 1) / mq) * p.Hq * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // pair heavy and light CTAs only in a causal grid of one wave of two per SM
  const int first_round =
      p.causal && cache.per_sm[dev] == 2 && blocks > sms && blocks <= 2LL * sms ? sms : 0;
  kernel<<<(unsigned)blocks, MT, bytes, stream>>>(p, first_round, extra...);
  return cudaSuccess;
}

// KIND 0: flash_star_mma_kernel, 1: flash_star_tf32_kernel, 2 / 3: the
// pv_int8 kernel on float32 / bfloat16
template <int KIND, bool STAR, int D>
cudaError_t launch_kind(const Params& p, cudaStream_t s, const V8Args& w) {
  static LaunchCache cache;
  using F = TcSmem<float, D, false>;
  using F8 = TcSmem<float, D, true>;
  using B8 = TcSmem<__nv_bfloat16, D, true>;
  if constexpr (KIND == 0)
    return launch_rows_first(flash_star_mma_kernel<D, STAR>, MQ, smem_bytes_mma<D>(), STAR,
                             cache, p, s);
  else if constexpr (KIND == 1)
    return launch_rows_first(flash_star_tf32_kernel<D, STAR>, F::MQ, F::bytes, STAR, cache, p, s);
  else if constexpr (KIND == 2)
    return launch_rows_first(flash_star_pv_int8_kernel<float, D, STAR>, F8::MQ, F8::bytes, STAR,
                             cache, p, s, w);
  else
    return launch_rows_first(flash_star_pv_int8_kernel<__nv_bfloat16, D, STAR>, B8::MQ,
                             B8::bytes, STAR, cache, p, s, w);
}

template <int KIND>
cudaError_t launch_d(const Params& p, int d, cudaStream_t s, const V8Args& w = V8Args{}) {
  const bool star = p.lut != nullptr;
  switch (d) {
    case 8: return star ? launch_kind<KIND, true, 8>(p, s, w) : launch_kind<KIND, false, 8>(p, s, w);
    case 16: return star ? launch_kind<KIND, true, 16>(p, s, w) : launch_kind<KIND, false, 16>(p, s, w);
    case 32: return star ? launch_kind<KIND, true, 32>(p, s, w) : launch_kind<KIND, false, 32>(p, s, w);
    case 64: return star ? launch_kind<KIND, true, 64>(p, s, w) : launch_kind<KIND, false, 64>(p, s, w);
    case 128: return star ? launch_kind<KIND, true, 128>(p, s, w) : launch_kind<KIND, false, 128>(p, s, w);
    case 256: return star ? launch_kind<KIND, true, 256>(p, s, w) : launch_kind<KIND, false, 256>(p, s, w);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_blocked(const Params& p, cudaStream_t s, const V8Args& w) {
  static LaunchCache cache;
  using S = TcSmem<T, D, false>;
  return launch_rows_first(flash_star_blocked_kernel<T, D>, S::MQ, S::bytes, true, cache, p, s, w);
}

template <typename T>
cudaError_t launch_blocked_d(const Params& p, int d, cudaStream_t s, const V8Args& w) {
  switch (d) {
    case 8: return launch_blocked<T, 8>(p, s, w);
    case 16: return launch_blocked<T, 16>(p, s, w);
    case 32: return launch_blocked<T, 32>(p, s, w);
    case 64: return launch_blocked<T, 64>(p, s, w);
    case 128: return launch_blocked<T, 128>(p, s, w);
    case 256: return launch_blocked<T, 256>(p, s, w);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const void* info, const void* lut,
                   long long q_sb, long long q_sh, long long q_st,
                   long long k_sb, long long k_sh, long long k_st,
                   long long v_sb, long long v_sh, long long v_st,
                   long long o_sb, long long o_sh, long long o_st,
                   int B, int Hq, int Hkv, int Tq, int Tk,
                   int causal, int window, float sm_scale, float grid_scale, int num_levels) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.info = static_cast<const int32_t*>(info);
  p.lut = static_cast<const float*>(lut);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.causal = causal; p.window = window;
  p.sm_scale = sm_scale; p.grid_scale = grid_scale; p.num_levels = num_levels;
  return p;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define FLASH_STAR_ARGS                                                     \
    const void *q, const void *k, const void *v, void *o,                    \
    const void *info, const void *lut,                                       \
    long long q_sb, long long q_sh, long long q_st,                          \
    long long k_sb, long long k_sh, long long k_st,                          \
    long long v_sb, long long v_sh, long long v_st,                          \
    long long o_sb, long long o_sh, long long o_st,                          \
    int B, int Hq, int Hkv, int Tq, int Tk, int D
#define FLASH_STAR_PARAMS                                                    \
  make_params(q, k, v, o, info, lut, q_sb, q_sh, q_st, k_sb, k_sh, k_st,    \
              v_sb, v_sh, v_st, o_sb, o_sh, o_st, B, Hq, Hkv, Tq, Tk,        \
              causal, window, sm_scale, grid_scale, num_levels)

// Every entry point: strides in elements, the feature dimension contiguous;
// the base pointers and the batch, head and T strides of q, k and v
// multiples of 16 bytes (the wrapper checks); returns cudaGetLastError()
// after its launch(es).

// bfloat16 q/k/v/o, pv_int8 off: flash_star_mma_kernel.
extern "C" int flash_star_mma_launch(
    FLASH_STAR_ARGS,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  const cudaError_t err = launch_d<0>(p, D, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// float32 q/k/v/o, pv_int8 off: flash_star_tf32_kernel.
extern "C" int flash_star_tf32_launch(
    FLASH_STAR_ARGS,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  const cudaError_t err = launch_d<1>(p, D, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int8 P.V variant, step 1: V [B, Hkv, Tk, D] (dtype 0 = float32, 1 =
// bfloat16) to codes [B, Hkv, nblk, D, kpad] and scales [B, Hkv, nblk],
// nblk = ceil(Tk / bk), kpad = bk rounded up to 32 (any bk >= 1).
extern "C" int flash_star_quantize_v_launch(
    const void* v, long long v_sb, long long v_sh, long long v_st,
    int B, int Hkv, int Tk, int D, int dtype, int bk, void* codes, void* scales,
    void* stream) {
  if (bk < 1 || (dtype != 0 && dtype != 1) || D < 8 || D > QV_MAX_D || D % 8)
    return (int)cudaErrorInvalidValue;
  if (Tk <= 0 || B <= 0 || Hkv <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scales);
  const cudaError_t err = dtype == 0
      ? launch_quantize_v(static_cast<const float*>(v), v_sb, v_sh, v_st, B, Hkv, Tk, D, bk, c, sc, s)
      : launch_quantize_v(static_cast<const __nv_bfloat16*>(v), v_sb, v_sh, v_st, B, Hkv, Tk, D,
                          bk, c, sc, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int8 P.V variant, step 2: the attention over V's codes from step 1
// (the same bk and Tk), q/k/o float32 (dtype 0) or bfloat16 (1).
extern "C" int flash_star_pv_int8_launch(
    FLASH_STAR_ARGS, int dtype,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    int bk, const void* codes, const void* scales, void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (bk < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  V8Args w;
  w.codes = static_cast<const int8_t*>(codes);
  w.scales = static_cast<const float*>(scales);
  w.bk = bk;
  w.kpad = pad32(bk);
  w.nblk = (Tk + bk - 1) / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_d<2>(p, D, s, w) : launch_d<3>(p, D, s, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The block route (STAR only, lut required): KV blocks of bk rows from row
// 0, each block's max before its P, q/k/v/o float32 (dtype 0) or bfloat16
// (1): flash_star_blocked_kernel.
extern "C" int flash_star_blocked_launch(
    FLASH_STAR_ARGS, int dtype,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    int bk, void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (bk < 1 || lut == nullptr || num_levels < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  V8Args w;
  w.codes = nullptr;
  w.scales = nullptr;
  w.bk = bk;
  w.kpad = pad32(bk);
  w.nblk = (Tk + bk - 1) / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_blocked_d<float>(p, D, s, w)
                                     : launch_blocked_d<__nv_bfloat16>(p, D, s, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
