// crossbar_matmul: the RRAM crossbar MatMul engine model's tiled ADC
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/crossbar_matmul/kernel.py
// (crossbar_matmul_pallas / _kernel).  Per 128x128 crossbar tile (k, n) the
// analog partial sum of quantized operands passes a 5-bit ADC,
//     adc = clip(rint(partial / step[k, n] + off[k, n]), +-adc_levels) * step[k, n],
// and the ADC outputs accumulate digitally over the K tiles in order.  The
// TPU grid (M/bm, N/128, K/128) runs K innermost and carries the sum in a
// VMEM scratch; here one CTA owns a [128, BN] output block (BN 32 or 64,
// within one 128-column crossbar tile) and loops over the K tiles itself,
// in order, so nothing carries between CTAs.
//
// int8 codes (weight_bits <= 8) run on the tensor cores:
//   * clean int8 x int8: mma.sync m16n8k32 s8 into int32, exact (|partial| <=
//     128 * 127 * 127 < 2^24, so its float value equals the TPU's float32
//     dot and the plain version's bit for bit).  Its B fragments want K
//     contiguous, wq is [K, N] row-major and ldmatrix.trans moves 16-bit
//     elements only, so each staged w tile is transposed to [BN][128] in
//     shared memory (4x4 byte blocks through __byte_perm) before ldmatrix;
//   * faulty float32 weights x int8 codes: the codes are exact in bf16, and
//     each weight is split once per staged sub-tile into three bf16 pieces
//     (hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid): their sum
//     is w for |w| >= 2^-100), kept as three [64][BN] planes whose B
//     fragments come from ldmatrix.trans.  Per 16 k the three products (lo,
//     mid, hi) run into a fresh float32 accumulator that is then added to the
//     tile's partial with one IEEE add: the tensor cores' own rounding stays
//     inside a 16-term sum.  The plain version rounds the float64 dot once,
//     so a code within a few float32 ulps of a half-step may flip.
// The ADC step is IEEE division (__fdiv_rn: never a reciprocal multiply),
// rint is half to even (jnp.round), and the multiply and the accumulate are
// separately rounded (__fmul_rn, __fadd_rn).  Built without fast math.
//
// Staging: a cp.async ring of two raw stages that runs two stages ahead; a
// prep pass between two barriers per stage turns the raw stage into the
// operands (clean: the w transpose, x read as it landed, in a ring of three;
// faulty: x to bf16, w to its three planes), and the ADC runs once a whole
// crossbar tile is summed.  A clean stage is a crossbar tile; a faulty one
// is half a tile (64 k), which keeps shared memory under half the SM's (94
// KB at BN 64), so two CTAs share an SM and one's prep and ADC overlap the
// other's products.  The grid runs the M blocks fastest, so at M = 256 the
// two CTAs that read one w column block run side by side and w comes from
// device memory about once (at most twice).  BN is 64 where ceil(M / 128) *
// N / 64 fills the SMs, else 32 (q_proj [256, 4096] @ [4096, 4096]: 256 CTAs
// on 132 SMs).
//
// What bounds it on the H100: clean, bytes (74.5 MB at [256, 4096] x [4096,
// 14336]: 0.0222 ms; the int8 products at 1979 TOP/s take 0.0152); faulty,
// the three bf16 products as issued (3 x 30.1 GFLOP at 989 TFLOP/s: 0.091
// ms) over its float32 weight bytes (0.070 ms).  The ADC epilogue (one IEEE
// division per output per K tile, 117 M at that shape) is ALU work beside
// the tensor cores: about half the clean kernel's time and a fifth of the
// faulty one's (chip_smoke.py times the same instantiations without it).
//
// int32 codes (weight_bits > 8; no path runs them at full width) keep the
// scalar body of the first port: one CTA per [64, 128] block, 4 x 8 outputs
// a thread, float32 fmaf from shared memory in a fixed r order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;  // crossbar rows (K) and columns (N) per tile
constexpr int BM = 128;    // x rows per tensor-core CTA (warps of 32 rows)

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared, bypassing L1; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 16-byte matrices: register i of lane l holds 4 bytes of matrix i,
// row l / 4, bytes 4 (l % 4) .. + 3 (.trans: 16-bit elements (2 (l % 4),
// l / 4) and (2 (l % 4) + 1, l / 4)).  Lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), int32.  Lane 4 g + t holds A
// rows g (a0, a2) and g + 8 (a1, a3) at k = 4 t + i (a0, a1) and 16 + 4 t + i
// (a2, a3), byte i; B column g at the same k (b0, b1).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32.  Lane 4 g + t holds
// A (g, 2t..2t+1), (g + 8, 2t..), (g, 8 + 2t..), (g + 8, 8 + 2t..) and B
// (2t..2t+1, g), (8 + 2t.., g).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
// Two weights as three packed bf16 pieces each (x in the low halves):
// hi + mid + lo == w (both differences are exact in float32).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float2 h = unpack_bf16(hi);
  const float xr = __fsub_rn(x, h.x), yr = __fsub_rn(y, h.y);
  mid = pack_bf16(xr, yr);
  const float2 m = unpack_bf16(mid);
  lo = pack_bf16(__fsub_rn(xr, m.x), __fsub_rn(yr, m.y));
}
// Bytes 2 i and 2 i + 1 of u (int8 codes) as two packed bf16, exact: the
// float 1.5 * 2^23 + v has ulp 1, so subtracting 1.5 * 2^23 leaves v, whose
// 7 significant bits sit in the float's upper half.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t u, int i) {
  const int a = (int)(int8_t)(u >> (16 * i)), b = (int)(int8_t)(u >> (16 * i + 8));
  const float fa = __fsub_rn(__int_as_float(0x4B400000 + a), 12582912.f);
  const float fb = __fsub_rn(__int_as_float(0x4B400000 + b), 12582912.f);
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// One output's ADC step on a K tile: the sum of the tile's quantized partial.
__device__ __forceinline__ float adc(float acc, float part, float st, float o, bool has_off,
                                    float lim) {
  float code = __fdiv_rn(part, st);
  if (has_off) code = __fadd_rn(code, o);
  const float q = fminf(fmaxf(rintf(code), -lim), lim);
  return __fadd_rn(acc, __fmul_rn(q, st));
}

template <bool FAULTY, int BN> struct TcLayout {
  static constexpr int NT = (BM / 32) * (BN / 32) * 32;  // warps of 32 x 32 outputs
  static constexpr int KS = FAULTY ? 64 : TILE;    // k per staged sub-tile
  static constexpr int RING = 2;                   // raw stages: loads run two sub-tiles ahead
  static constexpr int XSTAGES = FAULTY ? RING : RING + 1;  // clean: ldmatrix reads x's stage
  static constexpr int XP = KS + 16;               // clean: int8 x row pitch (bytes)
  static constexpr int WT_P = KS + 16;             // clean: transposed w [BN][WT_P] bytes
  static constexpr int XB_P = KS + 8;              // faulty: x as bf16 [BM][XB_P]
  static constexpr int PL_P = BN + 8;              // faulty: w planes [KS][PL_P] bf16
  static constexpr int X_BYTES = XSTAGES * BM * (FAULTY ? KS : XP);
  static constexpr int WRAW_BYTES = RING * KS * BN * (FAULTY ? 4 : 1);
  static constexpr int OPS_BYTES = FAULTY ? (BM * XB_P + 3 * KS * PL_P) * 2 : BN * WT_P;
  static constexpr int SMEM = X_BYTES + WRAW_BYTES + OPS_BYTES;
};

// ADC false: the products and the staging alone, each tile's partial added
// as it is (a timing probe for the ADC epilogue's share; not the crossbar).
// Two CTAs an SM: at most 128 registers a thread.
template <bool FAULTY, int BN, bool ADC>
__global__ void __launch_bounds__(TcLayout<FAULTY, BN>::NT, 2) crossbar_tc_kernel(
    const int8_t* __restrict__ x, const void* __restrict__ wv, const float* __restrict__ step,
    const float* __restrict__ off, float* __restrict__ out, int M, int K, int N,
    int adc_levels) {
  using L = TcLayout<FAULTY, BN>;
  using Part = typename std::conditional<FAULTY, float, int>::type;
  constexpr int NT = L::NT, KS = L::KS;
  constexpr int XROW = FAULTY ? KS : L::XP;  // pitch of the raw x stage
  constexpr int SUB = TILE / KS;             // sub-tiles a crossbar tile
  constexpr int ESZ = FAULTY ? 4 : 1;        // bytes of a weight
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                    // [XSTAGES][BM][XROW]
  unsigned char* wring = smem + L::X_BYTES;                          // [RING][KS][BN] int8 / f32
  unsigned char* ops = wring + L::WRAW_BYTES;
  int8_t* wT = reinterpret_cast<int8_t*>(ops);                       // clean: [BN][WT_P]
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(ops);         // faulty: [BM][XB_P]
  __nv_bfloat16* planes = xb + BM * L::XB_P;                         // faulty: [3][KS][PL_P]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // warp's 32-row and 32-column block
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN, nt = col0 / TILE;
  const int S = K / KS, Nt = N / TILE;
  const float lim = (float)adc_levels;
  const bool has_off = off != nullptr;

  auto stage = [&](int s) {
    int8_t* xd = xs + (s % L::XSTAGES) * BM * XROW;
    for (int e = tid; e < BM * (KS / 16); e += NT) {
      const int r = e / (KS / 16), c = (e % (KS / 16)) * 16;
      const bool in = row0 + r < M;
      cp_async16(xd + r * XROW + c, in ? x + (long long)(row0 + r) * K + s * KS + c : x,
                 in ? 16 : 0);
    }
    constexpr int WCH = BN * ESZ / 16;  // 16-byte chunks per w row
    const unsigned char* wg = static_cast<const unsigned char*>(wv);
    unsigned char* wraw = wring + (s % L::RING) * KS * BN * ESZ;
    for (int e = tid; e < KS * WCH; e += NT) {
      const int r = e / WCH, c = (e % WCH) * 16;
      cp_async16(wraw + r * BN * ESZ + c, wg + ((long long)(s * KS + r) * N + col0) * ESZ + c,
                 16);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
  Part part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // one commit group per sub-tile (empty past the last), so waiting for all
  // but the newest group is waiting for sub-tile s
  stage(0);
  if (S > 1) stage(1); else cp_async_commit();
  for (int s = 0; s < S; ++s) {
    cp_async_wait_but_one();
    __syncthreads();  // sub-tile s landed; the last sub-tile's products are done
    const unsigned char* wraw = wring + (s % L::RING) * KS * BN * ESZ;
    if constexpr (FAULTY) {
      // x codes to bf16: 16 bytes in, 32 out
      const int8_t* xr = xs + (s % L::XSTAGES) * BM * KS;
      for (int e = tid; e < BM * (KS / 16); e += NT) {
        const int r = e / (KS / 16), c = (e % (KS / 16)) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(xr + r * KS + c);
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[2 * i] = s8x2_to_bf16x2(w4[i], 0);
          o[2 * i + 1] = s8x2_to_bf16x2(w4[i], 1);
        }
        uint4* dst = reinterpret_cast<uint4*>(xb + r * L::XB_P + c);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      // w to three bf16 planes, four weights a thread at a time
      const float* wr = reinterpret_cast<const float*>(wraw);
      for (int e = tid; e < KS * BN / 4; e += NT) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(wr + r * BN + c);
        uint32_t h0, m0, l0, h1, m1, l1;
        split3(v.x, v.y, h0, m0, l0);
        split3(v.z, v.w, h1, m1, l1);
        const int o = r * L::PL_P + c;
        *reinterpret_cast<uint2*>(planes + o) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(planes + KS * L::PL_P + o) = make_uint2(m0, m1);
        *reinterpret_cast<uint2*>(planes + 2 * KS * L::PL_P + o) = make_uint2(l0, l1);
      }
    } else {
      // w [KS][BN] -> wT [BN][KS]: 4 k x 4 n byte blocks
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(wraw);
      for (int e = tid; e < (KS / 4) * (BN / 4); e += NT) {
        const int nb = e % (BN / 4), kb = e / (BN / 4);
        const uint32_t r0 = wr[(4 * kb + 0) * (BN / 4) + nb], r1 = wr[(4 * kb + 1) * (BN / 4) + nb];
        const uint32_t r2 = wr[(4 * kb + 2) * (BN / 4) + nb], r3 = wr[(4 * kb + 3) * (BN / 4) + nb];
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
        uint32_t* d = reinterpret_cast<uint32_t*>(wT + (4 * nb) * L::WT_P + 4 * kb);
        d[0] = __byte_perm(t0, t1, 0x5410);
        d[L::WT_P / 4] = __byte_perm(t0, t1, 0x7632);
        d[2 * (L::WT_P / 4)] = __byte_perm(t2, t3, 0x5410);
        d[3 * (L::WT_P / 4)] = __byte_perm(t2, t3, 0x7632);
      }
    }
    __syncthreads();  // operands ready; the raw stage is free
    if (s + 2 < S) stage(s + 2); else cp_async_commit();

    if (s % SUB == 0) {  // a crossbar tile's first sub-tile: a fresh partial
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[i][j][v] = Part(0);
    }
    if constexpr (FAULTY) {
#pragma unroll 1
      for (int ks = 0; ks < KS / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], xb + (wm * 32 + mi * 16 + lane % 8 + ((lane / 8) & 1) * 8) * L::XB_P +
                             ks * 16 + (lane / 16) * 8);
        // lo, then mid, then hi into a fresh accumulator per output block,
        // the eight blocks' products interleaved
        float d[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) d[mi][ni][v] = 0.f;
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          uint32_t b[4][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            ldsm_x4_trans(r, planes + p * KS * L::PL_P +
                                 (ks * 16 + lane % 8 + ((lane / 8) & 1) * 8) * L::PL_P +
                                 wn * 32 + np * 16 + (lane / 16) * 8);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(d[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              part[mi][ni][v] = __fadd_rn(part[mi][ni][v], d[mi][ni][v]);
      }
    } else {
      const int8_t* xk = xs + (s % L::XSTAGES) * BM * XROW;
#pragma unroll
      for (int ks = 0; ks < KS / 32; ++ks) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], xk + (wm * 32 + mi * 16 + lane % 8 + ((lane / 8) & 1) * 8) * XROW +
                             ks * 32 + (lane / 16) * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, wT + (wn * 32 + np * 16 + lane % 8 + (lane / 16) * 8) * L::WT_P + ks * 32 +
                         ((lane / 8) & 1) * 16);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (s % SUB != SUB - 1) continue;

    // the crossbar tile's ADC: int32 partials are exact as float (< 2^24)
    const int kt = s / SUB;
    const float st = step[kt * Nt + nt];
    const float o = has_off ? off[kt * Nt + nt] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float pv = (float)part[i][j][v];
          acc[i][j][v] = ADC ? adc(acc[i][j][v], pv, st, o, has_off, lim)
                             : __fadd_rn(acc[i][j][v], pv);
        }
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wm * 32 + i * 16 + g + 8 * h;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(out + (long long)gr * N + col0 + wn * 32 + j * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// int32 codes: the scalar body

constexpr int SBM = 64;         // x rows per CTA
constexpr int SNT = 256;        // 16 x 16 threads, each a STM x STN block
constexpr int STM = 4;          // rows ty + 16 i
constexpr int STN = 8;          // columns tx + 16 j

template <typename XT, typename WT>
__global__ void __launch_bounds__(SNT) crossbar_scalar_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, const float* __restrict__ step,
    const float* __restrict__ off, float* __restrict__ out, int M, int K, int N,
    int adc_levels) {
  constexpr int XS = TILE + 1;  // padded x row: rows ty, ty+1 on other banks
  extern __shared__ __align__(16) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem);                            // [SBM][XS]
  WT* ws = reinterpret_cast<WT*>(smem + SBM * XS * sizeof(XT));    // [TILE][TILE]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * SBM, nt = blockIdx.y, col0 = nt * TILE;
  const int Kt = K / TILE, Nt = N / TILE;
  const float lim = (float)adc_levels;
  float acc[STM][STN];
#pragma unroll
  for (int i = 0; i < STM; ++i)
#pragma unroll
    for (int j = 0; j < STN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < Kt; ++kt) {
    for (int e = threadIdx.x; e < SBM * TILE; e += SNT) {
      const int r = e / TILE, c = e % TILE, gr = row0 + r;
      xs[r * XS + c] = gr < M ? x[(long long)gr * K + kt * TILE + c] : XT(0);
    }
    for (int e = threadIdx.x; e < TILE * TILE; e += SNT) {
      const int r = e / TILE, c = e % TILE;
      ws[e] = w[(long long)(kt * TILE + r) * N + col0 + c];
    }
    __syncthreads();

    float part[STM][STN];
#pragma unroll
    for (int i = 0; i < STM; ++i)
#pragma unroll
      for (int j = 0; j < STN; ++j) part[i][j] = 0.f;
    for (int r = 0; r < TILE; ++r) {
      float a[STM], b[STN];
#pragma unroll
      for (int i = 0; i < STM; ++i) a[i] = (float)xs[(ty + 16 * i) * XS + r];
#pragma unroll
      for (int j = 0; j < STN; ++j) b[j] = (float)ws[r * TILE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < STM; ++i)
#pragma unroll
        for (int j = 0; j < STN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }

    const float st = step[kt * Nt + nt];
    const float o = off != nullptr ? off[kt * Nt + nt] : 0.f;
#pragma unroll
    for (int i = 0; i < STM; ++i)
#pragma unroll
      for (int j = 0; j < STN; ++j)
        acc[i][j] = adc(acc[i][j], part[i][j], st, o, off != nullptr, lim);
    __syncthreads();  // the tiles are overwritten next
  }

#pragma unroll
  for (int i = 0; i < STM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < STN; ++j) out[(long long)gr * N + col0 + tx + 16 * j] = acc[i][j];
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool FAULTY, int BN, bool ADC>
cudaError_t launch_tc(const void* x, const void* w, const float* step, const float* off,
                      float* out, int M, int K, int N, int adc_levels, cudaStream_t s) {
  using L = TcLayout<FAULTY, BN>;
  auto kernel = crossbar_tc_kernel<FAULTY, BN, ADC>;
  cudaError_t err = set_smem((const void*)kernel, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, N / BN);
  kernel<<<grid, L::NT, L::SMEM, s>>>(static_cast<const int8_t*>(x), w, step, off, out, M, K,
                                      N, adc_levels);
  return cudaGetLastError();
}

template <bool FAULTY, bool ADC = true>
cudaError_t launch_tc_bn(const void* x, const void* w, const float* step, const float* off,
                         float* out, int M, int K, int N, int adc_levels, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long ctas64 = (long long)((M + BM - 1) / BM) * (N / 64);
  return ctas64 >= sms
             ? launch_tc<FAULTY, 64, ADC>(x, w, step, off, out, M, K, N, adc_levels, s)
             : launch_tc<FAULTY, 32, ADC>(x, w, step, off, out, M, K, N, adc_levels, s);
}

template <typename XT, typename WT>
cudaError_t launch_scalar(const void* x, const void* w, const float* step, const float* off,
                          float* out, int M, int K, int N, int adc_levels, cudaStream_t s) {
  const size_t smem = SBM * (TILE + 1) * sizeof(XT) + (size_t)TILE * TILE * sizeof(WT);
  auto kernel = crossbar_scalar_kernel<XT, WT>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + SBM - 1) / SBM, N / TILE);
  kernel<<<grid, SNT, smem, s>>>(static_cast<const XT*>(x), static_cast<const WT*>(w), step,
                                 off, out, M, K, N, adc_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq [M, K] row-major (x_type 0 = int8, 1 = int32), wq [K, N] row-major
// (w_type 0 = int8, 1 = int32, 2 = float32), step / off float32 [K/128, N/128]
// (off may be null), out float32 [M, N].  K and N are multiples of 128; the
// int8 operands' rows start on 16 bytes (the wrapper checks the pointers).
// int8 x with int8 or float32 w runs on the tensor cores, int32 x on the
// scalar body.  Returns cudaGetLastError() after the launch.
extern "C" int crossbar_matmul_launch(
    const void* x, const void* w, const void* step, const void* off, void* out,
    int M, int K, int N, int x_type, int w_type, int adc_levels, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K % TILE != 0 || N % TILE != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(step);
  const float* of = static_cast<const float*>(off);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (x_type == 0 && w_type == 0)
    err = launch_tc_bn<false>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 0 && w_type == 2)
    err = launch_tc_bn<true>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 1 && w_type == 1)
    err = launch_scalar<int32_t, int32_t>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 1 && w_type == 2)
    err = launch_scalar<int32_t, float>(x, w, st, of, o, M, K, N, adc_levels, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The tensor-core instantiations without their ADC epilogue (same
// arguments, int8 x only): chip_smoke.py times it beside the crossbar to
// measure the epilogue's share.  Its output is the sum of the tiles'
// partials, not the crossbar's.
extern "C" int crossbar_matmul_products_launch(
    const void* x, const void* w, const void* step, const void* off, void* out,
    int M, int K, int N, int x_type, int w_type, int adc_levels, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K % TILE != 0 || N % TILE != 0 || x_type != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(step);
  const float* of = static_cast<const float*>(off);
  float* o = static_cast<float*>(out);
  if (w_type == 0) return (int)launch_tc_bn<false, false>(x, w, st, of, o, M, K, N, adc_levels, s);
  if (w_type == 2) return (int)launch_tc_bn<true, false>(x, w, st, of, o, M, K, N, adc_levels, s);
  return (int)cudaErrorInvalidValue;
}
