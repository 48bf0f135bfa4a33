// paged_attention: gather-free paged decode attention over a block-pool KV
// cache, for Hopper (sm_90a), split across CTAs along the KV rows
// (flash-decoding) and merged by a second, small kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_flash_attention / _kernel): its fp-KV variant (:222) and its
// quantized variant (:230, k_scale / v_scale: int8 or fp8_e4m3 pages).  The
// TPU grid (S, Hkv, W) walks one slot's pages in order through
// scalar-prefetched block tables and carries (m, l, acc) in VMEM.  Here the
// rows of a slot are cut at fixed offsets into splits of L rows, one CTA
// each, and a combine kernel merges the splits' (m, l, acc).  Table entries
// past the live prefix are never dereferenced, and no gathered
// [S, W*bs, Hkv, D] copy exists anywhere.
//
// What bounds it on the H100: the bytes of the live K/V pages.  At the
// decode tick of a full-width granite-8b serve (S 4, lens 514/386/258/130,
// Hq 32, Hkv 8, D 128, bs 16) that is 5.34 MB over bf16 pages, 1.59 us at
// 3.35 TB/s, and 2.71 MB over int8 pages, 0.81 us.  A grid of (S, Hkv)
// would hold 32 CTAs on 132 SMs, each walking its slot's pages in series:
// latency, not bytes.  Split-KV gives (S, Hkv, splits) CTAs, 288 at that
// tick (192 of them live), each loading its L rows once with 16-byte
// cp.async copies into shared memory, K and V as separate groups so QK^T
// and the softmax run while V lands.
//
// Why CUDA cores and not the tensor cores: with G = Hq / Hkv = 4 q heads per
// KV head, a decode step does 4 * G * D FLOP per 2 * D pool elements, i.e.
// 4 FLOP per byte of bf16 K/V and 8 per byte of 1-byte codes, below the
// FP32 units' 67 TFLOP/s / 3.35 TB/s = 20: fed FP32 FMAs reach the byte
// bound.  And a dequantized K (code * scale) is a float32 that bf16 cannot
// hold, so a bf16 mma would round an operand the reference keeps exact.
// K and V stay in their storage type in shared memory and are widened (and
// dequantized) as they are read.  QK^T: each thread holds one row's half of
// K in registers, 64 columns at a time (at D 256 the half-row's 128 would
// crowd out the rest), and dots it with the G q rows (broadcast reads of q
// in shared memory).  P.V: each thread owns CPT output columns (4; 8 at D
// 256, so that D / CPT x 4-head groups fit the CTA's 128 threads at every
// group up to MAXG) of 4 q heads over a residue class of the split's rows;
// the classes are summed in a fixed order at the end.
//
// L and batch invariance.  L = SPLIT_ROWS = 64 rows for every block size:
// one shared-memory tile, so a CTA loads K and V once and computes once.
// Each local row maps to its pool row through the table (row_sh), so a
// split may start inside a page (bs > 64, or bs not dividing 64) or span
// up to 64 pages (bs 1).  splits = ceil(W * bs / L) comes from shapes only,
// never from kv_valid: the wrapper reads nothing back from the card.
// Split i covers logical rows [i*L, (i+1)*L) of its slot, so its bits, and
// a slot's output, depend only on that slot's own rows: never on S, on W
// (bucket padding) or on other slots' lengths.  A split that begins at or
// past kv_valid writes an empty partial (m = sentinel or -1e30, l = 0,
// acc = 0) and returns.
//
// The combine (a second kernel on the same stream, one CTA per (slot, q
// head)) merges the live splits in split order, without atomics, so the
// result is the same bits run to run: m = max m_i (int32 under STAR),
// r_i = lut[min(m - m_i, top)] or expf(m_i - m), l = sum r_i * l_i,
// acc = sum r_i * acc_i, out = acc / (l <= 0 ? 1 : l), a true division,
// rounded to q's type once.  This is the TPU kernel's function, which applies
// the online rule at every page, only while lut[a] * lut[b] == lut[a + b]:
// under STAR it fails once a + b passes the deepest level top, where the
// table clamps, and then a key's weight depends on where the schedule cuts
// the rows.  The wrapper keeps this one-pass route where that moves the
// output by less than float32 rounding (formats of 6 bits and up, the exact
// softmax; kernel.py) and takes the block route below at 2 to 5 bits.  With
// splits == 1 (decided from shapes) the split kernel
// divides and writes the output itself: with one live split r_0 is exactly
// 1 (lut[0], expf(0)), so both routes give the same bits (the card tests
// and chip_smoke.py hold a short slot alone, one split, bit-equal to the
// same slot in a batch that goes through the combine).  A second launch
// was chosen over folding the combine into the last CTA of each head with a
// counter: it needs no zeroed counters and is a few microseconds.
//
// The block route (paged_attention_blocked_launch; STAR at 2 to 5 bits, every
// pool type): the TPU kernel's weights exactly, keeping split-KV.  With b_p
// page p's grid max, M_p = max(b_0 .. b_p) the running max after page p and
// r_p = lut[min(M_p - M_{p-1}, top)] its rescale, the TPU kernel gives row j
// of page p the weight lut[min(M_p - j, top)] * R_p, R_p = r_{p+1} ... r_last.
// Three launches before the combine: the split kernel in its scores mode
// (K only: each live row's grid index per q head into the workspace), a scan
// (one CTA per (slot, KV head): the page maxima, then per q head a warp's
// prefix max and suffix product over the pages: M_p and R_p), and the split
// kernel in its weights mode (V only: p = lut[min(M_p - j, top)] * R_p,
// the row sums and P.V as above), whose partials all carry m = 0, so the
// combine's r_i are lut[0] = 1 and it adds them.  The pool's K and V are each
// read once, as in the one-pass route; the grid indices go to the workspace
// and back (4 bytes a row and q head).
//
// Softmax arithmetic is flash_star's: STAR snaps each score (q.k in
// float32, times sm_scale, a separate multiply) to the int grid with rint
// (half to even), saturating to +-2^24 before the int cast (NaN ->
// sentinel); the split's max is an int32; the probabilities and the
// combine's rescale factors are entries of the exp LUT passed in (nullptr =
// exact softmax, with expf).  Masked rows never enter the max.  A slot with
// kv_valid == 0 emits zeros.  q is float32 or bfloat16; arithmetic is
// float32; output in q's type.
//
// Pools hold q's type, or (quantized variant) 1-byte codes, int8 or
// __nv_fp8_e4m3, with one float32 scale per (page, kv head) in [N, Hkv]
// scale pages.  A CTA reads each of its pages' ids and two scales once, and
// dequantizes with __fmul_rn((float)code, scale), kvquant.decode's
// expression, so the operands equal the reference's dequantized K/V bit for
// bit (every int8 and e4m3 value converts to float exactly).
//
// Head dims 8, 16, 32, 64, 128 and 256 (recurrentgemma-2b: G 10 over one KV
// head; its float32 tile, 2 x 64 x 1040 bytes, is dynamic shared memory the
// launch opts into).  A head row is copied in pieces of 16
// bytes, or of its whole size where it is shorter: 8 bytes for the 1-byte
// codes of a D 8 row (cp.async.ca takes 4, 8 or 16 bytes); every
// instantiation's row splits into whole pieces (a static_assert), so no
// head dim or type can copy nothing.  The tile's padded pitch RB + 16 keeps
// each widen() vector load aligned to its size.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 16;               // largest GQA group
constexpr int SPLIT_ROWS = 64;         // L: KV rows a split, one shared-memory tile
constexpr int GRID_SENTINEL = -(1 << 24);
constexpr float NEG_BIG = -1e30f;

template <typename C> struct is_code { static constexpr bool value = false; };
template <> struct is_code<int8_t> { static constexpr bool value = true; };
template <> struct is_code<__nv_fp8_e4m3> { static constexpr bool value = true; };
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 32-bit word of storage -> 4 / sizeof(C) floats, exactly.
template <typename C> struct Widen;
template <> struct Widen<float> {
  __device__ static void word(uint32_t w, float* out) { out[0] = __uint_as_float(w); }
};
template <> struct Widen<__nv_bfloat16> {
  __device__ static void word(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Widen<int8_t> {
  __device__ static void word(uint32_t w, float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (float)(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
};
template <> struct Widen<__nv_fp8_e4m3> {
  __device__ static void word(uint32_t w, float* out) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // e4m3 -> half is exact, half -> float too
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3));
      const float2 f = __half22float2(h);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// N elements of C at a shared-memory address aligned to N * sizeof(C)
// bytes (4, 8 or 16) -> floats, with one vector load.
template <typename C, int N>
__device__ __forceinline__ void widen(const C* src, float* out) {
  constexpr int WORDS = N * (int)sizeof(C) / 4;
  constexpr int PER = 4 / (int)sizeof(C);
  uint32_t w[WORDS];
  if constexpr (WORDS == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (WORDS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
#pragma unroll
  for (int i = 0; i < WORDS; ++i) Widen<C>::word(w[i], out + i * PER);
}

__device__ __forceinline__ int snap(float s, float scale) {
  float v = rintf(s * scale);
  if (isnan(v)) v = (float)GRID_SENTINEL;
  v = fminf(fmaxf(v, (float)GRID_SENTINEL), (float)(-GRID_SENTINEL));
  return (int)v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// N bytes global -> shared: 16 through L2 only (.cg), 4 or 8 through L1
// (.ca: .cg takes 16 alone); dst and src aligned to N
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // all but the newest N groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Params {
  const void* q;        // [S, Hq, D]
  const void* k;        // [N, bs, Hkv, D]
  const void* v;        // [N, bs, Hkv, D]
  void* o;              // [S, Hq, D]
  const int32_t* tables;  // [S, W]
  const int32_t* valid;   // [S]
  const float* lut;       // [num_levels], nullptr = exact softmax
  const float* kscale;    // [N, Hkv] (quantized pools only)
  const float* vscale;    // [N, Hkv]
  float* ws;              // acc [S, Hkv, splits, G, D], then m and l [S, Hkv, splits, G]
  int* jg;                // block route: grid index [S, Hq, splits * L]
  int* pm;                // block route: M_p [S, Hq, W], then R_p (float) [S, Hq, W]
  int S, Hq, Hkv, W, bs, splits;
  float sm_scale, grid_scale;
  int num_levels;
};

// P.V: output columns a thread
__host__ __device__ constexpr int cols_per_thread(int d) { return d > 128 ? 8 : 4; }

// Shared-memory layout of the split kernel, in bytes from the dynamic base
// (q rows, float [G][D], at 0).
struct Layout {
  int sp, ps, kv, total;
};

__host__ __device__ inline Layout layout(int G, int D, int elem) {
  const int gp = 4 * ((G + 3) / 4);
  const int rg = NTHREADS / ((D / cols_per_thread(D)) * (gp / 4));
  const int tile = 2 * SPLIT_ROWS * (D * elem + 16);
  const int red = rg * gp * D * 4;
  Layout l;
  l.sp = G * D * 4;                         // QK^T halves, float [2][G][L]
  l.ps = l.sp + 2 * G * SPLIT_ROWS * 4;     // probabilities, float [L][gp]
  l.kv = l.ps + SPLIT_ROWS * gp * 4;        // K and V tiles; the P.V reduction after them
  l.total = l.kv + (tile > red ? tile : red);
  return l;
}

// Copy the split's `rows` pool rows of this CTA's KV head into a tile of
// SPLIT_ROWS rows with a padded stride, in pieces of PIECE bytes: 16, or the
// whole row where it is shorter (8 bytes: D 8 over 1-byte codes).
template <typename C, int D>
__device__ __forceinline__ void issue_rows(unsigned char* dst, const C* pool, const int* row_sh,
                                           int rows, int Hkv, int hk, int tid) {
  constexpr int RB = D * (int)sizeof(C);  // bytes of one head row
  constexpr int PIECE = RB < 16 ? RB : 16;
  constexpr int CPR = RB / PIECE;         // pieces a row
  static_assert(CPR >= 1 && CPR * PIECE == RB && (PIECE == 16 || PIECE == 8 || PIECE == 4),
                "a head row must split into whole cp.async pieces of 4, 8 or 16 bytes");
  const unsigned char* base = reinterpret_cast<const unsigned char*>(pool) + (long long)hk * RB;
  for (int idx = tid; idx < rows * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const long long row = row_sh[r];
    cp_async<PIECE>(dst + r * (RB + 16) + c * PIECE, base + row * Hkv * RB + c * PIECE);
  }
}

// T: q / output type; C: pool element type (T, or an 8-bit code type).
// Grid (splits, Hkv, S): CTA (i, hk, s) owns rows [i*L, (i+1)*L) of slot s.
// MODE 0: the one-pass split; the block route's 1: scores (K only, grid
// indices out) and 2: weights (V only, p from the scan's M_p and R_p).
template <typename T, typename C, int D, bool STAR, int MODE = 0>
__global__ void __launch_bounds__(NTHREADS, 1) paged_split_kernel(Params p) {
  constexpr bool QUANT = is_code<C>::value;
  constexpr int ES = (int)sizeof(C);
  constexpr int RS = D * ES + 16;   // padded tile row stride, bytes
  constexpr int HALF = D / 2;       // QK^T: a thread's half of a K row ...
  constexpr int KCH = HALF < 64 ? HALF : 64;  // ... KCH columns of it in registers at a time
  constexpr int KV_VEC = (16 / ES < HALF) ? 16 / ES : HALF;
  constexpr int CPT = cols_per_thread(D);  // P.V: CPT output columns per thread
  constexpr int NC = D / CPT;
  static_assert(NTHREADS / (NC * (MAXG / 4)) >= 1,
                "P.V: every (column, 4-head) group needs a thread: rg would be 0");
  static_assert(HALF % KCH == 0 && KCH % KV_VEC == 0 && KCH % 4 == 0, "whole K chunks");
  static_assert(MODE == 0 || STAR, "the block route is STAR's");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int page_sh[SPLIT_ROWS];  // the split's page ids (L of them at bs 1)
  __shared__ int row_sh[SPLIT_ROWS];   // pool row of each local row
  __shared__ int pidx_sh[SPLIT_ROWS];  // local row -> page of the split
  __shared__ float ks_sh[QUANT ? SPLIT_ROWS : 1], vs_sh[QUANT ? SPLIT_ROWS : 1];
  __shared__ int m_sh[MAXG];
  __shared__ float mf_sh[MAXG], l_sh[MAXG];

  const int sp = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, GQ = (G + 3) / 4, GP = 4 * GQ;
  const int bs = p.bs;
  const int row0 = sp * SPLIT_ROWS;
  const int page0 = row0 / bs;
  const int split_pages = min((row0 + SPLIT_ROWS - 1) / bs + 1, p.W) - page0;
  const long long part = ((long long)(s * p.Hkv + hk) * p.splits + sp) * G;
  const bool direct = p.splits == 1;
  T* og = static_cast<T*>(p.o) + ((long long)s * p.Hq + hk * G) * D;

  // page ids first, so that their read overlaps kv_valid's
  int page = 0;
  if (tid < split_pages) page = p.tables[(long long)s * p.W + page0 + tid];
  if (tid < split_pages) page_sh[tid] = page;
  const int kv = min(max(p.valid[s], 0), p.W * bs);
  const int rows = min(SPLIT_ROWS, kv - row0);  // live rows of this split
  if (rows <= 0) {                     // empty split (or free slot): an empty partial
    if constexpr (MODE == 1) return;   // (the scores mode writes nothing)
    for (int idx = tid; idx < G * D; idx += NTHREADS) {
      if (direct) og[idx] = from_f32<T>(0.f);
      else p.ws[part * D + idx] = 0.f;
    }
    if (!direct && tid < G) {
      float* ws_m = p.ws + (long long)p.S * p.Hq * p.splits * D;
      float* ws_l = ws_m + (long long)p.S * p.Hq * p.splits;
      if constexpr (STAR) reinterpret_cast<int*>(ws_m)[part + tid] = GRID_SENTINEL;
      else ws_m[part + tid] = NEG_BIG;
      ws_l[part + tid] = 0.f;
    }
    return;
  }
  __syncthreads();  // page_sh
  if (tid < rows) {
    const int r = row0 + tid, pi = r / bs - page0;
    row_sh[tid] = page_sh[pi] * bs + (r - (page0 + pi) * bs);
    pidx_sh[tid] = pi;
  }
  __syncthreads();  // row_sh

  float* Qs = reinterpret_cast<float*>(smem + 0);
  const Layout lay = layout(G, D, ES);
  float* Sp = reinterpret_cast<float*>(smem + lay.sp);
  float* Ps = reinterpret_cast<float*>(smem + lay.ps);
  unsigned char* Kst = smem + lay.kv;
  unsigned char* Vst = Kst + SPLIT_ROWS * RS;

  if constexpr (MODE != 2) {
    issue_rows<C, D>(Kst, static_cast<const C*>(p.k), row_sh, rows, p.Hkv, hk, tid);
    cp_async_commit();
  }
  if constexpr (MODE != 1) {
    issue_rows<C, D>(Vst, static_cast<const C*>(p.v), row_sh, rows, p.Hkv, hk, tid);
    cp_async_commit();
  }

  // while K and V land: scales, q, the padding heads' p = 0
  if constexpr (QUANT) {
    const int live_pages = (row0 + rows - 1) / bs - page0 + 1;
    if (tid < live_pages) {
      const long long at = (long long)page_sh[tid] * p.Hkv + hk;
      ks_sh[tid] = p.kscale[at];
      vs_sh[tid] = p.vscale[at];
    }
  }
  if constexpr (MODE != 2) {
    constexpr int QV = 16 / (int)sizeof(T);
    const T* qg = static_cast<const T*>(p.q) + ((long long)s * p.Hq + hk * G) * D;
    for (int idx = tid * QV; idx < G * D; idx += NTHREADS * QV) {
      float f[QV];
      widen<T, QV>(qg + idx, f);  // q rows are contiguous and 16-byte aligned
#pragma unroll
      for (int i = 0; i < QV; ++i) Qs[idx + i] = f[i];
    }
  }
  for (int idx = tid; idx < SPLIT_ROWS * (GP - G); idx += NTHREADS)
    Ps[(idx / (GP - G)) * GP + G + idx % (GP - G)] = 0.f;
  if constexpr (MODE == 0)
    cp_async_wait<1>();  // K (V may be in flight)
  else if constexpr (MODE == 1)
    cp_async_wait<0>();  // K
  __syncthreads();

  // QK^T: thread (row r, half h) dots its K half-row with every q row
  if constexpr (MODE != 2) {
    const int r = tid & (SPLIT_ROWS - 1), h = tid / SPLIT_ROWS;
    if (r < rows) {
      const C* krow = reinterpret_cast<const C*>(Kst + r * RS) + h * HALF;
#pragma unroll
      for (int c0 = 0; c0 < HALF; c0 += KCH) {
        float kf[KCH];
#pragma unroll
        for (int i = 0; i < KCH; i += KV_VEC) widen<C, KV_VEC>(krow + c0 + i, kf + i);
        if constexpr (QUANT) {
          const float sc = ks_sh[pidx_sh[r]];
#pragma unroll
          for (int i = 0; i < KCH; ++i) kf[i] = __fmul_rn(kf[i], sc);
        }
        for (int g = 0; g < G; ++g) {
          const float* qh = Qs + g * D + h * HALF + c0;
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int i = 0; i < KCH; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + i);
            d0 = fmaf(qv.x, kf[i], d0);
            d1 = fmaf(qv.y, kf[i + 1], d1);
            d2 = fmaf(qv.z, kf[i + 2], d2);
            d3 = fmaf(qv.w, kf[i + 3], d3);
          }
          const float part = (d0 + d1) + (d2 + d3);
          float* at = Sp + (h * G + g) * SPLIT_ROWS + r;
          *at = c0 == 0 ? part : *at + part;  // the chunks in order (one chunk below D 256)
        }
      }
    }
  }
  __syncthreads();

  // the split's softmax, one warp per q head: m = its max, l = sum p
  for (int g = warp; g < G; g += NWARPS) {
    float sc[2];
    bool live[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k;
      live[k] = c < rows;
      if constexpr (MODE != 2)
        sc[k] = live[k] ? (Sp[g * SPLIT_ROWS + c] + Sp[(G + g) * SPLIT_ROWS + c]) * p.sm_scale
                        : 0.f;
    }
    float psum = 0.f;
    const long long hrow = (long long)s * p.Hq + hk * G + g;  // (slot, q head)
    if constexpr (MODE == 1) {  // the grid indices of the live rows
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (live[k])
          p.jg[hrow * p.splits * SPLIT_ROWS + row0 + lane + 32 * k] = snap(sc[k], p.grid_scale);
      continue;
    } else if constexpr (MODE == 2) {  // the TPU kernel's weights, from the scan
      const int top = p.num_levels - 1;
      const float* pr = reinterpret_cast<const float*>(p.pm) + (long long)p.S * p.Hq * p.W;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = lane + 32 * k;
        float pv = 0.f;
        if (live[k]) {
          const long long pg = hrow * p.W + page0 + pidx_sh[c];
          const int j = p.jg[hrow * p.splits * SPLIT_ROWS + row0 + c];
          pv = __fmul_rn(__ldg(p.lut + min(max(p.pm[pg] - j, 0), top)), pr[pg]);
        }
        Ps[c * GP + g] = pv;
        psum += pv;
      }
      if (lane == 0) m_sh[g] = 0;
    } else if constexpr (STAR) {
      const int top = p.num_levels - 1;
      int jg[2], m = GRID_SENTINEL;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        jg[k] = snap(sc[k], p.grid_scale);
        if (live[k]) m = max(m, jg[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float pv = live[k] ? __ldg(p.lut + min(max(m - jg[k], 0), top)) : 0.f;
        Ps[(lane + 32 * k) * GP + g] = pv;
        psum += pv;
      }
      if (lane == 0) m_sh[g] = m;
    } else {
      float m = NEG_BIG;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (live[k]) m = fmaxf(m, sc[k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float pv = live[k] ? expf(sc[k] - m) : 0.f;
        Ps[(lane + 32 * k) * GP + g] = pv;
        psum += pv;
      }
      if (lane == 0) mf_sh[g] = m;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    if (lane == 0) l_sh[g] = psum;
  }
  if constexpr (MODE == 1) return;
  cp_async_wait<0>();  // V
  __syncthreads();

  // P.V: thread (columns CPT c.., heads 4gq..) over the rows j (mod RG)
  const int pc = tid % NC, pgq = (tid / NC) % GQ, pj = tid / (NC * GQ);
  const int RG = NTHREADS / (NC * GQ);
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[i][k] = 0.f;
  if (pj < RG) {
    for (int row = pj; row < rows; row += RG) {
      float vf[CPT];
#pragma unroll
      for (int k = 0; k < CPT; k += 4)
        widen<C, 4>(reinterpret_cast<const C*>(Vst + row * RS) + CPT * pc + k, vf + k);
      if constexpr (QUANT) {
        const float sc = vs_sh[pidx_sh[row]];
#pragma unroll
        for (int k = 0; k < CPT; ++k) vf[k] = __fmul_rn(vf[k], sc);
      }
      const float4 pp = *reinterpret_cast<const float4*>(Ps + row * GP + 4 * pgq);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < CPT; ++k) acc[i][k] = fmaf(pv[i], vf[k], acc[i][k]);
    }
  }

  // the row classes' sums in a fixed order, then the partial (or the output)
  __syncthreads();  // K and V consumed: their tiles hold the reduction now
  float* Red = reinterpret_cast<float*>(Kst);  // [RG][GP][D]
  if (pj < RG) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < CPT; ++k) Red[(pj * GP + 4 * pgq + i) * D + CPT * pc + k] = acc[i][k];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    float a = Red[idx];
    for (int j = 1; j < RG; ++j) a += Red[j * GP * D + idx];
    if (direct) {
      const float l = l_sh[idx / D];
      og[idx] = from_f32<T>(a / (l <= 0.f ? 1.f : l));
    } else {
      p.ws[part * D + idx] = a;
    }
  }
  if (!direct && tid < G) {
    float* ws_m = p.ws + (long long)p.S * p.Hq * p.splits * D;
    float* ws_l = ws_m + (long long)p.S * p.Hq * p.splits;
    if constexpr (STAR) reinterpret_cast<int*>(ws_m)[part + tid] = m_sh[tid];
    else ws_m[part + tid] = mf_sh[tid];
    ws_l[part + tid] = l_sh[tid];
  }
}

// The block route's scan, grid (Hkv, S): the live pages' grid maxima b_p
// from the scores mode's indices, then one warp per q head walks the pages
// in chunks of 32: M_p = max(b_0 .. b_p) (a prefix max, exact in any order)
// and R_p = prod over p' > p of lut[min(M_p' - M_p'-1, top)] (a suffix
// product, in a fixed order).  M_p overwrites b_p in place.
__global__ void __launch_bounds__(NTHREADS) paged_scan_kernel(Params p) {
  const int hk = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, bs = p.bs, top = p.num_levels - 1;
  const int kv = min(max(p.valid[s], 0), p.W * bs);
  const int np = (kv + bs - 1) / bs;
  const long long h0 = (long long)s * p.Hq + hk * G;
  float* pr = reinterpret_cast<float*>(p.pm) + (long long)p.S * p.Hq * p.W;
  for (int idx = tid; idx < G * np; idx += NTHREADS) {
    const int g = idx / np, pg = idx - g * np;
    const int* j = p.jg + (h0 + g) * p.splits * SPLIT_ROWS;
    int m = GRID_SENTINEL;
    for (int r = pg * bs; r < min((pg + 1) * bs, kv); ++r) m = max(m, j[r]);
    p.pm[(h0 + g) * p.W + pg] = m;
  }
  __syncthreads();  // every page max written
  for (int g = warp; g < G; g += NWARPS) {
    int* M = p.pm + (h0 + g) * p.W;
    float* R = pr + (h0 + g) * p.W;
    int carry = GRID_SENTINEL;
    for (int base = 0; base < np; base += 32) {
      const int pg = base + lane;
      int x = pg < np ? M[pg] : GRID_SENTINEL;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = max(x, y);
      }
      x = max(x, carry);
      if (pg < np) M[pg] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
    __syncwarp();  // M complete for the warp's lanes
    float after = 1.f;  // the product of the chunks past this one
    for (int base = (np - 1) / 32 * 32; base >= 0 && np > 0; base -= 32) {
      const int pg = base + lane;
      // the rescale that page pg + 1 applies (1 past the last page)
      float x = pg + 1 < np ? __ldg(p.lut + min(M[pg + 1] - M[pg], top)) : 1.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, x, o);
        if (lane + o < 32) x = __fmul_rn(x, y);
      }
      x = __fmul_rn(x, after);
      if (pg < np) R[pg] = x;
      after = __shfl_sync(0xffffffffu, x, 0);
    }
  }
}

// Grid (Hq, S), D threads (up to 256): merge (slot, q head)'s live splits
// in order.
template <typename T, bool STAR>
__global__ void __launch_bounds__(256) paged_combine_kernel(Params p, int D) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int G = p.Hq / p.Hkv, hk = h / G, g = h - hk * G;
  const int kv = min(max(p.valid[s], 0), p.W * p.bs);
  const int live = min((kv + SPLIT_ROWS - 1) / SPLIT_ROWS, p.splits);
  const long long part0 = (long long)(s * p.Hkv + hk) * p.splits * G + g;
  const float* ws_m = p.ws + (long long)p.S * p.Hq * p.splits * D;
  const float* ws_l = ws_m + (long long)p.S * p.Hq * p.splits;
  float l = 0.f, a = 0.f;
  if constexpr (STAR) {
    const int* mi = reinterpret_cast<const int*>(ws_m);
    const int top = p.num_levels - 1;
    int m = GRID_SENTINEL;
    for (int i = 0; i < live; ++i) m = max(m, mi[part0 + i * G]);
    for (int i = 0; i < live; ++i) {
      const long long at = part0 + i * G;
      const float r = __ldg(p.lut + min(m - mi[at], top));
      l = fmaf(r, ws_l[at], l);
      a = fmaf(r, p.ws[at * D + d], a);
    }
  } else {
    float m = NEG_BIG;
    for (int i = 0; i < live; ++i) m = fmaxf(m, ws_m[part0 + i * G]);
    for (int i = 0; i < live; ++i) {
      const long long at = part0 + i * G;
      const float r = expf(ws_m[at] - m);
      l = fmaf(r, ws_l[at], l);
      a = fmaf(r, p.ws[at * D + d], a);
    }
  }
  static_cast<T*>(p.o)[((long long)s * p.Hq + h) * D + d] = from_f32<T>(a / (l <= 0.f ? 1.f : l));
}

template <typename T, typename C, int D, bool STAR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, C, D, STAR>;
  const Layout lay = layout(p.Hq / p.Hkv, D, (int)sizeof(C));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.splits, p.Hkv, p.S), NTHREADS, lay.total, stream>>>(p);
  if (p.splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    paged_combine_kernel<T, STAR><<<dim3(p.Hq, p.S), D, 0, stream>>>(p, D);
  }
  return cudaSuccess;
}

// the block route: scores, scan, weights (and the combine)
template <typename T, typename C, int D>
cudaError_t launch_blocked(const Params& p, cudaStream_t stream) {
  auto scores = paged_split_kernel<T, C, D, true, 1>;
  auto weights = paged_split_kernel<T, C, D, true, 2>;
  const Layout lay = layout(p.Hq / p.Hkv, D, (int)sizeof(C));
  cudaError_t err = cudaFuncSetAttribute(
      scores, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(weights, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.Hkv, p.S);
  scores<<<grid, NTHREADS, lay.total, stream>>>(p);
  paged_scan_kernel<<<dim3(p.Hkv, p.S), NTHREADS, 0, stream>>>(p);
  weights<<<grid, NTHREADS, lay.total, stream>>>(p);
  if (p.splits > 1) paged_combine_kernel<T, true><<<dim3(p.Hq, p.S), D, 0, stream>>>(p, D);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_blocked_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_blocked<T, C, 8>(p, stream);
    case 16: return launch_blocked<T, C, 16>(p, stream);
    case 32: return launch_blocked<T, C, 32>(p, stream);
    case 64: return launch_blocked<T, C, 64>(p, stream);
    case 128: return launch_blocked<T, C, 128>(p, stream);
    case 256: return launch_blocked<T, C, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename C, bool STAR>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, C, 8, STAR>(p, stream);
    case 16: return launch<T, C, 16, STAR>(p, stream);
    case 32: return launch<T, C, 32, STAR>(p, stream);
    case 64: return launch<T, C, 64, STAR>(p, stream);
    case 128: return launch<T, C, 128, STAR>(p, stream);
    case 256: return launch<T, C, 256, STAR>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename C>
cudaError_t launch_s(const Params& p, int d, cudaStream_t stream) {
  return p.lut != nullptr ? launch_d<T, C, true>(p, d, stream)
                          : launch_d<T, C, false>(p, d, stream);
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const void* tables, const void* valid, const void* lut,
                   const void* kscale, const void* vscale,
                   int S, int Hq, int Hkv, int W, int bs,
                   float sm_scale, float grid_scale, int num_levels,
                   void* ws, int splits) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.tables = static_cast<const int32_t*>(tables);
  p.valid = static_cast<const int32_t*>(valid);
  p.lut = static_cast<const float*>(lut);
  p.kscale = static_cast<const float*>(kscale);
  p.vscale = static_cast<const float*>(vscale);
  p.ws = static_cast<float*>(ws);
  p.jg = nullptr;
  p.pm = nullptr;
  p.S = S; p.Hq = Hq; p.Hkv = Hkv; p.W = W; p.bs = bs;
  p.splits = splits;
  p.sm_scale = sm_scale; p.grid_scale = grid_scale; p.num_levels = num_levels;
  return p;
}

// The shapes the kernels take: GQA groups up to MAXG, splits = max(1,
// ceil(W * bs / L)), a workspace when splits > 1.
bool bad_shape(int S, int Hq, int Hkv, int W, int bs, void* ws, int splits) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || bs <= 0 || S < 0 || W < 0) return true;
  if (S > 65535 || Hkv > 65535 || Hq > 65535) return true;
  const long long rows = (long long)W * bs;
  const long long need = rows > 0 ? (rows + SPLIT_ROWS - 1) / SPLIT_ROWS : 1;
  return splits != need || (splits > 1 && ws == nullptr);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  q/o are contiguous [S, Hq, D], pools
// contiguous [N, bs, Hkv, D] of q's type, q and pools 16-byte aligned,
// tables [S, W] and valid [S] int32.  ws: float32 workspace of
// S * Hq * splits * (D + 2) elements (unused, may be null, when splits == 1).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* tables, const void* valid, const void* lut,
    int S, int Hq, int Hkv, int W, int bs, int D, int dtype,
    float sm_scale, float grid_scale, int num_levels, void* stream,
    void* ws, int splits) {
  if (bad_shape(S, Hq, Hkv, W, bs, ws, splits)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, tables, valid, lut, nullptr, nullptr,
                               S, Hq, Hkv, W, bs, sm_scale, grid_scale, num_levels,
                               ws, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_s<float, float>(p, D, s);
  else if (dtype == 1)
    err = launch_s<__nv_bfloat16, __nv_bfloat16>(p, D, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The quantized variant: pools hold 1-byte codes (code: 0 = int8,
// 1 = fp8 e4m3), kscale / vscale are contiguous float32 [N, Hkv].
extern "C" int paged_attention_quant_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* tables, const void* valid, const void* lut,
    const void* kscale, const void* vscale,
    int S, int Hq, int Hkv, int W, int bs, int D, int dtype, int code,
    float sm_scale, float grid_scale, int num_levels, void* stream,
    void* ws, int splits) {
  if (bad_shape(S, Hq, Hkv, W, bs, ws, splits) || kscale == nullptr ||
      vscale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, tables, valid, lut, kscale, vscale,
                               S, Hq, Hkv, W, bs, sm_scale, grid_scale, num_levels,
                               ws, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && code == 0)
    err = launch_s<float, int8_t>(p, D, s);
  else if (dtype == 0 && code == 1)
    err = launch_s<float, __nv_fp8_e4m3>(p, D, s);
  else if (dtype == 1 && code == 0)
    err = launch_s<__nv_bfloat16, int8_t>(p, D, s);
  else if (dtype == 1 && code == 1)
    err = launch_s<__nv_bfloat16, __nv_fp8_e4m3>(p, D, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The block route (STAR, lut required), every pool: code -1 = pools of q's
// type, 0 = int8 and 1 = fp8 e4m3 codes (kscale / vscale as above).  ws:
// float32 workspace of S * Hq * (splits * (D + 2 + L) + 2 * W) elements,
// always (the partials, whose first S * Hq * splits * (D + 2) are unused
// when splits == 1, then the grid indices, then M_p and R_p).
extern "C" int paged_attention_blocked_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* tables, const void* valid, const void* lut,
    const void* kscale, const void* vscale,
    int S, int Hq, int Hkv, int W, int bs, int D, int dtype, int code,
    float sm_scale, float grid_scale, int num_levels, void* stream,
    void* ws, int splits) {
  if (bad_shape(S, Hq, Hkv, W, bs, ws, splits) || ws == nullptr || lut == nullptr ||
      num_levels < 1 || (code >= 0 && (kscale == nullptr || vscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  Params p = make_params(q, k, v, o, tables, valid, lut, kscale, vscale,
                         S, Hq, Hkv, W, bs, sm_scale, grid_scale, num_levels, ws, splits);
  const long long parts = (long long)S * Hq * splits * (D + 2);
  p.jg = reinterpret_cast<int*>(p.ws + parts);
  p.pm = p.jg + (long long)S * Hq * splits * SPLIT_ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && code == -1)
    err = launch_blocked_d<float, float>(p, D, s);
  else if (dtype == 1 && code == -1)
    err = launch_blocked_d<__nv_bfloat16, __nv_bfloat16>(p, D, s);
  else if (dtype == 0 && code == 0)
    err = launch_blocked_d<float, int8_t>(p, D, s);
  else if (dtype == 0 && code == 1)
    err = launch_blocked_d<float, __nv_fp8_e4m3>(p, D, s);
  else if (dtype == 1 && code == 0)
    err = launch_blocked_d<__nv_bfloat16, int8_t>(p, D, s);
  else if (dtype == 1 && code == 1)
    err = launch_blocked_d<__nv_bfloat16, __nv_fp8_e4m3>(p, D, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
