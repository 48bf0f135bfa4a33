// flash_star: fused causal/ragged attention with the STAR integer-grid
// online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_star/kernel.py
// (flash_star_attention / _kernel).  The TPU grid (B, Hq, nq, nk) runs its
// innermost KV axis in order and carries (m, l, acc) in VMEM scratch; here
// one CTA owns one (batch, q head, 64-row q block) and walks the KV blocks
// in a loop, so nothing carries between CTAs.
//
// What bounds it on the H100: the QK^T and P.V products (about 2 GFLOP for
// one 512-token causal prefill at 32 heads, D=128).  This first version does
// them with float32 FMAs from shared memory, not with tensor cores, so it is
// bound by the SMs' FP32 and shared-memory rates, far above the card's
// bf16 tensor-core bound; a wgmma/TMA version is later work.  The design
// keeps the operand traffic at one read of q and of each K/V tile per CTA,
// skips whole KV tiles outside the causal / window / ragged range, and
// never writes the score matrix to device memory.
//
// STAR arithmetic matches the TPU kernel: score s = (q.k) * sm_scale snaps
// to j = rint(s * 2^frac) (round half to even, as jnp.round), saturated to
// [GRID_SENTINEL, -GRID_SENTINEL] before the int cast (NaN -> sentinel) so an
// infinite score cannot wrap; the running max is an int32, and both the
// rescale factor and the probabilities are entries of the exp LUT
// (core/lut.py) that the wrapper passes in.  lut == nullptr selects the
// exact float softmax.  Inputs are float32 or bfloat16; all arithmetic is
// float32; the output has the input's type.  Built without fast math.
//
// The int8 P.V variant (pv_int8=True in the TPU kernel, kernel.py:129-141)
// is a second kernel, flash_star_pv_int8_kernel, below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per CTA
constexpr int BK = 32;         // KV rows per tile
constexpr int NTHREADS = 128;  // two threads per q row
constexpr int GRID_SENTINEL = -(1 << 24);
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round(s * scale) on the signed grid, saturated, NaN -> sentinel.
__device__ __forceinline__ int snap(float s, float scale) {
  float v = rintf(s * scale);
  if (isnan(v)) v = (float)GRID_SENTINEL;
  v = fminf(fmaxf(v, (float)GRID_SENTINEL), (float)(-GRID_SENTINEL));
  return (int)v;
}

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

template <typename T, int D, bool STAR>
__global__ void __launch_bounds__(NTHREADS) flash_star_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int row = tid >> 1;    // local q row
  const int half = tid & 1;    // this thread's column / feature parity
  const int q_offset = p.info[0];
  const int kv_valid = min(p.info[1 + b], p.Tk);
  const int row0 = iq * BQ + q_offset;  // absolute position of local row 0
  const int pos = row0 + row;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D, t = iq * BQ + r;
    Qs[r * (D + 1) + c] = t < p.Tq ? to_f32(qg[t * p.q_st + c]) : 0.f;
  }

  int m_i = GRID_SENTINEL;  // running grid max (STAR)
  float m_f = NEG_BIG;      // running max (exact)
  float l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // KV tiles that can hold a live column for some row of this CTA.
  int kv_end = kv_valid;
  if (p.causal) kv_end = min(kv_end, row0 + BQ);
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, row0 - p.window + 1) / BK * BK;

  for (int c0 = kv_start; c0 < kv_end; c0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs loaded)
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D, t = c0 + r;
      const bool in = t < p.Tk;
      Ks[r * (D + 1) + c] = in ? to_f32(kg[t * p.k_st + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vg[t * p.v_st + c]) : 0.f;
    }
    __syncthreads();

    float sc[BK / 2];
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) sc[jj] = 0.f;
    const float* qrow = Qs + row * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj)
        sc[jj] = fmaf(qd, Ks[(half + 2 * jj) * (D + 1) + d], sc[jj]);
    }

    unsigned live = 0;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int col = c0 + half + 2 * jj;
      bool ok = col < kv_valid;
      if (p.causal) ok = ok && col <= pos;
      if (p.window > 0) ok = ok && col > pos - p.window;
      if (ok) live |= 1u << jj;
      sc[jj] *= p.sm_scale;
    }

    float r, psum = 0.f;
    float* prow = Ps + row * (BK + 1);
    if constexpr (STAR) {
      const int top = p.num_levels - 1;
      int jg[BK / 2];
      int mb = GRID_SENTINEL;
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        jg[jj] = (live >> jj & 1u) ? snap(sc[jj], p.grid_scale) : GRID_SENTINEL;
        mb = max(mb, jg[jj]);
      }
      mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      const int m_new = max(m_i, mb);
      r = __ldg(p.lut + min(max(m_new - m_i, 0), top));
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const float pv = (live >> jj & 1u)
            ? __ldg(p.lut + min(max(m_new - jg[jj], 0), top)) : 0.f;
        prow[half + 2 * jj] = pv;
        psum += pv;
      }
      m_i = m_new;
    } else {
      float mb = NEG_BIG;
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        if (!(live >> jj & 1u)) sc[jj] = NEG_BIG;
        mb = fmaxf(mb, sc[jj]);
      }
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      const float m_new = fmaxf(m_f, mb);
      r = expf(m_f - m_new);
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const float pv = (live >> jj & 1u) ? expf(sc[jj] - m_new) : 0.f;
        prow[half + 2 * jj] = pv;
        psum += pv;
      }
      m_f = m_new;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * r + psum;
    __syncthreads();  // the pair's probabilities are in Ps

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= r;
    for (int j = 0; j < BK; ++j) {
      const float pj = prow[j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(pj, Vs[j * D + half + 2 * i], acc[i]);
    }
  }

  const int t = iq * BQ + row;
  if (t < p.Tq) {
    const float den = l <= 0.f ? 1.f : l;
    T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) og[half + 2 * i] = from_f32<T>(acc[i] / den);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, bool STAR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_star_kernel<T, D, STAR>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaSuccess;
}

template <typename T, bool STAR>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, STAR>(p, stream);
    case 32: return launch<T, 32, STAR>(p, stream);
    case 64: return launch<T, 64, STAR>(p, stream);
    case 128: return launch<T, 128, STAR>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The int8 P.V variant.  Per KV block of bk rows (the TPU kernel's block_k,
// bk <= BK8) the TPU kernel quantizes
//   p8 = rint(p * 127)                 against the running max after the block,
//   v8 = rint(v * (127 / vamax)),      vamax = max(max |V_block|, 1e-6),
// and adds float(sum p8 * v8 as int32) * (vamax / 16129) to the accumulator,
// while the denominator sums the unquantized p.  Both codes depend on the
// block: P's through the running max (a max taken after 32 rows would give
// other codes than one taken after bk rows) and V's through the block's
// absmax, which runs over all bk x D values, rows past kv_valid included (the
// zero rows that pad Tk to a multiple of bk change nothing).  So this kernel
// walks KV in blocks of exactly bk rows from row 0: it forms a whole block's
// scores (in 32-row K sub-tiles) before it takes the block's max, quantizes
// V into shared memory as int8 (transposed, four rows to a 32-bit word),
// packs each row's p8 likewise, and accumulates with __dp4a in int32,
// converting to float once per block.  The quantizing multiply and the
// rescale are __fmul_rn / __fadd_rn: never contracted into an FMA.
//
// What bounds it: the same QK^T work as the float kernel (FP32 FMAs here)
// plus int8 products that the card's int8 tensor cores would do at
// 1979 TOP/s; dp4a on the SMs' integer units is the simple first step
// (an s8 mma.sync / wgmma version is later work).  One CTA owns 64 q rows
// with four threads per row; a row's four threads split the block's
// columns for the scores and p8, and the head dimension for P.V.

constexpr int BK8 = 128;         // largest KV block of the variant
constexpr int KT = 32;           // K rows per sub-tile
constexpr int NT8 = 256;         // four threads per q row
constexpr int W8 = BK8 / 4 + 1;  // 32-bit words per packed row (+1: banks)

template <int D>
constexpr size_t smem_bytes_int8() {
  return sizeof(float) * (BQ * (D + 1) + KT * (D + 1) + BQ * (BK8 + 1)) +
         sizeof(int) * (D * W8 + BQ * W8) + sizeof(float) * (NT8 / 32);
}

template <typename T, int D, bool STAR>
__global__ void __launch_bounds__(NT8) flash_star_pv_int8_kernel(Params p, int bk) {
  extern __shared__ float smem[];
  float* Qs = smem;                                       // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);                          // [KT][D + 1]
  float* Ss = Ks + KT * (D + 1);                          // [BQ][BK8 + 1] scaled scores
  int* V8 = reinterpret_cast<int*>(Ss + BQ * (BK8 + 1));  // [D][W8] packed v8 codes
  int* P8 = V8 + D * W8;                                  // [BQ][W8] packed p8 codes
  float* red = reinterpret_cast<float*>(P8 + BQ * W8);    // [NT8 / 32]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2;  // local q row
  const int qt = tid & 3;    // this thread's quarter of the row
  const int q_offset = p.info[0];
  const int kv_valid = p.info[1 + b];
  const int kv_lim = min(kv_valid, p.Tk);
  const int row0 = iq * BQ + q_offset;
  const int pos = row0 + row;
  const int nw = (bk + 3) / 4;  // packed words per block row

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT8) {
    const int r = idx / D, c = idx % D, t = iq * BQ + r;
    Qs[r * (D + 1) + c] = t < p.Tq ? to_f32(qg[t * p.q_st + c]) : 0.f;
  }

  int m_i = GRID_SENTINEL;
  float m_f = NEG_BIG;
  float l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  // the blocks the TPU kernel's block-level test can find live for some row
  // of this CTA (a block it skips for a row contributes p = 0 and r = 1 there)
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, row0 + BQ);
  int kb = 0;
  if (p.window > 0) kb = max(0, row0 - p.window + 1) / bk;

  for (int c0 = kb * bk; c0 < kv_end; c0 += bk) {
    const int rows = min(bk, p.Tk - c0);  // rows of the block inside Tk
    __syncthreads();  // the previous block is done with V8, P8, Ss and red (and Qs loaded)

    // V: the block's absmax, then its int8 codes, transposed and packed
    float vmax = 0.f;
    for (int idx = tid; idx < rows * D; idx += NT8) {
      const int r = idx / D, c = idx % D;
      vmax = fmaxf(vmax, fabsf(to_f32(vg[(c0 + r) * p.v_st + c])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0) red[warp] = vmax;
    __syncthreads();
    float vamax = red[0];
#pragma unroll
    for (int w = 1; w < NT8 / 32; ++w) vamax = fmaxf(vamax, red[w]);
    vamax = fmaxf(vamax, 1e-6f);
    const float vq = 127.f / vamax;
    int8_t* v8b = reinterpret_cast<int8_t*>(V8);
    for (int idx = tid; idx < 4 * nw * D; idx += NT8) {
      const int r = idx / D, c = idx % D;
      const float v = r < rows ? to_f32(vg[(c0 + r) * p.v_st + c]) : 0.f;
      v8b[c * (4 * W8) + r] = (int8_t)(int)rintf(__fmul_rn(v, vq));
    }

    // scores of the whole block, KT K rows at a time
    for (int s0 = 0; s0 < bk; s0 += KT) {
      if (s0 > 0) __syncthreads();  // the previous sub-tile is consumed
      for (int idx = tid; idx < KT * D; idx += NT8) {
        const int r = idx / D, c = idx % D, t = c0 + s0 + r;
        Ks[r * (D + 1) + c] = (s0 + r < bk && t < p.Tk) ? to_f32(kg[t * p.k_st + c]) : 0.f;
      }
      __syncthreads();
      const float* qrow = Qs + row * (D + 1);
#pragma unroll
      for (int jj = 0; jj < KT / 4; ++jj) {
        const int j = s0 + qt + 4 * jj;
        if (j < bk) {
          const float* krow = Ks + (qt + 4 * jj) * (D + 1);
          float sc = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) sc = fmaf(qrow[d], krow[d], sc);
          Ss[row * (BK8 + 1) + j] = sc * p.sm_scale;
        }
      }
    }
    __syncthreads();  // a row's scores come from its four threads

    // the block max, p and the packed p8 (this thread: words qt, qt + 4, ...)
    const float* srow = Ss + row * (BK8 + 1);
    auto live = [&](int j) {
      const int col = c0 + j;
      bool ok = j < rows && col < kv_lim;
      if (p.causal) ok = ok && col <= pos;
      if (p.window > 0) ok = ok && col > pos - p.window;
      return ok;
    };
    float r, psum = 0.f;
    if constexpr (STAR) {
      const int top = p.num_levels - 1;
      int mb = GRID_SENTINEL;
      for (int w = qt; w < nw; w += 4)
        for (int k = 0; k < 4; ++k)
          if (live(4 * w + k)) mb = max(mb, snap(srow[4 * w + k], p.grid_scale));
      mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const int m_new = max(m_i, mb);
      r = __ldg(p.lut + min(max(m_new - m_i, 0), top));
      for (int w = qt; w < nw; w += 4) {
        unsigned word = 0;
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * w + k;
          float pj = 0.f;
          if (live(j)) pj = __ldg(p.lut + min(max(m_new - snap(srow[j], p.grid_scale), 0), top));
          psum += pj;
          word |= ((unsigned)(int)rintf(__fmul_rn(pj, 127.f)) & 0xffu) << (8 * k);
        }
        P8[row * W8 + w] = (int)word;
      }
      m_i = m_new;
    } else {
      float mb = NEG_BIG;
      for (int w = qt; w < nw; w += 4)
        for (int k = 0; k < 4; ++k)
          if (live(4 * w + k)) mb = fmaxf(mb, srow[4 * w + k]);
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float m_new = fmaxf(m_f, mb);
      r = expf(m_f - m_new);
      for (int w = qt; w < nw; w += 4) {
        unsigned word = 0;
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * w + k;
          const float pj = live(j) ? expf(srow[j] - m_new) : 0.f;
          psum += pj;
          word |= ((unsigned)(int)rintf(__fmul_rn(pj, 127.f)) & 0xffu) << (8 * k);
        }
        P8[row * W8 + w] = (int)word;
      }
      m_f = m_new;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = __fadd_rn(__fmul_rn(l, r), psum);
    __syncthreads();  // P8 and V8 complete

    // P.V in int32 over the block; this thread's features qt + 4 i
    int part[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) part[i] = 0;
    const int* prow = P8 + row * W8;
    for (int w = 0; w < nw; ++w) {
      const int pw = prow[w];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) part[i] = __dp4a(pw, V8[(qt + 4 * i) * W8 + w], part[i]);
    }
    const float vs = vamax / 16129.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      acc[i] = __fadd_rn(__fmul_rn(acc[i], r), __fmul_rn((float)part[i], vs));
  }

  const int t = iq * BQ + row;
  if (t < p.Tq) {
    const float den = l <= 0.f ? 1.f : l;
    T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) og[qt + 4 * i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int D, bool STAR>
cudaError_t launch_int8(const Params& p, int bk, cudaStream_t stream) {
  auto kernel = flash_star_pv_int8_kernel<T, D, STAR>;
  constexpr size_t bytes = smem_bytes_int8<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  kernel<<<grid, NT8, bytes, stream>>>(p, bk);
  return cudaSuccess;
}

template <typename T, bool STAR>
cudaError_t launch_int8_d(const Params& p, int d, int bk, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_int8<T, 16, STAR>(p, bk, stream);
    case 32: return launch_int8<T, 32, STAR>(p, bk, stream);
    case 64: return launch_int8<T, 64, STAR>(p, bk, stream);
    case 128: return launch_int8<T, 128, STAR>(p, bk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the feature
// dimension must be contiguous.  pv_int8_bk > 0 selects the int8 P.V
// variant over KV blocks of that many rows (1 .. 128).  Returns
// cudaGetLastError() after launch.
extern "C" int flash_star_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* info, const void* lut,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int B, int Hq, int Hkv, int Tq, int Tk, int D, int dtype,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    int pv_int8_bk, void* stream) {
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
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool star = lut != nullptr;
  const int bk = pv_int8_bk;
  cudaError_t err;
  if (bk < 0 || bk > BK8 || (dtype != 0 && dtype != 1))
    err = cudaErrorInvalidValue;
  else if (bk > 0 && dtype == 0)
    err = star ? launch_int8_d<float, true>(p, D, bk, s)
               : launch_int8_d<float, false>(p, D, bk, s);
  else if (bk > 0)
    err = star ? launch_int8_d<__nv_bfloat16, true>(p, D, bk, s)
               : launch_int8_d<__nv_bfloat16, false>(p, D, bk, s);
  else if (dtype == 0)
    err = star ? launch_d<float, true>(p, D, s) : launch_d<float, false>(p, D, s);
  else
    err = star ? launch_d<__nv_bfloat16, true>(p, D, s)
               : launch_d<__nv_bfloat16, false>(p, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
