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
// one 512-token causal prefill at 32 heads, D=128).  The first kernel below,
// which now serves float32 inputs only, does them with float32 FMAs from
// shared memory, bound by the SMs' FP32 and shared-memory rates; bfloat16
// inputs run on the tensor cores (flash_star_mma_kernel).  The design
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
// exact float softmax.  All softmax arithmetic is float32; the output has
// the input's type.  Built without fast math.
//
// Three kernels, chosen by type (the wrapper routes; each entry point
// refuses the others' types):
//   flash_star_kernel<float>      float32 q/k/v: FP32 FMAs (this first one);
//   flash_star_mma_kernel         bfloat16 q/k/v: tensor cores (mma.sync),
//                                 entry point flash_star_mma_launch;
//   flash_star_pv_int8_kernel     the int8 P.V variant (pv_int8=True in the
//                                 TPU kernel, kernel.py:129-141), either type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
// Design (FlashAttention-2's shape): one CTA of 4 warps owns (batch, q
// head, 64 q rows), 16 rows per warp.  The grid is one-dimensional and
// hands out the longest causal rows first; when it is one wave of two CTAs
// per SM, the second CTA of each SM takes the lightest rows left, so heavy
// and light q blocks share an SM.  Each warp keeps its Q fragments in
// registers (ldmatrix once).  K and V tiles of 64 rows pass through a
// two-stage ring in shared memory filled by 16-byte cp.async copies (rows
// past Tk zero-filled): tile i + 1 loads while tile i computes, and the
// first tile's V lands while its QK^T runs.  Rows are padded by 16 bytes, so
// the eight row addresses of each ldmatrix (K) and ldmatrix.trans (V) fall
// on distinct banks.  Tiles outside the causal / window / ragged range are
// skipped by the CTA, and by a warp whose 16 rows see none of the tile; the
// mask is built only in tiles that are not wholly live for the warp, and a
// row whose max held (r == 1 exactly) skips the rescale.  mma.sync.m16n8k16
// (bf16 in, float32 accumulators) is far faster than this shape needs;
// wgmma with TMA is the step after, once a profile shows the tensor pipe as
// the limit.  On an H100 80GB HBM3 at 700 W it runs ~27 us at the shape
// above, ~9x its bound: each warp streams the whole K and V tile from shared memory
// for its 16 rows, and startup, softmax and P.V's three products each take
// a share (PERF.md).
//
// Arithmetic, as the reference's: bf16 x bf16 products are exact in
// float32, so QK^T differs from the float32 dot only in the order of its
// sums.  Then s = fl(acc * sm_scale), a separate multiply (sm_scale and
// log2(e) are not folded into q or into an exp2: the grid index is
// rint(fl(s * grid_scale)) as in the plain version), masked entries never
// enter the max and give p = 0.  STAR: the int32 row max is reduced across
// the four threads that share a row of the accumulator fragment, r and p
// are entries of the LUT (held in shared memory up to LUT_SMEM_MAX
// levels).  Exact: expf, no fast math.  P is float32 (a LUT entry or an
// expf), and rounding it to bf16 would break the outputs' float32 rounding,
// so each p is split in registers into three bf16 pieces, hi = bf16(p),
// mid = bf16(p - hi), lo = bf16(p - hi - mid), which sum to p exactly for
// p >= 2^-100 (within 2^-134 below; ref.split_bf16x3 is the plain copy);
// V is bf16 already, so three mma's into one float32 accumulator give the
// float32 P.V up to the order of its sums.  The A operands come straight
// from the score accumulators' registers.  The row sum adds the unsplit p,
// the accumulator is rescaled by r before the tile's P.V, and the epilogue
// divides by den = (l <= 0 ? 1 : l) (a true division) and rounds to bf16.

constexpr int MQ = 64;              // q rows per CTA, 16 per warp
constexpr int MK = 64;              // KV rows per tile
constexpr int MT = 128;             // four warps
constexpr int MSTAGES = 2;          // K/V ring depth
constexpr int LUT_SMEM_MAX = 4096;  // larger LUTs are read from global memory

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)));
}

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

template <int D>
constexpr size_t smem_bytes_mma() {
  return sizeof(__nv_bfloat16) * (MQ + 2 * MSTAGES * MK) * (D + 8);
}

// snap's grid index with one F2I.RNI: rint(s * scale) saturated to the
// sentinel range, NaN -> sentinel (fmaxf returns the bound for a NaN)
__device__ __forceinline__ int snap_rn(float s, float scale) {
  const float lim = static_cast<float>(-GRID_SENTINEL);
  return __float2int_rn(fminf(fmaxf(s * scale, -lim), lim));
}

// minBlocks 1: without it ptxas caps small-D instantiations at 128
// registers (four CTAs an SM) and spills
template <int D, bool STAR>
__global__ void __launch_bounds__(MT, 1) flash_star_mma_kernel(Params p, int first_round) {
  constexpr int PITCH = D + 8;    // bf16 per shared row: 16 bytes of padding
  constexpr int TILE = MK * PITCH;
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr int NS = MK / 8;      // score n-tiles per warp
  constexpr int NO = D / 8;       // output n-tiles per warp
  constexpr int VG = D >= 32 ? 2 : 1;  // V column groups per P.V step
  constexpr int QK_STEPS = (D / 16) * (NS / 2);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MQ][PITCH]
  __nv_bfloat16* ring = Qs + MQ * PITCH;  // stage s: K at ring + 2 s TILE, V after it
  float* lut_s = reinterpret_cast<float*>(ring + 2 * MSTAGES * TILE);

  // Block -> (q block, head, batch), the longest causal rows first.  When
  // the grid is one wave of two CTAs per SM, the second CTA of each SM
  // (blocks from first_round on, dispatched in the first round's SM order)
  // takes the lightest remaining work, so heavy and light q blocks pair up.
  const int nq = (p.Tq + MQ - 1) / MQ, hb = p.Hq * p.B;
  const int blk = blockIdx.x;
  const int rank = first_round > 0 && blk >= first_round
      ? static_cast<int>(gridDim.x) - 1 - (blk - first_round) : blk;
  const int iq = nq - 1 - rank / hb;
  const int h = rank % hb % p.Hq, b = rank % hb / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  const int q_offset = p.info[0];
  const int kv_lim = min(p.info[1 + b], p.Tk);
  const int row0 = iq * MQ + q_offset;  // absolute position of the CTA's row 0
  const int wr0 = row0 + warp * 16;     // ... of the warp's row 0

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

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
      const bool in = c0 + r_t + i * RS < p.Tk;
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
      const bool in = t < p.Tq;
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

  uint32_t qa[D / 16][4];
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
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH +
                            16 * kk + 8 * (lane >> 4));
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
      // ahead of their products.
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
        mma_bf16(s[j], qa[kk], kb[step & 1][0], kb[step & 1][1]);
        mma_bf16(s[j + 1], qa[kk], kb[step & 1][2], kb[step & 1][3]);
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
    auto softmax = [&](auto full_tile) {
      constexpr bool FULL = decltype(full_tile)::value;
      // element e of n-tile j is column c0 + 2 tg + 8 j + (e & 1)
      int dlo[2] = {0, 0}, dhi[2] = {0, 0};
      if constexpr (!FULL) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          dlo[hr] = lo[hr] - c0 - 2 * tg;
          dhi[hr] = hi[hr] - c0 - 2 * tg;
        }
      }
      auto is_live = [&](int j, int e) {
        const int c = 8 * j + (e & 1);
        return FULL || (c >= dlo[e >> 1] && c <= dhi[e >> 1]);
      };
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], p.sm_scale);
      if constexpr (STAR) {
        const int top = p.num_levels - 1;
        int jg[NS][4];
        int mb[2] = {GRID_SENTINEL, GRID_SENTINEL};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            jg[j][e] = is_live(j, e) ? snap_rn(s[j][e], p.grid_scale) : GRID_SENTINEL;
            mb[e >> 1] = max(mb[e >> 1], jg[j][e]);
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mb[hr] = max(mb[hr], __shfl_xor_sync(0xffffffffu, mb[hr], 1));
          mb[hr] = max(mb[hr], __shfl_xor_sync(0xffffffffu, mb[hr], 2));
          const int m_new = max(m_i[hr], mb[hr]);
          r[hr] = lut[min(m_new - m_i[hr], top)];  // m_new >= m_i
          m_i[hr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)  // a live j is at most the row max
            s[j][e] = is_live(j, e) ? lut[min(m_i[e >> 1] - jg[j][e], top)] : 0.f;
      } else {
        float mb[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!is_live(j, e)) s[j][e] = NEG_BIG;
            mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mb[hr] = fmaxf(mb[hr], __shfl_xor_sync(0xffffffffu, mb[hr], 1));
          mb[hr] = fmaxf(mb[hr], __shfl_xor_sync(0xffffffffu, mb[hr], 2));
          const float m_new = fmaxf(m_f[hr], mb[hr]);
          r[hr] = expf(__fsub_rn(m_f[hr], m_new));
          m_f[hr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = is_live(j, e) ? expf(__fsub_rn(s[j][e], m_f[e >> 1])) : 0.f;
      }
    };
    // every column of the tile is live for every row of the warp
    const bool full = c0 + MK <= kv_lim && (!p.causal || c0 + MK - 1 <= wr0) &&
                      (p.window <= 0 || c0 > wr0 + 15 - p.window);
    if (full)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[e >> 1] = __fadd_rn(ps[e >> 1], s[j][e]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = __fadd_rn(__fmul_rn(l[hr], r[hr]), ps[hr]);
    // a row whose max held has r == 1 exactly: its accumulator stays as it is
    if (__any_sync(0xffffffffu, r[0] != 1.f || r[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] = __fmul_rn(o[n][0], r[0]);
        o[n][1] = __fmul_rn(o[n][1], r[0]);
        o[n][2] = __fmul_rn(o[n][2], r[1]);
        o[n][3] = __fmul_rn(o[n][3], r[1]);
      }
    }

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

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float den = l[hr];
    den = __fadd_rn(den, __shfl_xor_sync(0xffffffffu, den, 1));
    den = __fadd_rn(den, __shfl_xor_sync(0xffffffffu, den, 2));
    if (den <= 0.f) den = 1.f;
    const int t = iq * MQ + warp * 16 + g + 8 * hr;
    if (t < p.Tq) {
      __nv_bfloat16* orow = og + t * p.o_st + 2 * tg;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(__fdiv_rn(o[n][2 * hr], den), __fdiv_rn(o[n][2 * hr + 1], den));
    }
  }
}

template <int D, bool STAR>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  auto kernel = flash_star_mma_kernel<D, STAR>;
  size_t bytes = smem_bytes_mma<D>();
  if (STAR && p.num_levels <= LUT_SMEM_MAX) bytes += sizeof(float) * p.num_levels;
  // once per device: the largest shared-memory request of this
  // instantiation (it bounds what a launch may ask; occupancy follows what
  // it does ask), the SM count and the CTAs an SM holds at that request
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {}, per_sm[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    const int most = (int)(smem_bytes_mma<D>() + (STAR ? sizeof(float) * LUT_SMEM_MAX : 0));
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
    per_sm[dev] = n_cta;
    sms[dev] = n_sm;
  }
  const long long blocks = (long long)((p.Tq + MQ - 1) / MQ) * p.Hq * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // pair heavy and light CTAs only in a causal grid of one wave of two per SM
  const int first_round =
      p.causal && per_sm[dev] == 2 && blocks > sms[dev] && blocks <= 2LL * sms[dev] ? sms[dev] : 0;
  kernel<<<(unsigned)blocks, MT, bytes, stream>>>(p, first_round);
  return cudaSuccess;
}

template <bool STAR>
cudaError_t launch_mma_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16, STAR>(p, stream);
    case 32: return launch_mma<32, STAR>(p, stream);
    case 64: return launch_mma<64, STAR>(p, stream);
    case 128: return launch_mma<128, STAR>(p, stream);
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

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the feature
// dimension must be contiguous.  pv_int8_bk > 0 selects the int8 P.V
// variant over KV blocks of that many rows (1 .. 128), either type; with
// pv_int8_bk == 0 this entry point takes float32 only (bfloat16 goes to
// flash_star_mma_launch).  Returns cudaGetLastError() after launch.
extern "C" int flash_star_launch(
    FLASH_STAR_ARGS, int dtype,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    int pv_int8_bk, void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool star = lut != nullptr;
  const int bk = pv_int8_bk;
  cudaError_t err;
  if (bk < 0 || bk > BK8 || (dtype != 0 && dtype != 1) || (bk == 0 && dtype != 0))
    err = cudaErrorInvalidValue;
  else if (bk > 0 && dtype == 0)
    err = star ? launch_int8_d<float, true>(p, D, bk, s)
               : launch_int8_d<float, false>(p, D, bk, s);
  else if (bk > 0)
    err = star ? launch_int8_d<__nv_bfloat16, true>(p, D, bk, s)
               : launch_int8_d<__nv_bfloat16, false>(p, D, bk, s);
  else
    err = star ? launch_d<float, true>(p, D, s) : launch_d<float, false>(p, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// bfloat16 q/k/v/o, pv_int8 off: the tensor-core kernel.  Strides are in
// elements; the base pointers and the batch, head and T strides must be
// multiples of 16 bytes (the wrapper checks), the feature dimension
// contiguous.  Returns cudaGetLastError() after launch.
extern "C" int flash_star_mma_launch(
    FLASH_STAR_ARGS,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    void* stream) {
  const Params p = FLASH_STAR_PARAMS;
  if (Tq <= 0 || B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = lut != nullptr ? launch_mma_d<true>(p, D, s)
                                         : launch_mma_d<false>(p, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
