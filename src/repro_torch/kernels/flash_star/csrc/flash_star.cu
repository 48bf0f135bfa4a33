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

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the feature
// dimension must be contiguous.  Returns cudaGetLastError() after launch.
extern "C" int flash_star_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* info, const void* lut,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int B, int Hq, int Hkv, int Tq, int Tk, int D, int dtype,
    int causal, int window, float sm_scale, float grid_scale, int num_levels,
    void* stream) {
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
  cudaError_t err;
  if (dtype == 0)
    err = star ? launch_d<float, true>(p, D, s) : launch_d<float, false>(p, D, s);
  else if (dtype == 1)
    err = star ? launch_d<__nv_bfloat16, true>(p, D, s)
               : launch_d<__nv_bfloat16, false>(p, D, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
