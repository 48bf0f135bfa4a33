// paged_attention: gather-free paged decode attention over a block-pool KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_flash_attention / _kernel), both its fp-KV variant and its
// quantized variant (k_scale / v_scale: int8 or fp8_e4m3 pages).  The TPU grid
// (S, Hkv, W) walks one slot's pages in order through scalar-prefetched
// block tables and carries (m, l, acc) in VMEM; here one CTA owns one
// (slot, kv head), reads its own table row and walks only the
// ceil(kv_valid / bs) live pages in a loop.  The GQA head group (the
// Hq / Hkv query heads sharing the KV head) forms the rows of each score
// tile, as on the TPU.  Table entries past the live prefix (scratch block)
// are never read, and no gathered [S, W*bs, Hkv, D] copy exists anywhere.
//
// What bounds it on the H100: the bytes of the live K/V pages (one decode
// token per slot does 4 FLOP per byte read).  This first version loads up to
// 64 rows (whole pages) per step into shared memory with plain coalesced
// loads and one CTA per (slot, kv head); with few slots it fills few SMs and
// is latency-bound rather than bandwidth-bound.  Splitting a slot's pages
// over several CTAs (flash-decoding) is later work.
//
// Softmax arithmetic is the flash_star online form: STAR snaps each score to
// the int grid with rint (half to even), saturating to +-2^24 before the int
// cast (NaN -> sentinel); the running max is an int32; the rescale factor and
// probabilities are entries of the exp LUT passed in (nullptr = exact
// softmax).  A slot with kv_valid == 0 emits zeros (den <= 0 -> 1).  q is
// float32 or bfloat16; arithmetic is float32; output in q's type.
//
// Pools hold q's type, or (quantized variant) 1-byte codes, int8 or
// __nv_fp8_e4m3, with one float32 scale per (page, kv head) in [N, Hkv]
// scale pages.  The dequant happens on the load into shared memory: the CTA
// reads each step's page ids and their two scales once into shared memory
// and stores float(code) * scale, kvquant.decode's expression, so the
// operands equal the reference's dequantized K/V bit for bit (every int8
// and e4m3 value converts to float exactly).  The 1-byte pools halve the
// bytes read against bf16, which does not move this latency-bound first
// version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 16;       // largest GQA group
constexpr int TILE_ROWS = 64;  // KV rows loaded per step (whole pages)
constexpr int MAX_STEP_PAGES = TILE_ROWS;  // pages per step when bs == 1
constexpr int GRID_SENTINEL = -(1 << 24);
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename C> struct is_code { static constexpr bool value = false; };
template <> struct is_code<int8_t> { static constexpr bool value = true; };
template <> struct is_code<__nv_fp8_e4m3> { static constexpr bool value = true; };
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int snap(float s, float scale) {
  float v = rintf(s * scale);
  if (isnan(v)) v = (float)GRID_SENTINEL;
  v = fminf(fmaxf(v, (float)GRID_SENTINEL), (float)(-GRID_SENTINEL));
  return (int)v;
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
  int S, Hq, Hkv, W, bs, pages_per_step;
  float sm_scale, grid_scale;
  int num_levels;
};

// T: q / output type; C: pool element type (T, or an 8-bit code type).
template <typename T, typename C, int D, bool STAR>
__global__ void __launch_bounds__(NTHREADS) paged_kernel(Params p) {
  constexpr bool QUANT = is_code<C>::value;
  constexpr int ACC = (MAXG * D + NTHREADS - 1) / NTHREADS;
  extern __shared__ float smem[];
  const int G = p.Hq / p.Hkv;
  const int tile = p.pages_per_step * p.bs;
  float* Qs = smem;                  // [G][D]
  float* Ks = Qs + G * D;            // [tile][D + 1]
  float* Vs = Ks + tile * (D + 1);   // [tile][D]
  float* Ss = Vs + tile * D;         // [G][tile] scores, then probabilities
  __shared__ int m_sh[MAXG];
  __shared__ float mf_sh[MAXG], l_sh[MAXG], r_sh[MAXG];
  __shared__ int page_sh[MAX_STEP_PAGES];
  __shared__ float ks_sh[MAX_STEP_PAGES], vs_sh[MAX_STEP_PAGES];

  const int s = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qg = static_cast<const T*>(p.q) + ((long long)s * p.Hq + hk * G) * D;
  for (int idx = tid; idx < G * D; idx += NTHREADS) Qs[idx] = to_f32(qg[idx]);
  if (tid < G) {
    m_sh[tid] = GRID_SENTINEL;
    mf_sh[tid] = NEG_BIG;
    l_sh[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int kv_valid = max(p.valid[s], 0);
  const int pages = min((kv_valid + p.bs - 1) / p.bs, p.W);
  const int32_t* table = p.tables + (long long)s * p.W;
  const C* kpool = static_cast<const C*>(p.k);
  const C* vpool = static_cast<const C*>(p.v);
  const long long row_stride = (long long)p.Hkv * D;  // one token row of the pool

  for (int j0 = 0; j0 < pages; j0 += p.pages_per_step) {
    const int np = min(p.pages_per_step, pages - j0);
    const int rows = np * p.bs;
    __syncthreads();  // Qs / state ready; previous tile consumed
    for (int i = tid; i < np; i += NTHREADS) {
      const int page = table[j0 + i];
      page_sh[i] = page;
      if constexpr (QUANT) {
        ks_sh[i] = p.kscale[(long long)page * p.Hkv + hk];
        vs_sh[i] = p.vscale[(long long)page * p.Hkv + hk];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rows * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D, pi = r / p.bs;
      const long long page = page_sh[pi];
      const long long off = (page * p.bs + r % p.bs) * row_stride + hk * D + c;
      if constexpr (QUANT) {
        Ks[r * (D + 1) + c] = __fmul_rn(to_f32(kpool[off]), ks_sh[pi]);
        Vs[r * D + c] = __fmul_rn(to_f32(vpool[off]), vs_sh[pi]);
      } else {
        Ks[r * (D + 1) + c] = to_f32(kpool[off]);
        Vs[r * D + c] = to_f32(vpool[off]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * rows; idx += NTHREADS) {
      const int g = idx / rows, r = idx % rows;
      const float* qr = Qs + g * D;
      const float* kr = Ks + r * (D + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ss[g * tile + r] = dot * p.sm_scale;
    }
    __syncthreads();
    // one warp per head row: online softmax update over this tile
    for (int g = warp; g < G; g += NWARPS) {
      float* srow = Ss + g * tile;
      const int col0 = j0 * p.bs;
      float psum = 0.f, r;
      if constexpr (STAR) {
        const int top = p.num_levels - 1;
        int mb = GRID_SENTINEL;
        for (int c = lane; c < rows; c += 32)
          if (col0 + c < kv_valid) mb = max(mb, snap(srow[c], p.grid_scale));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        const int m_old = m_sh[g];
        const int m_new = max(m_old, mb);
        r = __ldg(p.lut + min(max(m_new - m_old, 0), top));
        for (int c = lane; c < rows; c += 32) {
          const float pv = col0 + c < kv_valid
              ? __ldg(p.lut + min(max(m_new - snap(srow[c], p.grid_scale), 0), top))
              : 0.f;
          srow[c] = pv;
          psum += pv;
        }
        __syncwarp();
        if (lane == 0) m_sh[g] = m_new;
      } else {
        float mb = NEG_BIG;
        for (int c = lane; c < rows; c += 32)
          mb = fmaxf(mb, col0 + c < kv_valid ? srow[c] : NEG_BIG);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        const float m_old = mf_sh[g];
        const float m_new = fmaxf(m_old, mb);
        r = expf(m_old - m_new);
        for (int c = lane; c < rows; c += 32) {
          const float pv = col0 + c < kv_valid ? expf(srow[c] - m_new) : 0.f;
          srow[c] = pv;
          psum += pv;
        }
        __syncwarp();
        if (lane == 0) mf_sh[g] = m_new;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        l_sh[g] = l_sh[g] * r + psum;
        r_sh[g] = r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int idx = tid + i * NTHREADS;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* prow = Ss + g * tile;
        float a = acc[i] * r_sh[g];
        for (int r = 0; r < rows; ++r) a = fmaf(prow[r], Vs[r * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* og = static_cast<T*>(p.o) + ((long long)s * p.Hq + hk * G) * D;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NTHREADS;
    if (idx < G * D) {
      const float l = l_sh[idx / D];
      og[idx] = from_f32<T>(acc[i] / (l <= 0.f ? 1.f : l));
    }
  }
}

template <typename T, typename C, int D, bool STAR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = paged_kernel<T, C, D, STAR>;
  const int G = p.Hq / p.Hkv;
  const int tile = p.pages_per_step * p.bs;
  const size_t bytes = sizeof(float) * (G * D + tile * (D + 1) + tile * D + G * tile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.S, p.Hkv);
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaSuccess;
}

template <typename T, typename C, bool STAR>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, C, 16, STAR>(p, stream);
    case 32: return launch<T, C, 32, STAR>(p, stream);
    case 64: return launch<T, C, 64, STAR>(p, stream);
    case 128: return launch<T, C, 128, STAR>(p, stream);
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
                   float sm_scale, float grid_scale, int num_levels) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.tables = static_cast<const int32_t*>(tables);
  p.valid = static_cast<const int32_t*>(valid);
  p.lut = static_cast<const float*>(lut);
  p.kscale = static_cast<const float*>(kscale);
  p.vscale = static_cast<const float*>(vscale);
  p.S = S; p.Hq = Hq; p.Hkv = Hkv; p.W = W; p.bs = bs;
  p.pages_per_step = bs >= TILE_ROWS ? 1 : TILE_ROWS / bs;
  p.sm_scale = sm_scale; p.grid_scale = grid_scale; p.num_levels = num_levels;
  return p;
}

bool bad_shape(int S, int Hq, int Hkv, int bs) {
  return Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || bs <= 0 || S < 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  q/o are contiguous [S, Hq, D], pools
// contiguous [N, bs, Hkv, D] of q's type, tables [S, W] and valid [S] int32.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* tables, const void* valid, const void* lut,
    int S, int Hq, int Hkv, int W, int bs, int D, int dtype,
    float sm_scale, float grid_scale, int num_levels, void* stream) {
  if (bad_shape(S, Hq, Hkv, bs)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, tables, valid, lut, nullptr, nullptr,
                               S, Hq, Hkv, W, bs, sm_scale, grid_scale, num_levels);
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
    float sm_scale, float grid_scale, int num_levels, void* stream) {
  if (bad_shape(S, Hq, Hkv, bs) || kscale == nullptr || vscale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, tables, valid, lut, kscale, vscale,
                               S, Hq, Hkv, W, bs, sm_scale, grid_scale, num_levels);
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
