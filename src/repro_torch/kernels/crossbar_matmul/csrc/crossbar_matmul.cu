// crossbar_matmul: the RRAM crossbar MatMul engine model's tiled ADC
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/crossbar_matmul/kernel.py
// (crossbar_matmul_pallas / _kernel).  Per 128x128 crossbar tile (k, n) the
// analog partial sum of quantized operands passes a 5-bit ADC,
//     adc = clip(rint(partial / step[k, n] + off[k, n]), +-adc_levels) * step[k, n],
// and the ADC outputs accumulate digitally over the K tiles in order.  The
// TPU grid (M/bm, N/128, K/128) runs K innermost and carries the sum in a
// VMEM scratch; here one CTA owns a [64, 128] output block and loops over
// the K tiles itself, so nothing carries between CTAs.
//
// Per K tile the CTA stages the [64, 128] x tile and the [128, 128] w tile in
// shared memory; each of 256 threads forms a 4 x 8 block of partial sums:
//   * int8 x int8 (the clean path) in int32, which is exact (|partial| <=
//     128 * 127 * 127 < 2^24, so its float value equals the TPU's float32 dot);
//   * otherwise (float32 faulty weights, int32 codes above 8 bits) in float32
//     with fused multiply-adds in a fixed r order.
// The ADC step is IEEE division, rint is half to even (jnp.round), and the
// multiply and the accumulate are separately rounded (__fmul_rn, __fadd_rn),
// so the clean path equals the plain version bit for bit.  Built without
// fast math.
//
// What bounds it on the H100: operations.  M x N x K multiply-adds (1.5e10 at
// [256, 4096] x [4096, 14336]) against 2 * M*N*K / 1979e12 s on the int8
// tensor cores (clean) or / 67e12 s on the FP32 units (faulty float32
// weights).  This first version runs scalar multiply-adds from shared memory
// (about 12 shared loads per 32 multiply-adds), far from the tensor-core
// bound; s8 mma.sync / wgmma on the clean path is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;      // crossbar rows (K) and columns (N) per tile
constexpr int BM = 64;         // x rows per CTA
constexpr int NTHREADS = 256;  // 16 x 16 threads, each a TM x TN block
constexpr int TM = 4;          // rows ty + 16 i
constexpr int TN = 8;          // columns tx + 16 j

template <typename XT, typename WT> struct AccOf { using type = float; };
template <> struct AccOf<int8_t, int8_t> { using type = int; };

__device__ __forceinline__ void mac(int& acc, int a, int b) { acc += a * b; }
__device__ __forceinline__ void mac(float& acc, float a, float b) { acc = fmaf(a, b, acc); }

template <typename XT, typename WT>
__global__ void __launch_bounds__(NTHREADS) crossbar_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, const float* __restrict__ step,
    const float* __restrict__ off, float* __restrict__ out, int M, int K, int N,
    int adc_levels) {
  using Acc = typename AccOf<XT, WT>::type;
  constexpr int XS = TILE + 4 / (int)sizeof(XT);  // padded x row: rows ty, ty+1 on other banks
  extern __shared__ __align__(16) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem);                            // [BM][XS]
  WT* ws = reinterpret_cast<WT*>(smem + BM * XS * sizeof(XT));     // [TILE][TILE]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM, nt = blockIdx.y, col0 = nt * TILE;
  const int Kt = K / TILE, Nt = N / TILE;
  const float lim = (float)adc_levels;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < Kt; ++kt) {
    for (int e = threadIdx.x; e < BM * TILE; e += NTHREADS) {
      const int r = e / TILE, c = e % TILE, gr = row0 + r;
      xs[r * XS + c] = gr < M ? x[(long long)gr * K + kt * TILE + c] : XT(0);
    }
    for (int e = threadIdx.x; e < TILE * TILE; e += NTHREADS) {
      const int r = e / TILE, c = e % TILE;
      ws[e] = w[(long long)(kt * TILE + r) * N + col0 + c];
    }
    __syncthreads();

    Acc part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = Acc(0);
    for (int r = 0; r < TILE; ++r) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (Acc)xs[(ty + 16 * i) * XS + r];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (Acc)ws[r * TILE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mac(part[i][j], a[i], b[j]);
    }

    const float st = step[kt * Nt + nt];
    const float o = off != nullptr ? off[kt * Nt + nt] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float code = __fdiv_rn((float)part[i][j], st);
        if (off != nullptr) code = __fadd_rn(code, o);
        const float q = fminf(fmaxf(rintf(code), -lim), lim);
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(q, st));
      }
    __syncthreads();  // the tiles are overwritten next
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) out[(long long)gr * N + col0 + tx + 16 * j] = acc[i][j];
  }
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* w, const float* step, const float* off,
                   float* out, int M, int K, int N, int adc_levels, cudaStream_t s) {
  constexpr int XS = TILE + 4 / (int)sizeof(XT);
  const size_t smem = BM * XS * sizeof(XT) + (size_t)TILE * TILE * sizeof(WT);
  auto kernel = crossbar_kernel<XT, WT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((M + BM - 1) / BM, N / TILE);
  kernel<<<grid, NTHREADS, smem, s>>>(static_cast<const XT*>(x), static_cast<const WT*>(w),
                                      step, off, out, M, K, N, adc_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq [M, K] row-major (x_type 0 = int8, 1 = int32), wq [K, N] row-major
// (w_type 0 = int8, 1 = int32, 2 = float32), step / off float32 [K/128, N/128]
// (off may be null), out float32 [M, N].  K and N are multiples of 128.
// Returns cudaGetLastError() after the launch.
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
    err = launch<int8_t, int8_t>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 0 && w_type == 2)
    err = launch<int8_t, float>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 1 && w_type == 1)
    err = launch<int32_t, int32_t>(x, w, st, of, o, M, K, N, adc_levels, s);
  else if (x_type == 1 && w_type == 2)
    err = launch<int32_t, float>(x, w, st, of, o, M, K, N, adc_levels, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
