// ssd_scan: the fused SSD (state-space duality) chunk scan of the mamba2
// mixer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_pallas / _kernel).  Per chunk of Q steps, with ca the inclusive
// cumsum of the log-decay a inside the chunk and last = ca[Q-1]:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(ca_i - ca_j) x[j]   (intra-chunk)
//         + exp(ca_i) C_i h_prev                           (inter-chunk)
//   h_new = exp(last) h_prev + sum_j exp(last - ca_j) B_j x[j]^T
// The TPU grid (batch, chunks) runs the chunks in order and carries the
// whole [H, N, P] state in VMEM scratch (786 KB at mamba2-130m widths, more
// than a CTA's shared memory).  Heads are independent apart from sharing B
// and C, so here one CTA owns one (batch, head, slice of up to 64 head-dim
// columns), keeps that slice's [N, PS] state in shared memory, and walks
// the chunks in a loop: nothing carries between CTAs.
//
// What bounds it on the H100: FP32 operations.  At the serve shape (B 8,
// T 2048, H 24, P 64, N 128, Q 128) the live work is ~16 GFLOP (0.25 ms at
// 67 TFLOP/s) against ~218 MB of bytes (0.065 ms at 3.35 TB/s).  This
// first version does scalar FP32 FMAs from shared memory, with no tensor
// cores, and recomputes the head-independent C B^T scores in every head's
// CTA, so it sits well above that bound; what it keeps out of device memory
// is the [Q, Q] decay-masked score block and the state, which the plain
// version materializes every chunk.  Per chunk the CTA stages C [Q, N] and
// x [Q, PS] (B and C converted to float32 on load, from float32 or
// bfloat16), then B and the scores in blocks of JB columns.
//
// The decay exp(ca_i - ca_j) has a positive exponent for j > i and can
// overflow: those terms are skipped, never multiplied by a 0/1 mask
// (inf * 0 = NaN).  A ragged tail (T % Q != 0) is masked, not padded: its
// rows load as a = x = B = C = 0, which leaves the final state exactly as
// the plain version's zero padding does.  Built without fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int JB = 32;      // score columns (and B rows) per block
constexpr int PS_MAX = 64;  // head-dim columns per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  const float* x;   // [B, T, H, P] (pre-multiplied by dt)
  const float* a;   // [B, T, H]
  const void* bm;   // [B, T, N]
  const void* cm;   // [B, T, N]
  float* y;         // [B, T, H, P] contiguous
  float* hout;      // [B, H, N, P] contiguous
  long long x_sb, x_st, x_sh, a_sb, a_st, b_sb, b_st, c_sb, c_st;  // element strides
  int B, T, H, P, N, Q, PS;
};

template <typename BT>
__global__ void __launch_bounds__(NTHREADS) ssd_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, N = p.N, PS = p.PS;
  const int NS = N + 1, SS = JB + 1;  // padded rows: column reads spread over banks
  float* Cs = smem;              // [Q][NS]   C of the chunk
  float* Bs = Cs + Q * NS;       // [JB][NS]  B of one column block
  float* Ss = Bs + JB * NS;      // [Q][SS]   decayed scores of one column block
  float* Xs = Ss + Q * SS;       // [Q][PS]   x of the chunk
  float* Ys = Xs + Q * PS;       // [Q][PS]   y of the chunk
  float* Hs = Ys + Q * PS;       // [N][PS]   the state
  float* ca = Hs + N * PS;       // [Q]       inclusive cumsum of a
  float* eca = ca + Q;           // [Q]       exp(ca)
  float* wj = eca + Q;           // [Q]       exp(last - ca)

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, p0 = blockIdx.x * PS;
  const int pw = min(PS, p.P - p0);
  const float* xg = p.x + b * p.x_sb + h * p.x_sh + p0;
  const float* ag = p.a + b * p.a_sb + h;
  const BT* bg = static_cast<const BT*>(p.bm) + b * p.b_sb;
  const BT* cg = static_cast<const BT*>(p.cm) + b * p.c_sb;
  const long long y_st = (long long)p.H * p.P;
  float* yg = p.y + (long long)b * p.T * y_st + (long long)h * p.P + p0;

  for (int idx = tid; idx < N * PS; idx += NTHREADS) Hs[idx] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += Q) {
    const int nv = min(Q, p.T - t0);  // live rows of this chunk
    __syncthreads();  // the previous chunk is done with Cs, Xs and Ys
    for (int idx = tid; idx < Q * N; idx += NTHREADS) {
      const int i = idx / N, n = idx - i * N;
      Cs[i * NS + n] = i < nv ? to_f32(cg[(long long)(t0 + i) * p.c_st + n]) : 0.f;
    }
    for (int idx = tid; idx < Q * PS; idx += NTHREADS) {
      const int i = idx / PS, c = idx - i * PS;
      Xs[idx] = (i < nv && c < pw) ? xg[(long long)(t0 + i) * p.x_st + c] : 0.f;
    }
    for (int i = tid; i < Q; i += NTHREADS)
      ca[i] = i < nv ? ag[(long long)(t0 + i) * p.a_st] : 0.f;
    __syncthreads();
    if (tid == 0) {  // sequential inclusive cumsum
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += ca[i];
        ca[i] = s;
      }
    }
    __syncthreads();
    const float last = ca[Q - 1];
    for (int i = tid; i < Q; i += NTHREADS) {
      eca[i] = expf(ca[i]);
      wj[i] = expf(last - ca[i]);
    }
    __syncthreads();

    // inter-chunk: y = exp(ca_i) * (C_i . h_prev)
    for (int idx = tid; idx < nv * PS; idx += NTHREADS) {
      const int i = idx / PS, c = idx - i * PS;
      const float* crow = Cs + i * NS;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s = fmaf(crow[n], Hs[n * PS + c], s);
      Ys[idx] = s * eca[i];
    }
    __syncthreads();  // h_prev fully read
    // h <- exp(last) h_prev; each element stays with the thread that owns it
    // in the state update below (the same index walk)
    const float el = expf(last);
    for (int idx = tid; idx < N * PS; idx += NTHREADS) Hs[idx] *= el;

    for (int jb0 = 0; jb0 < nv; jb0 += JB) {
      const int jn = min(JB, nv - jb0);  // live columns of the block
      for (int idx = tid; idx < JB * N; idx += NTHREADS) {
        const int jj = idx / N, n = idx - jj * N;
        Bs[jj * NS + n] = jj < jn ? to_f32(bg[(long long)(t0 + jb0 + jj) * p.b_st + n]) : 0.f;
      }
      __syncthreads();
      // decayed scores of rows i >= jb0 (rows above see none of the block)
      for (int idx = tid; idx < (nv - jb0) * JB; idx += NTHREADS) {
        const int i = jb0 + idx / JB, jj = idx % JB, j = jb0 + jj;
        float s = 0.f;
        if (j <= i) {  // skip j > i: exp(ca_i - ca_j) may be inf there
          const float* crow = Cs + i * NS;
          const float* brow = Bs + jj * NS;
          for (int n = 0; n < N; ++n) s = fmaf(crow[n], brow[n], s);
          s *= expf(ca[i] - ca[j]);
        }
        Ss[i * SS + jj] = s;
      }
      // state: h += sum_j exp(last - ca_j) B_j x_j^T
      for (int idx = tid; idx < N * PS; idx += NTHREADS) {
        const int n = idx / PS, c = idx - n * PS;
        float s = 0.f;
        for (int jj = 0; jj < jn; ++jj)
          s = fmaf(Bs[jj * NS + n] * wj[jb0 + jj], Xs[(jb0 + jj) * PS + c], s);
        Hs[idx] += s;
      }
      __syncthreads();  // scores of the block complete
      // intra-chunk: y_i += sum_{j <= i} S[i, j] x_j
      for (int idx = tid; idx < (nv - jb0) * PS; idx += NTHREADS) {
        const int r = idx / PS, c = idx - r * PS, i = jb0 + r;
        const int je = min(jn, r + 1);
        float s = 0.f;
        for (int jj = 0; jj < je; ++jj) s = fmaf(Ss[i * SS + jj], Xs[(jb0 + jj) * PS + c], s);
        Ys[i * PS + c] += s;
      }
      __syncthreads();  // Bs and Ss free for the next block
    }

    for (int idx = tid; idx < nv * PS; idx += NTHREADS) {
      const int i = idx / PS, c = idx - i * PS;
      if (c < pw) yg[(long long)(t0 + i) * y_st + c] = Ys[idx];
    }
  }
  __syncthreads();
  float* hg = p.hout + ((long long)b * p.H + h) * N * p.P + p0;
  for (int idx = tid; idx < N * PS; idx += NTHREADS) {
    const int n = idx / PS, c = idx - n * PS;
    if (c < pw) hg[(long long)n * p.P + c] = Hs[idx];
  }
}

size_t smem_bytes(int Q, int N, int PS) {
  return sizeof(float) * ((size_t)Q * (N + 1) + (size_t)JB * (N + 1) + (size_t)Q * (JB + 1) +
                          2 * (size_t)Q * PS + (size_t)N * PS + 3 * (size_t)Q);
}

template <typename BT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<BT>;
  const size_t bytes = smem_bytes(p.Q, p.N, p.PS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.P + p.PS - 1) / p.PS, p.H, p.B);
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C).  Strides are in elements;
// the last dimension of every input must be contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(
    const void* x, const void* a, const void* bm, const void* cm, void* y, void* hout,
    long long x_sb, long long x_st, long long x_sh, long long a_sb, long long a_st,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    int B, int T, int H, int P, int N, int Q, int bc_dtype, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.bm = bm; p.cm = cm;
  p.y = static_cast<float*>(y);
  p.hout = static_cast<float*>(hout);
  p.x_sb = x_sb; p.x_st = x_st; p.x_sh = x_sh; p.a_sb = a_sb; p.a_st = a_st;
  p.b_sb = b_sb; p.b_st = b_st; p.c_sb = c_sb; p.c_st = c_st;
  p.B = B; p.T = T; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.PS = P < PS_MAX ? P : PS_MAX;
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bc_dtype == 0)
    err = launch<float>(p, s);
  else if (bc_dtype == 1)
    err = launch<__nv_bfloat16>(p, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
