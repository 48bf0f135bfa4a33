// ssd_scan: the SSD (state-space duality) chunk scan of the mamba2 mixer,
// for Hopper (sm_90a), as three chunk-parallel kernels.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_pallas / _kernel).  Per chunk of Q steps, with ca the inclusive
// cumsum of the log-decay a inside the chunk and last = ca[Q-1]:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(ca_i - ca_j) x[j]   (intra-chunk)
//         + exp(ca_i) C_i h_in                             (inter-chunk)
//   h_out = exp(last) h_in + s,  s = sum_j exp(last - ca_j) B_j x[j]^T
// The TPU grid (batch, chunks) runs the chunks in order and carries the
// [H, N, P] state in VMEM scratch.  Hopper has no ordered grid, and only the
// recurrence h_out = exp(last) h_in + s is sequential (Mamba2's SSD
// algorithm, arXiv:2405.21060 section 6), so the scan is three launches on
// one stream:
//   ssd_chunk_state_kernel  one CTA per (batch, chunk, HG_STATE heads, PS
//                           head columns): each head's cumsum ca (kept in cas
//                           [B, nc, H, Qp]) and its s [N, P], written to the
//                           float32 workspace ws [B, nc, H, N, P];
//   ssd_state_pass_kernel   one thread per 4 state elements of (batch, head):
//                           walks the chunks in order, h <- exp(last) h + s,
//                           overwrites ws with the state entering each chunk
//                           and writes the final state to hout;
//   ssd_chunk_scan_kernel   one CTA per (batch, chunk, group of heads, PS head
//                           columns): the scores C B^T once for its heads (B
//                           and C are shared by every head), then per head
//                           y = exp(ca_i) C_i h_in + the decayed S x.  The
//                           group is as many heads as keep about one CTA per
//                           SM (all 24 at the serve shape).
//
// What bounds it on the H100.  At the serve shape (B 8, T 2048, H 24, P 64,
// N 128, Q 128) the inputs and outputs are ~218 MB, and the workspace adds
// ~100 MB written once and read about three times (~0.19 ms at 3.35 TB/s
// all told); the ~16 GFLOP of live products take 0.1 ms as three tf32
// tensor-core products each (3 x 16.4 GFLOP at 495 TFLOP/s).  The products
// run on the tensor cores (mma.sync.m16n8k8, tf32 in, float32 accumulators),
// each warp owning 16-row tiles whose operands it reads from shared memory.
// The tensor cores are not what limits these kernels: the work around each
// product is (loading and splitting its operands, the decay's exp, waiting
// on loads with one or two CTAs an SM).  The chunk scan therefore splits x
// and h_in into tf32 hi and lo planes once per head (not once per warp that
// reads them), keeps each warp's band of scores in registers across the
// heads (its C fragment is the A fragment of S x, see warp_mma), computes
// each decay once, and loads a head's state while the previous head's S x
// runs and its x while C h_in runs (cp.async, two groups).  The chunk-state
// CTA takes 103 KB of shared memory (two an SM), the chunk-scan CTA 203 KB
// (one).
//
// Arithmetic.  The outputs keep float32 rounding: a float32 operand x is
// split into two tf32 values, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna),
// and each product is lo.hi + hi.lo + hi.hi (3xTF32; the dropped lo.lo is
// ~2^-22 of it).  A bf16 operand (B and C on the serve path) is exact in
// tf32, so its lo is 0 and its products with lo are not issued: C B^T is one
// product, C h_in and B^T (w x) two.  One tf32 rounding of a float32 operand
// would miss the plain version by ~3e-4 of the largest output.  The decay
// exp(ca_i - ca_j) has a positive exponent for j > i and can overflow: those
// terms are skipped, never multiplied by a 0/1 mask (inf * 0 = NaN).  The
// state pass multiplies and adds as two roundings, as the plain version.  A
// ragged tail (T % Q != 0) is masked, not padded: its rows load as a = x = B
// = C = 0, which leaves the final state exactly as the plain version's zero
// padding does.  No atomics: every output element has one writer, and the
// arithmetic of a head does not depend on how heads are grouped, so a batch
// row's outputs do not depend on the other rows.  Built without fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NTHREADS = 256;             // eight warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int QPAD = 64;                  // chunk rows padded to a multiple of this
constexpr int NPAD = 16;                  // state rows padded to a multiple of this
constexpr int PS = 64;                    // head-dim columns per CTA
constexpr int HG_STATE = 4;               // heads per CTA of the chunk-state kernel
constexpr int MAX_CHUNK = 16 * NWARPS;    // y rows: at most one 16-row band a warp
constexpr int MAX_STATE = 144;            // state rows whose tiles fit beside MAX_CHUNK
constexpr int PASS_ELEMS = 4;             // state elements per thread in the pass
constexpr int STAGE_BATCH = 8;            // loads in flight per thread while staging
constexpr int SMEM_LIMIT = 232448;        // dynamic shared memory of one CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  const float* x;   // [B, T, H, P] (pre-multiplied by dt)
  const float* a;   // [B, T, H]
  const void* bm;   // [B, T, N]
  const void* cm;   // [B, T, N]
  float* y;         // [B, T, H, P] contiguous
  float* hout;      // [B, H, N, P] contiguous
  float* ws;        // [B, nc, H, N, P]: s of each chunk, then the state entering it
  float* cas;       // [B, nc, H, Qp]: the inclusive cumsum of a in each chunk
  long long x_sb, x_st, x_sh, a_sb, a_st, b_sb, b_st, c_sb, c_st;  // element strides
  int B, T, H, P, N, Q, nc, Qp, Np;
  int hg_scan;      // heads per CTA of the chunk-scan kernel
  bool bc_vec;      // B / C rows load as 16-byte vectors
  bool x_vec;       // x and ws rows copy as 16-byte vectors
};

// B, x of one head, a of the CTA's heads and exp(last - ca)
constexpr size_t state_smem_bytes(int Qp, int Np) {
  return sizeof(float) *
         ((size_t)Qp * (Np + 4) + (size_t)Qp * (PS + 4) + (size_t)(HG_STATE + 1) * Qp);
}

// C; then B, or x and the entering state as tf32 hi and lo planes; ca of
// two heads
constexpr size_t scan_smem_bytes(int Qp, int Np) {
  return sizeof(float) * ((size_t)Qp * (Np + 4) +
                          (2 * (size_t)(Qp + Np) * (PS + 4) > (size_t)Qp * (Np + 4)
                               ? 2 * (size_t)(Qp + Np) * (PS + 4)
                               : (size_t)Qp * (Np + 4)) +
                          2 * (size_t)Qp);
}

// Both grow with the padded sizes, so every chunk <= MAX_CHUNK and state <=
// MAX_STATE fits; two chunk-state CTAs share an SM's 228 KB (1 KB reserved
// a CTA)
static_assert(MAX_CHUNK % QPAD == 0 && MAX_STATE % NPAD == 0, "limits are padded sizes");
static_assert(scan_smem_bytes(MAX_CHUNK, MAX_STATE) <= SMEM_LIMIT, "chunk-scan tiles fit");
static_assert(2 * (state_smem_bytes(MAX_CHUNK, MAX_STATE) + 1024) <= 233472,
              "two chunk-state CTAs an SM");

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// global -> shared without registers; bytes past src_bytes are zero-filled
// and nothing is read for src_bytes = 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // all but the newest N groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, rows) x PS columns of a float32 matrix (row stride st; rows >= nv
// and columns >= pw zero) into dst (row stride ld), with cp.async: 16 bytes a
// copy when vec (rows and src 16-byte aligned, pw a multiple of 4), else 4
__device__ __forceinline__ void copy_rows_async(float* dst, int ld, const float* src,
                                                long long st, int rows, int nv, int pw,
                                                bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (PS / 4); idx += NTHREADS) {
      const int i = idx / (PS / 4), col = (idx % (PS / 4)) * 4;
      const bool live = i < nv && col < pw;
      cp_async16(dst + i * ld + col, live ? src + i * st + col : src, live ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * PS; idx += NTHREADS) {
      const int i = idx / PS, col = idx % PS;
      const bool live = i < nv && col < pw;
      cp_async4(dst + i * ld + col, live ? src + i * st + col : src, live ? 4 : 0);
    }
  }
}

// dst[i][n] (row stride ld) = float32 of src[i * st + n] for i < nv and n <
// N, else 0, over the rows x Np tile.  Each thread has STAGE_BATCH loads out
// before it converts and stores them; 16-byte vectors when vec.
template <typename BT>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const BT* src, long long st,
                                           int rows, int nv, int N, int Np, bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(BT);
    const int per_row = Np / VW, total = rows * per_row;
    for (int base = threadIdx.x; base < total; base += NTHREADS * STAGE_BATCH) {
      uint4 v[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int idx = base + u * NTHREADS, i = idx / per_row, n = (idx - i * per_row) * VW;
        v[u] = idx < total && i < nv && n < N
                   ? *reinterpret_cast<const uint4*>(src + i * st + n)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int idx = base + u * NTHREADS, i = idx / per_row, n = (idx - i * per_row) * VW;
        if (idx >= total) continue;
        const BT* e = reinterpret_cast<const BT*>(&v[u]);
#pragma unroll
        for (int k = 0; k < VW; ++k) dst[i * ld + n + k] = to_f32(e[k]);
      }
    }
  } else {
    const int total = rows * Np;
    for (int base = threadIdx.x; base < total; base += NTHREADS * STAGE_BATCH) {
      float v[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int idx = base + u * NTHREADS, i = idx / Np, n = idx - i * Np;
        v[u] = idx < total && i < nv && n < N ? to_f32(src[i * st + n]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int idx = base + u * NTHREADS, i = idx / Np, n = idx - i * Np;
        if (idx < total) dst[i * ld + n] = v[u];
      }
    }
  }
}

// x rounded to the nearest tf32 (ties away), as a float32 bit pattern
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x = hi + lo as two tf32 values; an EXACT operand (a bf16 value) is its own hi
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    const float h = tf32_rna(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(tf32_rna(__fsub_rn(x, h)));
  }
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += the float32-faithful product of a and b: 3xTF32, with the products
// of an exact operand's lo (0) left out
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!A_EXACT) mma_tf32(c, al, bh);
  if (!B_EXACT) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragments (PTX m16n8k8): lane = 4 g + t holds A (g, k), (g + 8, k), B (k, g)
// for two values k of the 8-column step, and C (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1).  The k index is permuted inside each step: the two
// k of lane t are columns 2t and 2t + 1 (a sum over k does not see the
// order), so a thread's A values of a row are neighbours in memory, and the
// C fragment of one product is the A fragment of the next.
//
// acc += A[m0:m0+16, 0:k_end] B[0:k_end, n0:n0+8NT] for one warp, float32
// faithful.  la(m, k) and lb(k, n) read one operand element.
template <bool A_EXACT, bool B_EXACT, int NT, class LoadA, class LoadB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int m0, int n0, int k_end,
                                         LoadA la, LoadB lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < k_end; k0 += 8) {
    const int k = k0 + 2 * t;
    uint32_t ah[4], al[4];
    split_tf32<A_EXACT>(la(m0 + g, k), ah[0], al[0]);
    split_tf32<A_EXACT>(la(m0 + g + 8, k), ah[1], al[1]);
    split_tf32<A_EXACT>(la(m0 + g, k + 1), ah[2], al[2]);
    split_tf32<A_EXACT>(la(m0 + g + 8, k + 1), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + 8 * nt + g;
      uint32_t bh[2], bl[2];
      split_tf32<B_EXACT>(lb(k, n), bh[0], bl[0]);
      split_tf32<B_EXACT>(lb(k + 1, n), bh[1], bl[1]);
      mma3<A_EXACT, B_EXACT>(acc[nt], ah, al, bh, bl);
    }
  }
}

// store a warp's 16 x 8NT accumulator tile to rows m0.. (row stride ld) of
// dst, columns < cols, rows < rows
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], float* dst, long long ld,
                                           int m0, int n0, int rows, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
      if (r >= rows) continue;
      if (col < cols) dst[r * ld + col] = acc[nt][2 * half];
      if (col + 1 < cols) dst[r * ld + col + 1] = acc[nt][2 * half + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// 1. chunk state: s[n][p] = sum_j B[j][n] exp(last - ca_j) x[j][p]

template <typename BT>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_chunk_state_kernel(Params p) {
  constexpr bool EX = std::is_same<BT, __nv_bfloat16>::value;
  extern __shared__ float smem[];
  const int Qp = p.Qp, Np = p.Np, ldb = Np + 4, ldx = PS + 4;
  float* Bs = smem;                // [Qp][ldb]       B of the chunk (read as B^T)
  float* Xs = Bs + Qp * ldb;       // [Qp][ldx]       x of one head
  float* as = Xs + Qp * ldx;       // [HG_STATE][Qp]  a of the CTA's heads, then ca
  float* wj = as + HG_STATE * Qp;  // [Qp]            exp(last - ca_j)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int nps = (p.P + PS - 1) / PS;
  const int h0 = (blockIdx.x / nps) * HG_STATE, p0 = (blockIdx.x % nps) * PS;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.T - t0), pw = min(PS, p.P - p0);
  const int h_end = min(p.H, h0 + HG_STATE);

  const float* ag = p.a + b * p.a_sb + (long long)t0 * p.a_st + h0;
  for (int idx = tid; idx < Qp * HG_STATE; idx += NTHREADS) {
    const int i = idx / HG_STATE, hh = idx % HG_STATE;
    const bool live = i < nv && h0 + hh < h_end;
    cp_async4(as + hh * Qp + i, live ? ag + i * p.a_st + hh : p.a, live ? 4 : 0);
  }
  cp_async_commit();
  stage_rows(Bs, ldb, static_cast<const BT*>(p.bm) + b * p.b_sb + (long long)t0 * p.b_st,
             p.b_st, Qp, nv, p.N, Np, p.bc_vec);
  cp_async_wait<0>();
  __syncthreads();
  // the inclusive cumsum of each head's a (rows >= nv are 0), in place: one
  // lane a head, each summing in order as the plain version does, so ca has
  // its bits (exp turns a reordered sum's rounding, ~1e-6 at |ca| ~ 10,
  // into the largest error of y)
  if (tid < h_end - h0) {
    float run = 0.f;
    float* v = as + tid * Qp;
    for (int i = 0; i < Qp; ++i) {
      run += v[i];
      v[i] = run;
    }
  }

  for (int h = h0; h < h_end; ++h) {
    __syncthreads();  // Bs and ca ready; the previous head is done with Xs and wj
    copy_rows_async(Xs, ldx, p.x + b * p.x_sb + (long long)t0 * p.x_st + h * p.x_sh + p0,
                    p.x_st, Qp, nv, pw, p.x_vec);
    cp_async_commit();
    const float* ca = as + (h - h0) * Qp;
    const float last = ca[Qp - 1];
    float* cag = p.cas + (((long long)b * p.nc + c) * p.H + h) * Qp;
    for (int i = tid; i < Qp; i += NTHREADS) {
      wj[i] = expf(last - ca[i]);
      if (p0 == 0) cag[i] = ca[i];
    }
    cp_async_wait<0>();
    __syncthreads();  // x and wj complete

    float* sg = p.ws + (((long long)b * p.nc + c) * p.H + h) * p.N * p.P + p0;
    for (int m0 = warp * 16; m0 < Np; m0 += NWARPS * 16) {
      float acc[PS / 8][4] = {};
      warp_mma<EX, false>(
          acc, m0, 0, Qp, [&](int m, int k) { return Bs[k * ldb + m]; },
          [&](int k, int n) { return Xs[k * ldx + n] * wj[k]; });
      store_tile(acc, sg, p.P, m0, 0, p.N, pw);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state passing: h <- exp(last_c) h + s_c, in chunk order

__global__ void __launch_bounds__(NTHREADS) ssd_state_pass_kernel(Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long np = (long long)p.N * p.P, cstride = (long long)p.H * np;
  const long long e0 = (long long)blockIdx.x * NTHREADS * PASS_ELEMS + threadIdx.x;
  float* w = p.ws + ((long long)b * p.nc * p.H + h) * np;
  const float* last = p.cas + ((long long)b * p.nc * p.H + h) * p.Qp + p.Qp - 1;
  const long long lstride = (long long)p.H * p.Qp;
  bool live[PASS_ELEMS];
  float hcur[PASS_ELEMS], s[PASS_ELEMS];
#pragma unroll
  for (int u = 0; u < PASS_ELEMS; ++u) {
    live[u] = e0 + u * NTHREADS < np;
    hcur[u] = 0.f;
    s[u] = live[u] && p.nc > 0 ? w[e0 + u * NTHREADS] : 0.f;
  }
  for (int c = 0; c < p.nc; ++c) {
    const float el = expf(last[c * lstride]);
    float nxt[PASS_ELEMS];
#pragma unroll
    for (int u = 0; u < PASS_ELEMS; ++u)  // the next chunk's s, loaded ahead
      nxt[u] = live[u] && c + 1 < p.nc ? w[(c + 1) * cstride + e0 + u * NTHREADS] : 0.f;
#pragma unroll
    for (int u = 0; u < PASS_ELEMS; ++u) {
      if (live[u]) w[c * cstride + e0 + u * NTHREADS] = hcur[u];
      hcur[u] = __fadd_rn(__fmul_rn(hcur[u], el), s[u]);
      s[u] = nxt[u];
    }
  }
  float* hg = p.hout + ((long long)b * p.H + h) * np;
#pragma unroll
  for (int u = 0; u < PASS_ELEMS; ++u)
    if (live[u]) hg[e0 + u * NTHREADS] = hcur[u];
}

// ---------------------------------------------------------------------------
// 3. chunk output: y = exp(ca_i) C_i h_in + sum_{j<=i} G[i][j] exp(ca_i - ca_j) x_j

// v (rows x PS, row stride ld) -> its tf32 hi in place and its lo in lo,
// four floats a copy, each thread's STAGE_BATCH loads out before its stores
__device__ __forceinline__ void split_plane(float* v, float* lo, int ld, int rows) {
  constexpr int V4 = PS / 4;
  const int total = rows * V4;
  for (int base = threadIdx.x; base < total; base += NTHREADS * STAGE_BATCH) {
    float4 x[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int idx = base + u * NTHREADS;
      if (idx < total) x[u] = *reinterpret_cast<const float4*>(v + (idx / V4) * ld + idx % V4 * 4);
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int idx = base + u * NTHREADS;
      if (idx >= total) continue;
      const int off = (idx / V4) * ld + idx % V4 * 4;
      float4 h, l;
      h.x = tf32_rna(x[u].x);
      h.y = tf32_rna(x[u].y);
      h.z = tf32_rna(x[u].z);
      h.w = tf32_rna(x[u].w);
      l.x = tf32_rna(__fsub_rn(x[u].x, h.x));
      l.y = tf32_rna(__fsub_rn(x[u].y, h.y));
      l.z = tf32_rna(__fsub_rn(x[u].z, h.z));
      l.w = tf32_rna(__fsub_rn(x[u].w, h.w));
      *reinterpret_cast<float4*>(v + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
}

// the A fragment of rows m0.. of C (row stride ldc) at the permuted columns
// k, k + 1 (k = k0 + 2t): two 8-byte loads, split as 3xTF32 needs
template <bool EXACT>
__device__ __forceinline__ void c_fragment(const float* Cs, int ldc, int m0, int k,
                                           uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const float2 c0 = *reinterpret_cast<const float2*>(Cs + (m0 + g) * ldc + k);
  const float2 c1 = *reinterpret_cast<const float2*>(Cs + (m0 + g + 8) * ldc + k);
  split_tf32<EXACT>(c0.x, ah[0], al[0]);
  split_tf32<EXACT>(c1.x, ah[1], al[1]);
  split_tf32<EXACT>(c0.y, ah[2], al[2]);
  split_tf32<EXACT>(c1.y, ah[3], al[3]);
}

template <typename BT>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_chunk_scan_kernel(Params p) {
  constexpr bool EX = std::is_same<BT, __nv_bfloat16>::value;
  constexpr int NT = PS / 8;         // y: a warp's 16-row band, every column
  constexpr int GT = MAX_CHUNK / 8;  // score column tiles a band can hold
  extern __shared__ float smem[];
  const int Qp = p.Qp, Np = p.Np, ldc = Np + 4, ldx = PS + 4;
  const int staged = Qp * ldc, head = 2 * (Qp + Np) * ldx;
  float* Cs = smem;                                   // [Qp][ldc]  C of the chunk
  float* Bs = Cs + staged;                            // [Qp][ldc]  B, until the scores are in
  float* Xh = Bs;                                     // [Qp][ldx]  then x of one head, tf32 hi
  float* Xl = Xh + Qp * ldx;                          // [Qp][ldx]  and lo
  float* Hh = Xl + Qp * ldx;                          // [Np][ldx]  its entering state, hi
  float* Hl = Hh + Np * ldx;                          // [Np][ldx]  and lo
  float* cab = Bs + (head > staged ? head : staged);  // [2][Qp]     ca of this head, the next

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nps = (p.P + PS - 1) / PS;
  const int h0 = (blockIdx.x / nps) * p.hg_scan, p0 = (blockIdx.x % nps) * PS;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.T - t0), pw = min(PS, p.P - p0);
  const int h_end = min(p.H, h0 + p.hg_scan);
  // this warp's band of 16 rows of y; with a full chunk the warps that share
  // a scheduler (w and w + 4) take bands r and 7 - r, whose causal work
  // (r + 1 column tiles of 16) sums to the same
  const int bands = Qp / 16;
  const int r = bands == NWARPS ? (warp < NWARPS / 2 ? warp : 3 * NWARPS / 2 - 1 - warp) : warp;
  const bool mine = r < bands;
  const int m0 = 16 * r, nk = 2 * (r + 1);  // the band's score columns: j < m0 + 16

  stage_rows(Cs, ldc, static_cast<const BT*>(p.cm) + b * p.c_sb + (long long)t0 * p.c_st,
             p.c_st, Qp, nv, p.N, Np, p.bc_vec);
  stage_rows(Bs, ldc, static_cast<const BT*>(p.bm) + b * p.b_sb + (long long)t0 * p.b_st,
             p.b_st, Qp, nv, p.N, Np, p.bc_vec);
  __syncthreads();

  // the band's scores C B^T, once for the CTA's heads, kept in registers:
  // G[m0 + g (+8)][8 nt + 2t (+1)] is gs[nt][0..3], already the A fragment
  // of the intra-chunk product
  float gs[GT][4] = {};
  if (mine) {
    for (int k0 = 0; k0 < Np; k0 += 8) {
      const int k = k0 + 2 * t;
      uint32_t ah[4], al[4];
      c_fragment<EX>(Cs, ldc, m0, k, ah, al);
#pragma unroll
      for (int nt = 0; nt < GT; ++nt) {
        if (nt < nk) {
          const float2 bv = *reinterpret_cast<const float2*>(Bs + (8 * nt + g) * ldc + k);
          uint32_t bh[2], bl[2];
          split_tf32<EX>(bv.x, bh[0], bl[0]);
          split_tf32<EX>(bv.y, bh[1], bl[1]);
          mma3<EX, EX>(gs[nt], ah, al, bh, bl);
        }
      }
    }
  }
  __syncthreads();  // Bs is free for the planes

  const float* xg0 = p.x + b * p.x_sb + (long long)t0 * p.x_st + p0;
  const float* hg0 = p.ws + ((long long)b * p.nc + c) * p.H * p.N * p.P + p0;
  float* yg0 = p.y + ((long long)b * p.T + t0) * p.H * p.P + p0;
  const float* cag0 = p.cas + ((long long)b * p.nc + c) * p.H * Qp;
  // each head's state (with its ca) and x go out as two cp.async groups, and
  // the next head's state lands while this head's x is in use: the groups
  // alternate state, x, state, x (an empty group stands in past the last head)
  auto copy_state = [&](int hh) {
    copy_rows_async(Hh, ldx, hg0 + (long long)hh * p.N * p.P, p.P, Np, p.N, pw, p.x_vec);
    float* cad = cab + ((hh - h0) & 1) * Qp;
    for (int i = tid; i < Qp; i += NTHREADS) cp_async4(cad + i, cag0 + (long long)hh * Qp + i, 4);
  };
  copy_state(h0);
  cp_async_commit();
  copy_rows_async(Xh, ldx, xg0 + h0 * p.x_sh, p.x_st, Qp, nv, pw, p.x_vec);
  cp_async_commit();
  for (int h = h0; h < h_end; ++h) {
    const float* ca = cab + ((h - h0) & 1) * Qp;
    cp_async_wait<1>();
    __syncthreads();  // the entering state is in (x may still land)
    split_plane(Hh, Hl, ldx, Np);
    __syncthreads();
    float acc[NT][4] = {};
    if (mine) {  // inter-chunk: exp(ca_i) (C_i . h_in)
      for (int k0 = 0; k0 < Np; k0 += 8) {
        const int k = k0 + 2 * t;
        uint32_t ah[4], al[4];
        c_fragment<EX>(Cs, ldc, m0, k, ah, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = 8 * nt + g;
          const uint32_t bh[2] = {__float_as_uint(Hh[k * ldx + n]),
                                  __float_as_uint(Hh[(k + 1) * ldx + n])};
          const uint32_t bl[2] = {__float_as_uint(Hl[k * ldx + n]),
                                  __float_as_uint(Hl[(k + 1) * ldx + n])};
          mma3<EX, false>(acc[nt], ah, al, bh, bl);
        }
      }
      const float e0 = expf(ca[m0 + g]), e1 = expf(ca[m0 + g + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }
    __syncthreads();  // every warp is done with the state
    if (h + 1 < h_end) copy_state(h + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // x is in
    split_plane(Xh, Xl, ldx, Qp);
    __syncthreads();
    if (mine) {
      // intra-chunk: S[i][j] = G[i][j] exp(ca_i - ca_j) over the band's
      // columns j < m0 + 16; j > i skipped, never masked
      const int i0 = m0 + g, i1 = i0 + 8;
      const float ci0 = ca[i0], ci1 = ca[i1];
#pragma unroll
      for (int kk = 0; kk < GT; ++kk) {
        if (kk < nk) {
          const int j0 = 8 * kk + 2 * t, j1 = j0 + 1;
          const float cj0 = ca[j0], cj1 = ca[j1];
          uint32_t ah[4], al[4];
          split_tf32<false>(j0 <= i0 ? gs[kk][0] * expf(ci0 - cj0) : 0.f, ah[0], al[0]);
          split_tf32<false>(j0 <= i1 ? gs[kk][2] * expf(ci1 - cj0) : 0.f, ah[1], al[1]);
          split_tf32<false>(j1 <= i0 ? gs[kk][1] * expf(ci0 - cj1) : 0.f, ah[2], al[2]);
          split_tf32<false>(j1 <= i1 ? gs[kk][3] * expf(ci1 - cj1) : 0.f, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = 8 * nt + g;
            const uint32_t bh[2] = {__float_as_uint(Xh[j0 * ldx + n]),
                                    __float_as_uint(Xh[j1 * ldx + n])};
            const uint32_t bl[2] = {__float_as_uint(Xl[j0 * ldx + n]),
                                    __float_as_uint(Xl[j1 * ldx + n])};
            mma3<false, false>(acc[nt], ah, al, bh, bl);
          }
        }
      }
      store_tile(acc, yg0 + (long long)h * p.P, (long long)p.H * p.P, m0, 0, nv, pw);
    }
    __syncthreads();  // every warp is done with x
    if (h + 1 < h_end)
      copy_rows_async(Xh, ldx, xg0 + (h + 1) * p.x_sh, p.x_st, Qp, nv, pw, p.x_vec);
    cp_async_commit();
  }
}

template <typename BT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t state_bytes = state_smem_bytes(p.Qp, p.Np), scan_bytes = scan_smem_bytes(p.Qp, p.Np);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_bytes);
  if (err != cudaSuccess) return err;
  const int nps = (p.P + PS - 1) / PS;
  if (p.nc > 0) {
    const dim3 grid((p.H + HG_STATE - 1) / HG_STATE * nps, p.nc, p.B);
    ssd_chunk_state_kernel<BT><<<grid, NTHREADS, state_bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long np = (long long)p.N * p.P, per_cta = (long long)NTHREADS * PASS_ELEMS;
  ssd_state_pass_kernel<<<dim3((unsigned)((np + per_cta - 1) / per_cta), p.H, p.B), NTHREADS, 0,
                          stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.nc > 0) {
    const dim3 grid((p.H + p.hg_scan - 1) / p.hg_scan * nps, p.nc, p.B);
    ssd_chunk_scan_kernel<BT><<<grid, NTHREADS, scan_bytes, stream>>>(p);
  }
  return cudaSuccess;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C).  Strides are in elements;
// the last dimension of every input must be contiguous.  ws holds B * nc * H
// * N * P floats and cas B * nc * H * Qp, with nc = ceil(T / Q) and Qp = Q
// rounded up to QPAD.  A chunk over MAX_CHUNK rows, or a state over MAX_STATE
// rows, returns cudaErrorInvalidValue with nothing launched (the wrapper
// refuses them first).  Otherwise returns cudaGetLastError() after the
// three launches.
extern "C" int ssd_scan_launch(
    const void* x, const void* a, const void* bm, const void* cm, void* y, void* hout,
    void* ws, void* cas,
    long long x_sb, long long x_st, long long x_sh, long long a_sb, long long a_st,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    int B, int T, int H, int P, int N, int Q, int bc_dtype, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.bm = bm; p.cm = cm;
  p.y = static_cast<float*>(y);
  p.hout = static_cast<float*>(hout);
  p.ws = static_cast<float*>(ws);
  p.cas = static_cast<float*>(cas);
  p.x_sb = x_sb; p.x_st = x_st; p.x_sh = x_sh; p.a_sb = a_sb; p.a_st = a_st;
  p.b_sb = b_sb; p.b_st = b_st; p.c_sb = c_sb; p.c_st = c_st;
  p.B = B; p.T = T; p.H = H; p.P = P; p.N = N; p.Q = Q;
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return (int)cudaGetLastError();
  if (bc_dtype != 0 && bc_dtype != 1) return (int)cudaErrorInvalidValue;
  p.nc = (T + Q - 1) / Q;
  p.Qp = (Q + QPAD - 1) / QPAD * QPAD;
  p.Np = (N + NPAD - 1) / NPAD * NPAD;
  if (Q > MAX_CHUNK || N > MAX_STATE) return (int)cudaErrorInvalidValue;
  const long long vw = bc_dtype == 1 ? 8 : 4;  // elements in 16 bytes
  p.bc_vec = aligned16(bm) && aligned16(cm) && N % vw == 0 && b_sb % vw == 0 &&
             b_st % vw == 0 && c_sb % vw == 0 && c_st % vw == 0;
  p.x_vec = aligned16(x) && aligned16(ws) && P % 4 == 0 && x_sb % 4 == 0 && x_st % 4 == 0 &&
            x_sh % 4 == 0;
  // the chunk-scan kernel computes the scores once per CTA and pipelines its
  // heads, so it takes as many heads a CTA as keep about one CTA per SM
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)B * p.nc * ((P + PS - 1) / PS);
  long long groups = units > 0 ? (sms + units / 2) / units : 1;  // round(sms / units)
  groups = groups < 1 ? 1 : groups > H ? H : groups;
  p.hg_scan = (int)((H + groups - 1) / groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bc_dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
