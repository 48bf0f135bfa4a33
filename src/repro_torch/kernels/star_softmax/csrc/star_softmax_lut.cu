// star_softmax_lut: the STAR row softmax through runtime LUT / VMM /
// CAM-remap tables, one row split over a thread-block cluster, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/star_softmax/kernel.py:
// _kernel (pallas_call at :177) in every mode (gather, its use_mxu_lut
// one-hot @ LUT form, whose single nonzero reproduces the gathered entry bit
// for bit, and use_histogram) and _kernel_faulty (the fault-injected engine,
// pallas_call at :201).  The TPU kernel holds a block of rows in VMEM and
// does every lookup as a one-hot matmul on the MXU; the counter is a one-hot
// sum, the denominator a [L] x [L, 1] VMM.  A clean call passes the tables
// (lut, lut, identity), a faulty one its seeded realization, so one body
// serves both TPU kernels.  The ADC gain of the faulty histogram path is
// applied by the wrapper, as the TPU wrapper does.
//
// What bounds it on the H100: bytes, one read of x and one write of the
// output ([4, 49152] float32 for the sampling call: 1.57 MB, 0.47 us at
// 3.35 TB/s).  Sampling hands it 4 or 8 vocabulary-wide rows: one CTA a row
// would fill 4 or 8 of 132 SMs and walk each row serially.  So a cluster of
// C CTAs (the wrapper picks C from d: 1 up to 4096 columns, at most 8, the
// portable cluster size) owns one row, each CTA a contiguous slice with
// 16-byte loads, and the two row-wide reductions go through distributed
// shared memory inside the one launch:
//   1. each CTA loads the tables into its shared memory, snaps its slice to
//      the int grid (rint, half to even, saturated to +-2^24 before the int
//      cast, NaN -> sentinel, so -inf lands on the last level and never
//      wraps), keeps the snapped values in registers and publishes its
//      integer max; after cluster.sync() every CTA forms the row max m from
//      the C maxes;
//   2. k = clip(m - j, 0, L-1), k2 = remap[k] (broken CAM rows match the
//      nearest working row), p = lut[k2]; gather: a partial sum of p in a
//      fixed order; HISTOGRAM: integer shared-memory counts of k2, summed
//      across the cluster (exact), then den = sum_l counts[l] * vmm[l] in one
//      fixed order;
//   3. den from the C partials in rank order, identical in every CTA, so a
//      launch is deterministic; den <= 0 -> 1 (a row whose cells all read
//      zero emits zeros); p / den (IEEE division; built without fast math),
//      divided once per level (p takes at most L values) and looked up for
//      each column from the registers' snapped values.
// x is read once and the output written once.  A slice longer than the
// registers hold (NT * EPT values) is walked in rounds inside the same
// kernel, reading x again in each of the three phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;                  // threads a CTA
constexpr int NWARPS = NT / 32;
constexpr int EPT = 32;                  // snapped values a thread keeps in registers
constexpr int CAP = NT * EPT;            // a slice's values per round
constexpr int GRID_SENTINEL = -(1 << 24);
constexpr int INVALID = GRID_SENTINEL - 1;  // past the slice: below every snapped value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int snap(float s, float scale) {
  float v = rintf(s * scale);
  if (isnan(v)) v = (float)GRID_SENTINEL;
  v = fminf(fmaxf(v, (float)GRID_SENTINEL), (float)(-GRID_SENTINEL));
  return (int)v;
}

// 16 bytes of x as V float32 values
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The cluster barrier in two halves: a CTA arrives once it has read the
// others' shared memory and waits only before it exits, so the last
// barrier's latency overlaps the writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block-wide reductions; every thread gets the result.  The float sum's
// order is fixed by the thread layout.
__device__ int block_max(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NWARPS ? red[lane] : GRID_SENTINEL;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is reused by the next reduction
  return v;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NWARPS ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// One row per cluster of C CTAs along x: block b works on row b / C, slice
// b % C (its rank in the cluster), columns [rank * slice, + slice) of d.
// VEC: x's and out's rows start on 16 bytes, so whole 16-byte chunks of a
// slice load and store as vectors; otherwise every element goes alone.
template <typename T, bool HISTOGRAM, bool VEC>
__global__ void __launch_bounds__(NT) star_softmax_lut_kernel(
    const T* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ lut, const float* __restrict__ vmm,
    const int32_t* __restrict__ remap, int d, int slice, long long x_stride,
    long long out_stride, float grid_scale, int num_levels) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = EPT / V;             // chunks a thread holds
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  float* s_vmm = s_lut + num_levels;
  int* s_remap = reinterpret_cast<int*>(s_vmm + num_levels);
  int* s_counts = s_remap + num_levels;
  __shared__ int red_i[NWARPS];
  __shared__ float red_f[NWARPS];
  __shared__ int s_max;
  __shared__ float s_part;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x / C;
  const int s0 = rank * slice;
  const int len = max(min(slice, d - s0), 0);
  const T* xs = x + row * x_stride + s0;
  float* os = out + row * out_stride + s0;
  const int top = num_levels - 1;
  const int rounds = (len + CAP - 1) / CAP;

  // chunk i of round r: elements (r * NT * CH + i * NT + tid) * V + [0, V)
  int j[CH][V];
  auto load = [&](int r) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int base = ((r * CH + i) * NT + tid) * V;
      if (VEC && base + V <= len) {
        float v[V];
        load16(xs + base, v);
#pragma unroll
        for (int e = 0; e < V; ++e) j[i][e] = snap(v[e], grid_scale);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          j[i][e] = base + e < len ? snap(to_f32(xs[base + e]), grid_scale) : INVALID;
      }
    }
  };

  // 1. the row max (x's loads issued before the tables', so both latencies overlap)
  if (rounds == 1) load(0);
  for (int l = tid; l < num_levels; l += NT) {
    s_lut[l] = lut[l];
    s_vmm[l] = vmm[l];
    s_remap[l] = remap[l];
    s_counts[l] = 0;
  }
  int m = GRID_SENTINEL;
  for (int r = 0; r < rounds; ++r) {
    if (rounds > 1) load(r);
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) m = max(m, j[i][e]);
  }
  m = block_max(m, red_i);  // its __syncthreads also publishes the tables
  if (tid == 0) s_max = m;
  cluster.sync();
  m = GRID_SENTINEL;
  for (int q = 0; q < C; ++q) m = max(m, *cluster.map_shared_rank(&s_max, q));

  // 2. the denominator
  float part = 0.f;
  for (int r = 0; r < rounds; ++r) {
    if (rounds > 1) load(r);
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (j[i][e] == INVALID) continue;
        const int k2 = s_remap[min(max(m - j[i][e], 0), top)];
        if (HISTOGRAM)
          atomicAdd(&s_counts[k2], 1);
        else
          part = __fadd_rn(part, s_lut[k2]);
      }
  }
  float den;
  if (HISTOGRAM) {
    cluster.sync();  // every CTA's counts are complete
    for (int l = tid; l < num_levels; l += NT) {
      int c = 0;
      for (int q = 0; q < C; ++q) c += cluster.map_shared_rank(s_counts, q)[l];
      part = __fadd_rn(part, __fmul_rn((float)c, s_vmm[l]));
    }
    cluster_arrive();  // done with the other CTAs' shared memory
    den = block_sum(part, red_f);
  } else {
    part = block_sum(part, red_f);
    if (tid == 0) s_part = part;
    cluster.sync();
    den = 0.f;
    for (int q = 0; q < C; ++q) den = __fadd_rn(den, *cluster.map_shared_rank(&s_part, q));
    cluster_arrive();  // done with the other CTAs' shared memory
  }
  if (den <= 0.f) den = 1.f;

  // 3. p / den: a row's p takes at most L values, so each level's quotient
  // is divided once, into s_vmm (no longer read: den is formed), and every
  // column looks its own up: the same IEEE division, once per level
  for (int l = tid; l < num_levels; l += NT) s_vmm[l] = __fdiv_rn(s_lut[s_remap[l]], den);
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    if (rounds > 1) load(r);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int base = ((r * CH + i) * NT + tid) * V;
      float p[V];
#pragma unroll
      for (int e = 0; e < V; ++e) p[e] = s_vmm[min(max(m - j[i][e], 0), top)];
      if (VEC && base + V <= len) {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(os + base + e) =
              make_float4(p[e], p[e + 1], p[e + 2], p[e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (base + e < len) os[base + e] = p[e];
      }
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its shared memory
}

template <typename T, bool HISTOGRAM, bool VEC>
cudaError_t launch(const void* x, void* out, const float* lut, const float* vmm,
                   const int32_t* remap, int rows, int d, int cluster, int slice,
                   long long x_stride, long long out_stride, float grid_scale, int num_levels,
                   cudaStream_t stream) {
  const size_t smem = 16 * (size_t)num_levels;
  auto kernel = star_softmax_lut_kernel<T, HISTOGRAM, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                       static_cast<float*>(out), lut, vmm, remap, d, slice,
                                       x_stride, out_stride, grid_scale, num_levels);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool HISTOGRAM>
cudaError_t launch_vec(bool vec, const void* x, void* out, const float* lut, const float* vmm,
                       const int32_t* remap, int rows, int d, int cluster, int slice,
                       long long x_stride, long long out_stride, float grid_scale,
                       int num_levels, cudaStream_t s) {
  return vec ? launch<T, HISTOGRAM, true>(x, out, lut, vmm, remap, rows, d, cluster, slice,
                                          x_stride, out_stride, grid_scale, num_levels, s)
             : launch<T, HISTOGRAM, false>(x, out, lut, vmm, remap, rows, d, cluster, slice,
                                           x_stride, out_stride, grid_scale, num_levels, s);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  x is [rows, d] with row stride
// x_stride (elements, last axis contiguous); out is float32 [rows, d].
// lut / vmm float32 [L], remap int32 [L] (values in [0, L)).  cluster CTAs
// (1..8) share a row, each `slice` columns (a multiple of 8; cluster * slice
// >= d).  Returns the launch's error, then cudaGetLastError().
extern "C" int star_softmax_lut_launch(
    const void* x, void* out, const void* lut, const void* vmm, const void* remap,
    int rows, int d, int cluster, int slice, long long x_stride, long long out_stride,
    int dtype, int histogram, float grid_scale, int num_levels, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (cluster < 1 || cluster > 8 || slice % 8 != 0 || (long long)cluster * slice < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lut);
  const float* v = static_cast<const float*>(vmm);
  const int32_t* r = static_cast<const int32_t*>(remap);
  const size_t esz = dtype == 1 ? 2 : 4;
  const bool vec = (uintptr_t)x % 16 == 0 && (x_stride * (long long)esz) % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (out_stride * 4) % 16 == 0;
  cudaError_t err;
  if (dtype == 0)
    err = histogram ? launch_vec<float, true>(vec, x, out, l, v, r, rows, d, cluster, slice,
                                              x_stride, out_stride, grid_scale, num_levels, s)
                    : launch_vec<float, false>(vec, x, out, l, v, r, rows, d, cluster, slice,
                                               x_stride, out_stride, grid_scale, num_levels, s);
  else if (dtype == 1)
    err = histogram
              ? launch_vec<__nv_bfloat16, true>(vec, x, out, l, v, r, rows, d, cluster, slice,
                                                x_stride, out_stride, grid_scale, num_levels, s)
              : launch_vec<__nv_bfloat16, false>(vec, x, out, l, v, r, rows, d, cluster, slice,
                                                 x_stride, out_stride, grid_scale, num_levels,
                                                 s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
