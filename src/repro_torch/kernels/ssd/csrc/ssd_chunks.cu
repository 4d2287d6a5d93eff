// Mamba-2 SSD chunk step: for one (batch, chunk, head) tile of L steps,
//   cum[l]      = sum_{j<=l} dt[j] a                  (log-decay from start)
//   y_intra[l]  = sum_{m<=l} (c_l . b_m) e^{cum_l - cum_m} dt_m x_m
//   state       = sum_m e^{cum_{L-1} - cum_m} dt_m b_m x_m^T      (N x P)
// all in f32 from f32 or bf16 inputs.
//
// Replaces the Pallas kernel src/repro/kernels/ssd/kernel.py:ssd_chunks
// (body _ssd_chunk_kernel; pallas_call at kernel.py:74), whose tile holds
// every head of one (batch, chunk) pair - a few MB of TPU VMEM.  Here a
// block holds one head: at L = 128, N = P = 64 its working set in f32 is
// C^T and B^T (2 x 33 KB), x (32 KB), the L x L weights (64 KB) and cum/dt:
// 163 KB of the 227 KB a block may use, so one block per SM.  B and C are
// read per group (head h uses group h / (H/G)) straight from the
// projection output through its strides: at G = 1 nothing is repeated over
// heads in device memory, and no (B,S,H,N) copy is made.
//
// What bounds it on the H100 (Zamba2-2.7B prefill, B = 2, S = 8,192,
// H = 80, P = N = 64, G = 1, bf16 in): the data it must move once is
// x (168 MB), dt (5 MB), b and c (4 MB) and its f32 outputs y_intra
// (336 MB), states (168 MB) and cum (5 MB): ~0.69 GB, ~0.21 ms at
// 3.35 TB/s.  Its products (C B^T and the weighted sum over the lower
// triangle, the state product over the whole chunk) are ~3.1 MFLOP per
// block, ~32 GFLOP in all: ~0.03 ms at the bf16 tensor-core peak, so it is
// bound by bytes.  This first version does the products on the CUDA cores
// in f32 (67 TFLOP/s peak, ~0.5 ms at best): tensor cores, TMA and
// pipelining are later work.
//
// Design: grid (H, NC, B), 256 threads.  The block stages x, C^T, B^T and
// dt in shared memory (rows padded with zeros to a multiple of 4 so every
// product reads float4s), scans cum with one warp, then
//   1. W = (C B^T) o decay o dt over the lower-triangular 4x4 tiles only;
//      the mask m <= l is applied BEFORE the exponential: over a chunk cum
//      falls to about -1,400, so e^{cum_l - cum_m} for m > l would be inf
//      and inf * 0 NaN.  Tiles above the diagonal stay zero;
//   2. y_intra = W x, each 4x4 tile summing only m <= l;
//   3. state = (B o dte)^T x with dte = e^{cum_{L-1} - cum_m} dt_m.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ssd {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Dims {
  int nc, L, H, P, G, N;     // chunks, chunk length, heads, head dim, groups
  int Lp, Pp, Np, LW;        // padded to 4; LW: row stride of C^T / B^T
  long long x_sb, x_ss;      // element strides of x over batch and sequence
  long long b_sb, b_ss, c_sb, c_ss;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__host__ inline size_t smem_floats(const Dims& d) {
  return (size_t)2 * d.Np * d.LW + (size_t)d.Lp * d.Pp +
         (size_t)d.Lp * d.Lp + 2 * (size_t)d.Lp;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s,
                                     const float4& v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ c, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ cum_out,
                 Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int L = d.L, N = d.N, P = d.P, H = d.H;
  const int Lp = d.Lp, Pp = d.Pp, Np = d.Np, LW = d.LW;
  float* cT = sm;                  // c[l][n] at cT[n * LW + l]
  float* bT = cT + Np * LW;        // b[m][n] at bT[n * LW + m]
  float* xs = bT + Np * LW;        // x[m][p] at xs[m * Pp + p]
  float* W = xs + Lp * Pp;         // W[l][m] at W[l * Lp + m]
  float* cum = W + Lp * Lp;
  float* dts = cum + Lp;           // dt, later dte

  const int h = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / d.G);
  const int tid = threadIdx.x;
  const long long s0 = (long long)ci * L;
  const long long S = (long long)d.nc * L;

  // ---- stage the tile (zero padding beyond L, P, N) ----------------------
  for (int i = tid; i < Lp * Pp; i += THREADS) {
    const int l = i / Pp, p = i % Pp;
    xs[i] = (l < L && p < P)
                ? to_f(x[bi * d.x_sb + (s0 + l) * d.x_ss + (long long)h * P + p])
                : 0.f;
  }
  for (int i = tid; i < Lp * Np; i += THREADS) {
    const int l = i / Np, n = i % Np;
    float bv = 0.f, cv = 0.f;
    if (l < L && n < N) {
      const long long row = (long long)g * N + n;
      bv = to_f(b[bi * d.b_sb + (s0 + l) * d.b_ss + row]);
      cv = to_f(c[bi * d.c_sb + (s0 + l) * d.c_ss + row]);
    }
    bT[n * LW + l] = bv;
    cT[n * LW + l] = cv;
  }
  for (int i = tid; i < Lp * Lp; i += THREADS) W[i] = 0.f;
  for (int l = tid; l < Lp; l += THREADS) {
    dts[l] = l < L ? dt[((long long)bi * S + s0 + l) * H + h] : 0.f;
    cum[l] = 0.f;
  }
  __syncthreads();

  // ---- cum: one warp, a serial run per lane then a shuffle scan ----------
  if (tid < 32) {
    const float ah = a[h];
    const int per = (L + 31) / 32, l0 = tid * per;
    float run = 0.f;
    for (int j = 0; j < per; ++j) {
      const int l = l0 + j;
      if (l < L) {
        run += dts[l] * ah;
        cum[l] = run;
      }
    }
    float tot = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, tot, off);
      if (tid >= off) tot += v;
    }
    const float before = tot - run;
    for (int j = 0; j < per; ++j) {
      const int l = l0 + j;
      if (l < L) cum[l] += before;
    }
  }
  __syncthreads();
  const long long tile = (long long)bi * d.nc + ci;
  for (int l = tid; l < L; l += THREADS)
    cum_out[(tile * L + l) * H + h] = cum[l];

  // ---- 1. W = (C B^T) o e^{cum_l - cum_m} o dt_m, lower triangle ---------
  const int nt = Lp / 4;
  const int n_tri = nt * (nt + 1) / 2;
  for (int t = tid; t < n_tri; t += THREADS) {
    int li = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (li * (li + 1) / 2 > t) --li;
    while ((li + 1) * (li + 2) / 2 <= t) ++li;
    const int mi = t - li * (li + 1) / 2;
    const int l0 = 4 * li, m0 = 4 * mi;
    float acc[4][4] = {};
    for (int k = 0; k < N; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(&cT[k * LW + l0]);
      const float4 bv = *reinterpret_cast<const float4*>(&bT[k * LW + m0]);
      fma4(acc[0], cv.x, bv);
      fma4(acc[1], cv.y, bv);
      fma4(acc[2], cv.z, bv);
      fma4(acc[3], cv.w, bv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + j;
        // mask first: the exponential of a masked entry is never taken
        o[j] = (m <= l && l < L) ? acc[i][j] * expf(cum[l] - cum[m]) * dts[m]
                                 : 0.f;
      }
      *reinterpret_cast<float4*>(&W[l * Lp + m0]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // dte[m] = e^{cum_{L-1} - cum_m} dt_m (dts is no longer read as dt)
  const float cl = cum[L - 1];
  for (int m = tid; m < L; m += THREADS) dts[m] = expf(cl - cum[m]) * dts[m];
  __syncthreads();

  // ---- 2. y_intra = W x over m <= l --------------------------------------
  const int npt = Pp / 4;
  for (int t = tid; t < nt * npt; t += THREADS) {
    const int l0 = 4 * (t / npt), p0 = 4 * (t % npt);
    if (l0 >= L) continue;
    float acc[4][4] = {};
    const int mend = min(l0 + 4, Lp);
    for (int m0 = 0; m0 < mend; m0 += 4) {
      float4 xr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[j] = *reinterpret_cast<const float4*>(&xs[(m0 + j) * Pp + p0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(
            &W[(l0 + i) * Lp + m0]);
        fma4(acc[i], w.x, xr[0]);
        fma4(acc[i], w.y, xr[1]);
        fma4(acc[i], w.z, xr[2]);
        fma4(acc[i], w.w, xr[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      if (l >= L) continue;
      float* yrow = y + ((tile * L + l) * H + h) * (long long)P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < P) yrow[p0 + j] = acc[i][j];
    }
  }

  // ---- 3. state = (B o dte)^T x ------------------------------------------
  const int nn = Np / 4;
  for (int t = tid; t < nn * npt; t += THREADS) {
    const int n0 = 4 * (t / npt), p0 = 4 * (t % npt);
    float acc[4][4] = {};
    for (int m0 = 0; m0 < Lp; m0 += 4) {
      const float4 e = *reinterpret_cast<const float4*>(&dts[m0]);
      float4 xr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[j] = *reinterpret_cast<const float4*>(&xs[(m0 + j) * Pp + p0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 bv = *reinterpret_cast<const float4*>(
            &bT[(n0 + i) * LW + m0]);
        fma4(acc[i], bv.x * e.x, xr[0]);
        fma4(acc[i], bv.y * e.y, xr[1]);
        fma4(acc[i], bv.z * e.z, xr[2]);
        fma4(acc[i], bv.w * e.w, xr[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      if (n >= N) continue;
      float* srow = st + ((tile * H + h) * N + n) * (long long)P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < P) srow[p0 + j] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* st, void* cum, int bs, Dims d,
           void* stream) {
  d.Lp = round4(d.L);
  d.Pp = round4(d.P);
  d.Np = round4(d.N);
  d.LW = d.Lp + 4;        // padded rows: fewer bank conflicts on staging
  if (smem_floats(d) * sizeof(float) > (size_t)SMEM_MAX) d.LW = d.Lp;
  const size_t smem = smem_floats(d) * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.H, d.nc, bs);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b,
      (const T*)c, (float*)y, (float*)st, (float*)cum, d);
  return (int)cudaGetLastError();
}

}  // namespace ssd

#define SSD_CHUNKS_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* x, const void* dt, const void* a,           \
                      const void* b, const void* c, void* y, void* st,        \
                      void* cum, int bs, int nc, int L, int H, int P, int G,  \
                      int N, long long x_sb, long long x_ss, long long b_sb,  \
                      long long b_ss, long long c_sb, long long c_ss,         \
                      void* stream) {                                         \
    ssd::Dims d{nc, L, H, P, G, N, 0, 0, 0, 0, x_sb, x_ss, b_sb, b_ss, c_sb,  \
                c_ss};                                                        \
    return ssd::launch<T>(x, dt, a, b, c, y, st, cum, bs, d, stream);         \
  }

SSD_CHUNKS_ENTRY(ssd_chunks_f32, float)
SSD_CHUNKS_ENTRY(ssd_chunks_bf16, __nv_bfloat16)
