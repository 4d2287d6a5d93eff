// Mamba-2 SSD chunk step: for one (batch, chunk, head) tile of L steps,
//   cum[l]      = sum_{j<=l} dt[j] a                  (log-decay from start)
//   y_intra[l]  = sum_{m<=l} (c_l . b_m) e^{cum_l - cum_m} dt_m x_m
//   state       = sum_m e^{cum_{L-1} - cum_m} dt_m b_m x_m^T      (N x P)
// all in f32 from f32 or bf16 inputs.
//
// Replaces the Pallas kernel src/repro/kernels/ssd/kernel.py:ssd_chunks
// (body _ssd_chunk_kernel; pallas_call at kernel.py:74), whose tile holds
// every head of one (batch, chunk) pair - a few MB of TPU VMEM.  Here a
// block holds one head of one chunk: grid (H, NC, B).  B and C are read per
// group (head h uses group h / (H/G)) straight from the projection output
// through its strides: at G = 1 nothing is repeated over heads in device
// memory, and no (B,S,H,N) copy is made.
//
// What bounds it on the H100 (Zamba2-2.7B prefill, B = 2, S = 8,192,
// H = 80, P = N = 64, G = 1, bf16 in): the data it must move once is
// x (168 MB), dt (5 MB), b and c (4 MB) and its f32 outputs y_intra
// (336 MB), states (168 MB) and cum (5 MB): ~0.69 GB, ~0.21 ms at
// 3.35 TB/s.  Its products (C B^T and the weighted sum over the lower
// triangle, the state product over the whole chunk) are ~3.1 MFLOP per
// block, ~32 GFLOP in all: ~0.03 ms at the bf16 tensor-core peak, so it is
// bound by bytes.  The mask m <= l is applied BEFORE the exponential in
// both bodies: over a chunk cum falls to about -1,400, so e^{cum_l - cum_m}
// for m > l would be inf and inf * 0 NaN.  Two bodies, chosen by
// kernels/ssd/kernel.py:ssd_body from the dtype, shape and layout:
//
// * bf16 (ssd_tc::ssd_chunk_tc_kernel, ssd_chunks_tc_bf16) runs the three
//   products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulators), in the idiom of the flash-attention kernel.  4 warps;
//   x (L x P), B and C (L x N) are staged as bf16 with 16-byte cp.async
//   copies into rows padded by 16 bytes (an odd number of 16-byte chunks,
//   so ldmatrix's eight row addresses fall in eight bank groups): ~57 KB
//   at L = 128, N = P = 64, so three to four blocks share an SM and one
//   block's loads overlap another's products.  While the copies fly, one
//   warp scans cum from dt (scan_cum: f64 sums, rounded once).  Each warp
//   then owns two 16-row tiles of y, l-tiles w and L/16 - 1 - w (the
//   causal triangle's short and long rows, so the warps' work is even);
//   for each 16-column tile m <= l it
//   forms S = C B^T (C's A fragments held in registers through ldmatrix,
//   B by ldmatrix), turns the f32 accumulators into W in registers
//   (mask, then e^{cum_l - cum_m} dt_m), splits W into bf16 hi + lo
//   (hi = bf16(w), lo = bf16(w - hi): ~16 bits of w, as the flash kernel
//   splits P), and feeds both halves as A fragments straight into
//   y += W x, with x through ldmatrix.trans; tiles wholly above the
//   diagonal are skipped.  The chunk state (B o dte)^T x takes B^T's A
//   fragments through ldmatrix.trans, scales them by dte in f32 and
//   splits them the same way.  y and the state are written from the
//   accumulators as float2s.  Exact instantiations for (N, P) = (64, 64)
//   (Zamba2) and (128, 64) (Mamba-2-2.7B); a guarded one takes any
//   N % 8 == 0 and P % 8 == 0 up to 128 (zero columns pad both to 16).
//   It needs L % 16 == 0, L <= 128, 16-byte aligned base pointers and
//   strides that are multiples of 8 elements; any other bf16 input runs
//   the CUDA-core body.
// * f32, and bf16 outside the tensor-core body's reach
//   (ssd::ssd_chunk_kernel, ssd_chunks_{f32,bf16}), stays on the CUDA
//   cores: TF32 products keep ~10 bits and would break the f32 bar of
//   1e-4 of max |ref|.  256 threads; the block stages x, C^T, B^T and dt
//   in shared memory as f32 (rows padded with zeros to a multiple of 4 so
//   every product reads float4s): at L = 128, N = P = 64, C^T and B^T
//   (2 x 33 KB), x (32 KB), the L x L weights (64 KB) and cum/dt, 163 KB
//   of the 227 KB a block may use, so one block per SM and no overlap of
//   one block's loads with another's products.  It scans cum with one
//   warp (scan_cum), then
//   1. W = (C B^T) o decay o dt over the lower-triangular 4x4 tiles only
//      (tiles above the diagonal stay zero);
//   2. y_intra = W x, each 4x4 tile summing only m <= l;
//   3. state = (B o dte)^T x with dte = e^{cum_{L-1} - cum_m} dt_m.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// cum[l] = sum_{j <= l} dt[j] a for one warp (lane = its lane): each step
// dt[j] a rounded to f32, the running sum taken in f64 (a serial run per
// lane, then a shuffle scan) and rounded once.  Over a chunk |cum| reaches
// ~1,400, where an f32 running sum drifts by ~1e-4 and e^{cum_l - cum_m}
// with it; the f64 sum gives the same bits in any order, so the plain
// version (an f64 cumsum, rounded once) and the backward agree with it.
__device__ __forceinline__ void scan_cum(const float* dts, float ah,
                                         float* cum, int L, int lane) {
  const int per = (L + 31) / 32, l0 = lane * per;
  double run = 0.0;
  for (int j = 0; j < per; ++j) {
    const int l = l0 + j;
    if (l < L) {
      const float step = dts[l] * ah;
      run += (double)step;
    }
  }
  double tot = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, tot, 1);   // lanes before this
  if (lane == 0) acc = 0.0;
  for (int j = 0; j < per; ++j) {
    const int l = l0 + j;
    if (l < L) {
      const float step = dts[l] * ah;
      acc += (double)step;
      cum[l] = (float)acc;
    }
  }
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
  if (tid < 32) scan_cum(dts, a[h], cum, L, tid);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------
namespace ssd_tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;                 // warps per block
constexpr int THREADS = 32 * NW;
constexpr int MIN_BLOCKS = 3;         // blocks per SM (exact bodies)
constexpr int LMAX = 128;             // chunk length bound
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the
// low half of each register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

struct Args {
  int nc, L, H, P, G, N;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// Copy ``rows`` rows of ``nch`` 16-byte chunks (row r from src + r * stride)
// into shared memory at ``dst`` with a row stride of ``ld`` elements.
template <int NCH>
__device__ __forceinline__ void load_rows(uint32_t dst, int ld,
                                          const bf16* src, long long stride,
                                          int rows, int nch) {
  const int n = NCH > 0 ? NCH : nch;
  for (int c = threadIdx.x; c < rows * n; c += THREADS) {
    const int r = c / n, ch = c - r * n;
    cp_async16(dst + 2u * (r * ld + 8 * ch), src + r * stride + 8 * ch);
  }
}

// NK: k-steps of 16 over N; NP: 8-column tiles over P.  EXACT: N == 16 NK
// and P == 8 NP, so no step is guarded at run time.
template <int NK, int NP, bool EXACT>
__global__ void __launch_bounds__(THREADS, EXACT ? MIN_BLOCKS : 1)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ b,
                    const bf16* __restrict__ c, float* __restrict__ y,
                    float* __restrict__ st, float* __restrict__ cum_out,
                    Args d) {
  constexpr int LDB = 16 * NK + 8;    // row strides in elements: an odd
  constexpr int LDX = 8 * NP + 8;     // number of 16-byte chunks
  static_assert(NP % 2 == 0, "x is read 16 columns at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = d.L, H = d.H;
  const int N = EXACT ? 16 * NK : d.N, P = EXACT ? 8 * NP : d.P;
  const int nk = (N + 15) / 16, np = (P + 7) / 8;
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // c[l][n] at cs[l * LDB + n]
  bf16* bs = cs + L * LDB;                        // b[m][n] at bs[m * LDB + n]
  bf16* xs = bs + L * LDB;                        // x[m][p] at xs[m * LDX + p]
  float* cum = reinterpret_cast<float*>(xs + L * LDX);
  float* dts = cum + L;
  float* dte = dts + L;

  const int h = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (H / d.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const long long s0 = (long long)ci * L;
  const long long S = (long long)d.nc * L;
  const long long tile = (long long)bi * d.nc + ci;

  // ---- stage C, B and x (cp.async); dt and the scan meanwhile ----------
  const uint32_t cs_a = smem_addr(cs), bs_a = smem_addr(bs),
                 xs_a = smem_addr(xs);
  load_rows<EXACT ? 2 * NK : 0>(
      cs_a, LDB, c + bi * d.c_sb + s0 * d.c_ss + (long long)grp * N, d.c_ss,
      L, N / 8);
  load_rows<EXACT ? 2 * NK : 0>(
      bs_a, LDB, b + bi * d.b_sb + s0 * d.b_ss + (long long)grp * N, d.b_ss,
      L, N / 8);
  load_rows<EXACT ? NP : 0>(
      xs_a, LDX, x + bi * d.x_sb + s0 * d.x_ss + (long long)h * P, d.x_ss, L,
      P / 8);
  if (!EXACT && ((P | N) & 15)) {
    // zero pad columns: B's and C's add nothing to S = C B^T, and x's feed
    // only y's and the state's columns past P, which are not stored
    for (int r = tid; r < L; r += THREADS) {
      if (P & 15)
        *reinterpret_cast<uint4*>(xs + r * LDX + P) = make_uint4(0, 0, 0, 0);
      if (N & 15) {
        *reinterpret_cast<uint4*>(cs + r * LDB + N) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(bs + r * LDB + N) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  for (int l = tid; l < L; l += THREADS)
    dts[l] = dt[((long long)bi * S + s0 + l) * H + h];
  __syncthreads();
  if (warp == 0)            // cum: a serial run per lane, then a shuffle scan
    ssd::scan_cum(dts, a[h], cum, L, lane);
  __syncthreads();
  for (int l = tid; l < L; l += THREADS) {
    cum_out[(tile * L + l) * H + h] = cum[l];
    dte[l] = expf(cum[L - 1] - cum[l]) * dts[l];
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- y = W x: warp w takes l-tiles w and LT - 1 - w ------------------
  const int LT = L / 16;
  // lane offsets of ldmatrix: B (non-trans, as mma's col operand), x and
  // B^T (trans): see the flash-attention kernel's K and V
  const uint32_t b_lane = 2u * (((lane & 7) + 8 * (lane >> 4)) * LDB +
                                8 * ((lane >> 3) & 1));
  const uint32_t x_lane = 2u * (((lane & 7) + 8 * ((lane >> 3) & 1)) * LDX +
                                8 * (lane >> 4));
  for (int pi = warp; pi < (LT + 1) / 2; pi += NW) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int rt = half ? LT - 1 - pi : pi;
      if (half && rt == pi) break;
      const int l0 = 16 * rt;
      // C's A fragments for the tile's rows: lane addresses row l % 16,
      // column 8 (l / 16)
      uint32_t cf[NK][4];
      const uint32_t ca = cs_a + 2u * ((l0 + (lane & 15)) * LDB +
                                       8 * (lane >> 4));
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (EXACT || kk < nk) ldsm_x4(ca + 32u * kk, cf[kk]);
      const float cl0 = cum[l0 + g], cl1 = cum[l0 + g + 8];
      float yacc[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
      for (int kt = 0; kt <= rt; ++kt) {
        const int m0 = 16 * kt;
        // S = C B^T for columns m0 .. m0 + 15: two n-tiles of 8
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (!EXACT && kk >= nk) continue;
          uint32_t bf[4];
          ldsm_x4(bs_a + b_lane + 2u * (m0 * LDB + 16 * kk), bf);
          mma16816(s[0], cf[kk], bf[0], bf[1]);
          mma16816(s[1], cf[kk], bf[2], bf[3]);
        }
        // W on the accumulators: s[j][0..1] are row l0 + g, columns
        // m0 + 8j + 2tq + {0,1}; s[j][2..3] row l0 + g + 8.  Mask first.
        uint32_t wh[4], wl[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m0 + 8 * j + 2 * tq;
          const float2 cm = *reinterpret_cast<const float2*>(cum + m);
          const float2 dm = *reinterpret_cast<const float2*>(dts + m);
          const int r0 = l0 + g, r1 = r0 + 8;
          const float w0 = m <= r0 ? s[j][0] * expf(cl0 - cm.x) * dm.x : 0.f;
          const float w1 = m + 1 <= r0 ? s[j][1] * expf(cl0 - cm.y) * dm.y
                                       : 0.f;
          const float w2 = m <= r1 ? s[j][2] * expf(cl1 - cm.x) * dm.x : 0.f;
          const float w3 = m + 1 <= r1 ? s[j][3] * expf(cl1 - cm.y) * dm.y
                                       : 0.f;
          // A fragment of the k-step m0: registers 0, 1 are columns 0-7
          // (rows g, g + 8), registers 2, 3 columns 8-15
          split_bf16(w0, w1, wh[2 * j], wl[2 * j]);
          split_bf16(w2, w3, wh[2 * j + 1], wl[2 * j + 1]);
        }
        // y += W x over x rows m0 .. m0 + 15
#pragma unroll
        for (int nn = 0; nn < NP / 2; ++nn) {
          if (!EXACT && 2 * nn >= np) continue;
          uint32_t xf[4];
          ldsm_x4_trans(xs_a + x_lane + 2u * (m0 * LDX + 16 * nn), xf);
          mma16816(yacc[2 * nn], wh, xf[0], xf[1]);
          mma16816(yacc[2 * nn + 1], wh, xf[2], xf[3]);
          mma16816(yacc[2 * nn], wl, xf[0], xf[1]);   // lo
          mma16816(yacc[2 * nn + 1], wl, xf[2], xf[3]);   // lo
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = l0 + g + 8 * r;
        float* yrow = y + ((tile * L + l) * H + h) * (long long)P;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (!EXACT && j >= np) continue;
          *reinterpret_cast<float2*>(yrow + 8 * j + 2 * tq) =
              make_float2(yacc[j][2 * r], yacc[j][2 * r + 1]);
        }
      }
    }
  }

  // ---- state = (B o dte)^T x: 16 x 16 output tiles over the warps ------
  // B^T's A fragments come from the same lane addresses as B's col
  // operand above (row m0 + l % 8 + 8 (l / 16), column n0 + 8 ((l / 8) & 1)),
  // read with ldmatrix.trans
  const int npp = (np + 1) / 2;
  for (int u = warp; u < nk * npp; u += NW) {
    const int n0 = 16 * (u / npp), p0 = 16 * (u % npp);
    float acc[2][4] = {};
    for (int kt = 0; kt < LT; ++kt) {
      const int m0 = 16 * kt;
      uint32_t bf[4], bh[4], bl[4];
      ldsm_x4_trans(bs_a + b_lane + 2u * (m0 * LDB + n0), bf);
      // registers 0, 1 hold columns m0 + 2tq + {0,1}; 2, 3 the same + 8
      const float2 e0 = *reinterpret_cast<const float2*>(dte + m0 + 2 * tq);
      const float2 e1 =
          *reinterpret_cast<const float2*>(dte + m0 + 8 + 2 * tq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(bf[r]);
        const float2 e = r < 2 ? e0 : e1;
        split_bf16(v.x * e.x, v.y * e.y, bh[r], bl[r]);
      }
      uint32_t xf[4];
      ldsm_x4_trans(xs_a + x_lane + 2u * (m0 * LDX + p0), xf);
      mma16816(acc[0], bh, xf[0], xf[1]);
      mma16816(acc[1], bh, xf[2], xf[3]);
      mma16816(acc[0], bl, xf[0], xf[1]);   // lo
      mma16816(acc[1], bl, xf[2], xf[3]);   // lo
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + g + 8 * r;
      if (!EXACT && n >= N) continue;
      float* srow = st + ((tile * H + h) * N + n) * (long long)P;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = p0 + 8 * j + 2 * tq;
        if (EXACT || col < P)
          *reinterpret_cast<float2*>(srow + col) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

template <int NK, int NP, bool EXACT>
int launch_body(const void* x, const void* dt, const void* a, const void* b,
                const void* c, void* y, void* st, void* cum, int bs,
                const Args& d, void* stream) {
  const size_t smem = 2 * ((size_t)2 * d.L * (16 * NK + 8) +
                           (size_t)d.L * (8 * NP + 8)) +
                      3 * sizeof(float) * d.L;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto* kern = ssd_chunk_tc_kernel<NK, NP, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.H, d.nc, bs);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)a, (const bf16*)b,
      (const bf16*)c, (float*)y, (float*)st, (float*)cum, d);
  return (int)cudaGetLastError();
}

// The shapes and layouts the body takes (kernel.py:tc_takes says the same
// before launch); anything else is refused, never run.
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* st, void* cum, int bs,
           const Args& d, void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 == 0 &&
      (d.x_sb | d.x_ss | d.b_sb | d.b_ss | d.c_sb | d.c_ss) % 8 == 0;
  if (d.L % 16 || d.L <= 0 || d.L > LMAX || d.N % 8 || d.N <= 0 ||
      d.N > 128 || d.P % 8 || d.P <= 0 || d.P > 128 || !aligned)
    return (int)cudaErrorInvalidValue;
  if (d.N == 64 && d.P == 64)
    return launch_body<4, 8, true>(x, dt, a, b, c, y, st, cum, bs, d, stream);
  if (d.N == 128 && d.P == 64)
    return launch_body<8, 8, true>(x, dt, a, b, c, y, st, cum, bs, d, stream);
  return launch_body<8, 16, false>(x, dt, a, b, c, y, st, cum, bs, d, stream);
}

}  // namespace ssd_tc

#define SSD_CHUNKS_ARGS                                                       \
  const void *x, const void *dt, const void *a, const void *b, const void *c, \
      void *y, void *st, void *cum, int bs, int nc, int L, int H, int P,      \
      int G, int N, long long x_sb, long long x_ss, long long b_sb,           \
      long long b_ss, long long c_sb, long long c_ss, void *stream

#define SSD_CHUNKS_ENTRY(NAME, T)                                             \
  extern "C" int NAME(SSD_CHUNKS_ARGS) {                                      \
    ssd::Dims d{nc, L, H, P, G, N, 0, 0, 0, 0, x_sb, x_ss, b_sb, b_ss, c_sb,  \
                c_ss};                                                        \
    return ssd::launch<T>(x, dt, a, b, c, y, st, cum, bs, d, stream);         \
  }

SSD_CHUNKS_ENTRY(ssd_chunks_f32, float)
SSD_CHUNKS_ENTRY(ssd_chunks_bf16, __nv_bfloat16)

extern "C" int ssd_chunks_tc_bf16(SSD_CHUNKS_ARGS) {
  ssd_tc::Args d{nc, L, H, P, G, N, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  return ssd_tc::launch(x, dt, a, b, c, y, st, cum, bs, d, stream);
}
