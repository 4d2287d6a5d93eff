// Mamba-2 SSD chunk step, backward: the gradient of ssd_chunks.cu's
// (y_intra, states, cum) with respect to (x, dt, a, b, c).  For one
// (batch, chunk, head) tile of L steps, with E_lm = e^{cum_l - cum_m} on
// m <= l, W~ = (C B^T) o E, W = W~ diag(dt) and dte_m = e^{cum_{L-1} -
// cum_m} dt_m, given dY (L x P), dS (N x P) and dcum (L):
//   dX   = W^T dY + diag(dte) B dS
//   dS'  = (dY X^T) o E diag(dt)            (the gradient of C B^T)
//   dC_h = dS' B,  dB_h = dS'^T C + diag(dte) X dS^T
//   d(dt)_m = (X o W~^T dY)_m 1 + G_m e^{cum_{L-1} - cum_m} + a R_m
//   da_h = sum_m R_m dt_m
// where G_m = sum_{n,p} b_mn x_mp dS_np and R_m = sum_{l >= m} dcum'_l, the
// reverse cumulative sum of the total gradient of cum:
//   dcum'_l = dcum_l + rowsum_l(dseg) - colsum_l(dseg) - G_l dte_l
//             (+ sum_m G_m dte_m at l = L-1),   dseg = (dY X^T) o W.
// The row and column sums of dseg are taken without an L x L tile of it:
// rowsum_l = dY_l . (W X)_l and colsum_m = dt_m (X_m . (W~^T dY)_m).  Both
// leave out the diagonal, whose term cancels between them, and the state
// term leaves out m = L-1 for the same reason: where a decays fast W is
// nearly diagonal, and the two large terms would cancel only to rounding
// (in a CPU emulation at Zamba2's widths, twice the plain version's error
// in da).  The scan of dcum' and the sums of the state term and of da_h run
// in f64.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// jnp ssd_chunked (src/repro/models/ssm.py:61), so it has no SSD backward
// kernel.  The port's forward is a kernel, so its gradient is one too.
//
// What bounds it on the H100 (Mamba-2-2.7B's training microbatch, B = 2,
// S = 4,096, H = 80, P = 64, N = 128, G = 1, bf16 in): the work needs
// ~0.43 GB read (x, dt, a, b, c, cum, dY, dS, dcum) and ~0.09 GB written
// (dx, d(dt), da, dB and dC at the group's width) and ~64 GFLOP of
// products over the causal triangle (launch/roofline.py:ssd_bwd_work):
// 0.16 ms at 3.35 TB/s, 0.07 ms at the bf16 tensor-core peak, so bytes.
// Two bodies, chosen by kernels/ssd/kernel.py:ssd_bwd_body; every sum runs
// in a fixed order and no atomics are used, so two calls are bitwise equal.
//
// * bf16 (ssdb_tc::ssd_chunk_bwd_tc_kernel, ssd_chunks_bwd_tc_bf16) runs
//   every product on the tensor cores with flash attention's toolset
//   (../../attention/csrc/fa_common.cuh: mma.sync m16n8k16, bf16 in, f32
//   sums; ldmatrix / ldmatrix.trans; 16-byte cp.async into rows padded by
//   16 bytes).  x, B and C are exact in bf16, so a product of two of them
//   is one mma; dY and dS are split once into bf16 halves hi = bf16(v),
//   lo = bf16(v - hi) as they are staged, and the W~, W and dS' tiles
//   formed on the f32 accumulators are split the same way in registers:
//   an f32 operand against an exact one is two mma, W~^T dY (both f32)
//   three, hi hi + hi lo + lo hi (~16 bits of each; with hi alone phase
//   U's 5e-4 bar fails, tests/test_torch_ssd_backward_tc.py).  8 warps;
//   no L x L tile in shared memory: warp w owns m-tile w (16 rows m) and
//   l-tile w, LT - w + w + 1 tile pairs for every warp.  Over its m-tile
//   it recomputes each 16 x 16 S^T = B C^T and dW^T = X dY^T for l >= m
//   (tiles wholly above the diagonal skipped), sums dX's W~^T dY and dB's
//   dS'^T C, then the column sums x_m . (W~^T dY)_m, then the diagonal
//   tile's diagonal (kept apart in its own fragment) into the same sums
//   and q_m, then the state terms B dS (dX, G) and X dS^T (dB); dX is
//   written there, in x's dtype when the caller casts.  Over its l-tile
//   it recomputes S = C B^T and dW = dY X^T for m <= l, sums dC's dS' B
//   and W x (dt folded into W, m < l), and takes the row sums dY_l .
//   (W x)_l.  Then dB and dC (f32) are parked over the inputs' bytes,
//   and a cluster of K blocks, K consecutive heads of one group
//   (cudaLaunchKernelEx; clusters need sm_90 or later, and the build
//   targets sm_90a), sums them through
//   distributed shared memory: block r adds rows [r L / K, (r+1) L / K)
//   of the K blocks in rank order and writes (B, S, H / K, N) f32, one
//   torch sum folding the rest (84 MB at mamba2's microbatch against the
//   CUDA-core body's 671 MB of per-head partials).  Warp 0 then scans
//   dcum' in reverse over its lanes (f64: a serial run per lane, a
//   shuffle scan) and writes d(dt) and da_h.  Block: 165,376 bytes of
//   shared memory at N = 128, P = 64 (114,176 at N = 64), 255 / 194
//   registers a thread (the dB and dC accumulators live to the end):
//   one block an SM.  Exact instantiations (N, P) = (128, 64) and
//   (64, 64); a guarded one takes N, P multiples of 8 up to 128 (zero
//   pad columns and dS rows) where the block fits.  It needs L % 16 == 0,
//   L <= 128, 16-byte aligned x / b / c and strides that are multiples of
//   8 elements; any other bf16 input runs the CUDA-core body.
// * f32, and bf16 outside the tensor-core body's reach (ssdb::
//   ssd_chunk_bwd_kernel, ssd_chunks_bwd_{f32,bf16}): f32 products on the
//   CUDA cores (TF32 would break f32's 1e-4 bar), 256 threads a block,
//   grid (H, NC, B) as the forward's.  The block stages its tiles in
//   shared memory as f32, rows padded to a multiple of 4 (plus 4 against
//   bank conflicts where the budget allows), and reuses three regions
//   across the phases, reloading B, C and x from device memory (L2)
//   rather than holding all of them at once:
//   1. C, B          -> W~ (lower-triangular 4x4 tiles; the mask m <= l is
//                       applied BEFORE the exponential, as the forward
//                       does: e^{cum_l - cum_m} for m > l overflows to inf
//                       and inf * 0 is NaN);
//   2. dY, x         -> dX = dt o W~^T dY (written to dx), the x . (W~^T dY)
//                       partials (with and without the diagonal) and the
//                       dY . (W x) ones (without), then W~ overwritten by
//                       dS';
//   3. C, B          -> dC_h, dB_h (per head, f32, to partial buffers);
//   4. x, dS (B kept)-> dX += dte o B dS, dB_h += dte o X dS^T, G;
//   5. one thread: the state terms into dcum', the reverse scan, d(dt),
//      da_h.
//   dB and dC leave per head, (B, S, H, N) f32 (671 MB at mamba2's
//   microbatch, read again by the group sum); dx and d(dt) in f32.  Its
//   ~70 GFLOP (the products plus W x, recomputed for the row sums) run
//   from shared memory at ~10 TFLOP/s.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../attention/csrc/fa_common.cuh"

namespace ssdb {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Dims {
  int nc, L, H, P, G, N;
  int Lp, Pp, Np;            // padded to a multiple of 4
  int LS, PS, NS;            // row strides of the L-, P- and N-wide tiles
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The three tile regions, in floats: RM (W~, then dS'; then dS), R1 (C, dY,
// C, x), R2 (B, x, B).
__host__ __device__ inline int region_m(const Dims& d) {
  return imax(d.Lp * d.LS, d.Np * d.PS);
}
__host__ __device__ inline int region_1(const Dims& d) {
  return imax(d.Lp * d.NS, d.Lp * d.PS);
}
__host__ inline size_t smem_floats(const Dims& d) {
  return (size_t)region_m(d) + 2 * (size_t)region_1(d) +
         6 * (size_t)d.Lp + 3 * (size_t)d.Lp * (d.Pp / 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void fma4(float (&acc)[4], float s,
                                     const float4& v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}
__device__ __forceinline__ float dot4(const float4& u, const float4& v,
                                      float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ void zero_comp(float4& v, int j) {
  if (j == 0) v.x = 0.f;
  else if (j == 1) v.y = 0.f;
  else if (j == 2) v.z = 0.f;
  else v.w = 0.f;
}
__device__ __forceinline__ float4 axpy4(float s, const float4& u,
                                       const float4& v) {   // s u + v
  return make_float4(fmaf(s, u.x, v.x), fmaf(s, u.y, v.y),
                     fmaf(s, u.z, v.z), fmaf(s, u.w, v.w));
}

// rows x cols of a row-major source (row stride rs elements) into a tile of
// row stride ld, zero beyond rows / cols up to rows_p / cols_p
template <typename T>
__device__ void stage(float* dst, int ld, int rows_p, int cols_p, int rows,
                      int cols, const T* __restrict__ src, long long rs) {
  for (int i = threadIdx.x; i < rows_p * cols_p; i += THREADS) {
    const int r = i / cols_p, k = i % cols_p;
    dst[r * ld + k] =
        (r < rows && k < cols) ? to_f(src[(long long)r * rs + k]) : 0.f;
  }
}

// the t-th lower-triangular 4x4 tile (li >= mi)
__device__ __forceinline__ void tri_tile(int t, int& li, int& mi) {
  li = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (li * (li + 1) / 2 > t) --li;
  while ((li + 1) * (li + 2) / 2 <= t) ++li;
  mi = t - li * (li + 1) / 2;
}

// acc[i][j] = row (r0 + i) of U . row (c0 + j) of V over k < kp (both
// row-major, row strides lu and lv)
__device__ __forceinline__ void gram4(float (&acc)[4][4], const float* U,
                                     int lu, int r0, const float* V, int lv,
                                     int c0, int kp) {
  for (int k = 0; k < kp; k += 4) {
    float4 u[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = ld4(U + (r0 + i) * lu + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ld4(V + (c0 + j) * lv + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(u[i], v[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ c, const float* __restrict__ cum_in,
                     const float* __restrict__ dy,
                     const float* __restrict__ dst,
                     const float* __restrict__ dcum_in,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ da_part, float* __restrict__ db_part,
                     float* __restrict__ dc_part, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int L = d.L, N = d.N, P = d.P, H = d.H;
  const int Lp = d.Lp, Pp = d.Pp, Np = d.Np;
  const int LS = d.LS, PS = d.PS, NS = d.NS;
  float* M = sm;                       // W~, then dS' (L x L); then dS
  float* R1 = M + region_m(d);
  float* R2 = R1 + region_1(d);
  float* cum = R2 + region_1(d);
  float* dtv = cum + Lp;
  float* dacc = dtv + Lp;              // dcum'
  float* q = dacc + Lp;                // x . (W~^T dY)
  float* gm = q + Lp;                  // G
  float* ebuf = gm + Lp;               // e^{cum_{L-1} - cum_m}
  const int np4 = Pp / 4, nn4 = Np / 4, nl4 = Lp / 4;
  float* partA = ebuf + Lp;            // [Lp][np4]: q, then G
  float* partB = partA + Lp * np4;     // [Lp][np4]: dseg's row sums
  float* partC = partB + Lp * np4;     // [Lp][np4]: dseg's column sums

  const int h = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / d.G);
  const int tid = threadIdx.x;
  const long long s0 = (long long)ci * L;
  const long long S = (long long)d.nc * L;
  const long long tile = (long long)bi * d.nc + ci;
  const T* xs = x + bi * d.x_sb + s0 * d.x_ss + (long long)h * P;
  const T* bs = b + bi * d.b_sb + s0 * d.b_ss + (long long)g * N;
  const T* cs = c + bi * d.c_sb + s0 * d.c_ss + (long long)g * N;
  const float* dys = dy + (tile * L * H + h) * (long long)P;
  const float* dss = dst + (tile * H + h) * (long long)N * P;
  float* dxs = dx + ((bi * S + s0) * H + h) * (long long)P;
  float* dbs = db_part + ((bi * S + s0) * H + h) * (long long)N;
  float* dcs = dc_part + ((bi * S + s0) * H + h) * (long long)N;

  // ---- stage C, B and the per-step scalars -------------------------------
  stage(R1, NS, Lp, Np, L, N, cs, d.c_ss);
  stage(R2, NS, Lp, Np, L, N, bs, d.b_ss);
  for (int l = tid; l < Lp; l += THREADS) {
    const bool in = l < L;
    cum[l] = in ? cum_in[(tile * L + l) * H + h] : 0.f;
    dtv[l] = in ? dt[(bi * S + s0 + l) * H + h] : 0.f;
    dacc[l] = in ? dcum_in[(tile * L + l) * H + h] : 0.f;
  }
  __syncthreads();

  // ---- 1. W~ = (C B^T) o E over the lower-triangular tiles ---------------
  const int n_tri = nl4 * (nl4 + 1) / 2;
  for (int t = tid; t < n_tri; t += THREADS) {
    int li, mi;
    tri_tile(t, li, mi);
    const int l0 = 4 * li, m0 = 4 * mi;
    float acc[4][4] = {};
    gram4(acc, R1, NS, l0, R2, NS, m0, Np);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + j;
        // mask first: the exponential of a masked entry is never taken
        o[j] = (m <= l && l < L) ? acc[i][j] * expf(cum[l] - cum[m]) : 0.f;
      }
      *reinterpret_cast<float4*>(M + l * LS + m0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // ---- 2. dY into R1, x into R2 ------------------------------------------
  stage(R1, PS, Lp, Pp, L, P, dys, (long long)H * P);
  stage(R2, PS, Lp, Pp, L, P, xs, d.x_ss);
  __syncthreads();

  // 2a. dX = dt o (W~^T dY); partials of q_m = x_m . (W~^T dY)_m and of
  // the column sums x_m . (W~^T dY)_m without the diagonal term l = m
  for (int t = tid; t < nl4 * np4; t += THREADS) {
    const int m0 = 4 * (t / np4), pt = t % np4, p0 = 4 * pt;
    if (m0 >= L) continue;
    float acc[4][4] = {}, wd[4] = {};
    for (int l = m0; l < L; ++l) {
      float4 w = ld4(M + l * LS + m0);
      const float4 g4 = ld4(R1 + l * PS + p0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // the diagonal W~_ll, kept apart
        if (l == m0 + i) {
          wd[i] = comp(w, i);
          zero_comp(w, i);
        }
      }
      fma4(acc[0], w.x, g4);
      fma4(acc[1], w.y, g4);
      fma4(acc[2], w.z, g4);
      fma4(acc[3], w.w, g4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      const float4 xv = ld4(R2 + m * PS + p0);
      const float4 off = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                     acc[i][3]);
      const float4 full = axpy4(wd[i], ld4(R1 + m * PS + p0), off);
      partA[m * np4 + pt] = dot4(xv, full, 0.f);
      partC[m * np4 + pt] = dot4(xv, off, 0.f);
      if (m >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < P)
          dxs[(long long)m * H * P + p0 + j] = dtv[m] * comp(full, j);
    }
  }

  // 2b. row sums without the diagonal: dY_l . (W x)_l, W x = W~ (dt o x)
  // over m < l
  for (int t = tid; t < nl4 * np4; t += THREADS) {
    const int l0 = 4 * (t / np4), pt = t % np4, p0 = 4 * pt;
    if (l0 >= L) continue;
    float acc[4][4] = {};
    for (int m0 = 0; m0 <= l0; m0 += 4) {
      float4 xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = ld4(R2 + (m0 + j) * PS + p0);
        const float s = dtv[m0 + j];
        xv[j] = make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 w = ld4(M + (l0 + i) * LS + m0);
        if (m0 == l0) zero_comp(w, i);
        fma4(acc[i], w.x, xv[0]);
        fma4(acc[i], w.y, xv[1]);
        fma4(acc[i], w.z, xv[2]);
        fma4(acc[i], w.w, xv[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      const float4 gv = ld4(R1 + l * PS + p0);
      partB[l * np4 + pt] =
          dot4(gv, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
               0.f);
    }
  }
  __syncthreads();

  // 2c. W~ -> dS' = (dY X^T) o E o dt_m over the lower-triangular tiles
  for (int t = tid; t < n_tri; t += THREADS) {
    int li, mi;
    tri_tile(t, li, mi);
    const int l0 = 4 * li, m0 = 4 * mi;
    float acc[4][4] = {};
    gram4(acc, R1, PS, l0, R2, PS, m0, Pp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + j;
        o[j] = (m <= l && l < L)
                   ? acc[i][j] * expf(cum[l] - cum[m]) * dtv[m]
                   : 0.f;
      }
      *reinterpret_cast<float4*>(M + l * LS + m0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  // the partial sums, in a fixed order: dcum' = dcum + rowsum - colsum
  for (int l = tid; l < L; l += THREADS) {
    float qa = 0.f, rb = 0.f, qc = 0.f;
    for (int k = 0; k < np4; ++k) {
      qa += partA[l * np4 + k];
      rb += partB[l * np4 + k];
      qc += partC[l * np4 + k];
    }
    q[l] = qa;
    dacc[l] += rb - dtv[l] * qc;
  }
  __syncthreads();

  // ---- 3. C into R1, B into R2: dC_h = dS' B, dB_h = dS'^T C -------------
  stage(R1, NS, Lp, Np, L, N, cs, d.c_ss);
  stage(R2, NS, Lp, Np, L, N, bs, d.b_ss);
  __syncthreads();
  for (int t = tid; t < nl4 * nn4; t += THREADS) {
    const int l0 = 4 * (t / nn4), n0 = 4 * (t % nn4);
    if (l0 >= L) continue;
    float acc[4][4] = {};
    for (int m0 = 0; m0 <= l0; m0 += 4) {
      float4 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(R2 + (m0 + j) * NS + n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w = ld4(M + (l0 + i) * LS + m0);
        fma4(acc[i], w.x, bv[0]);
        fma4(acc[i], w.y, bv[1]);
        fma4(acc[i], w.z, bv[2]);
        fma4(acc[i], w.w, bv[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      if (l >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < N) dcs[(long long)l * H * N + n0 + j] = acc[i][j];
    }
  }
  for (int t = tid; t < nl4 * nn4; t += THREADS) {
    const int m0 = 4 * (t / nn4), n0 = 4 * (t % nn4);
    if (m0 >= L) continue;
    float acc[4][4] = {};
    for (int l = m0; l < L; ++l) {
      const float4 w = ld4(M + l * LS + m0);
      const float4 cv = ld4(R1 + l * NS + n0);
      fma4(acc[0], w.x, cv);
      fma4(acc[1], w.y, cv);
      fma4(acc[2], w.z, cv);
      fma4(acc[3], w.w, cv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      if (m >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < N) dbs[(long long)m * H * N + n0 + j] = acc[i][j];
    }
  }
  __syncthreads();

  // ---- 4. x into R1, dS into M (B stays in R2): the state terms ----------
  stage(R1, PS, Lp, Pp, L, P, xs, d.x_ss);
  stage(M, PS, Np, Pp, N, P, dss, (long long)P);
  for (int m = tid; m < Lp; m += THREADS)
    ebuf[m] = m < L ? expf(cum[L - 1] - cum[m]) : 0.f;
  __syncthreads();
  // 4a. dX += dte o (B dS); G partials x_m . (B dS)_m.  The same thread
  // wrote these dx entries in 2a (the same tile mapping).
  for (int t = tid; t < nl4 * np4; t += THREADS) {
    const int m0 = 4 * (t / np4), pt = t % np4, p0 = 4 * pt;
    if (m0 >= L) continue;
    float acc[4][4] = {};
    for (int n0 = 0; n0 < Np; n0 += 4) {
      float4 sv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[j] = ld4(M + (n0 + j) * PS + p0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 bv = ld4(R2 + (m0 + i) * NS + n0);
        fma4(acc[i], bv.x, sv[0]);
        fma4(acc[i], bv.y, sv[1]);
        fma4(acc[i], bv.z, sv[2]);
        fma4(acc[i], bv.w, sv[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      const float4 xv = ld4(R1 + m * PS + p0);
      partA[m * np4 + pt] =
          dot4(xv, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
               0.f);
      if (m >= L) continue;
      const float dte = ebuf[m] * dtv[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < P) dxs[(long long)m * H * P + p0 + j] += dte * acc[i][j];
    }
  }
  // 4b. dB_h += dte o (X dS^T).  The same thread wrote these entries in 3.
  for (int t = tid; t < nl4 * nn4; t += THREADS) {
    const int m0 = 4 * (t / nn4), n0 = 4 * (t % nn4);
    if (m0 >= L) continue;
    float acc[4][4] = {};
    gram4(acc, R1, PS, m0, M, PS, n0, Pp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      if (m >= L) continue;
      const float dte = ebuf[m] * dtv[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < N) dbs[(long long)m * H * N + n0 + j] += dte * acc[i][j];
    }
  }
  __syncthreads();
  for (int m = tid; m < L; m += THREADS) {
    float s = 0.f;
    for (int k = 0; k < np4; ++k) s += partA[m * np4 + k];
    gm[m] = s;
  }
  __syncthreads();

  // ---- 5. the state terms of dcum', the reverse scan, d(dt), da_h --------
  // (f64 sums; the term of m = L-1 cancels in dcum'_{L-1} and is left out)
  if (tid == 0) {
    double tot = 0.0;
    for (int m = 0; m < L - 1; ++m) {
      const float gd = gm[m] * ebuf[m] * dtv[m];
      tot += (double)gd;
      dacc[m] -= gd;
    }
    dacc[L - 1] += (float)tot;
    const float ah = a[h];
    double run = 0.0, da_h = 0.0;
    for (int m = L - 1; m >= 0; --m) {
      run += (double)dacc[m];
      ddt[(bi * S + s0 + m) * H + h] =
          q[m] + gm[m] * ebuf[m] + ah * (float)run;
      da_h += run * (double)dtv[m];
    }
    da_part[tile * H + h] = (float)da_h;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* cum, const void* dy, const void* dst,
           const void* dcum, void* dx, void* ddt, void* da_part,
           void* db_part, void* dc_part, int bs, Dims d, void* stream) {
  d.Lp = round4(d.L);
  d.Pp = round4(d.P);
  d.Np = round4(d.N);
  int pad = 4;                // padded rows: fewer bank conflicts
  for (;; pad -= 4) {
    d.LS = d.Lp + pad;
    d.PS = d.Pp + pad;
    d.NS = d.Np + pad;
    if (pad == 0 || smem_floats(d) * sizeof(float) <= (size_t)SMEM_MAX)
      break;
  }
  const size_t smem = smem_floats(d) * sizeof(float);
  if (smem > (size_t)SMEM_MAX || d.L <= 0 || d.G <= 0 || d.H % d.G)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.H, d.nc, bs);
  ssd_chunk_bwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b,
      (const T*)c, (const float*)cum, (const float*)dy, (const float*)dst,
      (const float*)dcum, (float*)dx, (float*)ddt, (float*)da_part,
      (float*)db_part, (float*)dc_part, d);
  return (int)cudaGetLastError();
}

}  // namespace ssdb

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 operands as bf16 hi + lo
// halves), dB and dC summed over a cluster of a group's heads
// ---------------------------------------------------------------------------
namespace ssdb_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace fa_mma;   // ../../attention/csrc/fa_common.cuh
constexpr int NW = 8;                 // warps per block
constexpr int THREADS = 32 * NW;
constexpr int LMAX = 16 * NW;         // chunk bound: an m-tile and an l-tile a warp
constexpr int KMAX = 8;               // heads a cluster (the portable bound)
constexpr int NVEC = 7;               // per-step f32 vectors
constexpr int SMEM_MAX = 232448;

struct Args {
  int nc, L, H, P, G, N, K, dx_bf16;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// The block's shared memory in bytes for template (NK, KP): x, dY's two
// halves (L x LDX bf16 each), B and C (L x LDB), dS's two halves (N
// rounded up to 16 rows x LDX); then, over the same bytes once the
// products are done, dB's and dC's parked f32 tiles (L x LDB each); then
// the per-step vectors.  kernel.py:bwd_smem_bytes says the same.
__host__ __device__ inline size_t smem_bytes(int L, int N, int NK, int KP) {
  const size_t ldx = 16 * KP + 8, ldb = 16 * NK + 8;
  const size_t nr = 16 * ((N + 15) / 16);
  const size_t inputs = 2 * (3 * L * ldx + 2 * L * ldb + 2 * nr * ldx);
  const size_t park = 4 * 2 * L * ldb;
  return (inputs > park ? inputs : park) + 4 * NVEC * (size_t)L;
}

// Copy ``rows`` rows of ``nch`` 16-byte chunks (row r from src + r * stride)
// into shared memory at ``dst`` with a row stride of ``ld`` elements.
__device__ __forceinline__ void load_rows(uint32_t dst, int ld,
                                          const bf16* src, long long stride,
                                          int rows, int nch) {
  for (int c = threadIdx.x; c < rows * nch; c += THREADS) {
    const int r = c / nch, ch = c - r * nch;
    cp_async16(dst + 2u * (r * ld + 8 * ch), src + r * stride + 8 * ch, true);
  }
}

// ``rows`` rows of ``cols`` f32 (a multiple of 4; row r from src + r *
// stride) into bf16 halves hi = bf16(v) and lo = bf16(v - hi) at rows of
// ``ld`` elements
__device__ __forceinline__ void load_split(bf16* hi, bf16* lo, int ld,
                                           const float* __restrict__ src,
                                           long long stride, int rows,
                                           int cols) {
  const int n4 = cols / 4;
  for (int i = threadIdx.x; i < rows * n4; i += THREADS) {
    const int r = i / n4, c = 4 * (i - r * n4);
    const float4 v = *reinterpret_cast<const float4*>(src + r * stride + c);
    uint2 h, l;
    split_bf16(v.x, v.y, h.x, l.x);
    split_bf16(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * ld + c) = h;
    *reinterpret_cast<uint2*>(lo + r * ld + c) = l;
  }
}

__device__ __forceinline__ float2 bf2f(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum over a quad of lanes (the four threads of one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NK: k-steps of 16 over N (and n-tile pairs of dB, dC); KP: k-steps of 16
// over P (2 KP n-tiles of dX).  EXACT: N == 16 NK and P == 16 KP, so no
// step is guarded at run time.  Grid (H, NC, B) in clusters of K
// consecutive heads of one group.
template <int NK, int KP, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bwd_tc_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const bf16* __restrict__ b,
                        const bf16* __restrict__ c,
                        const float* __restrict__ cum_in,
                        const float* __restrict__ dy,
                        const float* __restrict__ dst,
                        const float* __restrict__ dcum_in,
                        void* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ da_part,
                        float* __restrict__ db_part,
                        float* __restrict__ dc_part, Args d) {
  constexpr int LDX = 16 * KP + 8;    // row strides in elements: an odd
  constexpr int LDB = 16 * NK + 8;    // number of 16-byte chunks
  constexpr int NP = 2 * KP;          // 8-column n-tiles over P
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = d.L, H = d.H;
  const int N = EXACT ? 16 * NK : d.N, P = EXACT ? 16 * KP : d.P;
  const int nk = EXACT ? NK : (N + 15) / 16, kp = EXACT ? KP : (P + 15) / 16;
  const int NR = 16 * nk;             // dS rows, zero past N
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // x[m][p]
  bf16* yh = xs + L * LDX;                        // dY[l][p], hi and lo
  bf16* yl = yh + L * LDX;
  bf16* bs = yl + L * LDX;                        // b[m][n]
  bf16* cs = bs + L * LDB;                        // c[l][n]
  bf16* sh = cs + L * LDB;                        // dS[n][p], hi and lo
  bf16* sl = sh + NR * LDX;
  float* park_b = reinterpret_cast<float*>(smem_raw);   // dB[m][n], later
  float* park_c = park_b + L * LDB;                     // dC[l][n], later
  float* cum = reinterpret_cast<float*>(
      smem_raw + smem_bytes(L, N, NK, KP) - (size_t)4 * NVEC * L);
  float* dts = cum + L;
  float* dcm = dts + L;               // the incoming dcum
  float* rsum = dcm + L;              // dY_l . (W x)_l, m < l
  float* csum = rsum + L;             // x_m . (W~^T dY)_m, l > m
  float* qv = csum + L;               // x_m . (W~^T dY)_m, l >= m
  float* gv = qv + L;                 // G_m = x_m . (B dS)_m

  const int h = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (H / d.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const long long s0 = (long long)ci * L;
  const long long S = (long long)d.nc * L;
  const long long tile = (long long)bi * d.nc + ci;

  // ---- stage x, B, C (cp.async); dY and dS split into halves meanwhile --
  const uint32_t xs_a = smem_addr(xs), yh_a = smem_addr(yh),
                 yl_a = smem_addr(yl), bs_a = smem_addr(bs),
                 cs_a = smem_addr(cs), sh_a = smem_addr(sh),
                 sl_a = smem_addr(sl);
  load_rows(xs_a, LDX, x + bi * d.x_sb + s0 * d.x_ss + (long long)h * P,
            d.x_ss, L, P / 8);
  load_rows(bs_a, LDB, b + bi * d.b_sb + s0 * d.b_ss + (long long)grp * N,
            d.b_ss, L, N / 8);
  load_rows(cs_a, LDB, c + bi * d.c_sb + s0 * d.c_ss + (long long)grp * N,
            d.c_ss, L, N / 8);
  cp_async_commit();
  load_split(yh, yl, LDX, dy + (tile * L * H + h) * (long long)P,
             (long long)H * P, L, P);
  load_split(sh, sl, LDX, dst + (tile * H + h) * (long long)N * P, P, N, P);
  if (!EXACT) {
    // zero pads: x's, dY's and dS's columns P..16kp, B's and C's N..16nk,
    // and dS's rows N..16nk - they add exactly 0 to every product, and
    // only columns below P and N are stored
    if (P & 15) {
      for (int r = tid; r < 3 * L + 2 * NR; r += THREADS) {
        bf16* row = r < 3 * L ? xs + r * LDX : sh + (r - 3 * L) * LDX;
        *reinterpret_cast<uint4*>(row + P) = make_uint4(0, 0, 0, 0);
      }
    }
    if (N & 15) {
      for (int r = tid; r < 2 * L; r += THREADS)
        *reinterpret_cast<uint4*>(bs + r * LDB + N) = make_uint4(0, 0, 0, 0);
      for (int i = tid; i < 2 * (NR - N) * (kp * 2); i += THREADS) {
        const int half = i / ((NR - N) * kp * 2), j = i % ((NR - N) * kp * 2);
        const int r = N + j / (2 * kp), ch = j % (2 * kp);
        *reinterpret_cast<uint4*>((half ? sl : sh) + r * LDX + 8 * ch) =
            make_uint4(0, 0, 0, 0);
      }
    }
  }
  for (int l = tid; l < L; l += THREADS) {
    cum[l] = cum_in[(tile * L + l) * H + h];
    dts[l] = dt[((long long)bi * S + s0 + l) * H + h];
    dcm[l] = dcum_in[(tile * L + l) * H + h];
  }
  cp_async_wait<0>();
  __syncthreads();

  // lane offsets of ldmatrix: A operands from rows [m][k]; B operands of two
  // n-tiles from rows [n][k] (non-trans) or [k][n] (trans)
  const int a_r = lane & 15, a_c = 8 * (lane >> 4);
  const int bn_r = (lane & 7) + 8 * (lane >> 4), bn_c = 8 * ((lane >> 3) & 1);
  const int bt_r = (lane & 7) + 8 * ((lane >> 3) & 1), bt_c = 8 * (lane >> 4);
  const int LT = L / 16;
  const float cl_last = cum[L - 1];

  // warp w owns m-tile w (dX, dB, the column sums, the state terms) and
  // l-tile w (dC, the row sums): LT - w + w + 1 tile pairs, the same for
  // every warp
  float ab[2 * NK][4];                // dB rows m0 + g, m0 + g + 8
  float ac[2 * NK][4];                // dC rows l0 + g, l0 + g + 8
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ab[j][e] = ac[j][e] = 0.f;
  const int w = warp;
  const int r0 = 16 * w + g, r1 = r0 + 8;   // this thread's rows of both tiles
  if (w < LT) {
    // ================= columns: m-tile w ================================
    const int m0 = 16 * w;
    const float cm0 = cum[r0], cm1 = cum[r1];
    const float dtm0 = dts[r0], dtm1 = dts[r1];
    const uint32_t bA = bs_a + 2u * ((m0 + a_r) * LDB + a_c);
    const uint32_t xA = xs_a + 2u * ((m0 + a_r) * LDX + a_c);
    float ax[NP][4];                  // W~^T dY
#pragma unroll
    for (int j = 0; j < NP; ++j) ax[j][0] = ax[j][1] = ax[j][2] = ax[j][3] = 0.f;
    uint32_t dgh[4], dgl[4];          // W~^T's diagonal, hi and lo
    for (int lt = w; lt < LT; ++lt) {
      const int l0 = 16 * lt;
      // S^T = B C^T and dW^T = X dY^T over this 16 x 16 tile
      float st[2][4] = {}, dwt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (!EXACT && kk >= nk) continue;
        uint32_t af[4], b0, b1, b2, b3;
        ldsm_x4(bA + 32u * kk, af[0], af[1], af[2], af[3]);
        ldsm_x4(cs_a + 2u * ((l0 + bn_r) * LDB + bn_c + 16 * kk), b0, b1, b2,
                b3);
        mma16816(st[0], af, b0, b1);
        mma16816(st[1], af, b2, b3);
      }
#pragma unroll
      for (int kq = 0; kq < KP; ++kq) {
        if (!EXACT && kq >= kp) continue;
        uint32_t af[4], h0, h1, h2, h3, q0, q1, q2, q3;
        ldsm_x4(xA + 32u * kq, af[0], af[1], af[2], af[3]);
        const uint32_t off = 2u * ((l0 + bn_r) * LDX + bn_c + 16 * kq);
        ldsm_x4(yh_a + off, h0, h1, h2, h3);
        ldsm_x4(yl_a + off, q0, q1, q2, q3);
        mma16816(dwt[0], af, h0, h1);
        mma16816(dwt[1], af, h2, h3);
        mma16816(dwt[0], af, q0, q1);
        mma16816(dwt[1], af, q2, q3);
      }
      // on the fragments: st[j][e] is row m = r0 + 8 (e / 2), column l =
      // l0 + 8 j + 2 tq + e % 2.  W~^T = S^T o E with its diagonal kept
      // apart, and dS'^T = dW^T o E dt_m; the mask m <= l comes before the
      // exponential.  The C fragments of n-tiles 0, 1 are the A fragment
      // of the next product's k-step.
      uint32_t wh[4], wl[4], dh[4], dl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lc = l0 + 8 * j + 2 * tq;
        const float2 cl = *reinterpret_cast<const float2*>(cum + lc);
        float wv[4], dg[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = e < 2 ? r0 : r1, l = lc + (e & 1);
          const bool in = m <= l;
          const float ev = in ? expf(((e & 1) ? cl.y : cl.x) -
                                     (e < 2 ? cm0 : cm1))
                              : 0.f;
          const float wt = st[j][e] * ev;
          wv[e] = m < l ? wt : 0.f;
          dg[e] = m == l ? wt : 0.f;
          dv[e] = in ? dwt[j][e] * ev * (e < 2 ? dtm0 : dtm1) : 0.f;
        }
        split_bf16(wv[0], wv[1], wh[2 * j], wl[2 * j]);
        split_bf16(wv[2], wv[3], wh[2 * j + 1], wl[2 * j + 1]);
        split_bf16(dv[0], dv[1], dh[2 * j], dl[2 * j]);
        split_bf16(dv[2], dv[3], dh[2 * j + 1], dl[2 * j + 1]);
        if (lt == w) {
          split_bf16(dg[0], dg[1], dgh[2 * j], dgl[2 * j]);
          split_bf16(dg[2], dg[3], dgh[2 * j + 1], dgl[2 * j + 1]);
        }
      }
      // dX's sum W~^T dY (hi hi + hi lo + lo hi), dY through ldmatrix.trans
#pragma unroll
      for (int pp = 0; pp < KP; ++pp) {
        if (!EXACT && pp >= kp) continue;
        uint32_t h0, h1, h2, h3, q0, q1, q2, q3;
        const uint32_t off = 2u * ((l0 + bt_r) * LDX + bt_c + 16 * pp);
        ldsm_x4_trans(yh_a + off, h0, h1, h2, h3);
        ldsm_x4_trans(yl_a + off, q0, q1, q2, q3);
        mma16816(ax[2 * pp], wh, h0, h1);
        mma16816(ax[2 * pp + 1], wh, h2, h3);
        mma16816(ax[2 * pp], wh, q0, q1);
        mma16816(ax[2 * pp + 1], wh, q2, q3);
        mma16816(ax[2 * pp], wl, h0, h1);
        mma16816(ax[2 * pp + 1], wl, h2, h3);
      }
      // dB += dS'^T C, C through ldmatrix.trans
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        if (!EXACT && nn >= nk) continue;
        uint32_t c0, c1, c2, c3;
        ldsm_x4_trans(cs_a + 2u * ((l0 + bt_r) * LDB + bt_c + 16 * nn), c0,
                      c1, c2, c3);
        mma16816(ab[2 * nn], dh, c0, c1);
        mma16816(ab[2 * nn + 1], dh, c2, c3);
        mma16816(ab[2 * nn], dl, c0, c1);
        mma16816(ab[2 * nn + 1], dl, c2, c3);
      }
    }
    // the column sums x_m . (W~^T dY)_m without the diagonal, then with it
    // (the diagonal tile's diagonal, added last, into the same sums)
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (!EXACT && j >= 2 * kp) continue;
      const int pc = 8 * j + 2 * tq;
      const float2 x0 = bf2f(xs + r0 * LDX + pc), x1 = bf2f(xs + r1 * LDX + pc);
      cs0 = fmaf(x0.x, ax[j][0], fmaf(x0.y, ax[j][1], cs0));
      cs1 = fmaf(x1.x, ax[j][2], fmaf(x1.y, ax[j][3], cs1));
    }
    cs0 = quad_sum(cs0);
    cs1 = quad_sum(cs1);
#pragma unroll
    for (int pp = 0; pp < KP; ++pp) {
      if (!EXACT && pp >= kp) continue;
      uint32_t h0, h1, h2, h3, q0, q1, q2, q3;
      const uint32_t off = 2u * ((m0 + bt_r) * LDX + bt_c + 16 * pp);
      ldsm_x4_trans(yh_a + off, h0, h1, h2, h3);
      ldsm_x4_trans(yl_a + off, q0, q1, q2, q3);
      mma16816(ax[2 * pp], dgh, h0, h1);
      mma16816(ax[2 * pp + 1], dgh, h2, h3);
      mma16816(ax[2 * pp], dgh, q0, q1);
      mma16816(ax[2 * pp + 1], dgh, q2, q3);
      mma16816(ax[2 * pp], dgl, h0, h1);
      mma16816(ax[2 * pp + 1], dgl, h2, h3);
    }
    float q0s = 0.f, q1s = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (!EXACT && j >= 2 * kp) continue;
      const int pc = 8 * j + 2 * tq;
      const float2 x0 = bf2f(xs + r0 * LDX + pc), x1 = bf2f(xs + r1 * LDX + pc);
      q0s = fmaf(x0.x, ax[j][0], fmaf(x0.y, ax[j][1], q0s));
      q1s = fmaf(x1.x, ax[j][2], fmaf(x1.y, ax[j][3], q1s));
    }
    q0s = quad_sum(q0s);
    q1s = quad_sum(q1s);

    // the state terms: dX = dt_m W~^T dY + dte_m B dS (written here, in
    // x's dtype when the caller casts), G_m = x_m . (B dS)_m, and
    // dB += dte_m X dS^T; dS through ldmatrix (.trans for B dS)
    const float dte0 = expf(cl_last - cm0) * dtm0;
    const float dte1 = expf(cl_last - cm1) * dtm1;
    float g0 = 0.f, g1 = 0.f;
    const long long xrow0 = (((long long)bi * S + s0 + r0) * H + h) * P;
    const long long xrow1 = xrow0 + 8LL * H * P;
#pragma unroll
    for (int pp = 0; pp < KP; ++pp) {
      if (!EXACT && pp >= kp) continue;
      float t[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (!EXACT && kk >= nk) continue;
        uint32_t af[4], h0, h1, h2, h3, q0, q1, q2, q3;
        ldsm_x4(bA + 32u * kk, af[0], af[1], af[2], af[3]);
        const uint32_t off = 2u * ((16 * kk + bt_r) * LDX + bt_c + 16 * pp);
        ldsm_x4_trans(sh_a + off, h0, h1, h2, h3);
        ldsm_x4_trans(sl_a + off, q0, q1, q2, q3);
        mma16816(t[0], af, h0, h1);
        mma16816(t[1], af, h2, h3);
        mma16816(t[0], af, q0, q1);
        mma16816(t[1], af, q2, q3);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * pp + jj, pc = 8 * j + 2 * tq;
        const float2 x0 = bf2f(xs + r0 * LDX + pc),
                     x1 = bf2f(xs + r1 * LDX + pc);
        g0 = fmaf(x0.x, t[jj][0], fmaf(x0.y, t[jj][1], g0));
        g1 = fmaf(x1.x, t[jj][2], fmaf(x1.y, t[jj][3], g1));
        if (!EXACT && pc >= P) continue;
        const float v00 = fmaf(dte0, t[jj][0], dtm0 * ax[j][0]);
        const float v01 = fmaf(dte0, t[jj][1], dtm0 * ax[j][1]);
        const float v10 = fmaf(dte1, t[jj][2], dtm1 * ax[j][2]);
        const float v11 = fmaf(dte1, t[jj][3], dtm1 * ax[j][3]);
        if (d.dx_bf16) {
          bf16* o = reinterpret_cast<bf16*>(dx);
          *reinterpret_cast<__nv_bfloat162*>(o + xrow0 + pc) =
              __floats2bfloat162_rn(v00, v01);
          *reinterpret_cast<__nv_bfloat162*>(o + xrow1 + pc) =
              __floats2bfloat162_rn(v10, v11);
        } else {
          float* o = reinterpret_cast<float*>(dx);
          *reinterpret_cast<float2*>(o + xrow0 + pc) = make_float2(v00, v01);
          *reinterpret_cast<float2*>(o + xrow1 + pc) = make_float2(v10, v11);
        }
      }
    }
    g0 = quad_sum(g0);
    g1 = quad_sum(g1);
#pragma unroll
    for (int nn = 0; nn < NK; ++nn) {
      if (!EXACT && nn >= nk) continue;
      float t[2][4] = {};
#pragma unroll
      for (int kq = 0; kq < KP; ++kq) {
        if (!EXACT && kq >= kp) continue;
        uint32_t af[4], h0, h1, h2, h3, q0, q1, q2, q3;
        ldsm_x4(xA + 32u * kq, af[0], af[1], af[2], af[3]);
        const uint32_t off = 2u * ((16 * nn + bn_r) * LDX + bn_c + 16 * kq);
        ldsm_x4(sh_a + off, h0, h1, h2, h3);
        ldsm_x4(sl_a + off, q0, q1, q2, q3);
        mma16816(t[0], af, h0, h1);
        mma16816(t[1], af, h2, h3);
        mma16816(t[0], af, q0, q1);
        mma16816(t[1], af, q2, q3);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ab[2 * nn + jj][0] = fmaf(dte0, t[jj][0], ab[2 * nn + jj][0]);
        ab[2 * nn + jj][1] = fmaf(dte0, t[jj][1], ab[2 * nn + jj][1]);
        ab[2 * nn + jj][2] = fmaf(dte1, t[jj][2], ab[2 * nn + jj][2]);
        ab[2 * nn + jj][3] = fmaf(dte1, t[jj][3], ab[2 * nn + jj][3]);
      }
    }
    if (tq == 0) {
      csum[r0] = cs0;
      csum[r1] = cs1;
      qv[r0] = q0s;
      qv[r1] = q1s;
      gv[r0] = g0;
      gv[r1] = g1;
    }

    // ================= rows: l-tile w ===================================
    const int l0 = 16 * w;
    const float cl0 = cm0, cl1 = cm1;   // this thread's rows r0, r1 again
    const uint32_t cA = cs_a + 2u * ((l0 + a_r) * LDB + a_c);
    const uint32_t yhA = yh_a + 2u * ((l0 + a_r) * LDX + a_c);
    const uint32_t ylA = yl_a + 2u * ((l0 + a_r) * LDX + a_c);
    float wx[NP][4];                  // W x, m < l (dt folded into W)
#pragma unroll
    for (int j = 0; j < NP; ++j) wx[j][0] = wx[j][1] = wx[j][2] = wx[j][3] = 0.f;
    for (int mt = 0; mt <= w; ++mt) {
      const int mc0 = 16 * mt;
      float s[2][4] = {}, dw[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (!EXACT && kk >= nk) continue;
        uint32_t af[4], b0, b1, b2, b3;
        ldsm_x4(cA + 32u * kk, af[0], af[1], af[2], af[3]);
        ldsm_x4(bs_a + 2u * ((mc0 + bn_r) * LDB + bn_c + 16 * kk), b0, b1, b2,
                b3);
        mma16816(s[0], af, b0, b1);
        mma16816(s[1], af, b2, b3);
      }
#pragma unroll
      for (int kq = 0; kq < KP; ++kq) {
        if (!EXACT && kq >= kp) continue;
        uint32_t ah[4], al[4], b0, b1, b2, b3;
        ldsm_x4(yhA + 32u * kq, ah[0], ah[1], ah[2], ah[3]);
        ldsm_x4(ylA + 32u * kq, al[0], al[1], al[2], al[3]);
        ldsm_x4(xs_a + 2u * ((mc0 + bn_r) * LDX + bn_c + 16 * kq), b0, b1, b2,
                b3);
        mma16816(dw[0], ah, b0, b1);
        mma16816(dw[1], ah, b2, b3);
        mma16816(dw[0], al, b0, b1);
        mma16816(dw[1], al, b2, b3);
      }
      // s[j][e] is row l = r0 + 8 (e / 2), column m = mc0 + 8 j + 2 tq + e % 2:
      // W = S o E dt_m with m < l (the row sums leave the diagonal out), and
      // dS' = dW o E dt_m with m <= l
      uint32_t wh[4], wl[4], dh[4], dl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int mc = mc0 + 8 * j + 2 * tq;
        const float2 cm = *reinterpret_cast<const float2*>(cum + mc);
        const float2 dm = *reinterpret_cast<const float2*>(dts + mc);
        float wv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = e < 2 ? r0 : r1, m = mc + (e & 1);
          const bool in = m <= l;
          const float dtm = (e & 1) ? dm.y : dm.x;
          const float ev = in ? expf((e < 2 ? cl0 : cl1) -
                                     ((e & 1) ? cm.y : cm.x))
                              : 0.f;
          wv[e] = m < l ? s[j][e] * ev * dtm : 0.f;
          dv[e] = in ? dw[j][e] * ev * dtm : 0.f;
        }
        split_bf16(wv[0], wv[1], wh[2 * j], wl[2 * j]);
        split_bf16(wv[2], wv[3], wh[2 * j + 1], wl[2 * j + 1]);
        split_bf16(dv[0], dv[1], dh[2 * j], dl[2 * j]);
        split_bf16(dv[2], dv[3], dh[2 * j + 1], dl[2 * j + 1]);
      }
      // W x with x through ldmatrix.trans; dC += dS' B with B the same way
#pragma unroll
      for (int pp = 0; pp < KP; ++pp) {
        if (!EXACT && pp >= kp) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(xs_a + 2u * ((mc0 + bt_r) * LDX + bt_c + 16 * pp), b0,
                      b1, b2, b3);
        mma16816(wx[2 * pp], wh, b0, b1);
        mma16816(wx[2 * pp + 1], wh, b2, b3);
        mma16816(wx[2 * pp], wl, b0, b1);
        mma16816(wx[2 * pp + 1], wl, b2, b3);
      }
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        if (!EXACT && nn >= nk) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bs_a + 2u * ((mc0 + bt_r) * LDB + bt_c + 16 * nn), b0,
                      b1, b2, b3);
        mma16816(ac[2 * nn], dh, b0, b1);
        mma16816(ac[2 * nn + 1], dh, b2, b3);
        mma16816(ac[2 * nn], dl, b0, b1);
        mma16816(ac[2 * nn + 1], dl, b2, b3);
      }
    }
    // the row sums dY_l . (W x)_l, dY as hi + lo
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (!EXACT && j >= 2 * kp) continue;
      const int pc = 8 * j + 2 * tq;
      const float2 h0 = bf2f(yh + r0 * LDX + pc), q0 = bf2f(yl + r0 * LDX + pc);
      const float2 h1 = bf2f(yh + r1 * LDX + pc), q1 = bf2f(yl + r1 * LDX + pc);
      rs0 = fmaf(h0.x + q0.x, wx[j][0], fmaf(h0.y + q0.y, wx[j][1], rs0));
      rs1 = fmaf(h1.x + q1.x, wx[j][2], fmaf(h1.y + q1.y, wx[j][3], rs1));
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    if (tq == 0) {
      rsum[r0] = rs0;
      rsum[r1] = rs1;
    }
  }
  __syncthreads();   // every warp is done with the inputs

  // ---- park dB and dC (f32) over the inputs' bytes ---------------------
  if (w < LT) {
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      if (!EXACT && j >= 2 * nk) continue;
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(park_b + r0 * LDB + col) =
          make_float2(ab[j][0], ab[j][1]);
      *reinterpret_cast<float2*>(park_b + r1 * LDB + col) =
          make_float2(ab[j][2], ab[j][3]);
      *reinterpret_cast<float2*>(park_c + r0 * LDB + col) =
          make_float2(ac[j][0], ac[j][1]);
      *reinterpret_cast<float2*>(park_c + r1 * LDB + col) =
          make_float2(ac[j][2], ac[j][3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();    // every block of the cluster has parked its tiles

  // ---- block r sums rows [r L / K, (r + 1) L / K) over the cluster -----
  {
    const int K = d.K, r = (int)cluster.block_rank();
    const int lo = r * L / K, hi = (r + 1) * L / K, n4 = N / 4;
    const long long hk = h / K, HK = H / K;
    for (int i = tid; i < (hi - lo) * n4; i += THREADS) {
      const int row = lo + i / n4, col = 4 * (i % n4);
      float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
      for (int j = 0; j < K; ++j) {   // in rank order
        const float4 vb = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(park_b, j) + row * LDB + col);
        const float4 vc = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(park_c, j) + row * LDB + col);
        sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
        sc.x += vc.x; sc.y += vc.y; sc.z += vc.z; sc.w += vc.w;
      }
      const long long o = (((long long)bi * S + s0 + row) * HK + hk) * N + col;
      *reinterpret_cast<float4*>(db_part + o) = sb;
      *reinterpret_cast<float4*>(dc_part + o) = sc;
    }
  }

  // ---- warp 0: dcum', its reverse scan, d(dt) and da_h (f64 sums) -------
  // lane t holds steps [t per, (t + 1) per); the state term of m = L-1 and
  // dseg's diagonal cancel and are left out (see the header)
  if (warp == 0) {
    constexpr int PER = LMAX / 32;
    const int per = (L + 31) / 32, l_0 = lane * per;
    float dacc[PER], el[PER];
    double tot = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = l_0 + i;
      dacc[i] = el[i] = 0.f;
      if (i >= per || l >= L) continue;
      el[i] = expf(cl_last - cum[l]);
      float v = dcm[l] + (rsum[l] - dts[l] * csum[l]);
      if (l < L - 1) {
        const float gd = gv[l] * el[i] * dts[l];
        tot += (double)gd;
        v -= gd;
      }
      dacc[i] = v;
    }
    tot = warp_sum(tot);
    double seg = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int l = l_0 + i;
      if (i >= per || l >= L) continue;
      if (l == L - 1) dacc[i] += (float)tot;
      seg += (double)dacc[i];
    }
    // the sum of the segments of the lanes above this one
    double above = seg;
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_down_sync(0xffffffffu, above, off);
      if (lane + off < 32) above += v;
    }
    above -= seg;
    const float ah = a[h];
    double run = above, da_h = 0.0;
#pragma unroll
    for (int i = PER - 1; i >= 0; --i) {
      const int l = l_0 + i;
      if (i >= per || l >= L) continue;
      run += (double)dacc[i];
      ddt[((long long)bi * S + s0 + l) * H + h] =
          qv[l] + gv[l] * el[i] + ah * (float)run;
      da_h += run * (double)dts[l];
    }
    da_h = warp_sum(da_h);
    if (lane == 0) da_part[tile * H + h] = (float)da_h;
  }
  cluster.sync();    // no block leaves while another reads its tiles
}

template <int NK, int KP, bool EXACT>
int launch_body(const void* x, const void* dt, const void* a, const void* b,
                const void* c, const void* cum, const void* dy,
                const void* dst, const void* dcum, void* dx, void* ddt,
                void* da_part, void* db_part, void* dc_part, int bs,
                const Args& d, void* stream) {
  const size_t smem = smem_bytes(d.L, d.N, NK, KP);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto* kern = ssd_chunk_bwd_tc_kernel<NK, KP, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.H, d.nc, bs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, (const bf16*)x, (const float*)dt, (const float*)a,
      (const bf16*)b, (const bf16*)c, (const float*)cum, (const float*)dy,
      (const float*)dst, (const float*)dcum, dx, (float*)ddt,
      (float*)da_part, (float*)db_part, (float*)dc_part, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The shapes and layouts the body takes (kernel.py:tc_takes and
// ssd_bwd_body say the same before launch); anything else is refused.
bool takes(const void* x, const void* b, const void* c, const Args& d) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 == 0 &&
      (d.x_sb | d.x_ss | d.b_sb | d.b_ss | d.c_sb | d.c_ss) % 8 == 0;
  return aligned && d.L % 16 == 0 && d.L > 0 && d.L <= LMAX &&
         d.N % 8 == 0 && d.N > 0 && d.N <= 128 && d.P % 8 == 0 && d.P > 0 &&
         d.P <= 128 && d.G > 0 && d.H % d.G == 0 && d.K > 0 &&
         d.K <= KMAX && (d.H / d.G) % d.K == 0;
}

int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* cum, const void* dy, const void* dst,
           const void* dcum, void* dx, void* ddt, void* da_part,
           void* db_part, void* dc_part, int bs, const Args& d,
           void* stream) {
  if (!takes(x, b, c, d)) return (int)cudaErrorInvalidValue;
#define SSDB_TC_LAUNCH(NK, KP, EX)                                           \
  return launch_body<NK, KP, EX>(x, dt, a, b, c, cum, dy, dst, dcum, dx,    \
                                 ddt, da_part, db_part, dc_part, bs, d,     \
                                 stream)
  if (d.N == 128 && d.P == 64) SSDB_TC_LAUNCH(8, 4, true);
  if (d.N == 64 && d.P == 64) SSDB_TC_LAUNCH(4, 4, true);
  SSDB_TC_LAUNCH(8, 8, false);
#undef SSDB_TC_LAUNCH
}

// What a launch at (L, P, N, K) takes of the card, for the record:
// out[0] shared memory bytes a block, out[1] blocks an SM, out[2] clusters
// of K that can be resident at once.
int info(int L, int P, int N, int K, long long* out) {
  auto query = [&](auto kern, size_t smem) -> int {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0, clusters = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(K * 16, 1, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    out[0] = (long long)smem;
    out[1] = blocks;
    out[2] = clusters;
    return 0;
  };
  if (N == 128 && P == 64)
    return query(ssd_chunk_bwd_tc_kernel<8, 4, true>, smem_bytes(L, N, 8, 4));
  if (N == 64 && P == 64)
    return query(ssd_chunk_bwd_tc_kernel<4, 4, true>, smem_bytes(L, N, 4, 4));
  return query(ssd_chunk_bwd_tc_kernel<8, 8, false>, smem_bytes(L, N, 8, 8));
}

}  // namespace ssdb_tc

#define SSD_CHUNKS_BWD_ARGS                                                   \
  const void *x, const void *dt, const void *a, const void *b, const void *c, \
      const void *cum, const void *dy, const void *dst, const void *dcum,     \
      void *dx, void *ddt, void *da_part, void *db_part, void *dc_part,       \
      int bs, int nc, int L, int H, int P, int G, int N, long long x_sb,      \
      long long x_ss, long long b_sb, long long b_ss, long long c_sb,         \
      long long c_ss, void *stream

#define SSD_CHUNKS_BWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(SSD_CHUNKS_BWD_ARGS) {                                  \
    ssdb::Dims d{nc, L, H, P, G, N, 0, 0, 0, 0, 0, 0,                         \
                 x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};                         \
    return ssdb::launch<T>(x, dt, a, b, c, cum, dy, dst, dcum, dx, ddt,       \
                           da_part, db_part, dc_part, bs, d, stream);         \
  }

SSD_CHUNKS_BWD_ENTRY(ssd_chunks_bwd_f32, float)
SSD_CHUNKS_BWD_ENTRY(ssd_chunks_bwd_bf16, __nv_bfloat16)

#define SSD_CHUNKS_BWD_TC_ARGS                                                \
  const void *x, const void *dt, const void *a, const void *b, const void *c, \
      const void *cum, const void *dy, const void *dst, const void *dcum,     \
      void *dx, void *ddt, void *da_part, void *db_part, void *dc_part,       \
      int bs, int nc, int L, int H, int P, int G, int N, int K, int dx_bf16,  \
      long long x_sb, long long x_ss, long long b_sb, long long b_ss,         \
      long long c_sb, long long c_ss, void *stream

// The tensor-core body: db_part and dc_part are (B, S, H / K, N) f32, each
// cluster of K heads' sum; dx is bf16 when dx_bf16, else f32.
extern "C" int ssd_chunks_bwd_tc_bf16(SSD_CHUNKS_BWD_TC_ARGS) {
  ssdb_tc::Args d{nc,   L,    H,    P,    G,    N,   K,
                  dx_bf16, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  return ssdb_tc::launch(x, dt, a, b, c, cum, dy, dst, dcum, dx, ddt, da_part,
                         db_part, dc_part, bs, d, stream);
}

extern "C" int ssd_chunks_bwd_tc_info(int L, int P, int N, int K,
                                      long long *out) {
  return ssdb_tc::info(L, P, N, K, out);
}
