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
// One body: f32 products on the CUDA cores from f32 or bf16 inputs, 256
// threads a block, grid (H, NC, B) as the forward's.  The block stages its
// tiles in shared memory as f32, rows padded to a multiple of 4 (plus 4
// against bank conflicts where the budget allows), and reuses three
// regions across the phases, reloading B, C and x from device memory
// (L2) rather than holding all of them at once:
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
// Every sum runs in a fixed order and no atomics are used, so two calls
// are bitwise equal.  dB and dC leave the kernel per head, (B, S, H, N)
// f32, and the wrapper sums each group's heads with one torch reduction;
// da leaves per (batch, chunk, head) and is summed the same way.  dx and
// d(dt) are written in f32 and cast by the wrapper.
//
// What bounds it on the H100 (Mamba-2-2.7B's training microbatch, B = 2,
// S = 4,096, H = 80, P = 64, N = 128, G = 1, bf16 in): the work needs
// ~0.43 GB read (x, dt, a, b, c, cum, dY, dS, dcum) and ~0.09 GB written
// (dx, d(dt), da, dB and dC at the group's width) and ~64 GFLOP of
// products over the causal triangle (launch/roofline.py:ssd_bwd_work):
// 0.16 ms at 3.35 TB/s, 0.07 ms at the bf16 tensor-core peak, so bytes.
// This body moves more: the per-head dB/dC partials (671 MB f32 written,
// and read again by the group sum), f32 dx, and B, C, x re-read from L2;
// and it runs its ~70 GFLOP (the products above plus W x, recomputed for
// the row sums) on the CUDA cores from shared memory, whose f32 peak is
// 67 TFLOP/s.  The tensor-core redesign is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
