// Flash-attention backward: (dq, dk, dv) of o = softmax(q k^T * scale +
// mask) v for what flash_attention_fwd.cu computes, under the same masks
// (causal, sliding window, keys past T absent) and GQA (q head h reads kv
// head h / (H / Hkv)), f32 or bf16 in, out in the input dtype.
//
// Replaces no Pallas kernel: the reference trains through its XLA
// chunked_attention under jax.grad (src/repro/models/attention.py) and has
// no backward kernel.  The port's forward runs FA on the card, and autograd
// has no path through a ctypes launch, so the gradient of attention is this
// kernel, called from the torch.autograd.Function ``flash_attention`` in
// kernel.py.
//
// With P = exp(S * scale - lse) rebuilt from the forward's row log-sum-exp
// and D = rowsum(dO o o) (one torch reduction before the launches, in f32):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dK = dS^T Q * scale,  dQ = dS K * scale.
// Two passes and no atomics, so two calls give the same bits:
//
// * dK/dV: one block per (k-tile of 64 keys, kv head, batch), the causal
//   grid's first (heaviest) k-tiles first.  K and V stay in shared memory;
//   the block walks the kv head's ``rep`` query heads in order and, for
//   each, the q-tiles the masks let see the tile (causal: q >= the tile's
//   first key; window: q < its last key + window), and sums dK and dV over
//   all of them in registers.
// * dQ: one block per (q-tile, head, batch), the causal grid's last
//   (heaviest) q-tiles first; Q, dO, lse and D stay while it walks the
//   k-tiles the masks leave (the forward's range).
// Only tiles on the diagonal, a window's edge or a ragged end are masked
// element by element.
//
// What bounds it on the H100 (qwen2-7b training, B = 2, S = T = 4,096, 28
// heads over 4 kv heads, d = dv = 128, causal): 470 M visible pairs, each
// 2 (3d + 2dv) = 1,280 flop of products at the least: ~602 GFLOP, 0.61 ms
// at the bf16 tensor-core peak, against 0.3 GB of q, k, v, o, dO, lse in
// and dq, dk, dv out (~0.1 ms at 3.35 TB/s): bound by operations.
//
// Two bodies:
//
// * bf16 (fab_tc::dkdv_tc_kernel, dq_tc_kernel) runs every product on the
//   tensor cores with the forward's toolset (fa_common.cuh): mma.sync
//   m16n8k16, bf16 in, f32 accumulators; operands through ldmatrix and
//   ldmatrix.trans from shared memory, whose rows are padded by 16 bytes
//   (an odd number of 16-byte chunks: ldmatrix's eight row addresses fall
//   in eight bank groups); tiles copied with 16-byte cp.async.cg into a
//   two-stage ring, so the next Q/dO tile (dK/dV) or K/V tile (dQ) loads
//   while this one computes.  256 threads, one block an SM.
//   dK/dV computes the scores transposed, S^T = K Q^T and dP^T = V dO^T
//   (each warp 16 keys x 32 queries of a 64 x 64 tile pair), so P^T =
//   exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T o (dP^T - D) come
//   out of the accumulators with keys as rows.  They are staged in shared
//   memory as bf16 halves, and the output tile's columns are split over the
//   warps (each 16 keys x every other 16-column block of d and of dv), as
//   FlashAttention-2 does for wide heads: a warp keeping 16 keys x all of
//   d and dv would hold 128 f32 accumulators at d = dv = 128 and 160 at
//   d = 192 / dv = 128, besides 32 of S^T and dP^T; split, 64 and 80.
//   dV += P^T dO and dK += dS^T Q then read P^T and dS^T as A fragments
//   (ldmatrix) and dO and Q with ldmatrix.trans.
//   dQ: 8 warps of 16 query rows (128 rows a block) compute S = Q K^T and
//   dP = dO V^T, form dS on the accumulator fragments, and feed dQ += dS K
//   from registers (the C fragments of n-tiles 2kk, 2kk + 1 are the A
//   fragment of k-step kk), K through ldmatrix.trans.
//   Rounding: P enters dV, and dS enters dK and dQ, as two bf16 halves,
//   hi = bf16(x) and lo = bf16(x - hi), two mma a product (the forward's
//   split of P); sums are f32 and the outputs are rounded once.  With hi
//   alone, dk and dq pass 5e-3 of max |ref| against the plain version at
//   d = 120 and 192, and dv reaches 4.6e-3 at S = 4,096 (an emulation of
//   this body, tests/test_torch_fa_backward.py).
//   Widths: d and dv multiples of 8, dv <= 128; two instantiations, 8
//   k-steps over d (d <= 128) and 12 (d <= 192).  A d of 16k + 8 (h2o's
//   120) runs its last k-step on pad columns zeroed once, as the forward's
//   tc_k8.  Bases and strides 16-byte aligned, sequence strides below 2^23
//   elements (kernel.py:check_bf16_layout, for q, k, v and dO).
//   Work: 2 (6d + 4dv) flop a kept pair (S and dP in both passes, both
//   halves of P and dS) against the bound's 2 (3d + 2dv).  What remains: wgmma and
//   TMA (FlashAttention-3's shape), one pass (a dQ workspace, or ordered
//   semaphores), K and V fragments kept in registers across q-tiles.
// * f32, and the earlier bf16 body (fab::dkdv_kernel, dq_kernel; kept for
//   f32, whose bars TF32 products would break, and timed beside the
//   tensor-core body): f32 FMAs on the CUDA cores, in the forward's f32
//   layout.  256 threads, thread (rg, cg) = (t / 16, t % 16) owns rows
//   4rg..4rg+3 and columns 4cg..4cg+3 of each 64 x 64 score tile, and
//   output columns cg, cg + 16, ... of its rows (dv <= 128, d <= 192);
//   tiles sit transposed in shared memory (row stride 68 floats) so both
//   factors of every product are read as float4s.  2 (4d + 3dv) flop a
//   pair at most 67 TFLOP/s, each FMA pair reading a float4 of shared
//   memory: an order of magnitude above the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace fab {

constexpr int THREADS = 256;
constexpr int BQ = 64;            // query rows of a tile
constexpr int BK = 64;            // keys of a tile
constexpr int LD = 68;            // row stride of every transposed tile
constexpr int MAXD = 192;         // d: 12 output columns a thread
constexpr int MAXDV = 128;        // dv: 8 output columns a thread
constexpr int CD = MAXD / 16, CV = MAXDV / 16;
constexpr int SMEM_MAX = 232448;

struct Args {
  int S, T, H, Hkv, d, dv, causal, window;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;     // dO's strides
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + 64) of a (seq, width) slab with sequence stride ``ss``
// into dst[e * LD + r] (transposed), zeros past ``n`` rows
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long ss,
                                       int r0, int n, int width) {
  for (int i = threadIdx.x; i < 64 * width; i += THREADS) {
    const int r = i / width, e = i - r * width;
    dst[e * LD + r] = r0 + r < n ? to_f(src[(long long)(r0 + r) * ss + e])
                                 : 0.f;
  }
}

// acc[i][j] += sum_e a[e][ra + i] * b[e][cb + j] over e < n (both
// transposed tiles in shared memory)
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ra, int cb,
                                         int n) {
  for (int e = 0; e < n; ++e) {
    const float4 x = *reinterpret_cast<const float4*>(&a[e * LD + ra]);
    const float4 y = *reinterpret_cast<const float4*>(&b[e * LD + cb]);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// out[i][jj] += sum_c p[(r0 + i) * LD + c] * m[(jj * 16 + cg) * LD + c]
// over the tile's 64 columns c, for the NC column groups below ``width``
template <int NC>
__device__ __forceinline__ void tile_acc(float (&out)[4][NC], const float* p,
                                         const float* m, int r0, int cg,
                                         int width) {
  for (int c = 0; c < 64; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&p[(r0 + i) * LD + c]);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int e = jj * 16 + cg;
      if (e >= width) continue;
      const float4 mv = *reinterpret_cast<const float4*>(&m[e * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float t = out[i][jj];
        t = fmaf(pv[i].x, mv.x, t);
        t = fmaf(pv[i].y, mv.y, t);
        t = fmaf(pv[i].z, mv.z, t);
        t = fmaf(pv[i].w, mv.w, t);
        out[i][jj] = t;
      }
    }
  }
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  bool ok = qp < a.S && kp < a.T;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window) ok = ok && kp > qp - a.window;
  return ok;
}

// dK and dV of one k-tile of one kv head: grid (B * Hkv, k-tiles); the
// causal mask makes the first k-tiles the heaviest, and they come first.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ __align__(16) float sm[];
  const int d = a.d, dvw = a.dv;
  float* kT = sm;                   // k[c][e] at kT[e * LD + c]
  float* vT = kT + d * LD;          // v[c][e] at vT[e * LD + c]
  float* qT = vT + dvw * LD;        // q[r][e] at qT[e * LD + r]
  float* oT = qT + d * LD;          // dO[r][e] at oT[e * LD + r]
  float* pT = oT + dvw * LD;        // P^T[c][r] at pT[c * LD + r]
  float* sT = pT + BK * LD;         // dS^T[c][r] at sT[c * LD + r]
  float* lse_s = sT + BK * LD;      // lse and D of the q-tile's rows
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int r0 = 4 * rg, c0 = 4 * cg;      // key rows, query columns
  const int bh = blockIdx.x, bi = bh / a.Hkv, hk = bh % a.Hkv;
  const int rep = a.H / a.Hkv;
  const int k0 = blockIdx.y * BK;
  load_t(kT, k + bi * a.k_sb + (long long)hk * a.k_sh, a.k_ss, k0, a.T, d);
  load_t(vT, v + bi * a.v_sb + (long long)hk * a.v_sh, a.v_ss, k0, a.T,
         dvw);

  // queries that some key of this tile may be seen by
  const int k_last = min(k0 + BK, a.T) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window ? min(a.S, k_last + a.window) : a.S;

  float acc_k[4][CD], acc_v[4][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) acc_v[i][j] = 0.f;
  }

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qh = q + bi * a.q_sb + (long long)h * a.q_sh;
    const T* oh = dout + bi * a.o_sb + (long long)h * a.o_sh;
    const float* lh = lse + ((long long)bi * a.H + h) * a.S;
    const float* dh = dsum + ((long long)bi * a.H + h) * a.S;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile pair is consumed
      load_t(qT, qh, a.q_ss, q0, a.S, d);
      load_t(oT, oh, a.o_ss, q0, a.S, dvw);
      if (tid < BQ) {
        const bool in = q0 + tid < a.S;
        lse_s[tid] = in ? lh[q0 + tid] : 0.f;
        d_s[tid] = in ? dh[q0 + tid] : 0.f;
      }
      __syncthreads();

      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot(st, kT, qT, r0, c0, d);      // S^T = K Q^T
      tile_dot(dpt, vT, oT, r0, c0, dvw);   // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qp = q0 + c0 + j, kp = k0 + r0 + i;
          p[j] = visible(a, qp, kp)
                     ? expf(st[i][j] * a.scale - lse_s[c0 + j])
                     : 0.f;
          ds[j] = p[j] * (dpt[i][j] - d_s[c0 + j]);
        }
        *reinterpret_cast<float4*>(&pT[(r0 + i) * LD + c0]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&sT[(r0 + i) * LD + c0]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      tile_acc<CV>(acc_v, pT, oT, r0, cg, dvw);   // dV += P^T dO
      tile_acc<CD>(acc_k, sT, qT, r0, cg, d);     // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + r0 + i;
    if (kp >= a.T) continue;
    const long long row = ((long long)bi * a.T + kp) * a.Hkv + hk;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int e = j * 16 + cg;
      if (e < d) dk[row * d + e] = from_f<T>(acc_k[i][j] * a.scale);
    }
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int e = j * 16 + cg;
      if (e < dvw) dv[row * dvw + e] = from_f<T>(acc_v[i][j]);
    }
  }
}

// dQ of one q-tile of one head: grid (B * H, q-tiles), the causal mask's
// heaviest (last) q-tiles first.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, Args a) {
  extern __shared__ __align__(16) float sm[];
  const int d = a.d, dvw = a.dv;
  float* qT = sm;                   // q[r][e] at qT[e * LD + r]
  float* oT = qT + d * LD;          // dO[r][e] at oT[e * LD + r]
  float* kT = oT + dvw * LD;        // k[c][e] at kT[e * LD + c]
  float* vT = kT + d * LD;          // v[c][e] at vT[e * LD + c]
  float* s_ = vT + dvw * LD;        // dS[r][c] at s_[r * LD + c]
  float* lse_s = s_ + BQ * LD;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int r0 = 4 * rg, c0 = 4 * cg;      // query rows, key columns
  const int bh = blockIdx.x, bi = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.S + BQ - 1) / BQ;
  const int q0 = (a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const float* lh = lse + ((long long)bi * a.H + h) * a.S;
  const float* dh = dsum + ((long long)bi * a.H + h) * a.S;
  load_t(qT, q + bi * a.q_sb + (long long)h * a.q_sh, a.q_ss, q0, a.S, d);
  load_t(oT, dout + bi * a.o_sb + (long long)h * a.o_sh, a.o_ss, q0, a.S,
         dvw);
  if (tid < BQ) {
    const bool in = q0 + tid < a.S;
    lse_s[tid] = in ? lh[q0 + tid] : 0.f;
    d_s[tid] = in ? dh[q0 + tid] : 0.f;
  }
  const T* kh = k + bi * a.k_sb + (long long)hk * a.k_sh;
  const T* vh = v + bi * a.v_sb + (long long)hk * a.v_sh;

  // keys that some row of this query tile may see (the forward's range)
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_lo = a.window ? max(0, q0 - a.window + 1) : 0;

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous k-tile is consumed
    load_t(kT, kh, a.k_ss, k0, a.T, d);
    load_t(vT, vh, a.v_ss, k0, a.T, dvw);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, qT, kT, r0, c0, d);       // S = Q K^T
    tile_dot(dp, oT, vT, r0, c0, dvw);    // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + r0 + i, kp = k0 + c0 + j;
        const float p = visible(a, qp, kp)
                            ? expf(s[i][j] * a.scale - lse_s[r0 + i])
                            : 0.f;
        ds[j] = p * (dp[i][j] - d_s[r0 + i]);
      }
      *reinterpret_cast<float4*>(&s_[(r0 + i) * LD + c0]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    tile_acc<CD>(acc, s_, kT, r0, cg, d);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= a.S) continue;
    T* row = dq + (((long long)bi * a.S + qp) * a.H + h) * d;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int e = j * 16 + cg;
      if (e < d) row[e] = from_f<T>(acc[i][j] * a.scale);
    }
  }
}

__host__ inline size_t dkdv_smem(int d, int dv) {
  return sizeof(float) * ((size_t)(2 * d + 2 * dv + 2 * BK) * LD + 2 * BQ);
}
__host__ inline size_t dq_smem(int d, int dv) {
  return sizeof(float) * ((size_t)(2 * d + 2 * dv + BQ) * LD + 2 * BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, void* dq, void* dk, void* dv,
           int B, const Args& a, void* stream) {
  if (a.d <= 0 || a.d > MAXD || a.dv <= 0 || a.dv > MAXDV)
    return (int)cudaErrorInvalidValue;
  const size_t s1 = dkdv_smem(a.d, a.dv), s2 = dq_smem(a.d, a.dv);
  if (s1 > (size_t)SMEM_MAX || s2 > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g1(B * a.Hkv, (a.T + BK - 1) / BK);
  dkdv_kernel<T><<<g1, THREADS, s1, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dsum, (T*)dk, (T*)dv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(B * a.H, (a.S + BQ - 1) / BQ);
  dq_kernel<T><<<g2, THREADS, s2, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dsum, (T*)dq, a);
  return (int)cudaGetLastError();
}

}  // namespace fab

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------
namespace fab_tc {

using bf16 = __nv_bfloat16;
using fab::Args;
using namespace fa_mma;   // fa_common.cuh
constexpr int NW = 8;                 // warps per block
constexpr int THREADS = 32 * NW;
constexpr int BK = 64;                // keys of a dK/dV block and a dQ k-tile
constexpr int BQ = 64;                // queries of a dK/dV q-tile
constexpr int BQ2 = 16 * NW;          // query rows of a dQ block
constexpr int LDP = BQ + 8;           // row stride of the staged P^T, dS^T
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// 4-byte global -> shared copy (an lse or D entry), zeros with ``full``
// false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}

// Copy ROWS rows of ``nch`` 16-byte chunks (row r from src + r * stride)
// into shared memory at ``dst`` with a row stride of ``ld`` elements; rows
// at or past ``valid`` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, int ld,
                                          const bf16* src, int stride,
                                          int valid, int nch) {
  for (int c = threadIdx.x; c < ROWS * nch; c += THREADS) {
    const int r = c / nch, ch = c - r * nch;
    const bool ok = r < valid;
    cp_async16(dst + 2u * (r * ld + 8 * ch), src + (ok ? r * stride + 8 * ch
                                                       : 0), ok);
  }
}

// Lane addresses of an ldmatrix.x4 B operand of two n-tiles (16 n x 16 k):
// from rows [n][k] (BN_*), giving b0, b1 of n 0-7 and b2, b3 of n 8-15; or
// from rows [k][n] with .trans (BT_*), the same registers.
__device__ __forceinline__ int bn_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int bn_col(int lane) { return 8 * ((lane >> 3) & 1); }
__device__ __forceinline__ int bt_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int bt_col(int lane) { return 8 * (lane >> 4); }

// dK and dV of one k-tile of 64 keys of one kv head: grid (B * Hkv,
// k-tiles).  NK: k-steps of 16 over d; NV: over dv (both even: each half
// of the warps owns every other 16-column block).
template <int NK, int NV>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Args a) {
  constexpr int LDK = 16 * NK + 8;    // row strides in elements: an odd
  constexpr int LDV = 16 * NV + 8;    // number of 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // BK x LDK
  bf16* qs = ks + BK * LDK;                       // 2 stages x BQ x LDK
  bf16* vs = qs + 2 * BQ * LDK;                   // BK x LDV
  bf16* os = vs + BK * LDV;                       // 2 stages x BQ x LDV (dO)
  bf16* ps = os + 2 * BQ * LDV;                   // P^T[key][query] hi
  bf16* pl = ps + BK * LDP;                       // P^T lo
  bf16* hs = pl + BK * LDP;                       // dS^T hi
  bf16* ls = hs + BK * LDP;                       // dS^T lo
  float* lse_s = reinterpret_cast<float*>(ls + BK * LDP);   // 2 x BQ
  float* d_s = lse_s + 2 * BQ;                              // 2 x BQ

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  // warp (kg, wh): keys 16 kg.. of the tile; queries 32 wh.. of S^T, and
  // the 16-column blocks 2j + wh of dK and dV
  const int kg = warp & 3, wh = warp >> 2;
  const int bh = blockIdx.x, bi = bh / a.Hkv, hk = bh % a.Hkv;
  const int rep = a.H / a.Hkv;
  const int k0 = blockIdx.y * BK;
  const int nk = (a.d + 15) / 16, nv = (a.dv + 15) / 16;
  const int q_ss = (int)a.q_ss, k_ss = (int)a.k_ss, v_ss = (int)a.v_ss,
            o_ss = (int)a.o_ss;

  // queries that some key of this tile may be seen by: q-tiles
  // [qt0, qt0 + nqt) of each of the rep heads, walked head by head
  const int k_last = min(k0 + BK, a.T) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window ? min(a.S, k_last + a.window) : a.S;
  const int qt0 = q_lo / BQ;
  const int nqt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = rep * nqt;

  // Pad columns, written once (cp.async copies only the d or dv real
  // ones): with d % 16 == 8, K's and Q's columns d..d+7 are zero, so the
  // last k-step adds exactly 0 to S^T and dK's pad columns stay unstored;
  // likewise V's and dO's for dv.
  if (a.d & 15) {      // K, then the Q ring (ks, qs adjoin)
    for (int r = tid; r < BK + 2 * BQ; r += THREADS)
      *reinterpret_cast<uint4*>(ks + r * LDK + a.d) = make_uint4(0, 0, 0, 0);
  }
  if (a.dv & 15) {     // V, then the dO ring
    for (int r = tid; r < BK + 2 * BQ; r += THREADS)
      *reinterpret_cast<uint4*>(vs + r * LDV + a.dv) = make_uint4(0, 0, 0, 0);
  }
  const uint32_t ks_a = smem_addr(ks), qs_a = smem_addr(qs),
                 vs_a = smem_addr(vs), os_a = smem_addr(os),
                 ps_a = smem_addr(ps), pl_a = smem_addr(pl),
                 hs_a = smem_addr(hs),
                 ls_a = smem_addr(ls), lse_a = smem_addr(lse_s),
                 d_a = smem_addr(d_s);
  load_rows<BK>(ks_a, LDK,
                k + bi * a.k_sb + (long long)hk * a.k_sh +
                    (long long)k0 * k_ss,
                k_ss, a.T - k0, a.d / 8);
  load_rows<BK>(vs_a, LDV,
                v + bi * a.v_sb + (long long)hk * a.v_sh +
                    (long long)k0 * v_ss,
                v_ss, a.T - k0, a.dv / 8);
  auto load_q = [&](int it, int stage) {
    const int h = hk * rep + it / nqt;
    const int q0 = (qt0 + it % nqt) * BQ;
    load_rows<BQ>(qs_a + 2u * stage * BQ * LDK, LDK,
                  q + bi * a.q_sb + (long long)h * a.q_sh +
                      (long long)q0 * q_ss,
                  q_ss, a.S - q0, a.d / 8);
    load_rows<BQ>(os_a + 2u * stage * BQ * LDV, LDV,
                  dout + bi * a.o_sb + (long long)h * a.o_sh +
                      (long long)q0 * o_ss,
                  o_ss, a.S - q0, a.dv / 8);
    const long long row = ((long long)bi * a.H + h) * a.S + q0;
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < a.S;
      const float* src = tid < BQ ? lse : dsum;
      cp_async4((tid < BQ ? lse_a : d_a) + 4u * (stage * BQ + r),
                src + row + (ok ? r : 0), ok);
    }
  };
  if (n_it > 0) load_q(0, 0);   // rides in K's and V's group
  cp_async_commit();

  const float sc = a.scale * LOG2E;   // scores in log2 units
  float acc_k[NK][4], acc_v[NV][4];   // n-tiles 2j, 2j + 1: block 2j + wh
#pragma unroll
  for (int j = 0; j < NK; ++j)
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;

  // A operands from rows [m][k]: lane l addresses row l % 16, column
  // 8 (l / 16) of a 16 x 16 block
  const int a_row = 16 * kg + (lane & 15), a_col = 8 * (lane >> 4);
  const uint32_t kA = ks_a + 2u * (a_row * LDK + a_col);
  const uint32_t vA = vs_a + 2u * (a_row * LDV + a_col);
  const uint32_t pA = 2u * (a_row * LDP + a_col);   // in ps, pl, hs, ls
  const int key0 = k0 + 16 * kg + g;                // this thread's keys:
                                                    // key0, key0 + 8
  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_q(it + 1, stage ^ 1);   // the stage of it - 1
    cp_async_commit();
    cp_async_wait<1>();   // tile it (and K, V) have landed
    __syncthreads();
    const int q0 = (qt0 + it % nqt) * BQ;
    const uint32_t qs_st = qs_a + 2u * stage * BQ * LDK;
    const uint32_t os_st = os_a + 2u * stage * BQ * LDV;

    // S^T = K Q^T, dP^T = V dO^T: this warp's 16 keys x 32 queries, four
    // n-tiles of 8 queries; one ldmatrix.x4 of Q (dO) rows gives two
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    const uint32_t qB = qs_st + 2u * ((32 * wh + bn_row(lane)) * LDK +
                                      bn_col(lane));
    const uint32_t oB = os_st + 2u * ((32 * wh + bn_row(lane)) * LDV +
                                      bn_col(lane));
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk >= nk) continue;
      uint32_t af[4];
      ldsm_x4(kA + 32u * kk, af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(qB + 2u * (16 * jj * LDK + 16 * kk), b0, b1, b2, b3);
        mma16816(st[2 * jj], af, b0, b1);
        mma16816(st[2 * jj + 1], af, b2, b3);
      }
    }
#pragma unroll
    for (int kk = 0; kk < NV; ++kk) {
      if (kk >= nv) continue;
      uint32_t af[4];
      ldsm_x4(vA + 32u * kk, af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(oB + 2u * (16 * jj * LDV + 16 * kk), b0, b1, b2, b3);
        mma16816(dpt[2 * jj], af, b0, b1);
        mma16816(dpt[2 * jj + 1], af, b2, b3);
      }
    }

    // P^T and dS^T on the fragments: st[j][e] is key key0 + 8 (e / 2),
    // query q0 + c + e % 2 with c = 32 wh + 8 j + 2 tq; staged as bf16 hi
    // and lo halves
    const bool edge = k0 + BK > a.T || q0 + BQ > a.S ||
                      (a.causal && k0 + BK - 1 > q0) ||
                      (a.window && k0 <= q0 + BQ - 1 - a.window);
    const float* lse_st = lse_s + stage * BQ;
    const float* d_st = d_s + stage * BQ;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * wh + 8 * j + 2 * tq;
      const float2 lq = *reinterpret_cast<const float2*>(lse_st + c);
      const float2 dq_ = *reinterpret_cast<const float2*>(d_st + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? lq.y : lq.x;
        const float dd = (e & 1) ? dq_.y : dq_.x;
        float pe = ex2(fmaf(st[j][e], sc, -l * LOG2E));
        if (edge && !fab::visible(a, q0 + c + (e & 1), key0 + 8 * (e >> 1)))
          pe = 0.f;
        p[e] = pe;
        ds[e] = pe * (dpt[j][e] - dd);
      }
      const int r0 = 16 * kg + g;
      uint32_t hi, lo;
      split_bf16(p[0], p[1], hi, lo);
      *reinterpret_cast<uint32_t*>(ps + r0 * LDP + c) = hi;
      *reinterpret_cast<uint32_t*>(pl + r0 * LDP + c) = lo;
      split_bf16(p[2], p[3], hi, lo);
      *reinterpret_cast<uint32_t*>(ps + (r0 + 8) * LDP + c) = hi;
      *reinterpret_cast<uint32_t*>(pl + (r0 + 8) * LDP + c) = lo;
      split_bf16(ds[0], ds[1], hi, lo);
      *reinterpret_cast<uint32_t*>(hs + r0 * LDP + c) = hi;
      *reinterpret_cast<uint32_t*>(ls + r0 * LDP + c) = lo;
      split_bf16(ds[2], ds[3], hi, lo);
      *reinterpret_cast<uint32_t*>(hs + (r0 + 8) * LDP + c) = hi;
      *reinterpret_cast<uint32_t*>(ls + (r0 + 8) * LDP + c) = lo;
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries (4 k-steps):
    // P^T's and dS^T's halves as A fragments; dO, Q through ldmatrix.trans
    const uint32_t oBt = os_st + 2u * (bt_row(lane) * LDV + bt_col(lane));
    const uint32_t qBt = qs_st + 2u * (bt_row(lane) * LDK + bt_col(lane));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ha[4], la[4];   // the hi and lo halves, of P^T, then dS^T
      ldsm_x4(ps_a + pA + 32u * kk, ha[0], ha[1], ha[2], ha[3]);
      ldsm_x4(pl_a + pA + 32u * kk, la[0], la[1], la[2], la[3]);
#pragma unroll
      for (int j = 0; j < NV / 2; ++j) {
        const int nn = 2 * j + wh;
        if (16 * nn >= a.dv) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(oBt + 2u * (16 * kk * LDV + 16 * nn), b0, b1, b2, b3);
        mma16816(acc_v[2 * j], ha, b0, b1);
        mma16816(acc_v[2 * j + 1], ha, b2, b3);
        mma16816(acc_v[2 * j], la, b0, b1);
        mma16816(acc_v[2 * j + 1], la, b2, b3);
      }
      ldsm_x4(hs_a + pA + 32u * kk, ha[0], ha[1], ha[2], ha[3]);
      ldsm_x4(ls_a + pA + 32u * kk, la[0], la[1], la[2], la[3]);
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        const int nn = 2 * j + wh;
        if (16 * nn >= a.d) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(qBt + 2u * (16 * kk * LDK + 16 * nn), b0, b1, b2, b3);
        mma16816(acc_k[2 * j], ha, b0, b1);
        mma16816(acc_k[2 * j + 1], ha, b2, b3);
        mma16816(acc_k[2 * j], la, b0, b1);
        mma16816(acc_k[2 * j + 1], la, b2, b3);
      }
    }
    __syncthreads();   // P^T, dS^T and this stage are consumed
  }
  cp_async_wait<0>();

  // acc[2j + t][e]: key key0 + 8 (e / 2), column 16 (2j + wh) + 8t + 2tq
  // + e % 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = key0 + 8 * half;
    if (kp >= a.T) continue;
    const long long row = ((long long)bi * a.T + kp) * a.Hkv + hk;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int col = 16 * (2 * (j / 2) + wh) + 8 * (j & 1) + 2 * tq;
      if (col >= a.d) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + row * a.d + col) =
          __floats2bfloat162_rn(acc_k[j][2 * half] * a.scale,
                                acc_k[j][2 * half + 1] * a.scale);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = 16 * (2 * (j / 2) + wh) + 8 * (j & 1) + 2 * tq;
      if (col >= a.dv) continue;
      *reinterpret_cast<__nv_bfloat162*>(dv + row * a.dv + col) =
          __floats2bfloat162_rn(acc_v[j][2 * half], acc_v[j][2 * half + 1]);
    }
  }
}

// dQ of one q-tile of 128 rows of one head: grid (B * H, q-tiles), the
// causal mask's heaviest (last) q-tiles first.
template <int NK, int NV>
__global__ void __launch_bounds__(THREADS, 1)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dq, Args a) {
  constexpr int LDK = 16 * NK + 8, LDV = 16 * NV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BQ2 x LDK
  bf16* ks = qs + BQ2 * LDK;                      // 2 stages x BK x LDK
  bf16* os = ks + 2 * BK * LDK;                   // BQ2 x LDV (dO)
  bf16* vs = os + BQ2 * LDV;                      // 2 stages x BK x LDV

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.S + BQ2 - 1) / BQ2;
  const int q0 = (a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ2;
  const int nk = (a.d + 15) / 16, nv = (a.dv + 15) / 16;
  const int q_ss = (int)a.q_ss, k_ss = (int)a.k_ss, v_ss = (int)a.v_ss,
            o_ss = (int)a.o_ss;
  const bf16* kp = k + bi * a.k_sb + (long long)hk * a.k_sh;
  const bf16* vp = v + bi * a.v_sb + (long long)hk * a.v_sh;

  // keys that some row of this query tile may see (the forward's range)
  const int q_last = min(q0 + BQ2, a.S) - 1;
  const int k_hi = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_lo = a.window ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_lo / BK, kt1 = (k_hi + BK - 1) / BK;   // [kt0, kt1)

  if (a.d & 15) {      // Q rows, then the K ring (qs, ks adjoin)
    for (int r = tid; r < BQ2 + 2 * BK; r += THREADS)
      *reinterpret_cast<uint4*>(qs + r * LDK + a.d) = make_uint4(0, 0, 0, 0);
  }
  if (a.dv & 15) {     // dO rows, then the V ring
    for (int r = tid; r < BQ2 + 2 * BK; r += THREADS)
      *reinterpret_cast<uint4*>(os + r * LDV + a.dv) = make_uint4(0, 0, 0, 0);
  }
  const uint32_t qs_a = smem_addr(qs), ks_a = smem_addr(ks),
                 os_a = smem_addr(os), vs_a = smem_addr(vs);
  load_rows<BQ2>(qs_a, LDK,
                 q + bi * a.q_sb + (long long)h * a.q_sh +
                     (long long)q0 * q_ss,
                 q_ss, a.S - q0, a.d / 8);
  load_rows<BQ2>(os_a, LDV,
                 dout + bi * a.o_sb + (long long)h * a.o_sh +
                     (long long)q0 * o_ss,
                 o_ss, a.S - q0, a.dv / 8);
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    load_rows<BK>(ks_a + 2u * stage * BK * LDK, LDK,
                  kp + (long long)k0 * k_ss, k_ss, a.T - k0, a.d / 8);
    load_rows<BK>(vs_a + 2u * stage * BK * LDV, LDV,
                  vp + (long long)k0 * v_ss, v_ss, a.T - k0, a.dv / 8);
  };
  if (kt0 < kt1) load_kv(kt0, 0);   // Q and dO ride in the first group
  cp_async_commit();

  // this thread's rows row0 and row0 + 8: lse in log2 units, and D
  const int row0 = q0 + 16 * warp + g;
  const long long lrow = ((long long)bi * a.H + h) * a.S;
  float l2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    l2[half] = r < a.S ? lse[lrow + r] * LOG2E : 0.f;
    dd[half] = r < a.S ? dsum[lrow + r] : 0.f;
  }
  const float sc = a.scale * LOG2E;
  float acc[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int a_row = 16 * warp + (lane & 15), a_col = 8 * (lane >> 4);
  const uint32_t qA = qs_a + 2u * (a_row * LDK + a_col);
  const uint32_t oA = os_a + 2u * (a_row * LDV + a_col);
  for (int t = kt0; t < kt1; ++t) {
    const int stage = (t - kt0) & 1;
    if (t + 1 < kt1) load_kv(t + 1, stage ^ 1);   // the stage of t - 1
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and Q, dO) have landed
    __syncthreads();
    const int k0 = t * BK;
    const uint32_t ks_st = ks_a + 2u * stage * BK * LDK;
    const uint32_t vs_st = vs_a + 2u * stage * BK * LDV;

    // S = Q K^T, dP = dO V^T: 16 rows x 64 keys, 8 n-tiles
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const uint32_t kB = ks_st + 2u * (bn_row(lane) * LDK + bn_col(lane));
    const uint32_t vB = vs_st + 2u * (bn_row(lane) * LDV + bn_col(lane));
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk >= nk) continue;
      uint32_t af[4];
      ldsm_x4(qA + 32u * kk, af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kB + 2u * (16 * jj * LDK + 16 * kk), b0, b1, b2, b3);
        mma16816(s[2 * jj], af, b0, b1);
        mma16816(s[2 * jj + 1], af, b2, b3);
      }
    }
#pragma unroll
    for (int kk = 0; kk < NV; ++kk) {
      if (kk >= nv) continue;
      uint32_t af[4];
      ldsm_x4(oA + 32u * kk, af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(vB + 2u * (16 * jj * LDV + 16 * kk), b0, b1, b2, b3);
        mma16816(dp[2 * jj], af, b0, b1);
        mma16816(dp[2 * jj + 1], af, b2, b3);
      }
    }

    // dS = P o (dP - D) in place of S: s[j][e] is row row0 + 8 (e / 2),
    // key k0 + 8 j + 2 tq + e % 2
    const bool edge = k0 + BK > a.T || q0 + BQ2 > a.S ||
                      (a.causal && k0 + BK - 1 > q0) ||
                      (a.window && k0 <= q0 + BQ2 - 1 - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float pe = ex2(fmaf(s[j][e], sc, -l2[half]));
        if (edge && !fab::visible(a, row0 + 8 * half,
                                  k0 + 8 * j + 2 * tq + (e & 1)))
          pe = 0.f;
        s[j][e] = pe * (dp[j][e] - dd[half]);
      }
    }

    // dQ += dS K: the C fragments of n-tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk (keys 16kk..), as bf16 hi and lo halves; K
    // through ldmatrix.trans
    const uint32_t kBt = ks_st + 2u * (bt_row(lane) * LDK + bt_col(lane));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        if (16 * nn >= a.d) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(kBt + 2u * (16 * kk * LDK + 16 * nn), b0, b1, b2, b3);
        mma16816(acc[2 * nn], ah, b0, b1);
        mma16816(acc[2 * nn + 1], ah, b2, b3);
        mma16816(acc[2 * nn], al, b0, b1);
        mma16816(acc[2 * nn + 1], al, b2, b3);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row0 + 8 * half;
    if (qpos >= a.S) continue;
    bf16* row = dq + (((long long)bi * a.S + qpos) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= a.d) continue;
      *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
          acc[j][2 * half] * a.scale, acc[j][2 * half + 1] * a.scale);
    }
  }
}

template <int NK, int NV>
int launch_body(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dsum,
                void* dq, void* dk, void* dv, int B, const Args& a,
                void* stream) {
  if (a.d > 16 * NK || a.dv > 16 * NV) return (int)cudaErrorInvalidValue;
  constexpr size_t LDK = 16 * NK + 8, LDV = 16 * NV + 8;
  const size_t s1 = 2 * ((BK + 2 * BQ) * (LDK + LDV) + 4 * BK * LDP) +
                    4 * 4 * BQ;
  const size_t s2 = 2 * (BQ2 + 2 * BK) * (LDK + LDV);
  if (s1 > (size_t)SMEM_MAX || s2 > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto* k1 = dkdv_tc_kernel<NK, NV>;
  auto* k2 = dq_tc_kernel<NK, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g1(B * a.Hkv, (a.T + BK - 1) / BK);
  k1<<<g1, THREADS, s1, st>>>((const bf16*)q, (const bf16*)k,
                              (const bf16*)v, (const bf16*)dout,
                              (const float*)lse, (const float*)dsum,
                              (bf16*)dk, (bf16*)dv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(B * a.H, (a.S + BQ2 - 1) / BQ2);
  k2<<<g2, THREADS, s2, st>>>((const bf16*)q, (const bf16*)k,
                              (const bf16*)v, (const bf16*)dout,
                              (const float*)lse, (const float*)dsum,
                              (bf16*)dq, a);
  return (int)cudaGetLastError();
}

// The body is the caller's choice (kernel.py:fa_bwd_body, the one rule;
// its index in kernel.py:BWD_BODIES): 1, 8 k-steps over d; 2, 12.  Each
// checks only the widths it can hold: d and dv multiples of 8, dv <= 128,
// d <= 16 * NK.
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, void* dq, void* dk, void* dv,
           int B, const Args& a, int body, void* stream) {
  if (a.d % 8 || a.dv % 8 || a.d <= 0 || a.dv <= 0)
    return (int)cudaErrorInvalidValue;
  if (body == 1)
    return launch_body<8, 8>(q, k, v, dout, lse, dsum, dq, dk, dv, B, a,
                             stream);
  if (body == 2)
    return launch_body<12, 8>(q, k, v, dout, lse, dsum, dq, dk, dv, B, a,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fab_tc

#define FLASH_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,              \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv, int B, \
      int S, int T_, int H, int Hkv, int d, int dvw, int causal, int window,  \
      float scale, long long q_sb, long long q_ss, long long q_sh,            \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,         \
      long long v_ss, long long v_sh, long long o_sb, long long o_ss,         \
      long long o_sh, void *stream, int body

#define FLASH_BWD_ARGS_STRUCT                                                 \
  fab::Args a{S,    T_,   H,    Hkv,  d,    dvw,  causal, window, scale,      \
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,       \
              o_sb, o_ss, o_sh};

// Launches the dK/dV pass, then the dQ pass, on ``stream``; dq (B,S,H,d),
// dk (B,T,Hkv,d) and dv (B,T,Hkv,dv) are contiguous, lse and dsum f32
// (B,H,S) contiguous; q, k, v and dO are read through their strides.
// body: the index in kernel.py:BWD_BODIES; 0, the CUDA-core body, is
// f32's one.
extern "C" int flash_attention_bwd_f32(FLASH_BWD_ARGS) {
  if (body != 0) return (int)cudaErrorInvalidValue;
  FLASH_BWD_ARGS_STRUCT
  return fab::launch<float>(q, k, v, dout, lse, dsum, dq, dk, dv, B, a,
                            stream);
}

extern "C" int flash_attention_bwd_bf16(FLASH_BWD_ARGS) {
  FLASH_BWD_ARGS_STRUCT
  if (body == 0)
    return fab::launch<__nv_bfloat16>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                      B, a, stream);
  return fab_tc::launch(q, k, v, dout, lse, dsum, dq, dk, dv, B, a, body,
                        stream);
}
