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
// * dK/dV (dkdv_kernel): one block per (k-tile of 64 keys, kv head, batch).
//   K and V stay in shared memory; the block walks the kv head's ``rep``
//   query heads and, for each, the q-tiles the masks let see the tile
//   (causal: q >= the tile's first key; window: q < its last key +
//   window), recomputes S^T and dP^T for the tile pair, and accumulates
//   dV and dK in registers.
// * dQ (dq_kernel): one block per (q-tile of 64 rows, head, batch); Q, dO,
//   lse and D stay in shared memory while it walks the k-tiles the masks
//   leave (the forward's range), recomputes S and dP and accumulates dQ.
//
// All math is f32 on the CUDA cores, in the forward's f32 layout: 256
// threads, thread (rg, cg) = (t / 16, t % 16) owns rows 4rg..4rg+3 and
// columns 4cg..4cg+3 of each 64 x 64 score tile, and output columns cg,
// cg + 16, ... of its rows (dv <= 128, d <= 192).  Tiles sit transposed in
// shared memory (row stride 68 floats) so both factors of every product
// are read as float4s.  bf16 inputs are read and converted; tensor cores,
// wgmma and TMA are later work.
//
// What bounds it on the H100 (qwen2-7b training, B = 2, S = T = 4,096, 32
// heads over 4 kv heads, d = dv = 128, causal): 470 M visible pairs, each
// 2 (3d + 2dv) = 1,280 flop of products at the least: ~602 GFLOP, 0.61 ms
// at the bf16 tensor-core peak, against 0.3 GB of q, k, v, o, dO, lse in
// and dq, dk, dv out (~0.1 ms at 3.35 TB/s): bound by operations.  These
// bodies do 2 (4d + 3dv) flop a pair in f32 FMAs (S and dP in both passes)
// at most 67 TFLOP/s, and every FMA pair reads a float4 of shared memory:
// a CUDA-core body sits an order of magnitude above that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

#define FLASH_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,              \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv, int B, \
      int S, int T_, int H, int Hkv, int d, int dvw, int causal, int window,  \
      float scale, long long q_sb, long long q_ss, long long q_sh,            \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,         \
      long long v_ss, long long v_sh, long long o_sb, long long o_ss,         \
      long long o_sh, void *stream

// Launches the dK/dV pass, then the dQ pass, on ``stream``; dq (B,S,H,d),
// dk (B,T,Hkv,d) and dv (B,T,Hkv,dv) are contiguous, lse and dsum f32
// (B,H,S) contiguous; q, k, v and dO are read through their strides.
#define FLASH_BWD_BODY(T)                                                     \
  fab::Args a{S,    T_,   H,    Hkv,  d,    dvw,  causal, window, scale,      \
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,       \
              o_sb, o_ss, o_sh};                                              \
  return fab::launch<T>(q, k, v, dout, lse, dsum, dq, dk, dv, B, a, stream);

extern "C" int flash_attention_bwd_f32(FLASH_BWD_ARGS) {
  FLASH_BWD_BODY(float)
}

extern "C" int flash_attention_bwd_bf16(FLASH_BWD_ARGS) {
  FLASH_BWD_BODY(__nv_bfloat16)
}
