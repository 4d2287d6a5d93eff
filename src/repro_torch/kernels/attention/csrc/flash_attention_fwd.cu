// Flash-attention forward: o = softmax(q k^T / sqrt(d) + mask) v with an
// online softmax over KV blocks, causal / sliding-window / KV-length masks,
// GQA (q head h reads kv head h / (H/Hkv)), f32 math from f32 or bf16 in,
// out in the input dtype.
//
// Replaces the Pallas kernel
// src/repro/kernels/attention/kernel.py:flash_attention_fwd (body
// _flash_kernel; pallas_call at kernel.py:92).  The TPU kernel walks the kv
// blocks as the innermost, sequential grid axis and keeps the running max,
// denominator and accumulator in VMEM scratch across grid steps.  Blocks of
// a CUDA grid run in no order, so here the kv axis is a loop inside one
// block over (batch*head, 64-query block), and the running statistics live
// in registers.  q, k and v are read in the model's (B, S, H, d) layout
// through their strides, so the transposes of the reference's ops.py go.
//
// What bounds it on the H100 (Zamba2-2.7B shared block prefill, B = 2,
// S = T = 8,192, H = Hkv = 32, d = dv = 80, causal, bf16): per head
// 8,192 * 8,193 / 2 visible pairs, each 2 * (d + dv) = 320 flop of
// products: ~687 GFLOP, ~0.69 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, against 0.13 GB of q, k, v and o (~0.04 ms at 3.35 TB/s):
// bound by operations.  This first version computes Q K^T and P V on the
// CUDA cores in f32 (67 TFLOP/s peak, >= 10 ms for that work): wgmma, TMA
// and pipelining are later work.
//
// Design: 256 threads per block; thread (rg, cg) = (t / 16, t % 16) owns
// query rows 4rg..4rg+3, score columns 4cg..4cg+3 of each 64-key block and
// output columns cg, cg+16, ... of its rows.  Q (pre-scaled) and each K
// block sit transposed in shared memory so both factors of Q K^T are read
// as float4s; the 16 threads of a row reduce its max and sum with
// shuffles.  KV blocks that the causal or window mask removes for every
// row of the query block are skipped: exact, since in the reference such a
// block either adds nothing (e^{-1e30 - m} = 0) or is wiped later by
// alpha = 0.  The finite -1e30 sentinel is kept: with -inf, a row whose
// first block is fully masked under a window would compute e^{-inf + inf}.
// Ragged S and T are bounds-checked; nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace fa {

constexpr int THREADS = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDQ = BQ + 4;      // row stride of Q^T, K^T and P
constexpr int MAXC = 8;          // output columns per thread: dv <= 128
constexpr int SMEM_MAX = 232448;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  int S, T, H, Hkv, d, dv, dv16, causal, window;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__host__ inline size_t smem_floats(int d, int dv16) {
  return (size_t)2 * d * LDQ + (size_t)BK * dv16 + (size_t)BQ * LDQ;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Args a) {
  extern __shared__ __align__(16) float sm[];
  const int d = a.d, dv = a.dv, dv16 = a.dv16;
  float* qT = sm;                  // q[r][e] * scale at qT[e * LDQ + r]
  float* kT = qT + d * LDQ;        // k[c][e] at kT[e * LDQ + c]
  float* vs = kT + d * LDQ;        // v[c][e] at vs[c * dv16 + e]
  float* ps = vs + BK * dv16;      // p[r][c] at ps[r * LDQ + c]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int r0 = 4 * rg, c0 = 4 * cg;
  const int bh = blockIdx.y, bi = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bi * a.q_sb + (long long)h * a.q_sh;
  const T* kb = k + bi * a.k_sb + (long long)hk * a.k_sh;
  const T* vb = v + bi * a.v_sb + (long long)hk * a.v_sh;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, e = i % d;
    qT[e * LDQ + r] =
        q0 + r < a.S ? to_f(qb[(long long)(q0 + r) * a.q_ss + e]) * a.scale
                     : 0.f;
  }

  // key range that some row of this query block may see
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_lo = a.window ? max(0, q0 - a.window + 1) : 0;

  float m[4], l[4], acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // previous block's K, V and P are consumed
    for (int i = tid; i < BK * d; i += THREADS) {
      const int c = i / d, e = i % d;
      kT[e * LDQ + c] =
          k0 + c < a.T ? to_f(kb[(long long)(k0 + c) * a.k_ss + e]) : 0.f;
    }
    for (int i = tid; i < BK * dv16; i += THREADS) {
      const int c = i / dv16, e = i % dv16;
      vs[i] = (k0 + c < a.T && e < dv)
                  ? to_f(vb[(long long)(k0 + c) * a.v_ss + e])
                  : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int e = 0; e < d; ++e) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[e * LDQ + r0]);
      const float4 kv = *reinterpret_cast<const float4*>(&kT[e * LDQ + c0]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r0 + i;
      float mb = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c0 + j;
        bool ok = kp < a.T;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window) ok = ok && kp > qp - a.window;
        s[i][j] = ok ? s[i][j] : NEG;
        mb = fmaxf(mb, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float alpha = expf(m[i] - m_new);
      float pr[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[j] = expf(s[i][j] - m_new);
        rs += pr[j];
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(&ps[(r0 + i) * LDQ + c0]) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(r0 + i) * LDQ + c]);
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int e = j * 16 + cg;
        if (e >= dv16) continue;
        const float v0 = vs[c * dv16 + e], v1 = vs[(c + 1) * dv16 + e];
        const float v2 = vs[(c + 2) * dv16 + e], v3 = vs[(c + 3) * dv16 + e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][j];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][j] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)bi * a.S + qp) * a.H + h) * dv;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int e = j * 16 + cg;
      if (e < dv) store(orow + e, acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           Args a, void* stream) {
  a.dv16 = (a.dv + 15) / 16 * 16;
  if (a.dv16 > 16 * MAXC) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(a.d, a.dv16) * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, a);
  return (int)cudaGetLastError();
}

}  // namespace fa

#define FLASH_FWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      int B, int S, int T_, int H, int Hkv, int d, int dv,    \
                      int causal, int window, float scale, long long q_sb,    \
                      long long q_ss, long long q_sh, long long k_sb,         \
                      long long k_ss, long long k_sh, long long v_sb,         \
                      long long v_ss, long long v_sh, void* stream) {         \
    fa::Args a{S,    T_,   H,    Hkv,  d,    dv,   0,    causal, window,      \
               scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss, v_sh}; \
    return fa::launch<T>(q, k, v, o, B, a, stream);                           \
  }

FLASH_FWD_ENTRY(flash_attention_fwd_f32, float)
FLASH_FWD_ENTRY(flash_attention_fwd_bf16, __nv_bfloat16)
