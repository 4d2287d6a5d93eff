// Flash-attention forward: o = softmax(q k^T / sqrt(d) + mask) v with an
// online softmax over KV blocks, causal / sliding-window / KV-length masks,
// GQA (q head h reads kv head h / (H/Hkv)), f32 or bf16 in, out in the
// input dtype.
//
// Replaces the Pallas kernel
// src/repro/kernels/attention/kernel.py:flash_attention_fwd (body
// _flash_kernel; pallas_call at kernel.py:92).  The TPU kernel walks the kv
// blocks as the innermost, sequential grid axis and keeps the running max,
// denominator and accumulator in VMEM scratch across grid steps.  Blocks of
// a CUDA grid run in no order, so here the kv axis is a loop inside one
// block over (batch*head, query block), and the running statistics live
// in registers.  q, k and v are read in the model's (B, S, H, d) layout
// through their strides, so the transposes of the reference's ops.py go.
//
// What bounds it on the H100 (Zamba2-2.7B shared block prefill, B = 2,
// S = T = 8,192, H = Hkv = 32, d = dv = 80, causal, bf16): per head
// 8,192 * 8,193 / 2 visible pairs, each 2 * (d + dv) = 320 flop of
// products: ~687 GFLOP, ~0.69 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, against 0.13 GB of q, k, v and o (~0.04 ms at 3.35 TB/s):
// bound by operations.
//
// Two bodies, one per input dtype:
//
// * bf16 (fa_tc::flash_fwd_tc_kernel) runs both products on the tensor
//   cores, in the FlashAttention-2 shape.  Each warp owns 16 query rows
//   (a block is 8 warps, 128 rows); the block's Q tile is loaded once into
//   registers as mma.sync m16n8k16 A fragments through ldmatrix.  K and V
//   tiles of 64 keys stream through a two-stage ring in shared memory with
//   16-byte cp.async.cg copies, so the next tile loads while this one
//   computes.  K is read with ldmatrix and V with ldmatrix.trans, so no
//   tile is transposed by scalar stores; rows are padded by 16 bytes (a
//   stride of an odd number of 16-byte chunks), so ldmatrix's eight row
//   addresses fall in eight different bank groups.  S = Q K^T accumulates
//   in f32 (bf16 products are exact in f32); the scale 1/sqrt(d) (times
//   log2 e, for exp2) is applied to the f32 scores, as the reference
//   scales q in f32 before its product.  The online softmax runs on the
//   accumulator fragments: the 4 threads of a quad that share a row
//   reduce its max with shuffles, and each keeps a partial row sum that is
//   reduced once at the end.  P goes straight from the S accumulators
//   into bf16 A fragments of O += P V (no trip through shared memory), as
//   two halves: hi = bf16(p) and lo = bf16(p - hi), each multiplied with
//   the same V fragments, so P V keeps ~16 bits of p.  With hi alone, an
//   output's error beyond its own bf16 rounding reaches ~3e-3 of its
//   row's max |out|; with both, ~4e-6 (a numpy emulation of this body at
//   d = 80, causal, 4,096 rows; tests/test_torch_attention.py).
//   chip_smoke.py holds the kernel to 1e-4 of that measure.  The row sum
//   adds the f32 p.  O accumulates in f32 registers and is scaled by 1/l
//   and rounded once at the end.  The causal grid runs the last
//   (heaviest) query blocks of every head first.
//   Needs d % 8 == 0 up to 192 and dv % 8 == 0 up to 128, 16-byte
//   aligned base pointers and strides, and sequence strides below 2^23
//   elements (the offsets within a tile of at most 256 rows are 32-bit;
//   kernel.py:check_bf16_layout says so before launch).  A d with
//   d % 16 == 8 (h2o-danube's 120 = 7 * 16 + 8) copies its 15 chunks of
//   a Q or K row and leaves columns d..d+7 at the zeros written once at
//   the start, so the padded k-step adds exactly 0; the scale is the
//   caller's, d^-1/2 of the true d.  Three instantiations: the exact
//   d = dv = 80 one (Zamba2; two blocks an SM), a guarded one with 8
//   k-steps (d <= 128) and one with 12 (d <= 192: deepseek-v3's MLA
//   prefill, d = 192, dv = 128; 48 registers of Q fragments a thread,
//   one block an SM).  The tile copies of the exact body unroll at
//   compile time, each thread's chunk offsets computed with constant
//   divisions.  wgmma, TMA and warp specialisation
//   (FlashAttention-3's shape) are the next step: their 128-byte swizzle
//   atoms do not tile a 160-byte row of d = 80 without padding d.
//
// * f32 (fa::flash_fwd_kernel) stays on the CUDA cores, in f32 FMAs: TF32
//   tensor-core products keep ~10 bits of mantissa and would break the f32
//   bars the port holds this path to (1e-4 of max |ref| against the plain
//   version, and the full-width f32 decode-vs-prefill parity of the model).
//   256 threads per block; thread (rg, cg) = (t / 16, t % 16) owns query
//   rows 4rg..4rg+3, score columns 4cg..4cg+3 of each 64-key block and
//   output columns cg, cg+16, ... of its rows.  Q (pre-scaled) and each K
//   block sit transposed in shared memory so both factors of Q K^T are
//   read as float4s; the 16 threads of a row reduce its max and sum with
//   shuffles.
//
// Training asks for a second output, each row's log-sum-exp of its scaled,
// masked scores (f32, (B, H, S), natural log), which both bodies write from
// the running max and sum they already hold; the backward kernels
// (flash_attention_bwd.cu) rebuild P from it.  Serving passes a null
// pointer and writes nothing more.
//
// Both bodies skip KV blocks that the causal or window mask removes for
// every row of the query block: exact, since in the reference such a block
// either adds nothing (e^{-1e30 - m} = 0) or is wiped later by alpha = 0.
// The finite -1e30 sentinel is kept: with -inf, a row whose first block is
// fully masked under a window would compute e^{-inf + inf}.  Ragged S and T
// are bounds-checked (the bf16 body zero-fills the copies past the edge);
// nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace fa {

constexpr int THREADS = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDQ = BQ + 4;      // row stride of Q^T, K^T and P
constexpr int MAXC = 8;          // output columns per thread: dv <= 128
constexpr int SMEM_MAX = 232448;
constexpr float NEG = -1e30f;

struct Args {
  int S, T, H, Hkv, d, dv, dv16, causal, window;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__host__ inline size_t smem_floats(int d, int dv16) {
  return (size_t)2 * d * LDQ + (size_t)BK * dv16 + (size_t)BQ * LDQ;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Args a) {
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
  const float* qb = q + bi * a.q_sb + (long long)h * a.q_sh;
  const float* kb = k + bi * a.k_sb + (long long)hk * a.k_sh;
  const float* vb = v + bi * a.v_sb + (long long)hk * a.v_sh;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, e = i % d;
    qT[e * LDQ + r] =
        q0 + r < a.S ? qb[(long long)(q0 + r) * a.q_ss + e] * a.scale
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
          k0 + c < a.T ? kb[(long long)(k0 + c) * a.k_ss + e] : 0.f;
    }
    for (int i = tid; i < BK * dv16; i += THREADS) {
      const int c = i / dv16, e = i % dv16;
      vs[i] = (k0 + c < a.T && e < dv)
                  ? vb[(long long)(k0 + c) * a.v_ss + e]
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
    if (lse != nullptr && cg == 0)   // natural log units: q was scaled
      lse[((long long)bi * a.H + h) * a.S + qp] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    float* orow = o + (((long long)bi * a.S + qp) * a.H + h) * dv;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int e = j * 16 + cg;
      if (e < dv) orow[e] = acc[i][j] * inv;
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, Args a, void* stream) {
  a.dv16 = (a.dv + 15) / 16 * 16;
  if (a.dv16 > 16 * MAXC) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(a.d, a.dv16) * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, a);
  return (int)cudaGetLastError();
}

}  // namespace fa

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------
namespace fa_tc {

// The block shape was chosen on the H100 by timing build variants in turns
// at Zamba2's prefill shapes (PERF.md): 8 warps beat 4, two blocks per SM
// (a 128-register cap on the exact body) beat one, and a third K/V stage
// gained nothing.
using bf16 = __nv_bfloat16;
constexpr int NW = 8;                 // warps per block, 16 query rows each
constexpr int MIN_BLOCKS = 2;         // blocks per SM (exact body)
constexpr int THREADS = 32 * NW;
constexpr int BQ = 16 * NW;
constexpr int BK = 64;                // keys per tile: 8 n-tiles of S
constexpr int STAGES = 2;             // K/V ring depth
constexpr int SMEM_MAX = 232448;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using namespace fa_mma;   // fa_common.cuh

struct Args {
  int S, T, H, Hkv, d, dv, causal, window;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// Copy ROWS rows of 16-byte chunks (row r from src + r * stride) into
// shared memory at ``dst`` with a row stride of ``ld`` elements; rows at or
// past ``valid`` are zero-filled.  CH > 0 fixes the chunks per row at
// compile time (the copy unrolls, with constant divisions); CH = 0 reads
// them from ``nch``.
template <int ROWS, int CH>
__device__ __forceinline__ void load_rows(uint32_t dst, int ld,
                                          const bf16* src, int stride,
                                          int valid, int nch) {
  auto copy = [&](int c, int n) {
    const int r = c / n, ch = c - r * n;
    const bool ok = r < valid;
    cp_async16(dst + 2u * (r * ld + 8 * ch), src + (ok ? r * stride + 8 * ch
                                                       : 0), ok);
  };
  if constexpr (CH > 0) {
    constexpr int TOTAL = ROWS * CH;
#pragma unroll
    for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
      const int c = threadIdx.x + THREADS * it;
      if (TOTAL % THREADS == 0 || c < TOTAL) copy(c, CH);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * nch; c += THREADS) copy(c, nch);
  }
}

// NK: k-steps of 16 over d; NV: 16-column groups over dv (ceil(dv / 16)).
// EXACT: d == 16 NK and dv == 16 NV, so no step is guarded at run time.
template <int NK, int NV, bool EXACT>
__global__ void __launch_bounds__(THREADS, EXACT ? MIN_BLOCKS : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Args a) {
  constexpr int LDK = 16 * NK + 8;    // row strides in elements: an odd
  constexpr int LDV = 16 * NV + 8;    // number of 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LDK;                 // STAGES x BK x LDK
  bf16* vs = ks + STAGES * BK * LDK;        // STAGES x BK x LDV

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.S + BQ - 1) / BQ;
  const int qb = a.causal ? nq - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * BQ;
  const int nk = EXACT ? NK : (a.d + 15) / 16;   // k-steps, the last padded
  constexpr int CK = EXACT ? 2 * NK : 0;       // 16-byte chunks of a K row
  constexpr int CV = EXACT ? 2 * NV : 0;       // and of a V row
  const int q_ss = (int)a.q_ss, k_ss = (int)a.k_ss, v_ss = (int)a.v_ss;
  const bf16* qp = q + bi * a.q_sb + (long long)h * a.q_sh;
  const bf16* kp = k + bi * a.k_sb + (long long)hk * a.k_sh;
  const bf16* vp = v + bi * a.v_sb + (long long)hk * a.v_sh;

  // key range that some row of this query block may see
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_lo = a.window ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_lo / BK, kt1 = (k_hi + BK - 1) / BK;   // [kt0, kt1)

  // Pad columns, written once (cp.async copies only the d or dv real
  // ones): with d % 16 == 8, Q's and K's columns d..d+7 are zero, so the
  // last k-step's extra products add exactly 0 to S; with dv % 16 == 8,
  // V's feed O's unused columns.
  if (!EXACT && (a.d & 15)) {    // Q rows, then the K ring (qs, ks adjoin)
    for (int r = tid; r < BQ + STAGES * BK; r += THREADS)
      *reinterpret_cast<uint4*>(qs + r * LDK + a.d) = make_uint4(0, 0, 0, 0);
  }
  if (!EXACT && (a.dv & 15)) {
    for (int r = tid; r < STAGES * BK; r += THREADS)
      *reinterpret_cast<uint4*>(vs + r * LDV + a.dv) = make_uint4(0, 0, 0, 0);
  }
  const uint32_t qs_a = smem_addr(qs), ks_a = smem_addr(ks),
                 vs_a = smem_addr(vs);
  load_rows<BQ, CK>(qs_a, LDK, qp + (long long)q0 * q_ss, q_ss, a.S - q0,
                    a.d / 8);
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    load_rows<BK, CK>(ks_a + 2u * stage * BK * LDK, LDK,
                      kp + (long long)k0 * k_ss, k_ss, a.T - k0, a.d / 8);
    load_rows<BK, CV>(vs_a + 2u * stage * BK * LDV, LDV,
                      vp + (long long)k0 * v_ss, v_ss, a.T - k0, a.dv / 8);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {   // Q rides in the first group
    if (kt0 + st < kt1) load_kv(kt0 + st, st);
    cp_async_commit();
  }

  const float sc = a.scale * LOG2E;         // scores in log2 units
  const int row0 = q0 + 16 * warp + g;      // this thread's rows: row0, +8
  uint32_t qf[NK][4];
  float oacc[2 * NV][4];
#pragma unroll
  for (int j = 0; j < 2 * NV; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int t = kt0; t < kt1; ++t) {
    const int stage = (t - kt0) % STAGES;
    if (t + STAGES - 1 < kt1)   // into the stage consumed at t - 1
      load_kv(t + STAGES - 1, (t - kt0 + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // tile t (and Q) have landed
    __syncthreads();
    if (t == kt0) {
      // Q's A fragments: lane l addresses row l % 16, column 8 (l / 16)
      const uint32_t qa = qs_a + 2u * ((16 * warp + (lane & 15)) * LDK +
                                       8 * (lane >> 4));
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (EXACT || kk < nk)
          ldsm_x4(qa + 32u * kk, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }

    // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 gives two n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t kb = ks_a + 2u * (stage * BK * LDK +
                                     ((lane & 7) + 8 * (lane >> 4)) * LDK +
                                     8 * ((lane >> 3) & 1));
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (!EXACT && kk >= nk) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kb + 2u * (16 * jj * LDK + 16 * kk), b0, b1, b2, b3);
        mma16816(s[2 * jj], qf[kk], b0, b1);
        mma16816(s[2 * jj + 1], qf[kk], b2, b3);
      }
    }

    // online softmax on the fragments: s[j][0..1] are row0, keys
    // k0 + 8j + 2tq + {0,1}; s[j][2..3] the same keys of row0 + 8.  A tile
    // that a mask touches is scaled and masked here (mul = 1 after); an
    // interior one keeps its raw scores, and the scale goes into the max
    // (rounding is monotonic, so round(sc * max s) = max round(sc * s))
    // and into one fma per exponent.
    const int k0 = t * BK;
    const bool edge = k0 + BK > a.T || (a.causal && k0 + BK - 1 > q0) ||
                      (a.window && k0 <= q_last - a.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
          bool ok = kpos < a.T;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && kpos > qpos - a.window;
          s[j][e] = ok ? s[j][e] * sc : NEG;
        }
      }
    }
    const float mul = edge ? 1.f : sc;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * mul);
    mx1 = fmaxf(m1, mx1 * mul);
    const float al0 = ex2(m0 - mx0), al1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P as bf16 hi and lo A fragments of P V: k-step kk covers n-tiles
    // 2kk, 2kk + 1 of S; registers 0, 2 hold row0, 1, 3 row0 + 8
    uint32_t ph[4][4], pl[4][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], mul, -mx0));
      const float p1 = ex2(fmaf(s[j][1], mul, -mx0));
      const float p2 = ex2(fmaf(s[j][2], mul, -mx1));
      const float p3 = ex2(fmaf(s[j][3], mul, -mx1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      const int r = (j & 1) * 2;
      split_bf16(p0, p1, ph[j >> 1][r], pl[j >> 1][r]);
      split_bf16(p2, p3, ph[j >> 1][r + 1], pl[j >> 1][r + 1]);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    // rescale O unless no row of the warp moved its max (alpha == 1)
    if (!__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
      for (int j = 0; j < 2 * NV; ++j) {
        oacc[j][0] *= al0;
        oacc[j][1] *= al0;
        oacc[j][2] *= al1;
        oacc[j][3] *= al1;
      }
    }

    // O += P V: V through ldmatrix.trans; lane l addresses key
    // 8 ((l / 8) & 1) + l % 8 and column 8 (l / 16) of a 16 x 16 block
    const uint32_t vb = vs_a + 2u * (stage * BK * LDV +
                                     ((lane & 7) + 8 * ((lane >> 3) & 1)) *
                                         LDV + 8 * (lane >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nn = 0; nn < NV; ++nn) {
        if (!EXACT && 16 * nn >= a.dv) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(vb + 2u * (16 * kk * LDV + 16 * nn), b0, b1, b2, b3);
        mma16816(oacc[2 * nn], ph[kk], b0, b1);
        mma16816(oacc[2 * nn + 1], ph[kk], b2, b3);
        mma16816(oacc[2 * nn], pl[kk], b0, b1);
        mma16816(oacc[2 * nn + 1], pl[kk], b2, b3);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row0 + 8 * half;
    if (qpos >= a.S) continue;
    const float inv = half ? inv1 : inv0;
    if (lse != nullptr && tq == 0)   // m is in log2 units of the scores
      lse[((long long)bi * a.H + h) * a.S + qpos] =
          ((half ? m1 : m0) + log2f(fmaxf(half ? l1 : l0, 1e-30f))) *
          0.6931471805599453f;
    bf16* orow = o + (((long long)bi * a.S + qpos) * a.H + h) * a.dv;
#pragma unroll
    for (int j = 0; j < 2 * NV; ++j) {
      const int col = 8 * j + 2 * tq;
      if (!EXACT && col >= a.dv) continue;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          oacc[j][2 * half] * inv, oacc[j][2 * half + 1] * inv);
    }
  }
}

template <int NK, int NV, bool EXACT>
int launch_body(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, const Args& a, void* stream) {
  const size_t smem = 2 * ((size_t)BQ * (16 * NK + 8) +
                           (size_t)STAGES * BK * (16 * NK + 8) +
                           (size_t)STAGES * BK * (16 * NV + 8));
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto* kern = flash_fwd_tc_kernel<NK, NV, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      a);
  return (int)cudaGetLastError();
}

// The body is the caller's choice (kernel.py:fa_body, the one rule; its
// index in kernel.py:BODIES): 1, the exact one, d = dv = 80 only; 2,
// guarded, 8 k-steps; 3, guarded, 12 k-steps.  Each checks only the
// widths it can hold: d and dv multiples of 8, dv <= 128, d <= 16 * NK.
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, const Args& a, int body, void* stream) {
  if (a.d % 8 || a.dv % 8 || a.dv > 128 || a.d <= 0 || a.dv <= 0)
    return (int)cudaErrorInvalidValue;
  if (body == 1 && a.d == 80 && a.dv == 80)
    return launch_body<5, 5, true>(q, k, v, o, lse, B, a, stream);
  if (body == 2 && a.d <= 128)
    return launch_body<8, 8, false>(q, k, v, o, lse, B, a, stream);
  if (body == 3 && a.d <= 192)
    return launch_body<12, 8, false>(q, k, v, o, lse, B, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fa_tc

#define FLASH_FWD_ARGS                                                        \
  const void *q, const void *k, const void *v, void *o, int B, int S, int T_, \
      int H, int Hkv, int d, int dv, int causal, int window, float scale,     \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,         \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,         \
      long long v_sh, void *stream, int body, void *lse

// body: the index in kernel.py:BODIES; 0, the CUDA-core body, is f32's one.
// lse: null (serving), or an f32 (B, H, S) buffer for each row's
// log-sum-exp of its scaled, masked scores (natural log), which the
// backward kernels (flash_attention_bwd.cu) read.
extern "C" int flash_attention_fwd_f32(FLASH_FWD_ARGS) {
  if (body != 0) return (int)cudaErrorInvalidValue;
  fa::Args a{S,    T_,   H,    Hkv,  d,    dv,   0,    causal, window,
             scale, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss, v_sh};
  return fa::launch(q, k, v, o, lse, B, a, stream);
}

extern "C" int flash_attention_fwd_bf16(FLASH_FWD_ARGS) {
  fa_tc::Args a{S,    T_,   H,    Hkv,  d,    dv,   causal, window, scale,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh};
  return fa_tc::launch(q, k, v, o, lse, B, a, body, stream);
}
