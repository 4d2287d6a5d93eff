// K2: NEP-SPIN force pass - one traversal of the pairs evaluating both
// orientations of t = <Abar_i, a(dr, S_i, S_j)> + <Abar_j, a(-dr, S_j, S_i)>
// on a shared basis, returning F_i = sum_j dt/d(dr_ij) (pair-symmetric, no
// reverse scatter) and the second-pass field -dt/dS_i.
//
// Replaces the Pallas kernel src/repro/kernels/nep/kernel.py:nep_force_pass
// (body force_tile, _pair_contract, _radial_g_both; pallas_call at
// kernel.py:425), which takes jax.grad of the pair contraction and reads a
// pre-gathered (N, M, 182) copy of the neighbor adjoints.  Here the
// derivatives are written by hand (ref.py:force_pass_closed is the same math
// in plain torch) and the kernel reads each neighbor's adjoint row itself
// through the table index, so the 12 GB gathered block of the reference
// layout (262,144 atoms, f32) is never built.
//
// What bounds it on the H100 (production spec, 262,144 atoms, M = 64, f32):
// the data it must move once is dr (201 MB), sj (201 MB), idx and tj
// (67 MB each), mask (17 MB), the adjoints (191 MB) and two (N, 3) outputs:
// ~0.75 GB, ~0.23 ms at 3.35 TB/s.  Its arithmetic is ~3,000 flops per
// pair inside the cutoff (~43 per atom), ~34 GFLOP, ~0.50 ms at
// 67 TFLOP/s: bound by operations (chip_smoke.py counts both from each
// run's pairs).  Besides, the neighbor adjoint rows (728 B each) are
// re-read from L2 for every pair that names them: ~8 GB of L2 traffic.
//
// Per pair both bodies form the basis and its r-derivative once, the per-k
// coefficient sum of both halves (dt/df_k), and the gradient P = dt/d(rhat)
// at fixed basis; then dt/d(dr) = rhat * sum_k f'_k coef_k
// + (P - rhat (rhat.P)) / r.  Masked slots (self-padded, dr = 0) and pairs
// at or beyond the cutoff add nothing.  Two bodies:
//
// * force_pass_warp_kernel (nep_force_pass_warp_*): one warp per atom,
//   templated on the spec's sizes (nep_common.cuh: Sizes, the list K1's
//   warp body reads; K2 matches a spec on types, K, n_rad, n_ang, l_max
//   and n_spin), so every loop over them unrolls and the per-pair state
//   (basis, its derivative, coef, monomials and their B sums, the carriers'
//   g sums)
//   lives in registers, with the monomial exponents as immediates.
//   Instantiated for the production spec (configs/fege_spinlattice.py:
//   config()) and the smoke spec (smoke_config()), whose carriers the
//   md_loop scenario's spec shares; kernel.py:
//   force_pass_body picks it.  The lanes read the atom's M slots
//   side by side (coalesced), and a ballot over mask & (r < rc) packs the
//   live slots into a list, so lanes take live pairs in turn and no lane
//   idles on a dead slot before the last round.  For each round of up to
//   32 pairs the warp copies the 32 neighbor adjoint rows into shared
//   memory, one row at a time with 32 lanes on consecutive words (a lane
//   reading its own 728-byte row would touch 32 cache lines per load
//   instruction); each lane then reads its row there, at an odd row
//   stride, so no two lanes share a bank.  The atom's own row sits in
//   shared memory and is read as broadcasts.  F_i and h2_i are summed
//   across the warp with shuffles and written by lane 0: no atomics, the
//   same result every run.
// * force_pass_kernel (nep_force_pass_*, the first body): one thread per atom
//   with run-time loop bounds, so its per-pair arrays sit in local memory.
//   It serves every other spec within the bounds of nep_common.cuh.
//
// Replica axis: one launch serves nr replicas.  dr, si, sj, the adjoints
// and both outputs carry a leading replica axis.  The table (mask, tj, idx
// (n, m), ti (n,)) is shared by every replica (the Replicated plan:
// tab_stride 0) or is one per replica (the Sharded plan's replicas:
// tab_stride n).  Each replica's adjoints are n_src >= n rows (n_src > n on
// the Sharded plan: the owned slots, then the halo ring).  The grid's y axis
// is the replica: a block moves those pointers to its replica's rows - the
// table's by tab_stride rows, the adjoints' by n_src (so a neighbor's
// adjoint row is replica r's, at r * n_src + idx) - and runs the flat body
// unchanged, so replica r of a batched launch is bitwise a launch on
// replica r's inputs alone.  The warp body's
// flat instantiation (BATCH false, launched for nr = 1) leaves the move
// out, as K1's does.
#include "nep_common.cuh"

namespace nep {

template <typename T>
__global__ void __launch_bounds__(BLOCK)
force_pass_kernel(const T* __restrict__ dr, const bool* __restrict__ mask,
                  const int* __restrict__ idx, const int* __restrict__ ti,
                  const int* __restrict__ tj, const T* __restrict__ si,
                  const T* __restrict__ sj, const T* __restrict__ c_rad,
                  const T* __restrict__ c_ang, const T* __restrict__ c_spin,
                  const T* __restrict__ abar, T* __restrict__ f_out,
                  T* __restrict__ h_out, int n, int m, int tab_stride,
                  int n_src, Spec sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nt = sp.n_types, K = sp.K;
  const int nmono = n_mono(sp.l_max);
  const int A = sp.n_rad + sp.n_ang * nmono + (sp.spin ? 9 * sp.n_spin : 0);
  T* s_crad = sm;
  T* s_cang = s_crad + nt * nt * sp.n_rad * K;
  T* s_cspin = s_cang + nt * nt * sp.n_ang * K;
  stage(s_crad, c_rad, nt * nt * sp.n_rad * K);
  stage(s_cang, c_ang, nt * nt * sp.n_ang * K);
  if (sp.spin) stage(s_cspin, c_spin, nt * nt * sp.n_spin * K);
  __syncthreads();

  // replica blockIdx.y: its blocks, adjoints and outputs, and its table
  // unless the table is shared (tab_stride 0)
  const size_t rep = blockIdx.y;
  mask += rep * tab_stride * m;
  idx += rep * tab_stride * m;
  tj += rep * tab_stride * m;
  ti += rep * tab_stride;
  dr += rep * n * m * 3;
  si += rep * n * 3;
  sj += rep * n * m * 3;
  abar += rep * n_src * A;
  f_out += rep * n * 3;
  h_out += rep * n * 3;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const T rc = T(sp.cutoff);
  const int ta = ti[i];
  const T s0 = si[3 * i], s1 = si[3 * i + 1], s2 = si[3 * i + 2];
  T ai[MAX_ACC];
  for (int c = 0; c < A; ++c) ai[c] = abar[(size_t)i * A + c];
  const int o_ang = sp.n_rad;
  const int o_dot = o_ang + sp.n_ang * nmono;
  const int ns = sp.n_spin;

  T fx = T(0), fy = T(0), fz = T(0);      // sum_m dt/d(dr_im)
  T gx = T(0), gy = T(0), gz = T(0);      // sum_m dt/dS_i

  for (int s = 0; s < m; ++s) {
    const size_t pm = (size_t)i * m + s;
    if (!mask[pm]) continue;
    const T dx = dr[3 * pm], dy = dr[3 * pm + 1], dz = dr[3 * pm + 2];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz + dist_eps<T>());
    if (r >= rc) continue;
    const T inv = T(1) / r;
    const T rx = dx * inv, ry = dy * inv, rz = dz * inv;
    const int tb = tj[pm];
    const T* aj = abar + (size_t)idx[pm] * A;

    T f[MAX_K], df[MAX_K], coef[MAX_K];
    chebyshev<T>(r, rc, K, f, df);
    for (int k = 0; k < K; ++k) coef[k] = T(0);

    // radial: both halves' carriers contract against Abar.rad
    const T* c1 = s_crad + (ta * nt + tb) * sp.n_rad * K;
    const T* c2 = s_crad + (tb * nt + ta) * sp.n_rad * K;
    for (int a = 0; a < sp.n_rad; ++a) {
      const T Ai = ai[a], Aj = __ldg(aj + a);
      for (int k = 0; k < K; ++k)
        coef[k] += c1[a * K + k] * Ai + c2[a * K + k] * Aj;
    }

    // angular: Y = sum_pc mono_pc Abar.ang, the j-half with (-1)^p;
    // B_pc = sum_a g1_a Ai + (-1)^p g2_a Aj feeds P = sum_pc B_pc grad mono
    T px[MAX_L + 1], py[MAX_L + 1], pz[MAX_L + 1];
    powers(rx, px); powers(ry, py); powers(rz, pz);
    T mono[N_MONO], bvec[N_MONO];
    for (int g = 0; g < nmono; ++g) {
      mono[g] = px[MONO_E[g][0]] * py[MONO_E[g][1]] * pz[MONO_E[g][2]];
      bvec[g] = T(0);
    }
    c1 = s_cang + (ta * nt + tb) * sp.n_ang * K;
    c2 = s_cang + (tb * nt + ta) * sp.n_ang * K;
    for (int a = 0; a < sp.n_ang; ++a) {
      T g1 = T(0), g2 = T(0);
      for (int k = 0; k < K; ++k) {
        g1 += c1[a * K + k] * f[k];
        g2 += c2[a * K + k] * f[k];
      }
      T yi = T(0), yj = T(0);
      for (int p = 0; p <= sp.l_max; ++p) {
        const T sgn = (p & 1) ? T(-1) : T(1);
        const int c0 = MONO_START[p], cp = MONO_START[p + 1] - c0;
        const int base = o_ang + sp.n_ang * c0 + a * cp;
        for (int c = 0; c < cp; ++c) {
          const T Ai = ai[base + c], Aj = sgn * __ldg(aj + base + c);
          yi += mono[c0 + c] * Ai;
          yj += mono[c0 + c] * Aj;
          bvec[c0 + c] += g1 * Ai + g2 * Aj;
        }
      }
      for (int k = 0; k < K; ++k)
        coef[k] += c1[a * K + k] * yi + c2[a * K + k] * yj;
    }
    T Px = T(0), Py = T(0), Pz = T(0);
    for (int g = 1; g < nmono; ++g) {
      const int ex = MONO_E[g][0], ey = MONO_E[g][1], ez = MONO_E[g][2];
      const T b = bvec[g];
      if (ex) Px += b * T(ex) * px[ex - 1] * py[ey] * pz[ez];
      if (ey) Py += b * T(ey) * px[ex] * py[ey - 1] * pz[ez];
      if (ez) Pz += b * T(ez) * px[ex] * py[ey] * pz[ez - 1];
    }

    if (sp.spin) {
      const T j0 = sj[3 * pm], j1 = sj[3 * pm + 1], j2 = sj[3 * pm + 2];
      const T dot = s0 * j0 + s1 * j1 + s2 * j2;
      const T cx = s1 * j2 - s2 * j1, cy = s2 * j0 - s0 * j2,
              cz = s0 * j1 - s1 * j0;
      const T dmi = cx * rx + cy * ry + cz * rz;
      const T sir = s0 * rx + s1 * ry + s2 * rz;
      const T sjr = j0 * rx + j1 * ry + j2 * rz;
      const T pd = sir * sjr;
      T S_dot = T(0), S_dmi = T(0), S_pd = T(0);
      T Wx = T(0), Wy = T(0), Wz = T(0), Vx = T(0), Vy = T(0), Vz = T(0);
      c1 = s_cspin + (ta * nt + tb) * ns * K;
      c2 = s_cspin + (tb * nt + ta) * ns * K;
      const int o_v = o_dot + 3 * ns, o_w = o_v + 3 * ns;
      for (int a = 0; a < ns; ++a) {
        T g1 = T(0), g2 = T(0);
        for (int k = 0; k < K; ++k) {
          g1 += c1[a * K + k] * f[k];
          g2 += c2[a * K + k] * f[k];
        }
        const T id = ai[o_dot + a], im = ai[o_dot + ns + a],
                ip = ai[o_dot + 2 * ns + a];
        const T jd = __ldg(aj + o_dot + a), jm = __ldg(aj + o_dot + ns + a),
                jp = __ldg(aj + o_dot + 2 * ns + a);
        const T iv0 = ai[o_v + 3 * a], iv1 = ai[o_v + 3 * a + 1],
                iv2 = ai[o_v + 3 * a + 2];
        const T iw0 = ai[o_w + 3 * a], iw1 = ai[o_w + 3 * a + 1],
                iw2 = ai[o_w + 3 * a + 2];
        const T jv0 = __ldg(aj + o_v + 3 * a), jv1 = __ldg(aj + o_v + 3 * a + 1),
                jv2 = __ldg(aj + o_v + 3 * a + 2);
        const T jw0 = __ldg(aj + o_w + 3 * a), jw1 = __ldg(aj + o_w + 3 * a + 1),
                jw2 = __ldg(aj + o_w + 3 * a + 2);
        // i-half sees S_j as the neighbor spin and +rhat; the j-half sees
        // S_i as the neighbor spin and -rhat (sp_w flips sign)
        const T zi = dot * id + dmi * im + pd * ip +
                     (j0 * iv0 + j1 * iv1 + j2 * iv2) +
                     (rx * iw0 + ry * iw1 + rz * iw2);
        const T zj = dot * jd + dmi * jm + pd * jp +
                     (s0 * jv0 + s1 * jv1 + s2 * jv2) -
                     (rx * jw0 + ry * jw1 + rz * jw2);
        for (int k = 0; k < K; ++k)
          coef[k] += c1[a * K + k] * zi + c2[a * K + k] * zj;
        S_dot += g1 * id + g2 * jd;
        S_dmi += g1 * im + g2 * jm;
        S_pd += g1 * ip + g2 * jp;
        Wx += g1 * iw0 - g2 * jw0;
        Wy += g1 * iw1 - g2 * jw1;
        Wz += g1 * iw2 - g2 * jw2;
        Vx += g2 * jv0; Vy += g2 * jv1; Vz += g2 * jv2;
      }
      // dt/d(rhat): DMI (S_i x S_j), pseudo-dipolar, and the W carriers
      Px += S_dmi * cx + S_pd * (s0 * sjr + j0 * sir) + Wx;
      Py += S_dmi * cy + S_pd * (s1 * sjr + j1 * sir) + Wy;
      Pz += S_dmi * cz + S_pd * (s2 * sjr + j2 * sir) + Wz;
      // dt/dS_i: Heisenberg S_j, DMI S_j x rhat, pseudo-dipolar, V of j
      gx += S_dot * j0 + S_dmi * (j1 * rz - j2 * ry) + S_pd * sjr * rx + Vx;
      gy += S_dot * j1 + S_dmi * (j2 * rx - j0 * rz) + S_pd * sjr * ry + Vy;
      gz += S_dot * j2 + S_dmi * (j0 * ry - j1 * rx) + S_pd * sjr * rz + Vz;
    }

    T dtdr = T(0);
    for (int k = 0; k < K; ++k) dtdr += df[k] * coef[k];
    const T rp = rx * Px + ry * Py + rz * Pz;
    fx += rx * dtdr + (Px - rx * rp) * inv;
    fy += ry * dtdr + (Py - ry * rp) * inv;
    fz += rz * dtdr + (Pz - rz * rp) * inv;
  }
  f_out[3 * i] = fx;
  f_out[3 * i + 1] = fy;
  f_out[3 * i + 2] = fz;
  h_out[3 * i] = -gx;
  h_out[3 * i + 1] = -gy;
  h_out[3 * i + 2] = -gz;
}

template <typename T>
int launch_force_pass(const void* dr, const void* mask, const void* idx,
                      const void* ti, const void* tj, const void* si,
                      const void* sj, const void* c_rad, const void* c_ang,
                      const void* c_spin, const void* abar, void* f, void* h,
                      int n, int m, int nr, int tab_stride, int n_src,
                      Spec sp, void* stream) {
  const size_t smem = (size_t)sp.n_types * sp.n_types *
                      (sp.n_rad + sp.n_ang + (sp.spin ? sp.n_spin : 0)) *
                      sp.K * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      force_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, nr);
  force_pass_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)idx, (const int*)ti,
      (const int*)tj, (const T*)si, (const T*)sj, (const T*)c_rad,
      (const T*)c_ang, (const T*)c_spin, (const T*)abar, (T*)f, (T*)h, n, m,
      tab_stride, n_src, sp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One warp per atom, templated on the spec
// ---------------------------------------------------------------------------
constexpr int WARPS = 4;           // atoms in flight per block
constexpr int WGRID_MAX = 8192;    // blocks; warps stride over the atoms

// g[a] = sum_k c[a][k] f[k] for both halves' carriers of n channels
template <typename T, int N, int K>
__device__ __forceinline__ void carrier_sums(const T* c1, const T* c2,
                                             const T (&f)[K], T (&g1)[N],
                                             T (&g2)[N]) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    T r1[K], r2[K];
    load_row<T, K>(c1 + a * K, r1);
    load_row<T, K>(c2 + a * K, r2);
    T s1 = T(0), s2 = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s1 += r1[k] * f[k];
      s2 += r2[k] * f[k];
    }
    g1[a] = s1;
    g2[a] = s2;
  }
}

// coef[k] += sum_a c1[a][k] x1[a] + c2[a][k] x2[a]
template <typename T, int N, int K>
__device__ __forceinline__ void add_coef(const T* c1, const T* c2,
                                         const T (&x1)[N], const T (&x2)[N],
                                         T (&coef)[K]) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    T r1[K], r2[K];
    load_row<T, K>(c1 + a * K, r1);
    load_row<T, K>(c2 + a * K, r2);
#pragma unroll
    for (int k = 0; k < K; ++k) coef[k] += r1[k] * x1[a] + r2[k] * x2[a];
  }
}

// Angular degree P: Y_a += sum_c mono_c A_a,c for both halves (the j-half
// with (-1)^P), and P_vec += sum_c B_c grad mono_c with
// B_c = sum_a g1_a Ai_a,c + (-1)^P g2_a Aj_a,c.  Recurses to degree L.
template <int P, typename S, typename T>
__device__ __forceinline__ void angular(
    const T* ai, const T* aj, const T (&px)[MAX_L + 1],
    const T (&py)[MAX_L + 1], const T (&pz)[MAX_L + 1],
    const T (&g1)[S::NA], const T (&g2)[S::NA], T (&yi)[S::NA],
    T (&yj)[S::NA], T& Px, T& Py, T& Pz) {
  constexpr int C = (P + 1) * (P + 2) / 2;
  constexpr int G0 = n_mono(P - 1);                // first monomial of P
  constexpr int BASE = S::NR + S::NA * G0;
  const T sgn = (P & 1) ? T(-1) : T(1);
  T mono[C], bv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mono[c] = px[mono_exp(G0 + c, 0)] * py[mono_exp(G0 + c, 1)] *
              pz[mono_exp(G0 + c, 2)];
    bv[c] = T(0);
  }
#pragma unroll
  for (int a = 0; a < S::NA; ++a) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T Ai = ai[BASE + a * C + c], Aj = sgn * aj[BASE + a * C + c];
      yi[a] += mono[c] * Ai;
      yj[a] += mono[c] * Aj;
      bv[c] += g1[a] * Ai + g2[a] * Aj;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ex = mono_exp(G0 + c, 0), ey = mono_exp(G0 + c, 1),
              ez = mono_exp(G0 + c, 2);
    if (ex) Px += bv[c] * T(ex) * px[ex - 1] * py[ey] * pz[ez];
    if (ey) Py += bv[c] * T(ey) * px[ex] * py[ey - 1] * pz[ez];
    if (ez) Pz += bv[c] * T(ez) * px[ex] * py[ey] * pz[ez - 1];
  }
  if constexpr (P < S::L)
    angular<P + 1, S>(ai, aj, px, py, pz, g1, g2, yi, yj, Px, Py, Pz);
}

// One pair's contribution to F_i (fx, fy, fz) and dt/dS_i (gx, gy, gz).
// ai, aj: the two adjoint rows in shared memory; sc: the carriers in shared
// memory; s0..s2 and j0..j2: S_i and S_j.
template <typename S, typename T>
__device__ __forceinline__ void warp_pair(T dx, T dy, T dz, T rc, int ta,
                                          int tb, const T* sc, const T* ai,
                                          const T* aj, T s0, T s1, T s2,
                                          T j0, T j1, T j2, T& fx, T& fy,
                                          T& fz, T& gx, T& gy, T& gz) {
  constexpr int K = S::K, NT = S::NT;
  const T r = dsqrt(dx * dx + dy * dy + dz * dz + dist_eps<T>());
  const T inv = T(1) / r;
  const T rx = dx * inv, ry = dy * inv, rz = dz * inv;
  const int p1 = ta * NT + tb, p2 = tb * NT + ta;   // c[ti][tj], c[tj][ti]
  T fk[K], dfk[K], coef[K];
  chebyshev<T, true>(r, rc, K, fk, dfk);

  // radial: both halves' carriers contract against Abar.rad
  T ri[S::NR], rj[S::NR];
#pragma unroll
  for (int a = 0; a < S::NR; ++a) {
    ri[a] = ai[a];
    rj[a] = aj[a];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) coef[k] = T(0);
  add_coef<T, S::NR, K>(sc + p1 * S::NR * K, sc + p2 * S::NR * K, ri, rj,
                        coef);

  // angular
  T px[MAX_L + 1], py[MAX_L + 1], pz[MAX_L + 1];
  powers(rx, px);
  powers(ry, py);
  powers(rz, pz);
  const T* ca1 = sc + S::C_ANG + p1 * S::NA * K;
  const T* ca2 = sc + S::C_ANG + p2 * S::NA * K;
  T g1[S::NA], g2[S::NA], yi[S::NA], yj[S::NA];
  carrier_sums<T, S::NA, K>(ca1, ca2, fk, g1, g2);
#pragma unroll
  for (int a = 0; a < S::NA; ++a) yi[a] = yj[a] = T(0);
  T Px = T(0), Py = T(0), Pz = T(0);
  angular<0, S>(ai, aj, px, py, pz, g1, g2, yi, yj, Px, Py, Pz);
  add_coef<T, S::NA, K>(ca1, ca2, yi, yj, coef);

  if constexpr (S::NS > 0) {
    constexpr int NS = S::NS, OD = S::O_DOT, OV = OD + 3 * NS,
                  OW = OV + 3 * NS;
    const T dot = s0 * j0 + s1 * j1 + s2 * j2;
    const T cx = s1 * j2 - s2 * j1, cy = s2 * j0 - s0 * j2,
            cz = s0 * j1 - s1 * j0;
    const T dmi = cx * rx + cy * ry + cz * rz;
    const T sir = s0 * rx + s1 * ry + s2 * rz;
    const T sjr = j0 * rx + j1 * ry + j2 * rz;
    const T pd = sir * sjr;
    const T* cs1 = sc + S::C_SPIN + p1 * NS * K;
    const T* cs2 = sc + S::C_SPIN + p2 * NS * K;
    T h1[NS], h2[NS], zi[NS], zj[NS];
    carrier_sums<T, NS, K>(cs1, cs2, fk, h1, h2);
    T S_dot = T(0), S_dmi = T(0), S_pd = T(0);
    T Wx = T(0), Wy = T(0), Wz = T(0), Vx = T(0), Vy = T(0), Vz = T(0);
#pragma unroll
    for (int a = 0; a < NS; ++a) {
      const T id = ai[OD + a], im = ai[OD + NS + a], ip = ai[OD + 2 * NS + a];
      const T jd = aj[OD + a], jm = aj[OD + NS + a], jp = aj[OD + 2 * NS + a];
      const T iv0 = ai[OV + 3 * a], iv1 = ai[OV + 3 * a + 1],
              iv2 = ai[OV + 3 * a + 2];
      const T iw0 = ai[OW + 3 * a], iw1 = ai[OW + 3 * a + 1],
              iw2 = ai[OW + 3 * a + 2];
      const T jv0 = aj[OV + 3 * a], jv1 = aj[OV + 3 * a + 1],
              jv2 = aj[OV + 3 * a + 2];
      const T jw0 = aj[OW + 3 * a], jw1 = aj[OW + 3 * a + 1],
              jw2 = aj[OW + 3 * a + 2];
      // i-half sees S_j as the neighbor spin and +rhat; the j-half sees
      // S_i as the neighbor spin and -rhat (sp_w flips sign)
      zi[a] = dot * id + dmi * im + pd * ip +
              (j0 * iv0 + j1 * iv1 + j2 * iv2) +
              (rx * iw0 + ry * iw1 + rz * iw2);
      zj[a] = dot * jd + dmi * jm + pd * jp +
              (s0 * jv0 + s1 * jv1 + s2 * jv2) -
              (rx * jw0 + ry * jw1 + rz * jw2);
      S_dot += h1[a] * id + h2[a] * jd;
      S_dmi += h1[a] * im + h2[a] * jm;
      S_pd += h1[a] * ip + h2[a] * jp;
      Wx += h1[a] * iw0 - h2[a] * jw0;
      Wy += h1[a] * iw1 - h2[a] * jw1;
      Wz += h1[a] * iw2 - h2[a] * jw2;
      Vx += h2[a] * jv0; Vy += h2[a] * jv1; Vz += h2[a] * jv2;
    }
    add_coef<T, NS, K>(cs1, cs2, zi, zj, coef);
    // dt/d(rhat): DMI (S_i x S_j), pseudo-dipolar, and the W carriers
    Px += S_dmi * cx + S_pd * (s0 * sjr + j0 * sir) + Wx;
    Py += S_dmi * cy + S_pd * (s1 * sjr + j1 * sir) + Wy;
    Pz += S_dmi * cz + S_pd * (s2 * sjr + j2 * sir) + Wz;
    // dt/dS_i: Heisenberg S_j, DMI S_j x rhat, pseudo-dipolar, V of j
    gx += S_dot * j0 + S_dmi * (j1 * rz - j2 * ry) + S_pd * sjr * rx + Vx;
    gy += S_dot * j1 + S_dmi * (j2 * rx - j0 * rz) + S_pd * sjr * ry + Vy;
    gz += S_dot * j2 + S_dmi * (j0 * ry - j1 * rx) + S_pd * sjr * rz + Vz;
  }

  T dtdr = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) dtdr += dfk[k] * coef[k];
  const T rp = rx * Px + ry * Py + rz * Pz;
  fx += rx * dtdr + (Px - rx * rp) * inv;
  fy += ry * dtdr + (Py - ry * rp) * inv;
  fz += rz * dtdr + (Pz - rz * rp) * inv;
}

template <typename S, typename T, bool BATCH>
__global__ void __launch_bounds__(32 * WARPS)
force_pass_warp_kernel(const T* __restrict__ dr, const bool* __restrict__ mask,
                       const int* __restrict__ idx, const int* __restrict__ ti,
                       const int* __restrict__ tj, const T* __restrict__ si,
                       const T* __restrict__ sj, const T* __restrict__ c_rad,
                       const T* __restrict__ c_ang,
                       const T* __restrict__ c_spin,
                       const T* __restrict__ abar, T* __restrict__ f_out,
                       T* __restrict__ h_out, int n, int m,
                       int tab_stride, int n_src, T rc) {
  constexpr int A = S::A, LDA = S::LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);             // carriers
  T* s_own = sc + (S::NC + 3) / 4 * 4;                // WARPS x A
  T* s_nb = s_own + WARPS * A;                        // WARPS x 32 x LDA
  int* s_list = reinterpret_cast<int*>(s_nb + WARPS * 32 * LDA);  // WARPS x m
  constexpr int NRK = S::NT * S::NT * S::NR * S::K;
  constexpr int NAK = S::NT * S::NT * S::NA * S::K;
  stage(sc, c_rad, NRK);
  stage(sc + S::C_ANG, c_ang, NAK);
  if constexpr (S::NS > 0)
    stage(sc + S::C_SPIN, c_spin, S::NT * S::NT * S::NS * S::K);
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* own = s_own + warp * A;
  T* nbs = s_nb + warp * 32 * LDA;
  int* list = s_list + warp * m;
  // a batch's replica blockIdx.y: its blocks, adjoints and outputs, and
  // its table unless the table is shared (tab_stride 0); a flat launch
  // (BATCH false) runs the body as it was
  if constexpr (BATCH) {
    const size_t rep = blockIdx.y;
    mask += rep * tab_stride * m;
    idx += rep * tab_stride * m;
    tj += rep * tab_stride * m;
    ti += rep * tab_stride;
    dr += rep * n * m * 3;
    si += rep * n * 3;
    sj += rep * n * m * 3;
    abar += rep * n_src * A;
    f_out += rep * n * 3;
    h_out += rep * n * 3;
  }
  for (int i = blockIdx.x * WARPS + warp; i < n; i += gridDim.x * WARPS) {
#pragma unroll
    for (int c0 = 0; c0 < A; c0 += 32)
      if (c0 + lane < A) own[c0 + lane] = abar[(size_t)i * A + c0 + lane];
    // live slots, in slot order
    int live = 0;
    for (int s0 = 0; s0 < m; s0 += 32) {
      const int s = s0 + lane;
      bool ok = false;
      if (s < m) {
        const size_t pm = (size_t)i * m + s;
        if (mask[pm]) {
          const T dx = dr[3 * pm], dy = dr[3 * pm + 1], dz = dr[3 * pm + 2];
          ok = dsqrt(dx * dx + dy * dy + dz * dz + dist_eps<T>()) < rc;
        }
      }
      const unsigned b = __ballot_sync(full, ok);
      if (ok) list[live + __popc(b & ((1u << lane) - 1u))] = s;
      live += __popc(b);
    }
    __syncwarp();

    const int ta = ti[i];
    const T s0 = si[3 * i], s1 = si[3 * i + 1], s2 = si[3 * i + 2];
    T fx = T(0), fy = T(0), fz = T(0), gx = T(0), gy = T(0), gz = T(0);
    for (int t0 = 0; t0 < live; t0 += 32) {
      const int cnt = min(32, live - t0);
      const bool act = lane < cnt;
      const size_t pm = (size_t)i * m + (act ? list[t0 + lane] : 0);
      const int j = act ? idx[pm] : 0;
      // the round's neighbor rows, 32 lanes on consecutive words of a row
#pragma unroll 4
      for (int rr = 0; rr < cnt; ++rr) {
        const T* src = abar + (size_t)__shfl_sync(full, j, rr) * A;
#pragma unroll
        for (int c0 = 0; c0 < A; c0 += 32)
          if (c0 + lane < A) nbs[rr * LDA + c0 + lane] = __ldg(src + c0 + lane);
      }
      __syncwarp();
      if (act)
        warp_pair<S, T>(dr[3 * pm], dr[3 * pm + 1], dr[3 * pm + 2], rc, ta,
                        tj[pm], sc, own, nbs + lane * LDA, s0, s1, s2,
                        sj[3 * pm], sj[3 * pm + 1], sj[3 * pm + 2], fx, fy,
                        fz, gx, gy, gz);
      __syncwarp();
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      fx += __shfl_xor_sync(full, fx, off);
      fy += __shfl_xor_sync(full, fy, off);
      fz += __shfl_xor_sync(full, fz, off);
      gx += __shfl_xor_sync(full, gx, off);
      gy += __shfl_xor_sync(full, gy, off);
      gz += __shfl_xor_sync(full, gz, off);
    }
    if (lane == 0) {
      f_out[3 * i] = fx;
      f_out[3 * i + 1] = fy;
      f_out[3 * i + 2] = fz;
      h_out[3 * i] = -gx;
      h_out[3 * i + 1] = -gy;
      h_out[3 * i + 2] = -gz;
    }
    __syncwarp();
  }
}

template <typename S, typename T>
int launch_warp(const void* dr, const void* mask, const void* idx,
                const void* ti, const void* tj, const void* si,
                const void* sj, const void* c_rad, const void* c_ang,
                const void* c_spin, const void* abar, void* f, void* h,
                int n, int m, int nr, int tab_stride, int n_src,
                double cutoff, void* stream) {
  const size_t smem = sizeof(T) * ((S::NC + 3) / 4 * 4 + WARPS * S::A +
                                   WARPS * 32 * S::LDA) +
                      sizeof(int) * WARPS * m;
  auto* kern = nr > 1 ? force_pass_warp_kernel<S, T, true>
                      : force_pass_warp_kernel<S, T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // WGRID_MAX blocks in all, shared out over the replicas
  const dim3 grid(min((n + WARPS - 1) / WARPS, max(1, WGRID_MAX / nr)), nr);
  kern<<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)idx, (const int*)ti,
      (const int*)tj, (const T*)si, (const T*)sj, (const T*)c_rad,
      (const T*)c_ang, (const T*)c_spin, (const T*)abar, (T*)f, (T*)h, n, m,
      tab_stride, n_src, T(cutoff));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_force_pass_warp(const void* dr, const void* mask, const void* idx,
                           const void* ti, const void* tj, const void* si,
                           const void* sj, const void* c_rad,
                           const void* c_ang, const void* c_spin,
                           const void* abar, void* f, void* h, int n, int m,
                           int nr, int tab_stride, int n_src, Spec sp,
                           void* stream) {
  if (is<ProdSizes>(sp))
    return launch_warp<ProdSizes, T>(dr, mask, idx, ti, tj, si, sj, c_rad,
                                     c_ang, c_spin, abar, f, h, n, m, nr,
                                     tab_stride, n_src, sp.cutoff, stream);
  // the md_loop scenario's spec shares SmokeSizes' carriers: it runs here
  if (is<SmokeSizes>(sp))
    return launch_warp<SmokeSizes, T>(dr, mask, idx, ti, tj, si, sj, c_rad,
                                      c_ang, c_spin, abar, f, h, n, m, nr,
                                      tab_stride, n_src, sp.cutoff, stream);
  if (is<TrainSizes>(sp))
    return launch_warp<TrainSizes, T>(dr, mask, idx, ti, tj, si, sj, c_rad,
                                      c_ang, c_spin, abar, f, h, n, m, nr,
                                      tab_stride, n_src, sp.cutoff, stream);
  return (int)cudaErrorInvalidValue;   // no instantiation for this spec
}

}  // namespace nep

#define NEP_FORCE_PASS_ENTRY(NAME, T, LAUNCH)                                 \
  extern "C" int NAME(const void* dr, const void* mask, const void* idx,      \
                      const void* ti, const void* tj, const void* si,         \
                      const void* sj, const void* c_rad, const void* c_ang,   \
                      const void* c_spin, const void* abar, void* f, void* h, \
                      int n, int m, int nr, int tab_stride, int n_src,        \
                      int n_types, int K, int n_rad, int n_ang, int l_max,    \
                      int n_spin, int n_onsite, int hidden, int spin,         \
                      double cutoff, void* stream) {                          \
    nep::Spec sp{n_types, K, n_rad, n_ang, l_max, n_spin, n_onsite, hidden,   \
                 spin, cutoff};                                               \
    return nep::LAUNCH<T>(dr, mask, idx, ti, tj, si, sj, c_rad, c_ang,        \
                          c_spin, abar, f, h, n, m, nr, tab_stride, n_src,    \
                          sp, stream);                                        \
  }

NEP_FORCE_PASS_ENTRY(nep_force_pass_f32, float, launch_force_pass)
NEP_FORCE_PASS_ENTRY(nep_force_pass_f64, double, launch_force_pass)
NEP_FORCE_PASS_ENTRY(nep_force_pass_warp_f32, float, launch_force_pass_warp)
NEP_FORCE_PASS_ENTRY(nep_force_pass_warp_f64, double, launch_force_pass_warp)
