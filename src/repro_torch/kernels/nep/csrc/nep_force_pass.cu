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
// Design: one thread per atom; its own 182 adjoints are held in a
// per-thread array, neighbor rows are read through the read-only path; the
// carrier coefficients sit in shared memory and are indexed c[ti][tj] and
// c[tj][ti] for the two halves.  Per pair the kernel forms the basis and
// its r-derivative once, the per-k coefficient sum of both halves
// (dt/df_k), and the gradient P = dt/d(rhat) at fixed basis; then
// dt/d(dr) = rhat * sum_k f'_k coef_k + (P - rhat (rhat.P)) / r.  Masked
// slots (self-padded, dr = 0) and pairs at or beyond the cutoff are skipped.
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
                  T* __restrict__ h_out, int n, int m, Spec sp) {
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
                      int n, int m, Spec sp, void* stream) {
  const size_t smem = (size_t)sp.n_types * sp.n_types *
                      (sp.n_rad + sp.n_ang + (sp.spin ? sp.n_spin : 0)) *
                      sp.K * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      force_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + BLOCK - 1) / BLOCK;
  force_pass_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)idx, (const int*)ti,
      (const int*)tj, (const T*)si, (const T*)sj, (const T*)c_rad,
      (const T*)c_ang, (const T*)c_spin, (const T*)abar, (T*)f, (T*)h, n, m,
      sp);
  return (int)cudaGetLastError();
}

}  // namespace nep

#define NEP_FORCE_PASS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* dr, const void* mask, const void* idx,      \
                      const void* ti, const void* tj, const void* si,         \
                      const void* sj, const void* c_rad, const void* c_ang,   \
                      const void* c_spin, const void* abar, void* f, void* h, \
                      int n, int m, int n_types, int K, int n_rad, int n_ang, \
                      int l_max, int n_spin, int n_onsite, int hidden,        \
                      int spin, double cutoff, void* stream) {                \
    nep::Spec sp{n_types, K, n_rad, n_ang, l_max, n_spin, n_onsite, hidden,   \
                 spin, cutoff};                                               \
    return nep::launch_force_pass<T>(dr, mask, idx, ti, tj, si, sj, c_rad,    \
                                     c_ang, c_spin, abar, f, h, n, m, sp,     \
                                     stream);                                 \
  }

NEP_FORCE_PASS_ENTRY(nep_force_pass_f32, float)
NEP_FORCE_PASS_ENTRY(nep_force_pass_f64, double)
