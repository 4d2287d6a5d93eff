// K1: NEP-SPIN atom pass - descriptor, per-type tanh MLP energy, and the
// adjoint accumulators Abar_i = dE_i/dA_i plus the direct field -dE_i/dS_i.
//
// Replaces the Pallas kernel src/repro/kernels/nep/kernel.py:nep_atom_pass
// (body atom_tile, pallas_call at kernel.py:233), which takes jax.vjp of
// finalize + mlp_energy inside the kernel.  Here that backward is derived by
// hand; repro_torch/kernels/nep/ref.py:atom_pass_closed is the same math in
// plain torch, held against autograd by the CPU tests.
//
// What bounds it on the H100 (production spec, 262,144 atoms, M = 64, f32):
// the data it must move is dr (201 MB), sj (201 MB), tj (67 MB), mask
// (17 MB) in and the packed adjoints (191 MB) out: ~0.69 GB, ~0.20 ms at
// 3.35 TB/s.  Its arithmetic, ~750 flops per pair inside the cutoff (~43
// per atom) plus ~7 kflop of finalize, MLP forward and backward per atom,
// is ~10 GFLOP, ~0.15 ms at 67 TFLOP/s.  So it is bound by bytes
// (chip_smoke.py counts both from each run's pairs).
//
// Design: one thread per atom walks its M neighbors and keeps the 182
// accumulators (at most MAX_ACC) in a per-thread array; the type dispatch
// is a direct index c[ti][tj] into the carrier coefficients, which sit in
// shared memory with the MLP weights (~15 KB f32, ~30 KB f64).  Masked
// slots and pairs at or beyond the cutoff (where every basis function and
// its derivative vanish) are skipped.  The per-thread accumulator array
// lives in local memory (runtime-indexed), so this first version pays L1/L2
// traffic for it; the ragged edge n % BLOCK is masked by the bounds check.
#include "nep_common.cuh"

namespace nep {

template <typename T>
__global__ void __launch_bounds__(BLOCK)
atom_pass_kernel(const T* __restrict__ dr, const bool* __restrict__ mask,
                 const int* __restrict__ ti, const int* __restrict__ tj,
                 const T* __restrict__ si, const T* __restrict__ sj,
                 const T* __restrict__ c_rad, const T* __restrict__ c_ang,
                 const T* __restrict__ c_spin, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, const T* __restrict__ q_scale,
                 T* __restrict__ e_out, T* __restrict__ hdir_out,
                 T* __restrict__ abar_out, int n, int m, Spec sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nt = sp.n_types, K = sp.K, H = sp.hidden;
  const int nmono = n_mono(sp.l_max);
  const int D = sp.n_rad + sp.n_ang * sp.l_max +
                (sp.spin ? sp.n_onsite + 6 * sp.n_spin : 0);
  const int A = sp.n_rad + sp.n_ang * nmono + (sp.spin ? 9 * sp.n_spin : 0);

  T* s_crad = sm;
  T* s_cang = s_crad + nt * nt * sp.n_rad * K;
  T* s_cspin = s_cang + nt * nt * sp.n_ang * K;
  T* s_w1 = s_cspin + (sp.spin ? nt * nt * sp.n_spin * K : 0);
  T* s_b1 = s_w1 + nt * D * H;
  T* s_w2 = s_b1 + nt * H;
  T* s_b2 = s_w2 + nt * H;
  T* s_qs = s_b2 + nt;
  stage(s_crad, c_rad, nt * nt * sp.n_rad * K);
  stage(s_cang, c_ang, nt * nt * sp.n_ang * K);
  if (sp.spin) stage(s_cspin, c_spin, nt * nt * sp.n_spin * K);
  stage(s_w1, w1, nt * D * H);
  stage(s_b1, b1, nt * H);
  stage(s_w2, w2, nt * H);
  stage(s_b2, b2, nt);
  stage(s_qs, q_scale, D);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const T rc = T(sp.cutoff);
  const int ta = ti[i];
  const T s0 = si[3 * i], s1 = si[3 * i + 1], s2 = si[3 * i + 2];

  T rad[MAX_CH], ang[MAX_CH][N_MONO];
  T sdot[MAX_CH], sdmi[MAX_CH], spd[MAX_CH], sv[MAX_CH][3], sw[MAX_CH][3];
  for (int a = 0; a < MAX_CH; ++a) {
    rad[a] = sdot[a] = sdmi[a] = spd[a] = T(0);
    for (int d = 0; d < 3; ++d) sv[a][d] = sw[a][d] = T(0);
    for (int g = 0; g < N_MONO; ++g) ang[a][g] = T(0);
  }

  for (int s = 0; s < m; ++s) {
    const size_t pm = (size_t)i * m + s;
    if (!mask[pm]) continue;
    const T dx = dr[3 * pm], dy = dr[3 * pm + 1], dz = dr[3 * pm + 2];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz + dist_eps<T>());
    if (r >= rc) continue;
    const T inv = T(1) / r;
    const T rx = dx * inv, ry = dy * inv, rz = dz * inv;
    const int tb = tj[pm];
    T f[MAX_K];
    chebyshev<T>(r, rc, K, f, nullptr);

    const T* cr = s_crad + (ta * nt + tb) * sp.n_rad * K;
    for (int a = 0; a < sp.n_rad; ++a) {
      T g = T(0);
      for (int k = 0; k < K; ++k) g += cr[a * K + k] * f[k];
      rad[a] += g;
    }

    T px[MAX_L + 1], py[MAX_L + 1], pz[MAX_L + 1], mono[N_MONO];
    powers(rx, px); powers(ry, py); powers(rz, pz);
    for (int g = 0; g < nmono; ++g)
      mono[g] = px[MONO_E[g][0]] * py[MONO_E[g][1]] * pz[MONO_E[g][2]];
    const T* ca = s_cang + (ta * nt + tb) * sp.n_ang * K;
    for (int a = 0; a < sp.n_ang; ++a) {
      T g = T(0);
      for (int k = 0; k < K; ++k) g += ca[a * K + k] * f[k];
      for (int c = 0; c < nmono; ++c) ang[a][c] += g * mono[c];
    }

    if (sp.spin) {
      const T j0 = sj[3 * pm], j1 = sj[3 * pm + 1], j2 = sj[3 * pm + 2];
      const T dot = s0 * j0 + s1 * j1 + s2 * j2;
      const T cx = s1 * j2 - s2 * j1, cy = s2 * j0 - s0 * j2,
              cz = s0 * j1 - s1 * j0;
      const T dmi = cx * rx + cy * ry + cz * rz;
      const T pd = (s0 * rx + s1 * ry + s2 * rz) * (j0 * rx + j1 * ry + j2 * rz);
      const T* cs = s_cspin + (ta * nt + tb) * sp.n_spin * K;
      for (int a = 0; a < sp.n_spin; ++a) {
        T g = T(0);
        for (int k = 0; k < K; ++k) g += cs[a * K + k] * f[k];
        sdot[a] += g * dot;
        sdmi[a] += g * dmi;
        spd[a] += g * pd;
        sv[a][0] += g * j0; sv[a][1] += g * j1; sv[a][2] += g * j2;
        sw[a][0] += g * rx; sw[a][1] += g * ry; sw[a][2] += g * rz;
      }
    }
  }

  // ---- finalize: accumulators -> descriptor q -----------------------------
  T q[MAX_DESC];
  int o = 0;
  for (int a = 0; a < sp.n_rad; ++a) q[o++] = rad[a];
  T mpow[MAX_L + 1][MAX_CH];
  for (int p = 0; p <= sp.l_max; ++p)
    for (int a = 0; a < sp.n_ang; ++a) {
      T acc = T(0);
      for (int g = MONO_START[p]; g < MONO_START[p + 1]; ++g)
        acc += T(MONO_W[g]) * ang[a][g] * ang[a][g];
      mpow[p][a] = acc;
    }
  for (int l = 1; l <= sp.l_max; ++l)
    for (int a = 0; a < sp.n_ang; ++a) {
      T acc = T(0);
      for (int p = 0; p <= l; ++p) acc += T(LEG[l][p]) * mpow[p][a];
      q[o++] = acc;
    }
  T smag = T(0);
  if (sp.spin) {
    smag = dsqrt(s0 * s0 + s1 * s1 + s2 * s2 + T(1e-30));
    T pw = smag;
    for (int k = 0; k < sp.n_onsite; ++k) { q[o++] = pw; pw *= smag; }
    for (int a = 0; a < sp.n_spin; ++a) q[o++] = sdot[a];
    for (int a = 0; a < sp.n_spin; ++a) q[o++] = sdmi[a];
    for (int a = 0; a < sp.n_spin; ++a) q[o++] = spd[a];
    for (int a = 0; a < sp.n_spin; ++a)
      q[o++] = sv[a][0] * sv[a][0] + sv[a][1] * sv[a][1] + sv[a][2] * sv[a][2];
    for (int a = 0; a < sp.n_spin; ++a)
      q[o++] = sv[a][0] * s0 + sv[a][1] * s1 + sv[a][2] * s2;
    for (int a = 0; a < sp.n_spin; ++a)
      q[o++] = sw[a][0] * sv[a][0] + sw[a][1] * sv[a][1] + sw[a][2] * sv[a][2];
  }

  // ---- MLP forward, then backward to dq = dE/dq ---------------------------
  const T* W1 = s_w1 + ta * D * H;
  T hb[MAX_HIDDEN];
  for (int h = 0; h < H; ++h) hb[h] = T(0);
  for (int d = 0; d < D; ++d) {
    const T qn = q[d] / s_qs[d];
    for (int h = 0; h < H; ++h) hb[h] += qn * W1[d * H + h];
  }
  T e = s_b2[ta];
  for (int h = 0; h < H; ++h) {
    const T th = dtanh(hb[h] + s_b1[ta * H + h]);
    const T wv = s_w2[ta * H + h];
    e += th * wv;
    hb[h] = wv * (T(1) - th * th);        // dE/dz_h
  }
  T dq[MAX_DESC];
  for (int d = 0; d < D; ++d) {
    T acc = T(0);
    for (int h = 0; h < H; ++h) acc += W1[d * H + h] * hb[h];
    dq[d] = acc / s_qs[d];
  }

  // ---- adjoints: dE/dA through finalize -----------------------------------
  T* out = abar_out + (size_t)i * A;
  o = 0;
  for (int a = 0; a < sp.n_rad; ++a) out[o++] = dq[a];
  for (int p = 0; p <= sp.l_max; ++p) {
    const int c0 = MONO_START[p], cp = MONO_START[p + 1] - c0;
    for (int a = 0; a < sp.n_ang; ++a) {
      T dmp = T(0);     // dE/d mpow[p][a] = sum_l LEG[l][p] dq_l[a]
      for (int l = (p > 1 ? p : 1); l <= sp.l_max; ++l)
        dmp += T(LEG[l][p]) * dq[sp.n_rad + (l - 1) * sp.n_ang + a];
      for (int c = 0; c < cp; ++c)
        out[o + a * cp + c] = dmp * T(2) * T(MONO_W[c0 + c]) * ang[a][c0 + c];
    }
    o += sp.n_ang * cp;
  }
  T h0 = T(0), h1 = T(0), h2 = T(0);      // dE_i/dS_i at fixed accumulators
  if (sp.spin) {
    const int ns = sp.n_spin;
    const int od = sp.n_rad + sp.n_ang * sp.l_max;   // onsite features
    const int ofs = od + sp.n_onsite;                 // sp_dot features
    for (int a = 0; a < ns; ++a) out[o + a] = dq[ofs + a];
    for (int a = 0; a < ns; ++a) out[o + ns + a] = dq[ofs + ns + a];
    for (int a = 0; a < ns; ++a) out[o + 2 * ns + a] = dq[ofs + 2 * ns + a];
    T* ov = out + o + 3 * ns;
    T* ow = ov + 3 * ns;
    const T sv_[3] = {s0, s1, s2};
    T vsum[3] = {T(0), T(0), T(0)};
    for (int a = 0; a < ns; ++a) {
      const T dvv = dq[ofs + 3 * ns + a];
      const T dvs = dq[ofs + 4 * ns + a];
      const T dwv = dq[ofs + 5 * ns + a];
      for (int d = 0; d < 3; ++d) {
        ov[3 * a + d] = T(2) * sv[a][d] * dvv + sv_[d] * dvs + sw[a][d] * dwv;
        ow[3 * a + d] = sv[a][d] * dwv;
        vsum[d] += sv[a][d] * dvs;
      }
    }
    T dsmag = T(0), pw = T(1);
    for (int k = 0; k < sp.n_onsite; ++k) {
      dsmag += T(k + 1) * pw * dq[od + k];
      pw *= smag;
    }
    const T f = dsmag / smag;
    h0 = f * s0 + vsum[0];
    h1 = f * s1 + vsum[1];
    h2 = f * s2 + vsum[2];
  }
  e_out[i] = e;
  hdir_out[3 * i] = -h0;
  hdir_out[3 * i + 1] = -h1;
  hdir_out[3 * i + 2] = -h2;
}

inline size_t atom_pass_smem(const Spec& sp, size_t elem) {
  const int nt = sp.n_types, K = sp.K, H = sp.hidden;
  const int D = sp.n_rad + sp.n_ang * sp.l_max +
                (sp.spin ? sp.n_onsite + 6 * sp.n_spin : 0);
  const size_t count = (size_t)nt * nt * (sp.n_rad + sp.n_ang +
                                          (sp.spin ? sp.n_spin : 0)) * K +
                       (size_t)nt * D * H + 2 * nt * H + nt + D;
  return count * elem;
}

template <typename T>
int launch_atom_pass(const void* dr, const void* mask, const void* ti,
                     const void* tj, const void* si, const void* sj,
                     const void* c_rad, const void* c_ang, const void* c_spin,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* q_scale, void* e, void* hdir,
                     void* abar, int n, int m, Spec sp, void* stream) {
  const size_t smem = atom_pass_smem(sp, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      atom_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + BLOCK - 1) / BLOCK;
  atom_pass_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)ti, (const int*)tj,
      (const T*)si, (const T*)sj, (const T*)c_rad, (const T*)c_ang,
      (const T*)c_spin, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (const T*)q_scale, (T*)e, (T*)hdir, (T*)abar, n, m, sp);
  return (int)cudaGetLastError();
}

}  // namespace nep

#define NEP_ATOM_PASS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* dr, const void* mask, const void* ti,      \
                      const void* tj, const void* si, const void* sj,        \
                      const void* c_rad, const void* c_ang,                  \
                      const void* c_spin, const void* w1, const void* b1,    \
                      const void* w2, const void* b2, const void* q_scale,   \
                      void* e, void* hdir, void* abar, int n, int m,         \
                      int n_types, int K, int n_rad, int n_ang, int l_max,   \
                      int n_spin, int n_onsite, int hidden, int spin,        \
                      double cutoff, void* stream) {                         \
    nep::Spec sp{n_types, K, n_rad, n_ang, l_max, n_spin, n_onsite, hidden,  \
                 spin, cutoff};                                              \
    return nep::launch_atom_pass<T>(dr, mask, ti, tj, si, sj, c_rad, c_ang,  \
                                    c_spin, w1, b1, w2, b2, q_scale, e,      \
                                    hdir, abar, n, m, sp, stream);           \
  }

NEP_ATOM_PASS_ENTRY(nep_atom_pass_f32, float)
NEP_ATOM_PASS_ENTRY(nep_atom_pass_f64, double)
