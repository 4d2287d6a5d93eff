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
// Per atom both bodies sum, over the pairs inside the cutoff, the 182
// accumulators (at most MAX_ACC): rad_a = sum g_a, ang_a,c = sum g_a
// mono_c(rhat), and the spin sums of g_a times S_i.S_j, DMI, pseudo-dipolar,
// S_j and rhat, where g_a = sum_k c[ti][tj][a][k] f_k(r) are the carriers.
// Then finalize (q), the MLP (e) and its backward (dq = dE/dq), and the
// adjoints through finalize.  Masked slots and pairs at or beyond the cutoff
// (where every basis function vanishes) add nothing.  Two bodies:
//
// * atom_pass_warp_kernel (nep_atom_pass_warp_*): one warp per atom,
//   templated on the spec's sizes (nep_common.cuh: Sizes, the list K2's
//   warp body reads), so every loop over them unrolls; kernel.py:
//   atom_pass_body picks it for the specs of configs/fege_spinlattice.py
//   and the md_loop scenario (launch/md_loop.py).
//   As in K2, the lanes read the atom's M slots side by side (coalesced)
//   and a ballot over mask & (r < rc) packs the live slots into a list;
//   each lane then takes one live pair and forms, in registers, its basis
//   (sincospi: no local-memory table), its 14 carriers g, its 35
//   monomials and its spin terms, and writes these 59 factors as one row
//   of a per-warp record in shared memory (odd row stride: the lanes'
//   stores hit 32 banks).  The 182 sums are then transposed onto the
//   lanes: lane j owns accumulators j, j + 32, ... (6 of them), knows each
//   one's two factors' positions in a row, and adds their products over
//   the round's pairs in registers, in pair order - no local memory, no
//   atomics, the same result every run.  (The other way, each lane holding
//   its own pair's 182 products and the warp summing them with shuffle
//   butterflies, costs 182 x 5 shuffles per round against ~12 shared
//   loads per pair per lane here.)  Finalize and the MLP run across the
//   lanes: q (49 features) in shared memory read as broadcasts; one hidden
//   unit per lane (hidden = 32) with W1 staged at an odd row stride (33),
//   so the backward dq_d = sum_h W1[d][h] hb_h, with lanes over d, is free
//   of bank conflicts; the energy is a shuffle sum.  Each lane then forms
//   the adjoints of the accumulators it owns, and the warp writes the
//   182-float row to consecutive words.  It runs at ~13 % of the bytes
//   bound above; how its time splits between the record's shared-memory
//   traffic, the per-pair arithmetic and latency is not measured apart.
// * atom_pass_kernel (nep_atom_pass_*, the first body): one thread per atom
//   with run-time loop bounds; it keeps the accumulators, q and dq in
//   per-thread arrays, which live in local memory (2,320 bytes of stack at
//   the production spec, f32), and its slot reads are 768 bytes apart
//   across a warp.  It serves every other spec within the bounds of
//   nep_common.cuh; the carriers and MLP weights sit in shared memory
//   (~15 KB f32, ~30 KB f64), the type dispatch is a direct index
//   c[ti][tj], and the ragged edge n % BLOCK is masked by the bounds check.
//
// Replica axis: one launch serves nr replicas.  dr, si, sj and the three
// outputs carry a leading replica axis.  The table (mask, tj (n, m), ti
// (n,)) is shared by every replica (the Replicated plan: tab_stride 0) or
// is one per replica (the Sharded plan's replicas, each with its own cells:
// tab_stride n, a (nr, n, m) table).  The grid's y axis is the replica: a
// block moves those pointers to its replica's rows - the table's by
// tab_stride rows - and runs the flat body unchanged, so replica r of a
// batched launch is bitwise a launch on replica r's inputs alone.  The warp body's flat
// instantiation (BATCH false, launched for nr = 1) leaves the move out: with
// it, the flat launch ran 3 % slower (launch/kernel_rate.py).
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
                 T* __restrict__ abar_out, int n, int m, int tab_stride,
                 Spec sp) {
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

  // replica blockIdx.y: its blocks and outputs, and its table unless the
  // table is shared (tab_stride 0)
  const size_t rep = blockIdx.y;
  mask += rep * tab_stride * m;
  tj += rep * tab_stride * m;
  ti += rep * tab_stride;
  dr += rep * n * m * 3;
  si += rep * n * 3;
  sj += rep * n * m * 3;
  e_out += rep * n;
  hdir_out += rep * n * 3;
  abar_out += rep * n * A;

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
                     void* abar, int n, int m, int nr, int tab_stride,
                     Spec sp, void* stream) {
  const size_t smem = atom_pass_smem(sp, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      atom_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, nr);
  atom_pass_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)ti, (const int*)tj,
      (const T*)si, (const T*)sj, (const T*)c_rad, (const T*)c_ang,
      (const T*)c_spin, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (const T*)q_scale, (T*)e, (T*)hdir, (T*)abar, n, m,
      tab_stride, sp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One warp per atom, templated on the spec
// ---------------------------------------------------------------------------
constexpr int AWARPS = 4;          // atoms in flight per block
constexpr int AGRID_MAX = 2048;    // blocks; warps stride over the atoms
// Blocks per SM: ~52 KB of shared memory each (f32 production) lets 4
// share an SM, so 128 registers a thread cost no occupancy.  With only the
// block size bounded, ptxas held the f32 production body to 72 registers
// and spilled five per-lane constants (24 bytes of stack); build variants
// timed on the card (8 and 2 warps a block, 2 blocks per SM) ran no faster.
constexpr int AMIN_BLOCKS = 4;

// One pair's row of the per-warp record: the factors whose products the
// accumulators sum (ONE is the constant 1 of the radial sums).
template <typename S>
struct Rec {
  static constexpr int ONE = 0, RAD = 1, ANG = RAD + S::NR,
                       SPIN = ANG + S::NA, MONO = SPIN + S::NS,
                       DOT = MONO + S::NM, DMI = DOT + 1, PD = DMI + 1,
                       J = PD + 1, R = J + 3, W = R + 3;
  static constexpr int LD = W | 1;             // odd row stride
  static constexpr int T = (S::A + 31) / 32;   // accumulators per lane
  static constexpr int NMP = (S::L + 1) * S::NA;   // mpow[p][a] values
};

// Accumulator k of the packed row sums rec[f1] * rec[f2] over the pairs;
// k past the row gets (ONE, ONE) and is never written.
template <typename S>
__device__ __forceinline__ void acc_factors(int k, int& f1, int& f2) {
  using R = Rec<S>;
  constexpr int NS = S::NS;
  f1 = f2 = R::ONE;
  if (k < S::NR) {
    f1 = R::RAD + k;
    return;
  }
  if (k < S::O_DOT) {
    int kk = k - S::NR;
#pragma unroll
    for (int p = 0; p <= S::L; ++p) {   // leaf ang{p}: [n_ang][C_p]
      const int C = (p + 1) * (p + 2) / 2;
      if (kk < S::NA * C) {
        f1 = R::ANG + kk / C;
        f2 = R::MONO + n_mono(p - 1) + kk % C;
        return;
      }
      kk -= S::NA * C;
    }
  }
  int o = k - S::O_DOT;
  if (o < 3 * NS) {                     // sp_dot, sp_dmi, sp_pd
    f1 = R::SPIN + o % NS;
    f2 = R::DOT + o / NS;
  } else if (o < 6 * NS) {              // sp_v[a][d] = sum g_a S_j,d
    o -= 3 * NS;
    f1 = R::SPIN + o / 3;
    f2 = R::J + o % 3;
  } else if (o < 9 * NS) {              // sp_w[a][d] = sum g_a rhat_d
    o -= 6 * NS;
    f1 = R::SPIN + o / 3;
    f2 = R::R + o % 3;
  }
}

// out[a] = sum_k c[a][k] f[k] for n channels of one type pair's carriers
template <typename T, int N, int K>
__device__ __forceinline__ void carrier_sum(const T* c, const T (&f)[K],
                                            T* out) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    T r[K];
    load_row<T, K>(c + a * K, r);
    T s = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) s += r[k] * f[k];
    out[a] = s;
  }
}

// One live pair's row of the record (in shared memory at ``rec``).
template <typename S, typename T>
__device__ __forceinline__ void pair_record(T dx, T dy, T dz, T rc, int pt,
                                            const T* sc, T s0, T s1, T s2,
                                            T j0, T j1, T j2, T* rec) {
  using R = Rec<S>;
  constexpr int K = S::K;
  const T r = dsqrt(dx * dx + dy * dy + dz * dz + dist_eps<T>());
  const T inv = T(1) / r;
  const T rx = dx * inv, ry = dy * inv, rz = dz * inv;
  T fk[K];
  chebyshev<T, true>(r, rc, K, fk, nullptr);
  rec[R::ONE] = T(1);
  carrier_sum<T, S::NR, K>(sc + pt * S::NR * K, fk, rec + R::RAD);
  carrier_sum<T, S::NA, K>(sc + S::C_ANG + pt * S::NA * K, fk, rec + R::ANG);
  carrier_sum<T, S::NS, K>(sc + S::C_SPIN + pt * S::NS * K, fk,
                           rec + R::SPIN);
  T px[MAX_L + 1], py[MAX_L + 1], pz[MAX_L + 1];
  powers(rx, px);
  powers(ry, py);
  powers(rz, pz);
#pragma unroll
  for (int g = 0; g < S::NM; ++g)
    rec[R::MONO + g] = px[mono_exp(g, 0)] * py[mono_exp(g, 1)] *
                       pz[mono_exp(g, 2)];
  const T cx = s1 * j2 - s2 * j1, cy = s2 * j0 - s0 * j2,
          cz = s0 * j1 - s1 * j0;
  rec[R::DOT] = s0 * j0 + s1 * j1 + s2 * j2;
  rec[R::DMI] = cx * rx + cy * ry + cz * rz;
  rec[R::PD] = (s0 * rx + s1 * ry + s2 * rz) * (j0 * rx + j1 * ry + j2 * rz);
  rec[R::J] = j0;
  rec[R::J + 1] = j1;
  rec[R::J + 2] = j2;
  rec[R::R] = rx;
  rec[R::R + 1] = ry;
  rec[R::R + 2] = rz;
}

// shared memory in T: block-wide carriers, MLP weights and q_scale ...
template <typename S>
__host__ __device__ constexpr int atom_shared_count() {
  return round4(S::NC) + S::NT * S::D * (S::H | 1) + 2 * S::NT * S::H +
         S::NT + S::D;
}
// ... and per warp the record, acc, q, dq, hb and mpow
template <typename S>
__host__ __device__ constexpr int atom_warp_count() {
  using R = Rec<S>;
  return 32 * R::LD + S::A + 2 * S::D + S::H + R::NMP;
}

template <typename S, typename T, bool BATCH>
__global__ void __launch_bounds__(32 * AWARPS, AMIN_BLOCKS)
atom_pass_warp_kernel(const T* __restrict__ dr, const bool* __restrict__ mask,
                      const int* __restrict__ ti, const int* __restrict__ tj,
                      const T* __restrict__ si, const T* __restrict__ sj,
                      const T* __restrict__ c_rad, const T* __restrict__ c_ang,
                      const T* __restrict__ c_spin, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2,
                      const T* __restrict__ q_scale, T* __restrict__ e_out,
                      T* __restrict__ hdir_out, T* __restrict__ abar_out,
                      int n, int m, int tab_stride, T rc) {
  static_assert(S::NS > 0, "the warp body is compiled for spin specs");
  using R = Rec<S>;
  constexpr int A = S::A, D = S::D, H = S::H, NT = S::NT, NS = S::NS,
                NA = S::NA, LDH = H | 1, NMP = R::NMP;
  static_assert(NMP <= 32, "one lane per mpow[p][a]");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);       // carriers
  T* s_w1 = sc + round4(S::NC);                 // NT x D x LDH
  T* s_b1 = s_w1 + NT * D * LDH;                // NT x H
  T* s_w2 = s_b1 + NT * H;                      // NT x H
  T* s_b2 = s_w2 + NT * H;                      // NT
  T* s_qs = s_b2 + NT;                          // D
  T* s_warps = sc + atom_shared_count<S>();     // AWARPS x atom_warp_count
  int* s_list = reinterpret_cast<int*>(s_warps + AWARPS * atom_warp_count<S>());
  stage(sc, c_rad, NT * NT * S::NR * S::K);
  stage(sc + S::C_ANG, c_ang, NT * NT * NA * S::K);
  stage(sc + S::C_SPIN, c_spin, NT * NT * NS * S::K);
  for (int t = threadIdx.x; t < NT * D * H; t += blockDim.x)
    s_w1[(t / H) * LDH + t % H] = w1[t];
  stage(s_b1, b1, NT * H);
  stage(s_w2, w2, NT * H);
  stage(s_b2, b2, NT);
  stage(s_qs, q_scale, D);
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* rec = s_warps + warp * atom_warp_count<S>();   // 32 x LD
  T* acc_s = rec + 32 * R::LD;                      // A
  T* q_s = acc_s + A;                               // D: q / q_scale
  T* dq_s = q_s + D;                                // D
  T* hb_s = dq_s + D;                               // H: dE/dz_h
  T* mp_s = hb_s + H;                               // mpow, then dE/dmpow
  int* list = s_list + warp * m;
  int f1[R::T], f2[R::T];
#pragma unroll
  for (int t = 0; t < R::T; ++t) acc_factors<S>(lane + 32 * t, f1[t], f2[t]);
  const int ofs = S::NR + NA * S::L + S::NO;   // sp_dot features in q

  // a batch's replica blockIdx.y: its blocks and outputs, and its table
  // unless the table is shared (tab_stride 0); a flat launch (BATCH false)
  // runs the body as it was
  if constexpr (BATCH) {
    const size_t rep = blockIdx.y;
    mask += rep * tab_stride * m;
    tj += rep * tab_stride * m;
    ti += rep * tab_stride;
    dr += rep * n * m * 3;
    si += rep * n * 3;
    sj += rep * n * m * 3;
    e_out += rep * n;
    hdir_out += rep * n * 3;
    abar_out += rep * n * A;
  }

  for (int i = blockIdx.x * AWARPS + warp; i < n; i += gridDim.x * AWARPS) {
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
    T acc[R::T];
#pragma unroll
    for (int t = 0; t < R::T; ++t) acc[t] = T(0);
    for (int t0 = 0; t0 < live; t0 += 32) {
      const int cnt = min(32, live - t0);
      if (lane < cnt) {
        const size_t pm = (size_t)i * m + list[t0 + lane];
        pair_record<S, T>(dr[3 * pm], dr[3 * pm + 1], dr[3 * pm + 2], rc,
                          ta * NT + tj[pm], sc, s0, s1, s2, sj[3 * pm],
                          sj[3 * pm + 1], sj[3 * pm + 2], rec + lane * R::LD);
      }
      __syncwarp();
      // the transpose: this lane's accumulators over the round's pairs
      for (int p = 0; p < cnt; ++p) {
        const T* rp = rec + p * R::LD;
#pragma unroll
        for (int t = 0; t < R::T; ++t) acc[t] += rp[f1[t]] * rp[f2[t]];
      }
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < R::T; ++t)
      if (lane + 32 * t < A) acc_s[lane + 32 * t] = acc[t];
    __syncwarp();

    // ---- finalize: mpow[p][a] = sum_c w_c ang[a][c]^2, then q ----------
    if (lane < NMP) {
      const int p = lane / NA, a = lane % NA;
      const int C = (p + 1) * (p + 2) / 2, g0 = n_mono(p - 1);
      const T* ang = acc_s + S::NR + NA * g0 + a * C;
      T v = T(0);
      for (int c = 0; c < C; ++c) v += T(MONO_W[g0 + c]) * ang[c] * ang[c];
      mp_s[lane] = v;
    }
    __syncwarp();
    const T smag = dsqrt(s0 * s0 + s1 * s1 + s2 * s2 + T(1e-30));
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      if (d >= D) continue;
      T q;
      if (d < S::NR) {
        q = acc_s[d];
      } else if (d < S::NR + NA * S::L) {
        const int l = (d - S::NR) / NA + 1, a = (d - S::NR) % NA;
        q = T(0);
        for (int p = 0; p <= l; ++p) q += T(LEG[l][p]) * mp_s[p * NA + a];
      } else if (d < ofs) {                      // |S|^(k+1)
        q = smag;
        for (int k = S::NR + NA * S::L; k < d; ++k) q *= smag;
      } else {
        const int o = d - ofs, grp = o / NS, a = o % NS;
        const T* sv = acc_s + S::O_DOT + 3 * NS + 3 * a;
        const T* sw = sv + 3 * NS;
        if (grp < 3)
          q = acc_s[S::O_DOT + o];               // sp_dot, sp_dmi, sp_pd
        else if (grp == 3)
          q = sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2];
        else if (grp == 4)
          q = sv[0] * s0 + sv[1] * s1 + sv[2] * s2;
        else
          q = sw[0] * sv[0] + sw[1] * sv[1] + sw[2] * sv[2];
      }
      q_s[d] = q / s_qs[d];
    }
    __syncwarp();

    // ---- MLP: one hidden unit per lane, then dq with lanes over d -------
    const T* W1 = s_w1 + ta * D * LDH;
    T epart = T(0);
#pragma unroll
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int h = h0 + lane;
      if (h < H) {
        T z = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) z += q_s[d] * W1[d * LDH + h];
        const T th = dtanh(z + s_b1[ta * H + h]);
        const T wv = s_w2[ta * H + h];
        epart += th * wv;
        hb_s[h] = wv * (T(1) - th * th);           // dE/dz_h
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      epart += __shfl_xor_sync(full, epart, off);
    __syncwarp();
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      if (d >= D) continue;
      T v = T(0);
#pragma unroll
      for (int h = 0; h < H; ++h) v += W1[d * LDH + h] * hb_s[h];
      dq_s[d] = v / s_qs[d];
    }
    __syncwarp();
    if (lane < NMP) {        // dE/d mpow[p][a] = sum_l LEG[l][p] dq_l[a]
      const int p = lane / NA, a = lane % NA;
      T v = T(0);
      for (int l = (p > 1 ? p : 1); l <= S::L; ++l)
        v += T(LEG[l][p]) * dq_s[S::NR + (l - 1) * NA + a];
      mp_s[lane] = v;
    }
    __syncwarp();

    // ---- adjoints of this lane's accumulators, one coalesced row --------
    T* out = abar_out + (size_t)i * A;
#pragma unroll
    for (int t = 0; t < R::T; ++t) {
      const int k = lane + 32 * t;
      if (k >= A) continue;
      T v;
      if (k < S::NR) {
        v = dq_s[k];
      } else if (k < S::O_DOT) {
        const int a = f1[t] - R::ANG, g = f2[t] - R::MONO;
        const int p = g < 1 ? 0 : g < 4 ? 1 : g < 10 ? 2 : g < 20 ? 3 : 4;
        v = mp_s[p * NA + a] * T(2) * T(MONO_W[g]) * acc[t];
      } else if (k < S::O_DOT + 3 * NS) {
        v = dq_s[ofs + k - S::O_DOT];
      } else {
        const int a = f1[t] - R::SPIN;
        const T dwv = dq_s[ofs + 5 * NS + a];
        if (k < S::O_DOT + 6 * NS) {           // sp_v[a][dd]
          const int dd = f2[t] - R::J;
          const T sd = dd == 0 ? s0 : dd == 1 ? s1 : s2;
          const T sw = acc_s[k + 3 * NS];
          v = T(2) * acc[t] * dq_s[ofs + 3 * NS + a] +
              sd * dq_s[ofs + 4 * NS + a] + sw * dwv;
        } else {                               // sp_w[a][dd]
          v = acc_s[k - 3 * NS] * dwv;
        }
      }
      out[k] = v;
    }
    // direct field -dE_i/dS_i at fixed accumulators: lane d, component d
    if (lane < 3) {
      T dsmag = T(0), pw = T(1);
#pragma unroll
      for (int k = 0; k < S::NO; ++k) {
        dsmag += T(k + 1) * pw * dq_s[S::NR + NA * S::L + k];
        pw *= smag;
      }
      T vs = T(0);
#pragma unroll
      for (int a = 0; a < NS; ++a)
        vs += acc_s[S::O_DOT + 3 * NS + 3 * a + lane] *
              dq_s[ofs + 4 * NS + a];
      const T sd = lane == 0 ? s0 : lane == 1 ? s1 : s2;
      hdir_out[3 * i + lane] = -((dsmag / smag) * sd + vs);
    }
    if (lane == 0) e_out[i] = s_b2[ta] + epart;
    __syncwarp();
  }
}

template <typename S, typename T>
int launch_atom_warp(const void* dr, const void* mask, const void* ti,
                     const void* tj, const void* si, const void* sj,
                     const void* c_rad, const void* c_ang, const void* c_spin,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* q_scale, void* e, void* hdir,
                     void* abar, int n, int m, int nr, int tab_stride,
                     double cutoff, void* stream) {
  const size_t smem =
      sizeof(T) * (atom_shared_count<S>() + AWARPS * atom_warp_count<S>()) +
      sizeof(int) * AWARPS * m;
  auto* kern = nr > 1 ? atom_pass_warp_kernel<S, T, true>
                      : atom_pass_warp_kernel<S, T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // AGRID_MAX blocks in all, shared out over the replicas
  const dim3 grid(min((n + AWARPS - 1) / AWARPS, max(1, AGRID_MAX / nr)), nr);
  kern<<<grid, 32 * AWARPS, smem, (cudaStream_t)stream>>>(
      (const T*)dr, (const bool*)mask, (const int*)ti, (const int*)tj,
      (const T*)si, (const T*)sj, (const T*)c_rad, (const T*)c_ang,
      (const T*)c_spin, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (const T*)q_scale, (T*)e, (T*)hdir, (T*)abar, n, m,
      tab_stride, T(cutoff));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_atom_pass_warp(const void* dr, const void* mask, const void* ti,
                          const void* tj, const void* si, const void* sj,
                          const void* c_rad, const void* c_ang,
                          const void* c_spin, const void* w1, const void* b1,
                          const void* w2, const void* b2,
                          const void* q_scale, void* e, void* hdir,
                          void* abar, int n, int m, int nr,
                          int tab_stride, Spec sp, void* stream) {
  if (is_atom<ProdSizes>(sp))
    return launch_atom_warp<ProdSizes, T>(dr, mask, ti, tj, si, sj, c_rad,
                                          c_ang, c_spin, w1, b1, w2, b2,
                                          q_scale, e, hdir, abar, n, m, nr,
                                          tab_stride, sp.cutoff, stream);
  if (is_atom<SmokeSizes>(sp))
    return launch_atom_warp<SmokeSizes, T>(dr, mask, ti, tj, si, sj, c_rad,
                                           c_ang, c_spin, w1, b1, w2, b2,
                                           q_scale, e, hdir, abar, n, m, nr,
                                           tab_stride, sp.cutoff, stream);
  if (is_atom<LoopSizes>(sp))
    return launch_atom_warp<LoopSizes, T>(dr, mask, ti, tj, si, sj, c_rad,
                                          c_ang, c_spin, w1, b1, w2, b2,
                                          q_scale, e, hdir, abar, n, m, nr,
                                          tab_stride, sp.cutoff, stream);
  if (is_atom<TrainSizes>(sp))
    return launch_atom_warp<TrainSizes, T>(dr, mask, ti, tj, si, sj, c_rad,
                                           c_ang, c_spin, w1, b1, w2, b2,
                                           q_scale, e, hdir, abar, n, m, nr,
                                           tab_stride, sp.cutoff, stream);
  return (int)cudaErrorInvalidValue;   // no instantiation for this spec
}

}  // namespace nep

#define NEP_ATOM_PASS_ENTRY(NAME, T, LAUNCH)                                  \
  extern "C" int NAME(const void* dr, const void* mask, const void* ti,      \
                      const void* tj, const void* si, const void* sj,        \
                      const void* c_rad, const void* c_ang,                  \
                      const void* c_spin, const void* w1, const void* b1,    \
                      const void* w2, const void* b2, const void* q_scale,   \
                      void* e, void* hdir, void* abar, int n, int m, int nr, \
                      int tab_stride, int n_types, int K, int n_rad,         \
                      int n_ang, int l_max,                                  \
                      int n_spin, int n_onsite, int hidden, int spin,        \
                      double cutoff, void* stream) {                         \
    nep::Spec sp{n_types, K, n_rad, n_ang, l_max, n_spin, n_onsite, hidden,  \
                 spin, cutoff};                                              \
    return nep::LAUNCH<T>(dr, mask, ti, tj, si, sj, c_rad, c_ang, c_spin,    \
                          w1, b1, w2, b2, q_scale, e, hdir, abar, n, m, nr,  \
                          tab_stride, sp, stream);                           \
  }

NEP_ATOM_PASS_ENTRY(nep_atom_pass_f32, float, launch_atom_pass)
NEP_ATOM_PASS_ENTRY(nep_atom_pass_f64, double, launch_atom_pass)
NEP_ATOM_PASS_ENTRY(nep_atom_pass_warp_f32, float, launch_atom_pass_warp)
NEP_ATOM_PASS_ENTRY(nep_atom_pass_warp_f64, double, launch_atom_pass_warp)
