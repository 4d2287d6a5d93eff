// Shared pieces of the NEP-SPIN kernels (K1 nep_atom_pass.cu, K2
// nep_force_pass.cu): compile-time bounds on the spec, the monomial and
// Legendre tables, the packed accumulator layout, and small math helpers
// overloaded for float and double.
//
// Packed accumulator row (one per atom, acc_keys order, each leaf row-major):
//   rad[n_rad] | ang0[n_ang][1] | ang1[n_ang][3] | ... | ang{l_max}[n_ang][C]
//   | sp_dot[n_spin] | sp_dmi[n_spin] | sp_pd[n_spin] | sp_v[n_spin][3]
//   | sp_w[n_spin][3]
// (the spin leaves only when spec.spin).  This matches
// repro_torch/kernels/nep/layout.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nep {

// Bounds the wrappers check before launch (kernel.py: SPEC_BOUNDS).
constexpr int MAX_TYPES = 4;
constexpr int MAX_CH = 8;        // n_rad, n_ang, n_spin
constexpr int MAX_K = 16;        // basis_size
constexpr int MAX_L = 4;         // l_max
constexpr int MAX_HIDDEN = 64;
constexpr int MAX_ONSITE = 4;
constexpr int N_MONO = 35;       // monomials of degree 0..4
constexpr int MAX_DESC = MAX_CH + MAX_CH * MAX_L + MAX_ONSITE + 6 * MAX_CH;
constexpr int MAX_ACC = MAX_CH + MAX_CH * N_MONO + 9 * MAX_CH;
constexpr int BLOCK = 128;       // threads per block of a thread-per-atom body

struct Spec {
  int n_types, K, n_rad, n_ang, l_max, n_spin, n_onsite, hidden, spin;
  double cutoff;
};

// Monomials of degree p occupy [MONO_START[p], MONO_START[p+1]), in the
// order of core/descriptor.py:_MONO; (u.v)^p = sum_c w_c mono_c(u) mono_c(v).
__constant__ int MONO_START[MAX_L + 2] = {0, 1, 4, 10, 20, 35};
__constant__ int MONO_E[N_MONO][3] = {
    {0, 0, 0},
    {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
    {2, 0, 0}, {0, 2, 0}, {0, 0, 2}, {1, 1, 0}, {1, 0, 1}, {0, 1, 1},
    {3, 0, 0}, {0, 3, 0}, {0, 0, 3}, {2, 1, 0}, {2, 0, 1}, {1, 2, 0},
    {0, 2, 1}, {1, 0, 2}, {0, 1, 2}, {1, 1, 1},
    {4, 0, 0}, {0, 4, 0}, {0, 0, 4}, {3, 1, 0}, {3, 0, 1}, {1, 3, 0},
    {0, 3, 1}, {1, 0, 3}, {0, 1, 3}, {2, 2, 0}, {2, 0, 2}, {0, 2, 2},
    {2, 1, 1}, {1, 2, 1}, {1, 1, 2}};
__constant__ double MONO_W[N_MONO] = {
    1,
    1, 1, 1,
    1, 1, 1, 2, 2, 2,
    1, 1, 1, 3, 3, 3, 3, 3, 3, 6,
    1, 1, 1, 4, 4, 4, 4, 4, 4, 6, 6, 6, 12, 12, 12};
// MONO_E for indices known at compile time (K2's templated body): the
// same table, folded into immediates once its loops unroll.
__host__ __device__ constexpr int mono_exp(int g, int axis) {
  constexpr int e[N_MONO][3] = {
      {0, 0, 0},
      {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
      {2, 0, 0}, {0, 2, 0}, {0, 0, 2}, {1, 1, 0}, {1, 0, 1}, {0, 1, 1},
      {3, 0, 0}, {0, 3, 0}, {0, 0, 3}, {2, 1, 0}, {2, 0, 1}, {1, 2, 0},
      {0, 2, 1}, {1, 0, 2}, {0, 1, 2}, {1, 1, 1},
      {4, 0, 0}, {0, 4, 0}, {0, 0, 4}, {3, 1, 0}, {3, 0, 1}, {1, 3, 0},
      {0, 3, 1}, {1, 0, 3}, {0, 1, 3}, {2, 2, 0}, {2, 0, 2}, {0, 2, 2},
      {2, 1, 1}, {1, 2, 1}, {1, 1, 2}};
  return e[g][axis];
}
// LEG[l][p]: coefficient of t^p in the Legendre polynomial P_l(t)
__constant__ double LEG[MAX_L + 1][MAX_L + 1] = {
    {1.0, 0.0, 0.0, 0.0, 0.0},
    {0.0, 1.0, 0.0, 0.0, 0.0},
    {-0.5, 0.0, 1.5, 0.0, 0.0},
    {0.0, -1.5, 0.0, 2.5, 0.0},
    {0.375, 0.0, -3.75, 0.0, 4.375}};

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ void dsincospi(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void dsincospi(double x, double* s, double* c) {
  sincospi(x, s, c);
}
__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return tanh(x); }

// distance regulariser of the reference kernels (_eps_for)
template <typename T> __device__ __forceinline__ T dist_eps();
template <> __device__ __forceinline__ float dist_eps<float>() { return 1e-12f; }
template <> __device__ __forceinline__ double dist_eps<double>() { return 1e-30; }

template <typename T> __device__ __forceinline__ T pi_v() {
  return T(3.14159265358979323846);
}

// f_k(r) = 0.5 (T_k(x) + 1) fc(r), x = 2 (r/rc - 1)^2 - 1, for r < rc.
// With ``df`` non-null also writes d f_k / d r.  SINCOSPI takes
// cos(pi xc) and sin(pi xc) from sincospi, whose exact argument reduction
// needs no local-memory table (cos and sin of pi * xc carry one for huge
// arguments).
template <typename T, bool SINCOSPI = false>
__device__ __forceinline__ void chebyshev(T r, T rc, int K, T* f, T* df) {
  const T xc = r / rc;
  const T x = T(2) * (xc - T(1)) * (xc - T(1)) - T(1);
  T cpi, spi;                       // cos(pi xc), sin(pi xc)
  if constexpr (SINCOSPI)
    dsincospi(xc, &spi, &cpi);
  else
    cpi = dcos(pi_v<T>() * xc);
  const T fc = T(0.5) * (T(1) + cpi);
  T tkm1 = T(1), tk = x;            // T_{k-1}, T_k
  T dkm1 = T(0), dk = T(1);         // their x-derivatives
  f[0] = fc;                        // 0.5 (T_0 + 1) fc
  if (df) {
    const T dx = T(4) * (xc - T(1)) / rc;
    if constexpr (!SINCOSPI) spi = dsin(pi_v<T>() * xc);
    const T dfc = -T(0.5) * pi_v<T>() / rc * spi;
    df[0] = dfc;
    for (int k = 1; k < K; ++k) {
      f[k] = T(0.5) * (tk + T(1)) * fc;
      df[k] = T(0.5) * dk * dx * fc + T(0.5) * (tk + T(1)) * dfc;
      const T tn = T(2) * x * tk - tkm1;
      const T dn = T(2) * tk + T(2) * x * dk - dkm1;
      tkm1 = tk; tk = tn; dkm1 = dk; dk = dn;
    }
  } else {
    for (int k = 1; k < K; ++k) {
      f[k] = T(0.5) * (tk + T(1)) * fc;
      const T tn = T(2) * x * tk - tkm1;
      tkm1 = tk; tk = tn;
    }
  }
}

// monomials of rhat up to degree l_max (n_mono = MONO_START[l_max+1])
template <typename T>
__device__ __forceinline__ void powers(T x, T* p) {
  p[0] = T(1);
  for (int e = 1; e <= MAX_L; ++e) p[e] = p[e - 1] * x;
}

// Stage ``count`` values of ``src`` into shared memory at ``dst``.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = src[t];
}

__host__ __device__ constexpr int n_mono(int l_max) {
  return (l_max + 1) * (l_max + 2) * (l_max + 3) / 6;
}

// The specs with a compiled warp-per-atom body in K1 and K2 (kernel.py:
// WARP_SPECS), as compile-time sizes, so every loop over them unrolls.
template <int NT_, int K_, int NR_, int NA_, int L_, int NS_, int H_, int NO_>
struct Sizes {
  static constexpr int NT = NT_, K = K_, NR = NR_, NA = NA_, L = L_,
                       NS = NS_, H = H_, NO = NO_;
  static constexpr int NM = n_mono(L);
  static constexpr int O_DOT = NR + NA * NM;       // spin leaves start here
  static constexpr int A = O_DOT + 9 * NS;         // adjoint row width
  static constexpr int LDA = A | 1;                // odd: no bank conflicts
  static constexpr int D = NR + NA * L + NO + 6 * NS;   // descriptor width
  static constexpr int C_ANG = NT * NT * NR * K;   // carrier blocks in s_c
  static constexpr int C_SPIN = C_ANG + NT * NT * NA * K;
  static constexpr int NC = C_SPIN + NT * NT * NS * K;
};
// (n_types, basis_size, n_rad, n_ang, l_max, n_spin, hidden, n_onsite)
using ProdSizes = Sizes<2, 8, 6, 4, 4, 4, 32, 3>;    // fege_spinlattice config()
using SmokeSizes = Sizes<2, 6, 4, 2, 2, 2, 16, 3>;   // fege_spinlattice smoke_config()
using LoopSizes = Sizes<2, 6, 4, 2, 2, 2, 32, 3>;    // the md_loop scenario's spec
using TrainSizes = Sizes<2, 6, 4, 2, 2, 3, 32, 3>;   // launch/train.py's fitted spec

// K2's warp body reads the carriers only: the sizes up to n_spin decide.
template <typename S>
bool is(const Spec& sp) {
  return sp.n_types == S::NT && sp.K == S::K && sp.n_rad == S::NR &&
         sp.n_ang == S::NA && sp.l_max == S::L && sp.n_spin == S::NS &&
         sp.spin;
}

// K1's warp body also runs the MLP and the onsite features.
template <typename S>
bool is_atom(const Spec& sp) {
  return is<S>(sp) && sp.hidden == S::H && sp.n_onsite == S::NO;
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// row[0..K) from shared memory, 16 or 8 bytes per load where aligned
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* p, T (&c)[K]) {
  if constexpr ((K * sizeof(T)) % 16 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      c[k] = v.x; c[k + 1] = v.y; c[k + 2] = v.z; c[k + 3] = v.w;
    }
  } else if constexpr ((K * sizeof(T)) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + k);
      c[k] = v.x; c[k + 1] = v.y;
    }
  } else if constexpr ((K * sizeof(T)) % 8 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + k);
      c[k] = v.x; c[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = p[k];
  }
}

}  // namespace nep
