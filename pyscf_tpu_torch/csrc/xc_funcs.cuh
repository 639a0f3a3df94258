// The XC components on forward-mode dual numbers of first and second order.
//
// Device counterpart of pyscf_tpu/dft/xc_funcs.py (lda_x, _vwn_eps,
// _f_zeta, vwn5_c, vwn3_c, b88_x, pbe_x, lyp_c, _rs; _pw92_g, pw92_eps,
// pbe_c, _sr_attenuation, cam_b88_x, _b97_u, _b97_series, wb97_xc) and of
// their
// torch versions in pyscf_tpu_torch/dft/xc_funcs.py. Each component is
// written once, in the JAX package's expression order and with its clamps,
// as a template over the number type D, which is one of
//   DualN<N>   the value and N tangents;
//   HDualN<N>  the value, N tangents and the N(N+1)/2 second derivatives
//              (a truncated Taylor number), for the XC response kernels.
// N is
//   2  d/drho and d/dsigma of the closed-shell energy density, seeded
//      through rho_a = rho_b = rho/2 and sigma_aa = sigma_ab = sigma_bb =
//      sigma/4 (edens_closed: kernels xc_rks, xc_rks_fxc): one evaluation
//      gives e_xc, vrho and vsigma, the numbers jax.grad gives at
//      pyscf_tpu/dft/numint.py:135-137, and on HDualN<2> their derivatives,
//      which jax.jvp of that jax.grad takes (pyscf_tpu/tdscf/rhf.py:218);
//   5  one for each of rho_a, rho_b, sigma_aa, sigma_ab and sigma_bb
//      (edens_open: kernels xc_uks, xc_uks_fxc, xc_fxc).
// The derivative rules are JAX's: pow(x, y)' = y pow(x, y-1), integer
// powers by repeated squaring with (x^n)' = n x^(n-1), erf' = 2/sqrt(pi)
// exp(-x^2), log1p' = 1/(1+x), expm1' = expm1(x) + 1, and a maximum or
// minimum at a tie passes
// half the tangent; on HDualN each rule is also differentiated once more
// (x^y)'' = y (y-1) x^(y-2), ..., and a tie's second derivative is zero,
// as jax.hessian (jacfwd of jacrev) composes them. The two components with
// parameters, CAM_B88 and WB97, are compiled in only where a kernel asks
// for them (the template flag RSH of edens_closed and edens_open): xc_rks
// and xc_uks.
//
// Constants that Python computes with pow are written out as the doubles
// Python gives (CUDA's pow is not correctly rounded); the rest are the
// same literal expressions, which the compiler folds as Python does.
#pragma once
#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#endif

#define PT_HD __host__ __device__ __forceinline__
// The components' qualifiers: inlined into the kernel, or, where a library
// is built with PT_XC_NOINLINE (the kernels on second-order dual numbers,
// ops/kernels.py), each compiled once as a function of its own. ptxas then
// takes about half the time on those libraries, and their kernels take
// 1-8 % longer (PERF.md section 6).
#ifdef PT_XC_NOINLINE
#define PT_XC __host__ __device__ __noinline__
#else
#define PT_XC PT_HD
#endif

namespace ptxc {

constexpr double PI = 3.141592653589793;
constexpr double TINY = 1e-30;

// x**n for an integer n >= 1 by repeated squaring (XLA's integer_pow)
PT_HD double ipow(double x, int n) {
  double acc = 1.0;
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    n >>= 1;
    if (n) x = x * x;
  }
  return acc;
}

// ---- dual numbers with N tangents -------------------------------------------

template <int N>
struct DualN {
  double v;      // value
  double d[N];   // tangents
};

template <int N>
PT_HD DualN<N> cst_n(double c) {
  DualN<N> r;
  r.v = c;
  for (int k = 0; k < N; ++k) r.d[k] = 0.0;
  return r;
}
template <int N>
PT_HD DualN<N> scale(const DualN<N>& x, double d, double v) {
  DualN<N> r;
  r.v = v;
  for (int k = 0; k < N; ++k) r.d[k] = d * x.d[k];
  return r;
}

template <int N>
PT_HD DualN<N> operator+(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v + b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator-(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v - b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator-(const DualN<N>& a) {
  DualN<N> r;
  r.v = -a.v;
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator*(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v * b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator/(const DualN<N>& a, const DualN<N>& b) {
  const double q = a.v / b.v;
  DualN<N> r;
  r.v = q;
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - q * b.d[k]) / b.v;
  return r;
}
template <int N>
PT_HD DualN<N> operator+(const DualN<N>& a, double c) {
  DualN<N> r = a;
  r.v = a.v + c;
  return r;
}
template <int N>
PT_HD DualN<N> operator+(double c, const DualN<N>& a) {
  DualN<N> r = a;
  r.v = c + a.v;
  return r;
}
template <int N>
PT_HD DualN<N> operator-(const DualN<N>& a, double c) {
  DualN<N> r = a;
  r.v = a.v - c;
  return r;
}
template <int N>
PT_HD DualN<N> operator-(double c, const DualN<N>& a) {
  DualN<N> r;
  r.v = c - a.v;
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator*(const DualN<N>& a, double c) {
  DualN<N> r;
  r.v = a.v * c;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * c;
  return r;
}
template <int N>
PT_HD DualN<N> operator*(double c, const DualN<N>& a) {
  DualN<N> r;
  r.v = c * a.v;
  for (int k = 0; k < N; ++k) r.d[k] = c * a.d[k];
  return r;
}
template <int N>
PT_HD DualN<N> operator/(const DualN<N>& a, double c) {
  DualN<N> r;
  r.v = a.v / c;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / c;
  return r;
}
template <int N>
PT_HD DualN<N> operator/(double c, const DualN<N>& b) {
  const double q = c / b.v;
  DualN<N> r;
  r.v = q;
  for (int k = 0; k < N; ++k) r.d[k] = (-q * b.d[k]) / b.v;
  return r;
}

// x**y for a float exponent y
template <int N>
PT_HD DualN<N> dpow(const DualN<N>& x, double y) {
  return scale(x, y * pow(x.v, y - 1.0), pow(x.v, y));
}

template <int N>
PT_HD DualN<N> dipow(const DualN<N>& x, int n) {
  const double d = n == 1 ? 1.0 : n * ipow(x.v, n - 1);
  return scale(x, d, ipow(x.v, n));
}

template <int N>
PT_HD DualN<N> dsqrt(const DualN<N>& x) {
  const double v = sqrt(x.v);
  return scale(x, 0.5 / v, v);
}
template <int N>
PT_HD DualN<N> dexp(const DualN<N>& x) {
  const double v = exp(x.v);
  return scale(x, v, v);
}
template <int N>
PT_HD DualN<N> dlog(const DualN<N>& x) {
  return scale(x, 1.0 / x.v, log(x.v));
}
template <int N>
PT_HD DualN<N> datan(const DualN<N>& x) {
  return scale(x, 1.0 / (1.0 + x.v * x.v), atan(x.v));
}
template <int N>
PT_HD DualN<N> dasinh(const DualN<N>& x) {
  return scale(x, 1.0 / sqrt(x.v * x.v + 1.0), asinh(x.v));
}
template <int N>
PT_HD DualN<N> derf(const DualN<N>& x) {
  constexpr double TWO_OVER_SQRT_PI = 1.1283791670955126;
  return scale(x, TWO_OVER_SQRT_PI * exp(-(x.v * x.v)), erf(x.v));
}
template <int N>
PT_HD DualN<N> dlog1p(const DualN<N>& x) {
  return scale(x, 1.0 / (x.v + 1.0), log1p(x.v));
}
template <int N>
PT_HD DualN<N> dexpm1(const DualN<N>& x) {
  const double v = expm1(x.v);
  return scale(x, v + 1.0, v);
}
template <int N>
PT_HD DualN<N> dmax(const DualN<N>& x, double c) {
  if (x.v > c) return x;
  if (x.v < c) return cst_n<N>(c);
  return scale(x, 0.5, c);
}
template <int N>
PT_HD DualN<N> dmin(const DualN<N>& x, double c) {
  if (x.v < c) return x;
  if (x.v > c) return cst_n<N>(c);
  return scale(x, 0.5, c);
}

// a constant of x's type
template <int N>
PT_HD DualN<N> cst_like(const DualN<N>&, double c) {
  return cst_n<N>(c);
}

// ---- second-order dual numbers with N tangents ------------------------------
//
// h holds the upper triangle of the Hessian row by row: h[k] is d2/dx_i dx_j
// for the k-th pair (i, j), i <= j, in the order of the double loop.

template <int N>
struct HDualN {
  static constexpr int M = N * (N + 1) / 2;
  double v;      // value
  double d[N];   // first derivatives
  double h[M];   // second derivatives, packed upper triangle
};

template <int N>
PT_HD HDualN<N> hcst(double c) {
  HDualN<N> r;
  r.v = c;
  for (int k = 0; k < N; ++k) r.d[k] = 0.0;
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = 0.0;
  return r;
}

// the independent variable x_i at the value v
template <int N>
PT_HD HDualN<N> hvar(double v, int i) {
  HDualN<N> r = hcst<N>(v);
  r.d[i] = 1.0;
  return r;
}

// f(x) by the chain rule from f(x.v) = f0, f'(x.v) = f1, f''(x.v) = f2
template <int N>
PT_HD HDualN<N> hchain(const HDualN<N>& x, double f0, double f1, double f2) {
  HDualN<N> r;
  r.v = f0;
  for (int k = 0; k < N; ++k) r.d[k] = f1 * x.d[k];
  int k = 0;
  for (int i = 0; i < N; ++i)
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = f1 * x.h[k] + f2 * (x.d[i] * x.d[j]);
  return r;
}

template <int N>
PT_HD HDualN<N> operator+(const HDualN<N>& a, const HDualN<N>& b) {
  HDualN<N> r;
  r.v = a.v + b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = a.h[k] + b.h[k];
  return r;
}
template <int N>
PT_HD HDualN<N> operator-(const HDualN<N>& a, const HDualN<N>& b) {
  HDualN<N> r;
  r.v = a.v - b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = a.h[k] - b.h[k];
  return r;
}
template <int N>
PT_HD HDualN<N> operator-(const HDualN<N>& a) {
  HDualN<N> r;
  r.v = -a.v;
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = -a.h[k];
  return r;
}
template <int N>
PT_HD HDualN<N> operator*(const HDualN<N>& a, const HDualN<N>& b) {
  HDualN<N> r;
  r.v = a.v * b.v;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  int k = 0;
  for (int i = 0; i < N; ++i)
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = a.h[k] * b.v + (a.d[i] * b.d[j] + a.d[j] * b.d[i])
               + a.v * b.h[k];
  return r;
}
// q = a / b from a = q b: q' = (a' - q b') / b,
// q'' = (a'' - q' b' - b' q' - q b'') / b
template <int N>
PT_HD HDualN<N> operator/(const HDualN<N>& a, const HDualN<N>& b) {
  HDualN<N> r;
  r.v = a.v / b.v;
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  int k = 0;
  for (int i = 0; i < N; ++i)
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = (a.h[k] - (r.d[i] * b.d[j] + r.d[j] * b.d[i])
                - r.v * b.h[k]) / b.v;
  return r;
}
template <int N>
PT_HD HDualN<N> operator+(const HDualN<N>& a, double c) {
  HDualN<N> r = a;
  r.v = a.v + c;
  return r;
}
template <int N>
PT_HD HDualN<N> operator+(double c, const HDualN<N>& a) {
  HDualN<N> r = a;
  r.v = c + a.v;
  return r;
}
template <int N>
PT_HD HDualN<N> operator-(const HDualN<N>& a, double c) {
  HDualN<N> r = a;
  r.v = a.v - c;
  return r;
}
template <int N>
PT_HD HDualN<N> operator-(double c, const HDualN<N>& a) {
  HDualN<N> r = -a;
  r.v = c - a.v;
  return r;
}
template <int N>
PT_HD HDualN<N> operator*(const HDualN<N>& a, double c) {
  HDualN<N> r;
  r.v = a.v * c;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * c;
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = a.h[k] * c;
  return r;
}
template <int N>
PT_HD HDualN<N> operator*(double c, const HDualN<N>& a) {
  return a * c;
}
template <int N>
PT_HD HDualN<N> operator/(const HDualN<N>& a, double c) {
  HDualN<N> r;
  r.v = a.v / c;
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / c;
  for (int k = 0; k < HDualN<N>::M; ++k) r.h[k] = a.h[k] / c;
  return r;
}
template <int N>
PT_HD HDualN<N> operator/(double c, const HDualN<N>& b) {
  return hcst<N>(c) / b;
}

template <int N>
PT_HD HDualN<N> dpow(const HDualN<N>& x, double y) {
  return hchain(x, pow(x.v, y), y * pow(x.v, y - 1.0),
                y * (y - 1.0) * pow(x.v, y - 2.0));
}
template <int N>
PT_HD HDualN<N> dipow(const HDualN<N>& x, int n) {
  const double d1 = n == 1 ? 1.0 : n * ipow(x.v, n - 1);
  const double d2 = n == 1 ? 0.0 : n == 2 ? 2.0
                                          : n * (n - 1) * ipow(x.v, n - 2);
  return hchain(x, ipow(x.v, n), d1, d2);
}
template <int N>
PT_HD HDualN<N> dsqrt(const HDualN<N>& x) {
  const double v = sqrt(x.v);
  const double d1 = 0.5 / v;
  return hchain(x, v, d1, -0.5 * d1 / x.v);
}
template <int N>
PT_HD HDualN<N> dexp(const HDualN<N>& x) {
  const double v = exp(x.v);
  return hchain(x, v, v, v);
}
template <int N>
PT_HD HDualN<N> dlog(const HDualN<N>& x) {
  const double d1 = 1.0 / x.v;
  return hchain(x, log(x.v), d1, -d1 * d1);
}
template <int N>
PT_HD HDualN<N> datan(const HDualN<N>& x) {
  const double d1 = 1.0 / (1.0 + x.v * x.v);
  return hchain(x, atan(x.v), d1, -2.0 * x.v * d1 * d1);
}
template <int N>
PT_HD HDualN<N> dasinh(const HDualN<N>& x) {
  const double d1 = 1.0 / sqrt(x.v * x.v + 1.0);
  return hchain(x, asinh(x.v), d1, -x.v * d1 * d1 * d1);
}
template <int N>
PT_HD HDualN<N> derf(const HDualN<N>& x) {
  constexpr double TWO_OVER_SQRT_PI = 1.1283791670955126;
  const double d1 = TWO_OVER_SQRT_PI * exp(-(x.v * x.v));
  return hchain(x, erf(x.v), d1, -2.0 * x.v * d1);
}
template <int N>
PT_HD HDualN<N> dlog1p(const HDualN<N>& x) {
  const double d1 = 1.0 / (x.v + 1.0);
  return hchain(x, log1p(x.v), d1, -d1 * d1);
}
template <int N>
PT_HD HDualN<N> dexpm1(const HDualN<N>& x) {
  const double v = expm1(x.v);
  return hchain(x, v, v + 1.0, v + 1.0);
}
template <int N>
PT_HD HDualN<N> dmax(const HDualN<N>& x, double c) {
  if (x.v > c) return x;
  if (x.v < c) return hcst<N>(c);
  return hchain(x, c, 0.5, 0.0);
}
template <int N>
PT_HD HDualN<N> dmin(const HDualN<N>& x, double c) {
  if (x.v < c) return x;
  if (x.v > c) return hcst<N>(c);
  return hchain(x, c, 0.5, 0.0);
}
template <int N>
PT_HD HDualN<N> cst_like(const HDualN<N>&, double c) {
  return hcst<N>(c);
}

// ---- the components, for D = DualN<N> --------------------------------------

template <class D>
PT_HD D rs_of(const D& rho) {
  return dpow(3.0 / ((4.0 * PI) * dmax(rho, TINY)), 1.0 / 3.0);
}

// Slater exchange, spin-scaled
template <class D>
PT_XC D lda_x(const D& ra, const D& rb) {
  constexpr double CX = -0.7385587663820223;  // -(3/4) (3/pi)^(1/3)
  D e = cst_like(ra, 0.0);
  const D* rs[2] = {&ra, &rb};
  for (int k = 0; k < 2; ++k) {
    const D r2 = dmax(2.0 * *rs[k], TINY);
    e = e + (0.5 * CX) * dpow(r2, 4.0 / 3.0);
  }
  return e;
}

template <class D>
PT_HD D vwn_eps(const D& rs, double A, double x0, double b,
                      double c) {
  const D x = dsqrt(rs);
  const D X = x * x + b * x + c;
  const double X0 = x0 * x0 + b * x0 + c;
  const double Q = sqrt(4 * c - b * b);
  const D atanq = datan(Q / (2.0 * x + b));
  return A * (dlog(x * x / X) + 2 * b / Q * atanq
              - b * x0 / X0 * (dlog(dipow(x - x0, 2) / X)
                               + 2 * (b + 2 * x0) / Q * atanq));
}

template <class D>
PT_HD D f_zeta(const D& zeta) {
  constexpr double DEN = 0.5198420997897464;  // 2^(4/3) - 2
  return (dpow(1.0 + zeta, 4.0 / 3.0) + dpow(1.0 - zeta, 4.0 / 3.0) - 2.0)
         / DEN;
}

template <class D>
PT_HD D zeta_of(const D& ra, const D& rb,
                      const D& rho) {
  return dmin(dmax((ra - rb) / rho, -1 + 1e-15), 1 - 1e-15);
}

template <class D>
PT_XC D vwn5_c(const D& ra, const D& rb) {
  const D rho = dmax(ra + rb, TINY);
  const D zeta = zeta_of(ra, rb, rho);
  const D rs = rs_of(rho);
  const D ep = vwn_eps(rs, 0.0310907, -0.10498, 3.72744, 12.9352);
  const D ef = vwn_eps(rs, 0.01554535, -0.32500, 7.06042, 18.0578);
  // A = -1 / (6 pi^2)
  const D ea = vwn_eps(rs, -0.01688686394038963, -0.00475840, 1.13107,
                          13.0045);
  const D f = f_zeta(zeta);
  constexpr double FPP0 = 1.7099209341613653;  // 4 / (9 (2^(1/3) - 1))
  const D z4 = dipow(zeta, 4);
  const D eps = ep + ea * f / FPP0 * (1.0 - z4) + (ef - ep) * f * z4;
  return rho * eps;
}

// VWN III (RPA): the correlation of the original B3LYP
template <class D>
PT_XC D vwn3_c(const D& ra, const D& rb) {
  const D rho = dmax(ra + rb, TINY);
  const D zeta = zeta_of(ra, rb, rho);
  const D rs = rs_of(rho);
  const D ep = vwn_eps(rs, 0.0310907, -0.409286, 13.0720, 42.7198);
  const D ef = vwn_eps(rs, 0.01554535, -0.743294, 20.1231, 101.578);
  const D f = f_zeta(zeta);
  const D eps = ep + (ef - ep) * f;
  return rho * eps;
}

template <class D>
PT_XC D b88_x(const D& ra, const D& rb,
                    const D& saa, const D& sbb) {
  constexpr double beta = 0.0042;
  constexpr double LDA = -0.9305257363491002;  // -(3/2) (3/(4 pi))^(1/3)
  D e = cst_like(ra, 0.0);
  const D* rr[2] = {&ra, &rb};
  const D* ss[2] = {&saa, &sbb};
  for (int k = 0; k < 2; ++k) {
    const D r = dmax(*rr[k], TINY);
    const D r43 = dpow(r, 4.0 / 3.0);
    const D x = dsqrt(dmax(*ss[k], TINY)) / r43;
    const D lda = LDA * r43;
    const D corr =
        -beta * r43 * x * x / (1.0 + 6 * beta * x * dasinh(x));
    e = e + lda + corr;
  }
  return e;
}

// PBE exchange, spin-scaled: half the unpolarized term at 2 rho_s and
// 4 sigma_ss for each spin
constexpr double THREE_PI2 = 29.608813203268074;  // 3 pi^2

template <class D>
PT_XC D pbe_x(const D& ra, const D& rb, const D& saa, const D& sbb) {
  constexpr double kappa = 0.8040, mu = 0.2195149727645171;
  constexpr double CX = -0.7385587663820223;  // -(3/4) (3/pi)^(1/3)
  D e = cst_like(ra, 0.0);
  const D* rr[2] = {&ra, &rb};
  const D* ss[2] = {&saa, &sbb};
  for (int k = 0; k < 2; ++k) {
    const D r2 = dmax(2.0 * *rr[k], TINY);
    const D s2 = 4.0 * dmax(*ss[k], 0.0);
    const D kf = dpow(THREE_PI2 * r2, 1.0 / 3.0);
    const D ss2 = s2 / dipow(2.0 * kf * r2, 2);
    const D fx = (1.0 + kappa) - kappa / (1.0 + mu * ss2 / kappa);
    const D ex_lda = CX * dpow(r2, 4.0 / 3.0);
    e = e + 0.5 * ex_lda * fx;
  }
  return e;
}

// LYP correlation, Miehlich et al. CPL 157, 200 form
template <class D>
PT_XC D lyp_c(const D& rho_a, const D& rho_b,
                    const D& gaa, const D& gab,
                    const D& gbb) {
  constexpr double a = 0.04918, b = 0.132, c = 0.2533, d = 0.349;
  constexpr double C113CF = 36.46239897876477;  // 2^(11/3) 0.3 (3 pi^2)^(2/3)
  const D rho = dmax(rho_a + rho_b, TINY);
  const D rm3 = dpow(rho, -1.0 / 3.0);
  const D w = dexp(-c * rm3) / (1.0 + d * rm3) * dipow(rm3, 11);
  const D dl = c * rm3 + d * rm3 / (1.0 + d * rm3);
  const D ra = dmax(rho_a, TINY), rb = dmax(rho_b, TINY);
  const D gsum = gaa + 2 * gab + gbb;
  const D e = -a * (4.0 * ra * rb / (rho * (1.0 + d * rm3))
                       + b * w * (
      ra * rb * (
          C113CF * (dpow(ra, 8.0 / 3.0) + dpow(rb, 8.0 / 3.0))
          + (47.0 / 18.0 - 7.0 / 18.0 * dl) * gsum
          - (2.5 - dl / 18.0) * (gaa + gbb)
          - (dl - 11.0) / 9.0 * (ra / rho * gaa + rb / rho * gbb))
      - 2.0 / 3.0 * rho * rho * gsum
      + (2.0 / 3.0 * rho * rho - ra * ra) * gbb
      + (2.0 / 3.0 * rho * rho - rb * rb) * gaa));
  return e;
}

// ---- the range-separated and B97 power-series components -----------------

template <class D>
PT_HD D pw92_g(const D& rs, double A, double a1, double b1, double b2,
               double b3, double b4) {
  const D s = dsqrt(rs);
  const D den = 2.0 * A * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs);
  return -2.0 * A * (1.0 + a1 * rs) * dlog1p(1.0 / dmax(den, TINY));
}

template <class D>
PT_HD D pw92_eps(const D& ra, const D& rb) {
  const D rho = dmax(ra + rb, TINY);
  const D zeta = zeta_of(ra, rb, rho);
  const D rs = rs_of(rho);
  const D e0 = pw92_g(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382,
                      0.49294);
  const D e1 = pw92_g(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662,
                      0.62517);
  const D alc = -pw92_g(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026,
                        0.49671);
  const D f = f_zeta(zeta);
  constexpr double FPP0 = 1.709920934161365617563962776245;
  const D z4 = dipow(zeta, 4);
  return e0 + alc * f / FPP0 * (1.0 - z4) + (e1 - e0) * f * z4;
}

// PBE correlation on PW92; sigma = sigma_aa + 2 sigma_ab + sigma_bb
template <class D>
PT_XC D pbe_c(const D& ra, const D& rb, const D& sigma) {
  constexpr double beta = 0.06672455060314922;
  constexpr double gamma = 0.0310906908696549;  // (1 - log 2) / pi^2
  const D rho = dmax(ra + rb, TINY);
  const D zeta = zeta_of(ra, rb, rho);
  const D eps = pw92_eps(ra, rb);
  const D phi = 0.5 * (dpow(1.0 + zeta, 2.0 / 3.0)
                       + dpow(1.0 - zeta, 2.0 / 3.0));
  const D kf = dpow(THREE_PI2 * rho, 1.0 / 3.0);
  const D ks = dsqrt(4.0 * kf / PI);
  const D t2 = dmax(sigma, 0.0) / dipow(2.0 * phi * ks * rho, 2);
  const D phi3 = dipow(phi, 3);
  const D A = (beta / gamma) / dmax(dexpm1(-eps / (gamma * phi3)), TINY);
  const D u = A * t2;
  const D H = gamma * phi3
              * dlog1p((beta / gamma) * t2 * (1.0 + u) / (1.0 + u + u * u));
  return rho * (eps + H);
}

// F(a): the fraction of exchange that survives erfc(w r)/r attenuation, a
// clipped to [1e-10, 50]. At large a the bracket is a difference of terms
// near 1e8 that leaves ~1e-5, so F carries ~1e-3 relative rounding there,
// in the JAX package as here: the expression order is kept.
template <class D>
PT_HD D sr_attenuation(const D& a_in) {
  constexpr double SQRT_PI = 1.7724538509055159;
  const D a = dmin(dmax(a_in, 1e-10), 50.0);
  const D a2 = a * a;
  const D expf = dexp(-dmin(1.0 / (4.0 * a2), 700.0));
  const D erfv = derf(1.0 / (2.0 * a));
  const D a3 = dipow(a, 3);
  return 1.0 - (8.0 / 3.0) * a * (SQRT_PI * erfv - 3.0 * a + 4.0 * a3
                                  + (2.0 * a - 4.0 * a3) * expf);
}

// B88 with the CAM partition of 1/r12: the DFT part keeps
// [1 - alpha - beta + beta F(a_sigma)] of the full B88 energy density.
template <class D>
PT_XC D cam_b88_x(const D& ra, const D& rb, const D& saa, const D& sbb,
                  double omega, double alpha, double beta) {
  constexpr double bbeta = 0.0042;
  constexpr double LDA = -0.9305257363491002;  // -(3/2) (3/(4 pi))^(1/3)
  D e = cst_like(ra, 0.0);
  const D* rr[2] = {&ra, &rb};
  const D* ss[2] = {&saa, &sbb};
  for (int k = 0; k < 2; ++k) {
    const D r = dmax(*rr[k], TINY);
    const D r43 = dpow(r, 4.0 / 3.0);
    const D x = dsqrt(dmax(*ss[k], TINY)) / r43;
    const D lda = LDA * r43;
    const D corr =
        -bbeta * r43 * x * x / (1.0 + 6 * bbeta * x * dasinh(x));
    const D e_full = lda + corr;
    const D K = dmax(-2.0 * e_full / r43, TINY);
    const D k_sig = dsqrt(9.0 * PI / K) * dpow(r, 1.0 / 3.0);
    const D a = omega / (2.0 * k_sig);
    const D F = sr_attenuation(a);
    e = e + e_full * (1.0 - alpha - beta + beta * F);
  }
  return e;
}

template <class D>
PT_HD D b97_u(const D& s2, double gamma) {
  const D gs = gamma * s2;
  return gs / (1.0 + gs);
}

// sum_i c_i u^i by Horner over NSERIES coefficients; the trailing zeros of
// a shorter series leave the value and its tangents exactly as they are
constexpr int NSERIES = 5;

template <class D>
PT_HD D b97_series(const D& u, const double* c) {
  D acc = cst_like(u, 0.0);
  for (int k = NSERIES - 1; k >= 0; --k) acc = acc * u + c[k];
  return acc;
}

// The omega-B97 family's semilocal part. p = [omega, alpha, beta,
// cx[5], css[5], cos[5]] (alpha and beta unused here).
template <class D>
PT_XC D wb97_xc(const D& ra, const D& rb, const D& saa, const D& sab,
                const D& sbb, const double* p) {
  constexpr double gam_x = 0.004, gam_ss = 0.2, gam_os = 0.006;
  constexpr double ELDA = -0.9305257363491002;  // -1.5 (3/(4 pi))^(1/3)
  constexpr double SIX_PI2 = 59.21762640653615;  // 6 pi^2
  const double omega = p[0];
  const double* cx = p + 3;
  const double* css = p + 3 + NSERIES;
  const double* cos_ = p + 3 + 2 * NSERIES;
  D e = cst_like(ra, 0.0);
  D s2s[2];
  const D* rr[2] = {&ra, &rb};
  const D* ss[2] = {&saa, &sbb};
  for (int k = 0; k < 2; ++k) {
    const D r = dmax(*rr[k], TINY);
    const D s = dmax(*ss[k], 0.0);
    const D s2 = s / dpow(r, 8.0 / 3.0);
    s2s[k] = s2;
    const D e_lda = ELDA * dpow(r, 4.0 / 3.0);
    const D kf = dpow(SIX_PI2 * r, 1.0 / 3.0);
    const D Fa = sr_attenuation(omega / (2.0 * kf));
    const D gx = b97_series(b97_u(s2, gam_x), cx);
    e = e + e_lda * Fa * gx;
  }
  // Stoll partition of PW92 correlation
  const D z = cst_like(ra, TINY);
  const D ec_ab = (ra + rb) * pw92_eps(ra, rb);
  const D ec_aa = ra * pw92_eps(ra, z);
  const D ec_bb = rb * pw92_eps(z, rb);
  const D g_ss_a = b97_series(b97_u(s2s[0], gam_ss), css);
  const D g_ss_b = b97_series(b97_u(s2s[1], gam_ss), css);
  const D u_os = b97_u(0.5 * (s2s[0] + s2s[1]), gam_os);
  const D g_os = b97_series(u_os, cos_);
  return e + ec_aa * g_ss_a + ec_bb * g_ss_b
         + (ec_ab - ec_aa - ec_bb) * g_os;
}

// Component ids, as pyscf_tpu_torch/ops/kernels.py names them.
enum Component {
  SLATER = 0, VWN5 = 1, VWN3 = 2, B88 = 3, LYP = 4, CAM_B88 = 5, WB97 = 6,
  PBE_X = 7, PBE_C = 8
};

constexpr int MAXTERM = 8;
// parameters per term: omega, alpha, beta and three series of NSERIES
constexpr int NPARAM = 3 + 3 * NSERIES;

struct Terms {
  int n;
  int id[MAXTERM];
  double c[MAXTERM];
  double p[MAXTERM][NPARAM];
};

// The weighted sum of the terms at (rho_a, rho_b, sigma_aa, sigma_ab,
// sigma_bb) = (a, b, xaa, xab, xbb), in their listed order; RSH compiles in
// CAM_B88 and WB97, GGA the gradient components (without it only SLATER,
// VWN5 and VWN3, which is all that make_terms lets an LDA launch take: a
// kernel's LDA instantiation then compiles a fraction of the code).
template <bool RSH, bool GGA = true, class D>
PT_HD D edens_terms(const Terms& t, const D& a, const D& b, const D& xaa,
                    const D& xab, const D& xbb) {
  D e = cst_like(a, 0.0);
  for (int k = 0; k < t.n; ++k) {
    D f = cst_like(a, 0.0);
    switch (t.id[k]) {
      case SLATER: f = lda_x(a, b); break;
      case VWN5: f = vwn5_c(a, b); break;
      case VWN3: f = vwn3_c(a, b); break;
      case B88:
        if constexpr (GGA) f = b88_x(a, b, xaa, xbb);
        break;
      case LYP:
        if constexpr (GGA) f = lyp_c(a, b, xaa, xab, xbb);
        break;
      case PBE_X:
        if constexpr (GGA) f = pbe_x(a, b, xaa, xbb);
        break;
      case PBE_C:
        if constexpr (GGA) f = pbe_c(a, b, xaa + 2.0 * xab + xbb);
        break;
      default:
        if constexpr (RSH && GGA) {
          if (t.id[k] == CAM_B88) {
            f = cam_b88_x(a, b, xaa, xbb, t.p[k][0], t.p[k][1], t.p[k][2]);
          } else {
            f = wb97_xc(a, b, xaa, xab, xbb, t.p[k]);
          }
        }
        break;
    }
    e = e + t.c[k] * f;
  }
  return e;
}

// Closed-shell energy density with its derivatives: e.v = e_xc(rho, sigma),
// e.d = (vrho, vsigma).
template <bool RSH = false>
PT_HD DualN<2> edens_closed(const Terms& t, double rho, double sigma) {
  const DualN<2> ra = 0.5 * DualN<2>{rho, {1.0, 0.0}};
  const DualN<2> s4 = 0.25 * DualN<2>{sigma, {0.0, 1.0}};
  return edens_terms<RSH>(t, ra, ra, s4, s4, s4);
}

// Spin-polarized energy density with its five derivatives: e.v = e_xc,
// e.d = (vrho_a, vrho_b, vsigma_aa, vsigma_ab, vsigma_bb), the numbers
// jax.grad gives at pyscf_tpu/dft/numint.py:239-240 and :278-279.
template <bool RSH = false>
PT_HD DualN<5> edens_open(const Terms& t, double ra, double rb, double saa,
                          double sab, double sbb) {
  const DualN<5> a{ra, {1.0, 0.0, 0.0, 0.0, 0.0}};
  const DualN<5> b{rb, {0.0, 1.0, 0.0, 0.0, 0.0}};
  const DualN<5> xaa{saa, {0.0, 0.0, 1.0, 0.0, 0.0}};
  const DualN<5> xab{sab, {0.0, 0.0, 0.0, 1.0, 0.0}};
  const DualN<5> xbb{sbb, {0.0, 0.0, 0.0, 0.0, 1.0}};
  return edens_terms<RSH>(t, a, b, xaa, xab, xbb);
}

// The same with second derivatives, for the B3LYP and PBE families (the
// response and Hessian kernels take no range-separated component; GGA as
// edens_terms's): h = (e_rr, e_rs, e_ss) of (rho, sigma) ...
template <bool GGA = true>
PT_HD HDualN<2> edens_closed2(const Terms& t, double rho, double sigma) {
  const HDualN<2> ra = 0.5 * hvar<2>(rho, 0);
  const HDualN<2> s4 = 0.25 * hvar<2>(sigma, 1);
  return edens_terms<false, GGA>(t, ra, ra, s4, s4, s4);
}

// ... and the 15 of (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb)
template <bool GGA = true>
PT_HD HDualN<5> edens_open2(const Terms& t, double ra, double rb, double saa,
                            double sab, double sbb) {
  return edens_terms<false, GGA>(t, hvar<5>(ra, 0), hvar<5>(rb, 1),
                                 hvar<5>(saa, 2), hvar<5>(sab, 3),
                                 hvar<5>(sbb, 4));
}

}  // namespace ptxc
