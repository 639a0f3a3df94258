// The B3LYP components on forward-mode dual numbers.
//
// Device counterpart of pyscf_tpu/dft/xc_funcs.py (lda_x, _vwn_eps,
// _f_zeta, vwn5_c, vwn3_c, b88_x, lyp_c, _rs) and of their torch versions
// in pyscf_tpu_torch/dft/xc_funcs.py. Each component is written once, in
// the JAX package's expression order and with its clamps, as a template
// over the dual number type DualN<N>, which carries the value and N
// tangents:
//   N = 2  d/drho and d/dsigma of the closed-shell energy density, seeded
//          through rho_a = rho_b = rho/2 and sigma_aa = sigma_ab = sigma_bb
//          = sigma/4 (edens_closed, kernel xc_rks): one evaluation gives
//          e_xc, vrho and vsigma, the numbers jax.grad gives at
//          pyscf_tpu/dft/numint.py:135-137;
//   N = 5  one for each of rho_a, rho_b, sigma_aa, sigma_ab and sigma_bb
//          (edens_open, kernel xc_uks).
// The derivative rules are JAX's: pow(x, y)' = y pow(x, y-1), integer
// powers by repeated squaring with (x^n)' = n x^(n-1), and a maximum or
// minimum at a tie passes half the tangent.
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
#endif

#define PT_HD __host__ __device__ __forceinline__

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

// ---- the components, for D = DualN<N> --------------------------------------

template <class D>
PT_HD D rs_of(const D& rho) {
  return dpow(3.0 / ((4.0 * PI) * dmax(rho, TINY)), 1.0 / 3.0);
}

// Slater exchange, spin-scaled
template <class D>
PT_HD D lda_x(const D& ra, const D& rb) {
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
PT_HD D vwn5_c(const D& ra, const D& rb) {
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
PT_HD D vwn3_c(const D& ra, const D& rb) {
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
PT_HD D b88_x(const D& ra, const D& rb,
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

// LYP correlation, Miehlich et al. CPL 157, 200 form
template <class D>
PT_HD D lyp_c(const D& rho_a, const D& rho_b,
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

// Component ids, as pyscf_tpu_torch/ops/kernels.py names them.
enum Component { SLATER = 0, VWN5 = 1, VWN3 = 2, B88 = 3, LYP = 4 };

constexpr int MAXTERM = 8;

struct Terms {
  int n;
  int id[MAXTERM];
  double c[MAXTERM];
};

// Closed-shell energy density with its derivatives: e.v = e_xc(rho, sigma),
// e.d = (vrho, vsigma). The terms are summed in their listed order.
PT_HD DualN<2> edens_closed(const Terms& t, double rho, double sigma) {
  const DualN<2> ra = 0.5 * DualN<2>{rho, {1.0, 0.0}};
  const DualN<2> s4 = 0.25 * DualN<2>{sigma, {0.0, 1.0}};
  DualN<2> e = cst_n<2>(0.0);
  for (int k = 0; k < t.n; ++k) {
    DualN<2> f;
    switch (t.id[k]) {
      case SLATER: f = lda_x(ra, ra); break;
      case VWN5: f = vwn5_c(ra, ra); break;
      case VWN3: f = vwn3_c(ra, ra); break;
      case B88: f = b88_x(ra, ra, s4, s4); break;
      default: f = lyp_c(ra, ra, s4, s4, s4); break;
    }
    e = e + t.c[k] * f;
  }
  return e;
}

// Spin-polarized energy density with its five derivatives: e.v = e_xc,
// e.d = (vrho_a, vrho_b, vsigma_aa, vsigma_ab, vsigma_bb), the numbers
// jax.grad gives at pyscf_tpu/dft/numint.py:239-240 and :278-279. The
// terms are summed in their listed order.
PT_HD DualN<5> edens_open(const Terms& t, double ra, double rb, double saa,
                          double sab, double sbb) {
  const DualN<5> a{ra, {1.0, 0.0, 0.0, 0.0, 0.0}};
  const DualN<5> b{rb, {0.0, 1.0, 0.0, 0.0, 0.0}};
  const DualN<5> xaa{saa, {0.0, 0.0, 1.0, 0.0, 0.0}};
  const DualN<5> xab{sab, {0.0, 0.0, 0.0, 1.0, 0.0}};
  const DualN<5> xbb{sbb, {0.0, 0.0, 0.0, 0.0, 1.0}};
  DualN<5> e = cst_n<5>(0.0);
  for (int k = 0; k < t.n; ++k) {
    DualN<5> f;
    switch (t.id[k]) {
      case SLATER: f = lda_x(a, b); break;
      case VWN5: f = vwn5_c(a, b); break;
      case VWN3: f = vwn3_c(a, b); break;
      case B88: f = b88_x(a, b, xaa, xbb); break;
      default: f = lyp_c(a, b, xaa, xab, xbb); break;
    }
    e = e + t.c[k] * f;
  }
  return e;
}

}  // namespace ptxc
