// The B3LYP components on forward-mode dual numbers.
//
// Device counterpart of pyscf_tpu/dft/xc_funcs.py (lda_x, _vwn_eps,
// _f_zeta, vwn5_c, vwn3_c, b88_x, lyp_c, _rs) and of their torch versions
// in pyscf_tpu_torch/dft/xc_funcs.py. Each component is written once, in
// the JAX package's expression order and with its clamps, over a dual
// number that carries the value and two tangents: d/drho and d/dsigma of
// the closed-shell energy density, seeded through rho_a = rho_b = rho/2 and
// sigma_aa = sigma_ab = sigma_bb = sigma/4. One evaluation gives e_xc,
// vrho and vsigma, the numbers jax.grad gives at pyscf_tpu/dft/numint.py
// :135-137. The derivative rules are JAX's: pow(x, y)' = y pow(x, y-1),
// integer powers by repeated squaring with (x^n)' = n x^(n-1), and a
// maximum or minimum at a tie passes half the tangent.
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

struct Dual {
  double v, r, s;   // value, d/drho, d/dsigma
};

PT_HD Dual cst(double c) { return Dual{c, 0.0, 0.0}; }
PT_HD Dual scale(const Dual& x, double d, double v) {
  return Dual{v, d * x.r, d * x.s};
}

PT_HD Dual operator+(const Dual& a, const Dual& b) {
  return Dual{a.v + b.v, a.r + b.r, a.s + b.s};
}
PT_HD Dual operator-(const Dual& a, const Dual& b) {
  return Dual{a.v - b.v, a.r - b.r, a.s - b.s};
}
PT_HD Dual operator-(const Dual& a) { return Dual{-a.v, -a.r, -a.s}; }
PT_HD Dual operator*(const Dual& a, const Dual& b) {
  return Dual{a.v * b.v, a.r * b.v + a.v * b.r, a.s * b.v + a.v * b.s};
}
PT_HD Dual operator/(const Dual& a, const Dual& b) {
  const double q = a.v / b.v;
  return Dual{q, (a.r - q * b.r) / b.v, (a.s - q * b.s) / b.v};
}
PT_HD Dual operator+(const Dual& a, double c) { return Dual{a.v + c, a.r, a.s}; }
PT_HD Dual operator+(double c, const Dual& a) { return Dual{c + a.v, a.r, a.s}; }
PT_HD Dual operator-(const Dual& a, double c) { return Dual{a.v - c, a.r, a.s}; }
PT_HD Dual operator-(double c, const Dual& a) {
  return Dual{c - a.v, -a.r, -a.s};
}
PT_HD Dual operator*(const Dual& a, double c) {
  return Dual{a.v * c, a.r * c, a.s * c};
}
PT_HD Dual operator*(double c, const Dual& a) {
  return Dual{c * a.v, c * a.r, c * a.s};
}
PT_HD Dual operator/(const Dual& a, double c) {
  return Dual{a.v / c, a.r / c, a.s / c};
}
PT_HD Dual operator/(double c, const Dual& b) {
  const double q = c / b.v;
  return Dual{q, (-q * b.r) / b.v, (-q * b.s) / b.v};
}

// x**y for a float exponent y
PT_HD Dual dpow(const Dual& x, double y) {
  return scale(x, y * pow(x.v, y - 1.0), pow(x.v, y));
}

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
PT_HD Dual dipow(const Dual& x, int n) {
  const double d = n == 1 ? 1.0 : n * ipow(x.v, n - 1);
  return scale(x, d, ipow(x.v, n));
}

PT_HD Dual dsqrt(const Dual& x) {
  const double v = sqrt(x.v);
  return scale(x, 0.5 / v, v);
}
PT_HD Dual dexp(const Dual& x) {
  const double v = exp(x.v);
  return scale(x, v, v);
}
PT_HD Dual dlog(const Dual& x) { return scale(x, 1.0 / x.v, log(x.v)); }
PT_HD Dual datan(const Dual& x) {
  return scale(x, 1.0 / (1.0 + x.v * x.v), atan(x.v));
}
PT_HD Dual dasinh(const Dual& x) {
  return scale(x, 1.0 / sqrt(x.v * x.v + 1.0), asinh(x.v));
}
PT_HD Dual dmax(const Dual& x, double c) {
  if (x.v > c) return x;
  if (x.v < c) return cst(c);
  return scale(x, 0.5, c);
}
PT_HD Dual dmin(const Dual& x, double c) {
  if (x.v < c) return x;
  if (x.v > c) return cst(c);
  return scale(x, 0.5, c);
}

PT_HD Dual rs_of(const Dual& rho) {
  return dpow(3.0 / ((4.0 * PI) * dmax(rho, TINY)), 1.0 / 3.0);
}

// Slater exchange, spin-scaled
PT_HD Dual lda_x(const Dual& ra, const Dual& rb) {
  constexpr double CX = -0.7385587663820223;  // -(3/4) (3/pi)^(1/3)
  Dual e = cst(0.0);
  const Dual* rs[2] = {&ra, &rb};
  for (int k = 0; k < 2; ++k) {
    const Dual r2 = dmax(2.0 * *rs[k], TINY);
    e = e + (0.5 * CX) * dpow(r2, 4.0 / 3.0);
  }
  return e;
}

PT_HD Dual vwn_eps(const Dual& rs, double A, double x0, double b, double c) {
  const Dual x = dsqrt(rs);
  const Dual X = x * x + b * x + c;
  const double X0 = x0 * x0 + b * x0 + c;
  const double Q = sqrt(4 * c - b * b);
  const Dual atanq = datan(Q / (2.0 * x + b));
  return A * (dlog(x * x / X) + 2 * b / Q * atanq
              - b * x0 / X0 * (dlog(dipow(x - x0, 2) / X)
                               + 2 * (b + 2 * x0) / Q * atanq));
}

PT_HD Dual f_zeta(const Dual& zeta) {
  constexpr double DEN = 0.5198420997897464;  // 2^(4/3) - 2
  return (dpow(1.0 + zeta, 4.0 / 3.0) + dpow(1.0 - zeta, 4.0 / 3.0) - 2.0)
         / DEN;
}

PT_HD Dual zeta_of(const Dual& ra, const Dual& rb, const Dual& rho) {
  return dmin(dmax((ra - rb) / rho, -1 + 1e-15), 1 - 1e-15);
}

PT_HD Dual vwn5_c(const Dual& ra, const Dual& rb) {
  const Dual rho = dmax(ra + rb, TINY);
  const Dual zeta = zeta_of(ra, rb, rho);
  const Dual rs = rs_of(rho);
  const Dual ep = vwn_eps(rs, 0.0310907, -0.10498, 3.72744, 12.9352);
  const Dual ef = vwn_eps(rs, 0.01554535, -0.32500, 7.06042, 18.0578);
  // A = -1 / (6 pi^2)
  const Dual ea = vwn_eps(rs, -0.01688686394038963, -0.00475840, 1.13107,
                          13.0045);
  const Dual f = f_zeta(zeta);
  constexpr double FPP0 = 1.7099209341613653;  // 4 / (9 (2^(1/3) - 1))
  const Dual z4 = dipow(zeta, 4);
  const Dual eps = ep + ea * f / FPP0 * (1.0 - z4) + (ef - ep) * f * z4;
  return rho * eps;
}

// VWN III (RPA): the correlation of the original B3LYP
PT_HD Dual vwn3_c(const Dual& ra, const Dual& rb) {
  const Dual rho = dmax(ra + rb, TINY);
  const Dual zeta = zeta_of(ra, rb, rho);
  const Dual rs = rs_of(rho);
  const Dual ep = vwn_eps(rs, 0.0310907, -0.409286, 13.0720, 42.7198);
  const Dual ef = vwn_eps(rs, 0.01554535, -0.743294, 20.1231, 101.578);
  const Dual f = f_zeta(zeta);
  const Dual eps = ep + (ef - ep) * f;
  return rho * eps;
}

PT_HD Dual b88_x(const Dual& ra, const Dual& rb, const Dual& saa,
                 const Dual& sbb) {
  constexpr double beta = 0.0042;
  constexpr double LDA = -0.9305257363491002;  // -(3/2) (3/(4 pi))^(1/3)
  Dual e = cst(0.0);
  const Dual* rr[2] = {&ra, &rb};
  const Dual* ss[2] = {&saa, &sbb};
  for (int k = 0; k < 2; ++k) {
    const Dual r = dmax(*rr[k], TINY);
    const Dual r43 = dpow(r, 4.0 / 3.0);
    const Dual x = dsqrt(dmax(*ss[k], TINY)) / r43;
    const Dual lda = LDA * r43;
    const Dual corr = -beta * r43 * x * x / (1.0 + 6 * beta * x * dasinh(x));
    e = e + lda + corr;
  }
  return e;
}

// LYP correlation, Miehlich et al. CPL 157, 200 form
PT_HD Dual lyp_c(const Dual& rho_a, const Dual& rho_b, const Dual& gaa,
                 const Dual& gab, const Dual& gbb) {
  constexpr double a = 0.04918, b = 0.132, c = 0.2533, d = 0.349;
  constexpr double C113CF = 36.46239897876477;  // 2^(11/3) 0.3 (3 pi^2)^(2/3)
  const Dual rho = dmax(rho_a + rho_b, TINY);
  const Dual rm3 = dpow(rho, -1.0 / 3.0);
  const Dual w = dexp(-c * rm3) / (1.0 + d * rm3) * dipow(rm3, 11);
  const Dual dl = c * rm3 + d * rm3 / (1.0 + d * rm3);
  const Dual ra = dmax(rho_a, TINY), rb = dmax(rho_b, TINY);
  const Dual gsum = gaa + 2 * gab + gbb;
  const Dual e = -a * (4.0 * ra * rb / (rho * (1.0 + d * rm3))
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
// e.r = vrho, e.s = vsigma. The terms are summed in their listed order.
PT_HD Dual edens_closed(const Terms& t, double rho, double sigma) {
  const Dual ra = 0.5 * Dual{rho, 1.0, 0.0};
  const Dual s4 = 0.25 * Dual{sigma, 0.0, 1.0};
  Dual e = cst(0.0);
  for (int k = 0; k < t.n; ++k) {
    Dual f;
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

}  // namespace ptxc
