// Second nuclear derivatives of one cartesian McMurchie-Davidson term, shared
// by int1e_ipip.cu and the Coulomb kernels of coulomb_ipip.cuh.
//
// An integral of the cartesian bra component i (shell on A, exponent a)
// and ket component j reads I(i, j) = sum_tuv E^{ij}_tuv y[tuv], with the
// bra pair's Hermite tables E and Hermite weights y[tuv] that hold the
// operator's centre C: R_tuv(p, P - C) for a point charge, the folded aux
// shell for a three-centre integral. Then
//   d/dC_x I = -sum_tuv E_tuv y[tuv + e_x]       (y is a function of P - C)
//   d/dA_x I(i) = 2a I(i + e_x) - i_x I(i - e_x)  (power-shift rule),
// so every second derivative on A and C is a sum of I of shifted bra
// components against shifted weights:
//   AA_xy = d2/dA_x dA_y,  AC_xy = d2/dA_x dC_y,  CC_xy = d2/dC_x dC_y.
// The third centre B follows by translational invariance, d/dB =
// -(d/dA + d/dC); the callers assemble it.
#pragma once
#include "hermite.cuh"

// sum_tuv E^x[ix, jx][t] E^y[iy, jy][u] E^z[iz, jz][v] y[(t, u, v) + s],
// zero for a negative bra power. The tables are e1d<LE, NJ - 1>: entry
// E[(i * NJ + j) * NT + t].
template <int NJ, int NT>
__device__ __forceinline__ double herm_sum(const double* Ex,
                                           const double* Ey,
                                           const double* Ez, int ix, int iy,
                                           int iz, int jx, int jy, int jz,
                                           const double* y, int sx, int sy,
                                           int sz) {
  if (ix < 0 || iy < 0 || iz < 0) return 0.0;
  const double* ex = Ex + (ix * NJ + jx) * NT;
  const double* ey = Ey + (iy * NJ + jy) * NT;
  const double* ez = Ez + (iz * NJ + jz) * NT;
  double s = 0.0;
  for (int t = 0; t <= ix + jx; ++t) {
    for (int u = 0; u <= iy + jy; ++u) {
      const double exy = ex[t] * ey[u];
      for (int v = 0; v <= iz + jz; ++v) {
        s += exy * ez[v] * y[tuv_idx(t + sx, u + sy, v + sz)];
      }
    }
  }
  return s;
}

// Adds g times the second derivatives of I(i, j) to cc[9] and, with
// WITH_A, to aa[9] and ac[9] (row x, column y). y must hold Hermite orders
// up to |i| + |j| + 2; the tables bra powers up to |i| + 2.
template <int NJ, int NT, bool WITH_A>
__device__ __forceinline__ void hess_terms(double a, const double* Ex,
                                           const double* Ey,
                                           const double* Ez, const int* i,
                                           const int* j, const double* y,
                                           double g, double* aa, double* ac,
                                           double* cc) {
  const int e[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int x = 0; x < 3; ++x) {
    for (int z = x; z < 3; ++z) {
      const double v = g * herm_sum<NJ, NT>(
          Ex, Ey, Ez, i[0], i[1], i[2], j[0], j[1], j[2], y,
          e[x][0] + e[z][0], e[x][1] + e[z][1], e[x][2] + e[z][2]);
      cc[x * 3 + z] += v;
      if (z != x) cc[z * 3 + x] += v;
    }
  }
  if constexpr (WITH_A) {
    const double a2 = 2.0 * a;
    for (int x = 0; x < 3; ++x) {
      for (int z = 0; z < 3; ++z) {
        // d/dA_x of -sum E y[tuv + e_z]
        const double up = herm_sum<NJ, NT>(
            Ex, Ey, Ez, i[0] + e[x][0], i[1] + e[x][1], i[2] + e[x][2], j[0],
            j[1], j[2], y, e[z][0], e[z][1], e[z][2]);
        const double dn = i[x] > 0 ? herm_sum<NJ, NT>(
            Ex, Ey, Ez, i[0] - e[x][0], i[1] - e[x][1], i[2] - e[x][2],
            j[0], j[1], j[2], y, e[z][0], e[z][1], e[z][2]) : 0.0;
        ac[x * 3 + z] -= g * (a2 * up - i[x] * dn);
      }
    }
    for (int x = 0; x < 3; ++x) {
      for (int z = x; z < 3; ++z) {
        // D_x D_z I(i), D = 2a (+e) - i (-e), applied twice
        double v = 0.0;
        for (int sz = -1; sz <= 1; sz += 2) {
          for (int sx = -1; sx <= 1; sx += 2) {
            int k[3] = {i[0], i[1], i[2]};
            double c = 1.0;
            // the step along z, then the step along x on the shifted power
            if (sz < 0 && k[z] == 0) continue;
            c *= sz > 0 ? a2 : -k[z];
            k[z] += sz;
            if (sx < 0 && k[x] == 0) continue;
            c *= sx > 0 ? a2 : -k[x];
            k[x] += sx;
            v += c * herm_sum<NJ, NT>(Ex, Ey, Ez, k[0], k[1], k[2], j[0],
                                      j[1], j[2], y, 0, 0, 0);
          }
        }
        aa[x * 3 + z] += g * v;
        if (z != x) aa[z * 3 + x] += g * v;
      }
    }
  }
}
