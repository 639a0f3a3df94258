// Cartesian overlap, kinetic and nuclear-attraction terms of one primitive
// pair, shared by int1e_stv.cu and int1e_ip.cu.
#pragma once
#include "hermite.cuh"

// Adds the primitive pair's [S, T, V] (S alone without TV) for the bra
// shell LS and the ket shell LB to acc[x * ncart(LS) * ncart(LB) + ia *
// ncart(LB) + jb]. Ex, Ey, Ez are the tables of e1d<LE, LB + 2> with
// LE >= LS, so one set of tables serves the bra shells la + 1 and la - 1 of
// a derivative; RZ[tuv] = sum_C Z_C R_tuv(p, P - C) up to order LS + LB.
// w is the product of the contraction coefficients (times 2a for a raised
// shell), b the ket exponent, p = a + b.
template <int LS, int LE, int LB, bool TV>
__device__ __forceinline__ void stv_accumulate(
    double w, double b, double p, const double* Ex, const double* Ey,
    const double* Ez, const double* RZ, double* acc) {
  constexpr int NCS = n_cart(LS), NCB = n_cart(LB);
  constexpr int NJ = LB + 3;           // j <= lb + 2
  constexpr int NT = LE + LB + 3;      // t <= le + lb + 2
#define PT_E(E, i, j, t) E[((i) * NJ + (j)) * NT + (t)]
  const double q = PT_PI / p;
  const double ws = w * q * sqrt(q);
  const double sq = sqrt(PT_PI / p);
  const double pre = -w * (2.0 * PT_PI / p);
  int ia = 0;
  for (int ix = LS; ix >= 0; --ix) {
    for (int iy = LS - ix; iy >= 0; --iy, ++ia) {
      const int iz = LS - ix - iy;
      int jb = 0;
      for (int jx = LB; jx >= 0; --jx) {
        for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
          const int jz = LB - jx - jy;
          const int o = ia * NCB + jb;
          acc[o] += ws * (PT_E(Ex, ix, jx, 0) * PT_E(Ey, iy, jy, 0)
                          * PT_E(Ez, iz, jz, 0));
          if (TV) {
            // 1D overlap s(i, j) and kinetic t(i, j) per direction
            double s1[3], t1[3];
            const double* Es[3] = {Ex, Ey, Ez};
            const int ii[3] = {ix, iy, iz}, jj[3] = {jx, jy, jz};
            for (int d = 0; d < 3; ++d) {
              const double* E = Es[d];
              const int i = ii[d], j = jj[d];
              const double s0 = PT_E(E, i, j, 0) * sq;
              double t = -2.0 * (b * b) * (PT_E(E, i, j + 2, 0) * sq)
                       + b * (2 * j + 1) * s0;
              if (j >= 2) t = t - 0.5 * (j * (j - 1))
                                      * (PT_E(E, i, j - 2, 0) * sq);
              s1[d] = s0;
              t1[d] = t;
            }
            acc[NCS * NCB + o] +=
                w * (t1[0] * s1[1] * s1[2] + s1[0] * t1[1] * s1[2]
                     + s1[0] * s1[1] * t1[2]);
            double v = 0.0;
            for (int t = 0; t <= ix + jx; ++t) {
              for (int u = 0; u <= iy + jy; ++u) {
                const double exy = PT_E(Ex, ix, jx, t) * PT_E(Ey, iy, jy, u);
                for (int vv = 0; vv <= iz + jz; ++vv) {
                  v += exy * PT_E(Ez, iz, jz, vv) * RZ[tuv_idx(t, u, vv)];
                }
              }
            }
            acc[2 * NCS * NCB + o] += pre * v;
          }
        }
      }
    }
  }
#undef PT_E
}

// RZ[tuv] = sum_C Z_C R_tuv(p, P - C) for t + u + v <= L over the natm
// point charges zq at zr; R is scratch of the same size.
template <int L>
__device__ __forceinline__ void nuclear_R(double p, double Px, double Py,
                                          double Pz, int natm,
                                          const double* zr, const double* zq,
                                          double* R, double* RZ) {
  for (int k = 0; k < n_tuv(L); ++k) RZ[k] = 0.0;
#pragma unroll 1
  for (int c = 0; c < natm; ++c) {
    const double z = zq[c];
    if (z == 0.0) continue;
    hermite_R<L>(p, Px - zr[3 * c], Py - zr[3 * c + 1], Pz - zr[3 * c + 2],
                 R);
    for (int k = 0; k < n_tuv(L); ++k) RZ[k] += R[k] * z;
  }
}

// sum over the cartesian components of both shells of Sa[sa, ia] Sb[sb, jb]
// blk[(ia * ncart(LB) + jb) * stride]: one sph element of a cartesian block.
template <int LA, int LB>
__device__ __forceinline__ double sph_element(const double* Sa,
                                              const double* Sb, int sa,
                                              int sb, const double* blk,
                                              int stride) {
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  double v = 0.0;
  for (int ia = 0; ia < NCA; ++ia) {
    const double fa = Sa[sa * NCA + ia];
    if (fa == 0.0) continue;
    for (int jb = 0; jb < NCB; ++jb) {
      v += fa * Sb[sb * NCB + jb] * blk[(ia * NCB + jb) * stride];
    }
  }
  return v;
}
