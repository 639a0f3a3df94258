// The two halves of a four-centre Coulomb quartet in the McMurchie-Davidson
// scheme, shared by int2e.cu and int2e_ip1.cu: the fold of a ket shell
// pair's primitives into Y, and the contraction of Y with a bra primitive
// pair's E tables.
#pragma once
#include "hermite.cuh"

// Y[tuv1 * (2LC+1) + sc] = sum over the ket's primitive pairs of
//   pref * sum_tuv2 E_cd[sc, sd][tuv2] (-1)^|tuv2| R[tuv1 + tuv2]
// for tuv1 of order <= L1 and one sph component sd of the ket's second
// shell; (p, P) is the bra primitive pair's exponent and centre. Primitives
// with a zero coefficient (the padding of the shell tables) are skipped.
template <int L1, int LC, int LD>
__device__ __forceinline__ void ket_fold(
    double p, double Px, double Py, double Pz,
    int Kc, const double* ec, const double* cc, const double* C,
    int Kd, const double* ed, const double* cd, const double* D,
    const double* Sc, const double* Sd, int sd, double* Y) {
  constexpr int L2 = LC + LD, L = L1 + L2;
  constexpr int NCC = n_cart(LC), NCD = n_cart(LD);
  constexpr int DC = 2 * LC + 1;
  constexpr int NE2 = (LC + 1) * (LD + 1) * (L2 + 1);
  constexpr int T2 = L2 + 1;
  double Fx[NE2], Fy[NE2], Fz[NE2];
  double R[n_tuv(L)];
  const double CDx = C[0] - D[0], CDy = C[1] - D[1], CDz = C[2] - D[2];
  for (int k = 0; k < n_tuv(L1) * DC; ++k) Y[k] = 0.0;

#pragma unroll 1
  for (int kc = 0; kc < Kc; ++kc) {
    const double cck = cc[kc];
    if (cck == 0.0) continue;
    const double c = ec[kc];
#pragma unroll 1
    for (int kd = 0; kd < Kd; ++kd) {
      const double cdk = cd[kd];
      if (cdk == 0.0) continue;
      const double d = ed[kd];
      const double q = c + d;
      const double Qx = (c * C[0] + d * D[0]) / q;
      const double Qy = (c * C[1] + d * D[1]) / q;
      const double Qz = (c * C[2] + d * D[2]) / q;
      const double pq = p * q;
      const double ps = p + q;
      // 2 pi^{5/2} / (p q sqrt(p + q))
      const double pref = 34.986836655249725 / (pq * sqrt(ps)) * cck * cdk;
      hermite_R<L>(pq / ps, Px - Qx, Py - Qy, Pz - Qz, R);
      e1d<LC, LD>(c, d, CDx, Fx);
      e1d<LC, LD>(c, d, CDy, Fy);
      e1d<LC, LD>(c, d, CDz, Fz);
#pragma unroll 1
      for (int sc = 0; sc < DC; ++sc) {
#pragma unroll 1
        for (int jc = 0; jc < NCC; ++jc) {
          const double s_c = Sc[sc * NCC + jc];
          if (s_c == 0.0) continue;
          // cartesian (kx, ky, kz) of position jc: ix descending, then
          // iy descending
          int kx = LC, rem = jc;
          while (rem > LC - kx) { rem -= LC - kx + 1; --kx; }
          const int ky = LC - kx - rem, kz = rem;
#pragma unroll 1
          for (int jd = 0; jd < NCD; ++jd) {
            const double s = s_c * Sd[sd * NCD + jd];
            if (s == 0.0) continue;
            int lx = LD, rd = jd;
            while (rd > LD - lx) { rd -= LD - lx + 1; --lx; }
            const int ly = LD - lx - rd, lz = rd;
            const double* fx = Fx + (kx * (LD + 1) + lx) * T2;
            const double* fy = Fy + (ky * (LD + 1) + ly) * T2;
            const double* fz = Fz + (kz * (LD + 1) + lz) * T2;
            for (int tx = 0; tx <= kx + lx; ++tx) {
              for (int ty = 0; ty <= ky + ly; ++ty) {
                for (int tz = 0; tz <= kz + lz; ++tz) {
                  const double e2 = fx[tx] * fy[ty] * fz[tz];
                  if (e2 == 0.0) continue;
                  double coef = pref * s * e2;
                  if ((tx + ty + tz) & 1) coef = -coef;
                  for (int n = 0; n <= L1; ++n) {
                    for (int t = n; t >= 0; --t) {
                      for (int u = n - t; u >= 0; --u) {
                        const int v = n - t - u;
                        Y[tuv_idx(t, u, v) * DC + sc] +=
                            coef * R[tuv_idx(t + tx, u + ty, v + tz)];
                      }
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
  }
}

// acc[(ia * ncart(LB) + jb) * DC + sc] += w * sum_tuv E_ab[ia, jb][tuv]
// Y[tuv * DC + sc] for the bra shell LS against the shell LB. Ex, Ey, Ez are
// the tables of e1d<LE, LB> with LE >= LS, so one set of tables serves the
// raised and lowered bra shells of a derivative.
template <int LS, int LE, int LB, int DC>
__device__ __forceinline__ void bra_contract(double w, const double* Ex,
                                             const double* Ey,
                                             const double* Ez,
                                             const double* Y, double* acc) {
  constexpr int NCB = n_cart(LB);
  constexpr int T1 = LE + LB + 1;
  int ia = 0;
  for (int ix = LS; ix >= 0; --ix) {
    for (int iy = LS - ix; iy >= 0; --iy, ++ia) {
      const int iz = LS - ix - iy;
      int jb = 0;
      for (int jx = LB; jx >= 0; --jx) {
        for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
          const int jz = LB - jx - jy;
          double* out = acc + (ia * NCB + jb) * DC;
          for (int t = 0; t <= ix + jx; ++t) {
            const double ex = w * Ex[(ix * (LB + 1) + jx) * T1 + t];
            for (int u = 0; u <= iy + jy; ++u) {
              const double exy = ex * Ey[(iy * (LB + 1) + jy) * T1 + u];
              for (int v = 0; v <= iz + jz; ++v) {
                const double e = exy * Ez[(iz * (LB + 1) + jz) * T1 + v];
                const double* y = Y + tuv_idx(t, u, v) * DC;
                for (int sc = 0; sc < DC; ++sc) out[sc] += e * y[sc];
              }
            }
          }
        }
      }
    }
  }
}
