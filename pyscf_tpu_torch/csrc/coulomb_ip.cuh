// First nuclear derivatives of a three-centre Coulomb block (ab|c), c a
// single-centre shell, contracted with a block of weights as they are made;
// shared by int3c2e_ip.cu and int2c2e_ip1.cu.
#pragma once
#include "quartet.cuh"

// sum over primitives of w E_ab[ia, jb][tuv] (sum_sc Y[tuv + e_x][sc]
// gc[ia, jb, sc]) into c3[x], for the shell pair (LA, LB). Ex, Ey, Ez are
// the tables of e1d<LE, LB> with LE >= LA; Y holds Hermite orders up to
// LA + LB + 1.
template <int LA, int LE, int LB, int DC>
__device__ __forceinline__ void shift_contract(double w, const double* Ex,
                                               const double* Ey,
                                               const double* Ez,
                                               const double* Y,
                                               const double* gc, double* c3) {
  constexpr int NCB = n_cart(LB);
  constexpr int T1 = LE + LB + 1;
  int ia = 0;
  for (int ix = LA; ix >= 0; --ix) {
    for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
      const int iz = LA - ix - iy;
      int jb = 0;
      for (int jx = LB; jx >= 0; --jx) {
        for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
          const int jz = LB - jx - jy;
          const double* g = gc + (ia * NCB + jb) * DC;
          for (int t = 0; t <= ix + jx; ++t) {
            const double ex = w * Ex[(ix * (LB + 1) + jx) * T1 + t];
            for (int u = 0; u <= iy + jy; ++u) {
              const double exy = ex * Ey[(iy * (LB + 1) + jy) * T1 + u];
              for (int v = 0; v <= iz + jz; ++v) {
                const double e = exy * Ez[(iz * (LB + 1) + jz) * T1 + v];
                const double* yx = Y + tuv_idx(t + 1, u, v) * DC;
                const double* yy = Y + tuv_idx(t, u + 1, v) * DC;
                const double* yz = Y + tuv_idx(t, u, v + 1) * DC;
                double sx = 0.0, sy = 0.0, sz = 0.0;
                for (int sc = 0; sc < DC; ++sc) {
                  sx += yx[sc] * g[sc];
                  sy += yy[sc] * g[sc];
                  sz += yz[sc] * g[sc];
                }
                c3[0] += e * sx;
                c3[1] += e * sy;
                c3[2] += e * sz;
              }
            }
          }
        }
      }
    }
  }
}

// For one bra shell pair (a on A, b on B) and one single-centre shell c on
// C, all primitives contracted, and a block of weights
// G[(sa*(2LB+1) + sb) * ldg + sc] in real solid harmonics:
//   dC[x] = sum G[sa, sb, sc] d(ab|c)/dC_x
//   dA[x] = sum G[sa, sb, sc] d(ab|c)/dA_x    (WITH_A only)
// The weights go to the cartesian bra basis once, gc = Sa^T Sb^T G. Per bra
// primitive pair the ket's primitives fold into Y to Hermite order
// LA + LB + 1 (quartet.cuh ket_fold, with an s partner of exponent 0).
//  - d/dC: the ket's Hermite expansion does not depend on C, and
//    d/dC_x Lambda_tuv(C) = Lambda_{tuv + e_x}, so d/dC_x (ab|c) =
//    -sum_tuv E_ab[tuv] Y[tuv + e_x]: contracted with gc at once.
//  - d/dA: the power-shift rule d/dA_x [x_A^i e^{-a x_A^2}] = 2a x_A^{i+1}
//    - i x_A^{i-1}: the cartesian blocks of the raised (2a in the weight)
//    and lowered bra shells accumulate from one set of tables
//    e1d<LA + 1, LB> (quartet.cuh bra_contract), and the rule and the
//    contraction with gc run once, after the primitive loops.
template <int LA, int LB, int LC, bool WITH_A>
__device__ __forceinline__ void coulomb_ip_block(
    int Ka, const double* ea, const double* ca, const double* A,
    int Kb, const double* eb, const double* cb, const double* B,
    int Kc, const double* ec, const double* cc, const double* C,
    const double* Sa, const double* Sb, const double* Sc,
    const double* G, int ldg, double* dA, double* dC) {
  constexpr int L1 = LA + LB;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DB = 2 * LB + 1, DC = 2 * LC + 1, DA = 2 * LA + 1;
  constexpr int LE = WITH_A ? LA + 1 : LA;
  constexpr int NE = (LE + 1) * (LB + 1) * (LE + LB + 1);
  constexpr int NCP = WITH_A ? n_cart(LA + 1) : 1;
  constexpr int NCM = (WITH_A && LA > 0) ? n_cart(LA - 1) : 1;
  const double zero = 0.0, one = 1.0;

  double gc[NCA * NCB * DC];
  for (int ia = 0; ia < NCA; ++ia) {
    for (int jb = 0; jb < NCB; ++jb) {
      for (int sc = 0; sc < DC; ++sc) {
        double v = 0.0;
        for (int sa = 0; sa < DA; ++sa) {
          const double fa = Sa[sa * NCA + ia];
          if (fa == 0.0) continue;
          for (int sb = 0; sb < DB; ++sb) {
            v += fa * Sb[sb * NCB + jb] * G[(size_t)(sa * DB + sb) * ldg + sc];
          }
        }
        gc[(ia * NCB + jb) * DC + sc] = v;
      }
    }
  }
  double accp[NCP * NCB * DC], accm[NCM * NCB * DC];
  if constexpr (WITH_A) {
    for (int k = 0; k < NCP * NCB * DC; ++k) accp[k] = 0.0;
    for (int k = 0; k < NCM * NCB * DC; ++k) accm[k] = 0.0;
  }
  double Y[n_tuv(L1 + 1) * DC];
  double Ex[NE], Ey[NE], Ez[NE];
  double c3[3] = {0.0, 0.0, 0.0};
  const double ABx = A[0] - B[0], ABy = A[1] - B[1], ABz = A[2] - B[2];

#pragma unroll 1
  for (int ka = 0; ka < Ka; ++ka) {
    const double cak = ca[ka];
    if (cak == 0.0) continue;
    const double a = ea[ka];
#pragma unroll 1
    for (int kb = 0; kb < Kb; ++kb) {
      const double cbk = cb[kb];
      if (cbk == 0.0) continue;
      const double b = eb[kb];
      const double p = a + b;
      const double w = cak * cbk;
      e1d<LE, LB>(a, b, ABx, Ex);
      e1d<LE, LB>(a, b, ABy, Ey);
      e1d<LE, LB>(a, b, ABz, Ez);
      ket_fold<L1 + 1, LC, 0>(
          p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
          (a * A[2] + b * B[2]) / p, Kc, ec, cc, C, 1, &zero, &one, C, Sc,
          &one, 0, 0.0, Y);
      if constexpr (WITH_A) {
        bra_contract<LA + 1, LE, LB, DC>(2.0 * a * w, Ex, Ey, Ez, Y, accp);
        if constexpr (LA > 0) {
          bra_contract<LA - 1, LE, LB, DC>(w, Ex, Ey, Ez, Y, accm);
        }
      }
      shift_contract<LA, LE, LB, DC>(w, Ex, Ey, Ez, Y, gc, c3);
    }
  }
  for (int d = 0; d < 3; ++d) dC[d] = -c3[d];

  if constexpr (WITH_A) {
    // the power-shift rule on the cartesian blocks, contracted with gc
    for (int d = 0; d < 3; ++d) {
      double s = 0.0;
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int c[3] = {ix, iy, LA - ix - iy};
          const int pu = cart_pos(c[1] + (d == 1), c[2] + (d == 2));
          const int pd = cart_pos(c[1] - (d == 1), c[2] - (d == 2));
          for (int k = 0; k < NCB * DC; ++k) {
            double v = accp[pu * NCB * DC + k];
            if (c[d] > 0) v -= c[d] * accm[pd * NCB * DC + k];
            s += v * gc[ia * NCB * DC + k];
          }
        }
      }
      dA[d] = s;
    }
  }
}
