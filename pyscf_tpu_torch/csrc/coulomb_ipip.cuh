// Uncontracted first and contracted second nuclear derivatives of a
// three-centre Coulomb block (ab|c), c a single-centre shell; shared by
// int3c2e_ip1.cu, int3c2e_ipip.cu and int2c2e_ipip.cu (a two-centre block is
// the case b = an s function of exponent 0 on the bra's centre).
#pragma once
#include "coulomb_ip.cuh"
#include "hess2.cuh"

// d(ab|c)/dA_x of one bra shell pair (a on A, b on B) and one single-centre
// shell c, all primitives contracted, in real solid harmonics:
// out[x][sa][sb][sc] = blk[((x * DA + sa) * DB + sb) * DC + sc]. The
// power-shift rule on the raised and lowered bra shells accumulated from
// one set of tables e1d<LA + 1, LB> (coulomb_ip.cuh's design, without the
// contraction with weights).
template <int LA, int LB, int LC>
__device__ __forceinline__ void coulomb_ip1_block(
    int Ka, const double* ea, const double* ca, const double* A,
    int Kb, const double* eb, const double* cb, const double* B,
    int Kc, const double* ec, const double* cc, const double* C,
    const double* Sa, const double* Sb, const double* Sc, double* blk) {
  constexpr int L1 = LA + LB;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  constexpr int NE = (LA + 2) * (LB + 1) * (L1 + 2);
  constexpr int NCP = n_cart(LA + 1);
  constexpr int NCM = LA > 0 ? n_cart(LA - 1) : 1;
  const double zero = 0.0, one = 1.0;
  double accp[NCP * NCB * DC], accm[NCM * NCB * DC];
  for (int k = 0; k < NCP * NCB * DC; ++k) accp[k] = 0.0;
  for (int k = 0; k < NCM * NCB * DC; ++k) accm[k] = 0.0;
  double Y[n_tuv(L1 + 1) * DC];
  double Ex[NE], Ey[NE], Ez[NE];
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
      e1d<LA + 1, LB>(a, b, ABx, Ex);
      e1d<LA + 1, LB>(a, b, ABy, Ey);
      e1d<LA + 1, LB>(a, b, ABz, Ez);
      ket_fold<L1 + 1, LC, 0>(
          p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
          (a * A[2] + b * B[2]) / p, Kc, ec, cc, C, 1, &zero, &one, C, Sc,
          &one, 0, 0.0, Y);
      bra_contract<LA + 1, LA + 1, LB, DC>(2.0 * a * w, Ex, Ey, Ez, Y, accp);
      if constexpr (LA > 0) {
        bra_contract<LA - 1, LA + 1, LB, DC>(w, Ex, Ey, Ez, Y, accm);
      }
    }
  }
  double cart[NCA * NCB * DC];
  for (int d = 0; d < 3; ++d) {
    int ia = 0;
    for (int ix = LA; ix >= 0; --ix) {
      for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
        const int c[3] = {ix, iy, LA - ix - iy};
        const int pu = cart_pos(c[1] + (d == 1), c[2] + (d == 2));
        const int pd = cart_pos(c[1] - (d == 1), c[2] - (d == 2));
        for (int k = 0; k < NCB * DC; ++k) {
          double v = accp[pu * NCB * DC + k];
          if (c[d] > 0) v -= c[d] * accm[pd * NCB * DC + k];
          cart[ia * NCB * DC + k] = v;
        }
      }
    }
    for (int sa = 0; sa < DA; ++sa) {
      for (int sb = 0; sb < DB; ++sb) {
        for (int sc = 0; sc < DC; ++sc) {
          double v = 0.0;
          for (int ia = 0; ia < NCA; ++ia) {
            const double fa = Sa[sa * NCA + ia];
            if (fa == 0.0) continue;
            for (int jb = 0; jb < NCB; ++jb) {
              v += fa * Sb[sb * NCB + jb] * cart[(ia * NCB + jb) * DC + sc];
            }
          }
          blk[((d * DA + sa) * DB + sb) * DC + sc] = v;
        }
      }
    }
  }
}

// Second derivatives of sum G[sa, sb, sc] (ab|c) for one bra shell pair and
// one single-centre shell, all primitives contracted, G[(sa * (2LB+1) + sb)
// * ldg + sc] in real solid harmonics: with WITH_A, AA, AC and CC of
// hess2.cuh (A the bra shell a's centre, C the shell c's) added to aa, ac,
// cc (9 each, row-major); without, CC alone. G goes to the cartesian bra
// basis once; per bra primitive pair the shell c's primitives fold into Y to
// Hermite order LA + LB + 2 (quartet.cuh ket_fold, with an s partner of
// exponent 0), and per cartesian bra component the weights contract Y's
// column, so that every shifted Hermite sum of hess2.cuh runs on one
// vector.
template <int LA, int LB, int LC, bool WITH_A>
__device__ __forceinline__ void coulomb_ipip_block(
    int Ka, const double* ea, const double* ca, const double* A,
    int Kb, const double* eb, const double* cb, const double* B,
    int Kc, const double* ec, const double* cc, const double* C,
    const double* Sa, const double* Sb, const double* Sc,
    const double* G, int ldg, double* aa, double* ac, double* ccc) {
  constexpr int L1 = LA + LB;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  constexpr int LE = WITH_A ? LA + 2 : LA;
  constexpr int NJ = LB + 1, NT = LE + LB + 1;
  constexpr int NE = (LE + 1) * NJ * NT;
  constexpr int NY = n_tuv(L1 + 2);
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
  double Y[NY * DC], yg[NY];
  double Ex[NE], Ey[NE], Ez[NE];
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
      e1d<LE, LB>(a, b, ABx, Ex);
      e1d<LE, LB>(a, b, ABy, Ey);
      e1d<LE, LB>(a, b, ABz, Ez);
      ket_fold<L1 + 2, LC, 0>(
          p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
          (a * A[2] + b * B[2]) / p, Kc, ec, cc, C, 1, &zero, &one, C, Sc,
          &one, 0, 0.0, Y);
      const double w = cak * cbk;
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int i[3] = {ix, iy, LA - ix - iy};
          int jb = 0;
          for (int jx = LB; jx >= 0; --jx) {
            for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
              const int j[3] = {jx, jy, LB - jx - jy};
              const double* g = gc + (ia * NCB + jb) * DC;
              for (int k = 0; k < NY; ++k) {
                double s = 0.0;
                for (int sc = 0; sc < DC; ++sc) s += Y[k * DC + sc] * g[sc];
                yg[k] = s;
              }
              hess_terms<NJ, NT, WITH_A>(a, Ex, Ey, Ez, i, j, yg, w, aa, ac,
                                         ccc);
            }
          }
        }
      }
    }
  }
}
