// McMurchie-Davidson building blocks shared by the integral kernels.
//
// Device counterparts of pyscf_tpu/ops/integrals/hermite.py (e1d_dense,
// hermite_R with its _r_step_tables) and of the plain PyTorch twins in
// pyscf_tpu_torch/ops/integrals/hermite.py, with the JAX package's
// conventions and orderings:
//   cartesian components: ix descending, then iy descending;
//   Hermite (t,u,v): by total order n, then t descending, then u descending.
// Every array here is a small per-thread local array whose size is fixed by
// the angular momenta, which the kernels take as template parameters.
#pragma once
#include <cuda_runtime.h>

#include "boys.cuh"

#define PT_PI 3.14159265358979323846

__host__ __device__ constexpr int n_cart(int l) { return (l + 1) * (l + 2) / 2; }
__host__ __device__ constexpr int n_tuv(int L) {
  return (L + 1) * (L + 2) * (L + 3) / 6;
}

// Position of (t,u,v) in the Hermite ordering; the same formula gives the
// position of a cartesian (ix,iy,iz) within its shell (n = l, no offset).
__device__ __forceinline__ int tuv_idx(int t, int u, int v) {
  const int n = t + u + v;
  const int m = n - t;
  return n * (n + 1) * (n + 2) / 6 + m * (m + 1) / 2 + (m - u);
}

// Position of the cartesian component (ix,iy,iz) within its shell.
__device__ __forceinline__ int cart_pos(int iy, int iz) {
  const int m = iy + iz;
  return m * (m + 1) / 2 + iz;
}

// 1D expansion table E_t^{i,j}, i <= LA, j <= LB, t <= LA+LB, stored at
// E[(i*(LB+1)+j)*(LA+LB+1)+t]; zero where t > i+j. ab = A_x - B_x. The
// Gaussian-product prefactor exp(-mu ab^2) sits in E_0^{0,0}.
template <int LA, int LB>
__device__ __forceinline__ void e1d(double a, double b, double ab, double* E) {
  constexpr int NT = LA + LB + 1;
  for (int k = 0; k < (LA + 1) * (LB + 1) * NT; ++k) E[k] = 0.0;
  const double p = a + b;
  const double mu = a * b / p;
  const double inv2p = 0.5 / p;
  const double qa = (-b / p) * ab;
  const double qb = (a / p) * ab;
  E[0] = exp(-mu * ab * ab);
  for (int i = 0; i <= LA; ++i) {
    for (int j = 0; j <= LB; ++j) {
      if (i == 0 && j == 0) continue;
      // increment i from (i-1, 0) on the j == 0 column, else j from (i, j-1)
      const int prev = (j == 0) ? ((i - 1) * (LB + 1)) * NT
                                : (i * (LB + 1) + j - 1) * NT;
      const int lim = i + j - 1;
      const double q = (j == 0) ? qa : qb;
      const int cur = (i * (LB + 1) + j) * NT;
      for (int t = 0; t <= i + j; ++t) {
        const double x1 = (t >= 1) ? E[prev + t - 1] : 0.0;
        const double x2 = (t <= lim) ? E[prev + t] : 0.0;
        const double x3 = (t + 1 <= lim) ? E[prev + t + 1] : 0.0;
        E[cur + t] = inv2p * x1 + q * x2 + (t + 1) * x3;
      }
    }
  }
}

// Hermite Coulomb table R_tuv(p, PQ) for t+u+v <= L into R[n_tuv(L)],
// R_000^{(n)} = (-2p)^n F_n(p |PQ|^2). The recursion runs in place from
// level n = L down to 0: at level n the entries of total order k are
// written from order k-1 and k-2 of level n+1, highest order first.
template <int L>
__device__ __forceinline__ void hermite_R(double p, double X, double Y,
                                          double Z, double* R) {
  double F[L + 1];
  boys<L>(p * (X * X + Y * Y + Z * Z), F);
  double pows[L + 1];
  double pw = 1.0;
  const double m2p = -2.0 * p;
  for (int n = 0; n <= L; ++n) {
    pows[n] = pw;
    pw = pw * m2p;
  }
  R[0] = pows[L] * F[L];
#pragma unroll 1
  for (int n = L - 1; n >= 0; --n) {
    for (int k = L - n; k >= 1; --k) {
      for (int t = k; t >= 0; --t) {
        for (int u = k - t; u >= 0; --u) {
          const int v = k - t - u;
          double val;
          if (t > 0) {
            val = (t >= 2 ? (t - 1) * R[tuv_idx(t - 2, u, v)] : 0.0)
                + X * R[tuv_idx(t - 1, u, v)];
          } else if (u > 0) {
            val = (u >= 2 ? (u - 1) * R[tuv_idx(0, u - 2, v)] : 0.0)
                + Y * R[tuv_idx(0, u - 1, v)];
          } else {
            val = (v >= 2 ? (v - 1) * R[tuv_idx(0, 0, v - 2)] : 0.0)
                + Z * R[tuv_idx(0, 0, v - 1)];
          }
          R[tuv_idx(t, u, v)] = val;
        }
      }
    }
    R[0] = pows[n] * F[n];
  }
}

// Coulomb integrals (ab|c) of one bra shell pair (a on A, b on B) with one
// single-centre ket shell c on C, contracted over every primitive, in real
// solid harmonics: res[((sa*(2LB+1)+sb)*(2LC+1)+sc]. Primitives with a zero
// coefficient (the padding of the shell tables) are skipped. With LB = 0, a
// b exponent of 0, a coefficient of 1 and Sb = {1}, the bra is the single
// shell a, which gives the two-centre (a|c).
//
// Per bra primitive pair, the ket primitives are first folded into
// Y[tuv1][sc] = sum_c pref * sum_tuv2 E_c[sc][tuv2] (-1)^|tuv2| R[tuv1+tuv2],
// then contracted with the bra's E tables into cartesian accumulators; the
// bra's cart->sph transform is applied once at the end.
template <int LA, int LB, int LC>
__device__ __forceinline__ void coulomb_block(
    int Ka, const double* ea, const double* ca, const double* A,
    int Kb, const double* eb, const double* cb, const double* B,
    int Kc, const double* ec, const double* cc, const double* C,
    const double* Sa, const double* Sb, const double* Sc, double* res) {
  constexpr int L1 = LA + LB;
  constexpr int L = L1 + LC;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB), NCC = n_cart(LC);
  constexpr int NT1 = n_tuv(L1);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  constexpr int NE = (LA + 1) * (LB + 1) * (L1 + 1);
  constexpr int NT = L1 + 1;

  double acc[NCA * NCB * DC];
  for (int k = 0; k < NCA * NCB * DC; ++k) acc[k] = 0.0;
  double Y[NT1 * DC];
  double Ex[NE], Ey[NE], Ez[NE];
  double Ec[(LC + 1) * (LC + 1)];
  double R[n_tuv(L)];
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
      const double Px = (a * A[0] + b * B[0]) / p;
      const double Py = (a * A[1] + b * B[1]) / p;
      const double Pz = (a * A[2] + b * B[2]) / p;
      e1d<LA, LB>(a, b, ABx, Ex);
      e1d<LA, LB>(a, b, ABy, Ey);
      e1d<LA, LB>(a, b, ABz, Ez);
      for (int k = 0; k < NT1 * DC; ++k) Y[k] = 0.0;

#pragma unroll 1
      for (int kc = 0; kc < Kc; ++kc) {
        const double cck = cc[kc];
        if (cck == 0.0) continue;
        const double c = ec[kc];
        const double pp = p * c;
        const double ps = p + c;
        const double omega = pp / ps;
        // 2 pi^{5/2} / (p c sqrt(p + c))
        const double pref = 34.986836655249725 / (pp * sqrt(ps)) * cck;
        hermite_R<L>(omega, Px - C[0], Py - C[1], Pz - C[2], R);
        e1d<LC, 0>(c, 0.0, 0.0, Ec);   // same table in x, y and z
#pragma unroll 1
        for (int sc = 0; sc < DC; ++sc) {
          int jc = 0;
          for (int kx = LC; kx >= 0; --kx) {
            for (int ky = LC - kx; ky >= 0; --ky, ++jc) {
              const int kz = LC - kx - ky;
              const double s = Sc[sc * NCC + jc];
              if (s == 0.0) continue;
              for (int tx = 0; tx <= kx; ++tx) {
                for (int ty = 0; ty <= ky; ++ty) {
                  for (int tz = 0; tz <= kz; ++tz) {
                    const double e2 = Ec[kx * (LC + 1) + tx]
                                    * Ec[ky * (LC + 1) + ty]
                                    * Ec[kz * (LC + 1) + tz];
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

      const double w = cak * cbk;
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int iz = LA - ix - iy;
          int jb = 0;
          for (int jx = LB; jx >= 0; --jx) {
            for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
              const int jz = LB - jx - jy;
              double* out = acc + (ia * NCB + jb) * DC;
              for (int t = 0; t <= ix + jx; ++t) {
                const double ex = w * Ex[(ix * (LB + 1) + jx) * NT + t];
                for (int u = 0; u <= iy + jy; ++u) {
                  const double exy = ex * Ey[(iy * (LB + 1) + jy) * NT + u];
                  for (int v = 0; v <= iz + jz; ++v) {
                    const double e = exy * Ez[(iz * (LB + 1) + jz) * NT + v];
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
  }

  for (int sa = 0; sa < DA; ++sa) {
    for (int sb = 0; sb < DB; ++sb) {
      for (int sc = 0; sc < DC; ++sc) {
        double v = 0.0;
        for (int ia = 0; ia < NCA; ++ia) {
          const double fa = Sa[sa * NCA + ia];
          if (fa == 0.0) continue;
          for (int jb = 0; jb < NCB; ++jb) {
            v += fa * Sb[sb * NCB + jb] * acc[(ia * NCB + jb) * DC + sc];
          }
        }
        res[(sa * DB + sb) * DC + sc] = v;
      }
    }
  }
}
