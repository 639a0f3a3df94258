// Second nuclear derivatives of the overlap, kinetic and nuclear-attraction
// integrals per ordered shell pair, contracted with the densities D and W of
// the nuclear Hessian as they are made.
//
// Replaces what jax.jvp of jax.grad makes of the one-electron terms of
// pyscf_tpu/hessian/rhf.py e_fix (:236-245) through
// pyscf_tpu/ops/integrals/int1e.py ovlp_chunk, kin_chunk and nuc_chunk;
// plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e_deriv.py:class_ipip. The sums by atom
// pair that follow are index_add_ calls.
//
// One thread per (ordered shell pair, slot c), c in [0, natm]. Slot c <
// natm is the attraction of the point charge Z_c at C: the thread writes
// AA, AC and CC (hess2.cuh) of sum D_ab V_c,ab, 27 numbers; d/dB follows
// from translational invariance, d/dB = -(d/dA + d/dC), in the caller. Slot
// natm writes AA of sum D_ab T_ab - W_ab S_ab, 9 numbers (d/dB = -d/dA for
// a two-centre term); S and T are products of 1D factors, so their second
// derivatives are the power-shift rule on the 1D overlaps of one set of
// tables e1d<la + 2, lb + 2> (the kinetic term moves the ket power by 2).
// The densities go to the cartesian basis once per thread, Sa^T D Sb.
// One thread owns its output: no atomics, the same result from run to run.
// What bounds it on the card is FP64 arithmetic: R_tuv to order la + lb + 2
// per primitive pair and charge, and the shifted Hermite sums.
//
// D, W: (n, (2la+1)(2lb+1)) sph blocks of the pairs; out: (n, natm + 1,
// 27).
#include <cuda_runtime.h>

#include "hess2.cuh"

template <int LA, int LB>
__global__ void __launch_bounds__(128) int1e_ipip_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int natm, const double* __restrict__ zr,
    const double* __restrict__ zq, const double* __restrict__ Sa,
    const double* __restrict__ Sb, const double* __restrict__ D,
    const double* __restrict__ W, double* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * (natm + 1)) return;
  const int ip = (int)(idx / (natm + 1));
  const int c = (int)(idx % (natm + 1));
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int L = LA + LB + 2;
  constexpr int NJ = LB + 3, NT = LA + LB + 5;
  constexpr int NE = (LA + 3) * NJ * NT;              // e1d<LA + 2, LB + 2>
  const bool st = c == natm;
  double* o = out + ((size_t)ip * (natm + 1) + c) * 27;
  double acc[27];
  for (int k = 0; k < 27; ++k) acc[k] = 0.0;
  const double z = st ? 0.0 : zq[c];
  if (!st && z == 0.0) {
    for (int k = 0; k < 27; ++k) o[k] = 0.0;
    return;
  }

  // the densities in the cartesian basis
  double gd[NCA * NCB], gw[NCA * NCB];
  const double* Dp = D + (size_t)ip * DA * DB;
  const double* Wp = W + (size_t)ip * DA * DB;
  for (int ia = 0; ia < NCA; ++ia) {
    for (int jb = 0; jb < NCB; ++jb) {
      double vd = 0.0, vw = 0.0;
      for (int sa = 0; sa < DA; ++sa) {
        const double fa = Sa[sa * NCA + ia];
        if (fa == 0.0) continue;
        for (int sb = 0; sb < DB; ++sb) {
          const double f = fa * Sb[sb * NCB + jb];
          vd += f * Dp[sa * DB + sb];
          vw += f * Wp[sa * DB + sb];
        }
      }
      gd[ia * NCB + jb] = vd;
      gw[ia * NCB + jb] = vw;
    }
  }

  double Ex[NE], Ey[NE], Ez[NE];
  double y[n_tuv(L)];
  const double* A = ra + 3 * (size_t)ip;
  const double* B = rb + 3 * (size_t)ip;
#pragma unroll 1
  for (int ka = 0; ka < Ka; ++ka) {
    const double cak = ca[(size_t)ip * Ka + ka];
    if (cak == 0.0) continue;
    const double a = ea[(size_t)ip * Ka + ka];
#pragma unroll 1
    for (int kb = 0; kb < Kb; ++kb) {
      const double cbk = cb[(size_t)ip * Kb + kb];
      if (cbk == 0.0) continue;
      const double b = eb[(size_t)ip * Kb + kb];
      const double w = cak * cbk;
      const double p = a + b;
      e1d<LA + 2, LB + 2>(a, b, A[0] - B[0], Ex);
      e1d<LA + 2, LB + 2>(a, b, A[1] - B[1], Ey);
      e1d<LA + 2, LB + 2>(a, b, A[2] - B[2], Ez);
      if (!st) {
        const double* C = zr + 3 * c;
        hermite_R<L>(p, (a * A[0] + b * B[0]) / p - C[0],
                     (a * A[1] + b * B[1]) / p - C[1],
                     (a * A[2] + b * B[2]) / p - C[2], y);
        const double pre = -z * w * (2.0 * PT_PI / p);
        for (int k = 0; k < n_tuv(L); ++k) y[k] *= pre;
      }
      const double sq = sqrt(PT_PI / p);
      const double* Es[3] = {Ex, Ey, Ez};
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int i[3] = {ix, iy, LA - ix - iy};
          int jb = 0;
          for (int jx = LB; jx >= 0; --jx) {
            for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
              const int j[3] = {jx, jy, LB - jx - jy};
              if (!st) {
                hess_terms<NJ, NT, true>(a, Ex, Ey, Ez, i, j, y,
                                         gd[ia * NCB + jb], acc, acc + 9,
                                         acc + 18);
                continue;
              }
              // 1D overlap s and kinetic t factors with the bra power
              // moved by -2..2: f[d][k][m], k = 0 overlap, 1 kinetic,
              // m = 0 value, 1 D, 2 D^2 (D = 2a(+1) - i(-1))
              double f[3][2][3];
              for (int d = 0; d < 3; ++d) {
                const double* E = Es[d];
                double s[5], t[5];
                for (int m = -2; m <= 2; ++m) {
                  const int ii = i[d] + m, jj = j[d];
                  if (ii < 0) {
                    s[m + 2] = t[m + 2] = 0.0;
                    continue;
                  }
                  const double s0 = E[(ii * NJ + jj) * NT] * sq;
                  double tv = -2.0 * (b * b) * (E[(ii * NJ + jj + 2) * NT]
                                                * sq)
                              + b * (2 * jj + 1) * s0;
                  if (jj >= 2) {
                    tv -= 0.5 * (jj * (jj - 1)) * (E[(ii * NJ + jj - 2) * NT]
                                                   * sq);
                  }
                  s[m + 2] = s0;
                  t[m + 2] = tv;
                }
                const int ii = i[d];
                const double* vals[2] = {s, t};
                for (int k = 0; k < 2; ++k) {
                  const double* v = vals[k];
                  f[d][k][0] = v[2];
                  f[d][k][1] = 2.0 * a * v[3] - ii * v[1];
                  f[d][k][2] = 4.0 * a * a * v[4]
                               - 2.0 * a * (2 * ii + 1) * v[2]
                               + ii * (ii - 1) * v[0];
                }
              }
              const double g_d = gd[ia * NCB + jb], g_w = gw[ia * NCB + jb];
              for (int x = 0; x < 3; ++x) {
                for (int zz = 0; zz < 3; ++zz) {
                  // order of the derivative on each direction
                  int ord[3] = {0, 0, 0};
                  ord[x] += 1;
                  ord[zz] += 1;
                  const double sv = f[0][0][ord[0]] * f[1][0][ord[1]]
                                    * f[2][0][ord[2]];
                  double tv = 0.0;
                  for (int dt = 0; dt < 3; ++dt) {
                    double v = 1.0;
                    for (int d = 0; d < 3; ++d) {
                      v *= f[d][d == dt ? 1 : 0][ord[d]];
                    }
                    tv += v;
                  }
                  acc[x * 3 + zz] += w * (g_d * tv - g_w * sv);
                }
              }
            }
          }
        }
      }
    }
  }
  for (int k = 0; k < 27; ++k) o[k] = acc[k];
}

template <int LA, int LB>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int natm, const double* zr,
                  const double* zq, const double* Sa, const double* Sb,
                  const double* D, const double* W, double* out,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)n * (natm + 1);
  const int blocks = (int)((total + threads - 1) / threads);
  int1e_ipip_kernel<LA, LB><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, D, W, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (la, lb <= 4, every ordered pair).
extern "C" int pt_int1e_ipip(int la, int lb, int n, int Ka, int Kb,
                             const double* ea, const double* ca,
                             const double* ra, const double* eb,
                             const double* cb, const double* rb, int natm,
                             const double* zr, const double* zq,
                             const double* Sa, const double* Sb,
                             const double* D, const double* W, double* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_C(A, B) \
  if (la == A && lb == B) \
    return launch<A, B>(n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, \
                        Sb, D, W, out, s);
#define PT_A(A) PT_C(A, 0) PT_C(A, 1) PT_C(A, 2) PT_C(A, 3) PT_C(A, 4)
  PT_A(0) PT_A(1) PT_A(2) PT_A(3) PT_A(4)
#undef PT_A
#undef PT_C
  return -1;
}
