// Overlap, kinetic and nuclear-attraction integrals per shell pair.
//
// Replaces pyscf_tpu/ops/integrals/j1e.py:_class_stv (which calls
// int1e.py:ovlp_chunk, kin_chunk and nuc_chunk); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e.py:class_stv. In S-only mode it also
// serves int1e_ovlp_cross (the minao guess's mol x minao overlap).
//
// One thread per shell pair owns its output rows, so there are no atomics
// and the result is the same from run to run. The thread loops over the
// primitive pairs, builds the 1D Hermite tables up to lb+2 (the kinetic
// term needs them), and for V sums R_tuv over the atoms. What bounds it on
// the card is FP64 arithmetic in the Boys series and the R recursion of the
// nuclear term (one per atom and primitive pair); the simple design spends
// it once per pair and keeps every table in per-thread local memory.
//
// out: (n, (2la+1)(2lb+1), 3) rows of [S, T, V], or (n, (2la+1)(2lb+1)) of S.
#include <cuda_runtime.h>

#include "hermite.cuh"

template <int LA, int LB, bool TV>
__global__ void __launch_bounds__(128) int1e_stv_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int natm, const double* __restrict__ zr,
    const double* __restrict__ zq, const double* __restrict__ Sa,
    const double* __restrict__ Sb, double* __restrict__ out) {
  const int ip = blockIdx.x * blockDim.x + threadIdx.x;
  if (ip >= n) return;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int L1 = LA + LB;
  constexpr int NJ = LB + 3;           // j <= lb + 2
  constexpr int NT = L1 + 3;           // t <= la + lb + 2
  constexpr int NE = (LA + 1) * NJ * NT;
  constexpr int NC = TV ? 3 : 1;

  double acc[NC * NCA * NCB];
  for (int k = 0; k < NC * NCA * NCB; ++k) acc[k] = 0.0;
  double Ex[NE], Ey[NE], Ez[NE];
  double R[n_tuv(L1)], RZ[n_tuv(L1)];
  const double* A = ra + 3 * ip;
  const double* B = rb + 3 * ip;

#define PT_E(E, i, j, t) E[((i) * NJ + (j)) * NT + (t)]
#pragma unroll 1
  for (int ka = 0; ka < Ka; ++ka) {
    const double cak = ca[ip * Ka + ka];
    if (cak == 0.0) continue;
    const double a = ea[ip * Ka + ka];
#pragma unroll 1
    for (int kb = 0; kb < Kb; ++kb) {
      const double cbk = cb[ip * Kb + kb];
      if (cbk == 0.0) continue;
      const double b = eb[ip * Kb + kb];
      const double w = cak * cbk;
      const double p = a + b;
      e1d<LA, LB + 2>(a, b, A[0] - B[0], Ex);
      e1d<LA, LB + 2>(a, b, A[1] - B[1], Ey);
      e1d<LA, LB + 2>(a, b, A[2] - B[2], Ez);
      const double q = PT_PI / p;
      const double ws = w * q * sqrt(q);
      const double sq = sqrt(PT_PI / p);
      if (TV) {
        const double Px = (a * A[0] + b * B[0]) / p;
        const double Py = (a * A[1] + b * B[1]) / p;
        const double Pz = (a * A[2] + b * B[2]) / p;
        for (int k = 0; k < n_tuv(L1); ++k) RZ[k] = 0.0;
#pragma unroll 1
        for (int c = 0; c < natm; ++c) {
          const double z = zq[c];
          if (z == 0.0) continue;
          hermite_R<L1>(p, Px - zr[3 * c], Py - zr[3 * c + 1],
                        Pz - zr[3 * c + 2], R);
          for (int k = 0; k < n_tuv(L1); ++k) RZ[k] += R[k] * z;
        }
      }
      const double pre = -w * (2.0 * PT_PI / p);
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int iz = LA - ix - iy;
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
                acc[NCA * NCB + o] +=
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
                acc[2 * NCA * NCB + o] += pre * v;
              }
            }
          }
        }
      }
    }
  }
#undef PT_E

  for (int sa = 0; sa < DA; ++sa) {
    for (int sb = 0; sb < DB; ++sb) {
      for (int x = 0; x < NC; ++x) {
        double v = 0.0;
        for (int ia = 0; ia < NCA; ++ia) {
          const double fa = Sa[sa * NCA + ia];
          if (fa == 0.0) continue;
          for (int jb = 0; jb < NCB; ++jb) {
            v += fa * Sb[sb * NCB + jb] * acc[x * NCA * NCB + ia * NCB + jb];
          }
        }
        out[((size_t)ip * DA * DB + sa * DB + sb) * NC + x] = v;
      }
    }
  }
}

template <int LA, int LB, bool TV>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int natm, const double* zr,
                  const double* zq, const double* Sa, const double* Sb,
                  double* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  int1e_stv_kernel<LA, LB, TV><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (S/T/V needs la <= lb <= 2; S alone la, lb <= 2).
extern "C" int pt_int1e_stv(int la, int lb, int with_tv, int n, int Ka,
                            int Kb, const double* ea, const double* ca,
                            const double* ra, const double* eb,
                            const double* cb, const double* rb, int natm,
                            const double* zr, const double* zq,
                            const double* Sa, const double* Sb, double* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, out, s
#define PT_TV(A, B) \
  if (with_tv && la == A && lb == B) return launch<A, B, true>(PT_ARGS);
#define PT_S(A, B) \
  if (!with_tv && la == A && lb == B) return launch<A, B, false>(PT_ARGS);
  PT_TV(0, 0) PT_TV(0, 1) PT_TV(0, 2) PT_TV(1, 1) PT_TV(1, 2) PT_TV(2, 2)
  PT_S(0, 0) PT_S(0, 1) PT_S(0, 2) PT_S(1, 0) PT_S(1, 1) PT_S(1, 2)
  PT_S(2, 0) PT_S(2, 1) PT_S(2, 2)
#undef PT_TV
#undef PT_S
#undef PT_ARGS
  return -1;
}
