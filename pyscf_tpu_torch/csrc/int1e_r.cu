// Dipole integrals <a| r_d |b> per shell pair, the origin at the coordinate
// origin.
//
// Replaces pyscf_tpu/ops/integrals/int1e.py:93 r_chunk (assembled by
// int1e.py:233 int1e_r over every ordered class pair, unscreened, as the
// JAX _assemble does); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e.py:class_r (over r_chunk).
//
// With r_d = (r - B)_d + B_d, the d component of a cartesian pair is the
// overlap with the ket's d index raised by one, plus B_d times the overlap:
//   <a|r_d|b> = w (s_d(i, j + 1) + B_d s_d(i, j)) prod_{d' != d} s_d'(i, j)
// with s(i, j) = E_0^{i,j} sqrt(pi / p), the 1D Hermite tables of
// hermite.cuh to lb + 1. This is the overlap path of int1e.cuh's
// stv_accumulate with one raised ket index.
//
// One thread per shell pair owns its output rows, as in int1e_stv.cu, so
// there are no atomics and the result is the same from run to run. The
// thread loops over the primitive pairs, builds the three tables and
// accumulates the cartesian block, then folds it to spherical rows. What
// bounds it on the card is the bytes of its output and pair tables: per
// primitive pair a few hundred operations, once; the simple design keeps
// every table in per-thread local memory.
//
// out: (n, (2la+1)(2lb+1), 3) rows of [x, y, z].
#include <cuda_runtime.h>

#include "int1e.cuh"

template <int LA, int LB>
__global__ void __launch_bounds__(128) int1e_r_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, const double* __restrict__ Sa,
    const double* __restrict__ Sb, double* __restrict__ out) {
  const int ip = blockIdx.x * blockDim.x + threadIdx.x;
  if (ip >= n) return;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int NJ = LB + 2;                 // j <= lb + 1
  constexpr int NT = LA + LB + 2;            // t <= la + lb + 1
  constexpr int NE = (LA + 1) * NJ * NT;     // e1d<LA, LB + 1>
#define PT_E0(E, i, j) E[((i) * NJ + (j)) * NT]

  double acc[3 * NCA * NCB];
  for (int k = 0; k < 3 * NCA * NCB; ++k) acc[k] = 0.0;
  double E[3][NE];
  const double* A = ra + 3 * ip;
  const double* B = rb + 3 * ip;

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
      const double sq = sqrt(PT_PI / (a + b));
      for (int d = 0; d < 3; ++d) e1d<LA, LB + 1>(a, b, A[d] - B[d], E[d]);
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int ii[3] = {ix, iy, LA - ix - iy};
          int jb = 0;
          for (int jx = LB; jx >= 0; --jx) {
            for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
              const int jj[3] = {jx, jy, LB - jx - jy};
              double s[3], s1[3];
              for (int d = 0; d < 3; ++d) {
                s[d] = PT_E0(E[d], ii[d], jj[d]) * sq;
                s1[d] = PT_E0(E[d], ii[d], jj[d] + 1) * sq;
              }
              const int o = ia * NCB + jb;
              for (int d = 0; d < 3; ++d) {
                double v = s1[d] + B[d] * s[d];
                for (int dd = 0; dd < 3; ++dd) {
                  if (dd != d) v = v * s[dd];
                }
                acc[d * NCA * NCB + o] += w * v;
              }
            }
          }
        }
      }
    }
  }
#undef PT_E0

  for (int sa = 0; sa < DA; ++sa) {
    for (int sb = 0; sb < DB; ++sb) {
      for (int d = 0; d < 3; ++d) {
        out[((size_t)ip * DA * DB + sa * DB + sb) * 3 + d] =
            sph_element<LA, LB>(Sa, Sb, sa, sb, acc + d * NCA * NCB, 1);
      }
    }
  }
}

template <int LA, int LB>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, const double* Sa, const double* Sb,
                  double* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  int1e_r_kernel<LA, LB><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, Sa, Sb, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (la, lb <= 4).
extern "C" int pt_int1e_r(int la, int lb, int n, int Ka, int Kb,
                          const double* ea, const double* ca,
                          const double* ra, const double* eb,
                          const double* cb, const double* rb,
                          const double* Sa, const double* Sb, double* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, Sa, Sb, out, s
#define PT_R(A, B) \
  if (la == A && lb == B) return launch<A, B>(PT_ARGS);
#define PT_ROW(A) PT_R(A, 0) PT_R(A, 1) PT_R(A, 2) PT_R(A, 3) PT_R(A, 4)
  PT_ROW(0) PT_ROW(1) PT_ROW(2) PT_ROW(3) PT_ROW(4)
#undef PT_ROW
#undef PT_R
#undef PT_ARGS
  return -1;
}
