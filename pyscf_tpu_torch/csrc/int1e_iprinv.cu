// Operator-centre derivatives d/dC <a|1/|r-C||b> per ordered shell pair and
// centre: the Hellmann-Feynman term of the nuclear gradient.
//
// Replaces pyscf_tpu/ops/integrals/int1e_deriv.py:iprinv_chunk (with the
// prim-sum and cart->sph of int1e.py:_assemble), which the JAX package
// runs once per atom; plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e_deriv.py:class_iprinv.
//
// <a|1/|r-C||b> = (2 pi / p) sum_tuv E_tuv R_tuv(p, P - C) and
// dR_tuv/dC_x = -R_{t+1,u,v}; in the JAX package's sign convention the
// derivative is (2 pi / p) sum_tuv E_tuv R_{tuv + e_d}(p, P - C), so the
// thread builds R_tuv to order la + lb + 1 once per primitive pair and
// reads it at three shifted positions. One launch takes every centre:
// one thread per (centre, shell pair) owns its 3 x (2la+1)(2lb+1) outputs,
// neighbouring threads share the centre. No atomics; FP64 arithmetic in the
// Boys series and the R recursion bounds it.
//
// out: (nc, 3, n, (2la+1)(2lb+1)).
#include <cuda_runtime.h>

#include "int1e.cuh"

template <int LA, int LB>
__global__ void __launch_bounds__(128) int1e_iprinv_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nc, const double* __restrict__ centers,
    const double* __restrict__ Sa, const double* __restrict__ Sb,
    double* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * nc) return;
  const int ip = (int)(idx % n);
  const int ic = (int)(idx / n);
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int L1 = LA + LB;
  constexpr int NT = L1 + 1;
  constexpr int NE = (LA + 1) * (LB + 1) * NT;

  double acc[3 * NCA * NCB];
  for (int k = 0; k < 3 * NCA * NCB; ++k) acc[k] = 0.0;
  double Ex[NE], Ey[NE], Ez[NE];
  double R[n_tuv(L1 + 1)];
  const double* A = ra + 3 * ip;
  const double* B = rb + 3 * ip;
  const double* C = centers + 3 * ic;

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
      const double p = a + b;
      e1d<LA, LB>(a, b, A[0] - B[0], Ex);
      e1d<LA, LB>(a, b, A[1] - B[1], Ey);
      e1d<LA, LB>(a, b, A[2] - B[2], Ez);
      hermite_R<L1 + 1>(p, (a * A[0] + b * B[0]) / p - C[0],
                        (a * A[1] + b * B[1]) / p - C[1],
                        (a * A[2] + b * B[2]) / p - C[2], R);
      const double pref = cak * cbk * (2.0 * PT_PI / p);
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int iz = LA - ix - iy;
          int jb = 0;
          for (int jx = LB; jx >= 0; --jx) {
            for (int jy = LB - jx; jy >= 0; --jy, ++jb) {
              const int jz = LB - jx - jy;
              double v[3] = {0.0, 0.0, 0.0};
              for (int t = 0; t <= ix + jx; ++t) {
                const double ex = Ex[(ix * (LB + 1) + jx) * NT + t];
                for (int u = 0; u <= iy + jy; ++u) {
                  const double exy = ex * Ey[(iy * (LB + 1) + jy) * NT + u];
                  for (int w = 0; w <= iz + jz; ++w) {
                    const double e = exy * Ez[(iz * (LB + 1) + jz) * NT + w];
                    v[0] += e * R[tuv_idx(t + 1, u, w)];
                    v[1] += e * R[tuv_idx(t, u + 1, w)];
                    v[2] += e * R[tuv_idx(t, u, w + 1)];
                  }
                }
              }
              for (int d = 0; d < 3; ++d) {
                acc[(d * NCA + ia) * NCB + jb] += pref * v[d];
              }
            }
          }
        }
      }
    }
  }

  for (int d = 0; d < 3; ++d) {
    double* row = out + (((size_t)ic * 3 + d) * n + ip) * DA * DB;
    for (int sa = 0; sa < DA; ++sa) {
      for (int sb = 0; sb < DB; ++sb) {
        row[sa * DB + sb] =
            sph_element<LA, LB>(Sa, Sb, sa, sb, acc + d * NCA * NCB, 1);
      }
    }
  }
}

template <int LA, int LB>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nc, const double* centers,
                  const double* Sa, const double* Sb, double* out,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)n * nc;
  const int blocks = (int)((total + threads - 1) / threads);
  int1e_iprinv_kernel<LA, LB><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, nc, centers, Sa, Sb, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (la, lb <= 2, every ordered pair).
extern "C" int pt_int1e_iprinv(int la, int lb, int n, int Ka, int Kb,
                               const double* ea, const double* ca,
                               const double* ra, const double* eb,
                               const double* cb, const double* rb, int nc,
                               const double* centers, const double* Sa,
                               const double* Sb, double* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_C(A, B) \
  if (la == A && lb == B) \
    return launch<A, B>(n, Ka, Kb, ea, ca, ra, eb, cb, rb, nc, centers, Sa, \
                        Sb, out, s);
  PT_C(0, 0) PT_C(0, 1) PT_C(0, 2) PT_C(1, 0) PT_C(1, 1) PT_C(1, 2)
  PT_C(2, 0) PT_C(2, 1) PT_C(2, 2)
#undef PT_C
  return -1;
}
