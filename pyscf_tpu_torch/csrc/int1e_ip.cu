// Bra-centre derivatives of the overlap, kinetic and nuclear-attraction
// integrals per ordered shell pair, for the nuclear gradient.
//
// Replaces pyscf_tpu/ops/integrals/int1e_deriv.py:ipovlp_chunk, ipkin_chunk
// and ipnuc_chunk (with the prim-sum and cart->sph of int1e.py:_assemble);
// plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e_deriv.py:class_ip.
//
// d/dA_x [x_A^i e^{-a x_A^2}] = 2a x_A^{i+1} - i x_A^{i-1}, so the
// derivative of a block is 2a times the block of the raised bra shell
// la + 1 less i times the block of the lowered shell la - 1. The thread
// accumulates the cartesian [S, T, V] of both shells over the primitive
// pairs (2a folded into the raised shell's weight) from one set of E tables,
// e1d<la + 1, lb + 2>, and one R_tuv sum over the atoms to order la + lb + 1,
// and applies the rule once, at the end, before the cart->sph transform.
// <d a|b> is not symmetric in a and b: the caller passes every ordered pair.
//
// One thread per shell pair owns its output rows: no atomics, the same
// result from run to run. What bounds it on the card is FP64 arithmetic in
// the Boys series and the R recursion (one per atom and primitive pair);
// the tables live in per-thread local memory, as in int1e_stv.cu.
//
// out: (n, (2la+1)(2lb+1), 9), [ipovlp, ipkin, ipnuc] x [x, y, z].
#include <cuda_runtime.h>

#include "int1e.cuh"

template <int LA, int LB>
__global__ void __launch_bounds__(128) int1e_ip_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int natm, const double* __restrict__ zr,
    const double* __restrict__ zq, const double* __restrict__ Sa,
    const double* __restrict__ Sb, double* __restrict__ out) {
  const int ip = blockIdx.x * blockDim.x + threadIdx.x;
  if (ip >= n) return;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int NCP = n_cart(LA + 1);
  constexpr int NCM = LA > 0 ? n_cart(LA - 1) : 1;
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int L1 = LA + LB + 1;
  constexpr int NE = (LA + 2) * (LB + 3) * (L1 + 3);   // e1d<LA + 1, LB + 2>

  double accp[3 * NCP * NCB], accm[3 * NCM * NCB];
  for (int k = 0; k < 3 * NCP * NCB; ++k) accp[k] = 0.0;
  for (int k = 0; k < 3 * NCM * NCB; ++k) accm[k] = 0.0;
  double Ex[NE], Ey[NE], Ez[NE];
  double R[n_tuv(L1)], RZ[n_tuv(L1)];
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
      const double p = a + b;
      e1d<LA + 1, LB + 2>(a, b, A[0] - B[0], Ex);
      e1d<LA + 1, LB + 2>(a, b, A[1] - B[1], Ey);
      e1d<LA + 1, LB + 2>(a, b, A[2] - B[2], Ez);
      nuclear_R<L1>(p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
                    (a * A[2] + b * B[2]) / p, natm, zr, zq, R, RZ);
      stv_accumulate<LA + 1, LA + 1, LB, true>(2.0 * a * w, b, p, Ex, Ey, Ez,
                                               RZ, accp);
      if constexpr (LA > 0) {
        stv_accumulate<LA - 1, LA + 1, LB, true>(w, b, p, Ex, Ey, Ez, RZ,
                                                 accm);
      }
    }
  }

  double blk[NCA * NCB];
  for (int x = 0; x < 3; ++x) {
    const double* up = accp + x * NCP * NCB;
    const double* dn = accm + x * NCM * NCB;
    for (int d = 0; d < 3; ++d) {
      int ia = 0;
      for (int ix = LA; ix >= 0; --ix) {
        for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
          const int c[3] = {ix, iy, LA - ix - iy};
          const int pu = cart_pos(c[1] + (d == 1), c[2] + (d == 2));
          const int pd = cart_pos(c[1] - (d == 1), c[2] - (d == 2));
          for (int jb = 0; jb < NCB; ++jb) {
            double v = up[pu * NCB + jb];
            if (c[d] > 0) v -= c[d] * dn[pd * NCB + jb];
            blk[ia * NCB + jb] = v;
          }
        }
      }
      for (int sa = 0; sa < DA; ++sa) {
        for (int sb = 0; sb < DB; ++sb) {
          out[((size_t)ip * DA * DB + sa * DB + sb) * 9 + x * 3 + d] =
              sph_element<LA, LB>(Sa, Sb, sa, sb, blk, 1);
        }
      }
    }
  }
}

template <int LA, int LB>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int natm, const double* zr,
                  const double* zq, const double* Sa, const double* Sb,
                  double* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  int1e_ip_kernel<LA, LB><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (la, lb <= 2, every ordered pair).
extern "C" int pt_int1e_ip(int la, int lb, int n, int Ka, int Kb,
                           const double* ea, const double* ca,
                           const double* ra, const double* eb,
                           const double* cb, const double* rb, int natm,
                           const double* zr, const double* zq,
                           const double* Sa, const double* Sb, double* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_C(A, B) \
  if (la == A && lb == B) \
    return launch<A, B>(n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, \
                        Sb, out, s);
  PT_C(0, 0) PT_C(0, 1) PT_C(0, 2) PT_C(1, 0) PT_C(1, 1) PT_C(1, 2)
  PT_C(2, 0) PT_C(2, 1) PT_C(2, 2)
#undef PT_C
  return -1;
}
