// Nuclear derivatives of the aux metric (P|Q) for the nuclear Hessian: two
// kernels from one source, one per library.
//
//  int2c2e_ip1_full  (built with -DPT_IP1_FULL) d(P|Q)/dR_P written out,
//       (3, naux, naux): the metric's part of _chunked_jvp(fock)
//       (pyscf_tpu/hessian/rhf.py:270 through grad/autodiff.py _j2c :131);
//       twin pyscf_tpu_torch/ops/integrals/j3c_deriv.py:int2c2e_ip1_full_plain.
//  int2c2e_ipip      d2(P|Q)/dR_P dR_P contracted with W_PQ per ordered aux
//       shell pair, (nsh, nsh, 9): the metric's second-derivative part of
//       jv_rows (:327); twin j3c_deriv.py:int2c2e_ipip_plain. d/dR_Q =
//       -d/dR_P (translational invariance) is left to the caller.
//
// The design is int2c2e_ip1.cu's: one launch per ordered aux class pair,
// one thread per (P, Q) shell pair writing its own slots, no atomics.
// int2c2e_ip1_full takes P as the bra, a single shell with an s partner of
// exponent 0 on its own centre, and Q as the single-Gaussian ket, and
// applies the power-shift rule on P (coulomb_ipip.cuh coulomb_ip1_block).
// int2c2e_ipip takes Q as the bra and P as the ket, whose Hermite expansion
// does not depend on R_P: d2/dR_P dR_P is two steps up in the Hermite index
// of P's fold Y (coulomb_ipip.cuh coulomb_ipip_block without the bra's
// derivatives). The metric is small (558 x 558 at benzene/def2-SVP), so most
// of the card idles; both run once per Hessian.
//
// Both take the same arguments. W: (naux, naux), grouped aux order,
// leading dimension ld, the class blocks at rows offy (Q) and columns offx
// (P); ip1_full reads no W and takes ld = naux. out: ip1_full (3, naux,
// naux) at rows offx + P's functions (the derivative's centre) and columns
// offy + Q's; ipip (nsh, nsh, 9) at entry (shx + P, shy + Q).
#include <cuda_runtime.h>

#include "coulomb_ipip.cuh"

template <int LX, int LY>
__global__ void __launch_bounds__(128) int2c2e_deriv_kernel(
    int nsx, int Kx, const double* __restrict__ ex,
    const double* __restrict__ cx, const double* __restrict__ rx, int nsy,
    int Ky, const double* __restrict__ ey, const double* __restrict__ cy,
    const double* __restrict__ ry, const double* __restrict__ Sx,
    const double* __restrict__ Sy, const double* __restrict__ W, int ld,
    int offx, int offy, double* __restrict__ out, int nsh, int shx,
    int shy) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)nsx * nsy) return;
  const int P = (int)(idx / nsy);
  const int Q = (int)(idx % nsy);
  constexpr int DX = 2 * LX + 1, DY = 2 * LY + 1;
  const double zero = 0.0, one = 1.0;
  const double* RP = rx + 3 * (size_t)P;
  const double* RQ = ry + 3 * (size_t)Q;
#ifdef PT_IP1_FULL
  coulomb_ip1_block<LX, 0, LY>(
      Kx, ex + (size_t)P * Kx, cx + (size_t)P * Kx, RP, 1, &zero, &one, RP,
      Ky, ey + (size_t)Q * Ky, cy + (size_t)Q * Ky, RQ, Sx, &one, Sy,
      out + (size_t)(offx + P * DX) * ld + offy + (size_t)Q * DY,
      (size_t)ld * ld, ld, 0);
#else
  double pp[9];
  for (int k = 0; k < 9; ++k) pp[k] = 0.0;
  coulomb_ipip_block<LY, 0, LX, false>(
      Ky, ey + (size_t)Q * Ky, cy + (size_t)Q * Ky, RQ, 1, &zero, &one, RQ,
      Kx, ex + (size_t)P * Kx, cx + (size_t)P * Kx, RP, Sy, &one, Sx,
      W + (size_t)(offy + Q * DY) * ld + offx + P * DX, ld, nullptr, nullptr,
      pp);
  double* o = out + ((size_t)(shx + P) * nsh + shy + Q) * 9;
  for (int k = 0; k < 9; ++k) o[k] = pp[k];
#endif
}

template <int LX, int LY>
static int launch(int nsx, int Kx, const double* ex, const double* cx,
                  const double* rx, int nsy, int Ky, const double* ey,
                  const double* cy, const double* ry, const double* Sx,
                  const double* Sy, const double* W, int ld, int offx,
                  int offy, double* out, int nsh, int shx, int shy,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)nsx * nsy;
  const int blocks = (int)((total + threads - 1) / threads);
  int2c2e_deriv_kernel<LX, LY><<<blocks, threads, 0, stream>>>(
      nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, W, ld, offx, offy,
      out, nsh, shx, shy);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class pair that
// has no instantiation (lx, ly <= 5).
#ifdef PT_IP1_FULL
extern "C" int pt_int2c2e_ip1_full(
#else
extern "C" int pt_int2c2e_ipip(
#endif
    int lx, int ly, int nsx, int Kx, const double* ex, const double* cx,
    const double* rx, int nsy, int Ky, const double* ey, const double* cy,
    const double* ry, const double* Sx, const double* Sy, const double* W,
    int ld, int offx, int offy, double* out, int nsh, int shx, int shy,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_C(X, Y) \
  if (lx == X && ly == Y) \
    return launch<X, Y>(nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, W, \
                        ld, offx, offy, out, nsh, shx, shy, s);
#define PT_X(X) PT_C(X, 0) PT_C(X, 1) PT_C(X, 2) PT_C(X, 3) PT_C(X, 4) \
                PT_C(X, 5)
  PT_X(0) PT_X(1) PT_X(2) PT_X(3) PT_X(4) PT_X(5)
#undef PT_X
#undef PT_C
  return -1;
}
