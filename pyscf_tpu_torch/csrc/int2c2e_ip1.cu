// First nuclear derivatives of the aux metric (P|Q), contracted with the DF
// gradient's weights W_PQ.
//
// Replaces what jax.grad makes of pyscf_tpu/grad/autodiff.py _j2c (:131)
// through pyscf_tpu/ops/integrals/int2e.py _eri_core (:127) and
// _aux_data_kernel (:235); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j3c_deriv.py:int2c2e_ip1_plain. The sums by
// atom that follow are index_add_ calls.
//
// One launch per ordered aux class pair (lx, ly), 36 for shells up to h:
// one thread per (P, Q) shell pair writes sum_pq W_pq d(p|q)/dR_P, three
// numbers, to its own slot, so there are no atomics. Q is the bra, a single
// shell with an s partner of exponent 0, and P the single-Gaussian ket:
// d/dR_P is one step up in the Hermite index of P's fold, contracted with
// the W block at once (coulomb_ip.cuh, without the bra derivative). d/dR_Q
// = -d/dR_P (translational invariance) is left to the caller. What bounds
// it on the card is FP64 arithmetic in Boys and R_tuv to order lx + ly + 1
// <= 11; the metric is small (558 x 558 at benzene), so most of the card
// idles, and it runs once per gradient.
//
// W: (naux, naux), grouped aux order, leading dimension ld, the class
// blocks at rows offy (Q) and columns offx (P); out: (nsh, nsh, 3), entry
// (shx + P, shy + Q).
#include <cuda_runtime.h>

#include "coulomb_ip.cuh"

template <int LX, int LY>
__global__ void __launch_bounds__(128) int2c2e_ip1_kernel(
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
  const double* RQ = ry + 3 * (size_t)Q;
  double dP[3];
  coulomb_ip_block<LY, 0, LX, false>(
      Ky, ey + (size_t)Q * Ky, cy + (size_t)Q * Ky, RQ, 1, &zero, &one, RQ,
      Kx, ex + (size_t)P * Kx, cx + (size_t)P * Kx, rx + 3 * (size_t)P, Sy,
      &one, Sx, W + (size_t)(offy + Q * DY) * ld + offx + P * DX, ld,
      nullptr, dP);
  double* o = out + ((size_t)(shx + P) * nsh + shy + Q) * 3;
  for (int d = 0; d < 3; ++d) o[d] = dP[d];
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
  int2c2e_ip1_kernel<LX, LY><<<blocks, threads, 0, stream>>>(
      nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, W, ld, offx, offy,
      out, nsh, shx, shy);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class pair that
// has no instantiation (lx, ly <= 5).
extern "C" int pt_int2c2e_ip1(int lx, int ly, int nsx, int Kx,
                              const double* ex, const double* cx,
                              const double* rx, int nsy, int Ky,
                              const double* ey, const double* cy,
                              const double* ry, const double* Sx,
                              const double* Sy, const double* W, int ld,
                              int offx, int offy, double* out, int nsh,
                              int shx, int shy, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, W, ld, \
                offx, offy, out, nsh, shx, shy, s
#define PT_C(X, Y) if (lx == X && ly == Y) return launch<X, Y>(PT_ARGS);
#define PT_X(X) PT_C(X, 0) PT_C(X, 1) PT_C(X, 2) PT_C(X, 3) PT_C(X, 4) \
                PT_C(X, 5)
  PT_X(0) PT_X(1) PT_X(2) PT_X(3) PT_X(4) PT_X(5)
#undef PT_X
#undef PT_C
#undef PT_ARGS
  return -1;
}
