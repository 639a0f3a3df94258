// Two-centre Coulomb metric (P|Q) of the auxiliary basis.
//
// Replaces pyscf_tpu/ops/integrals/j3c.py:_eri_2c_sph inside _j2c_whitener;
// plain PyTorch twin: pyscf_tpu_torch/ops/integrals/j3c.py:int2c2e_plain.
// The Cholesky factor and the triangular inverse that follow are library
// calls (torch.linalg).
//
// One launch per aux class pair (lx <= ly): one thread per (P, Q) shell
// pair owns its (2lx+1) x (2ly+1) block and, for lx < ly, also writes the
// transposed block, so the full symmetric matrix is filled without atomics.
// The bra is the single shell P, written as a pair with an s partner of
// exponent 0 (coulomb_block with LB = 0). What bounds it on the card is
// FP64 arithmetic in the Boys series and the R recursion up to L = 10
// (the h shells of cc-pvqz-jkfit); the metric is 558 x 558 for
// benzene/def2-universal-jkfit and 1390 x 1390 for (H2O)10/cc-pvtz-jkfit, so the simple
// design leaves most of the card idle and is still cheap next to the 3c
// rows.
//
// out: (naux, naux) in grouped aux order, leading dimension ld; the class
// blocks start at rows/columns offx and offy.
#include <cuda_runtime.h>

#include "hermite.cuh"

template <int LX, int LY>
__global__ void __launch_bounds__(128) int2c2e_kernel(
    int nsx, int Kx, const double* __restrict__ ex,
    const double* __restrict__ cx, const double* __restrict__ rx, int nsy,
    int Ky, const double* __restrict__ ey, const double* __restrict__ cy,
    const double* __restrict__ ry, const double* __restrict__ Sx,
    const double* __restrict__ Sy, double* __restrict__ out, int ld,
    int offx, int offy, double omega) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)nsx * nsy) return;
  const int P = (int)(idx / nsy);
  const int Q = (int)(idx % nsy);
  constexpr int DX = 2 * LX + 1, DY = 2 * LY + 1;
  const double zero = 0.0, one = 1.0;
  const double* A = rx + 3 * (size_t)P;
  double res[DX * DY];
  coulomb_block<LX, 0, LY>(Kx, ex + (size_t)P * Kx, cx + (size_t)P * Kx, A,
                           1, &zero, &one, A, Ky, ey + (size_t)Q * Ky,
                           cy + (size_t)Q * Ky, ry + 3 * (size_t)Q, Sx, &one,
                           Sy, omega, res);
  for (int sx = 0; sx < DX; ++sx) {
    for (int sy = 0; sy < DY; ++sy) {
      const double v = res[sx * DY + sy];
      const size_t r = offx + (size_t)P * DX + sx;
      const size_t c = offy + (size_t)Q * DY + sy;
      out[r * ld + c] = v;
      if (LX < LY) out[c * ld + r] = v;
    }
  }
}

template <int LX, int LY>
static int launch(int nsx, int Kx, const double* ex, const double* cx,
                  const double* rx, int nsy, int Ky, const double* ey,
                  const double* cy, const double* ry, const double* Sx,
                  const double* Sy, double* out, int ld, int offx, int offy,
                  double omega, cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)nsx * nsy;
  const int blocks = (int)((total + threads - 1) / threads);
  int2c2e_kernel<LX, LY><<<blocks, threads, 0, stream>>>(
      nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, out, ld, offx, offy,
      omega);
  return (int)cudaGetLastError();
}

// omega > 0: the erf(omega r)/r attenuated metric (0: the full operator).
// Returns cudaGetLastError() after the launch, or -1 for a class pair that
// has no instantiation (lx <= ly <= 5).
extern "C" int pt_int2c2e(int lx, int ly, int nsx, int Kx, const double* ex,
                          const double* cx, const double* rx, int nsy, int Ky,
                          const double* ey, const double* cy,
                          const double* ry, const double* Sx,
                          const double* Sy, double* out, int ld, int offx,
                          int offy, double omega, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS nsx, Kx, ex, cx, rx, nsy, Ky, ey, cy, ry, Sx, Sy, out, ld, \
                offx, offy, omega, s
#define PT_C(X, Y) if (lx == X && ly == Y) return launch<X, Y>(PT_ARGS);
  PT_C(0, 0) PT_C(0, 1) PT_C(0, 2) PT_C(0, 3) PT_C(0, 4) PT_C(0, 5)
  PT_C(1, 1) PT_C(1, 2) PT_C(1, 3) PT_C(1, 4) PT_C(1, 5)
  PT_C(2, 2) PT_C(2, 3) PT_C(2, 4) PT_C(2, 5)
  PT_C(3, 3) PT_C(3, 4) PT_C(3, 5)
  PT_C(4, 4) PT_C(4, 5)
  PT_C(5, 5)
#undef PT_C
#undef PT_ARGS
  return -1;
}
