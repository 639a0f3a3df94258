// Second nuclear derivatives of the three-centre Coulomb integrals (ij|P),
// contracted with the DF gradient's weights Gamma^P_ij as they are made, for
// the nuclear Hessian.
//
// Replaces what jax.jvp of jax.grad makes of the 3c term of
// pyscf_tpu/hessian/rhf.py e_fix (:236-245) through _j3c_builder (:73-102),
// pyscf_tpu/ops/integrals/int2e.py _eri_core (:127) and _paired_data_kernel
// (:310), the second-derivative part of jv_rows (:327); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j3c_deriv.py:int3c2e_ipip_plain. The sums
// by atom pair that follow are index_add_ calls.
//
// The design is int3c2e_ip.cu's: one launch per (bra class, aux class), one
// thread per (screened shell pair, aux shell), no atomics. The thread
// contracts its block of Gamma with the second derivatives as the primitive
// loops make them (coulomb_ipip.cuh): on the bra centre A by the power-shift
// rule twice, from one set of tables e1d<la + 2, lb>, and on the aux centre
// C by steps up in the Hermite index of the aux fold Y (to order la + lb +
// 2), so that d2/dA dA, d2/dA dC and d2/dC dC come from one fold; then
// translational invariance, d/dB = -(d/dA + d/dC), gives the thread's 27
// numbers: AA, AB and BB (3 x 3 each, row-major). The aux centre's rows
// follow in the caller the same way.
//
// What bounds it on the card is FP64 arithmetic: R_tuv to order la + lb +
// lc + 2 (10 for (dd|g), 15 for (gg|h)) in the fold, and the shifted
// Hermite sums per cartesian bra component; the tables live in per-thread
// local memory. la <= lb <= 4, lc <= 5; the library is built once per bra
// momentum la (-DPT_LA).
//
// G: row (pair*(2la+1)(2lb+1) + sa*(2lb+1) + sb), column col0 + P*(2lc+1)
// + sc, leading dimension ld (int3c2e_ip.cu's layout); out: (n, nsh, 27),
// this class's aux shells at sh0 + P.
#include <cuda_runtime.h>

#include "coulomb_ipip.cuh"

template <int LA, int LB, int LC>
__global__ void __launch_bounds__(128) int3c2e_ipip_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nsx, int Kc,
    const double* __restrict__ ec, const double* __restrict__ cc,
    const double* __restrict__ rc, const double* __restrict__ Sa,
    const double* __restrict__ Sb, const double* __restrict__ Sc,
    const double* __restrict__ G, int ld, int col0,
    double* __restrict__ out, int nsh, int sh0) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * nsx) return;
  const int ip = (int)(idx / nsx);
  const int P = (int)(idx % nsx);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  double aa[9], ac[9], cx[9];
  for (int k = 0; k < 9; ++k) aa[k] = ac[k] = cx[k] = 0.0;
  coulomb_ipip_block<LA, LB, LC, true>(
      Ka, ea + (size_t)ip * Ka, ca + (size_t)ip * Ka, ra + 3 * (size_t)ip,
      Kb, eb + (size_t)ip * Kb, cb + (size_t)ip * Kb, rb + 3 * (size_t)ip,
      Kc, ec + (size_t)P * Kc, cc + (size_t)P * Kc, rc + 3 * (size_t)P, Sa,
      Sb, Sc, G + (size_t)ip * DA * DB * ld + col0 + (size_t)P * DC, ld, aa,
      ac, cx);
  double* o = out + ((size_t)ip * nsh + sh0 + P) * 27;
  for (int x = 0; x < 3; ++x) {
    for (int y = 0; y < 3; ++y) {
      const int k = x * 3 + y;
      o[k] = aa[k];
      o[9 + k] = -(aa[k] + ac[k]);
      o[18 + k] = aa[k] + ac[k] + ac[y * 3 + x] + cx[k];
    }
  }
}

template <int LA, int LB, int LC>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nsx, int Kc, const double* ec,
                  const double* cc, const double* rc, const double* Sa,
                  const double* Sb, const double* Sc, const double* G,
                  int ld, int col0, double* out, int nsh, int sh0,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)n * nsx;
  const int blocks = (int)((total + threads - 1) / threads);
  int3c2e_ipip_kernel<LA, LB, LC><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, Sa, Sb, Sc, G,
      ld, col0, out, nsh, sh0);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation in this library (la == PT_LA <= lb <= 4, lc <= 5).
extern "C" int pt_int3c2e_ipip(int la, int lb, int lc, int n, int Ka, int Kb,
                               const double* ea, const double* ca,
                               const double* ra, const double* eb,
                               const double* cb, const double* rb, int nsx,
                               int Kc, const double* ec, const double* cc,
                               const double* rc, const double* Sa,
                               const double* Sb, const double* Sc,
                               const double* G, int ld, int col0,
                               double* out, int nsh, int sh0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, \
                Sa, Sb, Sc, G, ld, col0, out, nsh, sh0, s
#define PT_C(B, C) \
  if (la == PT_LA && lb == B && lc == C) return launch<PT_LA, B, C>(PT_ARGS);
#define PT_B(B) PT_C(B, 0) PT_C(B, 1) PT_C(B, 2) PT_C(B, 3) PT_C(B, 4) \
                PT_C(B, 5)
#if PT_LA <= 0
  PT_B(0)
#endif
#if PT_LA <= 1
  PT_B(1)
#endif
#if PT_LA <= 2
  PT_B(2)
#endif
#if PT_LA <= 3
  PT_B(3)
#endif
  PT_B(4)
#undef PT_B
#undef PT_C
#undef PT_ARGS
  return -1;
}
