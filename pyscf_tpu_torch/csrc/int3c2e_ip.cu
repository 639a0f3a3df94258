// First nuclear derivatives of the three-centre Coulomb integrals (ij|P),
// contracted with the DF gradient's weights Gamma^P_ij as they are made.
//
// Replaces what jax.grad makes of pyscf_tpu/grad/autodiff.py
// _df_intermediates (:148) through pyscf_tpu/ops/integrals/int2e.py
// _eri_core (:127), _paired_data_kernel (:310) and _aux_data_kernel (:235);
// plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j3c_deriv.py:int3c2e_ip_plain. The sums by
// atom that follow are index_add_ calls.
//
// The design is int3c2e.cu's: one launch per (bra class, aux class), one
// thread per (screened shell pair, aux shell), no atomics. The thread reads
// its (2la+1)(2lb+1) x (2lc+1) block of Gamma (sph, in the row layout of
// int3c2e's output), takes it to the cartesian bra basis once, and
// contracts it with the derivatives as the primitive loops make them
// (coulomb_ip.cuh): d/dA by the power-shift rule on the bra shell a, with
// the raised and lowered blocks accumulated from one set of tables
// e1d<la + 1, lb> and the rule applied once at the end (int2e_ip1.cu's
// design), and d/dC of the single-Gaussian aux shell by one step up in the
// Hermite index of the same Y, which costs three dot products per Hermite
// term and no accumulators. d/dB = -(d/dA + d/dC) (translational
// invariance). The thread writes six numbers: d/dA_xyz, d/dB_xyz.
//
// One launch per (bra class, aux class), la <= lb <= 4 and lc <= 5; the
// library is built once per bra momentum la (-DPT_LA), so that the classes
// compile in five processes side by side.
//
// What bounds it on the card is FP64 arithmetic: R_tuv to order
// la + lb + lc + 1 (9 for (dd|g), 220 terms, Boys m = 9; 14 for (gg|h))
// and the fold of the aux shell into Y to order la + lb + 1, per primitive
// triple. The tables live in per-thread local memory (about 16 KB for
// (dd|g), about 93 KB for (gg|h)); the simple design accepts it: the rows
// are contracted once per gradient.
//
// G: row (pair*(2la+1)(2lb+1) + sa*(2lb+1) + sb), column col0 + P*(2lc+1)
// + sc, leading dimension ld; out: (n, nsh, 6), this class's aux shells at
// sh0 + P.
#include <cuda_runtime.h>

#include "coulomb_ip.cuh"

template <int LA, int LB, int LC>
__global__ void __launch_bounds__(128) int3c2e_ip_kernel(
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
  double dA[3], dC[3];
  coulomb_ip_block<LA, LB, LC, true>(
      Ka, ea + (size_t)ip * Ka, ca + (size_t)ip * Ka, ra + 3 * (size_t)ip,
      Kb, eb + (size_t)ip * Kb, cb + (size_t)ip * Kb, rb + 3 * (size_t)ip,
      Kc, ec + (size_t)P * Kc, cc + (size_t)P * Kc, rc + 3 * (size_t)P, Sa,
      Sb, Sc, G + (size_t)ip * DA * DB * ld + col0 + (size_t)P * DC, ld, dA,
      dC);
  double* o = out + ((size_t)ip * nsh + sh0 + P) * 6;
  for (int d = 0; d < 3; ++d) {
    o[d] = dA[d];
    o[3 + d] = -(dA[d] + dC[d]);
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
  int3c2e_ip_kernel<LA, LB, LC><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, Sa, Sb, Sc, G,
      ld, col0, out, nsh, sh0);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation in this library (la == PT_LA <= lb <= 4, lc <= 5).
extern "C" int pt_int3c2e_ip(int la, int lb, int lc, int n, int Ka, int Kb,
                             const double* ea, const double* ca,
                             const double* ra, const double* eb,
                             const double* cb, const double* rb, int nsx,
                             int Kc, const double* ec, const double* cc,
                             const double* rc, const double* Sa,
                             const double* Sb, const double* Sc,
                             const double* G, int ld, int col0, double* out,
                             int nsh, int sh0, void* stream) {
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
