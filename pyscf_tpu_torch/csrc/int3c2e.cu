// Three-centre Coulomb integrals (ij|P) for the density-fitting factor.
//
// Replaces the integral part of pyscf_tpu/ops/integrals/j3c.py:
// _class_program (with _pair_sph_tables and _aux_prep); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j3c.py:int3c2e_plain. The whitening product
// that follows (rows @ (L^-1)^T) is a plain GEMM and stays a library call.
//
// One launch per (bra class, aux class), la <= lb <= 4 and lc <= 5; the
// library is built once per bra momentum la (-DPT_LA), so that nvcc
// compiles the classes in five processes side by side. One thread per
// (screened shell pair, aux shell) owns its (2la+1)(2lb+1) x (2lc+1)
// output block, so there are no atomics and the rows are the same from run
// to run. Neighbouring threads share the bra pair and walk neighbouring aux
// shells. The thread loops over the bra primitive pairs and the aux
// primitives and evaluates Boys + R_tuv up to L = la+lb+lc <= 13 (560
// Hermite terms). What bounds it on the card is FP64 arithmetic in that
// recursion and in the Hermite contraction; the tables live in per-thread
// local memory, which spills at (dd|g) and reaches ~50 KB a thread at
// (gg|h). The simple design accepts the spills: it is right first, and
// the rows are built once per geometry.
//
// out: row (pair*(2la+1)(2lb+1) + sa*(2lb+1) + sb), column col0 + P*(2lc+1)
// + sc, leading dimension ld (the grouped aux order of the JAX package).
#include <cuda_runtime.h>

#include "hermite.cuh"

template <int LA, int LB, int LC>
__global__ void __launch_bounds__(128) int3c2e_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nsx, int Kc,
    const double* __restrict__ ec, const double* __restrict__ cc,
    const double* __restrict__ rc, const double* __restrict__ Sa,
    const double* __restrict__ Sb, const double* __restrict__ Sc,
    double* __restrict__ out, int ld, int col0, double omega) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * nsx) return;
  const int ip = (int)(idx / nsx);
  const int P = (int)(idx % nsx);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  double res[DA * DB * DC];
  coulomb_block<LA, LB, LC>(Ka, ea + (size_t)ip * Ka, ca + (size_t)ip * Ka,
                            ra + 3 * (size_t)ip, Kb, eb + (size_t)ip * Kb,
                            cb + (size_t)ip * Kb, rb + 3 * (size_t)ip, Kc,
                            ec + (size_t)P * Kc, cc + (size_t)P * Kc,
                            rc + 3 * (size_t)P, Sa, Sb, Sc, omega, res);
  for (int ab = 0; ab < DA * DB; ++ab) {
    double* row = out + ((size_t)ip * DA * DB + ab) * ld + col0 + P * DC;
    for (int sc = 0; sc < DC; ++sc) row[sc] = res[ab * DC + sc];
  }
}

template <int LA, int LB, int LC>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nsx, int Kc, const double* ec,
                  const double* cc, const double* rc, const double* Sa,
                  const double* Sb, const double* Sc, double* out, int ld,
                  int col0, double omega, cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)n * nsx;
  const int blocks = (int)((total + threads - 1) / threads);
  int3c2e_kernel<LA, LB, LC><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, Sa, Sb, Sc,
      out, ld, col0, omega);
  return (int)cudaGetLastError();
}

// omega > 0: the erf(omega r)/r attenuated integrals (0: the full
// operator). Returns cudaGetLastError() after the launch, or -1 for a class
// that has no instantiation in this library (la == PT_LA, la <= lb <= 4,
// lc <= 5).
extern "C" int pt_int3c2e(int la, int lb, int lc, int n, int Ka, int Kb,
                          const double* ea, const double* ca,
                          const double* ra, const double* eb,
                          const double* cb, const double* rb, int nsx,
                          int Kc, const double* ec, const double* cc,
                          const double* rc, const double* Sa,
                          const double* Sb, const double* Sc, double* out,
                          int ld, int col0, double omega, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, \
                Sa, Sb, Sc, out, ld, col0, omega, s
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
