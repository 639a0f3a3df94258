// First nuclear derivatives of the three-centre Coulomb integrals (ij|P),
// written out uncontracted for the nuclear Hessian: d(ij|P)/dA_i for every
// function pair in both orders.
//
// Replaces what jax.jvp makes of pyscf_tpu/hessian/rhf.py _j3c_builder
// (:73-102) through pyscf_tpu/ops/integrals/int2e.py _eri_core (:127) and
// _paired_data_kernel (:310), the 3c part of _chunked_jvp(fock) (:270);
// plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j3c_deriv.py:int3c2e_ip1_plain. The aux
// centre's derivative follows by translational invariance, -(d/dA_i +
// d/dA_j), in the caller; no kernel is needed for it.
//
// One launch per (ordered bra class, aux class), one thread per (ordered
// shell pair, aux shell): the power-shift rule on the raised and lowered bra
// shells from one set of tables e1d<la + 1, lb> (coulomb_ipip.cuh
// coulomb_ip1_block, int3c2e_ip.cu's design without the weights), then the
// thread writes its 3 (2la+1)(2lb+1)(2lc+1) numbers to its own place in the
// dense tensor: no atomics. Every ordered (la, lb) <= 4 against lc <= 5;
// the library is built once per bra momentum la (-DPT_LA). What bounds it
// on the card is FP64 arithmetic in the fold of the aux shell (R_tuv to
// order la + lb + lc + 1, 14 at (gg|h)) and the 174 MB it writes at
// benzene/def2-SVP.
//
// ia, jb: AO offsets of the pairs' shells (int32, n); out: (3, nao, nao,
// naux), the aux index in grouped order, this class's shells at col0.
#include <cuda_runtime.h>

#include "coulomb_ipip.cuh"

template <int LA, int LB, int LC>
__global__ void __launch_bounds__(128) int3c2e_ip1_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nsx, int Kc,
    const double* __restrict__ ec, const double* __restrict__ cc,
    const double* __restrict__ rc, const double* __restrict__ Sa,
    const double* __restrict__ Sb, const double* __restrict__ Sc,
    const int* __restrict__ ia, const int* __restrict__ jb, int nao,
    int naux, int col0, double* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * nsx) return;
  const int ip = (int)(idx / nsx);
  const int P = (int)(idx % nsx);
  constexpr int DC = 2 * LC + 1;
  const size_t ssb = (size_t)naux, ssa = (size_t)nao * ssb;
  coulomb_ip1_block<LA, LB, LC>(
      Ka, ea + (size_t)ip * Ka, ca + (size_t)ip * Ka, ra + 3 * (size_t)ip,
      Kb, eb + (size_t)ip * Kb, cb + (size_t)ip * Kb, rb + 3 * (size_t)ip,
      Kc, ec + (size_t)P * Kc, cc + (size_t)P * Kc, rc + 3 * (size_t)P, Sa,
      Sb, Sc, out + ia[ip] * ssa + jb[ip] * ssb + col0 + (size_t)P * DC,
      (size_t)nao * ssa, ssa, ssb);
}

template <int LA, int LB, int LC>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nsx, int Kc, const double* ec,
                  const double* cc, const double* rc, const double* Sa,
                  const double* Sb, const double* Sc, const int* ia,
                  const int* jb, int nao, int naux, int col0, double* out,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)n * nsx;
  const int blocks = (int)((total + threads - 1) / threads);
  int3c2e_ip1_kernel<LA, LB, LC><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, Sa, Sb, Sc, ia,
      jb, nao, naux, col0, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation in this library (la == PT_LA, lb <= 4, lc <= 5).
extern "C" int pt_int3c2e_ip1(int la, int lb, int lc, int n, int Ka, int Kb,
                              const double* ea, const double* ca,
                              const double* ra, const double* eb,
                              const double* cb, const double* rb, int nsx,
                              int Kc, const double* ec, const double* cc,
                              const double* rc, const double* Sa,
                              const double* Sb, const double* Sc,
                              const int* ia, const int* jb, int nao,
                              int naux, int col0, double* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, nsx, Kc, ec, cc, rc, \
                Sa, Sb, Sc, ia, jb, nao, naux, col0, out, s
#define PT_C(B, C) \
  if (la == PT_LA && lb == B && lc == C) return launch<PT_LA, B, C>(PT_ARGS);
#define PT_B(B) PT_C(B, 0) PT_C(B, 1) PT_C(B, 2) PT_C(B, 3) PT_C(B, 4) \
                PT_C(B, 5)
  PT_B(0) PT_B(1) PT_B(2) PT_B(3) PT_B(4)
#undef PT_B
#undef PT_C
#undef PT_ARGS
  return -1;
}
