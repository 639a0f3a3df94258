// Overlap, kinetic and nuclear-attraction integrals per shell pair.
//
// Replaces pyscf_tpu/ops/integrals/j1e.py:_class_stv (which calls
// int1e.py:ovlp_chunk, kin_chunk and nuc_chunk); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int1e.py:class_stv. In S-only mode it also
// serves int1e_ovlp_cross (the minao guess's mol x minao overlap).
//
// One thread per shell pair owns its output rows, so there are no atomics
// and the result is the same from run to run. The thread loops over the
// primitive pairs, builds the 1D Hermite tables up to lb+2 (the kinetic
// term needs them), and for V sums R_tuv over the atoms (to L = la + lb
// = 8 at (gg)). What bounds it on
// the card is FP64 arithmetic in the Boys series and the R recursion of the
// nuclear term (one per atom and primitive pair); the simple design spends
// it once per pair and keeps every table in per-thread local memory.
//
// out: (n, (2la+1)(2lb+1), 3) rows of [S, T, V], or (n, (2la+1)(2lb+1)) of S.
#include <cuda_runtime.h>

#include "int1e.cuh"

template <int LA, int LB, bool TV>
__global__ void __launch_bounds__(128) int1e_stv_kernel(
    int n, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int natm, const double* __restrict__ zr,
    const double* __restrict__ zq, const double* __restrict__ Sa,
    const double* __restrict__ Sb, double* __restrict__ out) {
  const int ip = blockIdx.x * blockDim.x + threadIdx.x;
  if (ip >= n) return;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int L1 = LA + LB;
  constexpr int NE = (LA + 1) * (LB + 3) * (L1 + 3);   // e1d<LA, LB + 2>
  constexpr int NC = TV ? 3 : 1;

  double acc[NC * NCA * NCB];
  for (int k = 0; k < NC * NCA * NCB; ++k) acc[k] = 0.0;
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
      const double p = a + b;
      e1d<LA, LB + 2>(a, b, A[0] - B[0], Ex);
      e1d<LA, LB + 2>(a, b, A[1] - B[1], Ey);
      e1d<LA, LB + 2>(a, b, A[2] - B[2], Ez);
      if (TV) {
        nuclear_R<L1>(p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
                      (a * A[2] + b * B[2]) / p, natm, zr, zq, R, RZ);
      }
      stv_accumulate<LA, LA, LB, TV>(cak * cbk, b, p, Ex, Ey, Ez, RZ, acc);
    }
  }

  for (int sa = 0; sa < DA; ++sa) {
    for (int sb = 0; sb < DB; ++sb) {
      for (int x = 0; x < NC; ++x) {
        out[((size_t)ip * DA * DB + sa * DB + sb) * NC + x] =
            sph_element<LA, LB>(Sa, Sb, sa, sb, acc + x * NCA * NCB, 1);
      }
    }
  }
}

template <int LA, int LB, bool TV>
static int launch(int n, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int natm, const double* zr,
                  const double* zq, const double* Sa, const double* Sb,
                  double* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  int1e_stv_kernel<LA, LB, TV><<<blocks, threads, 0, stream>>>(
      n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class that has
// no instantiation (S/T/V needs la <= lb <= 4; S alone la, lb <= 4).
extern "C" int pt_int1e_stv(int la, int lb, int with_tv, int n, int Ka,
                            int Kb, const double* ea, const double* ca,
                            const double* ra, const double* eb,
                            const double* cb, const double* rb, int natm,
                            const double* zr, const double* zq,
                            const double* Sa, const double* Sb, double* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS n, Ka, Kb, ea, ca, ra, eb, cb, rb, natm, zr, zq, Sa, Sb, out, s
#define PT_TV(A, B) \
  if (with_tv && la == A && lb == B) return launch<A, B, true>(PT_ARGS);
#define PT_S(A, B) \
  if (!with_tv && la == A && lb == B) return launch<A, B, false>(PT_ARGS);
  PT_TV(0, 0) PT_TV(0, 1) PT_TV(0, 2) PT_TV(0, 3) PT_TV(0, 4)
  PT_TV(1, 1) PT_TV(1, 2) PT_TV(1, 3) PT_TV(1, 4)
  PT_TV(2, 2) PT_TV(2, 3) PT_TV(2, 4)
  PT_TV(3, 3) PT_TV(3, 4)
  PT_TV(4, 4)
#define PT_SA(A) PT_S(A, 0) PT_S(A, 1) PT_S(A, 2) PT_S(A, 3) PT_S(A, 4)
  PT_SA(0) PT_SA(1) PT_SA(2) PT_SA(3) PT_SA(4)
#undef PT_SA
#undef PT_S
#undef PT_TV
#undef PT_ARGS
  return -1;
}
