// Four-centre Coulomb integrals (ab|cd) for the in-core ERI tensor.
//
// Replaces pyscf_tpu/ops/integrals/j2e.py:_class_pair_program (with the
// _pair_sph_tables of both sides); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/j2e.py:int2e_class_plain. The gather of the
// rows into the dense (nao,)^4 tensor (_assemble_4c) is an index_select and
// stays a library call.
//
// One launch per ordered (bra class, ket class). One thread per (screened
// bra shell pair, screened ket shell pair, sph component sd of the ket's
// second shell) owns the (2la+1)(2lb+1)(2lc+1) numbers of its column sd, so
// there are no atomics and the rows are the same from run to run.
// Neighbouring threads share the bra pair. Splitting the ket's sd over
// threads keeps the per-thread tables of (dd|dd) (the bra's cartesian
// accumulators and Y, 36 x 5 and 35 x 5, R_tuv with 165 terms, the six E
// tables) near 6 KB of local memory; the price is that each thread redoes
// the Boys function, R_tuv and the E tables of its quartet for every sd.
//
// Per (bra primitive pair, ket primitive pair), as coulomb_block does with
// a one-centre ket (hermite.cuh), the ket's primitive pair is folded into
//   Y[tuv1][sc] += pref * sum_tuv2 E_cd[sc, sd][tuv2] (-1)^|tuv2| R[tuv1+tuv2]
// and each bra primitive pair contracts Y with its E tables into cartesian
// accumulators (ket_fold and bra_contract of quartet.cuh, shared with
// int2e_ip1.cu); the bra's cart->sph transform is applied once at the end.
// What bounds it on the card is FP64 arithmetic (R_tuv up to L = 8 and the
// Hermite contractions); the output, (nao)^4 / 8 unique doubles, is written
// once. The simple design accepts local-memory traffic and the recomputation
// across sd: it is right first.
//
// out: row (bra pair * (2la+1)(2lb+1) + sa*(2lb+1) + sb), column col0 +
// ket pair * (2lc+1)(2ld+1) + sc*(2ld+1) + sd, leading dimension ld.
#include <cuda_runtime.h>

#include "quartet.cuh"

template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void quartet_column(
    int Ka, const double* ea, const double* ca, const double* A,
    int Kb, const double* eb, const double* cb, const double* B,
    int Kc, const double* ec, const double* cc, const double* C,
    int Kd, const double* ed, const double* cd, const double* D,
    const double* Sa, const double* Sb, const double* Sc, const double* Sd,
    int sd, double omega, double* res) {
  constexpr int L1 = LA + LB;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1, DC = 2 * LC + 1;
  constexpr int NE1 = (LA + 1) * (LB + 1) * (L1 + 1);

  double acc[NCA * NCB * DC];
  for (int k = 0; k < NCA * NCB * DC; ++k) acc[k] = 0.0;
  double Y[n_tuv(L1) * DC];
  double Ex[NE1], Ey[NE1], Ez[NE1];
  const double ABx = A[0] - B[0], ABy = A[1] - B[1], ABz = A[2] - B[2];

#pragma unroll 1
  for (int ka = 0; ka < Ka; ++ka) {
    const double cak = ca[ka];
    if (cak == 0.0) continue;
    const double a = ea[ka];
#pragma unroll 1
    for (int kb = 0; kb < Kb; ++kb) {
      const double cbk = cb[kb];
      if (cbk == 0.0) continue;
      const double b = eb[kb];
      const double p = a + b;
      e1d<LA, LB>(a, b, ABx, Ex);
      e1d<LA, LB>(a, b, ABy, Ey);
      e1d<LA, LB>(a, b, ABz, Ez);
      ket_fold<L1, LC, LD>(p, (a * A[0] + b * B[0]) / p,
                           (a * A[1] + b * B[1]) / p,
                           (a * A[2] + b * B[2]) / p, Kc, ec, cc, C, Kd, ed,
                           cd, D, Sc, Sd, sd, omega, Y);
      bra_contract<LA, LA, LB, DC>(cak * cbk, Ex, Ey, Ez, Y, acc);
    }
  }

  for (int sa = 0; sa < DA; ++sa) {
    for (int sb = 0; sb < DB; ++sb) {
      for (int sc = 0; sc < DC; ++sc) {
        double v = 0.0;
        for (int ia = 0; ia < NCA; ++ia) {
          const double fa = Sa[sa * NCA + ia];
          if (fa == 0.0) continue;
          for (int jb = 0; jb < NCB; ++jb) {
            v += fa * Sb[sb * NCB + jb] * acc[(ia * NCB + jb) * DC + sc];
          }
        }
        res[(sa * DB + sb) * DC + sc] = v;
      }
    }
  }
}

template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(128) int2e_kernel(
    int nb, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nk, int Kc, int Kd,
    const double* __restrict__ ec, const double* __restrict__ cc,
    const double* __restrict__ rc, const double* __restrict__ ed,
    const double* __restrict__ cd, const double* __restrict__ rd,
    const double* __restrict__ Sa, const double* __restrict__ Sb,
    const double* __restrict__ Sc, const double* __restrict__ Sd,
    double* __restrict__ out, int ld, int col0, double omega) {
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int DC = 2 * LC + 1, DD = 2 * LD + 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)nb * nk * DD) return;
  const int sd = (int)(idx % DD);
  const long pair = idx / DD;
  const int kp = (int)(pair % nk);
  const int ip = (int)(pair / nk);
  double res[DA * DB * DC];
  quartet_column<LA, LB, LC, LD>(
      Ka, ea + (size_t)ip * Ka, ca + (size_t)ip * Ka, ra + 3 * (size_t)ip,
      Kb, eb + (size_t)ip * Kb, cb + (size_t)ip * Kb, rb + 3 * (size_t)ip,
      Kc, ec + (size_t)kp * Kc, cc + (size_t)kp * Kc, rc + 3 * (size_t)kp,
      Kd, ed + (size_t)kp * Kd, cd + (size_t)kp * Kd, rd + 3 * (size_t)kp,
      Sa, Sb, Sc, Sd, sd, omega, res);
  for (int ab = 0; ab < DA * DB; ++ab) {
    double* row = out + ((size_t)ip * DA * DB + ab) * ld + col0
                  + (size_t)kp * DC * DD + sd;
    for (int sc = 0; sc < DC; ++sc) row[sc * DD] = res[ab * DC + sc];
  }
}

template <int LA, int LB, int LC, int LD>
static int launch(int nb, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nk, int Kc, int Kd, const double* ec,
                  const double* cc, const double* rc, const double* ed,
                  const double* cd, const double* rd, const double* Sa,
                  const double* Sb, const double* Sc, const double* Sd,
                  double* out, int ld, int col0, double omega,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)nb * nk * (2 * LD + 1);
  const int blocks = (int)((total + threads - 1) / threads);
  int2e_kernel<LA, LB, LC, LD><<<blocks, threads, 0, stream>>>(
      nb, Ka, Kb, ea, ca, ra, eb, cb, rb, nk, Kc, Kd, ec, cc, rc, ed, cd, rd,
      Sa, Sb, Sc, Sd, out, ld, col0, omega);
  return (int)cudaGetLastError();
}

// omega > 0: the erf(omega r)/r attenuated integrals (0: the full
// operator). Returns cudaGetLastError() after the launch, or -1 for a class
// pair that has no instantiation (la <= lb <= 2 and lc <= ld <= 2).
extern "C" int pt_int2e(int la, int lb, int lc, int ld_, int nb, int Ka,
                        int Kb, const double* ea, const double* ca,
                        const double* ra, const double* eb, const double* cb,
                        const double* rb, int nk, int Kc, int Kd,
                        const double* ec, const double* cc, const double* rc,
                        const double* ed, const double* cd, const double* rd,
                        const double* Sa, const double* Sb, const double* Sc,
                        const double* Sd, double* out, int ld, int col0,
                        double omega, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS nb, Ka, Kb, ea, ca, ra, eb, cb, rb, nk, Kc, Kd, ec, cc, rc, \
                ed, cd, rd, Sa, Sb, Sc, Sd, out, ld, col0, omega, s
#define PT_Q(A, B, C, D) \
  if (la == A && lb == B && lc == C && ld_ == D) \
    return launch<A, B, C, D>(PT_ARGS);
#define PT_AB(A, B) PT_Q(A, B, 0, 0) PT_Q(A, B, 0, 1) PT_Q(A, B, 0, 2) \
                    PT_Q(A, B, 1, 1) PT_Q(A, B, 1, 2) PT_Q(A, B, 2, 2)
  PT_AB(0, 0) PT_AB(0, 1) PT_AB(0, 2) PT_AB(1, 1) PT_AB(1, 2) PT_AB(2, 2)
#undef PT_AB
#undef PT_Q
#undef PT_ARGS
  return -1;
}
