// Derivative four-centre Coulomb integrals d/dA (ab|cd), the derivative on
// the centre of the first bra function, for the nuclear gradient.
//
// Replaces pyscf_tpu/ops/integrals/int2e.py:_deriv_class_pair_block on the
// DerivPairClass bra tables (inside int2e_ip1, with its prim-sum and
// cart->sph einsum); plain PyTorch twin:
// pyscf_tpu_torch/ops/integrals/int2e.py:int2e_ip1_class_plain. The gather
// of the rows into the dense (3, nao, nao, nao, nao) tensor is an
// index_select and stays a library call.
//
// The design is int2e.cu's: one launch per (ordered bra class, ket class),
// one thread per (bra shell pair, screened ket shell pair, sph component sd
// of the ket's second shell), no atomics, the ket's primitives folded into
// Y and the bra's E tables contracted with it (quartet.cuh). The derivative
// enters through the bra alone:
//   d/dA_x [x_A^i e^{-a x_A^2}] = 2a x_A^{i+1} - i x_A^{i-1},
// so the thread accumulates the cartesian blocks of the raised bra shell
// la + 1 (2a folded into the primitive's weight) and of the lowered shell
// la - 1 from one set of tables e1d<la + 1, lb> and one Y of Hermite order
// la + lb + 1, and applies the rule once, at the end, before the bra's
// cart->sph transform. That holds (10 + 3) x 6 x 5 accumulators for
// (dd|dd) where three direction blocks would hold 3 x 36 x 5, and
// contracts 13 x 6 cartesian pairs per primitive pair instead of 108.
// R_tuv reaches order 9 (220 terms) and Boys m = 9; (dd|dd) keeps about
// 10 KB of per-thread tables in local memory. The derivative is not
// symmetric in a and b: the caller passes every ordered bra pair; the ket
// keeps lc <= ld.
//
// What bounds it on the card is FP64 arithmetic (R_tuv and the Hermite
// contractions); the output, 3 x nao^2 x (nao^2 / 2) doubles, is written
// once. The simple design accepts local-memory traffic and the
// recomputation across sd: it is right first.
//
// The library is built once per ordered bra class (-DPT_LA, -DPT_LB, la,
// lb <= 2), so that the 54 instantiations (six ket classes lc <= ld <= 2
// each) compile in nine processes side by side. f and g shells are not
// instantiated: every ordered (la, lb | lc <= ld) <= 4 is 375 classes, whose
// build passed 600 s on 8 cores.
//
// out: direction d at d * nb * (2la+1)(2lb+1) * ld; row (bra pair *
// (2la+1)(2lb+1) + sa*(2lb+1) + sb), column col0 + ket pair *
// (2lc+1)(2ld+1) + sc*(2ld+1) + sd, leading dimension ld.
#include <cuda_runtime.h>

#include "quartet.cuh"

template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(128) int2e_ip1_kernel(
    int nb, int Ka, int Kb, const double* __restrict__ ea,
    const double* __restrict__ ca, const double* __restrict__ ra,
    const double* __restrict__ eb, const double* __restrict__ cb,
    const double* __restrict__ rb, int nk, int Kc, int Kd,
    const double* __restrict__ ec, const double* __restrict__ cc,
    const double* __restrict__ rc, const double* __restrict__ ed,
    const double* __restrict__ cd, const double* __restrict__ rd,
    const double* __restrict__ Sa, const double* __restrict__ Sb,
    const double* __restrict__ Sc, const double* __restrict__ Sd,
    double* __restrict__ out, int ld, int col0) {
  constexpr int DA = 2 * LA + 1, DB = 2 * LB + 1;
  constexpr int DC = 2 * LC + 1, DD = 2 * LD + 1;
  constexpr int NCA = n_cart(LA), NCB = n_cart(LB);
  constexpr int NCP = n_cart(LA + 1);
  constexpr int NCM = LA > 0 ? n_cart(LA - 1) : 1;
  constexpr int L1 = LA + LB + 1;                      // raised bra
  constexpr int NE1 = (LA + 2) * (LB + 1) * (L1 + 1);  // e1d<LA + 1, LB>
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)nb * nk * DD) return;
  const int sd = (int)(idx % DD);
  const long pair = idx / DD;
  const int kp = (int)(pair % nk);
  const int ip = (int)(pair / nk);
  ea += (size_t)ip * Ka;
  ca += (size_t)ip * Ka;
  eb += (size_t)ip * Kb;
  cb += (size_t)ip * Kb;
  const double* A = ra + 3 * (size_t)ip;
  const double* B = rb + 3 * (size_t)ip;

  double accp[NCP * NCB * DC], accm[NCM * NCB * DC];
  for (int k = 0; k < NCP * NCB * DC; ++k) accp[k] = 0.0;
  for (int k = 0; k < NCM * NCB * DC; ++k) accm[k] = 0.0;
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
      const double w = cak * cbk;
      e1d<LA + 1, LB>(a, b, ABx, Ex);
      e1d<LA + 1, LB>(a, b, ABy, Ey);
      e1d<LA + 1, LB>(a, b, ABz, Ez);
      ket_fold<L1, LC, LD>(
          p, (a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
          (a * A[2] + b * B[2]) / p, Kc, ec + (size_t)kp * Kc,
          cc + (size_t)kp * Kc, rc + 3 * (size_t)kp, Kd,
          ed + (size_t)kp * Kd, cd + (size_t)kp * Kd, rd + 3 * (size_t)kp,
          Sc, Sd, sd, 0.0, Y);
      bra_contract<LA + 1, LA + 1, LB, DC>(2.0 * a * w, Ex, Ey, Ez, Y, accp);
      if constexpr (LA > 0) {
        bra_contract<LA - 1, LA + 1, LB, DC>(w, Ex, Ey, Ez, Y, accm);
      }
    }
  }

  // the power-shift rule on the cartesian blocks, then cart->sph on a, b
  double blk[NCA * NCB * DC];
  for (int d = 0; d < 3; ++d) {
    int ia = 0;
    for (int ix = LA; ix >= 0; --ix) {
      for (int iy = LA - ix; iy >= 0; --iy, ++ia) {
        const int c[3] = {ix, iy, LA - ix - iy};
        const int pu = cart_pos(c[1] + (d == 1), c[2] + (d == 2));
        const int pd = cart_pos(c[1] - (d == 1), c[2] - (d == 2));
        for (int k = 0; k < NCB * DC; ++k) {
          double v = accp[pu * NCB * DC + k];
          if (c[d] > 0) v -= c[d] * accm[pd * NCB * DC + k];
          blk[ia * NCB * DC + k] = v;
        }
      }
    }
    double* base = out + (size_t)d * nb * DA * DB * ld + col0
                   + (size_t)kp * DC * DD + sd;
    for (int sa = 0; sa < DA; ++sa) {
      for (int sb = 0; sb < DB; ++sb) {
        double* row = base + ((size_t)ip * DA * DB + sa * DB + sb) * ld;
        for (int sc = 0; sc < DC; ++sc) {
          double v = 0.0;
          for (int ja = 0; ja < NCA; ++ja) {
            const double fa = Sa[sa * NCA + ja];
            if (fa == 0.0) continue;
            for (int jb = 0; jb < NCB; ++jb) {
              v += fa * Sb[sb * NCB + jb] * blk[(ja * NCB + jb) * DC + sc];
            }
          }
          row[sc * DD] = v;
        }
      }
    }
  }
}

template <int LA, int LB, int LC, int LD>
static int launch(int nb, int Ka, int Kb, const double* ea, const double* ca,
                  const double* ra, const double* eb, const double* cb,
                  const double* rb, int nk, int Kc, int Kd, const double* ec,
                  const double* cc, const double* rc, const double* ed,
                  const double* cd, const double* rd, const double* Sa,
                  const double* Sb, const double* Sc, const double* Sd,
                  double* out, int ld, int col0, cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)nb * nk * (2 * LD + 1);
  const int blocks = (int)((total + threads - 1) / threads);
  int2e_ip1_kernel<LA, LB, LC, LD><<<blocks, threads, 0, stream>>>(
      nb, Ka, Kb, ea, ca, ra, eb, cb, rb, nk, Kc, Kd, ec, cc, rc, ed, cd, rd,
      Sa, Sb, Sc, Sd, out, ld, col0);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -1 for a class pair that
// has no instantiation in this library (la == PT_LA, lb == PT_LB,
// lc <= ld <= 2).
extern "C" int pt_int2e_ip1(int la, int lb, int lc, int ld_, int nb, int Ka,
                            int Kb, const double* ea, const double* ca,
                            const double* ra, const double* eb,
                            const double* cb, const double* rb, int nk,
                            int Kc, int Kd, const double* ec,
                            const double* cc, const double* rc,
                            const double* ed, const double* cd,
                            const double* rd, const double* Sa,
                            const double* Sb, const double* Sc,
                            const double* Sd, double* out, int ld, int col0,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_ARGS nb, Ka, Kb, ea, ca, ra, eb, cb, rb, nk, Kc, Kd, ec, cc, rc, \
                ed, cd, rd, Sa, Sb, Sc, Sd, out, ld, col0, s
#define PT_Q(C, D) \
  if (la == PT_LA && lb == PT_LB && lc == C && ld_ == D) \
    return launch<PT_LA, PT_LB, C, D>(PT_ARGS);
  PT_Q(0, 0) PT_Q(0, 1) PT_Q(0, 2)
  PT_Q(1, 1) PT_Q(1, 2)
  PT_Q(2, 2)
#undef PT_Q
#undef PT_ARGS
  return -1;
}
