// Bloch-summed AO values, and at deriv 1 their gradients, on real-space
// points for nk k-points at once: phi_mu^k(r) = sum_L e^{ik.L} chi_mu(r - L)
// over the lattice translations L of the cell, one l-class per launch.
//
// Replaces pyscf_tpu/pbc/df/fft.py:eval_ao_kpts, which calls the molecular
// eval_ao (pyscf_tpu/ops/eval_gto.py:_class_ao) once per image (~1,500
// images for the diamond primitive cell) and multiplies each image's values
// by its phases on the host; plain PyTorch twin:
// pyscf_tpu_torch/ops/eval_gto.py:eval_ao_kpts_plain, which sums the same
// per-image values against the phases by GEMMs.
//
// The layout of csrc/eval_ao_pbc.cu with a second grid dimension over
// tiles of KT k-points: one thread per (point, shell, k tile), points along
// the threads, so a warp shares its shell's exponents, its images and its
// phases (each phase load is a broadcast). The thread loops over the images
// inside the kernel, skips an image where the shell's most diffuse
// primitive is below the cutoff that the cell's rcut implies (a_min r^2 >
// lcut, lcut = min_exp rcut^2) and a primitive the same way, and adds each
// image's real cartesian values (and their three derivatives), times the
// image's phase for each k of its tile, into complex sums held in
// registers. The tile width KT keeps those sums near KT_DOUBLES doubles
// (every k would not fit: 64 k-points x 4 components x 6 cartesians of a d
// shell are 3,072 doubles), so each tile recomputes the image's real
// values: the per-image work is repeated nk / KT times, and for s and p
// shells the phase products outweigh it. The cart->sph transform and the
// store come once, after the loop. What bounds it on the card is the FP64
// work: the nk x components x cartesians complex multiply-adds of every
// image in range.
#include <cuda_runtime.h>

// the register budget of a thread's sums, in doubles (at 192 ptxas
// spills them)
constexpr int KT_DOUBLES = 96;

template <int L, int DERIV>
struct Tile {
  // k-points a thread accumulates: 2 KT NCOMP NC doubles of sums
  static constexpr int NC = (L + 1) * (L + 2) / 2;
  static constexpr int NCOMP = DERIV ? 4 : 1;
  static constexpr int raw = KT_DOUBLES / (2 * NCOMP * NC);
  static constexpr int KT = raw >= 16 ? 16 : raw >= 8 ? 8 : raw >= 4 ? 4
                            : raw >= 2 ? 2 : 1;
};

template <int L, int DERIV>
__global__ void __launch_bounds__(128) eval_ao_kpts_kernel(
    int npts, int ns, int K, int nimg, int nk, const double* __restrict__ pts,
    const double* __restrict__ exps, const double* __restrict__ coeffs,
    const double* __restrict__ centers, const int* __restrict__ ao_off,
    const double* __restrict__ Ls, const double* __restrict__ phases,
    double lcut, const double* __restrict__ S, double* __restrict__ out,
    int nao) {
  constexpr int NC = Tile<L, DERIV>::NC;
  constexpr int NCOMP = Tile<L, DERIV>::NCOMP;
  constexpr int KT = Tile<L, DERIV>::KT;
  constexpr int D = 2 * L + 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)npts * ns) return;
  const int p = (int)(idx % npts);
  const int sh = (int)(idx / npts);
  const int k0 = blockIdx.y * KT;
  const double* e = exps + (size_t)sh * K;
  const double* c = coeffs + (size_t)sh * K;
  double amin = 1e300;
  for (int k = 0; k < K; ++k)
    if (c[k] != 0.0 && e[k] < amin) amin = e[k];
  const double r0[3] = {pts[3 * p] - centers[3 * sh],
                        pts[3 * p + 1] - centers[3 * sh + 1],
                        pts[3 * p + 2] - centers[3 * sh + 2]};
  double re[KT][NCOMP][NC], im[KT][NCOMP][NC];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int comp = 0; comp < NCOMP; ++comp)
#pragma unroll
      for (int j = 0; j < NC; ++j) re[t][comp][j] = im[t][comp][j] = 0.0;

#pragma unroll 1
  for (int img = 0; img < nimg; ++img) {
    const double d[3] = {r0[0] - Ls[3 * img], r0[1] - Ls[3 * img + 1],
                         r0[2] - Ls[3 * img + 2]};
    const double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    if (amin * r2 > lcut) continue;
    double rad = 0.0, drad = 0.0;
    for (int k = 0; k < K; ++k) {
      if (c[k] == 0.0 || e[k] * r2 > lcut) continue;
      const double ex = c[k] * exp(-e[k] * r2);
      rad += ex;
      drad += -2.0 * e[k] * ex;
    }
    // the phases e^{ik.L} of this image for the tile's k-points
    double pr[KT], pi[KT];
    const double* ph = phases + 2 * ((size_t)img * nk + k0);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const bool in = k0 + t < nk;
      pr[t] = in ? ph[2 * t] : 0.0;
      pi[t] = in ? ph[2 * t + 1] : 0.0;
    }
    // powers x^0..x^L of each direction
    double pw[3][L + 1];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      pw[q][0] = 1.0;
#pragma unroll
      for (int n = 1; n <= L; ++n) pw[q][n] = pw[q][n - 1] * d[q];
    }
    int jc = 0;
#pragma unroll
    for (int ix = L; ix >= 0; --ix) {
#pragma unroll
      for (int iy = L - ix; iy >= 0; --iy, ++jc) {
        const int iz = L - ix - iy;
        const double m = pw[0][ix] * pw[1][iy] * pw[2][iz];
        double v[NCOMP];
        v[0] = m * rad;
        if constexpr (DERIV) {
          // d/dx_q (m R) = m_q R + m x_q R', R' = drad
          const double mx = ix ? ix * pw[0][ix - 1] * pw[1][iy] * pw[2][iz]
                               : 0.0;
          const double my = iy ? iy * pw[0][ix] * pw[1][iy - 1] * pw[2][iz]
                               : 0.0;
          const double mz = iz ? iz * pw[0][ix] * pw[1][iy] * pw[2][iz - 1]
                               : 0.0;
          v[1] = mx * rad + m * d[0] * drad;
          v[2] = my * rad + m * d[1] * drad;
          v[3] = mz * rad + m * d[2] * drad;
        }
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int comp = 0; comp < NCOMP; ++comp) {
            re[t][comp][jc] += pr[t] * v[comp];
            im[t][comp][jc] += pi[t] * v[comp];
          }
      }
    }
  }

  const size_t comp_stride = (size_t)npts * nao;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    if (k0 + t >= nk) break;
#pragma unroll
    for (int comp = 0; comp < NCOMP; ++comp) {
      double* col = out + 2 * (((size_t)(k0 + t) * NCOMP + comp) * comp_stride
                               + (size_t)p * nao + ao_off[sh]);
#pragma unroll
      for (int m = 0; m < D; ++m) {
        double vr = 0.0, vi = 0.0;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          vr += re[t][comp][j] * S[m * NC + j];
          vi += im[t][comp][j] * S[m * NC + j];
        }
        col[2 * m] = vr;
        col[2 * m + 1] = vi;
      }
    }
  }
}

template <int L, int DERIV>
static int launch(int npts, int ns, int K, int nimg, int nk, const double* pts,
                  const double* exps, const double* coeffs,
                  const double* centers, const int* ao_off, const double* Ls,
                  const double* phases, double lcut, const double* S,
                  double* out, int nao, cudaStream_t stream) {
  constexpr int KT = Tile<L, DERIV>::KT;
  const int threads = 128;
  const long total = (long)npts * ns;
  const dim3 blocks((unsigned)((total + threads - 1) / threads),
                    (unsigned)((nk + KT - 1) / KT));
  eval_ao_kpts_kernel<L, DERIV><<<blocks, threads, 0, stream>>>(
      npts, ns, K, nimg, nk, pts, exps, coeffs, centers, ao_off, Ls, phases,
      lcut, S, out, nao);
  return (int)cudaGetLastError();
}

// pts (npts, 3); exps/coeffs (ns, K); centers (ns, 3); ao_off (ns,); Ls
// (nimg, 3); phases (nimg, nk) complex128 e^{ik.L} as (re, im) pairs; S
// (2l+1, ncart); out complex128 as (re, im) pairs, (nk, npts, nao) for
// deriv 0, (nk, 4, npts, nao) [value, d/dx, d/dy, d/dz] for deriv 1.
// Returns cudaGetLastError() after the launch, or -1 for l > 4 or deriv >
// 1.
extern "C" int pt_eval_ao_kpts(int l, int deriv, int npts, int ns, int K,
                               int nimg, int nk, const double* pts,
                               const double* exps, const double* coeffs,
                               const double* centers, const int* ao_off,
                               const double* Ls, const double* phases,
                               double lcut, const double* S, double* out,
                               int nao, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_L(X)                                                              \
  if (l == X && deriv == 0)                                                  \
    return launch<X, 0>(npts, ns, K, nimg, nk, pts, exps, coeffs, centers,   \
                        ao_off, Ls, phases, lcut, S, out, nao, s);           \
  if (l == X && deriv == 1)                                                  \
    return launch<X, 1>(npts, ns, K, nimg, nk, pts, exps, coeffs, centers,   \
                        ao_off, Ls, phases, lcut, S, out, nao, s);
  PT_L(0) PT_L(1) PT_L(2) PT_L(3) PT_L(4)
#undef PT_L
  return -1;
}
