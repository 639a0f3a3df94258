// Lattice-summed AO values, and at deriv 1 their gradients, on real-space
// points: sum_L phi_mu(r - L) over the lattice translations L of the cell,
// one l-class per launch.
//
// Replaces pyscf_tpu/pbc/df/fft.py:eval_ao_periodic, which calls the
// molecular eval_ao (pyscf_tpu/ops/eval_gto.py:_class_ao) once per image
// (~1,500 images for the diamond primitive cell of gth-szv); plain
// PyTorch twin: pyscf_tpu_torch/ops/eval_gto.py:eval_ao_pbc_plain, which
// sums eval_ao_plain over the same images.
//
// One thread per (point, shell), points along the threads, so a warp
// shares its shell's exponents and images. The thread loops over the
// images inside the kernel and accumulates the cartesian values (and
// their three derivatives) in registers; the cart->sph transform and the
// store come once, after the loop, so each AO value is written once. An
// image is skipped where the shell's most diffuse primitive is below the
// cutoff that the cell's rcut implies, a_min r^2 > lcut with lcut =
// min_exp rcut^2 (exp(-lcut) ~ 1e-47 for gth-szv carbon), and a primitive
// the same way, a_k r^2 > lcut: the twin keeps those terms, which are
// below 1e-40 of the values. What bounds it on the card is the FP64 work
// of the images in range (the distance of every image, the exponentials
// and monomials of those in range); the bytes written, (4 or 1) x npts x
// nao doubles, come second at the 64-atom cell.
#include <cuda_runtime.h>

template <int L>
__global__ void __launch_bounds__(128) eval_ao_pbc_kernel(
    int deriv, int npts, int ns, int K, int nimg,
    const double* __restrict__ pts, const double* __restrict__ exps,
    const double* __restrict__ coeffs, const double* __restrict__ centers,
    const int* __restrict__ ao_off, const double* __restrict__ Ls,
    double lcut, const double* __restrict__ S, double* __restrict__ out,
    int nao) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)npts * ns) return;
  const int p = (int)(idx % npts);
  const int sh = (int)(idx / npts);
  constexpr int NC = (L + 1) * (L + 2) / 2;
  constexpr int D = 2 * L + 1;
  const double* e = exps + (size_t)sh * K;
  const double* c = coeffs + (size_t)sh * K;
  double amin = 1e300;
  for (int k = 0; k < K; ++k)
    if (c[k] != 0.0 && e[k] < amin) amin = e[k];
  const double r0[3] = {pts[3 * p] - centers[3 * sh],
                        pts[3 * p + 1] - centers[3 * sh + 1],
                        pts[3 * p + 2] - centers[3 * sh + 2]};
  double acc[4][NC];
  for (int comp = 0; comp < 4; ++comp)
    for (int j = 0; j < NC; ++j) acc[comp][j] = 0.0;

#pragma unroll 1
  for (int im = 0; im < nimg; ++im) {
    const double d[3] = {r0[0] - Ls[3 * im], r0[1] - Ls[3 * im + 1],
                         r0[2] - Ls[3 * im + 2]};
    const double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    if (amin * r2 > lcut) continue;
    double rad = 0.0, drad = 0.0;
    for (int k = 0; k < K; ++k) {
      if (c[k] == 0.0 || e[k] * r2 > lcut) continue;
      const double ex = c[k] * exp(-e[k] * r2);
      rad += ex;
      drad += -2.0 * e[k] * ex;
    }
    // powers x^0..x^L of each direction
    double pw[3][L + 1];
    for (int q = 0; q < 3; ++q) {
      pw[q][0] = 1.0;
      for (int n = 1; n <= L; ++n) pw[q][n] = pw[q][n - 1] * d[q];
    }
    int jc = 0;
    for (int ix = L; ix >= 0; --ix) {
      for (int iy = L - ix; iy >= 0; --iy, ++jc) {
        const int iz = L - ix - iy;
        const double m = pw[0][ix] * pw[1][iy] * pw[2][iz];
        acc[0][jc] += m * rad;
        if (deriv) {
          // d/dx_q (m R) = m_q R + m x_q R', R' = drad
          const double mx = ix ? ix * pw[0][ix - 1] * pw[1][iy] * pw[2][iz]
                               : 0.0;
          const double my = iy ? iy * pw[0][ix] * pw[1][iy - 1] * pw[2][iz]
                               : 0.0;
          const double mz = iz ? iz * pw[0][ix] * pw[1][iy] * pw[2][iz - 1]
                               : 0.0;
          acc[1][jc] += mx * rad + m * d[0] * drad;
          acc[2][jc] += my * rad + m * d[1] * drad;
          acc[3][jc] += mz * rad + m * d[2] * drad;
        }
      }
    }
  }

  double* col = out + (size_t)p * nao + ao_off[sh];
  const size_t comp_stride = (size_t)npts * nao;
  const int ncomp = deriv ? 4 : 1;
  for (int comp = 0; comp < ncomp; ++comp) {
    for (int m = 0; m < D; ++m) {
      double v = 0.0;
      for (int j = 0; j < NC; ++j) v += acc[comp][j] * S[m * NC + j];
      col[comp * comp_stride + m] = v;
    }
  }
}

template <int L>
static int launch(int deriv, int npts, int ns, int K, int nimg,
                  const double* pts, const double* exps, const double* coeffs,
                  const double* centers, const int* ao_off, const double* Ls,
                  double lcut, const double* S, double* out, int nao,
                  cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)npts * ns;
  const int blocks = (int)((total + threads - 1) / threads);
  eval_ao_pbc_kernel<L><<<blocks, threads, 0, stream>>>(
      deriv, npts, ns, K, nimg, pts, exps, coeffs, centers, ao_off, Ls, lcut,
      S, out, nao);
  return (int)cudaGetLastError();
}

// pts (npts, 3); exps/coeffs (ns, K); centers (ns, 3); ao_off (ns,); Ls
// (nimg, 3); S (2l+1, ncart); out (npts, nao) for deriv 0, (4, npts, nao)
// [value, d/dx, d/dy, d/dz] for deriv 1. Returns cudaGetLastError() after
// the launch, or -1 for l > 4 or deriv > 1.
extern "C" int pt_eval_ao_pbc(int l, int deriv, int npts, int ns, int K,
                              int nimg, const double* pts, const double* exps,
                              const double* coeffs, const double* centers,
                              const int* ao_off, const double* Ls,
                              double lcut, const double* S, double* out,
                              int nao, void* stream) {
  if (deriv < 0 || deriv > 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define PT_L(X)                                                            \
  if (l == X)                                                              \
    return launch<X>(deriv, npts, ns, K, nimg, pts, exps, coeffs, centers, \
                     ao_off, Ls, lcut, S, out, nao, s);
  PT_L(0) PT_L(1) PT_L(2) PT_L(3) PT_L(4)
#undef PT_L
  return -1;
}
