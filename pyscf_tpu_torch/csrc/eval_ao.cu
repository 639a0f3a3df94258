// AO values and their gradients on grid points, one l-class per launch.
//
// Replaces pyscf_tpu/ops/eval_gto.py:_class_ao and the column permutation
// of eval_ao (:63-89); plain PyTorch twin:
// pyscf_tpu_torch/ops/eval_gto.py:eval_ao_plain. Same arithmetic as the
// JAX package: the contracted radial part sum_k c_k exp(-a_k r^2) and its
// derivative factor sum_k -2 a_k c_k exp(-a_k r^2), cartesian monomials by
// repeated squaring (XLA's integer_pow), then cart->sph with the
// (2l+1, ncart) table of ops/integrals/int1e.py:sph.
//
// One thread per (point, shell), points along the threads, so a warp
// shares its shell's exponents and writes a column strip of the
// (npts, nao) output. Each shell's 2l+1 values go straight to their AO
// columns ao_off[shell] + m, so no permutation follows. What bounds it on
// the card is the bytes written, (4 or 1) x npts x nao doubles; the stores
// of a warp are strided by nao, so each touches its own 32-byte sector.
// The simple layout is kept: it runs once per SCF.
#include <cuda_runtime.h>

__device__ __forceinline__ double ipow(double x, int n) {
  double acc = 1.0;
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    n >>= 1;
    if (n) x = x * x;
  }
  return acc;
}

// m = 1 * x^ix * y^iy * z^iz with the zero powers skipped
__device__ __forceinline__ double mono(double x, double y, double z, int ix,
                                       int iy, int iz) {
  double m = 1.0;
  if (ix) m = m * ipow(x, ix);
  if (iy) m = m * ipow(y, iy);
  if (iz) m = m * ipow(z, iz);
  return m;
}

template <int L>
__global__ void __launch_bounds__(128) eval_ao_kernel(
    int deriv, int npts, int ns, int K, const double* __restrict__ pts,
    const double* __restrict__ exps, const double* __restrict__ coeffs,
    const double* __restrict__ centers, const int* __restrict__ ao_off,
    const double* __restrict__ S, double* __restrict__ out, int nao) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)npts * ns) return;
  const int p = (int)(idx % npts);
  const int sh = (int)(idx / npts);
  constexpr int NC = (L + 1) * (L + 2) / 2;
  constexpr int D = 2 * L + 1;
  const double d[3] = {pts[3 * p] - centers[3 * sh],
                       pts[3 * p + 1] - centers[3 * sh + 1],
                       pts[3 * p + 2] - centers[3 * sh + 2]};
  const double r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  double rad = 0.0, drad = 0.0;
  for (int k = 0; k < K; ++k) {
    const double a = exps[(size_t)sh * K + k];
    const double c = coeffs[(size_t)sh * K + k];
    const double ex = exp(-a * r2);
    rad += c * ex;
    drad += -2.0 * a * c * ex;
  }
  double cart[NC];
  double* col = out + (size_t)p * nao + ao_off[sh];
  const size_t comp_stride = (size_t)npts * nao;
  for (int comp = 0; comp < (deriv ? 4 : 1); ++comp) {
    int jc = 0;
    for (int ix = L; ix >= 0; --ix) {
      for (int iy = L - ix; iy >= 0; --iy, ++jc) {
        const int iz = L - ix - iy;
        const double m = mono(d[0], d[1], d[2], ix, iy, iz);
        if (comp == 0) {
          cart[jc] = m * rad;
        } else {
          const int pw[3] = {ix, iy, iz};
          const int q = comp - 1;
          const double dm =
              pw[q] ? pw[q] * mono(d[0], d[1], d[2], ix - (q == 0),
                                   iy - (q == 1), iz - (q == 2))
                    : 0.0;
          cart[jc] = dm * rad + m * d[q] * drad;
        }
      }
    }
    for (int m = 0; m < D; ++m) {
      double v = 0.0;
      for (int j = 0; j < NC; ++j) v += cart[j] * S[m * NC + j];
      col[comp * comp_stride + m] = v;
    }
  }
}

template <int L>
static int launch(int deriv, int npts, int ns, int K, const double* pts,
                  const double* exps, const double* coeffs,
                  const double* centers, const int* ao_off, const double* S,
                  double* out, int nao, cudaStream_t stream) {
  const int threads = 128;
  const long total = (long)npts * ns;
  const int blocks = (int)((total + threads - 1) / threads);
  eval_ao_kernel<L><<<blocks, threads, 0, stream>>>(
      deriv, npts, ns, K, pts, exps, coeffs, centers, ao_off, S, out, nao);
  return (int)cudaGetLastError();
}

// pts (npts, 3); exps/coeffs (ns, K); centers (ns, 3); ao_off (ns,);
// S (2l+1, ncart); out (npts, nao) for deriv 0 or (4, npts, nao) for
// deriv 1. Returns cudaGetLastError() after the launch, or -1 for l > 4.
extern "C" int pt_eval_ao(int l, int deriv, int npts, int ns, int K,
                          const double* pts, const double* exps,
                          const double* coeffs, const double* centers,
                          const int* ao_off, const double* S, double* out,
                          int nao, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PT_L(X)                                                         \
  if (l == X)                                                           \
    return launch<X>(deriv, npts, ns, K, pts, exps, coeffs, centers,    \
                     ao_off, S, out, nao, s);
  PT_L(0) PT_L(1) PT_L(2) PT_L(3) PT_L(4)
#undef PT_L
  return -1;
}
