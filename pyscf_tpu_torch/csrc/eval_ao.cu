// AO values and their first, second and third derivatives on grid points,
// one l-class per launch.
//
// Replaces pyscf_tpu/ops/eval_gto.py:_class_ao and the column permutation
// of eval_ao (:63-89); plain PyTorch twin:
// pyscf_tpu_torch/ops/eval_gto.py:eval_ao_plain. Same arithmetic as the
// JAX package: the contracted radial part sum_k c_k exp(-a_k r^2) and its
// derivative factor sum_k -2 a_k c_k exp(-a_k r^2), cartesian monomials by
// repeated squaring (XLA's integer_pow), then cart->sph with the
// (2l+1, ncart) table of ops/integrals/int1e.py:sph. deriv 2 adds the
// second derivatives xx, xy, xz, yy, yz, zz, with the radial factor
// sum_k 4 a_k^2 c_k exp(-a_k r^2): they replace what jax.grad takes of
// eval_ao(..., deriv=1, atom_coords=X) in the XC gradient
// (pyscf_tpu/grad/autodiff.py:207-210). deriv 3 adds the ten third
// derivatives xxx, xxy, xxz, xyy, xyz, xzz, yyy, yyz, yzz, zzz, with
// sum_k -8 a_k^3 c_k exp(-a_k r^2): they replace the second derivative
// of that eval_ao in the atom coordinates which the XC Hessian takes
// (pyscf_tpu/hessian/rhf.py:327).
//
// One thread per (point, shell), points along the threads, so a warp
// shares its shell's exponents and writes a column strip of the
// (npts, nao) output. Each shell's 2l+1 values go straight to their AO
// columns ao_off[shell] + m, so no permutation follows. What bounds it on
// the card is the bytes written, (20, 10, 4 or 1) x npts x nao doubles;
// the stores of a warp are strided by nao, so each touches its own
// 32-byte sector. The simple layout is kept: it runs once per SCF (deriv
// 3: once per Hessian).
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

// p[i] (p[i] - 1 if j == i) ... times the monomial with the powers of the
// directions i, j and k (-1: none) taken down by one each, 0 where a power
// runs out: the cartesian factor of a first (j = k = -1), second (k = -1)
// or third derivative of the monomial.
__device__ __forceinline__ double lowered(const double* d, int ix, int iy,
                                          int iz, int i, int j, int k3 = -1) {
  int pw[3] = {ix, iy, iz};
  int fac = 1;
  for (int k = 0; k < 3; ++k) {
    const int q = k == 0 ? i : (k == 1 ? j : k3);
    if (q < 0) break;
    if (pw[q] == 0) return 0.0;
    fac *= pw[q];
    pw[q] -= 1;
  }
  return fac * mono(d[0], d[1], d[2], pw[0], pw[1], pw[2]);
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
  double rad = 0.0, drad = 0.0, d2rad = 0.0, d3rad = 0.0;
  for (int k = 0; k < K; ++k) {
    const double a = exps[(size_t)sh * K + k];
    const double c = coeffs[(size_t)sh * K + k];
    const double ex = exp(-a * r2);
    rad += c * ex;
    drad += -2.0 * a * c * ex;
    if (deriv >= 2) d2rad += 4.0 * a * a * c * ex;
    if (deriv == 3) d3rad += -8.0 * a * a * a * c * ex;
  }
  double cart[NC];
  double* col = out + (size_t)p * nao + ao_off[sh];
  const size_t comp_stride = (size_t)npts * nao;
  const int ncomp = deriv == 0 ? 1 : (deriv == 1 ? 4 : (deriv == 2 ? 10 : 20));
  for (int comp = 0; comp < ncomp; ++comp) {
    int jc = 0;
    for (int ix = L; ix >= 0; --ix) {
      for (int iy = L - ix; iy >= 0; --iy, ++jc) {
        const int iz = L - ix - iy;
        const double m = mono(d[0], d[1], d[2], ix, iy, iz);
        if (comp == 0) {
          cart[jc] = m * rad;
        } else if (comp < 4) {
          const int pw[3] = {ix, iy, iz};
          const int q = comp - 1;
          const double dm =
              pw[q] ? pw[q] * mono(d[0], d[1], d[2], ix - (q == 0),
                                   iy - (q == 1), iz - (q == 2))
                    : 0.0;
          cart[jc] = dm * rad + m * d[q] * drad;
        } else if (comp < 10) {
          // d2/(dx_i dx_j) of m(x) R(r^2): m_ij R + (m_i x_j + m_j x_i) R'
          // + m (x_i x_j R'' + delta_ij R'), with R' = drad, R'' = d2rad
          // components 4..9: xx, xy, xz, yy, yz, zz
          const int q = comp - 4;
          const int i = q < 3 ? 0 : (q < 5 ? 1 : 2);
          const int j = q < 3 ? q : (q < 5 ? q - 2 : 2);
          const double v = lowered(d, ix, iy, iz, i, j) * rad
                         + (lowered(d, ix, iy, iz, i, -1) * d[j]
                            + lowered(d, ix, iy, iz, j, -1) * d[i]) * drad;
          double dd = d[i] * d[j] * d2rad;
          if (i == j) dd = dd + drad;
          cart[jc] = v + m * dd;
        } else {
          // d3/(dx_i dx_j dx_k) of m(x) R(r^2): m_ijk R + m R_ijk + the
          // three splits (ab, c) of {i, j, k}, m_ab R_c + m_c R_ab, with
          // R_c = x_c R', R_ab = x_a x_b R'' + delta_ab R' and R_ijk =
          // x_i x_j x_k R''' + (delta_ij x_k + delta_ik x_j + delta_jk x_i)
          // R''; components 10..19: xxx, xxy, xxz, xyy, xyz, xzz, yyy,
          // yyz, yzz, zzz
          const int q = comp - 10;
          const int i = q < 6 ? 0 : (q < 9 ? 1 : 2);
          const int j = q < 3 ? 0 : (q < 6 ? (q < 5 ? 1 : 2)
                                           : (q < 8 ? 1 : 2));
          const int k = q < 3 ? q : (q == 3 ? 1 : (q < 6 ? 2
                                : (q == 6 ? 1 : 2)));
          double r3 = d[i] * d[j] * d[k] * d3rad;
          if (i == j) r3 += d[k] * d2rad;
          if (i == k) r3 += d[j] * d2rad;
          if (j == k) r3 += d[i] * d2rad;
          double v = lowered(d, ix, iy, iz, i, j, k) * rad + m * r3;
          const int sp[3][3] = {{i, j, k}, {i, k, j}, {j, k, i}};
          for (int t = 0; t < 3; ++t) {
            const int a = sp[t][0], b = sp[t][1], c = sp[t][2];
            double rab = d[a] * d[b] * d2rad;
            if (a == b) rab += drad;
            v += lowered(d, ix, iy, iz, a, b) * d[c] * drad
                 + lowered(d, ix, iy, iz, c, -1) * rab;
          }
          cart[jc] = v;
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
// S (2l+1, ncart); out (npts, nao) for deriv 0, (4, npts, nao) for deriv
// 1, (10, npts, nao) for deriv 2 or (20, npts, nao) for deriv 3. Returns
// cudaGetLastError() after the launch, or -1 for l > 4 or deriv > 3.
extern "C" int pt_eval_ao(int l, int deriv, int npts, int ns, int K,
                          const double* pts, const double* exps,
                          const double* coeffs, const double* centers,
                          const int* ao_off, const double* S, double* out,
                          int nao, void* stream) {
  if (deriv < 0 || deriv > 3) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define PT_L(X)                                                         \
  if (l == X)                                                           \
    return launch<X>(deriv, npts, ns, K, pts, exps, coeffs, centers,    \
                     ao_off, S, out, nao, s);
  PT_L(0) PT_L(1) PT_L(2) PT_L(3) PT_L(4)
#undef PT_L
  return -1;
}
