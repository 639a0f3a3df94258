// The closed-shell XC energy's second derivatives along the nuclear
// coordinates on a fixed grid, at a fixed density matrix D: the KS terms
// of the analytic DF-RKS Hessian.
//
// Replaces what the JAX package's jax.jvp of jax.grad makes of
// pyscf_tpu/grad/autodiff.py:199 _exc_quadrature (restricted branch,
// :221-227) in pyscf_tpu/hessian/rhf.py: the fixed-D Hessian of E_xc in
// X (`jv_rows`, :327) and the fixed-D derivative of V_xc = dE_xc/dD in X
// (`fock`, :226-233, under `_chunked_jvp`, :279), in two launches from
// this source; plain PyTorch twins: pyscf_tpu_torch/dft/numint.py
// xc_rks_hess_plain and xc_rks_deriv1_plain. The AO values to the third
// derivative come from eval_ao.cu (deriv 3), dmao = aod[:4] @ D is a GEMM,
// and the contractions of the per-point outputs below (the quadratic term
// u_s . w H u_t, the explicit cross term's Z, V'_t = phi^T vt'_t) are
// GEMMs: they stay library calls.
//
// At a point with features u = (rho, grad rho) (rho = max(phi . D phi, 0),
// g_j = 2 (D phi) . d_j phi), the clamped energy density e(rho_s, sigma_s)
// of the B3LYP and PBE families on second-order dual numbers (xc_funcs.cuh
// edens_closed2) gives v = de/du and H = d2e/du2,
//   v_0 = e_r,  v_j = 2 e_s s' g_j,
//   H_00 = e_rr, H_0j = 2 e_rs s' g_j,
//   H_jk = 4 e_ss s'^2 g_j g_k + 2 e_s s' delta_jk,
// s' the slope of max(sigma, SIGMA_FLOOR) (1 above, 1/2 at a tie, 0
// below), all zero where rho <= RHO_THR, as jax.hessian takes the JAX
// package's clamps. With phi_mu on atom A, d phi_mu / dA_x = -d_x phi_mu,
// so along the tangent t = 3 A + x
//   u_t = -2 sum_{mu on A} [d_x phi_mu (D phi)_mu,
//                           d_x d_j phi_mu (D phi)_mu
//                           + d_x phi_mu (D d_j phi)_mu].
//
// xc_rks_hess (this file without PT_XC_DERIV1): one thread per point
// reduces the density over the point's AO row, evaluates the functional
// once and walks the atoms' AO ranges (the AOs of an atom are
// consecutive), writing
//   wv   (B, 4)             w v
//   ut   (3 natm, B, 4)     u_t
//   ht   (3 natm, B, 4)     w H u_t
//   same (B, natm, 6)       2 w sum_{mu on A} [v_0 d_xy phi_mu (D phi)_mu +
//                           sum_j v_j (d_xyj phi_mu (D phi)_mu
//                                      + d_xy phi_mu (D d_j phi)_mu)],
//                           the same-atom part of v . d2u/dA_x dA_y
//                           (xx, xy, xz, yy, yz, zz)
//   xr   (4, B, nao)        vtmp0 = 1/2 w v_0 phi + sum_j w v_j d_j phi and
//                           G_x = sum_j w v_j d_x d_j phi, the explicit rows.
// It reads the point's 20 AO rows and 4 dmao rows (10 and 1 for an LDA)
// from its own row of each: a warp's loads are strided by nao, served by
// the L1 cache line by line.
//
// xc_rks_deriv1 (PT_XC_DERIV1): one thread per (point, AO nu), for the
// tangents t0 .. t0 + nt - 1, writes the row of V'_t's half-product
//   vt'_t[b, nu] = 1/2 ht_0 phi_nu + sum_j ht_j d_j phi_nu
//                  - 1/2 [nu on A] (w v_0 d_x phi_nu + 2 G_x[nu])
// into (B, nt, nao), so that a warp's stores are contiguous and a point's
// nt rows are one block for the GEMM phi^T vt'. Then V'_t = F_t + F_t^T
// with F_t = phi^T vt'_t - [rows on A] (d_x phi)^T vtmp0 (2 F_t is the JAX
// package's unsymmetrised dV_xc/dX: its jax.grad in D takes g_j = 2 (D
// phi) . d_j phi as it is written). It reads 4 AO values and 3 G values
// per thread and writes nt doubles: bound by the bytes written.
//
// Neither uses floating-point atomics, so a run repeats bit for bit.
#include <cuda_runtime.h>

#include "xc_point.cuh"

// the index in 0..5 of d_i d_j in xx, xy, xz, yy, yz, zz
__device__ __forceinline__ int pair_index(int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

#ifndef PT_XC_DERIV1

// the index in 0..9 of d_i d_j d_k in xxx, xxy, xxz, xyy, xyz, xzz, yyy,
// yyz, yzz, zzz
__device__ __forceinline__ int triple_index(int i, int j, int k) {
  if (i > j) { const int t = i; i = j; j = t; }
  if (j > k) { const int t = j; j = k; k = t; }
  if (i > j) { const int t = i; i = j; j = t; }
  return i == 0 ? pair_index(j, k) : (i == 1 ? 3 + pair_index(j, k) : 9);
}

template <bool GGA>
__global__ void __launch_bounds__(128) xc_rks_hess_kernel(
    int npts, int nao, int natm, const int* __restrict__ atom_off,
    const double* __restrict__ aod, const double* __restrict__ dmao,
    const double* __restrict__ weights, ptxc::Terms terms,
    double* __restrict__ wv, double* __restrict__ ut,
    double* __restrict__ ht, double* __restrict__ same,
    double* __restrict__ xr) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= npts) return;
  const size_t plane = (size_t)npts * nao;
  const double* ao = aod + (size_t)b * nao;
  const double* dm = dmao + (size_t)b * nao;
  double rho = 0.0, g[3] = {0.0, 0.0, 0.0};
  for (int i = 0; i < nao; ++i) {
    const double d0 = dm[i];
    rho += d0 * ao[i];
    if (GGA) {
      for (int j = 0; j < 3; ++j) g[j] += d0 * ao[(1 + j) * plane + i];
    }
  }
  rho = fmax(rho, 0.0);
  for (int j = 0; j < 3; ++j) g[j] *= 2.0;
  const double sigma = GGA ? g[0] * g[0] + g[1] * g[1] + g[2] * g[2] : 0.0;
  const bool mask = rho > RHO_THR;
  const double w = weights[b];
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  double H[4][4];
  for (int p = 0; p < 4; ++p)
    for (int q = 0; q < 4; ++q) H[p][q] = 0.0;
  if (mask) {
    const ptxc::HDualN<2> e = ptxc::edens_closed2<GGA>(
        terms, fmax(rho, RHO_THR), fmax(sigma, SIGMA_FLOOR));
    v[0] = e.d[0];
    H[0][0] = e.h[0];
    if (GGA) {
      const double s = clamp_slope(sigma, SIGMA_FLOOR);
      for (int j = 0; j < 3; ++j) {
        v[1 + j] = 2.0 * e.d[1] * s * g[j];
        H[0][1 + j] = H[1 + j][0] = 2.0 * e.h[1] * s * g[j];
        for (int k = 0; k < 3; ++k)
          H[1 + j][1 + k] = 4.0 * e.h[2] * s * s * g[j] * g[k]
                            + (j == k ? 2.0 * e.d[1] * s : 0.0);
      }
    }
  }
  for (int c = 0; c < 4; ++c) wv[4 * b + c] = w * v[c];

  for (int A = 0; A < natm; ++A) {
    double p[3][4], sm[6];
    for (int x = 0; x < 3; ++x)
      for (int c = 0; c < 4; ++c) p[x][c] = 0.0;
    for (int k = 0; k < 6; ++k) sm[k] = 0.0;
    if (mask) {
      for (int i = atom_off[A]; i < atom_off[A + 1]; ++i) {
        const double d0 = dm[i];
        double dj[3] = {0.0, 0.0, 0.0}, a1[3], a2[6];
        if (GGA) {
          for (int j = 0; j < 3; ++j) dj[j] = dm[(1 + j) * plane + i];
        }
        for (int x = 0; x < 3; ++x) a1[x] = ao[(1 + x) * plane + i];
        for (int k = 0; k < 6; ++k) a2[k] = ao[(4 + k) * plane + i];
        for (int x = 0; x < 3; ++x) {
          p[x][0] += a1[x] * d0;
          if (GGA) {
            for (int j = 0; j < 3; ++j)
              p[x][1 + j] += a2[pair_index(x, j)] * d0 + a1[x] * dj[j];
          }
        }
        for (int x = 0, k = 0; x < 3; ++x) {
          for (int y = x; y < 3; ++y, ++k) {
            double t = v[0] * a2[k] * d0;
            if (GGA) {
              for (int j = 0; j < 3; ++j)
                t += v[1 + j] * (ao[(10 + triple_index(x, y, j)) * plane + i]
                                 * d0 + a2[k] * dj[j]);
            }
            sm[k] += t;
          }
        }
      }
    }
    for (int x = 0; x < 3; ++x) {
      double u[4];
      for (int c = 0; c < 4; ++c) u[c] = -2.0 * p[x][c];
      const size_t o = ((size_t)(3 * A + x) * npts + b) * 4;
      for (int c = 0; c < 4; ++c) {
        double h = 0.0;
        for (int q = 0; q < 4; ++q) h += H[c][q] * u[q];
        ut[o + c] = u[c];
        ht[o + c] = w * h;
      }
    }
    for (int k = 0; k < 6; ++k)
      same[((size_t)b * natm + A) * 6 + k] = 2.0 * w * sm[k];
  }

  double* r0 = xr + (size_t)b * nao;
  for (int i = 0; i < nao; ++i) {
    double t = 0.5 * w * v[0] * ao[i];
    double gx[3] = {0.0, 0.0, 0.0};
    if (GGA) {
      for (int j = 0; j < 3; ++j) {
        t += w * v[1 + j] * ao[(1 + j) * plane + i];
        for (int x = 0; x < 3; ++x)
          gx[x] += w * v[1 + j] * ao[(4 + pair_index(x, j)) * plane + i];
      }
    }
    r0[i] = t;
    for (int x = 0; x < 3; ++x) r0[(1 + x) * plane + i] = gx[x];
  }
}

template <bool GGA>
static void launch_hess(int blocks, int threads, cudaStream_t stream,
                        int npts, int nao, int natm, const int* atom_off,
                        const double* aod, const double* dmao,
                        const double* weights, const ptxc::Terms& terms,
                        double* wv, double* ut, double* ht, double* same,
                        double* xr) {
  xc_rks_hess_kernel<GGA><<<blocks, threads, 0, stream>>>(
      npts, nao, natm, atom_off, aod, dmao, weights, terms, wv, ut, ht,
      same, xr);
}

// aod (20, npts, nao) for a GGA (gga = 1) or (10, npts, nao) for an LDA;
// dmao (4, npts, nao) or (1, npts, nao); weights (npts,); atom_off (natm +
// 1,) the first AO of each atom (consecutive); ids/coeffs: the nterm
// components (the B3LYP and PBE families) and their weights; outputs wv (npts, 4),
// ut and ht (3 natm, npts, 4), same (npts, natm, 6), xr (4, npts, nao).
// Returns cudaGetLastError() after the launch, or -1 for a component that
// is not in the kernel or too many terms.
extern "C" int pt_xc_rks_hess(int gga, int npts, int nao, int natm,
                              const int* atom_off, const double* aod,
                              const double* dmao, const double* weights,
                              int nterm, const int* ids,
                              const double* coeffs, double* wv, double* ut,
                              double* ht, double* same, double* xr,
                              void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, nullptr, false, terms))
    return -1;
  const int threads = 128;
  const int blocks = (npts + threads - 1) / threads;
  (gga ? launch_hess<true> : launch_hess<false>)(
      blocks, threads, (cudaStream_t)stream, npts, nao, natm, atom_off, aod,
      dmao, weights, terms, wv, ut, ht, same, xr);
  return (int)cudaGetLastError();
}

#else  // PT_XC_DERIV1

template <bool GGA>
__global__ void __launch_bounds__(128) xc_rks_deriv1_kernel(
    int npts, int nao, int t0, int nt, const int* __restrict__ ao_atom,
    const double* __restrict__ aod, const double* __restrict__ wv,
    const double* __restrict__ ht, const double* __restrict__ xr,
    double* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)npts * nao) return;
  const long b = idx / nao;
  const int nu = (int)(idx % nao);
  const size_t plane = (size_t)npts * nao;
  const size_t at = (size_t)b * nao + nu;
  const double phi = aod[at];
  double a1[3], gx[3] = {0.0, 0.0, 0.0};
  for (int x = 0; x < 3; ++x) a1[x] = aod[(1 + x) * plane + at];
  if (GGA) {
    for (int x = 0; x < 3; ++x) gx[x] = xr[(1 + x) * plane + at];
  }
  const double wv0 = wv[4 * b];
  const int atom = ao_atom[nu];
  double* o = out + (size_t)b * nt * nao + nu;
  for (int t = t0; t < t0 + nt; ++t) {
    const double* h = ht + ((size_t)t * npts + b) * 4;
    double val = 0.5 * h[0] * phi;
    if (GGA) val += h[1] * a1[0] + h[2] * a1[1] + h[3] * a1[2];
    if (t / 3 == atom) {
      const int x = t % 3;
      val -= 0.5 * (wv0 * a1[x] + 2.0 * gx[x]);
    }
    o[(size_t)(t - t0) * nao] = val;
  }
}

template <bool GGA>
static void launch_deriv1(int blocks, int threads, cudaStream_t stream,
                          int npts, int nao, int t0, int nt,
                          const int* ao_atom, const double* aod,
                          const double* wv, const double* ht,
                          const double* xr, double* out) {
  xc_rks_deriv1_kernel<GGA><<<blocks, threads, 0, stream>>>(
      npts, nao, t0, nt, ao_atom, aod, wv, ht, xr, out);
}

// aod (>= 4, npts, nao): values and first derivatives; wv (npts, 4), ht
// (3 natm, npts, 4) and xr (4, npts, nao) from xc_rks_hess; ao_atom (nao,)
// the atom of each AO; out (npts, nt, nao) for the tangents t0 .. t0 + nt
// - 1. Returns cudaGetLastError() after the launch.
extern "C" int pt_xc_rks_deriv1(int gga, int npts, int nao, int t0, int nt,
                                const int* ao_atom, const double* aod,
                                const double* wv, const double* ht,
                                const double* xr, double* out, void* stream) {
  const int threads = 128;
  const long total = (long)npts * nao;
  const int blocks = (int)((total + threads - 1) / threads);
  (gga ? launch_deriv1<true> : launch_deriv1<false>)(
      blocks, threads, (cudaStream_t)stream, npts, nao, t0, nt, ao_atom,
      aod, wv, ht, xr, out);
  return (int)cudaGetLastError();
}

#endif  // PT_XC_DERIV1
