// The spin-polarized XC energy's second derivatives along the nuclear
// coordinates on a fixed grid, at fixed spin densities D_a, D_b: the KS
// terms of the analytic DF-UKS Hessian.
//
// Replaces what the JAX package's jax.jvp of jax.grad makes of
// pyscf_tpu/grad/autodiff.py:199 _exc_quadrature (unrestricted branch,
// :228-245) in pyscf_tpu/hessian/uhf.py: the fixed-D Hessian of E_xc in X
// (`jv_rows`, :256-265) and the fixed-D derivative of V_xc,s = dE_xc/dD_s
// in X (`fock`, :136-143, under `_chunked_jvp`, :176-186), in two launches
// from this source; plain PyTorch twins: pyscf_tpu_torch/dft/numint.py
// xc_uks_hess_plain and xc_uks_deriv1_plain. It is xc_rks_hess.cu with
// a spin axis: the AO values to the third derivative come from eval_ao.cu
// (deriv 3), dmao_s = aod[:4] @ D_s is one batched GEMM, and the
// contractions of the per-point outputs (the quadratic term u_s . w H u_t,
// each spin's explicit cross term Z_s, V'_t,s = phi^T vt'_t,s) stay GEMMs.
//
// At a point the features are u = (rho_a, g_a, rho_b, g_b) (rho_s =
// max(phi . D_s phi, 0), g_sj = 2 (D_s phi) . d_j phi). The energy density
// e(x) of x = (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb), clamped as the
// JAX package clamps it (rho_s >= RHO_THR/2, sigma_ss >= SIGMA_FLOOR,
// sigma_ab as it is), is evaluated once on second-order dual numbers
// (xc_funcs.cuh edens_open2), and with J = dx/du (the clamps' slopes: 1
// above the floor, 1/2 at a tie, 0 below)
//   v = J^T e_x,  H = J^T e_xx J + sum_k e_k d2x_k/du2,
// d2sigma_ss/dg_s dg_s = 2 s'_ss 1 and d2sigma_ab/dg_a dg_b = 1; all zero
// where rho_a + rho_b <= RHO_THR, as jax.hessian takes the clamps. Along
// the tangent t = 3 A + x, per spin,
//   u_t,s = -2 sum_{mu on A} [d_x phi_mu (D_s phi)_mu,
//                             d_x d_j phi_mu (D_s phi)_mu
//                             + d_x phi_mu (D_s d_j phi)_mu].
//
// xc_uks_hess (this file without PT_XC_DERIV1): one thread per point
// reduces both spins' densities over the point's AO row, evaluates the
// functional once and walks the atoms' AO ranges, writing
//   wv   (B, 8)             w v
//   ut   (3 natm, B, 8)     u_t
//   ht   (3 natm, B, 8)     w H u_t
//   same (B, natm, 6)       sum_s 2 w sum_{mu on A} [v_rho_s d_xy phi_mu
//                           (D_s phi)_mu + sum_j v_g_sj (d_xyj phi_mu (D_s
//                           phi)_mu + d_xy phi_mu (D_s d_j phi)_mu)]
//   xr   (2, 4, B, nao)     per spin vtmp0_s = 1/2 w v_rho_s phi + sum_j w
//                           v_g_sj d_j phi and G_s,x = sum_j w v_g_sj d_x
//                           d_j phi.
// It reads the point's 20 AO rows and 8 dmao rows (10 and 2 for an LDA)
// from its own row of each.
//
// xc_uks_deriv1 (PT_XC_DERIV1): one thread per (point, AO nu), for the
// tangents t0 .. t0 + nt - 1 and both spins, writes
//   vt'_t,s[b, nu] = 1/2 ht_rho_s phi_nu + sum_j ht_g_sj d_j phi_nu
//                    - 1/2 [nu on A] (w v_rho_s d_x phi_nu + 2 G_s,x[nu])
// into (2, B, nt, nao), so that V'_t,s = F_t,s + F_t,s^T with F_t,s =
// phi^T vt'_t,s - [rows on A] (d_x phi)^T vtmp0_s. Bound by the bytes
// written.
//
// Neither uses floating-point atomics, so a run repeats bit for bit.
#include <cuda_runtime.h>

#include "xc_point.cuh"

#ifndef PT_XC_DERIV1

// the index in 0..5 of d_i d_j in xx, xy, xz, yy, yz, zz
__device__ __forceinline__ int pair_index(int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

// the index in 0..9 of d_i d_j d_k in xxx, xxy, xxz, xyy, xyz, xzz, yyy,
// yyz, yzz, zzz
__device__ __forceinline__ int triple_index(int i, int j, int k) {
  if (i > j) { const int t = i; i = j; j = t; }
  if (j > k) { const int t = j; j = k; k = t; }
  if (i > j) { const int t = i; i = j; j = t; }
  return i == 0 ? pair_index(j, k) : (i == 1 ? 3 + pair_index(j, k) : 9);
}

// the index of (i, j) in HDualN<5>'s packed upper triangle
__device__ __forceinline__ int packed5(int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * 5 - i * (i - 1) / 2 + (j - i);
}

template <bool GGA>
__global__ void __launch_bounds__(128) xc_uks_hess_kernel(
    int npts, int nao, int natm, const int* __restrict__ atom_off,
    const double* __restrict__ aod, const double* __restrict__ dmao,
    const double* __restrict__ weights, ptxc::Terms terms,
    double* __restrict__ wv, double* __restrict__ ut,
    double* __restrict__ ht, double* __restrict__ same,
    double* __restrict__ xr) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= npts) return;
  const size_t plane = (size_t)npts * nao;
  const int nd = GGA ? 4 : 1;
  const double* ao = aod + (size_t)b * nao;
  const double* dm[2] = {dmao + (size_t)b * nao,
                         dmao + nd * plane + (size_t)b * nao};
  double rho[2], g[2][3];
  for (int s = 0; s < 2; ++s) {
    double r = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
    for (int i = 0; i < nao; ++i) {
      const double d0 = dm[s][i];
      r += d0 * ao[i];
      if (GGA) {
        gx += d0 * ao[plane + i];
        gy += d0 * ao[2 * plane + i];
        gz += d0 * ao[3 * plane + i];
      }
    }
    rho[s] = fmax(r, 0.0);
    g[s][0] = 2.0 * gx;
    g[s][1] = 2.0 * gy;
    g[s][2] = 2.0 * gz;
  }
  double sig[3] = {0.0, 0.0, 0.0};   // aa, ab, bb
  if (GGA) {
    for (int j = 0; j < 3; ++j) {
      sig[0] += g[0][j] * g[0][j];
      sig[1] += g[0][j] * g[1][j];
      sig[2] += g[1][j] * g[1][j];
    }
  }
  const bool mask = rho[0] + rho[1] > RHO_THR;
  const double w = weights[b];
  double v[8], H[8][8];
  for (int p = 0; p < 8; ++p) {
    v[p] = 0.0;
    for (int q = 0; q < 8; ++q) H[p][q] = 0.0;
  }
  if (mask) {
    const double lo = 0.5 * RHO_THR;
    const ptxc::HDualN<5> e = ptxc::edens_open2<GGA>(
        terms, fmax(rho[0], lo), fmax(rho[1], lo), fmax(sig[0], SIGMA_FLOOR),
        sig[1], fmax(sig[2], SIGMA_FLOOR));
    // J = dx/du, x = (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb)
    double J[5][8];
    for (int k = 0; k < 5; ++k)
      for (int p = 0; p < 8; ++p) J[k][p] = 0.0;
    J[0][0] = clamp_slope(rho[0], lo);
    J[1][4] = clamp_slope(rho[1], lo);
    const double sl_aa = clamp_slope(sig[0], SIGMA_FLOOR);
    const double sl_bb = clamp_slope(sig[2], SIGMA_FLOOR);
    if (GGA) {
      for (int j = 0; j < 3; ++j) {
        J[2][1 + j] = 2.0 * sl_aa * g[0][j];
        J[3][1 + j] = g[1][j];
        J[3][5 + j] = g[0][j];
        J[4][5 + j] = 2.0 * sl_bb * g[1][j];
      }
    }
    for (int p = 0; p < 8; ++p) {
      double t = 0.0;
      for (int k = 0; k < 5; ++k) t += e.d[k] * J[k][p];
      v[p] = t;
    }
    for (int p = 0; p < 8; ++p) {
      double m[5];
      for (int l = 0; l < 5; ++l) {
        double t = 0.0;
        for (int k = 0; k < 5; ++k) t += J[k][p] * e.h[packed5(k, l)];
        m[l] = t;
      }
      for (int q = 0; q < 8; ++q) {
        double t = 0.0;
        for (int l = 0; l < 5; ++l) t += m[l] * J[l][q];
        H[p][q] = t;
      }
    }
    if (GGA) {
      for (int j = 0; j < 3; ++j) {
        H[1 + j][1 + j] += 2.0 * e.d[2] * sl_aa;
        H[5 + j][5 + j] += 2.0 * e.d[4] * sl_bb;
        H[1 + j][5 + j] += e.d[3];
        H[5 + j][1 + j] += e.d[3];
      }
    }
  }
  for (int c = 0; c < 8; ++c) wv[8 * b + c] = w * v[c];

  for (int A = 0; A < natm; ++A) {
    double p[2][3][4], sm[6];
    for (int s = 0; s < 2; ++s)
      for (int x = 0; x < 3; ++x)
        for (int c = 0; c < 4; ++c) p[s][x][c] = 0.0;
    for (int k = 0; k < 6; ++k) sm[k] = 0.0;
    if (mask) {
      for (int i = atom_off[A]; i < atom_off[A + 1]; ++i) {
        double a1[3], a2[6];
        for (int x = 0; x < 3; ++x) a1[x] = ao[(1 + x) * plane + i];
        for (int k = 0; k < 6; ++k) a2[k] = ao[(4 + k) * plane + i];
        for (int s = 0; s < 2; ++s) {
          const double d0 = dm[s][i];
          const double* vs = v + 4 * s;
          double dj[3] = {0.0, 0.0, 0.0};
          if (GGA) {
            for (int j = 0; j < 3; ++j) dj[j] = dm[s][(1 + j) * plane + i];
          }
          for (int x = 0; x < 3; ++x) {
            p[s][x][0] += a1[x] * d0;
            if (GGA) {
              for (int j = 0; j < 3; ++j)
                p[s][x][1 + j] += a2[pair_index(x, j)] * d0 + a1[x] * dj[j];
            }
          }
          for (int x = 0, k = 0; x < 3; ++x) {
            for (int y = x; y < 3; ++y, ++k) {
              double t = vs[0] * a2[k] * d0;
              if (GGA) {
                for (int j = 0; j < 3; ++j)
                  t += vs[1 + j]
                       * (ao[(10 + triple_index(x, y, j)) * plane + i] * d0
                          + a2[k] * dj[j]);
              }
              sm[k] += t;
            }
          }
        }
      }
    }
    for (int x = 0; x < 3; ++x) {
      double u[8];
      for (int s = 0; s < 2; ++s)
        for (int c = 0; c < 4; ++c) u[4 * s + c] = -2.0 * p[s][x][c];
      const size_t o = ((size_t)(3 * A + x) * npts + b) * 8;
      for (int c = 0; c < 8; ++c) {
        double h = 0.0;
        for (int q = 0; q < 8; ++q) h += H[c][q] * u[q];
        ut[o + c] = u[c];
        ht[o + c] = w * h;
      }
    }
    for (int k = 0; k < 6; ++k)
      same[((size_t)b * natm + A) * 6 + k] = 2.0 * w * sm[k];
  }

  for (int s = 0; s < 2; ++s) {
    const double* vs = v + 4 * s;
    double* r0 = xr + 4 * s * plane + (size_t)b * nao;
    for (int i = 0; i < nao; ++i) {
      double t = 0.5 * w * vs[0] * ao[i];
      double gx[3] = {0.0, 0.0, 0.0};
      if (GGA) {
        for (int j = 0; j < 3; ++j) {
          t += w * vs[1 + j] * ao[(1 + j) * plane + i];
          for (int x = 0; x < 3; ++x)
            gx[x] += w * vs[1 + j] * ao[(4 + pair_index(x, j)) * plane + i];
        }
      }
      r0[i] = t;
      for (int x = 0; x < 3; ++x) r0[(1 + x) * plane + i] = gx[x];
    }
  }
}

template <bool GGA>
static void launch_hess(int blocks, int threads, cudaStream_t stream,
                        int npts, int nao, int natm, const int* atom_off,
                        const double* aod, const double* dmao,
                        const double* weights, const ptxc::Terms& terms,
                        double* wv, double* ut, double* ht, double* same,
                        double* xr) {
  xc_uks_hess_kernel<GGA><<<blocks, threads, 0, stream>>>(
      npts, nao, natm, atom_off, aod, dmao, weights, terms, wv, ut, ht,
      same, xr);
}

// aod (20, npts, nao) for a GGA (gga = 1) or (10, npts, nao) for an LDA;
// dmao (2, 4, npts, nao) or (2, 1, npts, nao); weights (npts,); atom_off
// (natm + 1,) the first AO of each atom (consecutive); ids/coeffs: the
// nterm components (the B3LYP and PBE families) and their weights;
// outputs wv (npts, 8), ut and ht (3 natm, npts, 8), same (npts, natm, 6),
// xr (2, 4, npts, nao). Returns cudaGetLastError() after the launch, or -1
// for a component that is not in the kernel or too many terms.
extern "C" int pt_xc_uks_hess(int gga, int npts, int nao, int natm,
                              const int* atom_off, const double* aod,
                              const double* dmao, const double* weights,
                              int nterm, const int* ids,
                              const double* coeffs, double* wv, double* ut,
                              double* ht, double* same, double* xr,
                              void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, nullptr, false, terms)) return -1;
  const int threads = 128;
  const int blocks = (npts + threads - 1) / threads;
  (gga ? launch_hess<true> : launch_hess<false>)(
      blocks, threads, (cudaStream_t)stream, npts, nao, natm, atom_off, aod,
      dmao, weights, terms, wv, ut, ht, same, xr);
  return (int)cudaGetLastError();
}

#else  // PT_XC_DERIV1

template <bool GGA>
__global__ void __launch_bounds__(128) xc_uks_deriv1_kernel(
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
  double a1[3];
  for (int x = 0; x < 3; ++x) a1[x] = aod[(1 + x) * plane + at];
  const int atom = ao_atom[nu];
  for (int s = 0; s < 2; ++s) {
    double gx[3] = {0.0, 0.0, 0.0};
    if (GGA) {
      for (int x = 0; x < 3; ++x) gx[x] = xr[(4 * s + 1 + x) * plane + at];
    }
    const double wv0 = wv[8 * b + 4 * s];
    double* o = out + ((size_t)s * npts + b) * nt * nao + nu;
    for (int t = t0; t < t0 + nt; ++t) {
      const double* h = ht + ((size_t)t * npts + b) * 8 + 4 * s;
      double val = 0.5 * h[0] * phi;
      if (GGA) val += h[1] * a1[0] + h[2] * a1[1] + h[3] * a1[2];
      if (t / 3 == atom) {
        const int x = t % 3;
        val -= 0.5 * (wv0 * a1[x] + 2.0 * gx[x]);
      }
      o[(size_t)(t - t0) * nao] = val;
    }
  }
}

template <bool GGA>
static void launch_deriv1(int blocks, int threads, cudaStream_t stream,
                          int npts, int nao, int t0, int nt,
                          const int* ao_atom, const double* aod,
                          const double* wv, const double* ht,
                          const double* xr, double* out) {
  xc_uks_deriv1_kernel<GGA><<<blocks, threads, 0, stream>>>(
      npts, nao, t0, nt, ao_atom, aod, wv, ht, xr, out);
}

// aod (>= 4, npts, nao): values and first derivatives; wv (npts, 8), ht
// (3 natm, npts, 8) and xr (2, 4, npts, nao) from xc_uks_hess; ao_atom
// (nao,) the atom of each AO; out (2, npts, nt, nao) for the tangents t0
// .. t0 + nt - 1. Returns cudaGetLastError() after the launch.
extern "C" int pt_xc_uks_deriv1(int gga, int npts, int nao, int t0, int nt,
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
