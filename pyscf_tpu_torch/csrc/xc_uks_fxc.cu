// The spin-polarized XC response on one block of grid points: the tangent
// of both spins' V_xc half-products vtmp_s along spin transition
// densities, for the triplet TDA matrix-vector product.
//
// Replaces the jax.jvp of _get_uks_core_aod's V_xc at pyscf_tpu/tdscf/
// rhf.py:237 (inside the jitted matvec at :245; the core is
// pyscf_tpu/dft/numint.py:224-316); plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_uks_fxc_plain, torch.func.jvp of
// xc_uks_plain. The products around it, dmao1_s = ao @ ddm_s and
// dV_s = ao^T @ dvtmp_s, are GEMMs and stay library calls.
//
// At a point with rho_a + rho_b > RHO_THR, the SCF's clamps (rho_s >=
// RHO_THR/2, sigma_ss >= SIGMA_FLOOR, sigma_ab as it is) and the 15 second
// derivatives E'' of e_xc over s = (rho_a, rho_b, sigma_aa, sigma_ab,
// sigma_bb) at the clamped values (xc_funcs.cuh edens_open2 on HDualN<5>)
// give, for the tangents t = (rho1_a, rho1_b, 2 g_a.g1_a, g_a.g1_b +
// g1_a.g_b, 2 g_b.g1_b), each through its clamp's slope as jax.jvp takes
// it, dv = E'' t' and
//   dvtmp_a = 1/2 w dv_ra ao + [2 w (dv_saa g_a + v_saa g1_a)
//                               + w (dv_sab g_b + v_sab g1_b)] . grad ao
// and the same for b with a and b swapped; zero at masked points. One warp
// takes 32 points, as in xc_rks_fxc.cu: each lane evaluates the functional
// for its own point, then the warp writes each point's rows for every
// transition density. Bound by the bytes: it reads the AO values and
// gradients twice (the second time mostly from cache), the two dmao rows
// once and the two dmao1 rows of each vector once, and writes two dvtmp
// rows per vector.
#include <cuda_runtime.h>

#include "xc_point.cuh"

constexpr int UKS_FXC_WARPS = 4;
// per point: K[p][q] = w E''[p][q] slope_q (25, zero where masked), w
// (v_saa, v_sab, v_sbb) (3), g_a (3), g_b (3)
constexpr int UKS_FXC_NCO = 34;

__global__ void xc_uks_fxc_kernel(int gga, int npts, int nao, int nvec,
                                  const double* __restrict__ aod,
                                  const double* __restrict__ dmao,
                                  const double* __restrict__ dmao1,
                                  const double* __restrict__ weights,
                                  ptxc::Terms terms,
                                  double* __restrict__ out) {
  __shared__ double co[UKS_FXC_WARPS][32][UKS_FXC_NCO];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = ((long)blockIdx.x * UKS_FXC_WARPS + warp) * 32;
  if (base >= npts) return;
  const size_t plane = (size_t)npts * nao;
  double rho[2], g[2][3];
  warp_point_densities(gga, 2, lane, base, npts, nao, aod, dmao, rho, g);
  double* c = co[warp][lane];
  for (int k = 0; k < UKS_FXC_NCO; ++k) c[k] = 0.0;
  if (base + lane < npts && (rho[0] + rho[1]) > RHO_THR) {
    double saa = 0.0, sab = 0.0, sbb = 0.0;
    if (gga) {
      for (int d = 0; d < 3; ++d) {
        saa += g[0][d] * g[0][d];
        sab += g[0][d] * g[1][d];
        sbb += g[1][d] * g[1][d];
      }
    }
    const double lo = 0.5 * RHO_THR;
    const ptxc::HDualN<5> e = ptxc::edens_open2(
        terms, fmax(rho[0], lo), fmax(rho[1], lo), fmax(saa, SIGMA_FLOOR),
        sab, fmax(sbb, SIGMA_FLOOR));
    const double w = weights[base + lane];
    const double slope[5] = {clamp_slope(rho[0], lo), clamp_slope(rho[1], lo),
                             clamp_slope(saa, SIGMA_FLOOR), 1.0,
                             clamp_slope(sbb, SIGMA_FLOOR)};
    int k = 0;
    for (int p = 0; p < 5; ++p)
      for (int q = p; q < 5; ++q, ++k) {
        c[5 * p + q] = w * e.h[k] * slope[q];
        c[5 * q + p] = w * e.h[k] * slope[p];
      }
    c[25] = w * e.d[2];
    c[26] = w * e.d[3];
    c[27] = w * e.d[4];
    for (int d = 0; d < 3; ++d) {
      c[28 + d] = g[0][d];
      c[31 + d] = g[1][d];
    }
  }
  __syncwarp();
  for (int p = 0; p < 32; ++p) {
    const long b = base + p;
    if (b >= npts) break;
    const double* cp = co[warp][p];
    const double* ga = cp + 28;
    const double* gb = cp + 31;
    const double* ao = aod + (size_t)b * nao;
    for (int v = 0; v < nvec; ++v) {
      const double* da = dmao1 + ((size_t)(2 * v) * npts + b) * nao;
      const double* db = da + plane;
      double ra = 0.0, rb = 0.0, a1[3] = {0.0, 0.0, 0.0};
      double b1[3] = {0.0, 0.0, 0.0};
      for (int i = lane; i < nao; i += 32) {
        const double xa = da[i], xb = db[i];
        ra += xa * ao[i];
        rb += xb * ao[i];
        if (gga) {
          for (int d = 0; d < 3; ++d) {
            const double gd = ao[(d + 1) * plane + i];
            a1[d] += xa * gd;
            b1[d] += xb * gd;
          }
        }
      }
      double t[5] = {warp_sum(ra), warp_sum(rb), 0.0, 0.0, 0.0};
      if (gga) {
        for (int d = 0; d < 3; ++d) {
          a1[d] = 2.0 * warp_sum(a1[d]);
          b1[d] = 2.0 * warp_sum(b1[d]);
        }
        t[2] = 2.0 * (ga[0] * a1[0] + ga[1] * a1[1] + ga[2] * a1[2]);
        t[3] = (ga[0] * b1[0] + ga[1] * b1[1] + ga[2] * b1[2])
               + (a1[0] * gb[0] + a1[1] * gb[1] + a1[2] * gb[2]);
        t[4] = 2.0 * (gb[0] * b1[0] + gb[1] * b1[1] + gb[2] * b1[2]);
      }
      double dv[5];
      for (int q = 0; q < 5; ++q) {
        double s = 0.0;
        for (int r = 0; r < 5; ++r) s += cp[5 * q + r] * t[r];
        dv[q] = s;
      }
      double fa[3] = {0.0, 0.0, 0.0}, fb[3] = {0.0, 0.0, 0.0};
      if (gga) {
        for (int d = 0; d < 3; ++d) {
          fa[d] = 2.0 * (dv[2] * ga[d] + cp[25] * a1[d])
                  + (dv[3] * gb[d] + cp[26] * b1[d]);
          fb[d] = 2.0 * (dv[4] * gb[d] + cp[27] * b1[d])
                  + (dv[3] * ga[d] + cp[26] * a1[d]);
        }
      }
      const double ha = 0.5 * dv[0], hb = 0.5 * dv[1];
      double* oa = out + ((size_t)(2 * v) * npts + b) * nao;
      double* ob = oa + plane;
      for (int i = lane; i < nao; i += 32) {
        double va = ha * ao[i], vb = hb * ao[i];
        if (gga) {
          const double x = ao[plane + i], y = ao[2 * plane + i];
          const double z = ao[3 * plane + i];
          va = va + (fa[0] * x + fa[1] * y + fa[2] * z);
          vb = vb + (fb[0] * x + fb[1] * y + fb[2] * z);
        }
        oa[i] = va;
        ob[i] = vb;
      }
    }
  }
}

// aod: (4, npts, nao) for a GGA (gga = 1) or (npts, nao) for an LDA;
// dmao = ao @ dm0_s (2, npts, nao); dmao1 = ao @ ddm_{v,s} (nvec, 2, npts,
// nao); weights (npts,); ids/coeffs: the nterm components (the B3LYP
// family) and their weights; out (nvec, 2, npts, nao). Returns
// cudaGetLastError() after the launch, or -1 for a component that is not
// in the kernel or too many terms.
extern "C" int pt_xc_uks_fxc(int gga, int npts, int nao, int nvec,
                             const double* aod, const double* dmao,
                             const double* dmao1, const double* weights,
                             int nterm, const int* ids, const double* coeffs,
                             double* out, void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, nullptr, false, terms))
    return -1;
  const long npb = 32L * UKS_FXC_WARPS;
  const int blocks = (int)((npts + npb - 1) / npb);
  xc_uks_fxc_kernel<<<blocks, 32 * UKS_FXC_WARPS, 0, (cudaStream_t)stream>>>(
      gga, npts, nao, nvec, aod, dmao, dmao1, weights, terms, out);
  return (int)cudaGetLastError();
}
