// The closed-shell XC response on one block of grid points: the tangent of
// the V_xc half-product vtmp along transition densities, for the singlet
// TDA matrix-vector product.
//
// Replaces the jax.jvp of _get_rks_core_aod's V_xc at pyscf_tpu/tdscf/
// rhf.py:218 (inside the jitted matvec at :245; the core is
// pyscf_tpu/dft/numint.py:117-180); plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_rks_fxc_plain, torch.func.jvp of
// xc_rks_plain. The products around it, dmao1 = ao @ ddm and
// dV = ao^T @ dvtmp, are GEMMs and stay library calls.
//
// At a point with rho = max(dmao0 . ao, 0) > RHO_THR, the functional's
// clamps rho_s = max(rho, RHO_THR), sigma_s = max(sigma, SIGMA_FLOOR) and
// second derivatives e_rr, e_rs, e_ss at (rho_s, sigma_s) (xc_funcs.cuh
// edens_closed2 on HDualN<2>) give, for the tangents rho1 = dmao1 . ao,
// g1 = 2 dmao1 . grad ao and sigma1 = 2 g0 . g1 (a clamp passing its
// tangent as jax.jvp does: all above the floor, half at a tie),
//   dvrho   = e_rr rho1 + e_rs sigma1',  dvsigma = e_rs rho1 + e_ss sigma1'
//   dvtmp   = 1/2 w dvrho ao + 2 w (dvsigma g0 + vsigma g1) . grad ao
// and zero at masked points. One warp takes 32 points: it reduces their
// ground densities over the AO rows, each lane evaluates the functional
// for its own point and leaves its coefficients in shared memory, then the
// warp walks the points again, reducing the tangents of each of the nvec
// transition densities and writing their dvtmp rows, so each vector's
// rows are one contiguous store per warp. It reads the AO values and
// gradients twice (the second time mostly from cache), dmao0 once and each
// dmao1 once, and writes each dvtmp: bound by the bytes.
#include <cuda_runtime.h>

#include "xc_point.cuh"

constexpr int RKS_FXC_WARPS = 4;
// per point: w e_rr, w e_rs s', w e_rs, w e_ss s', w vsigma (all zero where
// masked; s' the sigma clamp's slope), g0
constexpr int RKS_FXC_NCO = 8;

__global__ void xc_rks_fxc_kernel(int gga, int npts, int nao, int nvec,
                                  const double* __restrict__ aod,
                                  const double* __restrict__ dmao,
                                  const double* __restrict__ dmao1,
                                  const double* __restrict__ weights,
                                  ptxc::Terms terms,
                                  double* __restrict__ out) {
  __shared__ double co[RKS_FXC_WARPS][32][RKS_FXC_NCO];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = ((long)blockIdx.x * RKS_FXC_WARPS + warp) * 32;
  if (base >= npts) return;
  const size_t plane = (size_t)npts * nao;
  double rho[2], g[2][3];
  warp_point_densities(gga, 1, lane, base, npts, nao, aod, dmao, rho, g);
  double* c = co[warp][lane];
  for (int k = 0; k < RKS_FXC_NCO; ++k) c[k] = 0.0;
  if (base + lane < npts && rho[0] > RHO_THR) {
    const double sigma =
        gga ? g[0][0] * g[0][0] + g[0][1] * g[0][1] + g[0][2] * g[0][2]
            : 0.0;
    const ptxc::HDualN<2> e = ptxc::edens_closed2(
        terms, fmax(rho[0], RHO_THR), fmax(sigma, SIGMA_FLOOR));
    const double w = weights[base + lane];
    const double s1 = clamp_slope(sigma, SIGMA_FLOOR);
    c[0] = w * e.h[0];
    c[1] = w * e.h[1] * s1;
    c[2] = w * e.h[1];
    c[3] = w * e.h[2] * s1;
    c[4] = w * e.d[1];
    c[5] = g[0][0];
    c[6] = g[0][1];
    c[7] = g[0][2];
  }
  __syncwarp();
  for (int p = 0; p < 32; ++p) {
    const long b = base + p;
    if (b >= npts) break;
    const double* cp = co[warp][p];
    const double* ao = aod + (size_t)b * nao;
    for (int v = 0; v < nvec; ++v) {
      const double* d1 = dmao1 + ((size_t)v * npts + b) * nao;
      double r1 = 0.0, x1 = 0.0, y1 = 0.0, z1 = 0.0;
      for (int i = lane; i < nao; i += 32) {
        const double d = d1[i];
        r1 += d * ao[i];
        if (gga) {
          x1 += d * ao[plane + i];
          y1 += d * ao[2 * plane + i];
          z1 += d * ao[3 * plane + i];
        }
      }
      r1 = warp_sum(r1);
      double fx = 0.0, fy = 0.0, fz = 0.0, hw;
      if (gga) {
        x1 = 2.0 * warp_sum(x1);
        y1 = 2.0 * warp_sum(y1);
        z1 = 2.0 * warp_sum(z1);
        const double sig1 = 2.0 * (cp[5] * x1 + cp[6] * y1 + cp[7] * z1);
        hw = 0.5 * (cp[0] * r1 + cp[1] * sig1);
        const double dvs = cp[2] * r1 + cp[3] * sig1;
        fx = 2.0 * (dvs * cp[5] + cp[4] * x1);
        fy = 2.0 * (dvs * cp[6] + cp[4] * y1);
        fz = 2.0 * (dvs * cp[7] + cp[4] * z1);
      } else {
        hw = 0.5 * (cp[0] * r1);
      }
      double* o = out + ((size_t)v * npts + b) * nao;
      for (int i = lane; i < nao; i += 32) {
        double val = hw * ao[i];
        if (gga) {
          val = val + (fx * ao[plane + i] + fy * ao[2 * plane + i]
                       + fz * ao[3 * plane + i]);
        }
        o[i] = val;
      }
    }
  }
}

// aod: (4, npts, nao) for a GGA (gga = 1) or (npts, nao) for an LDA;
// dmao = ao @ dm0 (npts, nao); dmao1 = ao @ ddm_v (nvec, npts, nao);
// weights (npts,); ids/coeffs: the nterm components (the B3LYP and PBE families) and
// their weights; out (nvec, npts, nao). Returns cudaGetLastError() after
// the launch, or -1 for a component that is not in the kernel or too many
// terms.
extern "C" int pt_xc_rks_fxc(int gga, int npts, int nao, int nvec,
                             const double* aod, const double* dmao,
                             const double* dmao1, const double* weights,
                             int nterm, const int* ids, const double* coeffs,
                             double* out, void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, nullptr, false, terms))
    return -1;
  const long npb = 32L * RKS_FXC_WARPS;
  const int blocks = (int)((npts + npb - 1) / npb);
  xc_rks_fxc_kernel<<<blocks, 32 * RKS_FXC_WARPS, 0, (cudaStream_t)stream>>>(
      gga, npts, nao, nvec, aod, dmao, dmao1, weights, terms, out);
  return (int)cudaGetLastError();
}
