// The JAX package's density thresholds and the warp reductions shared by
// the XC kernels (xc_rks.cu, xc_uks.cu, xc_rks_grad.cu, xc_uks_grad.cu and
// the response kernels xc_fxc.cu, xc_rks_fxc.cu, xc_uks_fxc.cu), which
// reduce a point's AO row over the lanes of a warp.
#pragma once
#include "xc_funcs.cuh"

#define PT_FULL_MASK 0xffffffffu

constexpr double RHO_THR = 1e-10;       // pyscf_tpu/dft/numint.py:27-28
constexpr double SIGMA_FLOOR = 1e-20;

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(PT_FULL_MASK, x, off);
  }
  return x;
}

// rho = max(sum_i dm[i] ao[i], 0) and, for a GGA, g = 2 sum_i dm[i]
// grad ao[i] of one point's row (components stride apart), reduced over
// the warp: every lane ends with the same sums.
__device__ __forceinline__ void closed_density(int gga, int lane, int nao,
                                               size_t stride,
                                               const double* ao,
                                               const double* dm, double& rho,
                                               double& gx, double& gy,
                                               double& gz) {
  rho = gx = gy = gz = 0.0;
  for (int i = lane; i < nao; i += 32) {
    const double d = dm[i];
    rho += d * ao[i];
    if (gga) {
      gx += d * ao[stride + i];
      gy += d * ao[2 * stride + i];
      gz += d * ao[3 * stride + i];
    }
  }
  rho = fmax(warp_sum(rho), 0.0);
  if (gga) {
    gx = 2.0 * warp_sum(gx);
    gy = 2.0 * warp_sum(gy);
    gz = 2.0 * warp_sum(gz);
  }
}

// The functional's components for a launch, summed in the order given,
// with params (nterm x NPARAM, or null when no component takes any); false
// for too many terms, an unknown component, a range-separated one (CAM_B88,
// WB97) without rsh or a GGA component without gga.
inline bool make_terms(int gga, int nterm, const int* ids,
                       const double* coeffs, const double* params, bool rsh,
                       ptxc::Terms& terms) {
  if (nterm > ptxc::MAXTERM) return false;
  terms.n = nterm;
  for (int k = 0; k < nterm; ++k) {
    if (ids[k] < ptxc::SLATER || ids[k] > ptxc::PBE_C) return false;
    if (!rsh && (ids[k] == ptxc::CAM_B88 || ids[k] == ptxc::WB97))
      return false;
    if (!gga && ids[k] >= ptxc::B88) return false;
    terms.id[k] = ids[k];
    terms.c[k] = coeffs[k];
    for (int j = 0; j < ptxc::NPARAM; ++j) {
      terms.p[k][j] = params ? params[k * ptxc::NPARAM + j] : 0.0;
    }
  }
  return true;
}

// The densities of the 32 points base, ..., base + 31 of one warp, one
// point at a time: the lanes stride over the point's AO row and reduce
//   rho_s = max(sum_i dmao_s[i] ao[i], 0),  g_s = 2 sum_i dmao_s[i] grad ao[i]
// by shuffles for the nspin (1 or 2) rows of dmao (spins npts * nao apart,
// as the AO components), and lane p keeps point base + p's. The response
// kernels (xc_fxc.cu, xc_rks_fxc.cu, xc_uks_fxc.cu) then evaluate the
// functional on their own lane's point, not 32 times per point.
__device__ __forceinline__ void warp_point_densities(
    int gga, int nspin, int lane, long base, int npts, int nao,
    const double* aod, const double* dmao, double rho[2], double g[2][3]) {
  const size_t plane = (size_t)npts * nao;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    rho[s] = 0.0;
    g[s][0] = g[s][1] = g[s][2] = 0.0;
  }
  for (int p = 0; p < 32; ++p) {
    const long b = base + p;
    if (b >= npts) break;
    const double* ao = aod + (size_t)b * nao;
    double acc[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
    for (int i = lane; i < nao; i += 32) {
      const double a0 = ao[i];
      double ax = 0.0, ay = 0.0, az = 0.0;
      if (gga) {
        ax = ao[plane + i];
        ay = ao[2 * plane + i];
        az = ao[3 * plane + i];
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < nspin) {
          const double d = dmao[s * plane + (size_t)b * nao + i];
          acc[s][0] += d * a0;
          acc[s][1] += d * ax;
          acc[s][2] += d * ay;
          acc[s][3] += d * az;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s < nspin) {
        const double r = fmax(warp_sum(acc[s][0]), 0.0);
        double gx = 0.0, gy = 0.0, gz = 0.0;
        if (gga) {
          gx = 2.0 * warp_sum(acc[s][1]);
          gy = 2.0 * warp_sum(acc[s][2]);
          gz = 2.0 * warp_sum(acc[s][3]);
        }
        if (lane == p) {
          rho[s] = r;
          g[s][0] = gx;
          g[s][1] = gy;
          g[s][2] = gz;
        }
      }
    }
  }
}

// d max(x, lo)/dx as jax.grad and jax.jvp take it: 1 above lo, 1/2 at a
// tie, 0 below
__device__ __forceinline__ double clamp_slope(double x, double lo) {
  return x > lo ? 1.0 : (x == lo ? 0.5 : 0.0);
}
