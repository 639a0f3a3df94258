// The JAX package's density thresholds and the warp reductions shared by
// the XC kernels (xc_rks.cu, xc_uks.cu, xc_rks_grad.cu), which take one
// point per warp with the lanes striding over the AO index.
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
// for too many terms, a component above max_id or a GGA component without
// gga.
inline bool make_terms(int gga, int nterm, const int* ids,
                       const double* coeffs, const double* params,
                       int max_id, ptxc::Terms& terms) {
  if (nterm > ptxc::MAXTERM) return false;
  terms.n = nterm;
  for (int k = 0; k < nterm; ++k) {
    if (ids[k] < ptxc::SLATER || ids[k] > max_id) return false;
    if (!gga && ids[k] >= ptxc::B88) return false;
    terms.id[k] = ids[k];
    terms.c[k] = coeffs[k];
    for (int j = 0; j < ptxc::NPARAM; ++j) {
      terms.p[k][j] = params ? params[k * ptxc::NPARAM + j] : 0.0;
    }
  }
  return true;
}
