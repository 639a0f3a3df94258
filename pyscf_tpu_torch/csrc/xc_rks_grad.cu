// The nuclear gradient of the closed-shell XC energy on a fixed grid, per
// AO, summed over the points of a block.
//
// Replaces what jax.grad makes of pyscf_tpu/grad/autodiff.py
// _exc_quadrature (:199, restricted branch :221-227) with the B3LYP
// components of pyscf_tpu/dft/xc_funcs.py; plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_rks_grad_plain. The AO values with
// their second derivatives come from eval_ao.cu (deriv 2), dmao =
// aod[:4] @ dm is a GEMM and stays a library call, and the sum of the
// partials and by atom are torch calls.
//
// With phi on atom A, dphi/dA_x = -d_x phi, so per unmasked point
//   dE/dA_x = sum_{mu on A} -2 w [vrho d_x phi_mu (D phi)_mu
//             + 2 vsigma sum_j g_j (d_x phi_mu (D d_j phi)_mu
//                                   + d_x d_j phi_mu (D phi)_mu)],
// g_j = 2 sum (D phi) d_j phi. vsigma is the derivative through the clamp
// max(sigma, SIGMA_FLOOR): in full above the floor, half at it (a maximum
// at a tie, as JAX differentiates it), nothing below, so that it is zero
// where jax.grad gives zero.
//
// A thread block takes PTS consecutive points. First one warp per point
// (as xc_rks.cu: the lanes stride over the AO row and reduce rho and g by
// shuffles, every lane evaluates the functional on dual numbers DualN<2>
// from xc_funcs.cuh, the numbers xc_rks computes) writes the point's four
// coefficients -2 w vrho and -4 w vsigma g_j to shared memory. Then the
// threads stride over the AOs and sum over the block's points, each
// thread reading one AO column, so every load of a warp is contiguous.
// Each block writes its own (3, nao) partials and its sum of w e_xc: no
// floating-point atomics, so a run repeats bit for bit. What bounds it on
// the card is the bytes: it reads the 10 AO rows and 4 dmao rows of every
// point once (4 and 1 for an LDA) and writes nblk x 3 x nao partials.
#include <cuda_runtime.h>

#include "xc_point.cuh"

__global__ void xc_rks_grad_kernel(int gga, int npts, int nao,
                                   const double* __restrict__ aod,
                                   const double* __restrict__ dmao,
                                   const double* __restrict__ weights,
                                   ptxc::Terms terms, int pts,
                                   double* __restrict__ partials,
                                   double* __restrict__ exc_partials) {
  extern __shared__ double sh[];   // [4 coefficients per point | exc per warp]
  const int nwarp = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long b0 = (long)blockIdx.x * pts;
  const int nb = (int)(npts - b0 < pts ? npts - b0 : pts);
  const size_t stride = (size_t)npts * nao;   // between AO components
  double e_warp = 0.0;
  for (int k = warp; k < nb; k += nwarp) {
    const long b = b0 + k;
    double rho, gx, gy, gz;
    closed_density(gga, lane, nao, stride, aod + (size_t)b * nao,
                   dmao + (size_t)b * nao, rho, gx, gy, gz);
    const double sigma = gga ? gx * gx + gy * gy + gz * gz : 0.0;
    const double w = weights[b];
    const bool mask = rho > RHO_THR;
    const double rho_s = mask ? fmax(rho, RHO_THR) : 1.0;
    const double sigma_s = mask ? fmax(sigma, SIGMA_FLOOR) : 1.0;
    const ptxc::DualN<2> e = ptxc::edens_closed(terms, rho_s, sigma_s);
    const double vs = sigma > SIGMA_FLOOR ? e.d[1]
                      : (sigma == SIGMA_FLOOR ? 0.5 * e.d[1] : 0.0);
    const double bs = mask ? -4.0 * w * vs : 0.0;
    if (lane == 0) {
      sh[4 * k] = mask ? -2.0 * w * e.d[0] : 0.0;
      sh[4 * k + 1] = bs * gx;
      sh[4 * k + 2] = bs * gy;
      sh[4 * k + 3] = bs * gz;
    }
    e_warp += mask ? w * e.v : 0.0;
  }
  if (lane == 0) sh[4 * pts + warp] = e_warp;
  __syncthreads();

  for (int i = threadIdx.x; i < nao; i += blockDim.x) {
    double sx = 0.0, sy = 0.0, sz = 0.0;
    for (int k = 0; k < nb; ++k) {
      const double* c = sh + 4 * k;
      const size_t o = (size_t)(b0 + k) * nao + i;
      const double d0 = dmao[o];
      const double px = aod[stride + o], py = aod[2 * stride + o],
                   pz = aod[3 * stride + o];
      sx += c[0] * px * d0;
      sy += c[0] * py * d0;
      sz += c[0] * pz * d0;
      if (gga) {
        const double d1 = dmao[stride + o], d2 = dmao[2 * stride + o],
                     d3 = dmao[3 * stride + o];
        const double xx = aod[4 * stride + o], xy = aod[5 * stride + o],
                     xz = aod[6 * stride + o], yy = aod[7 * stride + o],
                     yz = aod[8 * stride + o], zz = aod[9 * stride + o];
        sx += c[1] * (px * d1 + xx * d0) + c[2] * (px * d2 + xy * d0)
              + c[3] * (px * d3 + xz * d0);
        sy += c[1] * (py * d1 + xy * d0) + c[2] * (py * d2 + yy * d0)
              + c[3] * (py * d3 + yz * d0);
        sz += c[1] * (pz * d1 + xz * d0) + c[2] * (pz * d2 + yz * d0)
              + c[3] * (pz * d3 + zz * d0);
      }
    }
    double* out = partials + (size_t)blockIdx.x * 3 * nao + i;
    out[0] = sx;
    out[nao] = sy;
    out[2 * nao] = sz;
  }
  if (threadIdx.x == 0) {
    double e = 0.0;
    for (int k = 0; k < nwarp; ++k) e += sh[4 * pts + k];
    exc_partials[blockIdx.x] = e;
  }
}

// aod: (10, npts, nao) for a GGA (gga = 1) or (4, npts, nao) for an LDA;
// dmao: (4, npts, nao), or (1, npts, nao) for an LDA; weights (npts,);
// ids/coeffs: the nterm components and their weights, summed in this
// order; partials (ceil(npts / pts), 3, nao) and exc_partials
// (ceil(npts / pts),) per thread block of warps_per_block warps. Returns
// cudaGetLastError() after the launch, or -1 for an unknown component or
// too many terms.
extern "C" int pt_xc_rks_grad(int gga, int npts, int nao, const double* aod,
                              const double* dmao, const double* weights,
                              int nterm, const int* ids,
                              const double* coeffs, double* partials,
                              double* exc_partials, int pts,
                              int warps_per_block, void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, nullptr, false, terms)) {
    return -1;
  }
  const int blocks = (npts + pts - 1) / pts;
  const size_t shmem = (4 * pts + warps_per_block) * sizeof(double);
  xc_rks_grad_kernel<<<blocks, 32 * warps_per_block, shmem,
                       (cudaStream_t)stream>>>(gga, npts, nao, aod, dmao,
                                               weights, terms, pts, partials,
                                               exc_partials);
  return (int)cudaGetLastError();
}
