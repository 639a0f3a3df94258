// The nuclear gradient of the spin-polarized XC energy on a fixed grid, per
// AO, summed over the points of a block.
//
// Replaces what jax.grad makes of pyscf_tpu/grad/autodiff.py
// _exc_quadrature (:199, unrestricted branch :228-245, under
// jax.value_and_grad at :313) with the B3LYP components of
// pyscf_tpu/dft/xc_funcs.py; plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_uks_grad_plain. The AO values with
// their second derivatives come from eval_ao.cu (deriv 2), dmao_s =
// aod[:4] @ D_s is one batched GEMM and stays a library call, and the sum
// of the partials and by atom are torch calls.
//
// With phi on atom A, dphi/dA_x = -d_x phi, so per unmasked point
//   dE/dA_x = sum_{mu on A} sum_s [a_s d_x phi_mu (D_s phi)_mu
//             + sum_j b_sj (d_x phi_mu (D_s d_j phi)_mu
//                           + d_x d_j phi_mu (D_s phi)_mu)],
//   a_s = -2 w vrho_s,  b_sj = -2 w (2 vsigma_ss g_sj + vsigma_ab g_s'j),
// g_sj = 2 sum (D_s phi) d_j phi. The mask and clamps are the JAX
// package's: rho_a + rho_b > RHO_THR, rho_s >= RHO_THR / 2, sigma_ss >=
// SIGMA_FLOOR, sigma_ab as it is. A derivative through a clamp max(x, lo)
// counts in full above the floor, half at it (a maximum at a tie, as JAX
// differentiates it) and not at all below, so one spin under its floor
// drops its vrho_s (and vsigma_ss) while the other spin's terms stay.
//
// A thread block takes PTS consecutive points. First one warp per point
// (the lanes stride over the AO row and reduce rho_s and g_s by shuffles,
// every lane evaluates the functional on dual numbers DualN<5> from
// xc_funcs.cuh, the numbers xc_uks computes) writes the point's eight
// coefficients a_s, b_sj to shared memory. Then the threads stride over the
// AOs and sum over the block's points, each thread reading one AO column,
// so every load of a warp is contiguous. Each block writes its own (3, nao)
// partials and its sum of w e_xc: no floating-point atomics, so a run
// repeats bit for bit. What bounds it on the card is the bytes: it reads
// the 10 AO rows and 8 dmao rows of every point once (4 and 2 for an LDA)
// and writes nblk x 3 x nao partials.
#include <cuda_runtime.h>

#include "xc_point.cuh"

// d max(x, lo)/dx as jax.grad takes it
__device__ __forceinline__ double clamp_slope(double x, double lo) {
  return x > lo ? 1.0 : (x == lo ? 0.5 : 0.0);
}

__global__ void xc_uks_grad_kernel(int gga, int npts, int nao,
                                   const double* __restrict__ aod,
                                   const double* __restrict__ dmao,
                                   const double* __restrict__ weights,
                                   ptxc::Terms terms, int pts,
                                   double* __restrict__ partials,
                                   double* __restrict__ exc_partials) {
  extern __shared__ double sh[];   // [8 coefficients per point | exc per warp]
  const int nwarp = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long b0 = (long)blockIdx.x * pts;
  const int nb = (int)(npts - b0 < pts ? npts - b0 : pts);
  const size_t stride = (size_t)npts * nao;   // between AO components
  const int nd = gga ? 4 : 1;                 // dmao rows per spin
  const double* dma = dmao;                   // (nd, npts, nao) per spin
  const double* dmb = dmao + nd * stride;
  double e_warp = 0.0;
  for (int k = warp; k < nb; k += nwarp) {
    const long b = b0 + k;
    double ra, ax, ay, az, rb, bx, by, bz;
    closed_density(gga, lane, nao, stride, aod + (size_t)b * nao,
                   dma + (size_t)b * nao, ra, ax, ay, az);
    closed_density(gga, lane, nao, stride, aod + (size_t)b * nao,
                   dmb + (size_t)b * nao, rb, bx, by, bz);
    double saa = 0.0, sab = 0.0, sbb = 0.0;
    if (gga) {
      saa = ax * ax + ay * ay + az * az;
      sab = ax * bx + ay * by + az * bz;
      sbb = bx * bx + by * by + bz * bz;
    }
    const double w = weights[b];
    const bool mask = (ra + rb) > RHO_THR;
    const double lo = 0.5 * RHO_THR;
    const ptxc::DualN<5> e = ptxc::edens_open(
        terms, mask ? fmax(ra, lo) : 1.0, mask ? fmax(rb, lo) : 1.0,
        mask ? fmax(saa, SIGMA_FLOOR) : 1.0, mask ? sab : 1.0,
        mask ? fmax(sbb, SIGMA_FLOOR) : 1.0);
    if (lane == 0) {
      double* c = sh + 8 * k;
      if (mask) {
        const double m2w = -2.0 * w;
        const double vaa = 2.0 * (e.d[2] * clamp_slope(saa, SIGMA_FLOOR));
        const double vbb = 2.0 * (e.d[4] * clamp_slope(sbb, SIGMA_FLOOR));
        const double vab = e.d[3];
        c[0] = m2w * (e.d[0] * clamp_slope(ra, lo));
        c[1] = m2w * (vaa * ax + vab * bx);
        c[2] = m2w * (vaa * ay + vab * by);
        c[3] = m2w * (vaa * az + vab * bz);
        c[4] = m2w * (e.d[1] * clamp_slope(rb, lo));
        c[5] = m2w * (vbb * bx + vab * ax);
        c[6] = m2w * (vbb * by + vab * ay);
        c[7] = m2w * (vbb * bz + vab * az);
      } else {
        for (int q = 0; q < 8; ++q) c[q] = 0.0;
      }
    }
    e_warp += mask ? w * e.v : 0.0;
  }
  if (lane == 0) sh[8 * pts + warp] = e_warp;
  __syncthreads();

  for (int i = threadIdx.x; i < nao; i += blockDim.x) {
    double sx = 0.0, sy = 0.0, sz = 0.0;
    for (int k = 0; k < nb; ++k) {
      const size_t o = (size_t)(b0 + k) * nao + i;
      const double px = aod[stride + o], py = aod[2 * stride + o],
                   pz = aod[3 * stride + o];
      double xx = 0.0, xy = 0.0, xz = 0.0, yy = 0.0, yz = 0.0, zz = 0.0;
      if (gga) {
        xx = aod[4 * stride + o];
        xy = aod[5 * stride + o];
        xz = aod[6 * stride + o];
        yy = aod[7 * stride + o];
        yz = aod[8 * stride + o];
        zz = aod[9 * stride + o];
      }
      for (int s = 0; s < 2; ++s) {
        const double* c = sh + 8 * k + 4 * s;
        const double* d = s ? dmb : dma;
        const double d0 = d[o];
        sx += c[0] * px * d0;
        sy += c[0] * py * d0;
        sz += c[0] * pz * d0;
        if (gga) {
          const double d1 = d[stride + o], d2 = d[2 * stride + o],
                       d3 = d[3 * stride + o];
          sx += c[1] * (px * d1 + xx * d0) + c[2] * (px * d2 + xy * d0)
                + c[3] * (px * d3 + xz * d0);
          sy += c[1] * (py * d1 + xy * d0) + c[2] * (py * d2 + yy * d0)
                + c[3] * (py * d3 + yz * d0);
          sz += c[1] * (pz * d1 + xz * d0) + c[2] * (pz * d2 + yz * d0)
                + c[3] * (pz * d3 + zz * d0);
        }
      }
    }
    double* out = partials + (size_t)blockIdx.x * 3 * nao + i;
    out[0] = sx;
    out[nao] = sy;
    out[2 * nao] = sz;
  }
  if (threadIdx.x == 0) {
    double e = 0.0;
    for (int k = 0; k < nwarp; ++k) e += sh[8 * pts + k];
    exc_partials[blockIdx.x] = e;
  }
}

// aod: (10, npts, nao) for a GGA (gga = 1) or (4, npts, nao) for an LDA;
// dmao: (2, 4, npts, nao), or (2, 1, npts, nao) for an LDA; weights
// (npts,); ids/coeffs: the nterm components and their weights, summed in
// this order; partials (ceil(npts / pts), 3, nao) and exc_partials
// (ceil(npts / pts),) per thread block of warps_per_block warps. Returns
// cudaGetLastError() after the launch, or -1 for an unknown component or
// too many terms.
extern "C" int pt_xc_uks_grad(int gga, int npts, int nao, const double* aod,
                              const double* dmao, const double* weights,
                              int nterm, const int* ids,
                              const double* coeffs, double* partials,
                              double* exc_partials, int pts,
                              int warps_per_block, void* stream) {
  ptxc::Terms terms;
  if (!make_terms(gga, nterm, ids, coeffs, terms)) return -1;
  const int blocks = (npts + pts - 1) / pts;
  const size_t shmem = (8 * pts + warps_per_block) * sizeof(double);
  xc_uks_grad_kernel<<<blocks, 32 * warps_per_block, shmem,
                       (cudaStream_t)stream>>>(gga, npts, nao, aod, dmao,
                                               weights, terms, pts, partials,
                                               exc_partials);
  return (int)cudaGetLastError();
}
