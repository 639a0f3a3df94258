// The pointwise part of the closed-shell XC quadrature on one block of grid
// points: density, gradient, functional, derivatives and the V_xc
// half-product.
//
// Replaces pyscf_tpu/dft/numint.py:148-178 (inside _get_rks_core_aod) with
// the B3LYP components of pyscf_tpu/dft/xc_funcs.py and the derivatives
// that jax.grad takes at numint.py:135-137; plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_rks_plain. The two products around it,
// dmao = ao @ dm and V = ao^T @ vtmp, are GEMMs and stay library calls.
//
// One warp per point: the lanes stride over the AO index of the point's
// row, so every load and store of a warp is one contiguous row, and reduce
// rho = sum dmao ao and grad rho = 2 sum dmao dao by a butterfly of
// shuffles, which leaves the same sums on every lane. Each lane then
// evaluates the functional on dual numbers (xc_funcs.cuh) to the same
// numbers, and the lanes write their columns of
//     vtmp = 1/2 w vrho ao + 2 w vsigma (grad rho . grad ao).
// The sums n = sum w rho and exc = sum mask w e_xc are written per thread
// block and summed after the launch: no floating-point atomics, so a run
// gives the same energy bit for bit every time. What bounds it on the card
// is the bytes: it reads ao, its gradient and dmao and writes vtmp, 6 (GGA)
// or 3 (LDA) doubles per point and AO, and the per-point functional is a
// few hundred FP64 operations against 100-700 B of traffic per point.
#include <cuda_runtime.h>

#include "xc_funcs.cuh"

#define PT_FULL_MASK 0xffffffffu

constexpr double RHO_THR = 1e-10;
constexpr double SIGMA_FLOOR = 1e-20;

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(PT_FULL_MASK, x, off);
  }
  return x;
}

__global__ void xc_rks_kernel(int gga, int npts, int nao,
                              const double* __restrict__ aod,
                              const double* __restrict__ dmao,
                              const double* __restrict__ weights,
                              ptxc::Terms terms, double* __restrict__ vtmp,
                              double* __restrict__ partials) {
  extern __shared__ double sums[];   // [n per warp | exc per warp]
  const int nwarp = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long b = (long)blockIdx.x * nwarp + warp;
  double n_pt = 0.0, e_pt = 0.0;
  if (b < npts) {
    const size_t stride = (size_t)npts * nao;   // between AO components
    const double* ao = aod + (size_t)b * nao;
    const double* dm = dmao + (size_t)b * nao;
    double rho = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
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
    double sigma = 0.0;
    if (gga) {
      gx = 2.0 * warp_sum(gx);
      gy = 2.0 * warp_sum(gy);
      gz = 2.0 * warp_sum(gz);
      sigma = gx * gx + gy * gy + gz * gz;
    }
    const double w = weights[b];
    const bool mask = rho > RHO_THR;
    const double rho_s = mask ? fmax(rho, RHO_THR) : 1.0;
    const double sigma_s = mask ? fmax(sigma, SIGMA_FLOOR) : 1.0;
    const ptxc::DualN<2> e = ptxc::edens_closed(terms, rho_s, sigma_s);
    const double wv = mask ? w * e.d[0] : 0.0;
    const double wvs = mask ? w * e.d[1] : 0.0;
    n_pt = w * rho;
    e_pt = mask ? w * e.v : 0.0;
    const double hw = 0.5 * wv;
    const double fx = wvs * gx, fy = wvs * gy, fz = wvs * gz;
    double* out = vtmp + (size_t)b * nao;
    for (int i = lane; i < nao; i += 32) {
      double v = hw * ao[i];
      if (gga) {
        v = v + 2.0 * (fx * ao[stride + i] + fy * ao[2 * stride + i]
                       + fz * ao[3 * stride + i]);
      }
      out[i] = v;
    }
  }
  if (lane == 0) {
    sums[warp] = n_pt;
    sums[nwarp + warp] = e_pt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double n = 0.0, e = 0.0;
    for (int k = 0; k < nwarp; ++k) {
      n += sums[k];
      e += sums[nwarp + k];
    }
    partials[2 * blockIdx.x] = n;
    partials[2 * blockIdx.x + 1] = e;
  }
}

// aod: (4, npts, nao) for a GGA (gga = 1) or (npts, nao) for an LDA;
// dmao (npts, nao); weights (npts,); ids/coeffs: the nterm components and
// their weights, summed in this order; vtmp (npts, nao); partials
// (2 * ceil(npts / warps_per_block)): [n, exc] per thread block. Returns
// cudaGetLastError() after the launch, or -1 for an unknown component or
// too many terms.
extern "C" int pt_xc_rks(int gga, int npts, int nao, const double* aod,
                         const double* dmao, const double* weights,
                         int nterm, const int* ids, const double* coeffs,
                         double* vtmp, double* partials, int warps_per_block,
                         void* stream) {
  if (nterm > ptxc::MAXTERM) return -1;
  ptxc::Terms terms;
  terms.n = nterm;
  for (int k = 0; k < nterm; ++k) {
    if (ids[k] < ptxc::SLATER || ids[k] > ptxc::LYP) return -1;
    if (!gga && ids[k] >= ptxc::B88) return -1;
    terms.id[k] = ids[k];
    terms.c[k] = coeffs[k];
  }
  const int threads = 32 * warps_per_block;
  const int blocks = (npts + warps_per_block - 1) / warps_per_block;
  const size_t shmem = 2 * warps_per_block * sizeof(double);
  xc_rks_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      gga, npts, nao, aod, dmao, weights, terms, vtmp, partials);
  return (int)cudaGetLastError();
}
