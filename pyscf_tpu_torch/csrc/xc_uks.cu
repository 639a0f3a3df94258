// The pointwise part of the spin-polarized XC quadrature on one block of
// grid points: the two spin densities and their gradients, the functional
// with its five first derivatives, and the two V_xc half-products.
//
// Replaces pyscf_tpu/dft/numint.py:246-302 (inside _get_uks_core_aod) with
// the B3LYP components of pyscf_tpu/dft/xc_funcs.py and the derivatives
// that jax.grad takes at numint.py:239-240; plain PyTorch twin:
// pyscf_tpu_torch/dft/numint.py:xc_uks_plain. The products around it,
// dmao_s = ao @ dm_s and V_s = ao^T @ vtmp_s, are GEMMs and stay library
// calls.
//
// One warp per point, as in xc_rks.cu: the lanes stride over the AO index,
// so each load and store of a warp is one contiguous row, and reduce
//   rho_s = sum dmao_s ao,  grad rho_s = 2 sum dmao_s grad ao   (s = a, b)
// by a butterfly of shuffles, which leaves the same sums on every lane. With
// JAX's mask (rho_a + rho_b > RHO_THR) and clamps (rho_s >= RHO_THR / 2,
// sigma_ss >= SIGMA_FLOOR, sigma_ab as it is), each lane evaluates the
// functional on dual numbers with five tangents (xc_funcs.cuh) to the same
// numbers, and the lanes write their columns of
//   vtmp_s = 1/2 w vrho_s ao + 2 w vsigma_ss (grad rho_s . grad ao)
//            + w vsigma_ab (grad rho_s' . grad ao).
// The sums n_a, n_b and exc are written per thread block and summed after
// the launch: no floating-point atomics, so the energy repeats bit for bit.
// What bounds it on the card is the bytes: it reads ao, its gradient and the
// two dmao rows and writes two vtmp rows, 8 (GGA) or 5 (LDA) doubles per
// point and AO.
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

__global__ void xc_uks_kernel(int gga, int npts, int nao,
                              const double* __restrict__ aod,
                              const double* __restrict__ dmao,
                              const double* __restrict__ weights,
                              ptxc::Terms terms, double* __restrict__ vtmp,
                              double* __restrict__ partials) {
  extern __shared__ double sums[];   // [n_a | n_b | exc], one per warp
  const int nwarp = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long b = (long)blockIdx.x * nwarp + warp;
  double na_pt = 0.0, nb_pt = 0.0, e_pt = 0.0;
  if (b < npts) {
    const size_t plane = (size_t)npts * nao;   // between components / spins
    const double* ao = aod + (size_t)b * nao;
    const double* dma = dmao + (size_t)b * nao;
    const double* dmb = dma + plane;
    double ra = 0.0, rb = 0.0;
    double ax = 0.0, ay = 0.0, az = 0.0, bx = 0.0, by = 0.0, bz = 0.0;
    for (int i = lane; i < nao; i += 32) {
      const double da = dma[i], db = dmb[i];
      ra += da * ao[i];
      rb += db * ao[i];
      if (gga) {
        const double x = ao[plane + i], y = ao[2 * plane + i];
        const double z = ao[3 * plane + i];
        ax += da * x;
        ay += da * y;
        az += da * z;
        bx += db * x;
        by += db * y;
        bz += db * z;
      }
    }
    ra = fmax(warp_sum(ra), 0.0);
    rb = fmax(warp_sum(rb), 0.0);
    double saa = 0.0, sab = 0.0, sbb = 0.0;
    if (gga) {
      ax = 2.0 * warp_sum(ax);
      ay = 2.0 * warp_sum(ay);
      az = 2.0 * warp_sum(az);
      bx = 2.0 * warp_sum(bx);
      by = 2.0 * warp_sum(by);
      bz = 2.0 * warp_sum(bz);
      saa = ax * ax + ay * ay + az * az;
      sab = ax * bx + ay * by + az * bz;
      sbb = bx * bx + by * by + bz * bz;
    }
    const double w = weights[b];
    const bool mask = (ra + rb) > RHO_THR;
    const ptxc::DualN<5> e = ptxc::edens_open(
        terms, mask ? fmax(ra, 0.5 * RHO_THR) : 1.0,
        mask ? fmax(rb, 0.5 * RHO_THR) : 1.0,
        mask ? fmax(saa, SIGMA_FLOOR) : 1.0, mask ? sab : 1.0,
        mask ? fmax(sbb, SIGMA_FLOOR) : 1.0);
    na_pt = w * ra;
    nb_pt = w * rb;
    e_pt = mask ? w * e.v : 0.0;
    // spin a: (vrho_a, vsigma_aa, own gradient a, other gradient b); spin b
    // the same with a and b swapped; vsigma_ab couples the two
    const double wx = mask ? w * e.d[3] : 0.0;
    const double hwa = mask ? 0.5 * (w * e.d[0]) : 0.0;
    const double hwb = mask ? 0.5 * (w * e.d[1]) : 0.0;
    const double wa = mask ? w * e.d[2] : 0.0;
    const double wb = mask ? w * e.d[4] : 0.0;
    const double fax = 2.0 * (wa * ax) + wx * bx;
    const double fay = 2.0 * (wa * ay) + wx * by;
    const double faz = 2.0 * (wa * az) + wx * bz;
    const double fbx = 2.0 * (wb * bx) + wx * ax;
    const double fby = 2.0 * (wb * by) + wx * ay;
    const double fbz = 2.0 * (wb * bz) + wx * az;
    double* outa = vtmp + (size_t)b * nao;
    double* outb = outa + plane;
    for (int i = lane; i < nao; i += 32) {
      double va = hwa * ao[i];
      double vb = hwb * ao[i];
      if (gga) {
        const double x = ao[plane + i], y = ao[2 * plane + i];
        const double z = ao[3 * plane + i];
        va = va + (fax * x + fay * y + faz * z);
        vb = vb + (fbx * x + fby * y + fbz * z);
      }
      outa[i] = va;
      outb[i] = vb;
    }
  }
  if (lane == 0) {
    sums[warp] = na_pt;
    sums[nwarp + warp] = nb_pt;
    sums[2 * nwarp + warp] = e_pt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double na = 0.0, nb = 0.0, e = 0.0;
    for (int k = 0; k < nwarp; ++k) {
      na += sums[k];
      nb += sums[nwarp + k];
      e += sums[2 * nwarp + k];
    }
    partials[3 * blockIdx.x] = na;
    partials[3 * blockIdx.x + 1] = nb;
    partials[3 * blockIdx.x + 2] = e;
  }
}

// aod: (4, npts, nao) for a GGA (gga = 1) or (npts, nao) for an LDA;
// dmao (2, npts, nao); weights (npts,); ids/coeffs: the nterm components
// and their weights, summed in this order; vtmp (2, npts, nao); partials
// (3 * ceil(npts / warps_per_block)): [n_a, n_b, exc] per thread block.
// Returns cudaGetLastError() after the launch, or -1 for an unknown
// component or too many terms.
extern "C" int pt_xc_uks(int gga, int npts, int nao, const double* aod,
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
  const size_t shmem = 3 * warps_per_block * sizeof(double);
  xc_uks_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      gga, npts, nao, aod, dmao, weights, terms, vtmp, partials);
  return (int)cudaGetLastError();
}
