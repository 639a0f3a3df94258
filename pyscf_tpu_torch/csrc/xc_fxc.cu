// The XC response kernel f_xc per grid point, and the pair features that
// carry it into the occupied-virtual space: the pointwise parts of the
// dense TDA/TDDFT A and B matrices.
//
// Replaces the jitted `block` of pyscf_tpu/tdscf/rhf.py:96-142 (_fxc_ov,
// restricted) and of pyscf_tpu/tdscf/uhf.py:98-141 (_fxc_ov_uks), in two
// launches from this source; plain PyTorch twins:
// pyscf_tpu_torch/dft/numint.py:xc_fxc_plain and xc_fxc_pairs_plain. The
// products around them, dmao = ao @ dm, the orbital values aod @ C and
// A_xc += P^T (w H P) over the points, are GEMMs and stay library calls.
//
// xc_fxc (this file without PT_FXC_PAIRS): per point, the 8x8 Hessian of
// e_xc over u = (rho_a, rho_b, grad rho_a, grad rho_b), as jax.hessian of
// e_of_u8 takes it, with _fxc_ov's features: no clamps, u = (rho/2, rho/2,
// g/2, g/2) for a closed shell or the spin densities for an open one at
// unmasked points, (1/2, 1/2, 0, 0) at masked ones, H zero where masked.
// One warp takes 32 points: the lanes reduce each point's densities over
// its AO row (xc_point.cuh warp_point_densities) and lane p keeps point p's,
// so that every lane evaluates the functional once, on second-order dual
// numbers in (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb) (xc_funcs.cuh
// HDualN<5>), and builds the 8x8 Hessian by the chain rule through
// sigma_st = g_s . g_t. It writes w H in 4x4 blocks over (rho, grad rho):
// the closed shell's H_aa + sgn H_ab (singlet sgn = 1, triplet -1), or
// the open shell's [H_aa, H_ab, H_ba, H_bb]. It reads the AO values and
// their gradients and dmao, 5 or 6 doubles per point and AO, and the
// functional's few ten thousand FP64 operations per point are done once
// per point: bound by the bytes.
//
// xc_fxc_pairs (PT_FXC_PAIRS): one thread block per point stages the
// point's occupied and virtual orbital values and gradients (4 (nocc +
// nvir) doubles) and its H blocks in shared memory; its threads stride over
// the pairs x = i nvir + a, writing
//   P  = [phi_i phi_a, grad(phi_i phi_a)]          (4, B, nov)
//   HP = H P for each of one or two H blocks       (nh, 4, B, nov)
// so the writes of a warp are contiguous. It is bound by those writes, 8 or
// 12 doubles per point and pair.
#include <cuda_runtime.h>

#include "xc_point.cuh"

#ifndef PT_FXC_PAIRS

// The 8x8 Hessian over u = (rho_a, rho_b, ga, gb) from e's derivatives over
// s = (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb):
//   H = J^T E'' J + sum_p E'_p d2 s_p / du2,  J = ds/du
__device__ __forceinline__ void hessian8(const ptxc::HDualN<5>& e,
                                         const double ga[3],
                                         const double gb[3], double H[8][8]) {
  double E2[5][5];
  int k = 0;
  for (int p = 0; p < 5; ++p)
    for (int q = p; q < 5; ++q, ++k) E2[p][q] = E2[q][p] = e.h[k];
  double J[5][8];
  for (int p = 0; p < 5; ++p)
    for (int u = 0; u < 8; ++u) J[p][u] = 0.0;
  J[0][0] = 1.0;
  J[1][1] = 1.0;
  for (int d = 0; d < 3; ++d) {
    J[2][2 + d] = 2.0 * ga[d];
    J[3][2 + d] = gb[d];
    J[3][5 + d] = ga[d];
    J[4][5 + d] = 2.0 * gb[d];
  }
  double T[5][8];
  for (int p = 0; p < 5; ++p)
    for (int v = 0; v < 8; ++v) {
      double t = 0.0;
      for (int q = 0; q < 5; ++q) t += E2[p][q] * J[q][v];
      T[p][v] = t;
    }
  for (int u = 0; u < 8; ++u)
    for (int v = 0; v < 8; ++v) {
      double h = 0.0;
      for (int p = 0; p < 5; ++p) h += J[p][u] * T[p][v];
      H[u][v] = h;
    }
  for (int d = 0; d < 3; ++d) {
    H[2 + d][2 + d] += 2.0 * e.d[2];
    H[5 + d][5 + d] += 2.0 * e.d[4];
    H[2 + d][5 + d] += e.d[3];
    H[5 + d][2 + d] += e.d[3];
  }
}

__global__ void xc_fxc_kernel(int nspin, double sgn, int npts, int nao,
                              const double* __restrict__ aod,
                              const double* __restrict__ dmao,
                              const double* __restrict__ weights,
                              ptxc::Terms terms, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long base = (((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
  if (base >= npts) return;
  double rho[2], g[2][3];
  warp_point_densities(1, nspin, lane, base, npts, nao, aod, dmao, rho, g);
  const long b = base + lane;
  if (b >= npts) return;
  const int nblk = nspin == 1 ? 1 : 4;
  double* o = out + (size_t)b * nblk * 16;
  double ra, rb, ga[3], gb[3];
  bool mask;
  if (nspin == 1) {
    // the half density of the closed shell in both spins
    mask = rho[0] > RHO_THR;
    ra = rb = 0.5 * rho[0];
    for (int d = 0; d < 3; ++d) ga[d] = gb[d] = 0.5 * g[0][d];
  } else {
    mask = (rho[0] + rho[1]) > RHO_THR;
    ra = rho[0];
    rb = rho[1];
    for (int d = 0; d < 3; ++d) {
      ga[d] = g[0][d];
      gb[d] = g[1][d];
    }
  }
  if (!mask) {
    for (int k = 0; k < nblk * 16; ++k) o[k] = 0.0;
    return;
  }
  const double saa = ga[0] * ga[0] + ga[1] * ga[1] + ga[2] * ga[2];
  const double sab = ga[0] * gb[0] + ga[1] * gb[1] + ga[2] * gb[2];
  const double sbb = gb[0] * gb[0] + gb[1] * gb[1] + gb[2] * gb[2];
  const ptxc::HDualN<5> e = ptxc::edens_open2(terms, ra, rb, saa, sab, sbb);
  double H[8][8];
  hessian8(e, ga, gb, H);
  const double w = weights[b];
  const int idx[2][4] = {{0, 2, 3, 4}, {1, 5, 6, 7}};
  if (nspin == 1) {
    for (int u = 0; u < 4; ++u)
      for (int v = 0; v < 4; ++v)
        o[4 * u + v] =
            w * (H[idx[0][u]][idx[0][v]] + sgn * H[idx[0][u]][idx[1][v]]);
  } else {
    for (int s = 0; s < 2; ++s)
      for (int t = 0; t < 2; ++t)
        for (int u = 0; u < 4; ++u)
          for (int v = 0; v < 4; ++v)
            o[(2 * s + t) * 16 + 4 * u + v] = w * H[idx[s][u]][idx[t][v]];
  }
}

// aod (4, npts, nao); dmao (nspin, npts, nao) of the total density (nspin
// 1) or of each spin (nspin 2); weights (npts,); ids/coeffs: the nterm
// components (the B3LYP and PBE families) and their weights; out (npts, 1, 4, 4) for
// nspin 1 with sgn +1 (singlet) or -1 (triplet), (npts, 4, 4, 4) for nspin
// 2. Returns cudaGetLastError() after the launch, or -1 for a component
// that is not in the kernel or too many terms.
extern "C" int pt_xc_fxc(int nspin, double sgn, int npts, int nao,
                         const double* aod, const double* dmao,
                         const double* weights, int nterm, const int* ids,
                         const double* coeffs, double* out,
                         int warps_per_block, void* stream) {
  ptxc::Terms terms;
  if (!make_terms(1, nterm, ids, coeffs, nullptr, false, terms))
    return -1;
  const int threads = 32 * warps_per_block;
  const long npw = 32L * warps_per_block;
  const int blocks = (int)((npts + npw - 1) / npw);
  xc_fxc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      nspin, sgn, npts, nao, aod, dmao, weights, terms, out);
  return (int)cudaGetLastError();
}

#else  // PT_FXC_PAIRS

__global__ void xc_fxc_pairs_kernel(int npts, int nocc, int nvir,
                                    const double* __restrict__ oo,
                                    const double* __restrict__ ov,
                                    const double* __restrict__ H, int nblk,
                                    int nh, int h0, int h1,
                                    double* __restrict__ P,
                                    double* __restrict__ HP) {
  extern __shared__ double sm[];   // [4 nocc | 4 nvir | 16 nh]
  const long b = blockIdx.x;
  double* so = sm;
  double* sv = sm + 4 * nocc;
  double* sh = sv + 4 * nvir;
  for (int k = threadIdx.x; k < 4 * nocc; k += blockDim.x) {
    const int c = k / nocc, i = k % nocc;
    so[k] = oo[((size_t)c * npts + b) * nocc + i];
  }
  for (int k = threadIdx.x; k < 4 * nvir; k += blockDim.x) {
    const int c = k / nvir, a = k % nvir;
    sv[k] = ov[((size_t)c * npts + b) * nvir + a];
  }
  for (int k = threadIdx.x; k < 16 * nh; k += blockDim.x) {
    const int blk = k < 16 ? h0 : h1;
    sh[k] = H[((size_t)b * nblk + blk) * 16 + (k & 15)];
  }
  __syncthreads();
  const int nov = nocc * nvir;
  const size_t plane = (size_t)npts * nov;
  for (int x = threadIdx.x; x < nov; x += blockDim.x) {
    const int i = x / nvir, a = x % nvir;
    const double o0 = so[i], v0 = sv[a];
    double p[4];
    p[0] = o0 * v0;
    for (int d = 1; d < 4; ++d)
      p[d] = so[d * nocc + i] * v0 + o0 * sv[d * nvir + a];
    const size_t at = (size_t)b * nov + x;
    for (int c = 0; c < 4; ++c) P[c * plane + at] = p[c];
    for (int h = 0; h < nh; ++h) {
      const double* hb = sh + 16 * h;
      for (int u = 0; u < 4; ++u)
        HP[(size_t)(4 * h + u) * plane + at] =
            hb[4 * u] * p[0] + hb[4 * u + 1] * p[1] + hb[4 * u + 2] * p[2]
            + hb[4 * u + 3] * p[3];
    }
  }
}

// oo (4, npts, nocc) and ov (4, npts, nvir): orbital values and gradients;
// H (npts, nblk, 4, 4) from xc_fxc; the nh (1 or 2) blocks h0, h1 of H
// give HP; P (4, npts, nocc * nvir), HP (nh, 4, npts, nocc * nvir).
// Returns cudaGetLastError() after the launch, or -1 for a bad nh.
extern "C" int pt_xc_fxc_pairs(int npts, int nocc, int nvir,
                               const double* oo, const double* ov,
                               const double* H, int nblk, int nh, int h0,
                               int h1, double* P, double* HP, int threads,
                               void* stream) {
  if (nh < 1 || nh > 2) return -1;
  const size_t shmem = (4 * (size_t)(nocc + nvir) + 16 * nh) * sizeof(double);
  if (shmem > 48 * 1024) {
    if (cudaFuncSetAttribute(xc_fxc_pairs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  xc_fxc_pairs_kernel<<<npts, threads, shmem, (cudaStream_t)stream>>>(
      npts, nocc, nvir, oo, ov, H, nblk, nh, h0, h1, P, HP);
  return (int)cudaGetLastError();
}

#endif  // PT_FXC_PAIRS
