// Becke fuzzy-cell partition weights of the molecular grid.
//
// Replaces pyscf_tpu/dft/gen_grid.py:_becke_weights_program (:179-205),
// which get_partition_fast runs; plain PyTorch twin:
// pyscf_tpu_torch/dft/gen_grid.py:becke_weights_plain. Same arithmetic:
// distances with the +1e-200 of the JAX package, mu_ij / R_ij plus the
// Treutler a_ij (1 - mu^2), three steps of (1.5 - 0.5 f^2) f, s = (1-f)/2,
// the product over j != i, then w0 P_owner / max(sum_i P_i, 1e-300).
//
// One thread per point; natm is a runtime argument and the atom tables
// (coordinates, 1/R_ij, a_ij) are read through the read-only L1 path, which
// every thread of a warp hits at the same address. The distance to atom j
// is recomputed in the inner loop rather than kept in a natm-sized local
// array, so any atom count runs without local memory. What bounds it on the
// card is FP64 arithmetic, about 20 natm^2 operations per point; it runs
// once per geometry.
#include <cuda_runtime.h>

__device__ __forceinline__ double atom_dist(double x, double y, double z,
                                            const double* __restrict__ atm,
                                            int j) {
  const double dx = x - __ldg(atm + 3 * j);
  const double dy = y - __ldg(atm + 3 * j + 1);
  const double dz = z - __ldg(atm + 3 * j + 2);
  return sqrt(dx * dx + dy * dy + dz * dz + 1e-200);
}

__global__ void __launch_bounds__(128) becke_kernel(
    int npts, int natm, const double* __restrict__ coords,
    const double* __restrict__ w0, const int* __restrict__ owner,
    const double* __restrict__ atm, const double* __restrict__ inv_dist,
    const double* __restrict__ a_adj, double* __restrict__ w) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double x = coords[3 * p], y = coords[3 * p + 1], z = coords[3 * p + 2];
  const int own = owner[p];
  double psum = 0.0, pown = 0.0;
  for (int i = 0; i < natm; ++i) {
    const double di = atom_dist(x, y, z, atm, i);
    double P = 1.0;
    for (int j = 0; j < natm; ++j) {
      if (j == i) continue;                  // s_ii = 1
      const double dj = atom_dist(x, y, z, atm, j);
      double mu = (di - dj) * __ldg(inv_dist + i * natm + j);
      mu = mu + __ldg(a_adj + i * natm + j) * (1.0 - mu * mu);
      double f = mu;
      for (int it = 0; it < 3; ++it) f = (1.5 - 0.5 * f * f) * f;
      P = P * (0.5 * (1.0 - f));
    }
    psum += P;
    if (i == own) pown = P;
  }
  w[p] = w0[p] * pown / fmax(psum, 1e-300);
}

// coords (npts, 3); w0 (npts,); owner (npts,); atm (natm, 3); inv_dist and
// a_adj (natm, natm); w (npts,). Returns cudaGetLastError() after the launch.
extern "C" int pt_becke(int npts, int natm, const double* coords,
                        const double* w0, const int* owner,
                        const double* atm, const double* inv_dist,
                        const double* a_adj, double* w, void* stream) {
  const int threads = 128;
  const int blocks = (int)(((long)npts + threads - 1) / threads);
  becke_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      npts, natm, coords, w0, owner, atm, inv_dist, a_adj, w);
  return (int)cudaGetLastError();
}
