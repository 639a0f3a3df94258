// The MP2 / CCSD pair-energy pass: one fused read of (ia|jb) that forms
// the amplitudes and reduces the direct and the exchange sums.
//
// Replaces pyscf_tpu/mp/mp2.py:_emp2_from_ovov (and the same form in
// mp2.py:_emp2_os_ss, mp/ump2.py:_emp2_uhf and cc/ccsd.py:energy); plain
// PyTorch twin: pyscf_tpu_torch/mp/mp2.py:mp2_energy_plain. With ovov
// (no1, nv1, no2, nv2) and the orbital-energy differences eia1 (no1, nv1),
// eia2 (no2, nv2):
//   x[i,a,j,b] = ovov[i,a,j,b] / (eia1[i,a] + eia2[j,b])   (tau null;
//                written to t2 when t2 is not null),
//   or x[i,a,j,b] = tau[i,j,a,b], the given CCSD tau read in its own
//   (no1, no2, nv1, nv2) layout (no transposed copy is made),
//   direct   = sum ovov[i,a,j,b] x[i,a,j,b],
//   exchange = sum ovov[i,a,j,b] x[i,b,j,a]   (only when exchange != 0,
//              which needs nv1 == nv2).
// Closed-shell MP2 is 2 direct - exchange, its opposite- and same-spin
// parts direct and direct - exchange, a UMP2 same-spin block
// (direct - exchange) / 2 and the opposite-spin block direct alone.
//
// One block per occupied pair (i, j): its threads stride over the nv1 x nv2
// tile, each element read once in order, and the exchange partner
// [i,b,j,a] read (and, without x, divided) again from the same tile,
// which this block has just brought into L1/L2: "one transposed read".
// What bounds it on the card is bytes: ovov read once and t2 written once
// (61 MB at benzene/def2-SVP, about 18 us at 3.35 TB/s); the transposed
// read hits the cache. The two sums are reduced per block in shared memory
// and written per block; the wrapper adds the blocks' partial sums in a
// fixed order, so there are no atomics and every run gives the same sum.
// The staging loops stride by the block size, so the host build of the
// tests runs it with one thread per block.
//
// partials (no1 * no2, 2): [direct, exchange] per block.
#include <cuda_runtime.h>

constexpr int MP2_MAX_THREADS = 256;

template <int MAXT>
__global__ void __launch_bounds__(MAXT) mp2_energy_kernel(
    int no1, int nv1, int no2, int nv2, const double* __restrict__ ovov,
    const double* __restrict__ eia1, const double* __restrict__ eia2,
    const double* __restrict__ tau, int exchange, double* __restrict__ t2,
    double* __restrict__ partials) {
  __shared__ double sd[MAXT], sx[MAXT];
  const int i = blockIdx.x / no2;
  const int j = blockIdx.x % no2;
  const int nab = nv1 * nv2;
  // element [i,a,j,b] at row (i*nv1 + a)*no2 + j of nv2
  const double* g_i = ovov + (size_t)i * nv1 * no2 * nv2 + (size_t)j * nv2;
  const long row = (long)no2 * nv2;
  // tau[i,j,a,b] at (i*no2 + j)*nab + a*nv2 + b, and blockIdx.x = i*no2 + j
  const double* tau_ij =
      tau == nullptr ? nullptr : tau + (size_t)blockIdx.x * nab;
  double d = 0.0, e = 0.0;
  for (int ab = threadIdx.x; ab < nab; ab += blockDim.x) {
    const int a = ab / nv2, b = ab % nv2;
    const double g = g_i[a * row + b];
    double xd;
    if (tau_ij == nullptr) {
      xd = g / (eia1[i * nv1 + a] + eia2[j * nv2 + b]);
      if (t2 != nullptr) t2[(size_t)i * nv1 * row + a * row + j * nv2 + b] = xd;
    } else {
      xd = tau_ij[ab];
    }
    d += g * xd;
    if (exchange) {
      double xe;
      if (tau_ij == nullptr)
        xe = g_i[b * row + a] / (eia1[i * nv1 + b] + eia2[j * nv2 + a]);
      else
        xe = tau_ij[b * nv2 + a];
      e += g * xe;
    }
  }
  sd[threadIdx.x] = d;
  sx[threadIdx.x] = e;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      sd[threadIdx.x] += sd[threadIdx.x + s];
      sx[threadIdx.x] += sx[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[2 * (size_t)blockIdx.x] = sd[0];
    partials[2 * (size_t)blockIdx.x + 1] = sx[0];
  }
}

// ovov (no1, nv1, no2, nv2); eia1 (no1, nv1) and eia2 (no2, nv2) (unused
// when tau is given); tau null or (no1, no2, nv1, nv2); t2 null or (no1,
// nv1, no2, nv2) (written only when tau is null); partials
// (no1*no2, 2). threads a power of two <= MP2_MAX_THREADS. Returns
// cudaGetLastError() after the launch, -1 for a thread count out of range
// or an exchange sum with nv1 != nv2.
extern "C" int pt_mp2_energy(int no1, int nv1, int no2, int nv2,
                             const double* ovov, const double* eia1,
                             const double* eia2, const double* tau,
                             int exchange,
                             double* t2, double* partials, int threads,
                             void* s) {
  if (threads < 1 || threads > MP2_MAX_THREADS ||
      (threads & (threads - 1)) != 0)
    return -1;
  if (exchange && nv1 != nv2) return -1;
  const int blocks = no1 * no2;
  if (blocks == 0) return 0;
  cudaStream_t stream = (cudaStream_t)s;
  mp2_energy_kernel<MP2_MAX_THREADS><<<blocks, threads, 0, stream>>>(
      no1, nv1, no2, nv2, ovov, eia1, eia2, tau, exchange, t2, partials);
  return (int)cudaGetLastError();
}
