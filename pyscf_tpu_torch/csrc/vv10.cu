// VV10 non-local correlation: the double sum over grid-point pairs and its
// derivatives in rho and |grad rho|^2 at every point.
//
// Replaces pyscf_tpu/dft/vv10.py:_vv10_energy_features and its
// jax.value_and_grad (_vv10_grad, vv10.py:68); plain PyTorch twin:
// pyscf_tpu_torch/dft/vv10.py:vv10_plain. With the JAX package's mask
// (rho > RHO_CUT) and features
//   E = sum_i wr_i [beta + 1/2 sum_j wr_j Phi_ij],  wr = w rho,
//   Phi_ij = -3/2 / (g_i g_j (g_i + g_j)),  g_i = omega0_i R_ij^2 + kappa_i,
//   omega0 = sqrt(C s2^2 + (4 pi/3) rho),  s2 = |grad rho|^2 / rho^2,
//   kappa = b (3 pi/2) (rho/(9 pi))^(1/6),  beta = (1/32) (3/b^2)^(3/4),
// the derivatives are the closed-form sums of PySCF's _vv10nlc:
//   U_i = sum_j wr_j Phi_ij,  W_i = sum_j wr_j dPhi_ij/dg_i,
//   V_i = sum_j wr_j dPhi_ij/dg_i R_ij^2,
//   dE/drho_i = w_i (beta + U_i) + wr_i (W_i dkappa_i/drho_i
//               + V_i domega0_i/drho_i),
//   dE/dg2_i  = wr_i V_i domega0_i/dg2_i,
// which is what jax.grad takes of the energy. With t = 1/(g_i g_j s),
// s = g_i + g_j, one reciprocal gives both Phi = -3/2 t and
// dPhi/dg_i = 3/2 t^2 g_j (s + g_i).
//
// A plain N-body design, not the JAX package's (2048 x ng) tiles: one thread
// per point i keeps U, W and V in registers while the block stages the j
// points tile by tile in shared memory (x, y, z, omega0, kappa, wr), each
// thread computing the features of the j it stages. A masked point keeps
// the JAX package's placeholders (rho 1, g2 0, w 0), so it adds exactly
// zero as a j, and its thread skips the pair loop and writes zeros. The
// energy is written per point, [wr_i (beta + 1/2 U_i)], and summed after
// the launch: no atomics, the same sum every run. What bounds it on the card
// is FP64 arithmetic: about 25 operations with one reciprocal per pair,
// against 48 bytes read and 24 written per point. The simple design is
// right first; register tiling of j and a cheaper reciprocal are later work.
//
// out (3, n): [energy per point, dE/drho, dE/dg2].
#include <cuda_runtime.h>

constexpr double RHO_CUT = 1e-8;   // pyscf_tpu/dft/vv10.py:20
constexpr int VV10_TILE = 128;     // j points staged per tile

struct VV10Point {
  double omega0, kappa, wr;
};

// The features of one point as the JAX package computes them (masked
// points: rho 1, g2 0, w 0).
__host__ __device__ __forceinline__ VV10Point vv10_point(double rho,
                                                        double g2, double w,
                                                        double b, double C,
                                                        bool& mask) {
  mask = rho > RHO_CUT;
  const double rho_s = mask ? rho : 1.0;
  const double g2_s = mask ? g2 : 0.0;
  const double s2 = g2_s / (rho_s * rho_s);
  VV10Point p;
  // (4 pi / 3), b (3 pi / 2), 9 pi
  p.omega0 = sqrt(C * s2 * s2 + 4.1887902047863905 * rho_s);
  p.kappa = b * 4.71238898038469 * pow(rho_s / 28.274333882308138,
                                       1.0 / 6.0);
  p.wr = (mask ? w : 0.0) * rho_s;
  return p;
}

template <int TILE>
__global__ void __launch_bounds__(TILE) vv10_kernel(
    int n, const double* __restrict__ coords, const double* __restrict__ rho,
    const double* __restrict__ g2, const double* __restrict__ weights,
    double b, double C, double* __restrict__ out) {
  __shared__ double sx[TILE], sy[TILE], sz[TILE];
  __shared__ double so[TILE], sk[TILE], sw[TILE];
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool mi = false;
  double xi = 0.0, yi = 0.0, zi = 0.0;
  VV10Point p_i{1.0, 1.0, 0.0};
  if (i < n) {
    p_i = vv10_point(rho[i], g2[i], weights[i], b, C, mi);
    xi = coords[3 * i];
    yi = coords[3 * i + 1];
    zi = coords[3 * i + 2];
  }
  double U = 0.0, W = 0.0, V = 0.0;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    for (int jj = threadIdx.x; jj < TILE; jj += blockDim.x) {
      const int j = j0 + jj;
      VV10Point pj{1.0, 1.0, 0.0};
      double x = 0.0, y = 0.0, z = 0.0;
      if (j < n) {
        bool mask;
        pj = vv10_point(rho[j], g2[j], weights[j], b, C, mask);
        x = coords[3 * (size_t)j];
        y = coords[3 * (size_t)j + 1];
        z = coords[3 * (size_t)j + 2];
      }
      sx[jj] = x;
      sy[jj] = y;
      sz[jj] = z;
      so[jj] = pj.omega0;
      sk[jj] = pj.kappa;
      sw[jj] = pj.wr;
    }
    __syncthreads();
    if (mi) {
      const int nt = n - j0 < TILE ? n - j0 : TILE;
#pragma unroll 4
      for (int jj = 0; jj < nt; ++jj) {
        const double dx = xi - sx[jj], dy = yi - sy[jj], dz = zi - sz[jj];
        const double r2 = dx * dx + dy * dy + dz * dz;
        const double gi = p_i.omega0 * r2 + p_i.kappa;
        const double gj = so[jj] * r2 + sk[jj];
        const double s = gi + gj;
        const double t = 1.0 / (gi * gj * s);
        const double wt = sw[jj] * t;
        const double d = wt * t * gj * (s + gi);
        U += wt;
        W += d;
        V += d * r2;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    double e = 0.0, vr = 0.0, vg = 0.0;
    if (mi) {
      const double r = rho[i];
      const double s2 = g2[i] / (r * r);
      const double beta = 0.03125 * pow(3.0 / (b * b), 0.75);
      const double u = -1.5 * U, wsum = 1.5 * W, vsum = 1.5 * V;
      // d omega0 / d rho, d omega0 / d g2 and d kappa / d rho
      const double dodr =
          (4.1887902047863905 - 4.0 * C * s2 * s2 / r) / (2.0 * p_i.omega0);
      const double dodg = C * s2 / (r * r * p_i.omega0);
      const double dkdr = p_i.kappa / (6.0 * r);
      e = p_i.wr * (beta + 0.5 * u);
      vr = weights[i] * (beta + u) + p_i.wr * (wsum * dkdr + vsum * dodr);
      vg = p_i.wr * vsum * dodg;
    }
    out[i] = e;
    out[n + i] = vr;
    out[2 * (size_t)n + i] = vg;
  }
}

// coords (n, 3), rho, g2 = |grad rho|^2 and weights (n,); b and C the VV10
// parameters; out (3, n); threads per block <= VV10_TILE. Returns
// cudaGetLastError() after the launch, or -1 for a thread count out of
// range.
extern "C" int pt_vv10(int n, const double* coords, const double* rho,
                       const double* g2, const double* weights, double b,
                       double C, double* out, int threads, void* s) {
  if (threads < 1 || threads > VV10_TILE) return -1;
  if (n == 0) return 0;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t stream = (cudaStream_t)s;
  vv10_kernel<VV10_TILE><<<blocks, threads, 0, stream>>>(
      n, coords, rho, g2, weights, b, C, out);
  return (int)cudaGetLastError();
}
