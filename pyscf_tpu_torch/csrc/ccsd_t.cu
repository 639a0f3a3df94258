// The closed-shell (T) energy of CCSD(T) over a list of virtual triples
// a >= b >= c.
//
// Replaces pyscf_tpu/cc/ccsd_t.py:_et_all (with :24 _et_batch and :18 _r3);
// plain PyTorch twin: pyscf_tpu_torch/cc/ccsd_t.py:et_plain. For a triple
// (a, b, c) with multiplicity m (6 for a = b = c, 2 for one pair equal, 1
// otherwise) and sigma = (x, y, z) one of the six orderings of (a, b, c),
//   w_sigma[i,j,k] = sum_f vvov[x,y,i,f] t2[k,j,z,f]
//                    - sum_m vooo[x,i,j,m] t2T[y,z,m,k],
//   v_sigma[i,j,k] = ovov[i,x,j,y] t1[k,z],
//   Z_sigma = r3(w_sigma + v_sigma / 2) / d3,
//   d3[i,j,k] = (e_i + e_j + e_k - e_a - e_b - e_c) max(m, 1/2),
// and the triple's energy is the 36 pairings of the JAX package,
//   sum_sigma sum_g sum_ijk w_{sigma o g}[g(i,j,k)] Z_sigma[i,j,k],
// g running over the six permutations. The wrapper doubles the sum.
//
// Design: the six w and six Z of one triple are 12 o^3 tensors (890 KB at
// benzene's nocc 21), far beyond a block's 227 KB of shared memory. Every
// term above reads w, v and Z of one triple only at the six permutations
// of one unordered occupied triple {i, j, k} (r3 and the 36 pairings
// permute (i, j, k); d3 is symmetric in them). So one thread takes one
// unordered occupied triple i >= j >= k (an "orbit") and holds its 36 w
// values (six sigma by six positions) and 36 u = w + v/2 in registers:
// nothing is recomputed, nothing is staged in device memory, and no tile
// crosses threads. An orbit with two equal indices visits each ordered
// triple twice among its six positions (i = j = k six times), so its sum
// is divided by 2 (6). One block per virtual triple: its 256 threads
// stride over the o(o+1)(o+2)/6 orbits (1771 at benzene) in rounds of
// blockDim.x, after staging the six vvov[x,y] slices (o x v each) and the
// six t2T[y,z] slices (o x o) that every orbit reads in shared memory (115
// KB at benzene). Where the six vvov slices do not fit beside the t2T
// slices, the wrapper gives an f tile ft < v: the slices are staged ft
// values of f at a time, once per tile and round, and the partial w sums
// accumulate in the registers across tiles (naphthalene/def2-SVP, o 34 and
// v 180, takes ft 107); only where the t2T slices alone leave no room (o
// above 68) does the wrapper raise. The t2 rows t2[k,j,z,:] and vooo rows
// vooo[x,i,j,:] are read from device memory (L2) with f and m contiguous,
// each row serving the two orderings that share it.
//
// What bounds it on the card: the w builds, 2 o^3 (v + o) FMAs per
// ordering and triple, 1.75e12 FP64 operations at benzene: 26 ms at the
// 67 TFLOP/s of the FP64 tensor cores (DMMA), which can run these small
// matrix products. This simple kernel does them on the FP64 pipes outside
// the tensor cores, with two loads (one shared, one L1/L2) per two FMAs,
// so it is bound by the loads, well above that; tiling the orbits across a
// warp and DMMA are later work.
// Each block writes its triple's sum; the wrapper adds them in a fixed
// order, so there are no atomics and every run gives the same sum. The
// staging loops stride by the block size, so the host build of the tests
// runs it with one thread per block.
#include <cuda_runtime.h>

#ifndef PT_DYNAMIC_SMEM
#define PT_DYNAMIC_SMEM(name) extern __shared__ double name[]
#endif

constexpr int CCSD_T_MAX_THREADS = 256;
// shared memory a block can have on sm_90, static and dynamic together
constexpr long CCSD_T_SMEM_PER_BLOCK = 232448;

// Tables as constexpr functions of their indices, so that in the unrolled
// loops every index folds to a constant and w and u stay in registers.
// perm(s, k): the six permutations in the JAX package's order
// (ccsd_t.py:42)
__host__ __device__ constexpr int perm(int s, int k) {
  return "012021102120201210"[3 * s + k] - '0';
}
// comp(s, g): the index of perm(s) composed with perm(g)
__host__ __device__ constexpr int comp(int s, int g) {
  return "012345104523230154325401451032543210"[6 * s + g] - '0';
}
// r3 (ccsd_t.py:18) as the coefficient of the position permuted by g
__host__ __device__ constexpr double r3(int g) {
  return g == 0 ? 4.0 : (g == 3 || g == 4 ? 1.0 : -2.0);
}
// the orderings that share z (so a t2 row): (0, 2), (1, 4), (3, 5); those
// that share x (a vooo row) are (0, 1), (2, 3), (4, 5)
__host__ __device__ constexpr int zpair(int p, int k) {
  return "021435"[2 * p + k] - '0';
}

template <int MAXT>
__global__ void __launch_bounds__(MAXT) ccsd_t_kernel(
    int no, int nv, int ft, const int* __restrict__ abc,
    const double* __restrict__ mult, int norb, const int* __restrict__ ijk,
    const double* __restrict__ vvov, const double* __restrict__ vooo,
    const double* __restrict__ t2, const double* __restrict__ t2T,
    const double* __restrict__ ovov, const double* __restrict__ t1,
    const double* __restrict__ eo, const double* __restrict__ ev,
    double* __restrict__ partials) {
  PT_DYNAMIC_SMEM(smem);
  __shared__ double red[MAXT];
  const int noo = no * no;
  double* A = smem;             // [s][p][f - f0] = vvov[x_s, y_s, p, f]
  double* T = smem + 6 * no * ft;   // [s][m][r] = t2T[y_s, z_s, m, r]
  const int tri = blockIdx.x;
  const int V[3] = {abc[3 * tri], abc[3 * tri + 1], abc[3 * tri + 2]};
  const bool tiled = ft < nv;
  // stage the vvov slices' f in [f0, f0 + nf) at stride ft
  auto stage = [&](int f0, int nf) {
    for (int idx = threadIdx.x; idx < 6 * no * nf; idx += blockDim.x) {
      const int s = idx / (no * nf), p = idx / nf % no, f = idx % nf;
      A[(s * no + p) * ft + f] =
          vvov[(((size_t)V[perm(s, 0)] * nv + V[perm(s, 1)]) * no + p) * nv
               + f0 + f];
    }
  };
  if (!tiled) stage(0, nv);
  for (int idx = threadIdx.x; idx < 6 * noo; idx += blockDim.x) {
    const int s = idx / noo;
    T[idx] = t2T[((size_t)V[perm(s, 1)] * nv + V[perm(s, 2)]) * noo +
                 idx % noo];
  }
  __syncthreads();
  const double m = mult[tri];
  const double scale = m > 0.5 ? m : 0.5;
  const double evs = ev[V[0]] + ev[V[1]] + ev[V[2]];
  double et = 0.0;
  // rounds of blockDim.x orbits; every thread runs every round (and its
  // barriers), those past norb idle in the last
  for (int orb0 = 0; orb0 < norb; orb0 += blockDim.x) {
    const int orb = orb0 + threadIdx.x;
    const bool live = orb < norb;
    const int O[3] = {live ? ijk[3 * orb] : 0, live ? ijk[3 * orb + 1] : 0,
                      live ? ijk[3 * orb + 2] : 0};
    double w[6][6], u[6][6];
#pragma unroll
    for (int s = 0; s < 6; ++s)
#pragma unroll
      for (int t = 0; t < 6; ++t) w[s][t] = 0.0;
    for (int f0 = 0; f0 < nv; f0 += ft) {
      const int nf = nv - f0 < ft ? nv - f0 : ft;
      if (tiled) {
        __syncthreads();
        stage(f0, nf);
        __syncthreads();
      }
      if (!live) continue;
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const int p = O[perm(t, 0)], q = O[perm(t, 1)], r = O[perm(t, 2)];
#pragma unroll
        for (int zp = 0; zp < 3; ++zp) {
          const int s1 = zpair(zp, 0), s2 = zpair(zp, 1);
          const double* row =
              t2 + (((size_t)r * no + q) * nv + V[perm(s1, 2)]) * nv + f0;
          const double* A1 = A + (s1 * no + p) * ft;
          const double* A2 = A + (s2 * no + p) * ft;
          double acc1 = 0.0, acc2 = 0.0;
          for (int f = 0; f < nf; ++f) {
            const double tv = row[f];
            acc1 += A1[f] * tv;
            acc2 += A2[f] * tv;
          }
          w[s1][t] += acc1;
          w[s2][t] += acc2;
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      const int p = O[perm(t, 0)], q = O[perm(t, 1)], r = O[perm(t, 2)];
#pragma unroll
      for (int xp = 0; xp < 3; ++xp) {
        const int s1 = 2 * xp, s2 = 2 * xp + 1;
        const double* row =
            vooo + (((size_t)V[perm(s1, 0)] * no + p) * no + q) * no;
        const double* T1 = T + s1 * noo + r;
        const double* T2 = T + s2 * noo + r;
        double acc1 = 0.0, acc2 = 0.0;
        for (int mm = 0; mm < no; ++mm) {
          const double vv = row[mm];
          acc1 += vv * T1[mm * no];
          acc2 += vv * T2[mm * no];
        }
        w[s1][t] -= acc1;
        w[s2][t] -= acc2;
      }
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const int x = V[perm(s, 0)], y = V[perm(s, 1)], z = V[perm(s, 2)];
        u[s][t] = w[s][t] + 0.5 * (ovov[(((size_t)p * nv + x) * no + q) * nv
                                        + y] * t1[r * nv + z]);
      }
    }
    double e = 0.0;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        double zv = 0.0, yv = 0.0;
#pragma unroll
        for (int g = 0; g < 6; ++g) {
          zv += r3(g) * u[s][comp(t, g)];
          yv += w[comp(s, g)][comp(t, g)];
        }
        e += zv * yv;
      }
    }
    const double d3 = (eo[O[0]] + eo[O[1]] + eo[O[2]] - evs) * scale;
    const double occ_mult =
        O[0] == O[2] ? 6.0 : (O[0] == O[1] || O[1] == O[2] ? 2.0 : 1.0);
    et += e / (d3 * occ_mult);
  }
  red[threadIdx.x] = et;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[tri] = m > 0.0 ? red[0] : 0.0;
}

// The dynamic shared memory a block of ccsd_t needs at f tile ft, in bytes.
extern "C" long pt_ccsd_t_smem(int no, int ft) {
  return 8L * 6 * ((long)no * ft + (long)no * no);
}

// abc (n, 3) int32 virtual triples, mult (n,); ijk (norb, 3) int32, the
// occupied triples i >= j >= k; vvov (nv, nv, no, nv), vooo (nv, no, no,
// no), t2 (no, no, nv, nv), t2T (nv, nv, no, no), ovov (no, nv, no, nv),
// t1 (no, nv), eo (no,), ev (nv,); partials (n,), one sum per triple. ft
// in [1, nv], the f tile of the staged vvov slices (nv: staged once).
// threads a power of two <= CCSD_T_MAX_THREADS. Returns
// cudaGetLastError() after the launch, -1 for a thread count or tile out
// of range or more shared memory than a block can have.
extern "C" int pt_ccsd_t(int no, int nv, int ft, int n, const int* abc,
                         const double* mult, int norb, const int* ijk,
                         const double* vvov, const double* vooo,
                         const double* t2, const double* t2T,
                         const double* ovov, const double* t1,
                         const double* eo, const double* ev,
                         double* partials, int threads, void* s) {
  if (threads < 1 || threads > CCSD_T_MAX_THREADS ||
      (threads & (threads - 1)) != 0 || ft < 1 || ft > nv)
    return -1;
  const long smem = pt_ccsd_t_smem(no, ft);
  if (smem + 8L * CCSD_T_MAX_THREADS > CCSD_T_SMEM_PER_BLOCK) return -1;
  if (n == 0) return 0;
  const int blocks = n;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        ccsd_t_kernel<CCSD_T_MAX_THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  cudaStream_t stream = (cudaStream_t)s;
  ccsd_t_kernel<CCSD_T_MAX_THREADS><<<blocks, threads, smem, stream>>>(
      no, nv, ft, abc, mult, norb, ijk, vvov, vooo, t2, t2T, ovov, t1, eo,
      ev, partials);
  return (int)cudaGetLastError();
}
