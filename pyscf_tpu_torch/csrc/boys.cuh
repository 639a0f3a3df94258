// Boys function F_m(T) = int_0^1 t^{2m} exp(-T t^2) dt, m = 0..M, for one T.
//
// Device counterpart of pyscf_tpu/ops/integrals/boys.py:boys and of the
// plain PyTorch twin pyscf_tpu_torch/ops/integrals/boys.py, with the same
// branches, term count and operation order:
//   T < 18: 72-term series for F_M, then downward recursion
//           F_{m-1} = (2T F_m + exp(-T)) / (2m-1);
//   T >= 18: F_0 = sqrt(pi)/2 / sqrt(T) * erf(sqrt(T)), then upward
//           recursion F_{m+1} = ((2m+1) F_m - exp(-T)) / (2T).
// The series is 72 dependent FP64 multiply-divides per call: in the
// integral kernels it is the largest scalar cost after the R recursion.
#pragma once

#define PT_BOYS_TCRIT 18.0
#define PT_BOYS_NTERMS 72

template <int M>
__device__ __forceinline__ void boys(double t, double* F) {
  const double tt = fmax(t, 1e-300);
  if (t < PT_BOYS_TCRIT) {
    const double ets = exp(-tt);
    double term = 1.0 / (2.0 * M + 1.0);
    double acc = term;
#pragma unroll 1
    for (int k = 0; k < PT_BOYS_NTERMS; ++k) {
      term = term * 2.0 * tt / (2.0 * M + 2.0 * k + 3.0);
      acc = acc + term;
    }
    double f = acc * ets;
    F[M] = f;
#pragma unroll
    for (int m = M; m > 0; --m) {
      f = (2.0 * tt * f + ets) / (2.0 * m - 1.0);
      F[m - 1] = f;
    }
  } else {
    const double et = exp(-tt);
    const double sqt = sqrt(tt);
    double f = 0.5 * 1.7724538509055160273 / sqt * erf(sqt);
    F[0] = f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      f = ((2.0 * m + 1.0) * f - et) / (2.0 * tt);
      F[m + 1] = f;
    }
  }
}
