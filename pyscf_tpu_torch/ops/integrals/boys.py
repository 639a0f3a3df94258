"""Boys function F_m(T) = int_0^1 t^{2m} exp(-T t^2) dt, plain PyTorch.

Counterpart of pyscf_tpu/ops/integrals/boys.py:boys, with the same
branches and term count so the two agree to rounding:
  * T < _TCRIT: the series F_m(T) = exp(-T) sum_k (2T)^k (2m-1)!!/(2m+2k+1)!!
    at m = mmax with _NTERMS terms, then downward recursion
    F_{m-1} = (2T F_m + exp(-T)) / (2m-1);
  * T >= _TCRIT: F_0 = sqrt(pi/T)/2 erf(sqrt(T)), then upward recursion
    F_{m+1} = ((2m+1) F_m - exp(-T)) / (2T).
The CUDA kernels evaluate the same scheme per element (csrc/boys.cuh).
"""
import math

import torch

_TCRIT = 18.0
_NTERMS = 72


def boys(mmax, t):
    """F_m(T) for m = 0..mmax: tensor of shape (mmax+1,) + t.shape."""
    tt = torch.clamp(t, min=1e-300)
    ts = torch.clamp(tt, max=_TCRIT)
    ets = torch.exp(-ts)
    term = torch.full_like(ts, 1.0 / (2.0 * mmax + 1.0))
    acc = term
    for k in range(_NTERMS):
        term = term * 2.0 * ts / (2.0 * mmax + 2.0 * k + 3.0)
        acc = acc + term
    f = acc * ets
    fs_down = [f]
    for m in range(mmax, 0, -1):
        f = (2.0 * ts * f + ets) / (2.0 * m - 1.0)
        fs_down.append(f)
    fs_down = torch.stack(fs_down[::-1])

    use_series = t < _TCRIT
    tt_up = torch.where(use_series, torch.full_like(tt, _TCRIT), tt)
    et_up = torch.exp(-tt_up)
    sqt = torch.sqrt(tt_up)
    f = 0.5 * math.sqrt(math.pi) / sqt * torch.special.erf(sqt)
    fs_up = [f]
    for m in range(mmax):
        f = ((2.0 * m + 1.0) * f - et_up) / (2.0 * tt_up)
        fs_up.append(f)
    fs_up = torch.stack(fs_up)
    return torch.where(use_series, fs_down, fs_up)
