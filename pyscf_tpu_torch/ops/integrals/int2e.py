"""Shell-pair screening and the Hermite combination table.

Counterpart of the pieces of pyscf_tpu/ops/integrals/int2e.py that the DF
path uses: SCREEN_THRESH, pair_screen_bound and _comb_onehot3. Screening
runs in numpy on the host with the JAX package's exact arithmetic, so both
packages keep exactly the same shell pairs.
"""
from functools import lru_cache

import numpy as np

from .hermite import tuv_components, tuv_index

SCREEN_THRESH = 1e-14


def pair_screen_bound(ga, gb):
    """Overlap-based magnitude bound per shell pair, (nsa, nsb) numpy."""
    ea, eb = ga.exps, gb.exps
    ca, cb = np.abs(ga.coeffs), np.abs(gb.coeffs)
    AB2 = ((ga.coords[:, None, :] - gb.coords[None, :, :]) ** 2).sum(-1)
    p = ea[:, None, :, None] + eb[None, :, None, :]
    mu = ea[:, None, :, None] * eb[None, :, None, :] / p
    return (ca[:, None, :, None] * cb[None, :, None, :]
            * np.exp(-mu * AB2[:, :, None, None])
            * (np.pi / p) ** 1.5).sum(axis=(2, 3))


@lru_cache(maxsize=None)
def _phase(L):
    return np.array([(-1.0) ** sum(c) for c in tuv_components(L)])


@lru_cache(maxsize=None)
def _comb_onehot3(L1, L2):
    """Dense (nt1, nt2, ntuv(L1+L2)) +-1 combination tensor.

    W3[s, t, L] = phase(t) if tuv_s + tuv_t == tuv_L else 0.
    """
    idx12 = tuv_index(L1 + L2)
    t1 = tuv_components(L1)
    t2 = tuv_components(L2)
    phase = _phase(L2)
    W = np.zeros((len(t1), len(t2), len(tuv_components(L1 + L2))))
    for i, c1 in enumerate(t1):
        for j, c2 in enumerate(t2):
            W[i, j, idx12[(c1[0] + c2[0], c1[1] + c2[1], c1[2] + c2[2])]] = \
                phase[j]
    return W
