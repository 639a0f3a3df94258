"""McMurchie-Davidson Hermite expansions, plain PyTorch.

Counterpart of pyscf_tpu/ops/integrals/hermite.py (e1d_dense, e3d,
hermite_R with its _r_step_tables). Conventions are the JAX package's:
E_t^{i,j} expands x_A^i x_B^j exp(-a x_A^2 - b x_B^2) with the
Gaussian-product prefactor folded into E_0^{0,0}; R_tuv(p, PQ) with
R_000^{(n)} = (-2p)^n F_n(p |PQ|^2). The CUDA kernels carry the same
recursions as device functions (csrc/hermite.cuh).
"""
from functools import lru_cache

import numpy as np
import torch

from .boys import boys


def n_cart(l):
    return (l + 1) * (l + 2) // 2


def n_tuv(L):
    return (L + 1) * (L + 2) * (L + 3) // 6


@lru_cache(maxsize=None)
def cart_components(l):
    """(ix, iy, iz) with ix decreasing, then iy decreasing (x,y,z; xx,xy..)."""
    out = []
    for ix in range(l, -1, -1):
        for iy in range(l - ix, -1, -1):
            out.append((ix, iy, l - ix - iy))
    return tuple(out)


@lru_cache(maxsize=None)
def tuv_components(L):
    """Hermite (t,u,v) triples with t+u+v <= L, ordered by total order."""
    out = []
    for n in range(L + 1):
        for t in range(n, -1, -1):
            for u in range(n - t, -1, -1):
                out.append((t, u, n - t - u))
    return tuple(out)


@lru_cache(maxsize=None)
def tuv_index(L):
    return {c: i for i, c in enumerate(tuv_components(L))}


def e1d_dense(la, lb, a, b, ab):
    """1D table E_t^{i,j}: (..., la+1, lb+1, la+lb+1), zero where t > i+j."""
    p = a + b
    mu = a * b / p
    inv2p = 0.5 / p
    qa = -b / p * ab   # (P - A)_x
    qb = a / p * ab    # (P - B)_x
    zero = torch.zeros_like(p * ab)
    E = {(0, 0, 0): torch.exp(-mu * ab * ab) + zero}

    def step(fac, i, j, t):
        """inv2p E[t-1] + fac E[t] + (t+1) E[t+1] of the entry (i, j), the
        terms outside 0 <= t <= i + j (zero) left out: the same sums, in
        the same order, as with them."""
        out = None
        for c, tt in ((inv2p, t - 1), (fac, t), (t + 1, t + 1)):
            if 0 <= tt <= i + j:
                term = c * E[(i, j, tt)]
                out = term if out is None else out + term
        return out

    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            for t in range(i + j + 1):
                E[(i, j, t)] = (step(qa, i - 1, j, t) if j == 0
                                else step(qb, i, j - 1, t))
    L = la + lb
    rows = [E[(i, j, t)] if t <= i + j else zero
            for i in range(la + 1) for j in range(lb + 1)
            for t in range(L + 1)]
    out = torch.stack(rows, dim=-1)
    return out.reshape(out.shape[:-1] + (la + 1, lb + 1, L + 1))


_DEVICE_TABLES = {}


def _on_device(table, key, device):
    """The numpy arrays of table(*key) as tensors on device, made once."""
    k = (table.__name__, key, str(device))
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = tuple(torch.as_tensor(x, device=device)
                                  for x in table(*key))
    return _DEVICE_TABLES[k]


@lru_cache(maxsize=None)
def _e3d_gather_indices(la, lb):
    carts_a = cart_components(la)
    carts_b = cart_components(lb)
    tuvs = tuv_components(la + lb)
    shape = (len(carts_a), len(carts_b), len(tuvs), 3)
    ia = np.zeros(shape, dtype=np.int64)
    jb = np.zeros(shape, dtype=np.int64)
    tt = np.zeros(shape, dtype=np.int64)
    for i, ca in enumerate(carts_a):
        for j, cb in enumerate(carts_b):
            for k, tuv in enumerate(tuvs):
                ia[i, j, k] = ca
                jb[i, j, k] = cb
                tt[i, j, k] = tuv
    return ia, jb, tt


def e3d(la, lb, exps_a, exps_b, ra, rb):
    """(..., ncart(la), ncart(lb), ntuv(la+lb)) Hermite expansion tensor."""
    Ed = [e1d_dense(la, lb, exps_a, exps_b, ra[..., d] - rb[..., d])
          for d in range(3)]
    ia, jb, tt = _on_device(_e3d_gather_indices, (la, lb), exps_a.device)
    return (Ed[0][..., ia[..., 0], jb[..., 0], tt[..., 0]]
            * Ed[1][..., ia[..., 1], jb[..., 1], tt[..., 1]]
            * Ed[2][..., ia[..., 2], jb[..., 2], tt[..., 2]])


@lru_cache(maxsize=None)
def _r_step_tables(L, n):
    """Gather tables for one downward-n step of the R recursion.

    For each entry tuv of T_n (orders <= L-n), with d = first nonzero
    direction:  T_n[tuv] = (c_d-1) T_{n+1}[tuv-2e_d] + X_d T_{n+1}[tuv-e_d].
    """
    prev = tuv_components(L - n - 1)
    nxt = tuv_components(L - n)
    iprev = {c: i for i, c in enumerate(prev)}
    m = len(nxt)
    idx1 = np.zeros(m, dtype=np.int64)
    idx2 = np.zeros(m, dtype=np.int64)
    coef = np.zeros(m)
    dsel = np.zeros(m, dtype=np.int64)
    for j, c in enumerate(nxt):
        if c == (0, 0, 0):
            continue
        d = 0 if c[0] > 0 else (1 if c[1] > 0 else 2)
        dsel[j] = d
        e1 = list(c)
        e1[d] -= 1
        idx1[j] = iprev[tuple(e1)]
        if c[d] >= 2:
            e2 = list(c)
            e2[d] -= 2
            idx2[j] = iprev[tuple(e2)]
            coef[j] = c[d] - 1
    return idx2, coef, idx1, dsel


def hermite_R(L, p, rpq):
    """R_tuv(p, PQ) for t+u+v <= L: p (...,), rpq (..., 3) -> (..., ntuv(L))."""
    t2 = p * torch.sum(rpq * rpq, dim=-1)
    F = boys(L, t2)
    m2p = -2.0 * p
    pw = torch.ones_like(p)
    pows = []
    for n in range(L + 1):
        pows.append(pw)
        if n < L:
            pw = pw * m2p
    T = (pows[L] * F[L])[..., None]
    for n in range(L - 1, -1, -1):
        idx2, coef, idx1, dsel = _on_device(_r_step_tables, (L, n),
                                            p.device)
        Xd = rpq[..., dsel]
        Tn = coef * T[..., idx2] + Xd * T[..., idx1]
        Tn[..., 0] = pows[n] * F[n]
        T = Tn
    return T
