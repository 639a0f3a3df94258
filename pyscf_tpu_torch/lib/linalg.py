"""Symmetric eigensolver, canonical orthogonalization, generalized eigh.

Counterpart of pyscf_tpu/lib/linalg.py (eigh, canonical_orth, eigh_gen)
on torch.linalg.eigh (LAPACK on the CPU, cuSOLVER on the card).

The JAX package refines every f64 eigh with Ogita-Aishima steps because
jax 0.9's eigh left residuals ||AV - VW|| near 1e-6 at n=580. That
refinement is ported behind the same `refine` argument. EIGH_REFINE is
the number of steps the SCF uses: 0, because torch.linalg.eigh's residual
is at rounding level on both devices (LAPACK on the CPU; on the H100,
chip_smoke.py prints the measured max residual at n=114).
"""
import torch

EIGH_REFINE = 0


def eigh(a, refine=EIGH_REFINE):
    """Symmetric eigendecomposition with `refine` Ogita-Aishima steps.

    Each step squares the error using only matmuls:
        R = I - V^T V,  S = V^T A V,  w~ = diag(S)
        E_ij = (S_ij + w~_j R_ij) / (w~_j - w~_i)   (well-separated pairs)
        E_ij = R_ij / 2                              (near-degenerate)
        V <- V + V E
    Near-degenerate clusters keep only the orthonormalization part.
    """
    w, v = torch.linalg.eigh(a)
    if refine == 0:
        return w, v
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    floors = [1e-5] + [1e-7] * max(0, refine - 1)
    for floor in floors[:refine]:
        S = v.T @ (a @ v)
        R = eye - v.T @ v
        wt = torch.diagonal(S)
        den = wt[None, :] - wt[:, None]
        num = S + wt[None, :] * R
        E_cand = num / torch.where(den == 0.0, torch.ones_like(den), den)
        scale = torch.clamp(torch.max(torch.abs(wt)), min=1.0)
        safe = (torch.abs(E_cand) < 0.05) & (torch.abs(den) > floor * scale)
        safe = safe & safe.T
        E = torch.where(safe, E_cand, R / 2.0)
        E = E - torch.diag(torch.diagonal(E)) + torch.diag(torch.diagonal(R) / 2.0)
        v = v + v @ E
        w = torch.diagonal(v.T @ (a @ v)) / torch.diagonal(v.T @ v)
    order = torch.argsort(w)
    return w[order], v[:, order]


def canonical_orth(s, thresh=1e-8):
    """X with X^T S X = I; near-singular directions become zero columns."""
    w, v = eigh(s)
    keep = w > thresh
    winv = torch.where(keep, 1.0 / torch.sqrt(torch.where(
        keep, w, torch.ones_like(w))), torch.zeros_like(w))
    return v * winv[None, :]


def eigh_gen(f, x, refine=EIGH_REFINE):
    """Solve F C = S C e given X = S^{-1/2}: returns (e, C)."""
    e, cp = eigh(x.T @ f @ x, refine)
    return e, x @ cp
