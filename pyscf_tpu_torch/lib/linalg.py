"""Symmetric eigensolver, canonical orthogonalization, generalized eigh
and the Davidson solver.

Counterpart of pyscf_tpu/lib/linalg.py (eigh, canonical_orth, eigh_gen,
davidson) on torch.linalg.eigh (LAPACK on the CPU, cuSOLVER on the card).

The JAX package refines every f64 eigh with Ogita-Aishima steps because
jax 0.9's eigh left residuals ||AV - VW|| near 1e-6 at n=580. That
refinement is ported behind the same `refine` argument. EIGH_REFINE is
the number of steps the SCF uses: 0, because torch.linalg.eigh's residual
is at rounding level on both devices (LAPACK on the CPU; on the H100,
chip_smoke.py prints the measured max residual at n=114).
"""
import numpy as np
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


def align_degenerate(e, c, n, tol=1e-8):
    """Fix the rotation of a degenerate cluster that the occupation
    boundary n splits (e[n-1] and e[n] within tol): eigh leaves any
    rotation of the cluster's vectors, and a partly occupied one (the OH
    radical's beta pi pair in its guess) would start the SCF from an
    arbitrary orientation of the hole. The cluster's columns of c are
    rotated so that on the AO rows of largest weight (picked greedily,
    the lowest index among ties) they are lower triangular with a
    positive diagonal: each vector is aligned with the AOs where the
    Fock matrix's symmetry puts it. Returns c, changed only there."""
    if n <= 0 or n >= e.shape[0]:
        return c
    lo, hi = e[n - 1:n + 1].tolist()
    if hi - lo > tol * max(1.0, abs(hi)):
        return c
    ev = e.tolist()
    i0, i1 = n - 1, n + 1
    while i0 > 0 and ev[i0] - ev[i0 - 1] <= tol * max(1.0, abs(ev[i0])):
        i0 -= 1
    while i1 < len(ev) and ev[i1] - ev[i1 - 1] <= tol * max(1.0, abs(ev[i1])):
        i1 += 1
    blk = c[:, i0:i1].cpu().numpy()
    res, piv = blk.copy(), []
    for _ in range(i1 - i0):
        norms = np.linalg.norm(res, axis=1)
        j = int(np.flatnonzero(norms >= norms.max() * (1 - 1e-10))[0])
        piv.append(j)
        u = res[j] / norms[j]
        res -= np.outer(res @ u, u)
    q, r = np.linalg.qr(blk[piv].T)
    q = q * np.sign(np.diagonal(r))[None, :]
    out = c.clone()
    out[:, i0:i1] = torch.as_tensor(blk @ q, dtype=c.dtype, device=c.device)
    return out


def davidson(matvec, x0, neig=1, max_cycle=60, tol=1e-10, max_space=14,
             hdiag=None):
    """Davidson eigensolver for the lowest eigenpairs of a symmetric
    operator: (evals (neig,) numpy, evecs (neig, n) tensor, converged).

    The JAX package's solver (pyscf_tpu/lib/linalg.py:89-166): the same
    subspace, restart with the Ritz vectors and guard roots, diagonal
    preconditioner and convergence test. The vectors stay on x0's device;
    the subspace matrix goes to the host for its eigh, as DIIS's does.
    matvec takes a batch (k, n) and returns A applied to each row (k, n):
    the new vectors of an iteration go in one call, which gives the
    product of one vector at a time of the JAX package's matvec."""
    x0 = x0[None] if x0.dim() == 1 else x0
    max_space = max(max_space, 3 * (neig + 2))
    hd = None if hdiag is None else torch.as_tensor(hdiag, device=x0.device)
    V = [v / torch.linalg.norm(v) for v in x0]
    AV = []
    theta_old = None
    conv = False
    evals = evecs = None
    for _ in range(max_cycle):
        if len(AV) < len(V):
            AV.extend(matvec(torch.stack(V[len(AV):])))
        Vm = torch.stack(V)
        AVm = torch.stack(AV)
        H = (Vm @ AVm.T).cpu().numpy()
        theta, S = np.linalg.eigh(0.5 * (H + H.T))
        # guard roots beyond the requested ones, so that a restart keeps
        # low-spectrum components the Ritz set has not resolved yet
        nroot = min(neig + 2, len(theta))
        theta = theta[:nroot]
        St = torch.as_tensor(S[:, :nroot].T.copy(), device=Vm.device)
        X = St @ Vm
        R = St @ AVm - torch.as_tensor(theta, device=Vm.device)[:, None] * X
        rnorm = torch.linalg.norm(R, dim=1).cpu().numpy()
        evals, evecs = theta[:neig], X[:neig]
        if np.all(rnorm[:neig] < tol) or (
                theta_old is not None
                and np.all(np.abs(theta[:neig] - theta_old) < tol * 1e-2)
                and np.all(rnorm[:neig] < np.sqrt(tol))):
            conv = True
            break
        theta_old = theta[:neig]
        if len(V) + nroot > max_space:
            V = [X[i] / torch.linalg.norm(X[i]) for i in range(nroot)]
            AV = []
            continue
        for i in range(nroot):
            if rnorm[i] < tol:
                continue
            t = R[i]
            if hd is not None:
                denom = hd - float(theta[i])
                denom = torch.where(denom.abs() < 1e-8,
                                    torch.sign(denom + 1e-30) * 1e-8, denom)
                t = t / denom
            # modified Gram-Schmidt against the subspace
            for v in V:
                t = t - (v @ t) * v
            nrm = float(torch.linalg.norm(t))
            if nrm > 1e-7:
                V.append(t / nrm)
    return evals, evecs, conv
