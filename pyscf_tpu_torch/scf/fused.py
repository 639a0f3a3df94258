"""The SCF cycles: DIIS extrapolation, eigh, new orbitals.

Counterpart of pyscf_tpu/scf/fused.py: _diis_extrapolate, the three
programs of build_restricted_cycle (seed, cycle, finalize) and the body of
build_unrestricted_program (seed_u, cycle_u, finalize_u), as plain torch
functions that one host loop in scf/hf.py drives. Only the float64 stage
is ported: the JAX package's float32 pre-stage made up for emulated
float64 on the TPU.
"""
import torch

from ..lib.linalg import align_degenerate, eigh, eigh_gen


def _diis_extrapolate(fh, eh, nval, newest):
    """DIIS solve over a (space, n, n) ring buffer with nval valid slots.

    Minimizes |sum_i c_i err_i| s.t. sum c_i = 1 (Pulay) through the
    bordered system [[G, -1/s], [-1/s^T, 0]] [d; l] = [0; -1] on the
    norm-scaled G, with c_i = d_i / s_i, solved by an eigh pseudo-inverse
    with a 1e-10 relative cutoff. Slots whose error norm dwarfs the
    current best by 1e8 are dropped. Falls back to the newest Fock when
    the coefficients are huge.

    This is the form of the JAX package before its c ~ G^-1 1 rewrite
    (pyscf_tpu/scf/fused.py:21-70): when the error vectors are linearly
    dependent, as for He, whose only occupied-virtual rotation is 1s-2s,
    G is singular, the pseudo-inverse of G drops the very direction that
    zeroes the error, and the SCF diverges. The bordered system keeps
    that solution."""
    space = fh.shape[0]
    dt, dev = fh.dtype, fh.device
    ef = eh.reshape(space, -1)
    G = ef @ ef.T
    valid = torch.arange(space, device=dev) < nval
    norms2 = torch.diagonal(G)
    inf = torch.full_like(norms2, float('inf'))
    best = torch.min(torch.where(valid, norms2, inf))
    valid = valid & (norms2 < 1e8 * torch.clamp(best, min=1e-300))
    vv = valid[:, None] & valid[None, :]
    eye = torch.eye(space, dtype=dt, device=dev)
    G = torch.where(vv, G, eye)
    scale = torch.sqrt(torch.clamp(torch.diagonal(G),
                                   min=torch.finfo(dt).tiny))
    scale = torch.where(valid, scale, torch.ones_like(scale))
    G = G / (scale[:, None] * scale[None, :])
    H = torch.zeros((space + 1, space + 1), dtype=dt, device=dev)
    H[:space, :space] = G
    cvec = torch.where(valid, -1.0 / scale, torch.zeros_like(scale))
    H[:space, space] = cvec
    H[space, :space] = cvec
    rhs = torch.zeros(space + 1, dtype=dt, device=dev)
    rhs[space] = -1.0
    w, v = eigh(H)
    winv = torch.where(torch.abs(w) > 1e-10 * torch.max(torch.abs(w)),
                       1.0 / w, torch.zeros_like(w))
    c = (v @ (winv * (v.T @ rhs)))[:space]
    c = torch.where(valid, c / scale, torch.zeros_like(c))
    bad = torch.max(torch.abs(c)) > 20.0
    c_safe = torch.zeros(space, dtype=dt, device=dev)
    c_safe[newest] = 1.0
    c = torch.where(bad, c_safe, c)
    return torch.tensordot(c, fh, dims=([0], [0]))


def seed(veff_dm_fn, h1e, x, dm0, nocc):
    """Occupied factor (scaled by sqrt(2)) from diagonalizing F(guess dm)."""
    vhf0, _ = veff_dm_fn(dm0)
    _, moc0 = eigh_gen(h1e + vhf0, x)
    return moc0[:, :nocc] * 2.0 ** 0.5


def cycle(veff_fn, h1e, s1e, x, co, fh, eh, cyc, nocc):
    """One SCF cycle; fills DIIS slot cyc % space of fh/eh in place.

    Returns (new occupied factor, e_elec, |x^T err x|) as tensors."""
    dm = co @ co.T
    vhf, e2 = veff_fn(dm, co)
    f = h1e + vhf
    e_elec = torch.sum(h1e * dm) + e2
    sdf = s1e @ dm @ f
    err = sdf.T - sdf
    space = fh.shape[0]
    idx = cyc % space
    fh[idx] = f
    eh[idx] = err
    f_d = _diis_extrapolate(fh, eh, min(cyc + 1, space), idx)
    _, moc = eigh_gen(f_d, x)
    co_n = moc[:, :nocc] * 2.0 ** 0.5
    gnorm = torch.linalg.norm(x.T @ err @ x)
    return co_n, e_elec, gnorm


def finalize(veff_fn, h1e, x, co, nocc):
    """Canonical orbitals of the true converged Fock + final energy."""
    dm = co @ co.T
    vhf, _ = veff_fn(dm, co)
    moe, moc = eigh_gen(h1e + vhf, x)
    co2 = moc[:, :nocc] * 2.0 ** 0.5
    dm2 = co2 @ co2.T
    vhf2, e22 = veff_fn(dm2, co2)
    e_elec = torch.sum(h1e * dm2) + e22
    return e_elec, moe, moc, dm2


# ---- unrestricted (UHF/UKS) -------------------------------------------------
# veff_fn(dm (2, n, n), cos) -> (vhf (2, n, n), e2) with cos = (coa, cob),
# the occupied factors (occupation 1, dm_s = co_s co_s^T), or None.

def seed_u(veff_dm_fn, h1e, x, dm0, na, nb):
    """Occupied factors from diagonalizing F of the untruncated guess dm0
    (2, n, n): no guess information is lost to a rank-na/nb factorization
    (pyscf_tpu/scf/fused.py:298-304)."""
    vhf0, _ = veff_dm_fn(dm0)
    return tuple(_occupied(h1e + vhf0[s], x, n) for s, n in ((0, na),
                                                             (1, nb)))


def _occupied(f, x, n):
    """The n lowest orbitals of F, a degenerate cluster that n splits
    aligned by lib/linalg.py align_degenerate."""
    e, c = eigh_gen(f, x)
    return align_degenerate(e, c, n)[:, :n]


def _fock_u(veff_fn, h1e, s1e, cos):
    """(Fock (2, n, n), e_elec, DIIS error S D F - F D S (2, n, n), dm)."""
    coa, cob = cos
    dm = torch.stack([coa @ coa.T, cob @ cob.T])
    vhf, e2 = veff_fn(dm, cos)
    f = h1e + vhf
    e_elec = torch.sum(h1e * (dm[0] + dm[1])) + e2
    sdf = s1e @ dm @ f
    return f, e_elec, sdf.transpose(1, 2) - sdf, dm


def cycle_u(veff_fn, h1e, s1e, x, cos, fh, eh, cyc, na, nb):
    """One unrestricted cycle; fills slot cyc % space of the stacked
    (space, 2, n, n) buffers fh/eh in place, one DIIS over both spins.

    Returns (new occupied factors, e_elec, |g|) with
    |g| = sqrt(|x^T err_a x|^2 + |x^T err_b x|^2)."""
    f, e_elec, err, _ = _fock_u(veff_fn, h1e, s1e, cos)
    space = fh.shape[0]
    idx = cyc % space
    fh[idx] = f
    eh[idx] = err
    f_d = _diis_extrapolate(fh, eh, min(cyc + 1, space), idx)
    gnorm = torch.sqrt(torch.linalg.norm(x.T @ err[0] @ x) ** 2
                       + torch.linalg.norm(x.T @ err[1] @ x) ** 2)
    return (_occupied(f_d[0], x, na), _occupied(f_d[1], x, nb)), e_elec, gnorm


def finalize_u(veff_fn, h1e, s1e, x, cos, na, nb):
    """Canonical orbitals of the true converged Fock, then the energy of
    their density (pyscf_tpu/scf/fused.py:330-340). Returns (e_elec,
    mo_energy (2, n), mo_coeff (2, n, n), dm (2, n, n))."""
    f, _, _, _ = _fock_u(veff_fn, h1e, s1e, cos)
    ea, ca = eigh_gen(f[0], x)
    eb, cb = eigh_gen(f[1], x)
    _, e_elec, _, dm = _fock_u(veff_fn, h1e, s1e, (ca[:, :na], cb[:, :nb]))
    return e_elec, torch.stack([ea, eb]), torch.stack([ca, cb]), dm
