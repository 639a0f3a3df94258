"""Whitened density-fitting factor B (naux, nao, nao) on the device.

Counterpart of pyscf_tpu/ops/integrals/j3c.py. The host metadata
(_BraClass, _grouped_order, _row_maps) is the JAX package's; the device
programs become two CUDA kernels with plain PyTorch twins here:

  int3c2e  (csrc/int3c2e.cu) replaces the integral part of _class_program:
           raw sph rows (ij|P) of the screened shell pairs of one bra class
           against every aux shell, in grouped aux order; twin int3c2e_plain.
  int2c2e  (csrc/int2c2e.cu) replaces _eri_2c_sph inside _j2c_whitener:
           the (P|Q) metric in grouped aux order; twin int2c2e_plain.

Both take omega (the JAX package's rs_omega): the erf(omega r)/r
attenuated, long-range integrals of a range-separated functional's K, by
the substitution rho -> rho theta, pref -> pref sqrt(theta) with
theta = omega^2 / (omega^2 + rho) (pyscf_tpu/ops/integrals/j3c.py:235-238,
:274-277); None or 0 is the full Coulomb operator.

The whitening product rows @ (L^-1)^T, the Cholesky factor and the
triangular inverse are dense linear algebra and go to torch.matmul and
torch.linalg, as XLA ran them as library ops in the JAX package.
"""
import math
import time
from functools import lru_cache

import numpy as np
import torch

from .hermite import e3d, hermite_R, n_tuv, tuv_components
from .int1e import flat_prims, pair_tables, sph
from .int2e import pair_screen_bound, SCREEN_THRESH

# elements of the largest temporary the plain 3c version allocates per chunk
_PLAIN_BUDGET = 1 << 24
# eigenvalues of a metric without a Cholesky factor that the whitener keeps
# (PySCF df/incore.py LINEAR_DEP_THR)
LINEAR_DEP_THR = 1e-9


class _BraClass:
    """Screened shell-pair metadata for one (la, lb) class (host only)."""

    def __init__(self, mol, la, lb, thresh=SCREEN_THRESH):
        ga, gb = mol.shell_groups[la], mol.shell_groups[lb]
        self.la, self.lb = la, lb
        self.ga, self.gb = ga, gb
        bound = pair_screen_bound(ga, gb)
        if la == lb:
            bound = np.triu(bound)
        sel = np.argwhere(bound > thresh)
        self.nsel = sel.shape[0]
        self.sel_a = sel[:, 0]
        self.sel_b = sel[:, 1]
        self.da, self.db = 2 * la + 1, 2 * lb + 1
        self.ns1 = self.da * self.db


def _bra_classes(mol):
    cache = mol._j3c_cache
    if 'bra' not in cache:
        ls = sorted(mol.shell_groups.keys())
        cache['bra'] = {(la, lb): _BraClass(mol, la, lb)
                        for la in ls for lb in ls if lb >= la}
    return cache['bra']


def aux_tables(auxmol):
    """[(l, exps, coeffs, coords)] per aux l, ascending, as device tensors."""
    cache = auxmol._j3c_cache
    if 'aux' not in cache:
        cache['aux'] = [(l,) + auxmol.shell_groups[l].tensors()
                        for l in sorted(auxmol.shell_groups.keys())]
    return cache['aux']


# ---------------------------------------------------------------------------
# plain PyTorch twins of the kernels
# ---------------------------------------------------------------------------

def _pair_sph_tables(la, lb, ea, ca, ra, eb, cb, rb):
    """Sph-folded Hermite tables of the primitive pairs of n shell pairs:
    p (n*Ka*Kb,), P (.., 3), E (.., da*db, ntuv(la+lb))."""
    a, b, A, B, w = flat_prims(ea, ca, ra, eb, cb, rb)
    m = a.shape[0]
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    E = e3d(la, lb, a, b, A, B) * w[:, None, None, None]
    Sa, Sb = sph(la, ea.device), sph(lb, ea.device)
    E = torch.einsum('mpqt,ap,bq->mabt', E, Sa, Sb)
    return p, P, E.reshape(m, Sa.shape[0] * Sb.shape[0], E.shape[-1])


def _aux_prep(l, e, c, r):
    """Sph-folded Hermite tables of every primitive of one aux class."""
    K = e.shape[1]
    ef = e.reshape(-1)
    cf = c.reshape(-1)
    rf = r.repeat_interleave(K, dim=0)
    E = e3d(l, 0, ef, torch.zeros_like(ef), rf, rf)[:, :, 0, :]
    E = E * cf[:, None, None]
    return ef, rf, torch.einsum('mpt,ap->mat', E, sph(l, e.device))


def _coulomb(l1, p1, P1, E1, l2, p2, P2, E2, omega=None):
    """(C1, ns1, C2, ns2) Coulomb integrals between two Hermite tables; with
    omega, of the erf(omega r)/r attenuated operator."""
    pp = p1[:, None] * p2[None, :]
    ps = p1[:, None] + p2[None, :]
    rho = pp / ps
    pref = 2.0 * math.pi ** 2.5 / (pp * torch.sqrt(ps))
    if omega:
        theta = omega ** 2 / (omega ** 2 + rho)
        rho = rho * theta
        pref = pref * torch.sqrt(theta)
    rpq = P1[:, None, :] - P2[None, :, :]
    R = hermite_R(l1 + l2, rho, rpq) * pref[..., None]       # (C1, C2, ntL)
    # R at tuv_s + tuv_t for every (s, t): the gather that the JAX
    # package writes as a product with a one-hot (nt1, nt2, ntL) tensor
    # (pyscf_tpu/ops/integrals/int2e.py _comb_onehot3), without its zeros
    idx, phase = _tuv_sums(l1, l2)
    Rg = R[:, :, torch.as_tensor(idx, device=p1.device)]  # (C1, C2, nt1, nt2)
    E2p = E2 * torch.as_tensor(phase, device=p1.device)
    Q = torch.einsum('abst,bqt->abqs', Rg, E2p)       # (C1, C2, ns2, nt1)
    return torch.einsum('aps,abqs->apbq', E1, Q)


@lru_cache(maxsize=None)
def _tuv_sums(l1, l2):
    """(nt1, nt2) positions of tuv_s + tuv_t among the Hermite terms of
    order <= l1 + l2, and the phases (-1)^|tuv_t| (nt2,)."""
    pos = {c: i for i, c in enumerate(tuv_components(l1 + l2))}
    t2 = tuv_components(l2)
    idx = np.array([[pos[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]
                     for b in t2] for a in tuv_components(l1)])
    return idx, np.array([(-1.0) ** sum(b) for b in t2])


def int3c2e_plain(la, lb, ea, ca, ra, eb, cb, rb, aux, omega=None):
    """Raw (ij|P) rows of n shell pairs: (n*da*db, naux), grouped aux order;
    with omega, of the erf(omega r)/r attenuated operator."""
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    L1 = la + lb
    ns1 = (2 * la + 1) * (2 * lb + 1)
    cols = []
    for l2, e2, c2, r2 in aux:
        nsx, K2 = e2.shape
        ns2 = 2 * l2 + 1
        p2, P2, E2 = _aux_prep(l2, e2, c2, r2)
        per_pair = KK * nsx * K2 * max(n_tuv(L1) * n_tuv(l2),
                                        ns2 * n_tuv(L1))
        step = max(1, _PLAIN_BUDGET // per_pair)
        blocks = []
        for i in range(0, n, step):
            s = slice(i, i + step)
            p1, P1, E1 = _pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                          eb[s], cb[s], rb[s])
            v = _coulomb(L1, p1, P1, E1, l2, p2, P2, E2, omega)
            v = v.reshape(-1, KK, ns1, nsx, K2, ns2).sum(dim=(1, 4))
            blocks.append(v.reshape(-1, nsx * ns2))
        cols.append(torch.cat(blocks))
    return torch.cat(cols, dim=1)


def int2c2e_plain(aux, omega=None):
    """(P|Q) over every aux class pair: (naux, naux), grouped aux order;
    with omega, of the erf(omega r)/r attenuated operator."""
    preps = [(l,) + _aux_prep(l, e, c, r) + (e.shape,) for l, e, c, r in aux]
    rows = []
    for lx, px, Px, Ex, (nsx, Kx) in preps:
        cols = []
        for ly, py, Py, Ey, (nsy, Ky) in preps:
            blk = _coulomb(lx, px, Px, Ex, ly, py, Py, Ey, omega)
            dx, dy = 2 * lx + 1, 2 * ly + 1
            blk = blk.reshape(nsx, Kx, dx, nsy, Ky, dy).sum(dim=(1, 4))
            cols.append(blk.reshape(nsx * dx, nsy * dy))
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def whitener(jg):
    """(L^-1)^T of the Cholesky factor L L^T = jg of the (P|Q) metric.

    A metric that is singular to rounding has no such factor: the
    erf(omega r)/r metric of a range-separated functional, whose smallest
    eigenvalues sit at +-1e-17 of its largest for def2-universal-jkfit at
    omega 0.3 (the JAX package's Cholesky gives NaN there). Then, as PySCF's
    decompose_j2c, the whitener is U diag(lam^-1/2) over the eigenvalues
    lam > LINEAR_DEP_THR, with zero columns for the rest: W^T jg W is the
    identity on the kept space, and the factor keeps its shape."""
    L, info = torch.linalg.cholesky_ex(jg)
    if int(info) == 0:
        eye = torch.eye(jg.shape[0], dtype=jg.dtype, device=jg.device)
        return torch.linalg.solve_triangular(L, eye, upper=False).T
    lam, U = torch.linalg.eigh(jg)
    keep = lam > LINEAR_DEP_THR
    return torch.where(keep, U / torch.sqrt(torch.where(keep, lam, 1.0)),
                       0.0)


def _grouped_order(auxmol):
    """grouped column position -> AO aux index."""
    order = []
    for l in sorted(auxmol.shell_groups.keys()):
        g = auxmol.shell_groups[l]
        order.append((g.ao_off[:, None] + np.arange(2 * l + 1)).reshape(-1))
    return np.concatenate(order)


def _row_maps(mol, bc):
    """Flat AO ids (i*nao+j) and (j*nao+i) plus piece-row positions."""
    nao = mol.nao
    ia = bc.ga.ao_off[bc.sel_a][:, None] + np.arange(bc.da)   # (nsel, da)
    jb = bc.gb.ao_off[bc.sel_b][:, None] + np.arange(bc.db)
    rows_ij = (ia[:, :, None] * nao + jb[:, None, :]).reshape(-1)
    rows_ji = (jb[:, None, :] * nao + ia[:, :, None]).reshape(-1)
    rowpos = np.arange(bc.nsel * bc.ns1)
    return rows_ij, rows_ji, rowpos


def _assemble(pieces, row_ids, nao):
    """Dense (nao*nao, ncol) from class pieces via the (ij)/(ji) row maps;
    pairs the screening dropped read a zero row."""
    nrows = sum(p.shape[0] for p in pieces)
    row_map = np.full(nao * nao, nrows, dtype=np.int64)
    off = 0
    for (rows_ij, rows_ji, rowpos), piece in zip(row_ids, pieces):
        row_map[rows_ij] = off + rowpos
        row_map[rows_ji] = off + rowpos       # (ij|P) == (ji|P)
        off += piece.shape[0]
    zero = pieces[0].new_zeros((1,) + pieces[0].shape[1:])
    V = torch.cat(list(pieces) + [zero])
    return V[torch.as_tensor(row_map, device=V.device)]


def sync(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def screened_pairs(mol):
    """{(la, lb): (class metadata, pair tables)} of the screened bra classes."""
    return {cls: (bc, pair_tables(bc.ga, bc.gb, bc.sel_a, bc.sel_b))
            for cls, bc in _bra_classes(mol).items() if bc.nsel}


def _to_ao_order(auxmol, device):
    """Positions that take an aux index from grouped to AO order."""
    return torch.as_tensor(np.argsort(_grouped_order(auxmol)), device=device)


def int2c2e_ao(mol):
    """(P|Q) over mol's own shells in its AO order, (nao, nao) on
    mol.device: mol.intor('int2c2e')."""
    from .. import kernels
    idx = _to_ao_order(mol, mol.device)
    return kernels.int2c2e(aux_tables(mol))[idx][:, idx]


def whitened_factor(mol, auxmol, rows, linv_t):
    """B (naux, nao, nao) from raw rows {(la, lb): (nsel*ns1, naux)} and the
    whitener: rows @ (L^-1)^T per class, gathered to AO order."""
    nao, naux = mol.nao, auxmol.nao
    bra = _bra_classes(mol)
    pieces = [r @ linv_t for r in rows.values()]
    row_ids = [_row_maps(mol, bra[cls]) for cls in rows]
    B = _assemble(pieces, row_ids, nao).T.reshape(naux, nao, nao)
    return B[_to_ao_order(auxmol, B.device)]


def df_factor(mol, auxmol, timings=None, omega=None):
    """(B, (L^-1)^T) on mol.device: the dense whitened DF factor B (naux,
    nao, nao) and its whitener, whose rows and columns are in the order of
    B's first index and of the AO aux basis, so that
    (L^-1)^T @ (B . dm) = (P|Q)^-1 gamma in AO order (the DF gradient needs
    both).

    (ij|kl) ~= sum_P B[P,i,j] B[P,k,l]; with omega, of the erf(omega r)/r
    attenuated operator in both the metric and the 3c rows (kernels
    int2c2e_lr and int3c2e_lr). timings, if given, receives the seconds of
    the j2c metric + whitener ('j2c') and of the 3c rows, whitening and
    assembly ('j3c')."""
    from .. import kernels
    aux = aux_tables(auxmol)
    t0 = time.perf_counter()
    linv_t = whitener(kernels.int2c2e(aux, omega))
    sync(mol.device)
    t1 = time.perf_counter()
    rows = {(la, lb): kernels.int3c2e(la, lb, *pairs, aux, omega)
            for (la, lb), (_, pairs) in screened_pairs(mol).items()}
    B = whitened_factor(mol, auxmol, rows, linv_t)
    sync(mol.device)
    if timings is not None:
        timings['j2c'] = t1 - t0
        timings['j3c'] = time.perf_counter() - t1
    ao = _to_ao_order(auxmol, B.device)
    return B, linv_t[ao][:, ao]
