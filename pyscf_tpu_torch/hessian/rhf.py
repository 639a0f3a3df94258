"""Analytic nuclear Hessian of density-fitted RHF through the coupled-
perturbed equations.

Counterpart of pyscf_tpu/hessian/rhf.py. The JAX package takes the jvp of
its analytic gradient g(X, D, W) = grad_X E_fix(X, D, W) along (dX_t, dD_t,
dW_t) for every coordinate tangent t, with the density responses dD_t and
dW_t from CPHF; here the same derivative is written out, term by term, on
the DF gradient of grad/df.py:

  g = grad_nuc + sum h' D - S' W + sum (ij|P)' Gamma^P_ij + sum (P|Q)' W_PQ
  Gamma^P = D c_P - hyb/2 D Psi_P D,   W_PQ = -1/2 c_P c_Q + hyb/4 Z_PQ
  Psi = M^-1 (ij|P) = (L^-1)^T B,  c = Psi . D,  Z_PQ = tr(D Psi_P D Psi_Q)

with M = (P|Q). Row s of the Hessian, for the total change along s of the
geometry and of D and W,

  H[s, t] = hess_nuc + [h'' D - S'' W + (ij|P)'' Gamma + (P|Q)'' W_PQ]_st
            + h'_t . dD_s - S'_t . dW_s + (ij|P)'_t . dGamma_s
            + (P|Q)'_t . dW_PQ,s

  - the second-derivative integrals contracted with the gradient's weights
    are the kernels int1e_ipip, int3c2e_ipip and int2c2e_ipip;
  - the first-derivative matrices S'_t and h'_t come from int1e_ip and
    int1e_iprinv, the uncontracted (ij|P)' and (P|Q)' from int3c2e_ip1 and
    int2c2e_ip1_full (the aux centre's by translational invariance);
  - dGamma_s and dW_PQ,s hold both the geometry's change of (ij|P) and M
    (the whitener's own X-dependence: dPsi = M^-1 ((ij|P)' - M' Psi)) and
    the density's dD_s; the exchange term is linearised in the D form of the
    energy, -hyb/4 tr(D K[D]) (pyscf_tpu/hessian/rhf.py:236-245 e_fix), as
    dD_s is not of the form co co^T.
  All of it is torch GEMMs on mol.device, chunked over tangent_chunk
  tangents so that no (3 natm, naux, nao, nao) tensor is held.

CPHF (pyscf_tpu/hessian/rhf.py:108-144 _cphf_pcg and :275-315): the
Fock derivative at fixed density F'_t = h'_t + J'_t - hyb/2 K'_t, and the
linear response G[dD] = J[dD] - hyb/2 K[dD] in the MO basis on the blocks
of B (cuBLAS GEMMs), solved for all 3 natm right-hand sides at once by
the reference's preconditioned CG, stopping when every column is under
cphf_tol (the reference runs all cphf_max_cycle steps with the finished
columns frozen, which gives the same U).
"""
import time

import numpy as np
import torch

from ..grad import df as grad_df
from ..grad.rhf import _ao2atom_map
from ..ops.integrals import int1e_deriv, j3c_deriv
from ..ops.integrals.int1e import cross_pairs
from ..ops.integrals.j3c import (_bra_classes, _grouped_order, aux_tables,
                                 screened_pairs, sync)


def hess_nuc(mol):
    """Nuclear-repulsion part of the Hessian, (natm, 3, natm, 3) numpy: the
    second derivative of sum_{A<B} Z_A Z_B / |R_A - R_B|."""
    z = np.asarray(mol.charges, dtype=float)
    r = np.asarray(mol.coords)
    natm = r.shape[0]
    h = np.zeros((natm, 3, natm, 3))
    for a in range(natm):
        for b in range(natm):
            if a == b:
                continue
            d = r[a] - r[b]
            dist = np.linalg.norm(d)
            blk = z[a] * z[b] * (3.0 * np.outer(d, d) / dist ** 5
                                 - np.eye(3) / dist ** 3)
            h[a, :, a, :] += blk
            h[a, :, b, :] -= blk
    return h


def cphf_pcg(matvec, rhs, ediff, max_cycle=40, tol=1e-10):
    """Solve A u = rhs for each column of rhs (nv, no, T) by preconditioned
    CG (pyscf_tpu/hessian/rhf.py:108-144), ediff (nv, no) the Jacobi
    preconditioner. Returns (u, residual norms (T,), iterations run)."""
    pre = 1.0 / ediff[:, :, None]

    def dots(x, y):
        return torch.einsum('aiT,aiT->T', x, y)

    x = rhs * pre
    r = rhs - matvec(x)
    p = r * pre
    rz = dots(r, p)
    it = 0
    for it in range(1, max_cycle + 1):
        alive = torch.sqrt(dots(r, r)) > tol
        if not bool(alive.any()):
            # every column is frozen from here on: the same u as running on
            it -= 1
            break
        Ap = matvec(p)
        pAp = dots(p, Ap)
        alpha = torch.where(alive, rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * pre
        rz_new = dots(r, z)
        beta = torch.where(alive, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(dots(r, r)), it


class Hessian:
    """Analytic Hessian of a converged DF-RHF mean field:
    Hessian(mf).kernel() -> (natm, 3, natm, 3) numpy in Ha/Bohr^2. After a
    call, `timings` holds the seconds of its phases (each ended by a device
    synchronize) and `cphf_cycles` the CG iterations."""

    cphf_max_cycle = 40
    cphf_tol = 1e-9
    tangent_chunk = 6

    def __init__(self, mf):
        if mf.with_df is None:
            raise NotImplementedError('analytic Hessian needs density '
                                      'fitting; use mf.density_fit()')
        from ..scf.uhf import UHF
        if isinstance(mf, UHF):
            raise NotImplementedError('restricted (RHF) only')
        if hasattr(mf, 'xc'):
            raise NotImplementedError(
                'the analytic DF-RKS Hessian is not ported yet: it needs the '
                'AO third derivatives and the XC energy\'s second derivative '
                'along the geometry (pyscf_tpu/hessian/rhf.py with isks)')
        self.mf = mf
        self.mol = mf.mol
        self.de = None
        self.timings = {}
        self.cphf_cycles = 0

    def kernel(self):
        self.timings = {}
        self.de, self.cphf_cycles = hessian(
            self.mf, self.cphf_max_cycle, self.cphf_tol, self.tangent_chunk,
            self.timings)
        return self.de

    run = kernel


class _Clock:
    """Phase seconds into a dict, each phase ended by a device sync."""

    def __init__(self, dev, out):
        self.dev, self.out = dev, out
        self.t = time.perf_counter()

    def lap(self, name):
        sync(self.dev)
        t = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + t - self.t
        self.t = t


def _first_1e(mol, ao2atom):
    """S'_t and h'_t of every tangent t = 3 A + x: (3 natm, nao, nao) each,
    from the bra derivatives (int1e_ip) and the operator centres
    (int1e_iprinv, all atoms in one launch per class)."""
    dev = mol.device
    ipovlp, ipkin, ipnuc = int1e_deriv.ip_parts(mol)
    iprinv = int1e_deriv.int1e_iprinv(mol, mol.coords)     # (natm, 3, n, n)
    natm, nao = mol.natm, mol.nao
    mask = (ao2atom[None, :] == torch.arange(natm, device=dev)[:, None])
    mask = mask.to(torch.float64)[:, None, :, None]         # (natm, 1, n, 1)
    s1 = ipovlp[None] * mask
    s1 = s1 + s1.transpose(-1, -2)
    h1 = (ipkin + ipnuc)[None] * mask
    z = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    h1 = h1 + h1.transpose(-1, -2) + z[:, None, None, None] * iprinv
    return (s1.reshape(3 * natm, nao, nao), h1.reshape(3 * natm, nao, nao))


def _first_df(mol, auxmol):
    """(ip1 (3, naux, nao, nao), ip2 (3, naux, naux)), aux in AO order:
    d(ij|P)/dA_i for every pair of the energy's screened shell pairs in
    both orders (int3c2e_ip1) and d(P|Q)/dR_P (int2c2e_ip1_full)."""
    from ..ops import kernels
    dev = mol.device
    nao, naux = mol.nao, auxmol.nao
    aux = aux_tables(auxmol)
    out = torch.zeros((3, nao, nao, naux), dtype=torch.float64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    for (la, lb), (bc, pairs) in screened_pairs(mol).items():
        ia = bc.ga.ao_off[bc.sel_a]
        jb = bc.gb.ao_off[bc.sel_b]
        kernels.int3c2e_ip1(la, lb, *pairs, aux, torch.as_tensor(ia, **i32),
                            torch.as_tensor(jb, **i32), out)
        # the mirrored pairs (b, a), without the diagonal pairs of la == lb
        keep = ~((la == lb) & (bc.sel_a == bc.sel_b))
        if keep.any():
            k = torch.as_tensor(np.flatnonzero(keep), device=dev)
            ea, ca, ra, eb, cb, rb = (t.index_select(0, k) for t in pairs)
            kernels.int3c2e_ip1(lb, la, eb, cb, rb, ea, ca, ra, aux,
                                torch.as_tensor(jb[keep], **i32),
                                torch.as_tensor(ia[keep], **i32), out)
    ao = torch.as_tensor(np.argsort(_grouped_order(auxmol)), device=dev)
    ip1 = out.index_select(3, ao).permute(0, 3, 1, 2).contiguous()
    del out
    ip2 = kernels.int2c2e_ip1_full(aux).index_select(1, ao).index_select(2, ao)
    return ip1, ip2


def _tangent_derivs(ip1, ip2, ao2atom, aux2atom, idx):
    """(ij|P)' (T, naux, nao, nao) and M' (T, naux, naux) of the tangents
    idx (3 A + x): the bra and ket functions on A by ip1, the aux functions
    on A by translational invariance, -(ip1[ij] + ip1[ji])."""
    dev = ip1.device
    atom = torch.as_tensor(idx // 3, device=dev)
    x = torch.as_tensor(idx % 3, device=dev)
    m_ao = (ao2atom[None, :] == atom[:, None]).to(torch.float64)
    m_aux = (aux2atom[None, :] == atom[:, None]).to(torch.float64)
    d = ip1.index_select(0, x)                          # (T, naux, n, n)
    dt = d.transpose(-1, -2)
    j3 = d * m_ao[:, None, :, None]
    j3 = j3 + j3.transpose(-1, -2) - (d + dt) * m_aux[:, :, None, None]
    m2 = ip2.index_select(0, x) * m_aux[:, :, None]
    return j3, m2 + m2.transpose(-1, -2)


def _mo_response(B, Co, Cv, hyb):
    """G(Moo, Mvo) -> (G_vo, G_oo): the MO blocks of J[dD] - hyb/2 K[dD] for
    the densities dD = Co Moo Co^T + Cv Mvo Co^T + Co Mvo^T Cv^T (batched,
    Moo (T, no, no), Mvo (T, nv, no)), on the MO blocks of B."""
    Bo = B @ Co                                         # (naux, nao, no)
    Boo = Co.T @ Bo                                     # (naux, no, no)
    Bvo = Cv.T @ Bo                                     # (naux, nv, no)
    Bvv = Cv.T @ (B @ Cv)                               # (naux, nv, nv)
    del Bo

    def g(Moo, Mvo):
        rho = (torch.einsum('Pij,Tij->TP', Boo, Moo)
               + 2.0 * torch.einsum('Pai,Tai->TP', Bvo, Mvo))
        gvo = torch.einsum('TP,Pai->Tai', rho, Bvo)
        goo = torch.einsum('TP,Pij->Tij', rho, Boo)
        # K_vo = sum_P Bvo Moo Boo + Bvv Mvo Boo + Bvo Mvo^T Bvo
        kvo = (torch.einsum('Pak,Tkl,Pli->Tai', Bvo, Moo, Boo)
               + torch.einsum('Pab,Tbk,Pki->Tai', Bvv, Mvo, Boo)
               + torch.einsum('Pak,Tbk,Pbi->Tai', Bvo, Mvo, Bvo))
        # K_oo = sum_P Boo Moo Boo + Bov Mvo Boo + (Bov Mvo Boo)^T
        k2 = torch.einsum('Pbi,Tbk,Pkj->Tij', Bvo, Mvo, Boo)
        koo = (torch.einsum('Pik,Tkl,Plj->Tij', Boo, Moo, Boo)
               + k2 + k2.transpose(-1, -2))
        return gvo - 0.5 * hyb * kvo, goo - 0.5 * hyb * koo

    return g


def _add_blocks(H, natm, a, b, blk):
    """H (natm * natm, 3, 3) += blk (m, 3, 3) at the atom pairs (a, b)."""
    H.index_add_(0, (a * natm + b).reshape(-1), blk.reshape(-1, 3, 3))


def _hess_1e(mol, D, W, ao2atom):
    """sum h'' D - S'' W, (natm * natm, 3, 3): one `int1e_ipip` launch per
    ordered class over every shell pair, then translational invariance
    d/dB = -(d/dA + d/dC) per charge C and d/dB = -d/dA for S and T."""
    from ..ops import kernels
    dev = mol.device
    natm = mol.natm
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    H = torch.zeros((natm * natm, 3, 3), dtype=torch.float64, device=dev)
    atoms = torch.arange(natm, device=dev)
    for la, lb, ga, gb, pairs in cross_pairs(mol, mol):
        sel_a = np.repeat(np.arange(ga.nshl), gb.nshl)
        sel_b = np.tile(np.arange(gb.nshl), ga.nshl)
        ia = torch.as_tensor(ga.ao_off[sel_a][:, None] + np.arange(2 * la + 1),
                             device=dev)
        jb = torch.as_tensor(gb.ao_off[sel_b][:, None] + np.arange(2 * lb + 1),
                             device=dev)
        n = ia.shape[0]
        Db = D[ia[:, :, None], jb[:, None, :]].reshape(n, -1).contiguous()
        Wb = W[ia[:, :, None], jb[:, None, :]].reshape(n, -1).contiguous()
        out = kernels.int1e_ipip(la, lb, *pairs, zr, zq, Db, Wb)
        A = torch.as_tensor(ga.atom_ids[sel_a], device=dev)
        B = torch.as_tensor(gb.atom_ids[sel_b], device=dev)
        st = out[:, natm, :9].reshape(n, 3, 3)
        _add_blocks(H, natm, A, A, st)
        _add_blocks(H, natm, B, B, st)
        _add_blocks(H, natm, A, B, -st)
        _add_blocks(H, natm, B, A, -st.transpose(-1, -2))
        aa, ac, cc = (out[:, :natm, 9 * k:9 * k + 9].reshape(n, natm, 3, 3)
                      for k in range(3))
        Ae = A[:, None].expand(n, natm)
        Be = B[:, None].expand(n, natm)
        Ce = atoms[None, :].expand(n, natm)
        ab = -(aa + ac)
        bc = -(ac + cc)
        for a, b, blk in ((Ae, Ae, aa), (Ae, Ce, ac),
                          (Ce, Ae, ac.transpose(-1, -2)), (Ce, Ce, cc),
                          (Ae, Be, ab), (Be, Ae, ab.transpose(-1, -2)),
                          (Be, Be, aa + ac + ac.transpose(-1, -2) + cc),
                          (Be, Ce, bc), (Ce, Be, bc.transpose(-1, -2))):
            _add_blocks(H, natm, a, b, blk)
    return H


def _hess_3c(mol, auxmol, gamma):
    """sum Gamma^P_ij (ij|P)'', (natm * natm, 3, 3): one `int3c2e_ipip`
    launch per (bra class, aux class) on the energy's screened pairs (the
    factor 2 of the mirrored pairs in Gamma's rows, as grad_3c), then
    d/dC = -(d/dA + d/dB) for the aux centre."""
    from ..ops import kernels
    dev = mol.device
    natm, naux, nao = mol.natm, auxmol.nao, mol.nao
    order = torch.as_tensor(_grouped_order(auxmol), device=dev)
    gflat = gamma.reshape(naux, nao * nao).index_select(0, order)
    aux = aux_tables(auxmol)
    bra = _bra_classes(mol)
    C = j3c_deriv._aux_atoms(auxmol, dev)
    H = torch.zeros((natm * natm, 3, 3), dtype=torch.float64, device=dev)
    for cls, (bc, pairs) in screened_pairs(mol).items():
        out = kernels.int3c2e_ipip(*cls, *pairs, aux, j3c_deriv._gamma_rows(
            mol, bra[cls], gflat))
        n, nsh = out.shape[:2]
        aa, ab, bb = (out[..., 9 * k:9 * k + 9].reshape(n, nsh, 3, 3)
                      for k in range(3))
        A = torch.as_tensor(bc.ga.atom_ids[bc.sel_a], device=dev)
        B = torch.as_tensor(bc.gb.atom_ids[bc.sel_b], device=dev)
        Ae = A[:, None].expand(n, nsh)
        Be = B[:, None].expand(n, nsh)
        Ce = C[None, :].expand(n, nsh)
        abt = ab.transpose(-1, -2)
        ac = -(aa + ab)
        bc_ = -(abt + bb)
        for a, b, blk in ((Ae, Ae, aa), (Ae, Be, ab), (Be, Ae, abt),
                          (Be, Be, bb), (Ae, Ce, ac),
                          (Ce, Ae, ac.transpose(-1, -2)), (Be, Ce, bc_),
                          (Ce, Be, bc_.transpose(-1, -2)),
                          (Ce, Ce, aa + ab + abt + bb)):
            _add_blocks(H, natm, a, b, blk)
    return H


def _hess_2c(auxmol, W):
    """sum W_PQ (P|Q)'', (natm * natm, 3, 3): the `int2c2e_ipip` launches,
    then d/dR_Q = -d/dR_P."""
    from ..ops import kernels
    dev = auxmol.device
    natm = auxmol.natm
    order = torch.as_tensor(_grouped_order(auxmol), device=dev)
    Wg = W.index_select(0, order).index_select(1, order).contiguous()
    pp = kernels.int2c2e_ipip(aux_tables(auxmol), Wg)
    nsh = pp.shape[0]
    pp = pp.reshape(nsh, nsh, 3, 3)
    C = j3c_deriv._aux_atoms(auxmol, dev)
    P = C[:, None].expand(nsh, nsh)
    Q = C[None, :].expand(nsh, nsh)
    H = torch.zeros((natm * natm, 3, 3), dtype=torch.float64, device=dev)
    for a, b, blk in ((P, P, pp), (Q, Q, pp), (P, Q, -pp),
                      (Q, P, -pp.transpose(-1, -2))):
        _add_blocks(H, natm, a, b, blk)
    return H


def _rows_to_atoms(rows, atom_of, natm):
    """(T, 3, m) per-function rows -> (T, 3 natm) sums by atom, tangent
    major (3 A + x)."""
    T = rows.shape[0]
    out = rows.new_zeros((T, 3, natm))
    out.index_add_(2, atom_of, rows)
    return out.permute(0, 2, 1).reshape(T, 3 * natm)


class _DFDerivs:
    """The DF tensors of the response terms: the uncontracted derivatives
    ip1, ip2 of _first_df, Psi = M^-1 (ij|P) (naux, nao, nao), M^-1, c =
    Psi . D, Psi co and co^T Psi co for the density D = co co^T, and the
    atoms of the AO and aux functions."""

    def __init__(self, mol, auxmol, B, linv_t, co):
        dev = mol.device
        naux, nao = auxmol.nao, mol.nao
        self.natm, self.nao, self.naux = mol.natm, nao, naux
        self.co, self.D = co, co @ co.T
        self.ip1, self.ip2 = _first_df(mol, auxmol)
        self.ao2atom = torch.as_tensor(_ao2atom_map(mol), device=dev)
        self.aux2atom = torch.as_tensor(_ao2atom_map(auxmol), device=dev)
        self.Minv = linv_t @ linv_t.T
        self.Psi = (linv_t @ B.reshape(naux, -1)).reshape(naux, nao, nao)
        self.c = torch.einsum('Pij,ij->P', self.Psi, self.D)
        self.PsiC = self.Psi @ co                       # (naux, nao, no)
        self.O = co.T @ self.PsiC                       # (naux, no, no)

    def tangent(self, idx):
        return _tangent_derivs(self.ip1, self.ip2, self.ao2atom,
                               self.aux2atom, idx)


def _fock1(dfd, chunks, hyb):
    """J'_t - hyb/2 K'_t at the fixed density D of every tangent, (3 natm,
    nao, nao): J = sum_P (ij|P) c_P, K = sum_P (ij|P) D Psi_P, differentiated
    in (ij|P) and M with J' = (ij|P)' . c + Psi (gamma' - M' c) and K' =
    sum (ij|P)'_P D Psi_P + h.c. - sum M'_PQ Psi_P D Psi_Q."""
    naux, nao = dfd.naux, dfd.nao
    co, c, Psi, PsiC = dfd.co, dfd.c, dfd.Psi, dfd.PsiC
    out = []
    for idx in chunks:
        j3, m2 = dfd.tangent(idx)
        T = len(idx)
        gam1 = torch.einsum('TPij,ij->TP', j3, dfd.D)
        vj = (torch.einsum('P,TPij->Tij', c, j3)
              + torch.einsum('TQ,Qij->Tij', gam1 - m2 @ c, Psi))
        k1 = torch.einsum('TPio,Pjo->Tij', j3 @ co, PsiC)
        Z = (m2 @ PsiC.reshape(naux, -1)).reshape(T, naux, nao, -1)
        vk = k1 + k1.transpose(-1, -2) - torch.einsum('TPio,Pjo->Tij', Z,
                                                      PsiC)
        out.append(vj - 0.5 * hyb * vk)
    return torch.cat(out)


def _rows_df(dfd, chunks, dD, hyb):
    """(ij|P)'_t . dGamma_s + M'_t . dW_PQ,s, (3 natm (s), 3 natm (t)): the
    change of the DF gradient's weights along tangent s, through (ij|P), M
    and the density response dD (3 natm, nao, nao), contracted with the
    uncontracted first derivatives of every tangent t."""
    naux, nao, natm = dfd.naux, dfd.nao, dfd.natm
    co, D0, c, Psi, PsiC, O = (dfd.co, dfd.D, dfd.c, dfd.Psi, dfd.PsiC,
                               dfd.O)
    rows = []
    for idx in chunks:
        T = len(idx)
        j3, m2 = dfd.tangent(idx)
        dPsi = j3.reshape(T, naux, -1) - m2 @ Psi.reshape(naux, -1)
        dPsi = (dfd.Minv @ dPsi).reshape(T, naux, nao, nao)
        del j3
        dDs = dD[idx[0]:idx[-1] + 1]
        dc = (torch.einsum('TPij,ij->TP', dPsi, D0)
              + torch.einsum('Pij,Tij->TP', Psi, dDs))
        Tm = torch.einsum('Tij,Pjo->TPio', dDs, PsiC)
        Od = co.T @ dPsi @ co                           # (T, naux, no, no)
        ddp = torch.einsum('TPio,jo->TPij', Tm, co)
        dgam = (c[None, :, None, None] * dDs[:, None]
                + dc[:, :, None, None] * D0
                - 0.5 * hyb * (ddp + ddp.transpose(-1, -2)
                               + co @ Od @ co.T))
        del dPsi, ddp
        A = (torch.einsum('TPio,Qio->TPQ', Tm, PsiC)
             + torch.einsum('TPop,Qop->TPQ', Od, O))
        dWpq = (-0.5 * (dc[:, :, None] * c[None, None, :]
                        + c[None, :, None] * dc[:, None, :])
                + 0.25 * hyb * (A + A.transpose(-1, -2)))
        del Tm, Od, A
        prod = dfd.ip1[:, None] * dgam[None]           # (3, T, naux, n, n)
        r_ao = prod.sum(dim=(2, 4)).permute(1, 0, 2)    # (T, 3, nao)
        r_aux = prod.sum(dim=(3, 4)).permute(1, 0, 2)   # (T, 3, naux)
        del prod, dgam
        r_m = torch.einsum('xPQ,TPQ->TxP', dfd.ip2, dWpq)
        rows.append(2.0 * _rows_to_atoms(r_ao, dfd.ao2atom, natm)
                    + 2.0 * _rows_to_atoms(r_m - r_aux, dfd.aux2atom, natm))
    return torch.cat(rows)


def hessian(mf, cphf_max_cycle=40, cphf_tol=1e-9, tangent_chunk=6,
            timings=None, reference_w=False):
    """((natm, 3, natm, 3) numpy Hessian, CPHF iterations) of a converged
    DF-RHF mean field; timings, if given, receives the seconds of the
    phases 's1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e', 'rows_df', 'rows_3c'
    and 'rows_2c'.

    reference_w=True reproduces pyscf_tpu/hessian/rhf.py:316-323, whose dW
    keeps only the diagonal of its occupied block (the orbital energies'
    change) and drops the off-diagonal f'_ij - s'_ij (e_i + e_j)/2 of the
    canonical orbitals' rotation: that Hessian misses -S' . dW of it
    wherever there are two occupied orbitals or more (ROADMAP section 3).
    The tests hold the port to the reference with it; the default is the
    derivative of the gradient, which central differences confirm."""
    mol = mf.mol
    dev = mol.device
    auxmol = mf.with_df.build().auxmol
    natm = mol.natm
    nt = 3 * natm
    hyb = 1.0
    clock = _Clock(dev, {} if timings is None else timings)
    f64 = dict(dtype=torch.float64, device=dev)

    occ = mf.mo_occ
    sel = occ > 0
    C = mf.mo_coeff
    Co, Cv = C[:, sel], C[:, ~sel]
    eo, ev = mf.mo_energy[sel], mf.mo_energy[~sel]
    no, nv = Co.shape[1], Cv.shape[1]
    co = Co * np.sqrt(2.0)
    ao2atom = torch.as_tensor(_ao2atom_map(mol), device=dev)
    B = mf.with_df.cderi

    s1, h1 = _first_1e(mol, ao2atom)
    clock.lap('s1h1')
    dfd = _DFDerivs(mol, auxmol, B, mf.with_df.whitener, co)
    clock.lap('ip1_3c')

    chunks = [np.arange(i, min(i + tangent_chunk, nt))
              for i in range(0, nt, tangent_chunk)]
    F1 = h1 + _fock1(dfd, chunks, hyb)
    clock.lap('F1')

    # CPHF (pyscf_tpu/hessian/rhf.py:275-315)
    s1_oo = Co.T @ s1 @ Co                              # (nt, no, no)
    s1_vo = Cv.T @ s1 @ Co
    f1_vo = Cv.T @ F1 @ Co
    g = _mo_response(B, Co, Cv, hyb)
    zero_vo = torch.zeros((nt, nv, no), **f64)
    g_oo_vo = g(-2.0 * s1_oo, zero_vo)[0]
    ediff = ev[:, None] - eo[None, :]
    rhs = (-f1_vo - g_oo_vo + s1_vo * eo).permute(1, 2, 0)
    zero_oo = torch.zeros((1, no, no), **f64)

    def matvec(u):
        gvo = g(zero_oo.expand(u.shape[2], no, no), 2.0 * u.permute(2, 0, 1))
        return ediff[:, :, None] * u + gvo[0].permute(1, 2, 0)

    U, _, cycles = cphf_pcg(matvec, rhs, ediff, cphf_max_cycle, cphf_tol)
    U = U.permute(2, 0, 1)                              # (nt, nv, no)
    half = Cv @ U @ Co.T
    dD = 2.0 * (half + half.transpose(-1, -2)) - 2.0 * Co @ s1_oo @ Co.T
    g_oo = g(-2.0 * s1_oo, 2.0 * U)[1]
    f1_oo = Co.T @ F1 @ Co + g_oo
    dCo = Cv @ U - 0.5 * Co @ s1_oo
    # the occupied block of the energy-weighted density's change: the
    # orbital energies' change on the diagonal, and off it the part of the
    # canonical orbitals' rotation that the gauge dCo leaves out
    e_oo = f1_oo - 0.5 * (s1_oo * eo + eo[:, None] * s1_oo)
    if reference_w:
        e_oo = torch.diag_embed(torch.diagonal(e_oo, dim1=1, dim2=2))
    dW = 2.0 * ((dCo * eo) @ Co.T + (Co * eo) @ dCo.transpose(-1, -2)
                + Co @ e_oo @ Co.T)
    del F1
    clock.lap('cphf')

    # H[s, t]: rows s of the perturbations, columns t of the gradient
    H = (dD.reshape(nt, -1) @ h1.reshape(nt, -1).T
         - dW.reshape(nt, -1) @ s1.reshape(nt, -1).T)
    dm, cos, dme, kfac = grad_df.occupied(mf)
    hxx = _hess_1e(mol, dm, dme, ao2atom)
    clock.lap('rows_1e')

    H += _rows_df(dfd, chunks, dD, hyb)
    clock.lap('rows_df')

    _, gamma, Wpq = grad_df.fitted_weights(mf, dm, cos, kfac)
    hxx += _hess_3c(mol, auxmol, gamma)
    del gamma
    clock.lap('rows_3c')
    hxx += _hess_2c(auxmol, Wpq)
    clock.lap('rows_2c')
    hxx = hxx.reshape(natm, natm, 3, 3).permute(0, 2, 1, 3).reshape(nt, nt)
    H = H + hxx
    H = 0.5 * (H + H.T)
    h = H.cpu().numpy().reshape(natm, 3, natm, 3) + hess_nuc(mol)
    return h, cycles
