"""Analytic nuclear Hessian of density-fitted RHF and RKS through the
coupled-perturbed equations.

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

DF-RKS (the JAX package's isks branch, :184-245, with exc_fun its
_exc_quadrature on the fixed grid) adds, with hyb the functional's hybrid
fraction (pyscf_tpu/hessian/rhf.py:223-245,279,287,327):
  - dV_xc/dX_t at fixed D to h'_t, so to F'_t and to the rows dD_s . V'_t
    (NumInt.rks_xc_hessian: kernels eval_ao deriv 3, xc_rks_hess and
    xc_rks_deriv1, GEMMs);
  - E_xc's second derivative in X at fixed D to the rows (the same call);
  - the XC response fxc . dD to G[dD] of CPHF: the tangent of V_xc along
    dD by NumInt.rks_response (kernel `xc_rks_fxc`) in the right-hand side
    and dW's occupied block, and in the CG steps either the same tangent
    or, where _dense_fxc finds it the cheaper, the dense occupied-virtual
    A_xc of tdscf/rhf.py _fxc_ov (kernels `xc_fxc`, `xc_fxc_pairs`), whose
    products with the vectors are GEMMs (both routes' times in PERF.md
    section 6).
The JAX package's dE_xc/dD is not symmetric for a GGA (its jax.grad in D
takes grad rho = 2 (D phi) . grad phi as written), and its CPHF takes the
occupied-virtual block of that matrix's derivatives in F' and in lin_g;
reference_vxc=True does the same, the default takes V_xc = (dE_xc/dD +
its transpose)/2, the matrix on which the SCF converged (ROADMAP section
3).
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
    """Analytic Hessian of a converged DF-RHF or DF-RKS (pure or global
    hybrid) mean field: Hessian(mf).kernel() -> (natm, 3, natm, 3) numpy in
    Ha/Bohr^2. After a call, `timings` holds the seconds of its phases
    (each ended by a device synchronize) and `cphf_cycles` the CG
    iterations."""

    cphf_max_cycle = 40
    cphf_tol = 1e-9
    tangent_chunk = 6

    def __init__(self, mf):
        if mf.with_df is None:
            raise NotImplementedError('analytic Hessian needs density '
                                      'fitting; use mf.density_fit()')
        self._check_kind(mf)
        if hasattr(mf, 'xc'):
            if mf._numint.rsh_and_hybrid_coeff(mf.xc)[0]:
                raise NotImplementedError('range-separated hybrids')
            if mf.nlc:
                raise NotImplementedError('NLC functionals')
        self.mf = mf
        self.mol = mf.mol
        self.de = None
        self.timings = {}
        self.cphf_cycles = 0

    @staticmethod
    def _check_kind(mf):
        from ..scf.uhf import UHF
        if isinstance(mf, UHF):
            raise NotImplementedError('restricted (RHF/RKS) only: '
                                      'hessian/uhf.py takes DF-UHF and DF-UKS')

    @staticmethod
    def _hessian(*args):
        return hessian(*args)

    def kernel(self):
        self.timings = {}
        self.de, self.cphf_cycles = self._hessian(
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


def tangent_chunks(nt, size):
    """The tangents 0 .. nt - 1 in consecutive chunks of size."""
    return [np.arange(i, min(i + size, nt)) for i in range(0, nt, size)]


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


def _mo_response(B, orbs, kw, vxc=None):
    """G(Moos, Mvos) -> ([G_vo], [G_oo]): for each block (Co, Cv) of orbs
    (one for RHF, one per spin for UHF) the MO blocks of J[sum dD] - kw
    K[dD] (+ vxc, the XC response, where given and with_xc) for the
    densities dD = Co Moo Co^T + Cv Mvo Co^T + Co Mvo^T Cv^T of each block
    (batched, Moo (T, no, no), Mvo (T, nv, no)), J and K on the MO blocks
    of B; kw is hyb/2 for RHF (dD the total density) and hyb for UHF. vxc
    maps dD (T, nao, nao) for one block, (T, 2, nao, nao) for two."""
    blocks = []
    for Co, Cv in orbs:
        Bo = B @ Co                                     # (naux, nao, no)
        blocks.append((Co, Cv, Co.T @ Bo, Cv.T @ Bo,    # Boo, Bvo
                       Cv.T @ (B @ Cv)))                # Bvv (naux, nv, nv)
        del Bo

    def g(Moos, Mvos, with_xc=True):
        rho = sum(torch.einsum('Pij,Tij->TP', Boo, Moo)
                  + 2.0 * torch.einsum('Pai,Tai->TP', Bvo, Mvo)
                  for (_, _, Boo, Bvo, _), Moo, Mvo in zip(blocks, Moos, Mvos))
        gvos, goos = [], []
        for (Co, Cv, Boo, Bvo, Bvv), Moo, Mvo in zip(blocks, Moos, Mvos):
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
            gvos.append(gvo - kw * kvo)
            goos.append(goo - kw * koo)
        if vxc is not None and with_xc:
            dD = []
            for (Co, Cv, _, _, _), Moo, Mvo in zip(blocks, Moos, Mvos):
                half = Cv @ Mvo @ Co.T
                dD.append(Co @ Moo @ Co.T + half + half.transpose(-1, -2))
            v = vxc(dD[0] if len(dD) == 1 else torch.stack(dD, dim=1))
            vs = [v] if len(dD) == 1 else v.unbind(1)
            for k, ((Co, Cv, _, _, _), vk) in enumerate(zip(blocks, vs)):
                gvos[k] = gvos[k] + Cv.T @ vk @ Co
                goos[k] = goos[k] + Co.T @ vk @ Co
        return gvos, goos

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
    Psi . D for the density D = sum co co^T over the occupied blocks cos
    (co = Co sqrt(2) for RHF, Co of each spin for UHF), per block Psi co
    and co^T Psi co, and the atoms of the AO and aux functions."""

    def __init__(self, mol, auxmol, B, linv_t, cos):
        dev = mol.device
        naux, nao = auxmol.nao, mol.nao
        self.natm, self.nao, self.naux = mol.natm, nao, naux
        self.cos = cos
        self.D = sum(co @ co.T for co in cos)
        self.ip1, self.ip2 = _first_df(mol, auxmol)
        self.ao2atom = torch.as_tensor(_ao2atom_map(mol), device=dev)
        self.aux2atom = torch.as_tensor(_ao2atom_map(auxmol), device=dev)
        self.Minv = linv_t @ linv_t.T
        self.Psi = (linv_t @ B.reshape(naux, -1)).reshape(naux, nao, nao)
        self.c = torch.einsum('Pij,ij->P', self.Psi, self.D)
        self.PsiC = [self.Psi @ co for co in cos]       # (naux, nao, no)
        self.O = [co.T @ pc for co, pc in zip(cos, self.PsiC)]

    def tangent(self, idx):
        return _tangent_derivs(self.ip1, self.ip2, self.ao2atom,
                               self.aux2atom, idx)


def _fock1(dfd, chunks, kws):
    """J'_t - kw K'_t of each occupied block (weight kw: hyb/2 for RHF's
    one block, hyb for each spin of UHF) at the fixed density of every
    tangent, (nblock, 3 natm, nao, nao): J = sum_P (ij|P) c_P of the total
    D, K = sum_P (ij|P) D_k Psi_P of the block's D_k = co co^T,
    differentiated in (ij|P) and M with J' = (ij|P)' . c + Psi (gamma' -
    M' c) and K' = sum (ij|P)'_P D_k Psi_P + h.c. - sum M'_PQ Psi_P D_k
    Psi_Q."""
    naux, nao = dfd.naux, dfd.nao
    c, Psi = dfd.c, dfd.Psi
    out = []
    for idx in chunks:
        j3, m2 = dfd.tangent(idx)
        T = len(idx)
        gam1 = torch.einsum('TPij,ij->TP', j3, dfd.D)
        vj = (torch.einsum('P,TPij->Tij', c, j3)
              + torch.einsum('TQ,Qij->Tij', gam1 - m2 @ c, Psi))
        f = []
        for co, PsiC, kw in zip(dfd.cos, dfd.PsiC, kws):
            k1 = torch.einsum('TPio,Pjo->Tij', j3 @ co, PsiC)
            Z = (m2 @ PsiC.reshape(naux, -1)).reshape(T, naux, nao, -1)
            vk = k1 + k1.transpose(-1, -2) - torch.einsum('TPio,Pjo->Tij', Z,
                                                          PsiC)
            f.append(vj - kw * vk)
        out.append(torch.stack(f))
    return torch.cat(out, dim=1)


def _rows_df(dfd, chunks, dDs, kws):
    """(ij|P)'_t . dGamma_s + M'_t . dW_PQ,s, (3 natm (s), 3 natm (t)): the
    change of the DF gradient's weights along tangent s, through (ij|P), M
    and the density responses dDs (3 natm, nao, nao), one per occupied
    block of dfd with its exchange weight kw as _fock1's, contracted with
    the uncontracted first derivatives of every tangent t."""
    naux, nao, natm = dfd.naux, dfd.nao, dfd.natm
    D0, c, Psi = dfd.D, dfd.c, dfd.Psi
    rows = []
    for idx in chunks:
        T = len(idx)
        j3, m2 = dfd.tangent(idx)
        dPsi = j3.reshape(T, naux, -1) - m2 @ Psi.reshape(naux, -1)
        dPsi = (dfd.Minv @ dPsi).reshape(T, naux, nao, nao)
        del j3
        dDb = [dD[idx[0]:idx[-1] + 1] for dD in dDs]
        dDt = sum(dDb)
        dc = (torch.einsum('TPij,ij->TP', dPsi, D0)
              + torch.einsum('Pij,Tij->TP', Psi, dDt))
        dgam = (c[None, :, None, None] * dDt[:, None]
                + dc[:, :, None, None] * D0)
        dWpq = -0.5 * (dc[:, :, None] * c[None, None, :]
                       + c[None, :, None] * dc[:, None, :])
        for co, PsiC, O, dD, kw in zip(dfd.cos, dfd.PsiC, dfd.O, dDb, kws):
            Tm = torch.einsum('Tij,Pjo->TPio', dD, PsiC)
            Od = co.T @ dPsi @ co                       # (T, naux, no, no)
            ddp = torch.einsum('TPio,jo->TPij', Tm, co)
            dgam = dgam - kw * (ddp + ddp.transpose(-1, -2)
                                + co @ Od @ co.T)
            del ddp
            A = (torch.einsum('TPio,Qio->TPQ', Tm, PsiC)
                 + torch.einsum('TPop,Qop->TPQ', Od, O))
            dWpq = dWpq + 0.5 * kw * (A + A.transpose(-1, -2))
            del Tm, Od, A
        del dPsi
        prod = dfd.ip1[:, None] * dgam[None]           # (3, T, naux, n, n)
        r_ao = prod.sum(dim=(2, 4)).permute(1, 0, 2)    # (T, 3, nao)
        r_aux = prod.sum(dim=(3, 4)).permute(1, 0, 2)   # (T, 3, naux)
        del prod, dgam
        r_m = torch.einsum('xPQ,TPQ->TxP', dfd.ip2, dWpq)
        rows.append(2.0 * _rows_to_atoms(r_ao, dfd.ao2atom, natm)
                    + 2.0 * _rows_to_atoms(r_m - r_aux, dfd.aux2atom, natm))
    return torch.cat(rows)


def _xc_terms(mf, D, tangent_chunk, clock, reference_vxc):
    """The KS terms at the density D (nao, nao), or the spin density D (2,
    nao, nao): (V' (3 natm, nao, nao), or (2, 3 natm, nao, nao) of each
    spin's V_xc, and E_xc's fixed-D Hessian (3 natm, 3 natm)), timed as the
    phases 'xc_rows' and 'xc_F1'. V' is the derivative of V_xc at fixed D,
    symmetrised unless reference_vxc (the JAX package's unsymmetrised form,
    2 F)."""
    if mf.grids.coords is None:
        mf.grids.build()
    t = {}
    xc_hessian = (mf._numint.uks_xc_hessian if D.dim() == 3
                  else mf._numint.rks_xc_hessian)
    F, hxx = xc_hessian(mf.mol, mf.grids, mf.xc, D, 2 * tangent_chunk, t)
    V1 = 2.0 * F if reference_vxc else F + F.transpose(-1, -2)
    clock.lap('xc_F1')
    clock.out['xc_F1'] -= t['xc_rows']
    clock.out['xc_rows'] = t['xc_rows']
    return V1, hxx


# the ratio (nocc nvir)^2 / (3 natm nao^2) up to which CPHF's CG steps take
# the dense A_xc (_dense_fxc)
DENSE_FXC_RATIO = 16.0


def _dense_fxc(mol, nov):
    """True when CPHF's CG steps take the dense A_xc of nov = nocc nvir:
    it fits half the free memory (numint._budget), and its build, 8 nov^2
    npts operations, costs no more than the tangent route's steps, 4
    (3 natm) npts nao^2 operations each, so while nov^2 / (3 natm nao^2)
    is at most DENSE_FXC_RATIO. On an H100 the build took 0.54 of the
    tangent route's CG steps' time at benzene/def2-TZVP (ratio 10.0) and
    3.5 times it at C6F6/def2-TZVP (ratio 43.5); the power law through
    the two crosses 1 at 16 (PERF.md section 6)."""
    from ..dft.numint import _budget
    return (nov * nov <= DENSE_FXC_RATIO * 3 * mol.natm * mol.nao ** 2
            and 8 * nov * nov <= _budget(mol.device, 2))


def _xc_response(mf, D, Co, Cv, reference_vxc):
    """(the XC response dD -> (T, nao, nao) of G[dD], NumInt.rks_response
    symmetrised as _xc_terms's V'; the CG step's Mvo -> (T, nv, no) by the
    dense occupied-virtual A_xc of tdscf/rhf.py _fxc_ov where _dense_fxc
    takes it, else None), both on one set of the grid's AO values.
    reference_vxc takes the tangent alone: the reference's unsymmetrised
    form has no dense counterpart here."""
    ni = mf._numint
    no, nv = Co.shape[1], Cv.shape[1]
    dense = not reference_vxc and _dense_fxc(mf.mol, no * nv)
    gga = mf.xc_obj.is_gga
    aod, weights = ni.grid_ao(mf.mol, mf.grids, 1 if gga or dense else 0)
    resp = ni.rks_response(mf.xc, aod if gga or not dense
                           else [a[0] for a in aod], weights, D,
                           sym=not reference_vxc)
    if not dense:
        return resp, None
    from ..tdscf.rhf import _fxc_ov
    a_xc = _fxc_ov(mf, Co, Cv, aod, weights).reshape(no * nv, no * nv)

    def step(Mvo):
        T = Mvo.shape[0]
        x = Mvo.transpose(1, 2).reshape(T, no * nv)
        return (x @ a_xc).reshape(T, no, nv).transpose(1, 2)

    return resp, step


def hessian(mf, cphf_max_cycle=40, cphf_tol=1e-9, tangent_chunk=6,
            timings=None, reference_w=False, reference_vxc=False):
    """((natm, 3, natm, 3) numpy Hessian, CPHF iterations) of a converged
    DF-RHF or DF-RKS mean field; timings, if given, receives the seconds of
    the phases 's1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e', 'rows_df',
    'rows_3c' and 'rows_2c', and for DF-RKS 'xc_rows' (the AO values to the
    third derivative, xc_rks_hess and E_xc's fixed-D Hessian) and 'xc_F1'
    (xc_rks_deriv1 and dV_xc/dX); 'cphf' includes the XC response's
    set-up (A_xc, where _dense_fxc takes it).

    reference_w=True reproduces pyscf_tpu/hessian/rhf.py:316-323, whose dW
    keeps only the diagonal of its occupied block (the orbital energies'
    change) and drops the off-diagonal f'_ij - s'_ij (e_i + e_j)/2 of the
    canonical orbitals' rotation: that Hessian misses -S' . dW of it
    wherever there are two occupied orbitals or more (ROADMAP section 3).
    The tests hold the port to the reference with it; the default is the
    derivative of the gradient, which central differences confirm.

    reference_vxc=True (DF-RKS) takes the JAX package's unsymmetrised
    dE_xc/dD in F' and in CPHF's XC response, as pyscf_tpu/hessian/
    rhf.py:226-233,287 do (the module docstring says why it differs), with
    the tangent of V_xc in the CG steps."""
    mol = mf.mol
    dev = mol.device
    auxmol = mf.with_df.build().auxmol
    natm = mol.natm
    nt = 3 * natm
    isks = hasattr(mf, 'xc')
    hyb = mf._numint.rsh_and_hybrid_coeff(mf.xc)[2] if isks else 1.0
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
    if isks:
        V1, hxx_xc = _xc_terms(mf, co @ co.T, tangent_chunk, clock,
                               reference_vxc)
        h1 = h1 + V1
        del V1
    dfd = _DFDerivs(mol, auxmol, B, mf.with_df.whitener, [co])
    clock.lap('ip1_3c')

    chunks = tangent_chunks(nt, tangent_chunk)
    F1 = h1 + _fock1(dfd, chunks, [0.5 * hyb])[0]
    clock.lap('F1')

    # CPHF (pyscf_tpu/hessian/rhf.py:275-315)
    s1_oo = Co.T @ s1 @ Co                              # (nt, no, no)
    s1_vo = Cv.T @ s1 @ Co
    f1_vo = Cv.T @ F1 @ Co
    vxc = step = None
    if isks:
        vxc, step = _xc_response(mf, co @ co.T, Co, Cv, reference_vxc)
    g = _mo_response(B, [(Co, Cv)], 0.5 * hyb, vxc)
    zero_vo = torch.zeros((nt, nv, no), **f64)
    g_oo_vo = g([-2.0 * s1_oo], [zero_vo])[0][0]
    ediff = ev[:, None] - eo[None, :]
    rhs = (-f1_vo - g_oo_vo + s1_vo * eo).permute(1, 2, 0)
    zero_oo = torch.zeros((1, no, no), **f64)

    def matvec(u):
        Mvo = 2.0 * u.permute(2, 0, 1)
        gvo = g([zero_oo.expand(u.shape[2], no, no)], [Mvo],
                step is None)[0][0]
        if step is not None:
            gvo = gvo + step(Mvo)
        return ediff[:, :, None] * u + gvo.permute(1, 2, 0)

    U, _, cycles = cphf_pcg(matvec, rhs, ediff, cphf_max_cycle, cphf_tol)
    U = U.permute(2, 0, 1)                              # (nt, nv, no)
    half = Cv @ U @ Co.T
    dD = 2.0 * (half + half.transpose(-1, -2)) - 2.0 * Co @ s1_oo @ Co.T
    g_oo = g([-2.0 * s1_oo], [2.0 * U])[1][0]
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

    H += _rows_df(dfd, chunks, [dD], [0.5 * hyb])
    clock.lap('rows_df')

    _, gamma, Wpq = grad_df.fitted_weights(mf, dm, cos, kfac)
    hxx += _hess_3c(mol, auxmol, gamma)
    del gamma
    clock.lap('rows_3c')
    hxx += _hess_2c(auxmol, Wpq)
    clock.lap('rows_2c')
    hxx = hxx.reshape(natm, natm, 3, 3).permute(0, 2, 1, 3).reshape(nt, nt)
    if isks:
        hxx = hxx + hxx_xc
    H = H + hxx
    H = 0.5 * (H + H.T)
    h = H.cpu().numpy().reshape(natm, 3, natm, 3) + hess_nuc(mol)
    return h, cycles
