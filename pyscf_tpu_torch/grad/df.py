"""Analytic nuclear gradients of density-fitted RHF, RKS, UHF and UKS.

Counterpart of pyscf_tpu/grad/autodiff.py build_grad_fn (:259) and
grad_scf (:363). The JAX package takes jax.value_and_grad of an energy
rebuilt from the DF intermediates; here the same derivative is written out,
with the densities held fixed (D, the occupied orbitals co scaled by
sqrt(occ), the energy-weighted density W_e) and kfac, hyb as in
autodiff.py:289-290:

    u = B.D = L^-1 gamma,  c = L^-T u        gamma_P = sum_ij D_ij (ij|P)
    V = co^T B co = L^-1 O,  Y = L^-T V      per spin, (naux, no, no)
    Gamma^P_ij = D_ij c_P - 2 kfac hyb sum_spin (co Y_P co^T)_ij
    W_PQ = -1/2 c_P c_Q + kfac hyb sum_spin sum_op Y_P^op Y_Q^op
    dE/dX = d E_nuc + 1e terms (grad_1e) + sum (ij|P)' Gamma^P_ij
            + sum (P|Q)' W_PQ + dE_xc/dX (grid held fixed)

B and the whitener (L^-1)^T come from the SCF's DF cache (df/df.py), so
nothing that is not differentiated is recomputed; c, Y, Gamma and W are
torch GEMMs on mol.device. The derivative integrals are the kernels
int3c2e_ip and int2c2e_ip1 (ops/integrals/j3c_deriv.py), the XC term the
kernels eval_ao (deriv 2) and xc_rks_grad (dft/numint.py rks_grad) or, for
two spins, xc_uks_grad (numint.py uks_grad). No
(3, naux, nao, nao) tensor is built; Gamma is (naux, nao, nao).
"""
import time

import torch

from ..ops.integrals import j3c_deriv
from ..ops.integrals.j3c import sync
from .rhf import ao_rows_to_atoms, energy_weighted_dm, grad_1e, grad_nuc

def check_functional(mf):
    """NotImplementedError for a range-separated or VV10 functional: the
    reference's gradient (pyscf_tpu/grad/autodiff.py:259-311 build_grad_fn)
    reads neither rsh_coeff nor nlc, so it is not the energy's gradient
    there, and the port has no other to hold these terms to yet."""
    if not hasattr(mf, 'xc'):
        return
    if mf.xc_obj.omega or mf.nlc:
        raise NotImplementedError(
            f'nuclear gradients of {mf.xc!r} (nlc {mf.nlc!r}) are not '
            'ported: the long-range K and VV10 terms have no reference '
            '(pyscf_tpu/grad/autodiff.py:259-311 leaves them out)')


def occupied(mf):
    """(dm, [co per spin], dme, kfac): the total density, the occupied
    orbitals scaled by sqrt(occ), the energy-weighted density and the
    exchange factor of E_K = -kfac hyb sum_spin |V_spin|^2."""
    moe, moc, occ = mf.mo_energy, mf.mo_coeff, mf.mo_occ
    if occ.dim() == 1:
        sel = occ > 0
        co = moc[:, sel] * torch.sqrt(occ[sel])
        return mf.make_rdm1(), [co], energy_weighted_dm(moe, moc, occ), 0.25
    cos = [moc[s][:, occ[s] > 0] * torch.sqrt(occ[s][occ[s] > 0])
           for s in (0, 1)]
    dme = sum(energy_weighted_dm(moe[s], moc[s], occ[s]) for s in (0, 1))
    dm = mf.make_rdm1()
    return dm[0] + dm[1], cos, dme, 0.5


def fitted_weights(mf, dm, cos, kfac):
    """(e2, Gamma (naux, nao, nao), W (naux, naux)) of the densities dm and
    cos on mf's DF factor, aux in AO order: the two-electron energy
    1/2 u.u - kfac hyb sum_spin |V|^2 and the weights of (ij|P)' and
    (P|Q)' in its derivative."""
    isks = hasattr(mf, 'xc')
    hyb = mf.xc_obj.hyb if isks else 1.0
    B, linv_t = mf.with_df.cderi, mf.with_df.whitener
    naux, nao = B.shape[0], B.shape[1]
    u = B.reshape(naux, nao * nao) @ dm.reshape(-1)
    c = linv_t @ u
    e2 = 0.5 * torch.dot(u, u)
    gamma = c[:, None, None] * dm
    W = -0.5 * torch.outer(c, c)
    if not isks or hyb != 0.0:
        for co in cos:
            no = co.shape[1]
            V = co.T @ (B @ co)                               # (naux, no, no)
            Y = linv_t @ V.reshape(naux, no * no)
            e2 = e2 - kfac * hyb * torch.sum(V * V)
            gamma -= (2.0 * kfac * hyb) * (co @ Y.reshape(naux, no, no)
                                           @ co.T)
            W += (kfac * hyb) * (Y @ Y.T)
    return e2, gamma, W


def grad_scf(mf, timings=None):
    """(e_chk, de (natm, 3) numpy in Ha/Bohr) of a converged DF-RHF,
    DF-RKS, DF-UHF or DF-UKS mean field; e_chk is the energy rebuilt from
    the gradient's own intermediates, for the caller's check against
    mf.e_tot.

    timings, if given, receives the seconds of the one-electron part
    ('int1e_ip'), of c, Y, Gamma and W ('contract'), of the two derivative
    integral kernels ('int3c2e_ip', 'int2c2e_ip1') and, for KS, of the AO
    values ('ao2') and the XC gradient ('xc_grad'), each ended by a device
    synchronize."""
    check_functional(mf)
    mol = mf.mol
    dev = mol.device
    isks = hasattr(mf, 'xc')
    dm, cos, dme, kfac = occupied(mf)
    t = {}

    t0 = time.perf_counter()
    de = grad_1e(mol, dm, dme)
    sync(dev)
    t1 = time.perf_counter()
    e2, gamma, W = fitted_weights(mf, dm, cos, kfac)
    sync(dev)
    t2 = time.perf_counter()
    de += j3c_deriv.grad_3c(mol, mf.with_df.auxmol, gamma)
    del gamma
    sync(dev)
    t3 = time.perf_counter()
    de += j3c_deriv.grad_2c(mf.with_df.auxmol, W)
    sync(dev)
    t.update(int1e_ip=t1 - t0, contract=t2 - t1, int3c2e_ip=t3 - t2,
             int2c2e_ip1=time.perf_counter() - t3)
    exc = 0.0
    if isks:
        if len(cos) == 2:
            exc, g = mf._numint.uks_grad(mol, mf.grids, mf.xc,
                                         mf.make_rdm1(), t)
        else:
            exc, g = mf._numint.rks_grad(mol, mf.grids, mf.xc, dm, t)
        de += ao_rows_to_atoms(mol, g)
    e_chk = (mol.energy_nuc() + float(torch.sum(mf.get_hcore() * dm))
             + float(e2) + float(exc))
    if timings is not None:
        timings.update(t)
    return e_chk, de.cpu().numpy() + grad_nuc(mol)
