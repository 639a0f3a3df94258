"""Analytic RHF nuclear gradients with in-core derivative integrals.

Counterpart of pyscf_tpu/grad/rhf.py: _ao2atom_map, grad_nuc, grad_elec,
Gradients and finite_difference_gradient.

    de[A] = 2 tr(h1[:, A rows] dm) + Z_A tr(iprinv_A dm)
            - 2 tr(ipovlp[:, A rows] dme) + 2 tr(vhf[:, A rows] dm)
            + grad_nuc[A]
    h1 = ipkin + ipnuc;  vhf = vj - vk/2;  vj = ip1.dm (lk),  vk = ip1.dm (jk)

The derivative integrals come from the kernels int1e_ip, int1e_iprinv (all
atoms in one launch per class) and int2e_ip1; the contractions run on
mol.device (the JAX package does them with numpy on the host). vj and vk
are GEMVs on the (3, nao, nao, nao, nao) tensor's own layout, so no
permuted copy of it is made.

The JAX package sends density-fitted objects to jax.grad of a rebuilt
energy. A hand-written kernel has no backward: a DF object raises
NotImplementedError here until the derivative kernels of (ij|P) and (P|Q)
are ported.
"""
import time

import numpy as np
import torch

from ..ops.integrals.j3c import sync


def _ao2atom_map(mol):
    ao2atom = np.zeros(mol.nao, dtype=np.int64)
    for l, g in mol.shell_groups.items():
        for off, ia in zip(g.ao_off, g.atom_ids):
            ao2atom[off:off + 2 * l + 1] = ia
    return ao2atom


def grad_nuc(mol):
    """Nuclear-repulsion part of the gradient, (natm, 3) numpy."""
    z = np.asarray(mol.charges, dtype=float)
    r = np.asarray(mol.coords)
    d = r[:, None, :] - r[None, :, :]
    dist = np.linalg.norm(d, axis=2)
    np.fill_diagonal(dist, np.inf)
    # dE/dR_A = -sum_B Z_A Z_B (R_A - R_B)/|R_A - R_B|^3
    return -np.einsum('a,b,abx->ax', z, z, d / dist[:, :, None] ** 3)


def refuse_df(mf):
    if mf.with_df is not None:
        raise NotImplementedError(
            'gradients of density-fitted mean fields need the derivative '
            'kernels of (ij|P) on the bra and aux centres, of (P|Q) and of '
            'the XC quadrature, which are not ported; drop .density_fit() '
            'for the conventional gradient')


def grad_elec(mf, mo_energy=None, mo_coeff=None, mo_occ=None, timings=None):
    """Electronic part of the RHF gradient, (natm, 3) numpy.

    timings, if given, receives the seconds of the one-electron derivative
    integrals ('int1e_ip'), of the int2e_ip1 tensor ('int2e_ip1') and of
    the contractions ('contract'), each ended by a device synchronize."""
    from ..ops.integrals import int1e_deriv
    mol = mf.mol
    dev = mol.device

    def on_dev(x, default):
        x = default if x is None else x
        if not torch.is_tensor(x):
            x = torch.tensor(np.array(x, dtype=np.float64))
        return x.to(device=dev, dtype=torch.float64)

    mo_e = on_dev(mo_energy, mf.mo_energy)
    mo_c = on_dev(mo_coeff, mf.mo_coeff)
    mo_o = on_dev(mo_occ, mf.mo_occ)
    dm = mf.make_rdm1(mo_c, mo_o)
    occ = mo_o > 0
    dme = (mo_c[:, occ] * (mo_e[occ] * mo_o[occ])) @ mo_c[:, occ].T

    t0 = time.perf_counter()
    ipovlp, ipkin, ipnuc = int1e_deriv.ip_parts(mol)     # <d mu | nu>
    iprinv = int1e_deriv.int1e_iprinv(mol, mol.coords)   # (natm, 3, n, n)
    sync(dev)
    t1 = time.perf_counter()
    ip1 = mol.intor('int2e_ip1')                         # (3, d mu, nu|la,si)
    sync(dev)
    t2 = time.perf_counter()

    n = mol.nao
    # vj[x,i,j] = sum_kl ip1[x,i,j,k,l] dm[l,k]; vk[x,i,l] = sum_jk
    # ip1[x,i,j,k,l] dm[j,k]: a GEMV per (x, i) on the (j k, l) block
    vj = (ip1.reshape(3 * n * n, n * n) @ dm.T.reshape(-1)).reshape(3, n, n)
    vk = (dm.reshape(1, 1, 1, n * n) @ ip1.reshape(3, n, n * n, n)).squeeze(2)
    del ip1
    vhf = vj - 0.5 * vk
    # bra derivative, dm symmetric: 2 <d mu|h + vhf|nu> dm - 2 <d mu|nu> dme
    rows = 2.0 * (torch.einsum('xij,ij->ix', ipkin + ipnuc + vhf, dm)
                  - torch.einsum('xij,ij->ix', ipovlp, dme))
    de = torch.zeros((mol.natm, 3), dtype=torch.float64, device=dev)
    de.index_add_(0, torch.as_tensor(_ao2atom_map(mol), device=dev), rows)
    # Hellmann-Feynman operator term (full matrix sum, no bra/ket factor)
    z = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    de += z[:, None] * torch.einsum('axij,ij->ax', iprinv, dm)
    de = de.cpu().numpy()
    if timings is not None:
        timings.update({'int1e_ip': t1 - t0, 'int2e_ip1': t2 - t1,
                        'contract': time.perf_counter() - t2})
    return de


class Gradients:
    """mf.nuc_grad_method(): kernel() returns de (natm, 3) in Ha/Bohr and
    leaves the phase seconds of the last call in `timings`."""

    def __init__(self, mf):
        self._scf = mf
        self.mol = mf.mol
        self.de = None
        self.timings = {}

    def grad_nuc(self):
        return grad_nuc(self.mol)

    def grad_elec(self):
        self.timings = {}
        return grad_elec(self._scf, timings=self.timings)

    def kernel(self):
        refuse_df(self._scf)
        self.de = self.grad_elec() + self.grad_nuc()
        return self.de

    run = kernel


def finite_difference_gradient(mf_factory, mol, step=1e-4, coords=None):
    """Central-difference gradient of any energy method, (natm, 3) numpy.

    mf_factory(mol) returns the energy of a moved copy of mol. coords, if
    given, lists the (atom, direction) pairs to differentiate; the other
    entries stay zero."""
    coords0 = np.asarray(mol.coords).copy()
    de = np.zeros((mol.natm, 3))
    if coords is None:
        coords = [(A, x) for A in range(mol.natm) for x in range(3)]
    for A, x in coords:
        for sign in (1.0, -1.0):
            c = coords0.copy()
            c[A, x] += sign * step
            de[A, x] += sign * mf_factory(mol.copy().set_geom_(c))
    return de / (2 * step)
