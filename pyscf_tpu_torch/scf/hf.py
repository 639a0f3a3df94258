"""Restricted Hartree-Fock, density-fitted or with in-core ERIs.

Counterpart of pyscf_tpu/scf/hf.py (SCF, RHF): get_hcore, get_ovlp, the
'minao' and 'hcore' guesses, density_fit, _get_eri, both branches of
RHF._fused_veff, and _kernel_staged as `kernel`: one host loop drives the
cycle functions of scf/fused.py; RHF.Gradients / nuc_grad_method lead to
grad/rhf.py, RHF.MP2 and RHF.CCSD to mp/mp2.py and cc/ccsd.py, RHF.TDA and RHF.TDHF to
tdscf/rhf.py; dip_moment, quad_moment, mulliken_pop and analyze are the
JAX package's analysis (hf.py:559-621). Unlike the JAX package, a failing
minao guess raises instead of falling back to the core-Hamiltonian guess.

J and K come from the DF factor, or from the dense in-core ERI tensor
(nao, nao, nao, nao): `_eri` as the caller assigned it, else built once by
mol.intor('int2e') (kernel `int2e`). J is one GEMV on the tensor; K is a
batched GEMV on the same tensor, so the in-core path holds one copy of it.
A range-separated functional's long-range K takes the same forms on the
erf(omega r)/r factor (_df_lr, kernels int2c2e_lr and int3c2e_lr) or
tensor (_get_eri(omega), kernel int2e_lr), each built once per omega.

Runs on mol.device. `timings` holds the seconds of each phase of the last
kernel() (hcore, j2c, j3c or eri, guess, scf_loop; RKS and UKS add grids
and ao, and a range-separated functional j2c_lr and j3c_lr or eri_lr),
each ended by a device synchronize.
"""
import time

import numpy as np
import torch

from ..lib.linalg import canonical_orth, eigh_gen
from ..lib.parameters import DEBYE
from ..ops.integrals.j3c import sync
from . import fused


def get_hcore(mol):
    from ..ops.integrals.j1e import hcore_parts
    stv = hcore_parts(mol)
    return stv[1] + stv[2]


def get_ovlp(mol):
    from ..ops.integrals.j1e import hcore_parts
    return hcore_parts(mol)[0]


def get_occ_rhf(mo_energy, nocc):
    """Aufbau occupation: 2 electrons in each of the nocc lowest orbitals."""
    occ = torch.zeros_like(mo_energy)
    occ[torch.argsort(mo_energy)[:nocc]] = 2.0
    return occ


class SCF:
    conv_tol = 1e-10
    conv_tol_grad = None
    max_cycle = 100
    diis_space = 8
    init_guess = 'minao'
    lindep_thresh = 1e-8

    def __init__(self, mol):
        self.mol = mol
        self.verbose = mol.verbose
        self.converged = False
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.scf_cycles = 0
        self.with_df = None
        self._eri = None
        self._eri_lr = {}           # omega -> the erf(omega r)/r tensor
        self.timings = {}
        self._veff_timings = {}     # set-up phases of the last _veff_fns()

    def get_hcore(self, mol=None):
        return get_hcore(mol or self.mol)

    def get_ovlp(self, mol=None):
        return get_ovlp(mol or self.mol)

    def get_occ(self, mo_energy, mo_coeff=None):
        return get_occ_rhf(mo_energy, self.mol.nelectron // 2)

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return (c * o[None, :]) @ c.T

    def energy_nuc(self):
        return self.mol.energy_nuc()

    def get_init_guess(self, mol=None, key=None):
        mol = mol or self.mol
        key = key or self.init_guess
        if key in ('hcore', '1e'):
            return self.init_guess_by_1e(mol)
        if key == 'minao':
            from .init_guess import init_guess_by_minao
            return init_guess_by_minao(mol)
        raise NotImplementedError(f'init_guess {key}')

    def init_guess_by_1e(self, mol=None):
        mol = mol or self.mol
        x = canonical_orth(self.get_ovlp(mol), self.lindep_thresh)
        mo_energy, mo_coeff = eigh_gen(self.get_hcore(mol), x)
        return self.make_rdm1(mo_coeff, self.get_occ(mo_energy, mo_coeff))

    def density_fit(self, auxbasis=None):
        from ..df.df_jk import density_fit
        return density_fit(self, auxbasis)

    def _get_eri(self, omega=None):
        """The in-core ERI tensor: `_eri` if assigned, else built once; with
        omega, the erf(omega r)/r tensor, built once per omega
        (ops/integrals/j2e.py int2e_dense, kernel int2e_lr)."""
        if omega:
            if omega not in self._eri_lr:
                from ..ops.integrals.j2e import int2e_dense
                t0 = time.perf_counter()
                self._eri_lr[omega] = int2e_dense(self.mol, omega)
                sync(self.mol.device)
                self._veff_timings['eri_lr'] = time.perf_counter() - t0
            return self._eri_lr[omega]
        if self._eri is None:
            t0 = time.perf_counter()
            self._eri = self.mol.intor('int2e')
            sync(self.mol.device)
            self._veff_timings['eri'] = time.perf_counter() - t0
        return self._eri

    def _df_lr(self, omega):
        """The DF object of the erf(omega r)/r metric and rows in the mean
        field's aux basis (pyscf_tpu/scf/hf.py:160-169), built once per
        Mole and omega (DF's cache)."""
        from ..df.df import DF
        return DF(self.mol, self.with_df.auxbasis, omega).build()

    def _jk_fns(self, omega=None):
        """(get_j(dm), get_k(dm, co=None)): DF-J/K on the factor B, K from
        the occupied factor co (scaled by the square root of its
        occupation) when given; or GEMVs on the in-core ERI tensor. With
        omega, the same on the erf(omega r)/r factor or tensor: the
        long-range K of a range-separated functional."""
        if self.with_df is not None:
            from ..df.df_jk import j_from_dm, k_from_dm, k_from_mo
            dfobj = self._df_lr(omega) if omega else self.with_df
            B = dfobj.cderi
            self._veff_timings.update(dfobj.timings)

            def get_k(dm, co=None):
                return k_from_dm(B, dm) if co is None else k_from_mo(B, co)

            return (lambda dm: j_from_dm(B, dm)), get_k
        eri = self._get_eri(omega)
        n = eri.shape[0]
        eri_j = eri.reshape(n * n, n * n)

        def get_k(dm, co=None):
            # K_ij = sum_kl (ik|jl) dm_kl: one GEMV per (i, k) on the
            # tensor's own layout, then a sum over k
            return (eri @ dm[None, :, :, None]).sum(1).squeeze(-1)

        return (lambda dm: (eri_j @ dm.T.reshape(-1)).reshape(n, n)), get_k

    def _cycle_fns(self, veff_fn, veff_dm_fn, h1e, s1e, x):
        """(seed(dm0), cycle(co, fh, eh, cyc), finalize(co), DIIS slot
        shape) of the restricted cycle in scf/fused.py."""
        nocc = self.mol.nelectron // 2
        return (lambda dm: fused.seed(veff_dm_fn, h1e, x, dm, nocc),
                lambda co, fh, eh, cyc: fused.cycle(
                    veff_fn, h1e, s1e, x, co, fh, eh, cyc, nocc),
                lambda co: fused.finalize(veff_fn, h1e, x, co, nocc),
                h1e.shape)

    def kernel(self, dm0=None):
        """Converge the SCF from dm0 (or the init_guess); returns e_tot."""
        mol = self.mol
        dev = mol.device
        self._veff_timings = {}
        veff_fn, veff_dm_fn = self._veff_fns()
        conv_tol_grad = (np.sqrt(self.conv_tol) if self.conv_tol_grad is None
                         else self.conv_tol_grad)
        t0 = time.perf_counter()
        s1e = self.get_ovlp(mol)
        h1e = self.get_hcore(mol)
        x = canonical_orth(s1e, self.lindep_thresh)
        sync(dev)
        t1 = time.perf_counter()
        dm = dm0 if dm0 is not None else self.get_init_guess(mol)
        sync(dev)
        t2 = time.perf_counter()
        timings = {'hcore': t1 - t0, 'guess': t2 - t1}
        timings.update(self._veff_timings)

        t3 = time.perf_counter()
        seed, cycle, finalize, shape = self._cycle_fns(veff_fn, veff_dm_fn,
                                                       h1e, s1e, x)
        co = seed(dm)
        fh = torch.zeros((self.diis_space,) + tuple(shape), dtype=h1e.dtype,
                         device=dev)
        eh = torch.zeros_like(fh)
        e_last = 0.0
        conv = False
        ncyc = 0
        for cyc in range(self.max_cycle):
            co, e_elec, gnorm = cycle(co, fh, eh, cyc)
            e_elec, gnorm = torch.stack([e_elec, gnorm]).tolist()
            de = abs(e_elec - e_last)
            e_last = e_elec
            ncyc = cyc + 1
            if self.verbose >= 5:
                print(f'cycle= {ncyc} E_elec= {e_elec:.12g} '
                      f'delta_E= {de:.3g} |g|= {gnorm:.3g}')
            if de < self.conv_tol and gnorm < conv_tol_grad:
                conv = True
                break
        e_elec, moe, moc, _ = finalize(co)
        self.converged = conv
        self.scf_cycles = ncyc
        self.e_tot = float(e_elec) + self.energy_nuc()
        self.mo_energy = moe
        self.mo_coeff = moc
        self.mo_occ = self.get_occ(moe, moc)
        sync(dev)
        timings['scf_loop'] = time.perf_counter() - t3
        self.timings = timings
        return self.e_tot

    # ---- analysis (pyscf_tpu/scf/hf.py:559-621) ----------------------------
    def dip_moment(self, mol=None, dm=None, unit='Debye'):
        """Dipole moment (3,) numpy about the coordinate origin: -tr(r dm)
        of the electrons (mol.intor('int1e_r'), kernel `int1e_r`) plus
        sum_A Z_A R_A; in Debye unless unit is 'au'."""
        mol = mol or self.mol
        if dm is None:
            dm = self.make_rdm1()
        el = -torch.einsum('xij,ji->x', mol.intor('int1e_r'), dm)
        nuc = np.einsum('a,ax->x', np.asarray(mol.charges, dtype=np.float64),
                        mol.coords)
        mu = el.cpu().numpy() + nuc
        if unit.lower().startswith('d'):
            mu = mu * DEBYE
        return mu

    def quad_moment(self, mol=None, dm=None):
        """Traceless quadrupole moment (3, 3) numpy in a.u. about the
        coordinate origin: q = sum_A Z_A R_A R_A - sum_g w r r rho on the
        default grid (AO values by kernel `eval_ao`, in blocks), returned
        as 3/2 q - 1/2 tr(q) I."""
        from ..dft import gen_grid
        from ..dft.numint import _block_size
        from ..ops.eval_gto import eval_ao
        mol = mol or self.mol
        if dm is None:
            dm = self.make_rdm1()
        grids = gen_grid.Grids(mol).build()
        n = grids.size
        blk = _block_size(n, mol.nao, 2, mol.device)
        el = torch.zeros((3, 3), dtype=torch.float64, device=mol.device)
        for i in range(0, n, blk):
            c = grids.coords[i:i + blk]
            ao = eval_ao(mol, c, 0)
            rho = torch.einsum('gi,gi->g', ao @ dm, ao)
            el -= torch.einsum('g,gx,gy,g->xy', grids.weights[i:i + blk], c,
                               c, rho)
        z = np.asarray(mol.charges, dtype=np.float64)
        q = el.cpu().numpy() + np.einsum('a,ax,ay->xy', z, mol.coords,
                                         mol.coords)
        return 1.5 * q - 0.5 * np.trace(q) * np.eye(3)

    def mulliken_pop(self, mol=None, dm=None, s=None):
        """(pop (nao,), chg (natm,)) numpy: the Mulliken populations
        (dm S)_ii and each atom's charge Z_A less its AOs' populations."""
        from ..grad.rhf import _ao2atom_map
        mol = mol or self.mol
        if dm is None:
            dm = self.make_rdm1()
        if s is None:
            s = self.get_ovlp(mol)
        pop = torch.einsum('ij,ji->i', dm, s).cpu().numpy()
        chg = np.array(mol.charges, dtype=float)
        np.subtract.at(chg, _ao2atom_map(mol), pop)
        return pop, chg

    def analyze(self):
        """Print the energy, the Mulliken charges and the dipole; returns
        (pop, chg, mu) as numpy."""
        pop, chg = self.mulliken_pop()
        mu = self.dip_moment()
        print('SCF summary: E_tot = %.12f  converged = %s'
              % (self.e_tot, self.converged))
        print('Mulliken charges:')
        for ia, c in enumerate(chg):
            print('  atom %d %-2s  charge % .5f'
                  % (ia, self.mol.elements_[ia], c))
        print('Dipole moment (Debye): %.5f %.5f %.5f  |mu| = %.5f'
              % (*mu, np.linalg.norm(mu)))
        return pop, chg, mu

    def Hessian(self):
        """The nuclear Hessian object of hessian.Hessian (the dispatcher:
        analytic for DF-RHF, DF-RKS, DF-UHF and DF-UKS, finite differences
        where the reference uses them)."""
        from ..hessian import Hessian
        return Hessian(self)

    def run(self, dm0=None):
        """kernel(dm0), then the mean field itself, so that calls chain as
        in PySCF: mol.RHF().run().nuc_grad_method().kernel(). (In the JAX
        package `run` is an alias of kernel and returns the energy.)"""
        self.kernel(dm0)
        return self


class RHF(SCF):
    def __init__(self, mol):
        if mol.nelectron % 2 != 0 or mol.spin != 0:
            raise RuntimeError('RHF requires closed-shell molecule')
        super().__init__(mol)

    def _veff_fns(self):
        """(veff_fn(dm, co), veff_dm_fn(dm)) -> (vhf, e2)."""
        get_j, get_k = self._jk_fns()

        def veff(dm, co=None):
            vhf = get_j(dm) - 0.5 * get_k(dm, co)
            return vhf, 0.5 * torch.sum(vhf * dm)

        return veff, veff

    def Gradients(self):
        from ..grad import rhf as rhf_grad
        return rhf_grad.Gradients(self)

    def nuc_grad_method(self):
        return self.Gradients()

    # post-HF constructors (pyscf_tpu/scf/hf.py:713-719)
    def MP2(self, **kwargs):
        from ..mp import MP2
        return MP2(self, **kwargs)

    def CCSD(self, **kwargs):
        from ..cc import CCSD
        return CCSD(self, **kwargs)

    # excited states (pyscf_tpu/scf/hf.py:729-735)
    def TDA(self, **kwargs):
        from ..tdscf import TDA
        return TDA(self, **kwargs)

    def TDHF(self, **kwargs):
        from ..tdscf import TDHF
        return TDHF(self, **kwargs)
