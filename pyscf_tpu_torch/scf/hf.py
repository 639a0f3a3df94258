"""Restricted Hartree-Fock with density fitting.

Counterpart of pyscf_tpu/scf/hf.py (SCF, RHF): get_hcore, get_ovlp, the
'minao' and 'hcore' guesses, density_fit, the DF branch of
RHF._fused_veff, and _kernel_staged as `kernel`: one host loop drives the
cycle functions of scf/fused.py. Unlike the JAX package, a failing minao
guess raises instead of falling back to the core-Hamiltonian guess.

J and K come from the DF factor, or from an in-core ERI tensor
(nao, nao, nao, nao) assigned to `_eri` as in PySCF: the port has no 4c
integral kernel yet (ROADMAP.md queue 1 step 8).

Runs on mol.device. `timings` holds the seconds of each phase of the last
kernel() (hcore, j2c, j3c, guess, scf_loop; RKS adds grids and ao), each
ended by a device synchronize.
"""
import time

import numpy as np
import torch

from ..lib.linalg import canonical_orth, eigh_gen
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
        nocc = mol.nelectron // 2
        nao, space = mol.nao, self.diis_space
        co = fused.seed(veff_dm_fn, h1e, x, dm, nocc)
        fh = torch.zeros((space, nao, nao), dtype=h1e.dtype, device=dev)
        eh = torch.zeros_like(fh)
        e_last = 0.0
        conv = False
        ncyc = 0
        for cyc in range(self.max_cycle):
            co, e_elec, gnorm = fused.cycle(veff_fn, h1e, s1e, x, co, fh, eh,
                                            cyc, nocc)
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
        e_elec, moe, moc, _ = fused.finalize(veff_fn, h1e, x, co, nocc)
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


class RHF(SCF):
    def __init__(self, mol):
        if mol.nelectron % 2 != 0 or mol.spin != 0:
            raise RuntimeError('RHF requires closed-shell molecule')
        super().__init__(mol)

    def _jk_fns(self):
        """(get_j(dm), get_k(dm, co=None)): DF-J/K on the factor B, K from
        the occupied factor co when given; or contractions of `_eri`."""
        if self.with_df is not None:
            from ..df.df_jk import j_from_dm, k_from_dm, k_from_mo
            B = self.with_df.cderi
            self._veff_timings.update(self.with_df.timings)

            def get_k(dm, co=None):
                return k_from_dm(B, dm) if co is None else k_from_mo(B, co)

            return (lambda dm: j_from_dm(B, dm)), get_k
        if self._eri is None:
            raise NotImplementedError(
                'in-core ERIs are not ported (ROADMAP.md queue 1 step 8): '
                'call .density_fit() or assign an ERI tensor to _eri')
        eri = self._eri
        return (lambda dm: torch.einsum('ijkl,lk->ij', eri, dm),
                lambda dm, co=None: torch.einsum('ilkj,lk->ij', eri, dm))

    def _veff_fns(self):
        """(veff_fn(dm, co), veff_dm_fn(dm)) -> (vhf, e2)."""
        get_j, get_k = self._jk_fns()

        def veff(dm, co=None):
            vhf = get_j(dm) - 0.5 * get_k(dm, co)
            return vhf, 0.5 * torch.sum(vhf * dm)

        return veff, veff
