"""Unrestricted Hartree-Fock.

Counterpart of pyscf_tpu/scf/uhf.py (UHF) with its analysis methods: the
density is a stacked (2, nao, nao) tensor [dm_alpha, dm_beta]; J of the
total density and K of each spin come from the DF factor (K from each
spin's occupied factor in the cycle) or from the in-core ERI tensor, as in
the two branches of UHF._fused_veff. The cycle is scf/fused.py's seed_u,
cycle_u and finalize_u under SCF.kernel's host loop.
"""
import numpy as np
import torch

from ..lib.linalg import canonical_orth, eigh_gen
from . import fused
from .hf import SCF


class UHF(SCF):
    def _veff_fns(self):
        """(veff_fn(dm, cos), veff_dm_fn(dm)) -> (vhf (2, n, n), e2) with
        cos = (coa, cob) the occupied factors, or None."""
        get_j, get_k = self._jk_fns()

        def veff(dm, cos=None):
            vj = get_j(dm[0] + dm[1])
            vka = get_k(dm[0], None if cos is None else cos[0])
            vkb = get_k(dm[1], None if cos is None else cos[1])
            vhf = torch.stack([vj - vka, vj - vkb])
            return vhf, 0.5 * (torch.sum(vhf[0] * dm[0])
                               + torch.sum(vhf[1] * dm[1]))

        return veff, veff

    def _cycle_fns(self, veff_fn, veff_dm_fn, h1e, s1e, x):
        na, nb = self.mol.nelec
        return (lambda dm: fused.seed_u(veff_dm_fn, h1e, x, dm, na, nb),
                lambda cos, fh, eh, cyc: fused.cycle_u(
                    veff_fn, h1e, s1e, x, cos, fh, eh, cyc, na, nb),
                lambda cos: fused.finalize_u(veff_fn, h1e, s1e, x, cos, na,
                                             nb),
                (2,) + tuple(h1e.shape))

    def get_occ(self, mo_energy, mo_coeff=None):
        """Aufbau occupation of each spin: (2, nao) of ones and zeros."""
        occ = torch.zeros_like(mo_energy)
        for s, n in enumerate(self.mol.nelec):
            occ[s, torch.argsort(mo_energy[s])[:n]] = 1.0
        return occ

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return torch.stack([(c[s] * o[s][None, :]) @ c[s].T for s in (0, 1)])

    def energy_elec(self, dm, h1e, vhf):
        e1 = torch.einsum('ij,sji->', h1e, dm)
        e2 = 0.5 * torch.einsum('sij,sji->', vhf, dm)
        return float(e1 + e2)

    def get_init_guess(self, mol=None, key=None):
        """A 2-D guess is split into alpha and beta by na/ne and nb/ne."""
        dm = super().get_init_guess(mol, key)
        if dm.dim() == 2:
            na, nb = self.mol.nelec
            ne = max(self.mol.nelectron, 1)
            dm = torch.stack([dm * (na / ne), dm * (nb / ne)])
        return dm

    def init_guess_by_1e(self, mol=None):
        mol = mol or self.mol
        x = canonical_orth(self.get_ovlp(mol), self.lindep_thresh)
        e, c = eigh_gen(self.get_hcore(mol), x)
        mo_energy = torch.stack([e, e])
        mo_coeff = torch.stack([c, c])
        return self.make_rdm1(mo_coeff, self.get_occ(mo_energy, mo_coeff))

    def spin_square(self, mo_coeff=None, mo_occ=None, s=None):
        """(<S^2>, 2S+1) of the UHF determinant."""
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        s = self.get_ovlp() if s is None else s
        ca = c[0][:, o[0] > 0]
        cb = c[1][:, o[1] > 0]
        na, nb = ca.shape[1], cb.shape[1]
        sab = ca.T @ s @ cb
        sz = 0.5 * (na - nb)
        ss = sz * sz + 0.5 * (na + nb) - float(torch.sum(sab * sab))
        return ss, 2 * (ss + 0.25) ** 0.5 if ss > -0.25 else 1.0

    # ---- analysis: the base class's methods on the total density dm_a +
    # dm_b (pyscf_tpu/scf/uhf.py:154-188) ---------------------------------
    def dip_moment(self, mol=None, dm=None, unit='Debye'):
        if dm is None:
            dm = self.make_rdm1()
        return super().dip_moment(mol, dm[0] + dm[1], unit)

    def quad_moment(self, mol=None, dm=None):
        if dm is None:
            dm = self.make_rdm1()
        return super().quad_moment(mol, dm[0] + dm[1])

    def mulliken_pop(self, mol=None, dm=None, s=None):
        if dm is None:
            dm = self.make_rdm1()
        return super().mulliken_pop(mol, dm[0] + dm[1], s)

    def mulliken_spin_pop(self, mol=None, dm=None, s=None):
        """(pop (nao,), spin (natm,)) numpy: the Mulliken populations of
        the spin density, ((dm_a - dm_b) S)_ii, and their sums per atom,
        which add up to 2S."""
        from ..grad.rhf import _ao2atom_map
        mol = mol or self.mol
        if dm is None:
            dm = self.make_rdm1()
        if s is None:
            s = self.get_ovlp(mol)
        pop = torch.einsum('ij,ji->i', dm[0] - dm[1], s).cpu().numpy()
        spin = np.zeros(mol.natm)
        np.add.at(spin, _ao2atom_map(mol), pop)
        return pop, spin

    def Gradients(self):
        from ..grad import uhf as uhf_grad
        return uhf_grad.Gradients(self)

    def nuc_grad_method(self):
        return self.Gradients()
