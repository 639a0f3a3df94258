"""Γ-point periodic Hartree-Fock.

Counterpart of pyscf_tpu/pbc/scf/hf.py (madelung, RHF): the molecular RHF
of scf/hf.py with the cell's integrals. S and hcore come from the FFTDF
(or GDF, after density_fit()), energy_nuc is the cell's Ewald sum, and J
and K come from the data-fitting object through _jk_fns, so the SCF loop
is the molecular one (scf/fused.py); the set-up seconds are in
with_df.timings. Exchange at Γ adds the probe-charge
(Madelung) correction of the G = 0 divergence, K += madelung S D S
(exxdiv 'ewald').
"""
import numpy as np
import torch

from ...scf.hf import RHF as MolRHF
from ..df.fft import FFTDF


def madelung(cell, kpts=None):
    """Madelung constant of a probe charge in the neutralizing lattice:
    -2 x the Ewald energy of one unit charge per cell. With k-points the
    probe lives in the Born-von Karman supercell: each lattice vector is
    scaled by the number of distinct fractions of kpts along it."""
    from ..gto.cell import Cell
    a = np.asarray(cell.lattice_vectors_)
    if kpts is not None:
        frac = np.asarray(kpts).reshape(-1, 3) @ a.T / (2.0 * np.pi)
        a = a * np.array([len(np.unique(np.round(frac[:, i], 8)))
                          for i in range(3)], dtype=float)[:, None]
    probe = Cell(atom=[('H', (0.0, 0.0, 0.0))], a=a,
                 unit='bohr', basis={'H': [[0, [1.0, 1.0]]]}, verbose=0,
                 precision=cell.precision, device=cell.device).build()
    probe.atom_charges_eff = np.array([1.0])
    return -2.0 * probe.ewald()


class RHF(MolRHF):
    def __init__(self, cell, exxdiv='ewald'):
        super().__init__(cell)
        self.cell = cell
        self.exxdiv = exxdiv
        self.with_df = FFTDF(cell)
        self._madelung = None

    def get_ovlp(self, mol=None):
        return self.with_df.get_ovlp()

    def _ao_deriv(self):
        """The derivative order of the grid AO values the mean field
        needs: 0 here, 1 for a GGA."""
        return 0

    def get_hcore(self, mol=None):
        self.with_df.ao_deriv = self._ao_deriv()
        return self.with_df.get_hcore()

    def density_fit(self, auxbasis=None):
        """J and K from Γ-point Gaussian density fitting (pbc/df/gdf.py);
        S, hcore and the grid still come from the FFT mesh."""
        from ..df.gdf import GDF
        self.with_df = GDF(self.cell, auxbasis)
        return self

    def _jk_fns(self, omega=None):
        """(get_j(dm), get_k(dm, co=None)) of the data-fitting object; K
        with the Madelung term when exxdiv is 'ewald'."""
        if omega:
            raise NotImplementedError('range-separated exchange in a cell '
                                      'is not ported')
        df = self.with_df
        s = self.get_ovlp()
        if self.exxdiv == 'ewald' and self._madelung is None:
            self._madelung = madelung(self.cell)

        def get_k(dm, co=None):
            vk = df.get_k(dm, co)
            if self.exxdiv == 'ewald':
                vk = vk + self._madelung * (s @ dm @ s)
            return vk

        return df.get_j, get_k

    def energy_tot(self, dm):
        """The energy functional at the density dm (nao, nao)."""
        _, e2 = self._veff_fns()[1](dm)
        return (float(torch.sum(self.get_hcore() * dm) + e2)
                + self.energy_nuc())

    def nuc_grad_method(self):
        raise NotImplementedError('periodic gradients are not ported')

    Gradients = nuc_grad_method
