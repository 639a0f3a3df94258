"""k-point unrestricted Hartree-Fock over FFTDF.

Counterpart of pyscf_tpu/pbc/scf/kuhf.py (KUHF): KRHF's loop (khf.py)
with a leading spin axis, densities and Fock matrices (2, nk, nao, nao):
J of the spin-summed density, K per spin with the Ewald exxdiv, the
Aufbau per spin over the whole k mesh ((nelectron + spin) / 2 alpha
electrons per cell).
"""
import torch

from .khf import KRHF


class KUHF(KRHF):

    def get_jk(self, dm, with_j=True, with_k=True):
        """(vj, vk) per spin and k of dm (2, nk, nao, nao): vj of the total
        density for both spins, vk per spin with the exxdiv term."""
        df = self.with_df
        vj = vk = None
        if with_j:
            vj = df.get_j_kpts(dm[0] + dm[1]).expand(2, -1, -1, -1)
        if with_k:
            vk = torch.stack([self._exxdiv(df.get_k_kpts(d), d) for d in dm])
        return vj, vk

    def get_veff(self, dm):
        vj, vk = self.get_jk(dm)
        return vj - vk

    def _nocc(self):
        nk = self.nkpts
        na = (self.cell.nelectron + self.cell.spin) // 2 * nk
        return (na, self.cell.nelectron * nk - na), 1.0

    @staticmethod
    def _spin_stack(h1e):
        return torch.stack([h1e, h1e])

    def get_bands(self, kpts_band, dm=None):
        raise NotImplementedError('bands of an unrestricted k-point mean '
                                  'field are not ported')
