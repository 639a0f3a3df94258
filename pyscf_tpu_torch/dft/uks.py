"""Unrestricted Kohn-Sham DFT.

Counterpart of pyscf_tpu/dft/uks.py (UKS) with both branches of
UKS._fused_veff and no range-separated part: each cycle

    vhf_s = vxc_s + vj - hyb vk_s
    e2    = 1/2 tr(vj (dm_a + dm_b)) + exc - 1/2 hyb (tr(vk_a dm_a)
                                                     + tr(vk_b dm_b))

with J/K on the DF factor (K from each spin's occupied factor in the cycle)
or on the in-core ERI tensor, and the XC term from NumInt's spin-polarized
core (kernel `xc_uks`) over AO values evaluated once per kernel() call.
The SCF loop is SCF.kernel of scf/hf.py with the cycle of UHF.
Gradients / nuc_grad_method lead to grad/uks.py: analytic for a
density-fitted mean field, NotImplementedError otherwise.
"""
import torch

from ..scf.uhf import UHF
from .rks import KohnShamDFT


class UKS(KohnShamDFT, UHF):
    def __init__(self, mol, xc='lda,vwn'):
        UHF.__init__(self, mol)
        self._init_ks(xc)

    def _veff_fns(self):
        """(veff_fn(dm, cos), veff_dm_fn(dm)) -> (vhf (2, n, n), e2); builds
        the grids and the AO values, timed as 'grids' and 'ao'."""
        get_j, get_k = self._jk_fns()
        aod, weights = self._grid_ao(2)
        core = self._numint._get_uks_core_aod(self.xc)
        hyb = self.xc_obj.hyb

        def veff(dm, cos=None):
            _, exc, vxc = core(aod, weights, dm)
            vj = get_j(dm[0] + dm[1])
            e2 = 0.5 * torch.sum(vj * (dm[0] + dm[1])) + exc
            vhf = vxc + vj
            if hyb != 0.0:
                vka = hyb * get_k(dm[0], None if cos is None else cos[0])
                vkb = hyb * get_k(dm[1], None if cos is None else cos[1])
                vhf = vhf - torch.stack([vka, vkb])
                e2 = e2 - 0.5 * (torch.sum(vka * dm[0])
                                 + torch.sum(vkb * dm[1]))
            return vhf, e2

        return veff, veff

    def Gradients(self):
        from ..grad import uks as uks_grad
        return uks_grad.Gradients(self)
