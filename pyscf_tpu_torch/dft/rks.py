"""Restricted Kohn-Sham DFT.

Counterpart of pyscf_tpu/dft/rks.py (KohnShamDFT, RKS) with the plain
branch of RKS._fused_veff: each cycle

    vhf = vxc + vj - 1/2 hyb vk
    e2  = 1/2 tr(vj dm) + exc - 1/4 hyb tr(vk dm)

with J/K on the DF factor or on the in-core ERI tensor (SCF._get_eri)
and the XC term from NumInt over AO values evaluated once per kernel()
call. The SCF loop is SCF.kernel of scf/hf.py.
"""
import time

import torch

from ..ops.integrals.j3c import sync
from ..scf.hf import RHF
from . import gen_grid
from . import xc as xc_mod
from .numint import NumInt


class KohnShamDFT:
    """Mixin adding the grids and XC machinery to an SCF class."""

    def _init_ks(self, xc='lda,vwn'):
        self.xc = xc
        self.grids = gen_grid.Grids(self.mol)
        self._numint = NumInt()

    @property
    def xc(self):
        return self._xc

    @xc.setter
    def xc(self, value):
        xc_mod.parse_xc(value)          # an unported name raises here
        self._xc = value

    @property
    def xc_obj(self):
        return xc_mod.parse_xc(self.xc)

    def _grid_ao(self, spins):
        """(AO value blocks, weight blocks) of the grids, built here if
        needed; timed as 'grids' and 'ao'."""
        dev = self.mol.device
        t0 = time.perf_counter()
        if self.grids.coords is None:
            self.grids.build()
        sync(dev)
        t1 = time.perf_counter()
        out = self._numint.grid_ao(self.mol, self.grids,
                                   1 if self.xc_obj.is_gga else 0, spins)
        sync(dev)
        self._veff_timings['grids'] = t1 - t0
        self._veff_timings['ao'] = time.perf_counter() - t1
        return out


class RKS(KohnShamDFT, RHF):
    def __init__(self, mol, xc='lda,vwn'):
        RHF.__init__(self, mol)
        self._init_ks(xc)

    def _veff_fns(self):
        """(veff_fn(dm, co), veff_dm_fn(dm)) -> (vhf, e2); builds the grids
        and the AO values, timed as 'grids' and 'ao'."""
        get_j, get_k = self._jk_fns()
        aod, weights = self._grid_ao(1)
        core = self._numint._get_rks_core_aod(self.xc)
        hyb = self.xc_obj.hyb

        def veff(dm, co=None):
            _, exc, vxc = core(aod, weights, dm)
            vj = get_j(dm)
            e2 = 0.5 * torch.sum(vj * dm) + exc
            vhf = vxc + vj
            if hyb != 0.0:
                vk = hyb * get_k(dm, co)
                vhf = vhf - 0.5 * vk
                e2 = e2 - 0.25 * torch.sum(vk * dm)
            return vhf, e2

        return veff, veff

    def nuc_grad_method(self):
        from ..grad import rks as rks_grad
        return rks_grad.Gradients(self)

    Gradients = nuc_grad_method
