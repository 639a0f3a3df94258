"""Restricted Kohn-Sham DFT.

Counterpart of pyscf_tpu/dft/rks.py (KohnShamDFT, RKS) with the plain
branch of RKS._fused_veff and the VV10 term of RKS.get_veff
(rks.py:228-234): each cycle

    vk  = hyb K + (alpha - hyb) K_LR
    vhf = vxc + v_nlc + vj - 1/2 vk
    e2  = 1/2 tr(vj dm) + exc + e_nlc - 1/4 tr(vk dm)

with J/K on the DF factor or on the in-core ERI tensor (SCF._get_eri),
K_LR on their erf(omega r)/r counterparts for a range-separated functional
((omega, alpha, hyb) = NumInt.rsh_and_hybrid_coeff), the XC term from
NumInt over AO values evaluated once per kernel() call, and, when nlc is
set (by a functional such as wB97X-V, or by hand), VV10 on the same grid
and AO values (dft/vv10.py nr_vv10, kernel `vv10`). The SCF loop is
SCF.kernel of scf/hf.py: unlike the JAX package, which runs a VV10
functional through its host loop, the port keeps its one cycle.
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

    # VV10 non-local correlation: off (''), or on with the parameters b and
    # C (pyscf_tpu/dft/vv10.py:96-100)
    nlc = ''
    nlc_b = 5.9
    nlc_C = 0.0093

    def _init_ks(self, xc='lda,vwn'):
        self.xc = xc
        self.grids = gen_grid.Grids(self.mol)
        self._numint = NumInt()
        self._nlc_events = []

    @property
    def xc(self):
        return self._xc

    @xc.setter
    def xc(self, value):
        # an unported name raises here; the functional's built-in non-local
        # correlation is resolved on every assignment, so `mf.xc =
        # 'wb97x-v'` turns VV10 on and a functional without it turns it off
        nlc = xc_mod.parse_xc(value).nlc
        self._xc = value
        if nlc is not None:
            self.nlc, self.nlc_b, self.nlc_C = nlc
        else:
            self.nlc = ''

    @property
    def xc_obj(self):
        return xc_mod.parse_xc(self.xc)

    def kernel(self, dm0=None):
        """SCF.kernel; with VV10 on the card, `timings['vv10']` then holds
        the seconds of the `vv10` launches inside scf_loop, from their CUDA
        events."""
        e = super().kernel(dm0)
        if self._nlc_events:
            self.timings['vv10'] = sum(
                a.elapsed_time(b) for a, b in self._nlc_events) / 1e3
        return e

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

    def _k_terms(self):
        """(omega, alpha, hyb, get_k_lr) of the functional's exact exchange,
        K = hyb get_k + (alpha - hyb) get_k_lr: get_k_lr(dm, co) is K on the
        erf(omega r)/r factor or tensor (None without range separation)."""
        omega, alpha, hyb = self._numint.rsh_and_hybrid_coeff(self.xc)
        return omega, alpha, hyb, self._jk_fns(omega)[1] if omega else None

    def _nlc_fn(self, ao_eval):
        """None without VV10; else nlc(dm) -> (e_nlc, v_nlc) of a
        closed-shell density on the SCF's grid, from the SCF's own AO
        blocks when they hold gradients. On the card each `vv10` launch is
        bracketed by CUDA events (no host sync) that kernel() reads."""
        self._nlc_events = []
        if not self.nlc:
            return None
        from .vv10 import nr_vv10
        if ao_eval[0][0].dim() != 3:
            ao_eval = self._numint.grid_ao(self.mol, self.grids, 1)
        events = self._nlc_events if self.mol.device.type == 'cuda' else None

        def nlc(dm):
            return nr_vv10(self.mol, self.grids, dm, self.nlc_b, self.nlc_C,
                           ao_eval, events)

        return nlc


class RKS(KohnShamDFT, RHF):
    def __init__(self, mol, xc='lda,vwn'):
        RHF.__init__(self, mol)
        self._init_ks(xc)

    def _veff_fns(self):
        """(veff_fn(dm, co), veff_dm_fn(dm)) -> (vhf, e2); builds the grids
        and the AO values, timed as 'grids' and 'ao'."""
        get_j, get_k = self._jk_fns()
        omega, alpha, hyb, get_k_lr = self._k_terms()
        aod, weights = self._grid_ao(1)
        core = self._numint._get_rks_core_aod(self.xc)
        nlc = self._nlc_fn((aod, weights))

        def veff(dm, co=None):
            _, exc, vxc = core(aod, weights, dm)
            if nlc is not None:
                e_nlc, v_nlc = nlc(dm)
                exc = exc + e_nlc
                vxc = vxc + v_nlc
            vj = get_j(dm)
            e2 = 0.5 * torch.sum(vj * dm) + exc
            vhf = vxc + vj
            if hyb != 0.0 or omega:
                vk = hyb * get_k(dm, co)
                if omega:
                    vk = vk + (alpha - hyb) * get_k_lr(dm, co)
                vhf = vhf - 0.5 * vk
                e2 = e2 - 0.25 * torch.sum(vk * dm)
            return vhf, e2

        return veff, veff

    def nuc_grad_method(self):
        from ..grad import rks as rks_grad
        return rks_grad.Gradients(self)

    Gradients = nuc_grad_method

    # excited states (pyscf_tpu/dft/rks.py:265-271); TDHF is RHF's
    def TDA(self, **kwargs):
        from ..tdscf import TDA
        return TDA(self, **kwargs)

    def TDDFT(self, **kwargs):
        from ..tdscf import TDDFT
        return TDDFT(self, **kwargs)
