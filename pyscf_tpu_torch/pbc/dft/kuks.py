"""k-point unrestricted Kohn-Sham DFT over FFTDF.

Counterpart of pyscf_tpu/pbc/dft/kuks.py (KUKS): KUHF's loop with the
spin densities' XC on the uniform FFT mesh through the molecular kernel
`xc_uks`, on the real and imaginary parts of every k's rows side by side
as KRKS feeds `xc_rks` (krks.py): its vtmp'_s is, part by part, the JAX
package's vtmp_s = 1/2 w vrho_s phi_k + w (2 vsigma_ss grad rho_s +
vsigma_ab grad rho_s') . grad phi_k (kuks.py:97-100), and V_s,k =
phi_k^H vtmp_s,k + h.c. The JAX package masks rho_a + rho_b > RHO_THR with
no floor (kuks.py:61-65); the kernel also keeps rho_s >= RHO_THR / 2 and
sigma_ss >= SIGMA_FLOOR, which bind nowhere on diamond
(tests/test_torch_kpts.py).
"""
import torch

from ...ops import kernels
from ..scf.kuhf import KUHF
from .krks import KRKS, stack_kpts, unstack_kpts


class KUKS(KUHF):
    def __init__(self, cell, kpts=None, xc='lda,vwn', exxdiv='ewald'):
        super().__init__(cell, kpts, exxdiv=exxdiv)
        self.xc = xc
        self._exc = self._ecoul = self._ek = 0.0

    multigrid_fftdf_ = KRKS.multigrid_fftdf_
    _functional = KRKS._functional
    _ao_deriv = KRKS._ao_deriv
    _xc_inputs = KRKS._xc_inputs
    energy_elec = KRKS.energy_elec

    def get_vxc(self, dm):
        """(exc, V_xc (2, nk, nao, nao)) of dm (2, nk, nao, nao); kernel
        `xc_uks`."""
        xc = self._functional()
        ao, aod, w = self._xc_inputs(xc)
        dmao = stack_kpts(ao @ (dm / self.nkpts), kaxis=1)
        vtmp, _, exc = kernels.xc_uks(aod, dmao, w, xc)
        v = ao.conj().transpose(1, 2) @ unstack_kpts(vtmp, self.nkpts)
        return float(exc), v + v.conj().transpose(-1, -2)

    def get_veff(self, dm):
        hyb = self._functional().hyb
        self._exc, vxc = self.get_vxc(dm)
        vj, vk = self.get_jk(dm, with_k=hyb != 0.0)
        nk = self.nkpts
        self._ecoul = 0.5 * float(torch.einsum('kij,kji->', vj[0],
                                               dm[0] + dm[1]).real) / nk
        self._ek = 0.0
        vhf = vj + vxc
        if vk is not None:
            vk = hyb * vk
            self._ek = -0.5 * float(torch.einsum('skij,skji->', vk,
                                                 dm).real) / nk
            vhf = vhf - vk
        return vhf
