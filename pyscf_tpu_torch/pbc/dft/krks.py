"""k-point restricted Kohn-Sham DFT over FFTDF.

Counterpart of pyscf_tpu/pbc/dft/krks.py (KRKS): the XC quadrature on the
uniform FFT mesh of the k-averaged density, J from KFFTDF, and for a
global hybrid hyb K with the Ewald exxdiv; range-separated functionals
raise, as in the JAX package. KRHF's loop (pbc/scf/khf.py) with

    vhf = vxc + vj - 1/2 hyb vk
    e2  = 1/2 tr(vj dm) + exc - 1/4 hyb tr(vk dm)     (k-averaged)

The XC runs through the molecular kernel `xc_rks` on real rows: the real
and imaginary parts of every k's Bloch AO values phi_k (and gradients)
and of dmao_k = phi_k D_k / nk, side by side along the AO axis (nao' = 2
nk nao), give the kernel's rho = sum ao' dmao' = (1/nk) sum_k Re(phi_k
D_k phi_k^H) and grad rho = 2 sum dmao' grad ao', the JAX package's
density and gradient (krks.py:34-50); the kernel's vtmp' is, part by
part, the real and imaginary parts of the JAX package's vtmp_k = 1/2 w
vrho phi_k + 2 w vsigma grad rho . grad phi_k (krks.py:83-85), and V_k =
phi_k^H vtmp_k + h.c. by cuBLAS. This V_k is dE_xc/dD_k (unlike the JAX
package's Γ-point RKS), so the port is held to the JAX k-point energies
directly. The kernel's density mask and floors (rho > RHO_THR, sigma >=
SIGMA_FLOOR) are the molecular _masked that krks.py:55,61 calls.
"""
import torch

from ...dft import xc as xc_mod
from ...ops import kernels
from ..scf.khf import KRHF


def stack_kpts(x, kaxis=0):
    """Complex rows with a k axis at kaxis, (.., nk, .., ng, nao) -> real
    (.., .., ng, nk 2 nao): the real and imaginary parts of every k side
    by side along the AO axis."""
    r = torch.view_as_real(x).transpose(-1, -2)     # (.., ng, 2, nao)
    r = r.movedim(kaxis, -3)                        # (.., ng, nk, 2, nao)
    return r.reshape(*r.shape[:-3], -1).contiguous()


def unstack_kpts(v, nk):
    """The inverse of stack_kpts for rows (.., ng, nk 2 nao) -> complex
    (.., nk, ng, nao)."""
    v = v.reshape(*v.shape[:-1], nk, 2, -1).movedim(-3, -4)
    return torch.complex(v[..., 0, :], v[..., 1, :])


class KRKS(KRHF):
    def __init__(self, cell, kpts=None, xc='lda,vwn', exxdiv='ewald'):
        super().__init__(cell, kpts, exxdiv=exxdiv)
        self.xc = xc
        self._exc = self._ecoul = self._ek = 0.0

    def multigrid_fftdf_(self, nlevels=3):
        raise NotImplementedError('the multigrid (pbc/dft/multigrid.py) is '
                                  'not ported')

    def _functional(self):
        xc = xc_mod.parse_xc(self.xc)
        if xc.rsh[0] or xc.nlc is not None:
            raise NotImplementedError('RSH functionals with k-points')
        return xc

    def _ao_deriv(self):
        return int(self._functional().is_gga)

    def _xc_inputs(self, xc):
        """(ao (nk, ng, nao), stacked AO rows for the kernel, weights)."""
        df = self.with_df
        aod = df._ao_on_grid_kpts(1 if xc.is_gga else 0)
        ao = aod[:, 0] if xc.is_gga else aod
        w = torch.full((df.ngrid,), df.weight, dtype=torch.float64,
                       device=ao.device)
        return ao, stack_kpts(aod), w

    def get_vxc(self, dm, band=None):
        """(exc, V_xc (nk, nao, nao)) of dm (nk, nao, nao); kernel
        `xc_rks`. With a KFFTDF band, V_xc at its k-points: their rows
        ride along after the SCF rows with zero dmao, so they add nothing
        to the density and the kernel writes their vtmp too."""
        xc = self._functional()
        ao, aod, w = self._xc_inputs(xc)
        dmao = stack_kpts(ao @ (dm / self.nkpts))
        if band is not None:
            ao = band._ao_on_grid_kpts(1 if xc.is_gga else 0)
            aod = torch.cat([aod, stack_kpts(ao)], -1)
            ao = ao[:, 0] if xc.is_gga else ao
            dmao = torch.cat([dmao, torch.zeros(
                dmao.shape[:-1] + (aod.shape[-1] - dmao.shape[-1],),
                dtype=dmao.dtype, device=dmao.device)], -1)
        vtmp, _, exc = kernels.xc_rks(aod, dmao, w, xc)
        v = ao.conj().transpose(1, 2) @ unstack_kpts(
            vtmp, aod.shape[-1] // (2 * ao.shape[-1]))[-ao.shape[0]:]
        return float(exc), v + v.conj().transpose(1, 2)

    def _band_veff(self, dm, band):
        hyb = self._functional().hyb
        v = (KRHF._band_veff(self, dm, band, hyb) if hyb != 0.0
             else self.with_df.get_j_kpts(dm, band))
        return v + self.get_vxc(dm, band)[1]

    def get_veff(self, dm):
        hyb = self._functional().hyb
        self._exc, vxc = self.get_vxc(dm)
        vj, vk = self.get_jk(dm, with_k=hyb != 0.0)
        nk = self.nkpts
        self._ecoul = 0.5 * float(torch.einsum('kij,kji->', vj, dm).real) / nk
        self._ek = 0.0
        vhf = vj + vxc
        if vk is not None:
            vk = hyb * vk
            self._ek = -0.25 * float(torch.einsum('kij,kji->', vk,
                                                  dm).real) / nk
            vhf = vhf - 0.5 * vk
        return vhf

    def energy_elec(self, dm, h1e, vhf):
        e1 = float(torch.einsum('...kij,...kji->', h1e.expand_as(dm),
                                dm).real) / self.nkpts
        return e1 + self._ecoul + self._exc + self._ek
