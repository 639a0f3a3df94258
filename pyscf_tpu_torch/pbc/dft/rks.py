"""Γ-point periodic Kohn-Sham DFT.

Counterpart of pyscf_tpu/pbc/dft/rks.py (RKS, get_veff, energy_elec): the
XC quadrature on the cell's uniform FFT mesh, every point weighted
vol / ngrid, over the lattice-summed AO values of the data-fitting object
(kernel `eval_ao_pbc`), through the molecular core (dft/numint.py, kernel
`xc_rks`); J from the data-fitting object (FFTDF or GDF), and for a
hybrid hyb K with the Madelung term. Each cycle

    vhf = vxc + vj - 1/2 hyb vk
    e2  = 1/2 tr(vj dm) + exc - 1/4 hyb tr(vk dm)

The density threshold is the molecular RHO_THR (1e-10) with the sigma
floor 1e-20, where the JAX package's periodic RKS masks rho > 1e-12 with
no floor: on diamond's [15]^3 grid the density stays above 1e-3 and no
sigma falls below 1e-20 (tests/test_torch_pbc.py), so neither moves the
energy.

The JAX package's periodic RKS puts half the GGA term into V_xc
(pyscf_tpu/pbc/dft/rks.py:68-70: 0.5 ao^T (2 w vsigma grad rho . grad
ao), then V + V^T): its V_xc is not dE_xc/dD, and its converged PBE
energy of config 5 lies 6.6e-8 Ha above the port's. The port computes
the derivative; at the JAX package's converged density its energy
functional gives the JAX energy (tests/test_torch_pbc.py).
"""
import torch

from ...dft import xc as xc_mod
from ...dft.numint import NumInt
from ..scf.hf import RHF as PBCRHF


class RKS(PBCRHF):
    def __init__(self, cell, xc='lda,vwn'):
        super().__init__(cell, exxdiv='ewald')
        self.xc = xc
        self._numint = NumInt()

    def _ao_deriv(self):
        return int(xc_mod.parse_xc(self.xc).is_gga)

    def multigrid_fftdf_(self, nlevels=3):
        raise NotImplementedError('the multigrid (pbc/dft/multigrid.py) is '
                                  'not ported')

    def _veff_fns(self):
        """(veff_fn(dm, co), veff_dm_fn(dm)) -> (vhf, e2); evaluates the
        AO values on the grid (the data-fitting object's 'ao')."""
        xc = xc_mod.parse_xc(self.xc)
        omega, _, hyb = self._numint.rsh_and_hybrid_coeff(self.xc)
        if omega or xc.nlc is not None:
            raise NotImplementedError('range-separated and VV10 functionals '
                                      'in a cell are not ported')
        get_j, get_k = self._jk_fns()
        df = self.with_df
        aod = df._ao_on_grid(1 if xc.is_gga else 0)
        weights = torch.full((df.ngrid,), df.weight, dtype=torch.float64,
                             device=aod.device)
        core = self._numint._get_rks_core_aod(self.xc)

        def veff(dm, co=None):
            _, exc, vxc = core([aod], [weights], dm)
            vj = get_j(dm)
            vhf = vxc + vj
            e2 = 0.5 * torch.sum(vj * dm) + exc
            if hyb != 0.0:
                vk = hyb * get_k(dm, co)
                vhf = vhf - 0.5 * vk
                e2 = e2 - 0.25 * torch.sum(vk * dm)
            return vhf, e2

        return veff, veff
