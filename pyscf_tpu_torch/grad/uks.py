"""UKS nuclear gradients: analytic for density-fitted mean fields
(grad/df.py with the spin-polarized XC term of kernel xc_uks_grad, the
grid held fixed as in the JAX package).

The JAX package's UKS takes its Gradients from UHF (pyscf_tpu/dft/uks.py),
whose non-DF branch (pyscf_tpu/grad/uhf.py:24-29) differentiates the
energy of a UHF object built on the moved molecule, not the UKS energy.
The port does not repeat that: a conventional UKS gradient raises."""
from . import uhf

NON_DF = ('UKS gradients without density fitting are not ported: the '
          'reference (pyscf_tpu/grad/uhf.py:24-29) differentiates a UHF '
          'energy for a UKS object; use .density_fit()')


class Gradients(uhf.Gradients):
    def __init__(self, mf):
        if mf.with_df is None:
            raise NotImplementedError(NON_DF)
        super().__init__(mf)
