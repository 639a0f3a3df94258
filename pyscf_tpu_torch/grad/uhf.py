"""UHF nuclear gradients: analytic for density-fitted mean fields
(grad/df.py), central differences of the conventional UHF energy
otherwise, as pyscf_tpu/grad/uhf.py computes them."""
from .rhf import df_kernel, finite_difference_gradient


class Gradients:
    def __init__(self, mf):
        self._scf = mf
        self.mol = mf.mol
        self.de = None
        self.timings = {}

    def _moved(self, mol):
        """The mean field of a moved copy, set up like self._scf."""
        return mol.UHF()

    def kernel(self, step=1e-4):
        mf0 = self._scf
        if mf0.with_df is not None:
            return df_kernel(self)

        def efac(m):
            mf = self._moved(m)
            mf.verbose = 0
            mf.init_guess = mf0.init_guess
            mf.conv_tol = max(mf0.conv_tol, 1e-11)
            return mf.kernel()

        self.de = finite_difference_gradient(efac, self.mol, step)
        return self.de

    run = kernel
