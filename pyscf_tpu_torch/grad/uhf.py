"""UHF nuclear gradients by central differences of the conventional UHF
energy, as pyscf_tpu/grad/uhf.py computes them without density fitting."""
from .rhf import finite_difference_gradient, refuse_df


class Gradients:
    def __init__(self, mf):
        self._scf = mf
        self.mol = mf.mol
        self.de = None

    def _moved(self, mol):
        """The mean field of a moved copy, set up like self._scf."""
        return mol.UHF()

    def kernel(self, step=1e-4):
        mf0 = self._scf
        refuse_df(mf0)

        def efac(m):
            mf = self._moved(m)
            mf.verbose = 0
            mf.init_guess = mf0.init_guess
            mf.conv_tol = max(mf0.conv_tol, 1e-11)
            return mf.kernel()

        self.de = finite_difference_gradient(efac, self.mol, step)
        return self.de

    run = kernel
