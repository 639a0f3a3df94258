"""RKS nuclear gradients by central differences of the conventional RKS
energy, as pyscf_tpu/grad/rks.py computes them without density fitting
(the moved grids follow the atoms, so the grid response is included)."""
from . import uhf


class Gradients(uhf.Gradients):
    def _moved(self, mol):
        mf = mol.RKS(xc=self._scf.xc)
        mf.grids.level = self._scf.grids.level
        mf.grids.atom_grid = self._scf.grids.atom_grid
        return mf
