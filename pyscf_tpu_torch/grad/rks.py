"""RKS nuclear gradients: analytic for density-fitted mean fields
(grad/df.py, the grid held fixed as in the JAX package), central
differences of the conventional RKS energy otherwise, as
pyscf_tpu/grad/rks.py computes them (the moved grids follow the atoms, so
that grid response is included)."""
from . import uhf


class Gradients(uhf.Gradients):
    def _moved(self, mol):
        mf = mol.RKS(xc=self._scf.xc)
        mf.grids.level = self._scf.grids.level
        mf.grids.atom_grid = self._scf.grids.atom_grid
        return mf
