"""RKS nuclear gradients: analytic for density-fitted mean fields
(grad/df.py, the grid held fixed as in the JAX package), central
differences of the conventional RKS energy otherwise, as
pyscf_tpu/grad/rks.py computes them (the moved grids follow the atoms, so
that grid response is included). A range-separated or VV10 functional
raises NotImplementedError (grad/df.py check_functional)."""
from . import uhf
from .df import check_functional


class Gradients(uhf.Gradients):
    def __init__(self, mf):
        check_functional(mf)
        super().__init__(mf)

    def _moved(self, mol):
        mf = mol.RKS(xc=self._scf.xc)
        mf.grids.level = self._scf.grids.level
        mf.grids.atom_grid = self._scf.grids.atom_grid
        return mf
