"""Density-fitting object: the whitened 3-index factor B on the device.

Counterpart of pyscf_tpu/df/df.py:DF. B satisfies
(ij|kl) ~= sum_P B[P,i,j] B[P,k,l] with B = L^{-1} (P|ij), (P|Q) = L L^T.
The factor depends only on geometry, basis and aux basis, so it is cached
on the Mole: fresh mean-field objects on the same molecule reuse it.
"""
from . import addons


class DF:
    def __init__(self, mol, auxbasis=None):
        self.mol = mol
        self.auxbasis = auxbasis
        self.auxmol = None
        self._cderi = None      # (naux, nao, nao)
        self.timings = {}       # seconds of the last build: 'j2c', 'j3c'

    def build(self):
        from ..ops.integrals.j3c import df_factor
        cache = self.mol._df_cache
        key = str(self.auxbasis)
        if key in cache:
            self.auxmol, self._cderi = cache[key]
            return self
        self.auxmol = addons.make_auxmol(self.mol, self.auxbasis)
        self._cderi = df_factor(self.mol, self.auxmol, self.timings)
        cache[key] = (self.auxmol, self._cderi)
        return self

    @property
    def cderi(self):
        if self._cderi is None:
            self.build()
        return self._cderi
