"""Density-fitting object: the whitened 3-index factor B on the device.

Counterpart of pyscf_tpu/df/df.py:DF. B satisfies
(ij|kl) ~= sum_P B[P,i,j] B[P,k,l] with B = L^{-1} (P|ij), (P|Q) = L L^T.
The factor and the whitener (L^{-1})^T depend only on geometry, basis, aux
basis and omega, so they are cached on the Mole under (auxbasis, omega):
fresh mean-field objects on the same molecule reuse them, and the DF
gradient (grad/df.py) takes the fitted densities from them. With omega,
both the metric and the 3c rows are of erf(omega r)/r: the long-range
factor of a range-separated functional's K; its build times are 'j2c_lr'
and 'j3c_lr'.
"""
from . import addons


class DF:
    def __init__(self, mol, auxbasis=None, omega=None):
        self.mol = mol
        self.auxbasis = auxbasis
        self.omega = omega      # erf(omega r)/r long-range factor
        self.auxmol = None
        self._cderi = None      # (naux, nao, nao)
        self._whitener = None   # (L^-1)^T, (naux, naux)
        self.timings = {}       # seconds of the last build: 'j2c', 'j3c'

    def build(self):
        from ..ops.integrals.j3c import df_factor
        cache = self.mol._df_cache
        omega = self.omega or None
        key = (str(self.auxbasis), omega)
        if key not in cache:
            auxmol = addons.make_auxmol(self.mol, self.auxbasis)
            t = {}
            cache[key] = (auxmol,) + df_factor(self.mol, auxmol, t, omega)
            suffix = '_lr' if omega else ''
            self.timings = {k + suffix: v for k, v in t.items()}
        self.auxmol, self._cderi, self._whitener = cache[key]
        return self

    @property
    def cderi(self):
        if self._cderi is None:
            self.build()
        return self._cderi

    @property
    def whitener(self):
        if self._whitener is None:
            self.build()
        return self._whitener
