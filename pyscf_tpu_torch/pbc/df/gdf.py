"""Γ-point Gaussian density fitting of a cell.

Counterpart of the Γ half of pyscf_tpu/pbc/df/gdf.py: make_etb_aux_cell,
GDF (build, cderi, get_jk) and _pivoted_cholesky. The Coulomb integrals
come from the plane waves of the FFT mesh, (f|g) = (1/vol) sum_G
conj(f^(G)) coulG g^(G) with f^ = w FFT(f), G = 0 left out. By default
(Cholesky route) the pair densities' FFTs h give the exact mesh ERI
M = Re(h^H h) (nao^2, nao^2), whose pivoted Cholesky to cholesky_tol is
the factor B; with an auxbasis (ETB route), an even-tempered aux cell's
lattice-summed values (kernel `eval_ao_pbc`) give j2c and j3c by FFT and
GEMM, and B = X^T j3c with X = j2c^(-1/2) over the eigenvalues above 1e-9
of the largest. J and K then take the molecular DF path (df/df_jk.py).
The FFTs and GEMMs run on cell.device (cuFFT, cuBLAS), the Cholesky's
pivot loop too.

Both hold M or the pair FFTs (ngrid, nao^2) whole: the 64-atom diamond
cell (nao 256, mesh [79]^3) would need 34 GB for M and more than a TB
for the pair FFTs, so cells of that size run FFTDF.
"""
import math
import time

import numpy as np
import torch

from ...df.df_jk import j_from_dm, k_from_dm, k_from_mo
from ...ops.integrals.j3c import sync
from .fft import FFTDF, eval_ao_periodic


def make_etb_aux_cell(cell, beta=1.7):
    """Even-tempered fitting basis from the orbital basis: per element and
    aux l, exponents from half the smallest product to twice the largest
    sum in steps of beta."""
    basis = {}
    for symb in set(cell.elements_):
        shells = {}
        for l, g in cell.shell_groups.items():
            for s in range(g.nshl):
                if cell.elements_[g.atom_ids[s]] != symb:
                    continue
                shells.setdefault(l, []).extend(
                    g.exps[s][g.coeffs[s] != 0].tolist())
        bas = []
        for laux in range(2 * max(shells) + 1):
            emins, emaxs = [], []
            for l1, e1 in shells.items():
                for l2, e2 in shells.items():
                    if not (abs(l1 - l2) <= laux <= l1 + l2):
                        continue
                    emins.append(2.0 * min(e1) * min(e2) / (min(e1) + min(e2)))
                    emaxs.append(2.0 * (max(e1) + max(e2)))
            if not emins:
                continue
            emin, emax = 0.5 * min(emins), 2.0 * max(emaxs)
            n = max(1, int(math.ceil(math.log(emax / emin) / math.log(beta))))
            bas.extend([laux, [emin * beta ** i, 1.0]] for i in range(n))
        basis[symb] = bas
    return _aux_cell(cell, basis)


def _aux_cell(cell, basis):
    from ..gto.cell import Cell
    return Cell(atom=list(zip(cell.raw_symbols, np.asarray(cell.coords))),
                a=cell.lattice_vectors_, unit='bohr', basis=basis,
                mesh=cell.mesh, precision=cell.precision, verbose=0,
                device=cell.device).build()


def _pivoted_cholesky(M, tol):
    """Pivoted Cholesky of a PSD matrix to absolute tolerance: L (rank, n)
    with M ~= L^T L. The pivot loop reads one pivot a step on the host."""
    n = M.shape[0]
    d = torch.diagonal(M).clone()
    L = torch.empty((n, n), dtype=M.dtype, device=M.device)
    k = 0
    while k < n:
        j = int(torch.argmax(d))
        dj = float(d[j])
        if dj <= tol:
            break
        row = M[j] - L[:k, j] @ L[:k] if k else M[j].clone()
        L[k] = row / math.sqrt(dj)
        d = d - L[k] * L[k]
        d[j] = 0.0
        k += 1
    return L[:k]


class GDF(FFTDF):
    """Γ-point Gaussian density fitting; hcore, overlap and the grid AO
    values come from FFTDF. `timings` adds 'cderi', the seconds of
    build()."""

    cholesky_tol = 1e-9      # pivoted-Cholesky truncation of the mesh ERI

    def __init__(self, cell, auxbasis=None):
        super().__init__(cell)
        self.auxbasis = auxbasis
        self.auxcell = None
        self._cderi = None

    @property
    def naux(self):
        return self.cderi.shape[0]

    def _pair_fft(self, ao):
        """w FFT of every AO pair product ao_i ao_j: (ngrid, nao^2)."""
        nao = ao.shape[1]
        pair = (ao[:, :, None] * ao[:, None, :]).reshape(*self.mesh,
                                                         nao * nao)
        return self.weight * torch.fft.fftn(pair, dim=(0, 1, 2)).reshape(
            self.ngrid, nao * nao)

    def build(self):
        t0 = time.perf_counter()
        cell = self.cell
        coul = self._coul()
        ao = self._ao_on_grid(0)
        nao = ao.shape[1]
        pairG = self._pair_fft(ao)
        if self.auxbasis is None:
            h = torch.sqrt(coul / cell.vol)[:, None] * pairG
            M = (h.conj().T @ h).real
            del h
            B = _pivoted_cholesky(M, self.cholesky_tol)
            self._cderi = B.reshape(-1, nao, nao)
        else:
            if self.auxcell is None:
                self.auxcell = (_aux_cell(cell, self.auxbasis)
                                if isinstance(self.auxbasis, str)
                                else make_etb_aux_cell(cell))
            chi = eval_ao_periodic(self.auxcell, self.grids_coords, 0)
            naux = chi.shape[1]
            chiG = self.weight * torch.fft.fftn(
                chi.reshape(*self.mesh, naux), dim=(0, 1, 2)).reshape(
                self.ngrid, naux)
            vchiG = coul[:, None] * chiG / cell.vol
            j2c = (chiG.conj().T @ vchiG).real
            j3c = (pairG.conj().T @ vchiG).real          # (nao^2, naux)
            w, v = torch.linalg.eigh(j2c)
            keep = w > 1e-9 * w.max()
            X = v[:, keep] / torch.sqrt(w[keep])         # j2c^(-1/2)
            self._cderi = (j3c @ X).T.reshape(-1, nao, nao).contiguous()
        sync(cell.device)
        self.timings['cderi'] = time.perf_counter() - t0
        return self

    @property
    def cderi(self):
        if self._cderi is None:
            self.build()
        return self._cderi

    def get_j(self, dm):
        return j_from_dm(self.cderi, dm)

    def get_k(self, dm, co=None):
        B = self.cderi
        return k_from_dm(B, dm) if co is None else k_from_mo(B, co)
