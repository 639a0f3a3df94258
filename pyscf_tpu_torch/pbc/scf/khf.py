"""k-point restricted Hartree-Fock over FFTDF.

Counterpart of pyscf_tpu/pbc/scf/khf.py (KRHF): get_ovlp, get_hcore,
get_jk with the Ewald exxdiv, get_occ (the Aufbau over the whole k mesh),
make_rdm1, energy_elec, energy_nuc, init_guess_dm (hcore), kernel and
get_bands. The molecular fused loop (scf/fused.py) is real and single-k,
so this is a driver of its own, and it runs on cell.device where the JAX
package loops over k on the host: the per-k canonical orthogonalisation
and the complex generalised eigenproblems are one batched
torch.linalg.eigh over k, and DIIS (lib/diis.py) mixes the stacked k
Fock matrices, with complex vectors as their real views (the real part of
<e_i, e_j> is the JAX package's B). J, K, S, T and the pseudopotential
come from KFFTDF (pbc/df/fft.py; kernels `eval_ao_kpts` and
`int1e_stv`). The convergence test is the JAX package's: |dE| < conv_tol
and |[F, D]_S| / nk < conv_tol_grad (default sqrt(conv_tol)) after the
first cycle; the final energy is recomputed at the canonical orbitals of
the converged Fock matrix.

The same loop serves KUHF (kuhf.py) through a leading spin axis on the
density and Fock matrices, and KRKS and KUKS (pbc/dft) through get_veff.
"""
import time

import numpy as np
import torch

from ...lib.diis import DIIS
from ...ops.integrals.j3c import sync
from ..df.fft import KFFTDF
from .hf import madelung


class KRHF:
    conv_tol = 1e-8
    conv_tol_grad = None
    max_cycle = 100
    diis_space = 8
    verbose = 0
    init_guess = 'hcore'

    def __init__(self, cell, kpts=None, exxdiv='ewald'):
        self.cell = self.mol = cell
        self.kpts = (np.zeros((1, 3)) if kpts is None
                     else np.asarray(kpts, dtype=np.float64).reshape(-1, 3))
        self.exxdiv = exxdiv
        self.with_df = KFFTDF(cell, self.kpts)
        self.converged = False
        self.e_tot = self.mo_energy = self.mo_coeff = self.mo_occ = None
        self.scf_cycles = 0
        self.timings = {}
        self._madelung = None

    @property
    def nkpts(self):
        return len(self.kpts)

    def get_ovlp(self):
        """S_k (nk, nao, nao)."""
        return self.with_df.get_ovlp_kpts()

    def _ao_deriv(self):
        """The derivative order of the Bloch AO values the mean field
        needs: 0 here, 1 for a GGA."""
        return 0

    def get_hcore(self):
        """T_k + V_pp,k (nk, nao, nao)."""
        self.with_df.ao_deriv = self._ao_deriv()
        return self.with_df.get_hcore_kpts()

    def density_fit(self, auxbasis=None):
        raise NotImplementedError('k-point Gaussian density fitting (KGDF, '
                                  'pyscf_tpu/pbc/df/gdf.py) is not ported')

    def madelung(self):
        if self._madelung is None:
            self._madelung = madelung(self.cell, self.kpts)
        return self._madelung

    def _exxdiv(self, vk, dm):
        """K + madelung S_k D_k S_k (exxdiv 'ewald')."""
        if self.exxdiv == 'ewald':
            s = self.get_ovlp()
            vk = vk + self.madelung() * (s @ dm @ s)
        return vk

    def get_jk(self, dm, with_j=True, with_k=True):
        """(vj, vk) per k of dm (nk, nao, nao), K with the exxdiv term."""
        vj, vk = self.with_df.get_jk_kpts(dm, with_j, with_k)
        return vj, (self._exxdiv(vk, dm) if with_k else None)

    def get_veff(self, dm):
        vj, vk = self.get_jk(dm)
        return vj - 0.5 * vk

    def _nocc(self):
        """Electrons to place per spin channel over the k mesh, and their
        occupation."""
        return (self.cell.nelectron * self.nkpts // 2,), 2.0

    def get_occ(self, mo_energy):
        """Aufbau over the whole k mesh: every state at or below the
        Fermi level of the (spin channel's) electrons is filled."""
        counts, occ = self._nocc()
        e = mo_energy.reshape(len(counts), -1)
        fermi = torch.stack([torch.sort(e[s]).values[n - 1]
                             for s, n in enumerate(counts)])
        fermi = fermi.reshape((-1,) + (1,) * (mo_energy.dim() - 1)) \
            if len(counts) > 1 else fermi[0]
        return (mo_energy <= fermi + 1e-12).to(mo_energy.dtype) * occ

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return (c * o[..., None, :]) @ c.conj().transpose(-1, -2)

    def energy_elec(self, dm, h1e, vhf):
        e1 = torch.einsum('...kij,...kji->', h1e.expand_as(dm), dm).real
        e2 = 0.5 * torch.einsum('...kij,...kji->', vhf, dm).real
        return float(e1 + e2) / self.nkpts

    def energy_nuc(self):
        return self.cell.ewald()

    @staticmethod
    def canonical_orth(s):
        """x_k with x_k^H S_k x_k = 1 over the eigenvalues of S_k above
        1e-10 (nk, nao, nmo)."""
        w, v = torch.linalg.eigh(s)
        keep = w > 1e-10
        nmo = keep.sum(-1)
        if int(nmo.min()) != int(nmo.max()):
            raise NotImplementedError(
                'S_k drops a different number of linear dependences at '
                f'different k-points ({nmo.tolist()})')
        m = int(nmo[0])
        return v[..., -m:] / torch.sqrt(w[..., -m:])[..., None, :]

    @staticmethod
    def eig_all(fock, x):
        """Orbital energies and coefficients of every (spin and) k:
        F' = x^H F x, batched eigh, C = x C'."""
        e, c = torch.linalg.eigh(x.conj().transpose(-1, -2) @ fock @ x)
        return e, x @ c

    def init_guess_dm(self, h1e, x):
        e, c = self.eig_all(self._spin_stack(h1e), x)
        return self.make_rdm1(c, self.get_occ(e))

    @staticmethod
    def _spin_stack(h1e):
        return h1e

    def kernel(self, dm0=None):
        t0 = time.perf_counter()
        s = self.get_ovlp()
        h1e = self.get_hcore()
        x = self.canonical_orth(s)
        dm = dm0 if dm0 is not None else self.init_guess_dm(h1e, x)
        conv_tol_grad = (np.sqrt(self.conv_tol) if self.conv_tol_grad is None
                         else self.conv_tol_grad)
        sync(s.device)
        t1 = time.perf_counter()
        diis = DIIS(self.diis_space)
        e_nuc = self.energy_nuc()
        e_last = 0.0
        conv = False
        cycle = 0
        for cycle in range(self.max_cycle):
            vhf = self.get_veff(dm)
            f = h1e + vhf
            e_tot = self.energy_elec(dm, h1e, vhf) + e_nuc
            errs = s @ dm @ f - f @ dm @ s
            f = torch.view_as_complex(diis.update(
                torch.view_as_real(f), torch.view_as_real(errs)))
            e, c = self.eig_all(f, x)
            dm = self.make_rdm1(c, self.get_occ(e))
            gnorm = float(torch.linalg.norm(errs)) / self.nkpts
            de = abs(e_tot - e_last)
            if self.verbose >= 4:
                print(f'{type(self).__name__} cycle {cycle}: E={e_tot:.12f} '
                      f'dE={de:.2e} |g|={gnorm:.2e}')
            if cycle > 0 and de < self.conv_tol and gnorm < conv_tol_grad:
                conv = True
                break
            e_last = e_tot
        # the canonical orbitals of the converged Fock matrix and their energy
        e, c = self.eig_all(h1e + self.get_veff(dm), x)
        occ = self.get_occ(e)
        dm = self.make_rdm1(c, occ)
        self.e_tot = self.energy_elec(dm, h1e, self.get_veff(dm)) + e_nuc
        sync(s.device)
        self.timings = {'setup': t1 - t0,
                        'scf_loop': time.perf_counter() - t1}
        self.scf_cycles = cycle + 1
        self.converged = conv
        self.mo_energy, self.mo_coeff, self.mo_occ = e, c, occ
        return self.e_tot

    def run(self):
        self.kernel()
        return self

    def get_bands(self, kpts_band, dm=None):
        """Band energies (nb, nmo) and orbitals (nb, nao, nmo) at the
        k-points kpts_band (nb, 3) from the converged density: hcore, S
        and the mean field at the band points (_band_veff)."""
        kpts_band = np.asarray(kpts_band, dtype=np.float64).reshape(-1, 3)
        dm = self.make_rdm1() if dm is None else dm
        band = KFFTDF(self.cell, kpts_band)
        band.ao_deriv = self._ao_deriv()
        fock = band.get_hcore_kpts() + self._band_veff(dm, band)
        return self.eig_all(fock, self.canonical_orth(band.get_ovlp_kpts()))

    def _band_veff(self, dm, band, hyb=1.0):
        """J - hyb/2 K at the band points of the KFFTDF band from the
        density dm of the SCF k-points, the Ewald exxdiv term only at band
        points that coincide with SCF points."""
        vj, vk = self.with_df.get_jk_bands(dm, band)
        if self.exxdiv == 'ewald':
            s = self.get_ovlp()
            for k, kpt in enumerate(self.kpts):
                for b in np.where(np.linalg.norm(band.kpts - kpt, axis=1)
                                  < 1e-9)[0]:
                    vk[b] += self.madelung() * (s[k] @ dm[k] @ s[k])
        return vj - 0.5 * hyb * vk
