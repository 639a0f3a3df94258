"""Nuclear Hessians, harmonic frequencies and thermochemistry.

Counterpart of pyscf_tpu/hessian/__init__.py: hessian_fd and HessianFD
(central differences of the analytic gradient), harmonic_analysis and thermo
(reference hessian/thermo.py:40 harmonic_analysis, :136 thermo), and the
Hessian(mf) dispatcher. The analytic Hessian of DF-RHF is hessian/rhf.py.
"""
import numpy as np

from ..data.elements import MASSES
from ..lib.parameters import AMU2AU, BOLTZMANN_AU, HARTREE2WAVENUMBER


def hessian_fd(grad_factory, mol, step=1e-3):
    """(natm, 3, natm, 3) Hessian from central differences of gradients,
    symmetrised. grad_factory(mol) -> (natm, 3) gradient (runs the SCF)."""
    natm = mol.natm
    h = np.zeros((natm, 3, natm, 3))
    coords0 = np.asarray(mol.coords).copy()
    for A in range(natm):
        for x in range(3):
            g = []
            for s in (step, -step):
                c = coords0.copy()
                c[A, x] += s
                g.append(np.asarray(grad_factory(mol.copy().set_geom_(c))))
            h[A, x] = (g[0] - g[1]) / (2 * step)
    return 0.5 * (h + h.transpose(2, 3, 0, 1))


def harmonic_analysis(mol, hess, masses=None):
    """Frequencies (cm^-1) and normal modes of a Cartesian Hessian.

    masses: optional per-atom masses in electron-mass units (default: the
    standard atomic weights, the reference thermo convention)."""
    natm = mol.natm
    if masses is None:
        masses = np.array([MASSES[z] for z in mol.charges]) * AMU2AU
    invsqrt = 1.0 / np.sqrt(np.repeat(masses, 3))
    H = np.asarray(hess).reshape(natm * 3, natm * 3)
    w2, modes = np.linalg.eigh(H * invsqrt[:, None] * invsqrt[None, :])
    freq_au = np.sign(w2) * np.sqrt(np.abs(w2))
    return {'freq_wavenumber': freq_au * HARTREE2WAVENUMBER,
            'norm_mode': modes, 'freq_au': freq_au}


def thermo(mol, freq_au, e_tot, temperature=298.15, pressure=101325.0):
    """Ideal-gas RRHO vibrational thermochemistry (reference
    hessian/thermo.py:136): the 3 natm - 6 (5 for a diatomic) largest |freq|
    are the vibrations."""
    kT = BOLTZMANN_AU * temperature
    natm = mol.natm
    nfree = 3 * natm - (5 if natm == 2 else 6 if natm > 2 else 0)
    freqs = np.sort(np.abs(freq_au))[-nfree:] if nfree > 0 else np.array([])
    freqs = freqs[freqs > 1e-8]
    zpe = 0.5 * freqs.sum()
    e_vib = zpe + np.sum(freqs / (np.exp(freqs / kT) - 1.0))
    s_vib = np.sum(freqs / kT / (np.exp(freqs / kT) - 1.0)
                   - np.log(1.0 - np.exp(-freqs / kT)))
    return {'ZPE': zpe, 'E_vib': e_vib, 'S_vib(k)': s_vib,
            'E_tot+ZPE': float(e_tot) + zpe}


def Hessian(mf, **kwargs):
    """Nuclear Hessian of a converged mean field (reference mf.Hessian()).

    DF-RHF: the analytic Hessian (hessian/rhf.py). Where the reference falls
    back to HessianFD (no density fitting; a range-separated or VV10
    functional), so does the port. DF-RKS, DF-UHF and DF-UKS raise
    NotImplementedError: the reference computes them analytically, and a
    finite-difference Hessian would be a different result."""
    from ..scf.uhf import UHF
    if mf.with_df is None:
        return HessianFD(mf, **kwargs)
    if hasattr(mf, 'xc') and (mf.xc_obj.omega or mf.nlc):
        return HessianFD(mf, **kwargs)
    if isinstance(mf, UHF):
        raise NotImplementedError(
            'the analytic DF-UHF/UKS Hessian (pyscf_tpu/hessian/uhf.py) is '
            'not ported yet: it comes after the DF-RKS Hessian')
    from .rhf import Hessian as AnalyticHessian
    return AnalyticHessian(mf, **kwargs)


class HessianFD:
    """Semi-analytic nuclear Hessian: central differences of the port's
    analytic gradient, the reference's fallback and cross-check of the
    analytic Hessian."""

    def __init__(self, mf, step=1e-3):
        self._scf = mf
        self.mol = mf.mol
        self.step = step
        self.de = None

    def kernel(self):
        from ..scf.uhf import UHF
        mf0 = self._scf

        def grad_factory(m2):
            unrestricted = isinstance(mf0, UHF)
            if hasattr(mf0, 'xc'):
                f = (m2.UKS if unrestricted else m2.RKS)(xc=mf0.xc)
            else:
                f = m2.UHF() if unrestricted else m2.RHF()
            if mf0.with_df is not None:
                f = f.density_fit(mf0.with_df.auxbasis)
            f.conv_tol = min(mf0.conv_tol, 1e-11)
            f.kernel()
            return f.Gradients().kernel()

        self.de = hessian_fd(grad_factory, self.mol, self.step)
        return self.de

    run = kernel
