"""Geometry optimisation: a Cartesian BFGS over the mean field's nuclear
gradient.

Counterpart of pyscf_tpu/geomopt/__init__.py:10-40 (optimize): the energy
and gradient of each geometry come from mf_factory, the quasi-Newton step
from scipy.optimize.minimize on the host. geomopt.internal holds the
optimiser in redundant internal coordinates.
"""
import numpy as np

from . import internal  # noqa: F401


def optimize(mf_factory, mol, maxsteps=50, gtol=3e-4, use_analytic=True):
    """Minimise the energy over the nuclear coordinates.

    mf_factory(mol) returns a converged mean field (with .e_tot and, for
    analytic forces, .Gradients()) or an energy. Without use_analytic, or
    without Gradients, the gradient is central differences of
    mf_factory's energy. Returns (the optimised copy of mol, the energy
    of every geometry evaluated)."""
    import scipy.optimize
    from ..grad.rhf import finite_difference_gradient
    mol = mol.copy()
    energies = []

    def energy(mf):
        return mf.e_tot if hasattr(mf, 'e_tot') else mf

    def fun(x):
        m = mol.copy()
        m.set_geom_(x.reshape(-1, 3))
        mf = mf_factory(m)
        e = energy(mf)
        energies.append(float(e))
        if use_analytic and hasattr(mf, 'Gradients'):
            g = np.asarray(mf.Gradients().kernel())
        else:
            g = finite_difference_gradient(
                lambda m2: energy(mf_factory(m2)), m)
        return float(e), g.ravel()

    res = scipy.optimize.minimize(
        fun, np.asarray(mol.coords).ravel(), jac=True, method='BFGS',
        options={'maxiter': maxsteps, 'gtol': gtol, 'norm': np.inf})
    mol.set_geom_(res.x.reshape(-1, 3))
    return mol, energies


def optimize_ts(mf_factory, mol, maxsteps=40, gtol=3e-4, trust=0.15,
                hess_update_every=0):
    """The transition-state search of pyscf_tpu/geomopt/__init__.py:43-127
    is not ported yet: its P-RFO steps take the nuclear Hessian, which the
    port has for DF-RHF (hessian/rhf.py) and not yet for the other mean
    fields."""
    raise NotImplementedError(
        'optimize_ts is not ported: its P-RFO steps take the nuclear '
        'Hessian, which the port has for DF-RHF only so far')
