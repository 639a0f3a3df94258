"""Geometry optimisation: a Cartesian BFGS over the mean field's nuclear
gradient, and a transition-state search on its Hessian.

Counterpart of pyscf_tpu/geomopt/__init__.py: optimize (:10-40), whose
energy and gradient of each geometry come from mf_factory and whose
quasi-Newton step is scipy.optimize.minimize's on the host, and
optimize_ts (:43-127), P-RFO on hessian.Hessian(mf) with Bofill updates, in
numpy on the host (the Hessian runs on mf's device). geomopt.internal holds
the optimiser in redundant internal coordinates.
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
    """First-order saddle-point search by partitioned rational-function
    optimisation (P-RFO, eigenvector following), step for step as
    pyscf_tpu/geomopt/__init__.py:43-127: uphill along the lowest mode of
    the Hessian, downhill along the rest, steps scaled to at most `trust`
    Bohr, the Hessian from hessian.Hessian(mf) at the start (and every
    hess_update_every steps if that is not 0), Bofill-updated from the
    gradients in between.

    mf_factory(mol) returns a converged mean field with .e_tot and
    .Gradients(). Returns (the copy of mol at the saddle, the energy of
    every geometry evaluated); the copy's _ts_grad_norm is max|g| there."""
    mol = mol.copy()
    n = 3 * mol.natm
    energies = []

    def eval_eg(x):
        m = mol.copy()
        m.set_geom_(x.reshape(-1, 3))
        mf = mf_factory(m)
        return float(mf.e_tot), np.asarray(mf.Gradients().kernel()).ravel(), mf

    def eval_hess(mf):
        from ..hessian import Hessian
        return np.asarray(Hessian(mf).kernel()).reshape(n, n)

    x = np.asarray(mol.coords).ravel().copy()
    e, g, mf = eval_eg(x)
    energies.append(e)
    H = eval_hess(mf)
    g_old = x_old = None
    for step in range(maxsteps):
        if abs(g).max() < gtol:
            break
        if hess_update_every and step and step % hess_update_every == 0:
            H = eval_hess(mf)
        elif g_old is not None:
            # Bofill: phi SR1 + (1 - phi) PSB
            dx = x - x_old
            xi = g - g_old - H @ dx
            denom_sr1 = xi @ dx
            phi = 0.0
            if abs(denom_sr1) > 1e-12:
                phi = (xi @ dx) ** 2 / ((xi @ xi) * (dx @ dx) + 1e-30)
                H = H + phi * np.outer(xi, xi) / denom_sr1
            dd = dx @ dx
            if dd > 1e-14:
                H = H + (1 - phi) * (
                    (np.outer(xi, dx) + np.outer(dx, xi)) / dd
                    - (xi @ dx) * np.outer(dx, dx) / dd ** 2)
        w, V = np.linalg.eigh(0.5 * (H + H.T))
        gq = V.T @ g
        # the shifts: lam_max above the lowest mode's eigenvalue b0, lam
        # below the others' (Newton on sum g^2 / (lam - b) = lam)
        b0, g0 = w[0], gq[0]
        lam_max = 0.5 * (b0 + np.sqrt(b0 * b0 + 4.0 * g0 * g0))
        rest_b, rest_g = w[1:], gq[1:]
        lam = min(0.0, rest_b.min() if rest_b.size else 0.0) - 1e-6
        for _ in range(100):
            f = np.sum(rest_g ** 2 / (lam - rest_b)) - lam
            df = -np.sum(rest_g ** 2 / (lam - rest_b) ** 2) - 1.0
            step_l = f / df
            lam -= step_l
            if abs(step_l) < 1e-12:
                break
        dq = np.zeros(n)
        dq[0] = -g0 / (b0 - lam_max)
        dq[1:] = -rest_g / (rest_b - lam)
        dx = V @ dq
        norm = np.linalg.norm(dx)
        if norm > trust:
            dx *= trust / norm
        x_old, g_old = x, g
        x = x + dx
        e, g, mf = eval_eg(x)
        energies.append(e)
    mol.set_geom_(x.reshape(-1, 3))
    mol._ts_grad_norm = float(abs(g).max())
    return mol, energies
