"""Analytic nuclear Hessian of density-fitted UHF and UKS through the
spin-coupled coupled-perturbed equations.

Counterpart of pyscf_tpu/hessian/uhf.py. The JAX package takes the jvp of
its analytic gradient g(X, D, W) along (dX_t, dD_t, dW_t) with D = (D_a,
D_b) and W the total energy-weighted density; here the same derivative is
written out on the DF gradient of grad/df.py, as hessian/rhf.py does for
the closed shell, with the shared helpers of hessian/rhf.py taking one
occupied block per spin:
  - J of the total density D_a + D_b, K_s of each spin's D_s with the
    weight hyb (pyscf_tpu/hessian/uhf.py:118-131,141,151-152), so the Fock
    derivative at fixed density F'_t,s = h'_t + J'_t - hyb K'_t,s (+ V'_t,s)
    (_fock1) and the DF rows (_rows_df) sum Gamma^P and W_PQ over both
    spins;
  - CPHF over the stacked amplitudes U = (U_a (nv_a, no_a), U_b) with dD_s
    = Cv_s U_s Co_s^T + h.c. - Co_s s'_oo,s Co_s^T, the response G_s[dD] =
    J[dD_a + dD_b] - hyb K[dD_s] (+ fxc_s[dD]) on the MO blocks of B (one
    _mo_response block per spin), solved by hessian/rhf.py cphf_pcg
    (pyscf_tpu/hessian/uhf.py:199-240, cphf_max_cycle 50);
  - dW = sum_s of the closed-shell form of each spin (occupation 1), with
    the full occupied block e_oo,s = f'_oo,s - 1/2 (s'_oo,s e_s + e_s
    s'_oo,s); reference_w=True keeps only its diagonal, as
    pyscf_tpu/hessian/uhf.py:245-254 does (ROADMAP section 3 item 2);
  - DF-UKS: V'_t,s = dV_xc,s/dX_t at fixed D and E_xc's fixed-D Hessian
    (NumInt.uks_xc_hessian: kernels eval_ao deriv 3, xc_uks_hess and
    xc_uks_deriv1, GEMMs), and in CPHF's right-hand side, CG steps and dW's
    occupied block the tangent of V_xc along dD (NumInt.uks_response,
    kernel xc_uks_fxc). The default symmetrises dE_xc/dD_s;
    reference_vxc=True takes the JAX package's unsymmetrised form (its
    jax.grad of _exc_quadrature in D, as for RKS).
"""
import torch

from ..grad import df as grad_df
from ..grad.rhf import _ao2atom_map
from . import rhf
from .rhf import (_Clock, _DFDerivs, _first_1e, _fock1, _hess_1e, _hess_2c,
                  _hess_3c, _mo_response, _rows_df, _xc_terms, cphf_pcg,
                  hess_nuc, tangent_chunks)


class Hessian(rhf.Hessian):
    """Analytic Hessian of a converged DF-UHF or DF-UKS (pure or global
    hybrid) mean field: Hessian(mf).kernel() -> (natm, 3, natm, 3) numpy in
    Ha/Bohr^2; `timings` and `cphf_cycles` as hessian/rhf.py's. The
    reference's forms are hessian()'s reference_w and reference_vxc."""

    cphf_max_cycle = 50

    @staticmethod
    def _check_kind(mf):
        from ..scf.uhf import UHF
        if not isinstance(mf, UHF):
            raise NotImplementedError('unrestricted (UHF/UKS) only')

    @staticmethod
    def _hessian(*args):
        return hessian(*args)


def hessian(mf, cphf_max_cycle=50, cphf_tol=1e-9, tangent_chunk=6,
            timings=None, reference_w=False, reference_vxc=False):
    """((natm, 3, natm, 3) numpy Hessian, CPHF iterations) of a converged
    DF-UHF or DF-UKS mean field; timings, if given, receives the seconds of
    hessian/rhf.py's phases ('s1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e',
    'rows_df', 'rows_3c', 'rows_2c', and for DF-UKS 'xc_rows' and 'xc_F1').
    reference_w and reference_vxc as the module docstring says."""
    mol = mf.mol
    dev = mol.device
    auxmol = mf.with_df.build().auxmol
    natm = mol.natm
    nt = 3 * natm
    isks = hasattr(mf, 'xc')
    hyb = mf._numint.rsh_and_hybrid_coeff(mf.xc)[2] if isks else 1.0
    clock = _Clock(dev, {} if timings is None else timings)
    f64 = dict(dtype=torch.float64, device=dev)

    Co, Cv, eo, ev = [], [], [], []
    for s in (0, 1):
        sel = mf.mo_occ[s] > 0
        Co.append(mf.mo_coeff[s][:, sel])
        Cv.append(mf.mo_coeff[s][:, ~sel])
        eo.append(mf.mo_energy[s][sel])
        ev.append(mf.mo_energy[s][~sel])
    no = [c.shape[1] for c in Co]
    nv = [c.shape[1] for c in Cv]
    D = torch.stack([c @ c.T for c in Co])
    ao2atom = torch.as_tensor(_ao2atom_map(mol), device=dev)
    B = mf.with_df.cderi

    s1, h1 = _first_1e(mol, ao2atom)
    clock.lap('s1h1')
    h1s = h1.expand(2, *h1.shape)                       # h'_t + V'_t,s
    hxx_xc = 0.0
    if isks:
        V1, hxx_xc = _xc_terms(mf, D, tangent_chunk, clock, reference_vxc)
        h1s = h1s + V1
        del V1
    dfd = _DFDerivs(mol, auxmol, B, mf.with_df.whitener, Co)
    clock.lap('ip1_3c')

    chunks = tangent_chunks(nt, tangent_chunk)
    F1 = h1s + _fock1(dfd, chunks, [hyb, hyb])
    clock.lap('F1')

    # CPHF (pyscf_tpu/hessian/uhf.py:188-240)
    s1_oo = [c.T @ s1 @ c for c in Co]                  # (nt, no, no)
    s1_vo = [v.T @ s1 @ c for c, v in zip(Co, Cv)]
    vxc = None
    if isks:
        ni = mf._numint
        aod, weights = ni.grid_ao(mol, mf.grids,
                                  1 if mf.xc_obj.is_gga else 0, spins=2)
        vxc = ni.uks_response(mf.xc, aod, weights, D,
                              sym=not reference_vxc)
    g = _mo_response(B, list(zip(Co, Cv)), hyb, vxc)
    minus_s1 = [-x for x in s1_oo]
    g_oo_vo = g(minus_s1, [torch.zeros((nt, v, o), **f64)
                           for v, o in zip(nv, no)])[0]
    sizes = [v * o for v, o in zip(nv, no)]
    rhs = torch.cat([
        (-(v.T @ F1[s] @ c) - g_oo_vo[s] + s1_vo[s] * eo[s]).permute(
            1, 2, 0).reshape(sizes[s], nt)
        for s, (c, v) in enumerate(zip(Co, Cv))])[:, None, :]
    ediff = torch.cat([(ev[s][:, None] - eo[s][None, :]).reshape(-1)
                       for s in (0, 1)])[:, None]       # (N, 1)
    zero_oo = [torch.zeros((1, o, o), **f64) for o in no]

    def split(u):
        """(N, 1, T) -> [U_s (T, nv_s, no_s)]"""
        return [p.reshape(nv[s], no[s], -1).permute(2, 0, 1)
                for s, p in enumerate(torch.split(u[:, 0], sizes))]

    def matvec(u):
        T = u.shape[2]
        gvo = g([z.expand(T, -1, -1) for z in zero_oo], split(u))[0]
        return ediff[:, :, None] * u + torch.cat([
            x.permute(1, 2, 0).reshape(-1, T) for x in gvo])[:, None]

    U, _, cycles = cphf_pcg(matvec, rhs, ediff, cphf_max_cycle, cphf_tol)
    U = split(U)
    g_oo = g(minus_s1, U)[1]
    dD, dW = [], 0.0
    for s in (0, 1):
        c, v, e = Co[s], Cv[s], eo[s]
        half = v @ U[s] @ c.T
        dD.append(half + half.transpose(-1, -2) - c @ s1_oo[s] @ c.T)
        f1_oo = c.T @ F1[s] @ c + g_oo[s]
        dCo = v @ U[s] - 0.5 * c @ s1_oo[s]
        e_oo = f1_oo - 0.5 * (s1_oo[s] * e + e[:, None] * s1_oo[s])
        if reference_w:
            e_oo = torch.diag_embed(torch.diagonal(e_oo, dim1=1, dim2=2))
        dW = dW + ((dCo * e) @ c.T + (c * e) @ dCo.transpose(-1, -2)
                   + c @ e_oo @ c.T)
    del F1
    clock.lap('cphf')

    # H[s, t]: rows s of the perturbations, columns t of the gradient
    H = -dW.reshape(nt, -1) @ s1.reshape(nt, -1).T
    for s in (0, 1):
        H += dD[s].reshape(nt, -1) @ h1s[s].reshape(nt, -1).T
    del h1s
    dm, cos, dme, kfac = grad_df.occupied(mf)
    hxx = _hess_1e(mol, dm, dme, ao2atom)
    clock.lap('rows_1e')

    H += _rows_df(dfd, chunks, dD, [hyb, hyb])
    clock.lap('rows_df')

    _, gamma, Wpq = grad_df.fitted_weights(mf, dm, cos, kfac)
    hxx += _hess_3c(mol, auxmol, gamma)
    del gamma
    clock.lap('rows_3c')
    hxx += _hess_2c(auxmol, Wpq)
    clock.lap('rows_2c')
    hxx = hxx.reshape(natm, natm, 3, 3).permute(0, 2, 1, 3).reshape(nt, nt)
    H = H + hxx + hxx_xc
    H = 0.5 * (H + H.T)
    h = H.cpu().numpy().reshape(natm, 3, natm, 3) + hess_nuc(mol)
    return h, cycles
