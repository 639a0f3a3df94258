"""Density-fitted nuclear gradients of pyscf_tpu_torch on the CPU against
pyscf_tpu: the plain twins of the five kernels the DF gradient adds
(int3c2e_ip, int2c2e_ip1, eval_ao deriv 2, xc_rks_grad, xc_uks_grad) and
the gradient of DF-RHF, DF-RKS, DF-UHF and DF-UKS end to end.

jax.grad of the JAX package's DF intermediates runs live on H2/sto-3g
(one bra class, aux l <= 2, ~10 s); on water, whose aux basis reaches
l = 4, it takes 23-54 s per case, and the JAX gradient program 67-220 s,
too long for the fast tests: those references are recorded in
pyscf_tpu_torch/refs.py with the commands that made them. jax.jacfwd of
eval_ao and jax.grad of the XC quadrature run live."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.df.addons import make_auxmol as jax_make_auxmol
from pyscf_tpu.dft import gen_grid as jax_gen_grid
from pyscf_tpu.dft import xc as jax_xc
from pyscf_tpu.dft.numint import _pad_grid
from pyscf_tpu.grad import autodiff
from pyscf_tpu.ops.eval_gto import eval_ao as jax_eval_ao

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.dft import gen_grid, numint, xc
from pyscf_tpu_torch.grad.rhf import ao_rows_to_atoms, _ao2atom_map
from pyscf_tpu_torch.ops import eval_gto
from pyscf_tpu_torch.ops.integrals import j3c_deriv

torch.set_num_threads(1)


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert np.max(np.abs(np.asarray(got) - ref)) <= rel * np.max(np.abs(ref))


def _seeded_densities(nao, naux):
    """The seeded D, orbitals C, a, b and W of refs.DF_DERIV_FUNCTIONALS."""
    rng = np.random.default_rng(11)
    C = rng.standard_normal((nao, 3)) * 0.3
    D = 2 * C @ C.T
    a = rng.standard_normal(naux)
    b = rng.standard_normal((naux, 3, 3))
    b = b + b.transpose(0, 2, 1)
    W = rng.standard_normal((naux, naux))
    W = W + W.T
    return D, C, a, b, W


def _port_functionals(mol, auxmol, D, C, a, b, W):
    """(grad_3c, grad_2c) of the port on the fitted densities whose energy
    is gamma . a + sum(O * b) and sum((P|Q) * W)."""
    gamma = torch.as_tensor(a[:, None, None] * D + C @ b @ C.T)
    return (j3c_deriv.grad_3c(mol, auxmol, gamma).numpy(),
            j3c_deriv.grad_2c(auxmol, torch.as_tensor(W)).numpy())


def test_df_derivative_integrals_match_live_jax():
    """The twins of int3c2e_ip and int2c2e_ip1 against a live jax.grad of
    autodiff._df_intermediates and _j2c on H2/sto-3g (one bra class with
    an off-diagonal pair, aux l = 0, 1, 2): 1e-10 x max."""
    atom = 'H 0 0 0; H 0.1 0.2 0.74'
    jmol = jpt.M(atom=atom, basis='sto-3g', verbose=0)
    jaux = jax_make_auxmol(jmol)
    pairs, auxes = autodiff._build_host_data_cached(jmol, jaux)
    mol = tpt.M(atom=atom, basis='sto-3g', device='cpu')
    auxmol = make_auxmol(mol)
    nao, naux = mol.nao, auxmol.nao
    assert (nao, naux) == (jmol.nao, jaux.nao)
    assert sorted(auxmol.shell_groups) == [0, 1, 2]
    D, C, a, b, W = _seeded_densities(nao, naux)
    dm_blocks = [sp.mat_blocks(D) for sp in pairs]
    co_sets = [[sp.co_blocks(C) for sp in pairs]]

    def f3(X):
        gam, Os = autodiff._df_intermediates(pairs, auxes, naux, X,
                                             dm_blocks, co_sets)
        return jnp.dot(gam, a) + jnp.sum(Os[0] * b)

    def f2(X):
        return jnp.sum(autodiff._j2c(auxes, naux, X) * W)

    X = jnp.asarray(np.asarray(jmol.coords))
    got3, got2 = _port_functionals(mol, auxmol, D, C, a, b, W)
    _close(got3, jax.jit(jax.grad(f3))(X), 1e-10)
    _close(got2, jax.jit(jax.grad(f2))(X), 1e-10)


@pytest.mark.parametrize('basis', ['sto-3g', 'def2-svp'])
def test_df_derivative_integrals_match_jax(basis):
    """The twins of int3c2e_ip and int2c2e_ip1 with their sums by atom,
    on the seeded fitted densities of refs.py, against jax.grad of
    autodiff._df_intermediates and _j2c (recorded): 1e-10 x max. The
    default aux basis (def2-universal-jkfit) reaches l = 4; def2-SVP brings
    the bra classes up to (dd|g)."""
    mol = tpt.M(atom=refs.WATER, basis=basis, device='cpu')
    auxmol = make_auxmol(mol)
    assert max(auxmol.shell_groups) == 4
    got3, got2 = _port_functionals(
        mol, auxmol, *_seeded_densities(mol.nao, auxmol.nao))
    ref = refs.DF_DERIV_FUNCTIONALS[basis]
    _close(got3, ref['3c'], 1e-10)
    _close(got2, ref['2c'], 1e-10)


@pytest.fixture(scope='module')
def water_grid():
    """(JAX mole, port mole, the JAX package's level-1 grid as numpy)."""
    jmol = jpt.M(atom=refs.WATER, basis='def2-svp', verbose=0)
    grids = jax_gen_grid.Grids(jmol)
    grids.level = 1
    grids.build()
    return (jmol, tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu'),
            np.asarray(grids.coords), np.asarray(grids.weights))


def test_eval_ao_deriv2_matches_jax_jacfwd(water_grid):
    """jax.jacfwd of eval_ao(deriv=1, atom_coords=X) is -d_i d_j phi_mu on
    mu's atom and zero on the others; 1e-12 x max on 300 grid points."""
    jmol, mol, coords, _ = water_grid
    pts = np.array(coords[::33][:300])
    jac = np.asarray(jax.jit(jax.jacfwd(lambda X: jax_eval_ao(
        jmol, pts, deriv=1, atom_coords=X)))(jnp.asarray(jmol.coords)))
    got = eval_gto.eval_ao(mol, torch.as_tensor(pts), deriv=2).numpy()
    assert got.shape == (10, pts.shape[0], mol.nao)
    own = np.zeros((mol.nao, mol.natm))
    own[np.arange(mol.nao), _ao2atom_map(mol)] = 1.0
    want = np.zeros((10,) + got.shape[1:])
    want[0] = np.asarray(jax_eval_ao(jmol, pts, deriv=0))
    want[1:4] = -np.einsum('pnax,na->xpn', jac[0], own)
    for k, (i, j) in enumerate(eval_gto.SECOND_DERIVS):
        want[4 + k] = -np.einsum('pna,na->pn', jac[1 + i, ..., j], own)
    assert not np.any(jac * (1.0 - own)[None, None, :, :, None])
    _close(got, want, 1e-12)


def test_xc_grad_matches_jax(water_grid):
    """The twin of xc_rks_grad with its sum by atom on a seeded density,
    b3lypg on the level-1 grid, against jax.grad of
    autodiff._exc_quadrature (restricted): 1e-10 x max."""
    jmol, mol, coords, weights = water_grid
    rng = np.random.default_rng(5)
    c = rng.standard_normal((mol.nao, 5)) * 0.3
    dm = 2 * c @ c.T
    f = jax_xc.parse_xc('b3lypg')
    pc, pw = _pad_grid(coords, weights)
    jexc, ref = jax.jit(jax.value_and_grad(
        lambda X: autodiff._exc_quadrature(jmol, f, X, jnp.asarray(dm), pc,
                                           pw, True)))(
        jnp.asarray(jmol.coords))
    grids = gen_grid.Grids(mol)
    grids.coords = torch.tensor(coords)
    grids.weights = torch.tensor(weights)
    exc, g = numint.NumInt().rks_grad(mol, grids, 'b3lypg',
                                      torch.as_tensor(dm))
    _close(ao_rows_to_atoms(mol, g).numpy(), np.asarray(ref), 1e-10)
    assert abs(float(exc) - float(jexc)) <= 1e-12 * abs(float(jexc))


def test_xc_grad_lda_is_first_derivatives_only():
    """An LDA takes the AO gradients (4, B, nao) and one dmao row; the
    vsigma terms vanish, so it equals the GGA formula with sigma unused."""
    rng = np.random.default_rng(2)
    aod = torch.as_tensor(rng.standard_normal((10, 40, 6)) * 0.2)
    dm = torch.as_tensor(np.eye(6) * 0.4)
    dmao = (aod[:4].reshape(-1, 6) @ dm).reshape(4, 40, 6)
    w = torch.as_tensor(rng.random(40))
    f = xc.parse_xc('lda,vwn')
    g4, e4 = numint.xc_rks_grad_plain(aod[:4], dmao[:1], w, f)
    g10, e10 = numint.xc_rks_grad_plain(aod, dmao, w, f)
    assert torch.allclose(g4, g10, rtol=0, atol=1e-14) and e4 == e10
    assert float(g4.abs().max()) > 1e-3


CASES = {
    # (mol kwargs, mean field, JAX energy, JAX gradient)
    'rhf-sto3g': (dict(basis='sto-3g'), lambda m: m.RHF().density_fit(),
                  refs.E_WATER_DF_RHF_STO3G, refs.GRAD_WATER_DF_RHF_STO3G),
    'rhf': (dict(basis='def2-svp'), lambda m: m.RHF().density_fit(),
            refs.E_WATER_DF_RHF_DEF2SVP, refs.GRAD_WATER_DF_RHF_DEF2SVP),
    'rks': (dict(basis='def2-svp'), lambda m: m.RKS(xc='b3lypg').density_fit(),
            refs.E_WATER_DF_RKS_B3LYPG_L1, refs.GRAD_WATER_DF_RKS_B3LYPG_L1),
    'uhf': (dict(basis='def2-svp', charge=1, spin=1),
            lambda m: m.UHF().density_fit(), refs.E_WATER_CATION_DF_UHF_DEF2SVP,
            refs.GRAD_WATER_CATION_DF_UHF_DEF2SVP),
    'uks': (dict(basis='def2-svp', charge=1, spin=1),
            lambda m: m.UKS(xc='b3lypg').density_fit(),
            refs.E_WATER_CATION_DF_UKS_B3LYPG_L1,
            refs.GRAD_WATER_CATION_DF_UKS_B3LYPG_L1),
}


def _converged(case):
    kwargs, build, _, _ = CASES[case]
    mf = build(tpt.M(atom=refs.WATER, device='cpu', **kwargs))
    if hasattr(mf, 'grids'):
        mf.grids.level = 1
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.kernel()
    assert mf.converged
    return mf


@pytest.mark.parametrize('case', list(CASES))
def test_df_gradient_matches_recorded_jax(case):
    """mf.nuc_grad_method().kernel() against the JAX gradient recorded in
    refs.py: 1e-8 Ha/Bohr (the SCF here stops at conv_tol_grad 1e-7, the
    reference at 1e-9). DF-RHF and DF-UHF are translationally invariant to
    1e-9; DF-RKS and DF-UKS hold their grid fixed, as the reference does,
    so their sum is the missing grid response and is not gated."""
    _, _, e_ref, g_ref = CASES[case]
    mf = _converged(case)
    assert abs(mf.e_tot - e_ref) < 1e-9
    g = mf.nuc_grad_method()
    de = g.kernel()
    assert isinstance(de, np.ndarray) and de.shape == (3, 3)
    assert np.max(np.abs(de - np.array(g_ref))) < 1e-8
    phases = {'int1e_ip', 'contract', 'int3c2e_ip', 'int2c2e_ip1'}
    if case in ('rks', 'uks'):
        phases |= {'ao2', 'xc_grad'}
    else:
        assert np.max(np.abs(de.sum(axis=0))) < 1e-9
    assert set(g.timings) == phases


def test_incore_uks_gradient_raises():
    """No finite differences of a UHF energy for a conventional UKS, which
    is what the reference's non-DF branch computes: the gradient raises
    and says so."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', charge=1, spin=1,
                device='cpu')
    mf = mol.UKS(xc='b3lypg')
    with pytest.raises(NotImplementedError, match='UHF energy'):
        mf.nuc_grad_method().kernel()


@pytest.fixture(scope='module')
def lih_cation():
    """(JAX mole, port mole, 400 seeded points and weights, the seeded spin
    density (2, nao, nao), the index of the point where rho_a sits under
    its floor RHO_THR/2) on LiH+/sto-3g (s and p shells).

    dm_b is positive semidefinite; dm_a is too, less a rank-one term along
    the AO values of one point that leaves rho_a = 2e-11 there, so that
    only the beta spin passes its floor while the total passes the mask."""
    atom = 'Li 0 0 0; H 0.2 0.1 1.6'
    jmol = jpt.M(atom=atom, basis='sto-3g', charge=1, spin=1, verbose=0)
    mol = tpt.M(atom=atom, basis='sto-3g', charge=1, spin=1, device='cpu')
    rng = np.random.default_rng(17)
    pts = rng.standard_normal((400, 3)) * 1.5 + np.array([0.1, 0.05, 1.5])
    w = rng.random(400) * 0.05
    ca, cb = (rng.standard_normal((mol.nao, 2)) * 0.4 for _ in range(2))
    dma, dmb = ca @ ca.T, cb @ cb.T
    p0 = 7
    phi = eval_gto.eval_ao(mol, torch.as_tensor(pts[p0:p0 + 1]))[0].numpy()
    r0 = phi @ dma @ phi
    dma = dma - (r0 - 2e-11) * np.outer(phi, phi) / (phi @ phi) ** 2
    return jmol, mol, pts, w, np.stack([dma, dmb]), p0


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_xc_uks_grad_matches_live_jax(lih_cation, xc_code):
    """The twin of xc_uks_grad with its sum by atom against a live
    jax.value_and_grad of autodiff._exc_quadrature (unrestricted) on
    seeded points, weights and spin densities: 1e-10 x max, exc 1e-12
    relative. At point p0 rho_a is under RHO_THR/2 and rho_b is not:
    there vrho_a and vsigma_aa drop out and the beta and sigma_ab terms
    stay, as jax.grad takes them through the clamps."""
    jmol, mol, pts, w, dm, p0 = lih_cation
    ao = eval_gto.eval_ao(mol, torch.as_tensor(pts)).numpy()
    rho = np.einsum('pi,sij,pj->sp', ao, dm, ao)
    assert 0 < rho[0, p0] < 0.5 * numint.RHO_THR
    assert rho[:, p0].sum() > 1e3 * numint.RHO_THR
    f = jax_xc.parse_xc(xc_code)
    pc, pw = _pad_grid(jnp.asarray(pts), jnp.asarray(w))
    jexc, ref = jax.jit(jax.value_and_grad(
        lambda X: autodiff._exc_quadrature(jmol, f, X, jnp.asarray(dm), pc,
                                           pw, False)))(
        jnp.asarray(jmol.coords))
    grids = gen_grid.Grids(mol)
    grids.coords = torch.as_tensor(pts)
    grids.weights = torch.as_tensor(w)
    t = {}
    exc, g = numint.NumInt().uks_grad(
        mol, grids, xc_code, compat.spin_density_from_numpy(dm, 'cpu'), t)
    assert set(t) == {'ao2', 'xc_grad'}
    _close(ao_rows_to_atoms(mol, g).numpy(), np.asarray(ref), 1e-10)
    assert abs(float(exc) - float(jexc)) <= 1e-12 * abs(float(jexc))


def test_xc_uks_grad_closed_shell_is_xc_rks_grad(water_grid):
    """Two equal spin densities dm/2 give the closed-shell twin's gradient
    and energy of dm (1e-12 x max): the spin-polarized integrand reduces
    to the restricted one."""
    _, mol, coords, weights = water_grid
    rng = np.random.default_rng(9)
    c = rng.standard_normal((mol.nao, 4)) * 0.3
    dm = torch.as_tensor(2 * c @ c.T)
    pts = np.ascontiguousarray(coords[::7])
    aod = eval_gto.eval_ao(mol, torch.as_tensor(pts), deriv=2)
    dmao = (aod[:4].reshape(-1, mol.nao) @ dm).reshape(4, -1, mol.nao)
    w = torch.as_tensor(np.ascontiguousarray(weights[::7]))
    f = xc.parse_xc('b3lypg')
    g_r, e_r = numint.xc_rks_grad_plain(aod, dmao, w, f)
    g_u, e_u = numint.xc_uks_grad_plain(aod, 0.5 * torch.stack([dmao, dmao]),
                                        w, f)
    _close(g_u.numpy(), g_r.numpy(), 1e-12)
    assert abs(float(e_u - e_r)) <= 1e-12 * abs(float(e_r))
