"""The analytic DF-UHF and DF-UKS Hessians, the PBE family and the DF-UHF
transition-state search of pyscf_tpu_torch on the CPU against pyscf_tpu:
the open-shell XC Hessian twins against torch.func.hessian of the energy
density and against the closed-shell twins (which
tests/test_torch_hessian_rks.py holds to the JAX package's jax.hessian);
the OH radical's DF-UHF and DF-UKS b3lypg Hessians and the water cation's
DF-UKS PBE0 Hessian on the JAX package's orbitals against its recorded
Hessians (tests/hessian_refs_record.py oh_uhf, oh_uks, cation_pbe0); the
default Hessians against central differences of the port's gradient on a
fixed grid; the PBE family's energies and gradients against the recorded
JAX values (tests/port_refs_record.py pbe_refs); and the H + H2 exchange
saddle of tests/test_ts_opt.py.

The JAX package's UHF Hessian keeps only the diagonal of each spin's
occupied block of dW, and its DF-UKS dE_xc/dD_s is unsymmetrised for a
GGA: with reference_w=True (and reference_vxc=True) the port reproduces
it, and the default is the derivative of the gradient (ROADMAP section
3)."""
import numpy as np
import pytest
import torch

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import hessian, refs
from pyscf_tpu_torch.dft import gen_grid, numint
from pyscf_tpu_torch.dft import xc as xc_mod
from pyscf_tpu_torch.hessian import uhf as hess_uhf
from pyscf_tpu_torch.ops import eval_gto

import hessian_refs_record as rec

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def recorded():
    return np.load(refs.HESSIAN_REFS)


# ---- the open-shell XC Hessian twins ---------------------------------------

def _spin_block(code, n=40):
    """(aod, dmao (2, nd, B, nao), weights, xc, atom_off) at n seeded points
    around water/def2-SVP with seeded spin densities."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
                device='cpu')
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.normal(size=(n, 3)) * 1.5)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, n))
    dm = torch.stack([c @ c.T for c in (
        torch.as_tensor(rng.standard_normal((mol.nao, k))) * 0.3
        for k in (5, 4))])
    f = xc_mod.parse_xc(code)
    aod = eval_gto.eval_ao(mol, pts, 3 if f.is_gga else 2)
    nd = 4 if f.is_gga else 1
    dmao = torch.matmul(aod[:nd].reshape(-1, mol.nao), dm).reshape(
        2, nd, n, mol.nao)
    return aod, dmao, w, f, numint.atom_ranges(mol)[0]


@pytest.mark.parametrize('code', ['lda,vwn', 'b3lypg', 'pbe0'])
def test_uks_hess_twin_matches_torch_func(code):
    """xc_uks_hess_plain's w v and w H u_t against torch.func.grad and
    torch.func.hessian of the clamped open-shell energy density over the
    eight features (rho_a, grad rho_a, rho_b, grad rho_b), within 1e-12 of
    the largest element."""
    aod, dmao, w, f, atom_off = _spin_block(code)
    wv, ut, ht, _, _ = numint.xc_uks_hess_plain(aod, dmao, w, f, atom_off)
    lo = 0.5 * numint.RHO_THR

    def e_of_u(u):
        ga, gb = u[1:4], u[5:8]
        return f.exc_density(
            numint._max(u[0], lo), numint._max(u[4], lo),
            numint._max(ga @ ga, numint.SIGMA_FLOOR), ga @ gb,
            numint._max(gb @ gb, numint.SIGMA_FLOOR))

    rho = torch.clamp(torch.einsum('sbi,bi->sb', dmao[:, 0], aod[0]), min=0)
    if f.is_gga:
        g = 2.0 * torch.einsum('sbi,jbi->sjb', dmao[:, 0], aod[1:4])
    else:
        g = torch.zeros((2, 3, rho.shape[1]), dtype=torch.float64)
    U = torch.cat([rho[0, None], g[0], rho[1, None], g[1]]).T
    keep = torch.ones(8, dtype=torch.float64)
    if not f.is_gga:
        keep = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0], dtype=torch.float64)
    mask = ((rho[0] + rho[1]) > numint.RHO_THR)[:, None]
    v = torch.where(mask, torch.func.vmap(torch.func.grad(e_of_u))(U), 0.0)
    H = torch.func.vmap(torch.func.hessian(e_of_u))(U)
    H = torch.where(mask[:, :, None], H * keep[:, None] * keep, 0.0)
    ref_wv = w[:, None] * v * keep
    ref_ht = w[None, :, None] * torch.einsum('bcq,tbq->tbc', H, ut)
    assert torch.max(torch.abs(wv - ref_wv)) <= 1e-12 * ref_wv.abs().max()
    assert torch.max(torch.abs(ht - ref_ht)) <= 1e-12 * ref_ht.abs().max()


@pytest.mark.parametrize('code', ['lda,vwn', 'b3lypg', 'pbe0'])
def test_uks_xc_hessian_closed_shell_matches_rks(recorded, code):
    """uks_xc_hessian (xc_uks_hess_plain, xc_uks_deriv1_plain and the GEMMs
    of each spin) at D_a = D_b = D/2 against rks_xc_hessian at D on the
    recorded water/def2-SVP grid and density: E_xc's fixed-D Hessian
    alike, and each spin's F alike to the closed shell's, within 1e-9 of
    the largest element."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    grids = gen_grid.Grids(mol)
    grids.coords = torch.as_tensor(recorded['xc_grid_coords'])
    grids.weights = torch.as_tensor(recorded['xc_grid_weights'])
    D = torch.as_tensor(recorded['xc_dm'])
    ni = numint.NumInt()
    F, hxx = ni.rks_xc_hessian(mol, grids, code, D, tangent_chunk=4)
    Fu, hxxu = ni.uks_xc_hessian(mol, grids, code,
                                 torch.stack([0.5 * D, 0.5 * D]),
                                 tangent_chunk=4)
    assert torch.max(torch.abs(hxxu - hxx)) <= 1e-9 * hxx.abs().max()
    for s in (0, 1):
        assert torch.max(torch.abs(Fu[s] - F)) <= 1e-9 * F.abs().max()


# ---- the Hessians on the JAX orbitals ---------------------------------------

def _recorded_mf(recorded, case):
    """The port's mean field of a recorded case on the JAX package's
    orbitals (and grid, for DF-UKS)."""
    atom, basis = rec.CASES[case]
    charge, spin = rec.SPIN[case]
    mol = tpt.M(atom=atom, basis=basis, charge=charge, spin=spin,
                device='cpu')
    if case in rec.KS_CASES:
        mf = mol.UKS(xc=rec.KS_CASES[case][0]).density_fit()
        mf.grids.coords = torch.as_tensor(recorded[f'{case}_grid_coords'])
        mf.grids.weights = torch.as_tensor(recorded[f'{case}_grid_weights'])
    else:
        mf = mol.UHF().density_fit()
    for k in ('mo_coeff', 'mo_energy', 'mo_occ'):
        setattr(mf, k, torch.as_tensor(recorded[f'{case}_{k}']))
    mf.e_tot = float(recorded[f'{case}_e_tot'])
    mf.converged = True
    return mf


@pytest.mark.parametrize('case', ['oh_uhf', 'oh_uks', 'cation_pbe0'])
def test_hessian_on_jax_orbitals(recorded, case):
    """With the reference's W response (and, for DF-UKS, its unsymmetrised
    dE_xc/dD_s), within 1e-8 Ha/Bohr^2 of the JAX package's recorded
    Hessian on the same orbitals and grid; for the OH radical the default
    more than 1e-3 away (the reference's dW keeps only the diagonal of each
    spin's occupied block: 0.21 and 0.18 Ha/Bohr^2 here)."""
    mf = _recorded_mf(recorded, case)
    ref = recorded[f'{case}_hess']
    ks = case in rec.KS_CASES
    h = hess_uhf.hessian(mf, reference_w=True, reference_vxc=ks)[0]
    assert np.max(np.abs(h - ref)) < 1e-8
    if case.startswith('oh_'):
        assert np.max(np.abs(hess_uhf.hessian(mf)[0] - ref)) > 1e-3


# ---- the default Hessians against central differences ----------------------

def _scf(mol, xc_code, grids=None):
    mf = (mol.UKS(xc=xc_code) if xc_code else mol.UHF()).density_fit()
    if grids is not None:
        mf.grids.coords, mf.grids.weights = grids
    elif xc_code:
        mf.grids.level = 0
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    return mf


def _fd_gate(mol, xc_code, columns, points):
    """The default analytic Hessian of mol's DF-UHF (xc_code None) or DF-UKS
    on its level-0 grid, held fixed, against the central differences
    (points 2 or 4) of the port's gradient on the columns: 1e-5
    Ha/Bohr^2."""
    mf = _scf(mol, xc_code)
    hobj = mf.Hessian()
    assert isinstance(hobj, hess_uhf.Hessian)
    h = hobj.kernel()
    assert set(hobj.timings) >= {'s1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e',
                                 'rows_df', 'rows_3c', 'rows_2c'}
    assert 0 < hobj.cphf_cycles <= hobj.cphf_max_cycle
    grids = (mf.grids.coords, mf.grids.weights) if xc_code else None
    fd = hessian.fd_columns(
        lambda m: _scf(m, xc_code, grids).Gradients().kernel(), mol,
        columns, points=points)
    for (A, x), col in zip(columns, fd):
        assert np.max(np.abs(h[:, :, A, x] - col)) < 1e-5
    return h


def test_uhf_hessian_matches_central_differences():
    """OH/sto-3g DF-UHF, O's three columns by two-point differences; the
    translational sum rule holds without a grid."""
    mol = tpt.M(atom=rec.OH, basis='sto-3g', spin=1, device='cpu')
    h = _fd_gate(mol, None, [(0, x) for x in range(3)], 2)
    assert np.max(np.abs(h.sum(axis=0))) < 1e-8


@pytest.mark.parametrize('xc_code', ['b3lypg', 'pbe0'])
def test_uks_hessian_matches_central_differences(xc_code):
    """The water cation/sto-3g DF-UKS (charge 1, spin 1), O's z column by
    four-point differences on the fixed level-0 grid, the nucleus whose
    tight core the two-point stencil misses (the OH radical's DF-UKS on
    this grid does not converge: its beta pi hole drifts, in both
    packages)."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', charge=1, spin=1,
                device='cpu')
    _fd_gate(mol, xc_code, [(0, 2)], 4)


# ---- the PBE family against the recorded JAX values ------------------------

@pytest.fixture(scope='module')
def port_refs():
    return np.load(refs.PORT_REFS)


@pytest.mark.parametrize('case,xc_code,charge', [
    ('pbe0_rks', 'pbe0', 0), ('pbe_rks', 'pbe', 0), ('pbe0_uks', 'pbe0', 1)])
def test_pbe_energy_and_gradient_match_jax(port_refs, case, xc_code, charge):
    """Water/sto-3g DF-RKS PBE0 and PBE and the water cation's DF-UKS PBE0
    on the level-0 grid: the energy and, for PBE0, the DF gradient within
    1e-8 of the JAX package's (tests/port_refs_record.py pbe_refs)."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', charge=charge, spin=charge,
                device='cpu')
    mf = (mol.UKS if charge else mol.RKS)(xc=xc_code).density_fit()
    mf.grids.level = 0
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    e = mf.kernel()
    assert mf.converged
    assert abs(e - float(port_refs[f'pbe_{case}_e'])) < 1e-8
    if f'pbe_{case}_grad' in port_refs.files:
        g = mf.Gradients().kernel()
        assert np.max(np.abs(g - port_refs[f'pbe_{case}_grad'])) < 1e-8


# ---- the transition-state search on DF-UHF ---------------------------------

def test_h3_exchange_ts():
    """tests/test_ts_opt.py's H + H2 exchange saddle on the port's DF-UHF
    (sto-3g, spin 1, conv_tol 1e-11, gtol 5e-4, maxsteps 25), with its
    asserts: max|g| under gtol, equal H-H distances within 5e-3 Bohr between
    1.5 and 2.1, and one negative eigenvalue of the analytic Hessian."""
    mol = tpt.M(atom='H 0 0 -1.05; H 0 0 0.0; H 0 0 0.85', basis='sto-3g',
                spin=1, device='cpu')

    def factory(m):
        mf = m.UHF().density_fit()
        mf.conv_tol = 1e-11
        mf.kernel()
        assert mf.converged
        return mf

    ts, energies = tpt.geomopt.optimize_ts(factory, mol, maxsteps=25,
                                           gtol=5e-4)
    assert ts._ts_grad_norm < 5e-4
    r = np.asarray(ts.coords)
    d01 = np.linalg.norm(r[1] - r[0])
    d12 = np.linalg.norm(r[2] - r[1])
    assert abs(d01 - d12) < 5e-3
    assert 1.5 < d01 < 2.1
    h = hessian.Hessian(factory(ts)).kernel().reshape(9, 9)
    w = np.linalg.eigvalsh(0.5 * (h + h.T))
    assert (w < -1e-4).sum() == 1
