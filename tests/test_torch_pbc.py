"""The port's Γ-point periodic SCF (pyscf_tpu_torch/pbc) against the JAX
package's (pyscf_tpu/pbc) on the diamond primitive cell of BASELINE config
5 (gth-szv, gth-pade; tests/test_pbc.py DIAMOND), on the CPU: the Cell
and Ewald sum, the mesh and lattice tables, the lattice-summed AO values
(the plain twin of the kernel `eval_ao_pbc`, live against
eval_ao_periodic at a short rcut and against its recorded values at the
cell's rcut), S, T and the GTH pseudopotential, and the energies of LDA
at [17]^3 (the PySCF golden that test_pbc.py:35 cites), HF at [17]^3, and
PBE at [15]^3 through FFTDF and GDF's Cholesky route, and at [9]^3
through GDF's ETB route (the port's energy functional at the JAX
package's converged densities, and its own SCF). The JAX values that take
more than a few seconds are recorded in pyscf_tpu_torch/data/pbc_refs.npz
by tests/pbc_refs_record.py. The cells are shared per mesh, so the AO
values on the grid, S, T and the pseudopotential are built once per mesh
(the cell's _pbc_cache)."""
import os

import numpy as np
import pytest
import torch

from pyscf_tpu.pbc.df.fft import eval_ao_periodic as jax_eval_ao_periodic
from pyscf_tpu.pbc.gto import Cell as JaxCell

from pyscf_tpu_torch import pbc
from pyscf_tpu_torch.pbc.df.fft import FFTDF, eval_ao_periodic

torch.set_num_threads(1)

DIAMOND = dict(
    atom='C 0 0 0; C 0.8917 0.8917 0.8917',
    a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834], [1.7834, 1.7834, 0]],
    basis='gth-szv', pseudo='gth-pade', verbose=0)
REFS = np.load(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'pyscf_tpu_torch', 'data', 'pbc_refs.npz'))
# the PySCF golden of diamond Γ LDA at [17]^3 (tests/test_pbc.py:35)
E_LDA17_GOLDEN = -10.221426445656439


def _cell(n):
    return pbc.gto.M(mesh=[n] * 3, device='cpu', **DIAMOND)


@pytest.fixture(scope='module')
def cell15():
    return _cell(15)


@pytest.fixture(scope='module')
def cell17():
    return _cell(17)


def _scf(mf):
    mf.conv_tol = 1e-9
    mf.init_guess = 'hcore'
    e = mf.kernel()
    assert mf.converged
    return e


@pytest.fixture(scope='module')
def pbe15(cell15):
    """{route: (mean field, its converged energy)}: config 5's PBE through
    FFTDF ('fft') and GDF's Cholesky route ('gdf')."""
    out = {}
    for route in ('fft', 'gdf'):
        mf = pbc.dft.RKS(cell15, xc='pbe')
        if route == 'gdf':
            mf = mf.density_fit()
        out[route] = mf, _scf(mf)
    return out


def test_cell_and_ewald():
    cell = _cell(17)
    ref = JaxCell(mesh=[17] * 3, **DIAMOND).build()
    assert cell.nao == ref.nao == 8
    assert cell.nelectron == ref.nelectron == 8
    assert abs(cell.vol - ref.vol) < 1e-8
    assert abs(cell.rcut - ref.rcut) < 1e-8
    assert (pbc.gto.M(device='cpu', **DIAMOND).mesh
            == JaxCell(**DIAMOND).build().mesh)
    assert abs(cell.ewald() - (-12.7871291456)) < 1e-8
    assert abs(cell.ewald(ew_eta=0.8) - cell.ewald(ew_eta=1.6)) < 1e-8


def test_mesh_and_lattice_tables_exact():
    cell = _cell(9)
    ref = JaxCell(mesh=[9] * 3, **DIAMOND).build()
    np.testing.assert_array_equal(cell.get_Gv(), ref.get_Gv())
    np.testing.assert_array_equal(cell.get_uniform_grids(),
                                  ref.get_uniform_grids())
    np.testing.assert_array_equal(cell.get_lattice_Ls(),
                                  ref.get_lattice_Ls())
    np.testing.assert_array_equal(cell.reciprocal_vectors(),
                                  ref.reciprocal_vectors())


@pytest.mark.parametrize('deriv', [0, 1])
def test_eval_ao_periodic_live(deriv):
    """The twin against the JAX function live, over the images within 6
    Bohr (its image loop at the cell's rcut of 30.2 takes ~50 s:
    pbc_refs.npz 'ao9_d1_seconds')."""
    cell = _cell(9)
    ref_cell = JaxCell(mesh=[9] * 3, **DIAMOND).build()
    got = eval_ao_periodic(cell, cell.get_uniform_grids(), deriv, rcut=6.0)
    ref = np.asarray(jax_eval_ao_periodic(
        ref_cell, ref_cell.get_uniform_grids(), deriv, rcut=6.0))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('deriv', [0, 1])
def test_eval_ao_periodic_recorded(deriv):
    """At the cell's rcut (1,505 images) against the recorded JAX values."""
    cell = _cell(9)
    got = eval_ao_periodic(cell, cell.get_uniform_grids(), deriv).numpy()
    ref = REFS[f'ao9_d{deriv}']
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('name', ['ovlp', 'kin', 'pp_loc', 'pp_nl'])
def test_one_electron(cell15, name):
    """S and T summed over the images (kernel int1e_stv), the GTH local
    part on the mesh and the non-local part (int1e_stv's projector
    overlaps) against the JAX FFTDF's, 1e-12."""
    df = FFTDF(cell15)
    got = {'ovlp': df.get_ovlp, 'kin': df.get_kin, 'pp_loc': df.get_pp_loc,
           'pp_nl': df.get_pp_nl}[name]()
    assert np.abs(got.numpy() - REFS[name]).max() <= 1e-12


def test_lda17_golden(cell17):
    e = _scf(pbc.dft.RKS(cell17, xc='lda,vwn'))
    assert abs(e - E_LDA17_GOLDEN) < 1e-6
    assert abs(e - float(REFS['e_lda17'])) < 1e-8


def test_rhf17(cell17):
    """FFT K with the Madelung term (exxdiv 'ewald')."""
    mf = pbc.scf.RHF(cell17)
    e = _scf(mf)
    assert abs(pbc.scf.madelung(cell17) - float(REFS['madelung17'])) < 1e-10
    assert abs(e - float(REFS['e_rhf17'])) < 1e-8


def _at_jax_density(mf, key):
    """The port's energy functional at the JAX package's converged density
    '<key>_dm' against the JAX energy '<key>' (the JAX functional at that
    density, tests/pbc_refs_record.py), 1e-10; returns it."""
    e = mf.energy_tot(torch.as_tensor(REFS[f'{key}_dm']))
    assert abs(e - float(REFS[key])) < 1e-10
    return e


@pytest.mark.parametrize('route', ['fft', 'gdf'])
def test_pbe15(pbe15, route):
    """Config 5: diamond Γ PBE through FFTDF and GDF's Cholesky route. The
    JAX package's periodic RKS puts half the GGA term into V_xc
    (pyscf_tpu/pbc/dft/rks.py:68-70), so its converged density is not the
    functional's stationary point: the port's functional at the JAX
    density gives the JAX one there (1e-10), and the port's own SCF ends
    1e-8 to 1e-6 Ha below the JAX energy; the two recorded JAX energies
    agree to 1e-8."""
    mf, e = pbe15[route]
    key = f'e_pbe15_{route}'
    _at_jax_density(mf, key)
    assert 1e-8 < float(REFS[key]) - e < 1e-6
    assert abs(float(REFS['e_pbe15_gdf'] - REFS['e_pbe15_fft'])) < 1e-8


def test_pbe15_vxc_is_the_energy_derivative(pbe15):
    """The port's own V_xc on the uniform grid is dE_xc/dD (central
    differences of E_xc along a seeded symmetric direction, 1e-9
    relative), and its converged PBE energies through GDF and FFTDF agree
    within 1e-8. The two packages' density thresholds differ (1e-12
    without a sigma floor in the JAX package's periodic RKS, the molecular
    1e-10 and 1e-20 here): on this grid the density stays above 1e-3 and
    sigma above 1e-20, so neither threshold is reached."""
    (mf, e_fft), (_, e_gdf) = pbe15['fft'], pbe15['gdf']
    assert abs(e_gdf - e_fft) < 1e-8
    aod = mf.with_df._ao_on_grid(1)
    w = torch.full((aod.shape[1],), mf.with_df.weight, dtype=torch.float64)
    dm = mf.make_rdm1()
    dmao = aod[0] @ dm
    rho = torch.einsum('gi,gi->g', dmao, aod[0])
    grho = 2.0 * torch.einsum('gi,dgi->dg', dmao, aod[1:])
    assert float(rho.min()) > 1e-3
    assert float(torch.einsum('dg,dg->g', grho, grho).min()) > 1e-20
    x = torch.as_tensor(np.random.default_rng(17).normal(size=dm.shape))
    x = 0.01 * (x + x.T)
    h = 1e-4
    core = mf._numint._get_rks_core_aod('pbe')
    exc = [core([aod], [w], dm + s * h * x)[1] for s in (1, -1)]
    fd = float(exc[0] - exc[1]) / (2 * h)
    v = core([aod], [w], dm)[2]
    assert abs(float(torch.sum(v * x)) - fd) < 1e-9 * abs(fd)


def test_pbe9_etb():
    """GDF's ETB route at [9]^3 (the aux cell's most diffuse exponent,
    0.059, brings 4,213 images): the aux count after the eigenvalue cut;
    the port's functional at the JAX densities of the ETB and FFTDF runs
    (1e-10, as test_pbe15), so the ETB-FFTDF gap there is the JAX
    package's own (-7.33e-3 Ha) within 1e-8; and each of the port's SCFs
    below its JAX energy by more than 1e-8 and less than 1e-5: on this
    coarse mesh the reference's half GGA term costs 2.6e-6 Ha (6.6e-8 at
    [15]^3), and the port's own gap differs from the JAX one by 1.9e-8."""
    cell = _cell(9)
    mf = pbc.dft.RKS(cell, xc='pbe').density_fit(auxbasis=True)
    e_dm = _at_jax_density(mf, 'e_pbe9_etb')
    e = _scf(mf)
    assert mf.with_df.naux == int(REFS['etb_naux'])
    assert 1e-8 < float(REFS['e_pbe9_etb']) - e < 1e-5
    mf = pbc.dft.RKS(cell, xc='pbe')
    e_fft_dm = _at_jax_density(mf, 'e_pbe9_fft')
    e_fft = _scf(mf)
    assert 1e-8 < float(REFS['e_pbe9_fft']) - e_fft < 1e-5
    gap = float(REFS['e_pbe9_etb'] - REFS['e_pbe9_fft'])
    assert abs((e_dm - e_fft_dm) - gap) < 1e-8
