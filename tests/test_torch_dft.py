"""DF-RKS in pyscf_tpu_torch on the CPU against pyscf_tpu: grids and Becke
weights, AO values, the XC quadrature, water DF-RKS against a JAX
run recorded by tests/port_refs_record.py, and He against the PySCF goldens of tests/test_dft.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.dft import gen_grid as jax_gen_grid
from pyscf_tpu.dft import numint as jax_numint
from pyscf_tpu.dft import radi as jax_radi
from pyscf_tpu.ops.eval_gto import eval_ao as jax_eval_ao

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.dft import gen_grid, lebedev, numint, radi
from pyscf_tpu_torch.ops.eval_gto import eval_ao

torch.set_num_threads(1)

GOLDEN_HE_B3LYPG = -2.9070540942168002    # tests/test_dft.py:45
GOLDEN_HE_LDA = -2.8641551904776055       # tests/test_dft.py:33


def _mols(atom, basis):
    return (jpt.M(atom=atom, basis=basis, verbose=0),
            tpt.M(atom=atom, basis=basis, device='cpu'))


@pytest.fixture(scope='module')
def water_grids():
    """{level: (jax Grids, port Grids)} for water def2-SVP."""
    mj, mt = _mols(refs.WATER, 'def2-svp')
    out = {}
    for level in (1, 3):
        gj, gt = jax_gen_grid.Grids(mj), gen_grid.Grids(mt)
        gj.level = gt.level = level
        out[level] = (gj.build(), gt.build())
    return mj, mt, out


def test_radial_grid_and_adjust_match_jax():
    mj, mt = _mols(refs.WATER, 'def2-svp')
    for n, chg in ((50, 8), (75, 1), (40, 2)):
        for a, b in zip(radi.treutler(n, chg), jax_radi.treutler(n, chg)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        radi.treutler_atomic_radii_adjust(mt),
        jax_radi.treutler_atomic_radii_adjust(mj))


def test_missing_lebedev_table_raises():
    with pytest.raises(FileNotFoundError, match='lebedev_orbits'):
        lebedev._load_orbits('/nonexistent/lebedev_orbits.npz')


@pytest.mark.parametrize('level', [1, 3])
def test_grids_match_jax(water_grids, level):
    _, _, grids = water_grids
    gj, gt = grids[level]
    assert gt.size == gj.size == {1: 10124, 3: 33698}[level]
    assert gt.coords.dtype == gt.weights.dtype == torch.float64
    np.testing.assert_array_equal(gt.coords.numpy(), np.asarray(gj.coords))
    wj = np.asarray(gj.weights)
    assert np.max(np.abs(gt.weights.numpy() - wj)) <= 1e-13 * np.max(wj)


def test_becke_matches_numpy_partition(water_grids):
    """The plain twin of the `becke` kernel against the JAX package's
    unblocked numpy get_partition, on the level-1 water grid."""
    mj, mt, _ = water_grids
    tab = gen_grid.gen_atomic_grids(mt, level=1)
    _, w_np = jax_gen_grid.get_partition(
        mj, tab, jax_radi.treutler_atomic_radii_adjust, jax_radi.BRAGG_RADII)
    _, w = gen_grid.get_partition(mt, tab)
    assert np.max(np.abs(w.numpy() - w_np)) <= 1e-13 * np.max(w_np)


@pytest.mark.parametrize('basis', ['def2-svp', 'cc-pvtz'])
@pytest.mark.parametrize('deriv', [0, 1])
def test_eval_ao_matches_jax(water_grids, basis, deriv):
    """On the level-1 water grid, which reaches to within 1e-5 bohr of each
    nucleus; cc-pVTZ has f shells."""
    _, _, grids = water_grids
    coords = grids[1][1].coords
    mj, mt = _mols(refs.WATER, basis)
    got = eval_ao(mt, coords, deriv).numpy()
    ref = np.asarray(jax_eval_ao(mj, jnp.asarray(coords.numpy()), deriv))
    assert got.shape == ref.shape == ((4,) if deriv else ()) + (10124,
                                                                 mt.nao)
    assert np.max(np.abs(got - ref)) <= 1e-13


@pytest.fixture(scope='module')
def water_density(water_grids):
    mj, mt, grids = water_grids
    rng = np.random.default_rng(11)
    c = rng.standard_normal((mt.nao, 5)) * 0.3
    return mj, mt, grids[1], 2.0 * c @ c.T


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_nr_rks_matches_jax(water_density, xc_code):
    mj, mt, (gj, gt), dm = water_density
    n, e, v = numint.NumInt().nr_rks(mt, gt, xc_code, torch.as_tensor(dm))
    nj, ej, vj = jax_numint.NumInt().nr_rks(mj, gj, xc_code, jnp.asarray(dm))
    assert abs(n - nj) <= 1e-10 and abs(e - ej) <= 1e-10
    assert np.max(np.abs(v.numpy() - np.asarray(vj))) <= 1e-10


def test_nr_rks_blocks_give_the_same_result(water_density, monkeypatch):
    _, mt, (_, gt), dm = water_density
    dm = torch.as_tensor(dm)
    n1, e1, v1 = numint.NumInt().nr_rks(mt, gt, 'b3lypg', dm)
    # about 1000 points per block: 11 blocks on the level-1 grid
    monkeypatch.setattr(numint, 'CPU_BLOCK_BYTES', 6 * mt.nao * 8 * 1000)
    n2, e2, v2 = numint.NumInt().nr_rks(mt, gt, 'b3lypg', dm)
    assert abs(n1 - n2) < 1e-12 and abs(e1 - e2) < 1e-12
    assert torch.max(torch.abs(v1 - v2)) < 1e-12


@pytest.fixture(scope='module')
def jax_water_rks():
    """The JAX package's water DF-RKS b3lypg/def2-SVP (grids level 1,
    minao, conv_tol 1e-10): (energy, converged) as
    tests/port_refs_record.py recorded them."""
    r = np.load(refs.PORT_REFS)
    return float(r['rks_e']), bool(r['rks_converged'])


def test_water_df_rks_matches_jax(jax_water_rks):
    e_jax, conv_jax = jax_water_rks
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    mf = tpt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert conv_jax and mf.converged
    assert abs(e - e_jax) < 1e-8
    assert abs(refs.E_WATER_DF_RKS_B3LYPG_L1 - e_jax) < 1e-8
    assert set(mf.timings) == {'hcore', 'guess', 'j2c', 'j3c', 'grids', 'ao',
                               'scf_loop'}


@pytest.fixture(scope='module')
def he_eri():
    return compat.tensor_from_numpy(
        jpt.M(atom='He 0 0 0', basis='cc-pvdz', verbose=0).intor('int2e'),
        'cpu')


def _he_rks(he_eri, xc_code, init_guess, conv_tol):
    """He/cc-pVDZ RKS without density fitting, on the JAX package's in-core
    ERIs assigned to _eri."""
    mf = tpt.M(atom='He 0 0 0', basis='cc-pvdz', device='cpu').RKS(xc=xc_code)
    mf._eri = he_eri
    mf.init_guess = init_guess
    mf.conv_tol = conv_tol
    return mf, mf.kernel()


def test_he_b3lypg_golden(he_eri):
    mf, e = _he_rks(he_eri, 'b3lypg', 'minao', 1e-10)
    assert mf.converged
    assert abs(e - GOLDEN_HE_B3LYPG) < 1e-8


def test_he_lda_golden(he_eri):
    """tests/test_dft.py:30's settings (hcore guess, conv_tol 1e-11), which
    the JAX package misses by 62 mHa unconverged; the port's DIIS keeps the
    bordered Pulay system and converges (scf/fused.py)."""
    mf, e = _he_rks(he_eri, 'lda,vwn_rpa', 'hcore', 1e-11)
    assert mf.converged
    assert abs(e - GOLDEN_HE_LDA) < 1e-8


def test_rks_without_df_or_eri_raises(he_eri):
    """Without density fitting and without an assigned _eri, RKS builds its
    own in-core ERIs (kernel `int2e`) and gives the energy it gives on the
    JAX package's tensor."""
    mf_jax_eri, e_jax_eri = _he_rks(he_eri, 'b3lypg', 'minao', 1e-10)
    mf = tpt.M(atom='He 0 0 0', basis='cc-pvdz', device='cpu').RKS(
        xc='b3lypg')
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mf.converged and mf_jax_eri.converged
    assert 'eri' in mf.timings
    assert abs(e - e_jax_eri) < 1e-10


@pytest.mark.slow
def test_benzene_df_rks_matches_reference():
    mol = tpt.M(atom=refs.BENZENE, basis='def2-svp', device='cpu')
    mf = tpt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.conv_tol = 1e-8
    e = mf.kernel()
    assert mf.converged
    assert abs(e - refs.E_BENZENE_DF_RKS_B3LYPG_DEF2SVP) < 1e-8
