"""The conventional RHF nuclear gradient of pyscf_tpu_torch on the CPU
against a live pyscf_tpu run, finite differences and a recorded pyscf_tpu
value; Mole.copy / set_geom_; the gradient entry points."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.grad import rhf as jax_grad

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.grad import rhf as grad_rhf
from pyscf_tpu_torch.grad import finite_difference_gradient
from pyscf_tpu_torch.lib.parameters import BOHR

torch.set_num_threads(1)


def _rhf(mol, conv_tol=1e-12):
    mf = mol.RHF()
    mf.verbose = 0
    mf.init_guess = 'hcore'
    mf.conv_tol = conv_tol
    mf.kernel()
    assert mf.converged
    return mf


@pytest.fixture(scope='module')
def water():
    """(JAX mean field, port mean field) of water/sto-3g in-core RHF."""
    return (_rhf(jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0)),
            _rhf(tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu')))


def test_grad_nuc_h2():
    mol = tpt.M(atom='H 0 0 0; H 0 0 0.74', basis='sto-3g', device='cpu')
    g = grad_rhf.grad_nuc(mol)
    r = 0.74 / 0.52917721092
    assert abs(g[0, 2] - 1.0 / r ** 2) < 1e-10
    assert abs(g.sum(axis=0)).max() < 1e-12


def test_grad_matches_live_jax(water):
    """1e-8 Ha/Bohr: both SCFs stop at conv_tol 1e-12, so the densities
    differ by ~1e-9."""
    jmf, tmf = water
    ref = np.asarray(jmf.nuc_grad_method().kernel())
    g = tmf.nuc_grad_method()
    de = g.kernel()
    assert isinstance(de, np.ndarray) and de.shape == (3, 3)
    assert np.max(np.abs(de - ref)) < 1e-8
    assert g.de is de
    assert set(g.timings) == {'int1e_ip', 'int2e_ip1', 'contract'}


def test_grad_elec_on_jax_orbitals(water):
    """The same orbitals through both grad_elec: 1e-11, only the
    summation order of the contractions differs."""
    jmf, tmf = water
    mo = [np.asarray(x) for x in (jmf.mo_energy, jmf.mo_coeff, jmf.mo_occ)]
    got = grad_rhf.grad_elec(tmf, *mo)
    assert np.max(np.abs(got - jax_grad.grad_elec(jmf))) < 1e-11
    assert np.max(np.abs(grad_rhf.grad_nuc(tmf.mol)
                         - jax_grad.grad_nuc(jmf.mol))) < 1e-13


def test_run_chains_to_the_gradient(water):
    """mol.RHF().run().nuc_grad_method().kernel(), the call a PySCF user
    makes: run() converges and returns the mean field; 1e-8 against the
    fixture's gradient (conv_tol 1e-12 on both)."""
    mf = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu').RHF()
    mf.conv_tol = 1e-12
    assert mf.run() is mf and mf.converged
    de = mf.nuc_grad_method().kernel()
    assert np.max(np.abs(de - water[1].nuc_grad_method().kernel())) < 1e-8


def test_grad_sums_to_zero(water):
    """Translational invariance, 1e-9 as tests/test_grad.py asks."""
    de = water[1].nuc_grad_method().kernel()
    assert np.max(np.abs(de.sum(axis=0))) < 1e-9


def test_grad_matches_finite_differences(water):
    """Central differences (step 1e-4 Bohr) of the port's own energy on
    two coordinates, 1e-6 as tests/test_grad.py:28."""
    tmf = water[1]
    de = tmf.nuc_grad_method().kernel()
    picks = [(0, 2), (1, 1)]
    fd = finite_difference_gradient(lambda m: _rhf(m).e_tot, tmf.mol, 1e-4,
                                    picks)
    for a, x in picks:
        assert abs(de[a, x] - fd[a, x]) < 1e-6
    assert fd[2, 0] == 0.0          # not asked for


def test_grad_water_def2svp_matches_recorded_jax():
    """Classes to (dd|dd) end to end, against the gradient recorded from
    pyscf_tpu (refs.py): 1e-8, the gradient's error being linear in the
    SCF's residue (conv_tol_grad 1e-7 here, 1e-9 in the reference)."""
    mf = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu').RHF()
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    e = mf.kernel()
    assert mf.converged
    assert abs(e - refs.E_WATER_RHF_DEF2SVP) < 1e-9
    de = mf.nuc_grad_method().kernel()
    assert np.max(np.abs(de - np.array(refs.GRAD_WATER_RHF_DEF2SVP))) < 1e-8
    assert np.max(np.abs(de.sum(axis=0))) < 1e-9


def test_copy_and_set_geom_leave_the_original_alone(water):
    tmf = water[1]
    mol = tmf.mol
    e0 = tmf.e_tot
    stv0 = tmf.get_ovlp()
    assert mol._j3c_cache
    moved = mol.copy()
    assert moved._j3c_cache == {} and moved._df_cache == {}
    assert moved.device == mol.device and moved.nao == mol.nao
    c = mol.coords.copy()
    c[1, 1] -= 0.05
    assert moved.set_geom_(c) is moved
    assert np.allclose(moved.coords, c) and moved.unit == mol.unit
    assert np.allclose(mol.coords[1], np.array(
        [0.0, -0.757, 0.587]) / BOHR)
    e1 = _rhf(moved).e_tot
    ref = _rhf(tpt.M(atom=list(zip(mol.raw_symbols, c)), unit='bohr',
                     basis='sto-3g', device='cpu')).e_tot
    assert abs(e1 - ref) < 1e-12 and abs(e1 - e0) > 1e-4
    # the original's caches and energy are as they were
    assert tmf.get_ovlp() is stv0 or torch.equal(tmf.get_ovlp(), stv0)
    assert abs(_rhf(mol).e_tot - e0) < 1e-11


def test_set_geom_drops_stale_caches(water):
    """set_geom_ on a Mole that has cached integrals rebuilds them."""
    mol = water[1].mol.copy()
    s0 = mol.intor('int1e_ipovlp').clone()
    c = mol.coords.copy()
    c[2, 2] += 0.1
    mol.set_geom_(c)
    assert mol._j3c_cache == {}
    assert float((mol.intor('int1e_ipovlp') - s0).abs().max()) > 1e-3


@pytest.mark.parametrize('build', [
    lambda m: m.RHF().density_fit(),
    lambda m: m.UHF().density_fit(),
    lambda m: m.RKS(xc='b3lypg').density_fit(),
], ids=['rhf', 'uhf', 'rks'])
def test_df_gradient_raises(build):
    """The DF gradient rebuilds the energy from its own intermediates and
    raises when that misses mf.e_tot by more than 1e-6, as the JAX
    package's Gradients.kernel does: no result and no fallback to finite
    differences or to the in-core path."""
    mf = build(tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu'))
    if hasattr(mf, 'grids'):
        mf.grids.level = 1
    mf.conv_tol = 1e-10
    mf.kernel()
    assert mf.converged
    mf.e_tot += 2e-6
    with pytest.raises(RuntimeError, match='energy check'):
        mf.nuc_grad_method().kernel()


def test_uks_gradient_raises():
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', charge=1, spin=1,
                device='cpu')
    with pytest.raises(NotImplementedError, match='UKS'):
        mol.UKS(xc='b3lypg').nuc_grad_method()


def test_uhf_gradient_is_finite_differences():
    """The non-DF UHF gradient is central differences in pyscf_tpu too; on
    closed-shell H2 it equals the analytic RHF gradient to 1e-6."""
    mol = tpt.M(atom='H 0 0 0; H 0 0 0.8', basis='sto-3g', device='cpu')
    mf = mol.UHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    de = mf.nuc_grad_method().kernel()
    ref = _rhf(mol).Gradients().kernel()
    assert np.max(np.abs(de - ref)) < 1e-6


def test_rks_gradient_is_finite_differences():
    """The non-DF RKS gradient by central differences on H2 (lda,vwn, grids
    level 1): antisymmetric along the bond, zero across it."""
    mol = tpt.M(atom='H 0 0 0; H 0 0 0.8', basis='sto-3g', device='cpu')
    mf = mol.RKS(xc='lda,vwn')
    mf.grids.level = 1
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    mf.kernel()
    assert mf.converged
    de = mf.nuc_grad_method().kernel()
    assert de.shape == (2, 3)
    assert abs(de[0, 2] + de[1, 2]) < 1e-7 and abs(de[0, 2]) > 1e-3
    assert np.max(np.abs(de[:, :2])) < 1e-7
