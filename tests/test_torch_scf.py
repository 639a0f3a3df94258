"""DF-RHF end to end: pyscf_tpu_torch on the CPU against pyscf_tpu (its
water/cc-pVDZ run and J/K recorded by tests/port_refs_record.py, DIIS
live), the recorded reference energies, the DF-J/K GEMMs, DIIS and eigh."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.scf.fused import _diis_extrapolate as jax_diis

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.df.df import DF
from pyscf_tpu_torch.df.df_jk import get_jk
from pyscf_tpu_torch.lib.linalg import eigh
from pyscf_tpu_torch.scf.fused import _diis_extrapolate

torch.set_num_threads(1)

GOLDEN_RHF_CCPVDZ = -76.026765673119627     # tests/test_scf.py:89-91


def _jax_df_rhf(atom, basis, conv_tol):
    mol = jpt.M(atom=atom, basis=basis, verbose=0)
    mf = mol.RHF().density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = conv_tol
    e = mf.kernel()
    return mf, e


def _port_df_rhf(atom, basis, conv_tol, dm0=None, init_guess='minao'):
    mol = tpt.M(atom=atom, basis=basis, device='cpu')
    mf = mol.RHF().density_fit()
    mf.init_guess = init_guess
    mf.conv_tol = conv_tol
    e = mf.kernel(dm0)
    return mf, e


@pytest.fixture(scope='module')
def jax_water():
    """The JAX package's water/cc-pVDZ DF-RHF (minao, conv_tol 1e-10, a
    converged run) and its J/K, as tests/port_refs_record.py recorded
    them."""
    r = np.load(refs.PORT_REFS)
    return dict(e=float(r['scf_e']), converged=True, dm=r['scf_dm'],
                B=r['scf_B'], co=r['scf_co'], vj=r['scf_vj'],
                vk=r['scf_vk'], vk_occ=r['scf_vk_occ'])


@pytest.fixture(scope='module')
def port_water():
    mf, e = _port_df_rhf(refs.WATER, 'cc-pvdz', 1e-10)
    return mf, e


def test_energy_matches_jax(jax_water, port_water):
    mf, e = port_water
    assert jax_water['converged'] and mf.converged
    assert abs(e - jax_water['e']) < 1e-8
    assert mf.mo_energy.shape == (24,) and mf.mo_coeff.shape == (24, 24)
    assert float(mf.mo_occ.sum()) == 10.0


def test_energy_in_golden_band(port_water):
    _, e = port_water
    # the DF error against exact RHF/cc-pVDZ (reference test_h2o_vdz.py:45)
    assert abs(e - GOLDEN_RHF_CCPVDZ) < 1e-3
    assert abs(e - GOLDEN_RHF_CCPVDZ) > 1e-8


def test_recorded_water_reference(jax_water):
    assert abs(refs.E_WATER_DF_RHF_CCPVDZ - jax_water['e']) < 1e-8


def test_seeded_with_jax_density(jax_water):
    """From the JAX package's converged density, the port's cycle maths
    stays at the JAX energy and converges within a few cycles."""
    dm0 = compat.tensor_from_numpy(jax_water['dm'], 'cpu')
    mf, e = _port_df_rhf(refs.WATER, 'cc-pvdz', 1e-10, dm0=dm0)
    assert mf.converged and mf.scf_cycles <= 4
    assert abs(e - jax_water['e']) < 1e-8


def test_hcore_guess_converges_to_same_energy(jax_water):
    mf, e = _port_df_rhf(refs.WATER, 'cc-pvdz', 1e-10, init_guess='hcore')
    assert mf.converged
    assert abs(e - jax_water['e']) < 1e-8


def test_jk_match_jax(jax_water):
    B = compat.tensor_from_numpy(jax_water['B'], 'cpu')
    dm = compat.tensor_from_numpy(jax_water['dm'], 'cpu')
    co = compat.tensor_from_numpy(jax_water['co'], 'cpu')
    vj_ref, vk_ref = jax_water['vj'], jax_water['vk']
    vk_occ = jax_water['vk_occ']
    dfobj = DF(None)
    dfobj._cderi = B
    vj, vk = get_jk(dfobj, dm)
    _, vk_mo = get_jk(dfobj, dm, with_j=False, mo_coeff_occ=co)
    assert np.max(np.abs(vj.numpy() - vj_ref)) < 1e-10
    assert np.max(np.abs(vk.numpy() - vk_ref)) < 1e-10
    assert np.max(np.abs(vk_mo.numpy() - vk_occ)) < 1e-10


@pytest.mark.parametrize('nval', [1, 3, 6])
def test_diis_matches_jax(nval):
    rng = np.random.default_rng(40 + nval)
    space, n = 6, 7
    fh = rng.standard_normal((space, n, n))
    eh = rng.standard_normal((space, n, n)) * 10.0 ** -np.arange(space)[
        :, None, None]
    newest = nval - 1
    ref = np.asarray(jax_diis(jnp.asarray(fh), jnp.asarray(eh), nval,
                              newest=newest))
    got = _diis_extrapolate(torch.as_tensor(fh), torch.as_tensor(eh), nval,
                            newest).numpy()
    assert np.max(np.abs(got - ref)) < 1e-10


def test_eigh_refinement_keeps_the_decomposition():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 40))
    a = torch.as_tensor(a + a.T)
    w0, v0 = eigh(a, refine=0)
    w3, v3 = eigh(a, refine=3)
    assert torch.max(torch.abs(w3 - w0)) < 1e-12
    assert torch.max(torch.abs(a @ v3 - v3 * w3)) < 1e-12
    assert torch.max(torch.abs(v3 @ v3.T - torch.eye(40,
                                                     dtype=a.dtype))) < 1e-12


@pytest.mark.slow
def test_benzene_matches_jax_and_reference():
    _, e_jax = _jax_df_rhf(refs.BENZENE, 'def2-svp', 1e-8)
    mf, e = _port_df_rhf(refs.BENZENE, 'def2-svp', 1e-8)
    assert mf.converged
    assert abs(e_jax - refs.E_BENZENE_DF_RHF_DEF2SVP) < 1e-8
    assert abs(e - e_jax) < 1e-8
