"""The in-core ERI tensor of pyscf_tpu_torch on the CPU against pyscf_tpu's
two engines, its 8-fold symmetry, and in-core RHF against the PySCF golden
of tests/test_scf.py."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.ops.integrals import j2e as jax_j2e

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import j2e, j3c

torch.set_num_threads(1)

GOLDEN_RHF_STO3G = -74.96306312971071      # tests/test_scf.py:19-25


def _port_mol(basis):
    return tpt.M(atom=refs.WATER, basis=basis, device='cpu')


def test_eri_sto3g_matches_jax_j2e():
    """Against the JAX package's screened engine, ops/integrals/j2e.py."""
    ref = np.asarray(jax_j2e.int2e_dense(
        jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0)))
    got = _port_mol('sto-3g').intor('int2e').numpy()
    assert got.shape == ref.shape == (7,) * 4
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def _eri_from_unique(u, n):
    """The (n,)*4 tensor from its elements (ij|kl), i >= j, k >= l, ij >= kl
    (tests/port_refs_record.py eri_unique)."""
    i, j = np.tril_indices(n)
    npair = i.size
    pair = np.zeros((npair, npair))
    p, q = np.tril_indices(npair)
    pair[p, q] = u
    pair[q, p] = u
    eri = np.zeros((n,) * 4)
    for a, b in ((i, j), (j, i)):
        for c, d in ((i, j), (j, i)):
            eri[a[:, None], b[:, None], c[None, :], d[None, :]] = pair
    return eri


@pytest.fixture(scope='module')
def water_svp_eri():
    """(port tensor, JAX legacy tensor) for water/def2-SVP, whose classes
    reach (dd|dd); the JAX package's mol.intor('int2e') as
    tests/port_refs_record.py recorded it."""
    got = _port_mol('def2-svp').intor('int2e')
    ref = _eri_from_unique(np.load(refs.PORT_REFS)['eri_svp_u'], 24)
    return got, ref


def test_eri_def2svp_matches_jax_legacy(water_svp_eri):
    got, ref = water_svp_eri
    assert got.shape == ref.shape == (24,) * 4
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_eri_classes_reach_dd():
    assert (2, 2) in j3c.screened_pairs(_port_mol('def2-svp'))


@pytest.mark.parametrize('perm', [(1, 0, 2, 3), (0, 1, 3, 2), (1, 0, 3, 2),
                                  (2, 3, 0, 1), (3, 2, 0, 1), (2, 3, 1, 0),
                                  (3, 2, 1, 0)])
def test_eri_8fold_symmetry(water_svp_eri, perm):
    """To rounding: within a pair of one shell with itself, (ij| and (ji|
    are two rows that the kernel (and its twin) compute apart, as in the
    JAX package; every other permutation reads the same entry."""
    eri, _ = water_svp_eri
    dev = torch.max(torch.abs(eri - eri.permute(*perm)))
    assert dev <= 1e-14 * torch.max(torch.abs(eri))


def test_int2e_wrapper_runs_the_plain_twin_on_cpu():
    mol = _port_mol('def2-svp')
    kets = j2e._ket_arrays(mol)
    (bc, pairs), = [v for k, v in j3c.screened_pairs(mol).items()
                    if k == (1, 2)]
    kernels.reset_launches()
    got = kernels.int2e(1, 2, *pairs, kets)
    ref = j2e.int2e_class_plain(1, 2, *pairs, kets)
    ncol = sum(k[2].shape[0] * (2 * k[0] + 1) * (2 * k[1] + 1) for k in kets)
    assert got.shape == (bc.nsel * 15, ncol)
    assert torch.equal(got, ref)
    assert kernels.launches()['int2e'] == 0


def test_incore_rhf_water_sto3g_golden():
    mf = _port_mol('sto-3g').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    e = mf.kernel()
    assert mf.converged
    assert abs(e - GOLDEN_RHF_STO3G) < 1e-8
    assert 'eri' in mf.timings and 'j3c' not in mf.timings


def test_incore_jk_match_einsum(water_svp_eri):
    """The GEMVs on the tensor and its axis-swapped copy are the JAX
    package's einsums (pyscf_tpu/scf/hf.py:700-705)."""
    eri, _ = water_svp_eri
    mf = _port_mol('def2-svp').RHF()
    mf._eri = eri
    get_j, get_k = mf._jk_fns()
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.standard_normal((24, 5)))
    dm = c @ c.T
    assert torch.max(torch.abs(
        get_j(dm) - torch.einsum('ijkl,lk->ij', eri, dm))) < 1e-12
    assert torch.max(torch.abs(
        get_k(dm) - torch.einsum('ilkj,lk->ij', eri, dm))) < 1e-12


def test_assigned_eri_wins():
    """An `_eri` the caller assigns is used as it is: the JAX package's
    tensor gives the same energy and no ERI is built."""
    eri = compat.eri_from_numpy(
        jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0).intor('int2e'),
        'cpu')
    mf = _port_mol('sto-3g').RHF()
    mf._eri = eri
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    e = mf.kernel()
    assert mf._eri is eri and 'eri' not in mf.timings
    assert mf.converged and abs(e - GOLDEN_RHF_STO3G) < 1e-8
