"""The dipole integrals and the SCF analysis of pyscf_tpu_torch on the CPU
against pyscf_tpu: the plain twin of the int1e_r kernel (class_r over
r_chunk) and dip_moment, quad_moment, mulliken_pop and mulliken_spin_pop
on the JAX package's own converged densities, handed over through compat
(the JAX runs' analysis as tests/port_refs_record.py recorded it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.ops.integrals.int1e import r_chunk as jax_r_chunk

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.ops.integrals import int1e

torch.set_num_threads(1)


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert np.max(np.abs(np.asarray(got) - ref)) <= rel * np.max(np.abs(ref))


def test_int1e_r_matches_jax():
    """mol.intor('int1e_r') on water/def2-SVP (every ordered class pair up
    to (d|d)) against the JAX int1e_r (recorded by
    tests/port_refs_record.py): 1e-12 x max."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    got = mol.intor('int1e_r')
    assert got.shape == (3, mol.nao, mol.nao)
    assert len(int1e.cross_pairs(mol, mol)) == 9
    _close(got.numpy(), np.load(refs.PORT_REFS)['int1e_r_svp'], 1e-12)


@pytest.mark.parametrize('la,lb', [(3, 3), (1, 3)])
def test_r_chunk_f_shells_match_jax(la, lb):
    """r_chunk on 24 seeded primitive pairs with f shells against the JAX
    r_chunk: 1e-12 x max."""
    rng = np.random.default_rng(la * 10 + lb)
    m = 24
    a, b = rng.random(m) * 3 + 0.1, rng.random(m) * 3 + 0.1
    A, B = rng.standard_normal((m, 3)), rng.standard_normal((m, 3))
    w = rng.standard_normal(m)
    ref = jax_r_chunk(la, lb, *[jnp.asarray(x) for x in (a, b, A, B, w)])
    got = int1e.r_chunk(la, lb, *[torch.as_tensor(x) for x in (a, b, A, B, w)])
    assert got.shape == ref.shape == (3, m, (la + 1) * (la + 2) // 2,
                                      (lb + 1) * (lb + 2) // 2)
    _close(got.numpy(), np.asarray(ref), 1e-12)


class _Recorded:
    """A JAX mean field's analysis as tests/port_refs_record.py recorded it
    (ana_<tag>_*), with the methods the comparison calls."""

    def __init__(self, tag):
        r = np.load(refs.PORT_REFS)
        self.r = {k[len(tag) + 5:]: r[k] for k in r.files
                  if k.startswith(f'ana_{tag}_')}

    def make_rdm1(self):
        return self.r['dm']

    def dip_moment(self, dm, unit):
        return self.r['dip_debye' if unit == 'Debye' else 'dip_au']

    def quad_moment(self, dm):
        return self.r['quad']

    def mulliken_pop(self, dm):
        return self.r['pop'], self.r['chg']

    def mulliken_spin_pop(self, dm):
        return self.r['spin_pop'], self.r['spin']


@pytest.fixture(scope='module')
def water_rhf():
    """(JAX RHF/sto-3g water, hcore, conv_tol 1e-11, converged, recorded;
    the port's RHF on the same mole)."""
    return (_Recorded('rhf'),
            tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu').RHF())


@pytest.fixture(scope='module')
def oh_uhf():
    """(JAX UHF/sto-3g OH radical, conv_tol 1e-11, converged, recorded; the
    port's UHF on the same mole)."""
    atom = 'O 0 0 0; H 0 0 0.97'
    return (_Recorded('uhf'),
            tpt.M(atom=atom, basis='sto-3g', spin=1, device='cpu').UHF())


def _analysis_matches(jmf, mf, dm):
    """dip_moment (Debye and a.u.) within 1e-10, quad_moment within 1e-8,
    mulliken_pop's populations and charges within 1e-10."""
    jdm = jmf.make_rdm1()
    for unit in ('Debye', 'au'):
        mu = mf.dip_moment(dm=dm, unit=unit)
        ref = np.asarray(jmf.dip_moment(dm=jdm, unit=unit))
        assert isinstance(mu, np.ndarray) and mu.shape == (3,)
        assert np.max(np.abs(mu - ref)) < 1e-10
    q = mf.quad_moment(dm=dm)
    assert q.shape == (3, 3) and abs(np.trace(q)) < 1e-10
    assert np.max(np.abs(q - np.asarray(jmf.quad_moment(dm=jdm)))) < 1e-8
    for got, ref in zip(mf.mulliken_pop(dm=dm), jmf.mulliken_pop(dm=jdm)):
        assert np.max(np.abs(got - np.asarray(ref))) < 1e-10


def test_rhf_analysis_matches_jax(water_rhf):
    jmf, mf = water_rhf
    _analysis_matches(jmf, mf, compat.tensor_from_numpy(jmf.make_rdm1(),
                                                        'cpu'))


def test_uhf_analysis_matches_jax(oh_uhf):
    """The stacked spin density collapses to dm_a + dm_b for the moments
    and the charges, and to dm_a - dm_b for the spin populations (which
    sum to 2S = 1)."""
    jmf, mf = oh_uhf
    dm = compat.spin_density_from_numpy(jmf.make_rdm1(), 'cpu')
    _analysis_matches(jmf, mf, dm)
    pop, spin = mf.mulliken_spin_pop(dm=dm)
    jpop, jspin = jmf.mulliken_spin_pop(dm=jmf.make_rdm1())
    assert np.max(np.abs(pop - np.asarray(jpop))) < 1e-10
    assert np.max(np.abs(spin - np.asarray(jspin))) < 1e-10
    assert abs(spin.sum() - 1.0) < 1e-8


def test_analyze_prints_and_returns(capsys):
    """analyze() on the port's own converged water: the populations, the
    charges (summing to the molecule's charge) and the dipole it returns
    are mulliken_pop's and dip_moment's, and it prints them."""
    mf = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    mf.kernel()
    pop, chg, mu = mf.analyze()
    out = capsys.readouterr().out
    assert 'Mulliken charges' in out and 'Dipole moment (Debye)' in out
    assert abs(chg.sum()) < 1e-10 and abs(pop.sum() - 10.0) < 1e-10
    assert np.array_equal(mu, mf.dip_moment())
    assert abs(np.linalg.norm(mu) - 1.73) < 0.1       # tests/test_scf.py
