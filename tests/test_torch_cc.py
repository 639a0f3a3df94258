"""CCSD and CCSD(T) of pyscf_tpu_torch on the CPU against pyscf_tpu: the
energy (the `mp2_energy` kernel's twin with x = tau), update_amps with the
dense (vv|vv) and with the chunked B_vv ladder, update_amps_dfb, and the
(T) sum (the `ccsd_t` kernel's twin) against the JAX package's programs on
seeded tensors; then the entry points end to end against PySCF's goldens
(tests/test_postscf.py) and the recorded JAX energies
(pyscf_tpu_torch/refs.py)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.cc import ccsd as jax_ccsd
from pyscf_tpu.cc import ccsd_t as jax_ccsd_t

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.cc import ccsd, ccsd_t

torch.set_num_threads(1)

# tests/test_postscf.py:39-41, from PySCF's self-checks
GOLDEN_CCSD = -0.213343234198275
GOLDEN_T = -0.003060022611584471
NO, NV, NAUX = 3, 6, 40


def _close(got, ref, tol=1e-12):
    """max |got - ref| <= tol x max |ref|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


@pytest.fixture(scope='module')
def seeded():
    """Seeded MO blocks from a random three-index factor B (naux 40) over
    nocc 3 and nvir 6, so that they have the ERI symmetries, with t1, t2
    and orbital energies; numpy."""
    rng = np.random.default_rng(11)
    n = NO + NV
    B = rng.standard_normal((NAUX, n, n)) * 0.2
    B = B + B.transpose(0, 2, 1)
    o, v = slice(0, NO), slice(NO, None)
    eri = np.einsum('xij,xkl->ijkl', B, B)
    t2 = rng.standard_normal((NO, NO, NV, NV)) * 0.03
    d = dict(
        oooo=eri[o, o, o, o], ooov=eri[o, o, o, v], oovv=eri[o, o, v, v],
        ovov=eri[o, v, o, v], ovvo=eri[o, v, v, o], ovvv=eri[o, v, v, v],
        vvvv=eri[v, v, v, v], Bov=B[:, o, v], Bvv=B[:, v, v],
        t1=rng.standard_normal((NO, NV)) * 0.02,
        t2=t2 + t2.transpose(1, 0, 3, 2),
        mo_energy=np.concatenate([-1.0 - rng.random(NO),
                                  0.3 + rng.random(NV)]))
    return {k: np.ascontiguousarray(a) for k, a in d.items()}


def _port_eris(d, dense=True, with_ovvv=True):
    t = {k: torch.as_tensor(a) for k, a in d.items()}
    return SimpleNamespace(
        oooo=t['oooo'], ooov=t['ooov'], oovv=t['oovv'], ovov=t['ovov'],
        ovvo=t['ovvo'], ovvv=t['ovvv'] if with_ovvv else None,
        vvvv=ccsd.ladder_operand(t['vvvv']) if dense else None,
        Bov=t['Bov'], Bvv=t['Bvv'], mo_energy=t['mo_energy'], nocc=NO)


def _jax_chunks(a):
    """The JAX package's aux chunks: zero-padded to a multiple of
    VVVV_AUX_CHUNK and reshaped to (nchunk, chunk, ...)."""
    pad = -a.shape[0] % jax_ccsd.VVVV_AUX_CHUNK
    a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
    return jnp.asarray(a.reshape(-1, jax_ccsd.VVVV_AUX_CHUNK, *a.shape[1:]))


def _jt(d, *keys):
    return tuple(jnp.asarray(d[k]) for k in keys)


def test_energy_against_jax(seeded):
    """ccsd.energy (the mp2_energy twin on tau in its (i,j,a,b) layout)
    against the JAX energy, 1e-12 relative."""
    d = seeded
    got = ccsd.energy(*[torch.as_tensor(d[k]) for k in ('t1', 't2', 'ovov')])
    ref = jax_ccsd.energy(*_jt(d, 't1', 't2', 'ovov'))
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))


@pytest.mark.parametrize('ladder', ['vvvv', 'Bvv'])
def test_update_amps_against_jax(seeded, ladder):
    """One update_amps step with the dense (vv|vv) ladder operand and with
    the B_vv aux chunks (40 aux functions: two chunks, the second partial)
    against the JAX update_amps with vvvv or its zero-padded chunks, 1e-12
    of the largest amplitude."""
    d = seeded
    dense = ladder == 'vvvv'
    got = ccsd.update_amps(torch.as_tensor(d['t1']), torch.as_tensor(d['t2']),
                           _port_eris(d, dense=dense))
    eris = _jt(d, 'oooo', 'ooov', 'oovv', 'ovov', 'ovvo', 'ovvv') + (
        (jnp.asarray(d['vvvv']), None) if dense
        else (None, _jax_chunks(d['Bvv']))) + _jt(d, 'mo_energy')
    ref = jax_ccsd.update_amps(*_jt(d, 't1', 't2'), eris)
    for a, b in zip(got, ref):
        _close(a, b)


def test_update_amps_dfb_against_jax(seeded):
    """One ovvv-free step (every (ov|vv) term through B_ov and B_vv)
    against the JAX update_amps_dfb, 1e-12 of the largest amplitude; and
    against the port's update_amps on the same factor, which it must equal
    up to rounding."""
    d = seeded
    t1, t2 = torch.as_tensor(d['t1']), torch.as_tensor(d['t2'])
    got = ccsd.update_amps_dfb(t1, t2, _port_eris(d, dense=False,
                                                  with_ovvv=False))
    eris = _jt(d, 'oooo', 'ooov', 'oovv', 'ovov', 'ovvo') + (
        _jax_chunks(d['Bov']).reshape(-1, NO, NV), _jax_chunks(d['Bvv']),
        jnp.asarray(d['mo_energy']))
    ref = jax_ccsd.update_amps_dfb(*_jt(d, 't1', 't2'), eris)
    same = ccsd.update_amps(t1, t2, _port_eris(d, dense=False))
    for a, b, c in zip(got, ref, same):
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize('no, nv', [(3, 6), (4, 8)])
def test_et_plain_against_jax(no, nv):
    """et_plain on the unpadded list of every a >= b >= c (each
    multiplicity present) against _et_all on the JAX package's padded
    blocks, 1e-12 relative."""
    rng = np.random.default_rng(no * 10 + nv)
    vvov = rng.standard_normal((nv, nv, no, nv)) * 0.1
    vooo = rng.standard_normal((nv, no, no, no)) * 0.1
    ovov = rng.standard_normal((no, nv, no, nv)) * 0.1
    t2 = rng.standard_normal((no, no, nv, nv)) * 0.05
    t1 = rng.standard_normal((no, nv)) * 0.02
    eo, ev = -1.0 - rng.random(no), 0.2 + rng.random(nv)
    abc, mult = ccsd_t.triples(nv)
    assert set(mult) == {1.0, 2.0, 6.0}
    got = ccsd_t.et_plain(*[torch.as_tensor(a) for a in
                            (abc, mult, vvov, vooo, ovov, t2, t1, eo, ev)])
    blk = jax_ccsd_t.TRIPLE_BLK
    pad = -len(abc) % blk
    abc_b = np.pad(abc, ((0, pad), (0, 0))).reshape(-1, blk, 3)
    mult_b = np.pad(mult, (0, pad)).reshape(-1, blk)
    eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]
    ref = jax_ccsd_t._et_all(
        jnp.asarray(abc_b), jnp.asarray(mult_b), jnp.asarray(vvov),
        jnp.asarray(vooo), jnp.asarray(ovov.transpose(1, 3, 0, 2)),
        jnp.asarray(t2.transpose(2, 3, 0, 1)), jnp.asarray(t1.T),
        jnp.asarray(eijk), jnp.asarray(ev))
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))


@pytest.fixture(scope='module')
def water_cc():
    """Water/cc-pVDZ in-core RHF (hcore, conv_tol 1e-12) and its CCSD
    (conv_tol 1e-10, conv_tol_normt 1e-8), the set-up of
    tests/test_postscf.py."""
    mf = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cpu').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    mycc = mf.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    mycc.kernel()
    return mf, mycc


def test_ccsd_t_golden(water_cc):
    """CCSD and (T) within 1e-8 of PySCF's goldens, converged; ccsd_t takes
    explicit amplitudes (tested with `is None`, so arrays are accepted)."""
    mf, mycc = water_cc
    assert mycc.converged and 5 < mycc.cycles < 50
    assert abs(mycc.e_corr - GOLDEN_CCSD) < 1e-8
    assert abs(mycc.e_tot - (mf.e_tot + GOLDEN_CCSD)) < 1e-8
    et = mycc.ccsd_t()
    assert abs(et - GOLDEN_T) < 1e-8
    assert mycc.ccsd_t(mycc.t1, mycc.t2) == et
    assert len(mycc.timings['cycles']) == mycc.cycles


def test_frozen_step_against_jax(water_cc):
    """frozen=1: the port's MO blocks without the 1s orbital, converted to
    numpy, through one JAX update_amps from the MP2 guess, against the
    port's step on the same blocks; then the frozen-core CCSD converges
    above the all-electron energy."""
    mf, _ = water_cc
    mycc = mf.CCSD(frozen=1)
    eris = mycc.ao2mo()
    assert eris.nocc == 4 and eris.ovov.shape == (4, 19, 4, 19)
    emp2, t1, t2 = mycc.init_amps(eris)
    got = ccsd.update_amps(t1, t2, eris)
    nv = eris.ovov.shape[1]
    vvvv = eris.vvvv.reshape(nv, nv, nv, nv).permute(2, 0, 3, 1)
    blocks = tuple(jnp.asarray(getattr(eris, k).numpy()) for k in
                   ('oooo', 'ooov', 'oovv', 'ovov', 'ovvo', 'ovvv'))
    ref = jax_ccsd.update_amps(
        jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy()),
        blocks + (jnp.asarray(vvvv.numpy()), None,
                  jnp.asarray(eris.mo_energy.numpy())))
    for a, b in zip(got, ref):
        _close(a, b)
    assert abs(emp2 - float(jax_ccsd.energy(
        jnp.zeros((4, nv)), jnp.asarray(t2.numpy()), blocks[3]))) < 1e-12
    mycc.conv_tol = 1e-9
    mycc.kernel()
    assert mycc.converged and GOLDEN_CCSD < mycc.e_corr < 0.0


@pytest.fixture(scope='module')
def water_df():
    mf = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cpu').RHF() \
        .density_fit()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    return mf


def test_df_ccsd_t_against_jax(water_df):
    """Water/cc-pVDZ DF-RHF: the DF-CCSD (B_vv aux-chunk ladder) and its
    (T) within 1e-8 of the recorded JAX energies."""
    mycc = water_df.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    e, _, _ = mycc.kernel()
    assert mycc.converged and mycc._eris.vvvv is None
    assert abs(e - refs.E_WATER_DF_CCSD_CCPVDZ) < 1e-8
    assert abs(mycc.ccsd_t() - refs.E_WATER_DF_CCSD_T_CCPVDZ) < 1e-8


def test_ovvv_free_path(water_df, monkeypatch):
    """With OVVV_MAX_ELEMS at 0 the DF-CCSD runs update_amps_dfb: the same
    energy as the recorded JAX DF-CCSD within 1e-8; its (T) raises
    NotImplementedError, where the JAX package fails on eris.ovvv."""
    monkeypatch.setattr(ccsd, 'OVVV_MAX_ELEMS', 0)
    mycc = water_df.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    e, _, _ = mycc.kernel()
    assert mycc.converged and mycc._eris.ovvv is None
    assert abs(e - refs.E_WATER_DF_CCSD_CCPVDZ) < 1e-8
    with pytest.raises(NotImplementedError, match='ovvv-free'):
        mycc.ccsd_t()
