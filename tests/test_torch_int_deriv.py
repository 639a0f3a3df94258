"""The derivative integrals of pyscf_tpu_torch on the CPU (the plain twins
of the kernels int1e_ip, int1e_iprinv and int2e_ip1) against pyscf_tpu's
jitted programs on the same numpy inputs (the per-class chunks as
tests/port_refs_record.py recorded them)."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.ops.integrals import int1e_deriv as jax_deriv
from pyscf_tpu.ops.integrals import int2e as jax_int2e
from pyscf_tpu.ops.integrals.cart2sph import cart2sph as jax_cart2sph

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import int1e, int1e_deriv, int2e

torch.set_num_threads(1)

CLASSES = [(la, lb) for la in range(3) for lb in range(3)]
# one s, p and d shell on each of two atoms: every class to (d, d) with two
# centres, at 2 x 2 shell pairs a class
TOY_ATOM = 'He 0 0 0; He 0.3 -0.4 1.1'
TOY_BASIS = [[0, [1.3, 1.0]], [1, [0.9, 1.0]], [2, [0.7, 1.0]]]


def _prims(seed, m=6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, m), rng.uniform(0.3, 3.0, m),
            rng.normal(size=(m, 3)), rng.normal(size=(m, 3)),
            rng.normal(size=m))


def _close(got, ref, tol=1e-12):
    """max |got - ref| <= tol x max |ref|: the two sides run the same
    recursions in another summation order."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(np.asarray(got) - ref)) <= tol * np.max(np.abs(ref))


@pytest.mark.parametrize('la,lb', CLASSES)
def test_chunks_match_jax(la, lb):
    """ipovlp, ipkin, ipnuc and iprinv over random primitive pairs, against
    the JAX chunks on the same inputs (recorded)."""
    a, b, A, B, w = _prims(10 * la + lb)
    rng = np.random.default_rng(99)
    zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)   # ATOM_PAD centres
    t = [torch.as_tensor(x) for x in (a, b, A, B, w)]
    ref = np.load(refs.PORT_REFS)
    k = f'chunk_{la}{lb}'
    _close(int1e_deriv.ipovlp_chunk(la, lb, *t), ref[f'{k}_ipovlp'])
    _close(int1e_deriv.ipkin_chunk(la, lb, *t), ref[f'{k}_ipkin'])
    _close(int1e_deriv.ipnuc_chunk(la, lb, *t, torch.as_tensor(zr),
                                   torch.as_tensor(zq)), ref[f'{k}_ipnuc'])
    _close(int1e_deriv.iprinv_chunk(la, lb, *t, torch.as_tensor(zr[3])),
           ref[f'{k}_iprinv'])


@pytest.fixture(scope='module')
def water():
    return (jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0),
            tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu'))


@pytest.mark.parametrize('name', ['int1e_ipovlp', 'int1e_ipkin',
                                  'int1e_ipnuc'])
def test_matrices_match_jax(water, name):
    jmol, tmol = water
    got = tmol.intor(name)
    assert got.shape == (3, 7, 7)
    _close(got.numpy(), getattr(jax_deriv, name)(jmol))


def test_iprinv_matches_jax(water):
    """One centre gives the JAX package's matrix; all atoms in one call
    give the same matrices."""
    jmol, tmol = water
    every = int1e_deriv.int1e_iprinv(tmol, tmol.coords)
    assert every.shape == (3, 3, 7, 7)
    for ia in (0, 2):
        ref = jax_deriv.int1e_iprinv(jmol, jmol.coords[ia])
        _close(int1e_deriv.int1e_iprinv(tmol, tmol.coords[ia]).numpy(), ref)
        _close(every[ia].numpy(), ref)


def test_ipovlp_is_antisymmetric():
    """d/dA <a|b> + d/dB <a|b> = 0 (translation), and d/dB <a|b> is the
    transpose of d/dA <b|a>; water/def2-SVP reaches (d, d)."""
    s1 = tpt.M(atom=refs.WATER, basis='def2-svp',
               device='cpu').intor('int1e_ipovlp')
    assert float((s1 + s1.transpose(1, 2)).abs().max()) <= 1e-14


def test_int2e_ip1_matches_jax_dense(water):
    """Against the JAX package's int2e_ip1 of water/sto-3g (recorded by
    tests/port_refs_record.py)."""
    _, tmol = water
    got = tmol.intor('int2e_ip1')
    assert got.shape == (3, 7, 7, 7, 7)
    _close(got.numpy(), np.load(refs.PORT_REFS)['int2e_ip1_sto3g'])


def _all_pairs(mol, la, lb):
    ga, gb = mol.shell_groups[la], mol.shell_groups[lb]
    sel_a = np.repeat(np.arange(ga.nshl), gb.nshl)
    sel_b = np.tile(np.arange(gb.nshl), ga.nshl)
    return int1e.pair_tables(ga, gb, sel_a, sel_b)


@pytest.mark.parametrize('bra,ket', [((2, 2), (2, 2)), ((1, 2), (0, 1)),
                                     ((0, 2), (2, 0)), ((2, 1), (1, 1))])
def test_int2e_ip1_class_matches_jax(bra, ket):
    """Class level, d shells on two centres: the twin against
    DerivPairClass + _deriv_class_pair_block with the JAX package's
    cart->sph, so that one JAX program compiles per case."""
    jmol = jpt.M(atom=TOY_ATOM, basis=TOY_BASIS, verbose=0)
    tmol = tpt.M(atom=TOY_ATOM, basis=TOY_BASIS, device='cpu')
    (la, lb), (lc, ld) = bra, ket
    blk = jax_int2e._deriv_class_pair_block(
        jax_int2e.DerivPairClass(jmol, la, lb),
        jax_int2e.PairClass(jmol, lc, ld))
    nca, ncb, ncc, ncd = [(l + 1) * (l + 2) // 2 for l in (la, lb, lc, ld)]
    blk = blk.reshape(2, 2, 3, nca, ncb, 2, 2, ncc, ncd)
    ref = np.einsum('mp,nq,abxpqcdrs,kr,ls->xabmncdkl', jax_cart2sph(la),
                    jax_cart2sph(lb), blk, jax_cart2sph(lc),
                    jax_cart2sph(ld), optimize=True)
    got = int2e.int2e_ip1_class_plain(
        la, lb, *_all_pairs(tmol, la, lb),
        [(lc, ld, *_all_pairs(tmol, lc, ld))])
    _close(got.numpy(), ref.reshape(got.shape))


def test_wrappers_run_the_plain_twins_on_cpu(water):
    _, tmol = water
    zr = torch.as_tensor(tmol.coords)
    zq = torch.as_tensor(tmol.charges, dtype=torch.float64)
    pairs = _all_pairs(tmol, 1, 0)
    kets = [(0, 1, *_all_pairs(tmol, 0, 1))]
    kernels.reset_launches()
    assert torch.equal(kernels.int1e_ip(1, 0, *pairs, zr, zq),
                       int1e_deriv.class_ip(1, 0, *pairs, zr, zq))
    assert torch.equal(kernels.int1e_iprinv(1, 0, *pairs, zr),
                       int1e_deriv.class_iprinv(1, 0, *pairs, zr))
    assert torch.equal(kernels.int2e_ip1(1, 0, *pairs, kets),
                       int2e.int2e_ip1_class_plain(1, 0, *pairs, kets))
    counts = kernels.launches()
    assert not any(counts[k] for k in ('int1e_ip', 'int1e_iprinv',
                                       'int2e_ip1'))


def test_intor_refuses_an_unported_name(water):
    with pytest.raises(NotImplementedError, match='int1e_ipnucip'):
        water[1].intor('int1e_ipnucip')
