"""The (P|Q) metric and the whitened DF factor B: pyscf_tpu_torch (plain
twins of the int2c2e and int3c2e kernels, on the CPU) against pyscf_tpu.

Water def2-SVP + def2-universal-jkfit has nao 24 and naux 113 and its aux
basis reaches l = 4, so it covers every bra/aux class of the benzene main
path (L up to 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.df.addons import make_auxmol as jax_make_auxmol
from pyscf_tpu.ops.integrals import j3c as jj3c

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import j3c

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def jax_factor():
    mol = jpt.M(atom=refs.WATER, basis='def2-svp', verbose=0)
    auxmol = jax_make_auxmol(mol)
    meta, raw = jj3c._aux_meta(auxmol)
    aux_data = jj3c._aux_prep(meta, tuple(
        (jnp.asarray(e), jnp.asarray(c), jnp.asarray(r)) for e, c, r in raw))
    jg, _ = jj3c._j2c_whitener(meta, aux_data)
    return np.asarray(jg), np.asarray(jj3c.df_factor(mol, auxmol))


@pytest.fixture(scope='module')
def port():
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    return mol, make_auxmol(mol)


def test_shapes(port):
    mol, auxmol = port
    assert (mol.nao, auxmol.nao) == (24, 113)
    assert max(auxmol.shell_groups) == 4 and max(mol.shell_groups) == 2


def test_metric_matches_jax(jax_factor, port):
    _, auxmol = port
    ref = jax_factor[0]
    got = kernels.int2c2e(j3c.aux_tables(auxmol)).numpy()
    assert got.shape == ref.shape == (113, 113)
    assert np.max(np.abs(got - ref)) < 1e-10


def test_factor_matches_jax(jax_factor, port):
    mol, auxmol = port
    ref = jax_factor[1]
    got = j3c.df_factor(mol, auxmol)[0].numpy()
    assert got.shape == ref.shape == (113, 24, 24)
    assert np.max(np.abs(got - ref)) < 1e-10


def test_3c_rows_cover_every_class(port):
    """Raw rows of every bra class against every aux class are finite and
    (ij|P) rows of the (s,s) class are symmetric in the AO pair."""
    mol, auxmol = port
    aux = j3c.aux_tables(auxmol)
    classes = j3c.screened_pairs(mol)
    assert sorted(classes) == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                               (2, 2)]
    for (la, lb), (bc, pairs) in classes.items():
        rows = kernels.int3c2e(la, lb, *pairs, aux)
        assert rows.shape == (bc.nsel * bc.ns1, auxmol.nao)
        assert bool(torch.isfinite(rows).all())
