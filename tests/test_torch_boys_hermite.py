"""Boys function and Hermite expansions: pyscf_tpu_torch against pyscf_tpu
on the same inputs, made from a seed with numpy (boys and e3d live,
hermite_R as tests/port_refs_record.py hermite_refs recorded it: a
compile per order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.ops.integrals import boys as jboys
from pyscf_tpu.ops.integrals import hermite as jherm

from pyscf_tpu_torch import refs
from pyscf_tpu_torch.ops.integrals import boys as tboys
from pyscf_tpu_torch.ops.integrals import hermite as therm

torch.set_num_threads(1)


@pytest.mark.parametrize('m', range(9))
def test_boys_matches_jax(m):
    rng = np.random.default_rng(100 + m)
    t = np.concatenate([rng.uniform(0.0, 60.0, 2000),
                        18.0 + rng.uniform(-1e-6, 1e-6, 64),
                        [0.0, 1e-14, 17.999999999, 18.0, 60.0]])
    ref = np.asarray(jboys.boys(m, jnp.asarray(t)))
    got = tboys.boys(m, torch.as_tensor(t)).numpy()
    assert got.shape == ref.shape == (m + 1, t.size)
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 1e-14


def _pair_inputs(seed, n=40):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 10.0, n)
    b = rng.uniform(0.1, 10.0, n)
    A = rng.uniform(-2.0, 2.0, (n, 3))
    B = rng.uniform(-2.0, 2.0, (n, 3))
    return a, b, A, B


@pytest.mark.parametrize('la,lb', [(la, lb) for la in range(3)
                                   for lb in range(3)])
def test_e3d_matches_jax(la, lb):
    args = _pair_inputs(10 * la + lb)
    ref = np.asarray(jherm.e3d(la, lb, *map(jnp.asarray, args)))
    got = therm.e3d(la, lb, *map(torch.as_tensor, args)).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-13 * max(1.0, np.abs(ref).max())


def _hermite_inputs(L):
    rng = np.random.default_rng(200 + L)
    return rng.uniform(0.05, 5.0, 300), rng.uniform(-3.0, 3.0, (300, 3))


def jax_hermite_R(L):
    """The JAX package's hermite_R at _hermite_inputs(L) (hermite_refs
    records it)."""
    p, rpq = _hermite_inputs(L)
    return np.asarray(jherm.hermite_R(L, jnp.asarray(p), jnp.asarray(rpq)))


@pytest.mark.parametrize('L', range(9))
def test_hermite_R_matches_jax(L):
    p, rpq = _hermite_inputs(L)
    ref = np.load(refs.PORT_REFS)[f'hermite_R_{L}']
    got = therm.hermite_R(L, torch.as_tensor(p), torch.as_tensor(rpq)).numpy()
    assert got.shape == ref.shape == (300, therm.n_tuv(L))
    assert np.max(np.abs(got - ref)) <= 1e-13 * np.abs(ref).max()
