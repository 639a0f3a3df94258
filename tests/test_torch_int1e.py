"""S/T/V and the minao cross overlap: pyscf_tpu_torch (plain twins of the
int1e_stv kernel, on the CPU) against pyscf_tpu (S/T/V as
tests/port_refs_record.py recorded them, the cross overlap live)."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.ops.integrals.int1e import int1e_ovlp_cross as jax_cross

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals.int1e import int1e_ovlp_cross
from pyscf_tpu_torch.ops.integrals.j1e import hcore_parts

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def mols():
    kw = dict(atom=refs.WATER, basis='cc-pvdz')
    return jpt.M(verbose=0, **kw), tpt.M(device='cpu', **kw)


def test_stv_matches_jax(mols):
    """S, T and V of water/cc-pVDZ against the JAX package's hcore_parts
    (recorded by tests/port_refs_record.py int1e_refs; the cross overlap
    below stays live)."""
    _, mt = mols
    ref = np.load(refs.PORT_REFS)['int1e_hcore_parts_ccpvdz']
    got = hcore_parts(mt).numpy()
    assert got.shape == ref.shape == (3, 24, 24)
    assert np.max(np.abs(got - ref)) < 1e-12
    np.testing.assert_allclose(np.diag(got[0]), 1.0, atol=1e-12)


def test_ovlp_cross_matches_jax(mols):
    mj, mt = mols
    mnj = jpt.M(atom=list(zip(mj.raw_symbols, mj.coords)), basis='minao',
                unit='bohr', verbose=0)
    mnt = tpt.M(atom=list(zip(mt.raw_symbols, mt.coords)), basis='minao',
                unit='bohr', device='cpu')
    ref = np.asarray(jax_cross(mj, mnj))
    got = int1e_ovlp_cross(mt, mnt).numpy()
    assert got.shape == ref.shape == (mt.nao, mnt.nao)
    assert np.max(np.abs(got - ref)) < 1e-12


def test_wrapper_checks_inputs():
    """The wrapper runs the plain twin on the CPU without counting a launch
    and refuses malformed inputs."""
    rng = np.random.default_rng(5)
    t = lambda *s: torch.as_tensor(rng.uniform(0.5, 2.0, s))
    pairs = [t(3, 2), t(3, 2), t(3, 3), t(3, 1), t(3, 1), t(3, 3)]
    kernels.reset_launches()
    out = kernels.int1e_stv(1, 0, *pairs, with_tv=False)
    assert out.shape == (3, 3) and kernels.launches()['int1e_stv'] == 0
    with pytest.raises(TypeError, match='float64'):
        kernels.int1e_stv(1, 0, *pairs[:5], pairs[5].float(), with_tv=False)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.int1e_stv(1, 0, pairs[0].T.contiguous().T, *pairs[1:],
                          with_tv=False)
    with pytest.raises(ValueError, match='shape'):
        kernels.int1e_stv(1, 0, *pairs[:2], t(3, 2), *pairs[3:],
                          with_tv=False)
