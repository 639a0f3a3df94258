"""VV10 non-local correlation in pyscf_tpu_torch on the CPU against
pyscf_tpu: the plain twin of the `vv10` kernel (closed-form sums) against
jax.value_and_grad of the JAX package's _vv10_energy_features, and nr_vv10
(energy and potential matrix) against the JAX nr_vv10 (as
tests/port_refs_record.py vv10_refs recorded it) and the PySCF golden
of tests/test_vv10.py, on water/6-31G with (20, 50) grids at the minao
density."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.dft import gen_grid as jax_gen_grid
from pyscf_tpu.dft import vv10 as jax_vv10
from pyscf_tpu.ops.eval_gto import eval_ao as jax_eval_ao

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.dft import gen_grid, vv10
from pyscf_tpu_torch.ops import kernels

torch.set_num_threads(1)

B, C = 6.0, 0.01                            # wB97M-V's, tests/test_vv10.py
GOLDEN = 0.04237199619089385                # tests/test_vv10.py:27


def jax_water():
    """(JAX mol, grids, minao dm (numpy)) of tests/test_vv10.py's set-up."""
    mj = jpt.M(atom=refs.WATER, basis='6-31g', verbose=0)
    dm = np.asarray(mj.RHF().get_init_guess(mj, 'minao'))
    gj = jax_gen_grid.Grids(mj)
    gj.atom_grid = {'H': (20, 50), 'O': (20, 50)}
    gj.prune = None
    gj.build()
    return mj, gj, dm


def jax_nr_vv10():
    """(E, V) of the JAX nr_vv10 at jax_water's density (vv10_refs
    records them)."""
    mj, gj, dm = jax_water()
    e, v = jax_vv10.nr_vv10(mj, gj, dm, b=B, C=C)
    return float(e), np.asarray(v)


@pytest.fixture(scope='module')
def water():
    """(JAX mol, grids, minao dm (numpy), port mol, grids) of
    tests/test_vv10.py's set-up."""
    mj, gj, dm = jax_water()
    mt = tpt.M(atom=refs.WATER, basis='6-31g', device='cpu')
    gt = gen_grid.Grids(mt)
    gt.atom_grid = {'H': (20, 50), 'O': (20, 50)}
    gt.prune = None
    gt.build()
    return mj, gj, dm, mt, gt


@pytest.fixture(scope='module')
def features(water):
    """(rho, |grad rho|^2, coords, weights) numpy of the JAX package's
    minao density on its grid, as its nr_vv10 forms them."""
    mj, gj, dm, _, _ = water
    coords = np.asarray(gj.coords)
    aod = np.asarray(jax_eval_ao(mj, jnp.asarray(coords), deriv=1))
    dmao = aod[0] @ dm
    rho = np.maximum(np.einsum('bi,bi->b', dmao, aod[0]), 0.0)
    grho = 2.0 * np.einsum('bi,dbi->db', dmao, aod[1:])
    return rho, np.einsum('db,db->b', grho, grho), coords, \
        np.asarray(gj.weights)


def test_vv10_plain_matches_jax_grad(features):
    """E to 1e-12 relative; dE/drho and dE/dg2 to 1e-10 of their largest
    magnitude; zero on the masked points, and some points are masked."""
    rho, g2, coords, weights = features
    e_ref, (dr_ref, dg_ref) = jax_vv10._vv10_grad(
        jnp.asarray(rho), jnp.asarray(g2), jnp.asarray(coords),
        jnp.asarray(weights), B, C)
    e, dr, dg = kernels.vv10(*[torch.as_tensor(x) for x in
                               (rho, g2, coords, weights)], B, C)
    assert abs(float(e) - float(e_ref)) <= 1e-12 * abs(float(e_ref))
    for got, ref in ((dr, dr_ref), (dg, dg_ref)):
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-10 * np.max(
            np.abs(ref))
    masked = rho <= vv10.RHO_CUT
    assert masked.any() and not masked.all()
    assert np.all(dr.numpy()[masked] == 0.0) and np.all(
        dg.numpy()[masked] == 0.0)


def test_vv10_plain_blocks_give_the_same_sums(features, monkeypatch):
    """The plain twin's row blocks (one row each here) leave the sums as
    they are."""
    args = [torch.as_tensor(x) for x in features]
    ref = vv10.vv10_plain(*args, B, C)
    monkeypatch.setitem(vv10.PLAIN_BLOCK_ELEMS, 'cpu', 1)
    got = vv10.vv10_plain(*args, B, C)
    assert abs(float(got[0] - ref[0])) <= 1e-13 * abs(float(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert torch.max(torch.abs(g - r)) <= 1e-13 * torch.max(torch.abs(r))


def test_nr_vv10_matches_jax(water):
    """E and the potential matrix against the JAX nr_vv10 (recorded) to
    1e-12, the energy within 2e-4 of the PySCF golden, and the SCF's own AO
    blocks (ao_eval) give what a fresh evaluation gives."""
    _, _, dm_np, mt, gt = water
    recorded = np.load(refs.PORT_REFS)
    e_ref, v_ref = float(recorded['vv10_nr_e']), recorded['vv10_nr_v']
    dm = compat.tensor_from_numpy(dm_np, 'cpu')
    e, v = vv10.nr_vv10(mt, gt, dm, B, C)
    assert abs(float(e) - e_ref) <= 1e-12 * abs(e_ref)
    assert np.max(np.abs(v.numpy() - v_ref)) <= 1e-12 * np.max(np.abs(v_ref))
    assert abs(float(e) - GOLDEN) < 2e-4
    from pyscf_tpu_torch.dft.numint import NumInt
    e2, v2 = vv10.nr_vv10(mt, gt, dm, B, C, NumInt().grid_ao(mt, gt, 1))
    assert float(e2) == float(e) and torch.equal(v2, v)


def test_nr_vv10_potential_is_the_energy_derivative(water):
    """tr(V d) against central differences of E along a seeded symmetric
    direction d (tests/test_vv10.py's check of the JAX potential)."""
    _, _, dm_np, mt, gt = water
    rng = np.random.RandomState(0)
    d = rng.rand(mt.nao, mt.nao) * 0.01
    d = compat.tensor_from_numpy(d + d.T, 'cpu')
    dm = compat.tensor_from_numpy(dm_np, 'cpu')
    _, v = vv10.nr_vv10(mt, gt, dm, B, C)
    eps = 1e-5
    ep, _ = vv10.nr_vv10(mt, gt, dm + eps * d, B, C)
    em, _ = vv10.nr_vv10(mt, gt, dm - eps * d, B, C)
    fd = float(ep - em) / (2 * eps)
    assert abs(fd - float(torch.sum(v * d))) < 1e-8


def test_hand_set_nlc_adds_vv10():
    """tests/test_vv10.py's test_vv10_scf with a ported functional:
    He/cc-pVDZ RKS b3lypg on (30, 86) grids, then the same with
    `mf.nlc = 'vv10'` set by hand (b 5.9, C 0.0093): converged, and VV10
    raises the energy by a positive amount under 0.1 Ha."""
    mol = tpt.M(atom='He 0 0 0', basis='cc-pvdz', device='cpu')
    energies = []
    for nlc in ('', 'vv10'):
        mf = mol.RKS(xc='b3lypg')
        mf.grids.atom_grid = {'He': (30, 86)}
        mf.nlc = nlc
        energies.append(mf.kernel())
        assert mf.converged
    assert 0 < energies[1] - energies[0] < 0.1
