"""Geometry optimisation of pyscf_tpu_torch on the CPU against pyscf_tpu:
both packages' Cartesian and internal-coordinate optimisers on one seeded
pair potential (no SCF), the Wilson B matrix of q_func against
jax.jacobian (recorded by tests/port_refs_record.py), and the port's
water/sto-3g optimisation end to end."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu import geomopt as jax_geomopt
from pyscf_tpu.geomopt import internal as jax_internal

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.geomopt import internal
from pyscf_tpu_torch.lib.parameters import BOHR

torch.set_num_threads(1)

# a bent H2O2-like chain: three bonds, two angles, one dihedral
CHAIN = 'O 0 0 0; H 0.96 0 0; O -0.3 1.4 0; H -0.2 1.6 0.9'


class PairPotential:
    """Sum over atom pairs of Morse terms D (1 - exp(-a (r - r0)))^2 with
    seeded D, a and r0 (Bohr): the .e_tot and .Gradients().kernel() that
    the optimisers read from a mean field, as numpy."""

    def __init__(self, coords, params):
        D, a, r0 = params
        d = coords[:, None, :] - coords[None, :, :]
        r = np.sqrt((d * d).sum(-1) + np.eye(len(coords)))
        x = np.exp(-a * (r - r0))
        iu = np.triu_indices(len(coords), 1)
        self.e_tot = float((D * (1 - x) ** 2)[iu].sum())
        dedr = 2 * D * a * x * (1 - x) * (1 - np.eye(len(coords)))
        self._de = np.einsum('ij,ijx->ix', dedr / r, d)

    def Gradients(self):
        return self

    def kernel(self):
        return self._de


def _params(natm):
    """Seeded, symmetric (D, a, r0) per atom pair."""
    rng = np.random.default_rng(23)

    def sym(x):
        return np.triu(x, 1) + np.triu(x, 1).T

    x0 = np.asarray(tpt.M(atom=CHAIN, device='cpu').coords)
    r = np.linalg.norm(x0[:, None] - x0[None], axis=-1)
    return (sym(0.05 + 0.1 * rng.random((natm, natm))),
            sym(0.8 + 0.4 * rng.random((natm, natm))),
            sym(r * (1 + 0.08 * rng.standard_normal((natm, natm)))))


@pytest.mark.parametrize('kind', ['cartesian', 'internal'])
def test_optimisers_match_jax_on_pair_potential(kind):
    """The same seeded potential through both packages' optimize: every
    step's energy and the final coordinates within 1e-10."""
    jmol = jpt.M(atom=CHAIN, basis='sto-3g', verbose=0)
    mol = tpt.M(atom=CHAIN, basis='sto-3g', device='cpu')
    params = _params(mol.natm)

    def factory(m):
        return PairPotential(np.asarray(m.coords), params)

    if kind == 'cartesian':
        jm, je = jax_geomopt.optimize(factory, jmol, maxsteps=40, gtol=1e-5)
        m, e = tpt.geomopt.optimize(factory, mol, maxsteps=40, gtol=1e-5)
    else:
        jm, je = jax_internal.optimize(factory, jmol, maxsteps=40, gtol=1e-5)
        m, e = internal.optimize(factory, mol, maxsteps=40, gtol=1e-5)
    assert 5 < len(e) == len(je) < 40 and e[-1] < e[0]
    assert np.max(np.abs(np.array(e) - np.array(je))) < 1e-10
    assert np.max(np.abs(np.asarray(m.coords) - np.asarray(jm.coords))) \
        < 1e-10
    assert np.abs(factory(m).kernel()).max() < 1e-5


@pytest.mark.parametrize('atom', ['BENZENE', 'PHENYL'])
def test_wilson_b_matches_jax_jacobian(atom):
    """detect_internals as the JAX package's (live), and the Jacobian of
    q_func by torch.func.jacrev against jax.jacobian of the JAX q_func
    (recorded by tests/port_refs_record.py): 1e-12."""
    jmol = jpt.M(atom=getattr(refs, atom), basis='sto-3g', verbose=0)
    mol = tpt.M(atom=getattr(refs, atom), basis='sto-3g', device='cpu')
    ints = internal.detect_internals(mol)
    assert ints == jax_internal.detect_internals(jmol)
    x = np.asarray(mol.coords)
    q = internal.q_func(*ints)
    jax_run = np.load(refs.PORT_REFS)
    # a planar dihedral is pi or -pi by the sign of a zero: compare the
    # differences wrapped into (-pi, pi], as the optimisers take them
    dq = q(torch.as_tensor(x)).numpy() - jax_run[f'wilson_{atom}_q']
    nd = len(ints[2])
    dq[-nd:] = (dq[-nd:] + np.pi) % (2 * np.pi) - np.pi
    assert np.max(np.abs(dq)) < 1e-12
    B = torch.func.jacrev(q)(torch.as_tensor(x)).numpy()
    jB = jax_run[f'wilson_{atom}_B']
    assert B.shape == jB.shape == (sum(map(len, ints)), mol.natm, 3)
    assert np.max(np.abs(B - jB)) < 1e-12


def test_water_internal_optimisation():
    """tests/test_grad.py's water through the port's internal optimiser:
    R(OH) 0.989 +- 0.01 Angstrom, angle 100 +- 2 degrees, at most 10 steps,
    and every step's energy within 1e-8 of the JAX run's (refs.py)."""
    mol = tpt.M(atom='O 0 0 0; H 0 -0.9 0.4; H 0 0.9 0.4', basis='sto-3g',
                device='cpu')
    bonds, angles, _ = internal.detect_internals(mol)
    assert len(bonds) == 2 and len(angles) == 1

    def mf_factory(m):
        mf = m.RHF()
        mf.conv_tol = 1e-11
        mf.init_guess = 'hcore'
        mf.kernel()
        return mf

    mol_i, e_i = internal.optimize(mf_factory, mol)
    r = np.asarray(mol_i.coords)
    roh = np.linalg.norm(r[0] - r[1]) * BOHR
    ang = np.degrees(np.arccos(
        np.dot(r[1] - r[0], r[2] - r[0])
        / np.linalg.norm(r[1] - r[0]) / np.linalg.norm(r[2] - r[0])))
    assert abs(roh - 0.989) < 0.01
    assert abs(ang - 100.0) < 2.0
    assert len(e_i) <= 10
    assert len(e_i) == len(refs.E_WATER_OPT_RHF_STO3G)
    assert np.max(np.abs(np.array(e_i)
                         - np.array(refs.E_WATER_OPT_RHF_STO3G))) < 1e-8


def test_optimize_ts_raises():
    mol = tpt.M(atom=CHAIN, basis='sto-3g', device='cpu')
    with pytest.raises(NotImplementedError, match='Hessian'):
        tpt.geomopt.optimize_ts(lambda m: None, mol)
