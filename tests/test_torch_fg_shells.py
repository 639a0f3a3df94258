"""f, g and aux h shells: pyscf_tpu_torch (the plain twins of the int1e_stv,
int3c2e, int2c2e and int2e kernels, on the CPU) against pyscf_tpu.

Water/cc-pVTZ (f on O; cc-pvtz-jkfit to g), water/def2-TZVP (f on O;
def2-universal-jkfit to g) and Ne/cc-pVQZ (g; cc-pvqz-jkfit to h) reach
every class that BASELINE configs 3 ((H2O)10 DF-RHF/cc-pVTZ) and 4 (N2
CCSD(T)/cc-pVQZ) run, at the size of a test. The energies are the JAX
package's, recorded once in pyscf_tpu_torch/refs.py, and its S/T/V,
mol.intor arrays, (gg|..) ERI block and (gg|P) rows in port_refs.npz
(tests/port_refs_record.py fg_water_refs and fg_neon_refs: the JAX
package compiles each class for the CPU, 10-30 s each); the (ff) class
of _class_stv and of _class_program are compared live."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyscf_tpu as jpt
from pyscf_tpu.df.addons import make_auxmol as jax_make_auxmol
from pyscf_tpu.ops.integrals import j1e as jax_j1e
from pyscf_tpu.ops.integrals import j3c as jj3c

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import j1e, j3c

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def recorded():
    return np.load(refs.PORT_REFS)


@pytest.fixture(scope='module')
def water_tz():
    kw = dict(atom=refs.WATER, basis='cc-pvtz')
    return jpt.M(verbose=0, **kw), tpt.M(device='cpu', **kw)


@pytest.fixture(scope='module')
def neon_qz():
    return tpt.M(atom='Ne 0 0 0', basis='cc-pvqz', device='cpu')


def _close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _scf(mf, conv_tol=1e-10, grids_level=None):
    if grids_level is not None:
        mf.grids.level = grids_level
    mf.init_guess = 'minao'
    mf.conv_tol = conv_tol
    e = mf.kernel()
    assert mf.converged
    return e


@pytest.mark.parametrize('basis, xc, ref', [
    ('cc-pvtz', None, refs.E_WATER_DF_RHF_CCPVTZ),
    ('cc-pvtz', 'b3lypg', refs.E_WATER_DF_RKS_B3LYPG_CCPVTZ_L1),
    ('def2-tzvp', 'b3lypg', refs.E_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1)])
def test_water_df_energy_matches_jax(basis, xc, ref):
    """Water DF-RHF and DF-RKS b3lypg (grids level 1) with f shells, minao,
    conv_tol 1e-10, within 1e-8 Ha of the JAX package's energy."""
    mol = tpt.M(atom=refs.WATER, basis=basis, device='cpu')
    assert max(mol.shell_groups) == 3
    mf = (mol.RKS(xc=xc) if xc else mol.RHF()).density_fit()
    e = _scf(mf, grids_level=1 if xc else None)
    assert abs(e - ref) < 1e-8


def test_neon_qz_rhf_and_mp2_match_jax(neon_qz):
    """Ne/cc-pVQZ in-core RHF (minao, conv_tol 1e-12, conv_tol_grad 1e-9)
    and MP2, g shells through the in-core ERI tensor: within 1e-8 Ha of the
    JAX package's."""
    mf = neon_qz.RHF()
    mf.conv_tol_grad = 1e-9
    e = _scf(mf, conv_tol=1e-12)
    assert abs(e - refs.E_NE_RHF_CCPVQZ) < 1e-8
    assert abs(mf.MP2().kernel()[0] - refs.E_NE_MP2_CCPVQZ) < 1e-8
    g = slice(neon_qz.nao - 9, neon_qz.nao)     # the (gg|gg) block
    blk = mf._eri[g, g, g, g]
    for perm in ((1, 0, 2, 3), (2, 3, 0, 1), (0, 1, 3, 2)):
        assert torch.max(torch.abs(blk - blk.permute(perm))) < 1e-13


def test_stv_matches_jax(water_tz, recorded):
    """S/T/V of water/cc-pVTZ, (ff) and (df) among its classes, against the
    JAX package's hcore_parts (recorded)."""
    _close(j1e.hcore_parts(water_tz[1]), recorded['fg_tz_stv'])


def test_ff_stv_class_matches_live_jax(water_tz):
    """The (ff) class's S/T/V rows against _class_stv run now."""
    mj, mt = water_tz
    bc = jj3c._bra_classes(mj)[(3, 3)]
    arrays, _ = bc.chunk_arrays(bc.nsel)
    ref = jax_j1e._class_stv(3, 3, *[jnp.asarray(a) for a in arrays],
                             jnp.asarray(mj.coords),
                             jnp.asarray(mj.charges, dtype=jnp.float64))
    zr = torch.as_tensor(mt.coords)
    zq = torch.as_tensor(mt.charges, dtype=torch.float64)
    p = j3c.screened_pairs(mt)[(3, 3)][1]
    _close(kernels.int1e_stv(3, 3, *p, zr, zq), np.asarray(ref)[:bc.nsel])


@pytest.mark.parametrize('name', ['int1e_ovlp', 'int1e_kin', 'int1e_nuc_sph',
                                  'int2c2e'])
def test_intor_matches_jax(water_tz, recorded, name):
    """mol.intor's S, T, V and the metric over the orbital basis's own
    shells, on the Mole's device and in AO order, against the JAX
    package's mol.intor (recorded)."""
    got = water_tz[1].intor(name)
    assert got.device == water_tz[1].device
    _close(got, recorded[f'fg_tz_intor_{name.replace("_sph", "")}'])


def test_intor_ecp_raises(water_tz):
    with pytest.raises(NotImplementedError, match='ECP'):
        water_tz[1].intor('ECPscalar')


def test_ff_3c_rows_match_live_jax(water_tz):
    """Raw (ij|P) rows of water/cc-pVTZ's (ff) class against cc-pvtz-jkfit
    (to g) and the JAX package's _class_program run now."""
    mj, mt = water_tz
    auxmol = jax_make_auxmol(mj)
    meta, raw = jj3c._aux_meta(auxmol)
    aux_data = jj3c._aux_prep(meta, tuple(
        (jnp.asarray(e), jnp.asarray(c), jnp.asarray(r)) for e, c, r in raw))
    bc = jj3c._bra_classes(mj)[(3, 3)]
    npc, tiles = jj3c._class_tiles(bc, meta)
    arrays, _ = bc.chunk_arrays(npc)
    ref = np.asarray(jj3c._class_program(
        3, 3, meta, tiles, *[jnp.asarray(a) for a in arrays], aux_data,
        jnp.eye(auxmol.nao)))
    aux = j3c.aux_tables(make_auxmol(mt))
    p = j3c.screened_pairs(mt)[(3, 3)][1]
    _close(kernels.int3c2e(3, 3, *p, aux), ref[:bc.nsel * bc.ns1])


def test_gg_3c_rows_match_jax(neon_qz, recorded):
    """Raw (ij|P) rows of Ne/cc-pVQZ's (gg) class against cc-pvqz-jkfit (to
    h, lc 5) against the JAX package's _class_program rows (recorded)."""
    aux = j3c.aux_tables(make_auxmol(neon_qz))
    assert max(l for l, *_ in aux) == 5
    p = j3c.screened_pairs(neon_qz)[(4, 4)][1]
    _close(kernels.int3c2e(4, 4, *p, aux), recorded['fg_ne_rows_44'])


def test_eri_gg_rows_match_jax(neon_qz, recorded):
    """(gg|ff), (gg|fg) and (gg|gg) rows of Ne/cc-pVQZ against the JAX
    package's ERI tensor (recorded: its g x g x (f, g) x (f, g) block)."""
    ref = recorded['fg_ne_eri_gg']
    off = neon_qz.nao - 23                      # the first f AO
    pairs = j3c.screened_pairs(neon_qz)
    p = pairs[(4, 4)][1]
    for lc, ld in ((3, 3), (3, 4), (4, 4)):
        bc, ket = pairs[(lc, ld)]
        dc, dd = 2 * lc + 1, 2 * ld + 1
        rows = kernels.int2e(4, 4, *p, [(lc, ld, *ket)])
        rows = rows.reshape(9, 9, bc.nsel, dc, dd)
        for k in range(bc.nsel):
            i = bc.ga.ao_off[bc.sel_a[k]] - off
            j = bc.gb.ao_off[bc.sel_b[k]] - off
            _close(rows[:, :, k], ref[:, :, i:i + dc, j:j + dd])
