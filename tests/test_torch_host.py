"""pyscf_tpu_torch host layer against pyscf_tpu: shell tables, AO and aux
sizes, nuclear repulsion, the compat hand-over and the device contract."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.df.addons import make_auxmol as jax_make_auxmol

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.gto import basis as basis_mod

torch.set_num_threads(1)

FIELDS = ('coords', 'exps', 'coeffs', 'ao_off', 'atom_ids')


def _assert_same_groups(gj, gt):
    assert sorted(gj) == sorted(gt)
    for l in gj:
        assert (gj[l].l, gj[l].nshl, gj[l].nprim) == \
            (gt[l].l, gt[l].nshl, gt[l].nprim)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(gj[l], f), getattr(gt[l], f))


@pytest.mark.parametrize('atom,basis,nao,naux', [
    (refs.WATER, 'cc-pvdz', 24, None),
    (refs.BENZENE, 'def2-svp', 114, 558),
])
def test_tables_match_jax(atom, basis, nao, naux):
    mj = jpt.M(atom=atom, basis=basis, verbose=0)
    mt = tpt.M(atom=atom, basis=basis, device='cpu')
    _assert_same_groups(mj.shell_groups, mt.shell_groups)
    assert mt.nao == mj.nao == nao
    assert mt.nelectron == mj.nelectron
    assert abs(mt.energy_nuc() - mj.energy_nuc()) < 1e-12
    aj, at = jax_make_auxmol(mj), make_auxmol(mt)
    _assert_same_groups(aj.shell_groups, at.shell_groups)
    assert at.nao == aj.nao
    if naux is not None:
        assert at.nao == naux
        assert max(at.shell_groups) == 4


def test_compat_round_trip():
    mj = jpt.M(atom=refs.WATER, basis='cc-pvdz', verbose=0)
    tables = {l: {'l': g.l, **{f: getattr(g, f) for f in FIELDS}}
              for l, g in mj.shell_groups.items()}
    groups = compat.shell_groups_from_numpy(tables, 'cpu')
    _assert_same_groups(mj.shell_groups, groups)
    a = np.random.default_rng(3).standard_normal((5, 4))
    t = compat.tensor_from_numpy(a, 'cpu')
    assert t.dtype == torch.float64 and t.device.type == 'cpu'
    np.testing.assert_array_equal(t.numpy(), a)


def test_mole_requires_device(monkeypatch):
    """Without a device the Mole goes to the card; with no card it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.M(atom=refs.WATER, basis='sto-3g')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert tpt.M(atom=refs.WATER, basis='sto-3g').device.type == 'cuda'
    assert tpt.M(atom=refs.WATER, basis='sto-3g',
                 device='cpu').device.type == 'cpu'


def test_missing_basis_dir_raises(monkeypatch):
    monkeypatch.setattr(basis_mod, '_DATA_DIR', '/nonexistent/basis_data')
    basis_mod._load_file.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match='basis data'):
            basis_mod.load('sto-3g', 'H')
    finally:
        basis_mod._load_file.cache_clear()
