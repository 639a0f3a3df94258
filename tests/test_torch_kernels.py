"""The CUDA kernels against their plain PyTorch twins on the card.

Marked `gpu`: a CUDA kernel has no interpret mode, so these tests skip
where torch finds no CUDA device, and run on a machine with an NVIDIA GPU
and nvcc (python -m pytest tests/test_torch_kernels.py -m gpu)."""
import numpy as np
import pytest
import torch

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.dft import gen_grid, numint, xc
from pyscf_tpu_torch.ops import eval_gto, kernels
from pyscf_tpu_torch.ops.integrals import (int1e, int1e_deriv, int2e, j2e,
                                           j3c, j3c_deriv)

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def water():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cuda')
    return mol, make_auxmol(mol)


def test_int1e_stv(water):
    mol, _ = water
    zr = torch.as_tensor(mol.coords, device='cuda')
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device='cuda')
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int1e_stv(la, lb, *p, zr, zq)
        ref = int1e.class_stv(la, lb, *p, zr, zq)
        assert torch.max(torch.abs(got - ref)) < 1e-12


def test_int3c2e(water):
    mol, auxmol = water
    aux = j3c.aux_tables(auxmol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int3c2e(la, lb, *p, aux)
        ref = j3c.int3c2e_plain(la, lb, *p, aux)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2c2e(water):
    _, auxmol = water
    aux = j3c.aux_tables(auxmol)
    got, ref = kernels.int2c2e(aux), j3c.int2c2e_plain(aux)
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2e(water):
    """Every ordered class pair of water/def2-SVP, up to (dd|dd)."""
    mol, _ = water
    kets = j2e._ket_arrays(mol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int2e(la, lb, *p, kets)
        ref = j2e.int2e_class_plain(la, lb, *p, kets)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int1e_ip_and_iprinv(water):
    """Every ordered class of water/def2-SVP, up to (d, d)."""
    mol, _ = water
    zr = torch.as_tensor(mol.coords, device='cuda')
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device='cuda')
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        got = kernels.int1e_ip(la, lb, *p, zr, zq)
        ref = int1e_deriv.class_ip(la, lb, *p, zr, zq)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()
        got = kernels.int1e_iprinv(la, lb, *p, zr)
        ref = int1e_deriv.class_iprinv(la, lb, *p, zr)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2e_ip1(water):
    """Every (ordered bra class, ket class) of water/def2-SVP, up to
    (dd|dd)."""
    mol, _ = water
    kets = j2e._ket_arrays(mol)
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        got = kernels.int2e_ip1(la, lb, *p, kets)
        ref = int2e.int2e_ip1_class_plain(la, lb, *p, kets)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_rhf_gradient_on_card_launches_its_kernels(water):
    kernels.reset_launches()
    mf = tpt.M(atom=refs.WATER, basis='def2-svp').RHF()
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.kernel()
    assert mf.converged
    de = mf.nuc_grad_method().kernel()
    assert np.max(np.abs(de - np.array(refs.GRAD_WATER_RHF_DEF2SVP))) < 1e-8
    launches = kernels.launches()
    assert all(launches[k] > 0 for k in ('int1e_ip', 'int1e_iprinv',
                                         'int2e_ip1'))


def test_incore_rhf_on_card_launches_int2e(water):
    kernels.reset_launches()
    mf = tpt.M(atom=refs.WATER, basis='sto-3g', device='cuda').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    e = mf.kernel()
    assert mf.converged and abs(e - (-74.96306312971071)) < 1e-8
    assert kernels.launches()['int2e'] > 0


def test_df_rhf_on_card_launches_every_kernel(water):
    kernels.reset_launches()
    mol = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cuda')
    mf = mol.RHF().density_fit()
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mf.converged
    assert abs(e - refs.E_WATER_DF_RHF_CCPVDZ) < 1e-8
    launches = kernels.launches()
    assert all(launches[k] > 0 for k in ('int1e_stv', 'int3c2e', 'int2c2e'))


@pytest.fixture(scope='module')
def water_grid(water):
    mol, _ = water
    grids = gen_grid.Grids(mol)
    grids.level = 1
    return grids.build()


@pytest.mark.parametrize('basis', ['def2-svp', 'cc-pvtz'])
@pytest.mark.parametrize('deriv', [0, 1])
def test_eval_ao(water_grid, basis, deriv):
    """cc-pVTZ brings the f shells (l = 3)."""
    mol = tpt.M(atom=refs.WATER, basis=basis, device='cuda')
    tables = eval_gto.ao_tables(mol)
    got = kernels.eval_ao(tables, water_grid.coords, mol.nao, deriv)
    ref = eval_gto.eval_ao_plain(tables, water_grid.coords, mol.nao, deriv)
    assert torch.max(torch.abs(got - ref)) <= 1e-13


def test_becke(water):
    mol, _ = water
    args = gen_grid.partition_inputs(mol, gen_grid.gen_atomic_grids(mol))
    got = kernels.becke(*args)
    ref = gen_grid.becke_weights_plain(*args)
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.max()


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn', 'blyp'])
def test_xc_rks(water, water_grid, xc_code):
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1 if f.is_gga else 0)
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.standard_normal((mol.nao, 5)) * 0.3,
                        device='cuda')
    dmao = (aod[0] if f.is_gga else aod) @ (2.0 * c @ c.T)
    got = kernels.xc_rks(aod, dmao, water_grid.weights, f)
    ref = numint.xc_rks_plain(aod, dmao, water_grid.weights, f)
    assert torch.max(torch.abs(got[0] - ref[0])) <= 1e-11 * ref[0].abs().max()
    for a, b in zip(got[1:], ref[1:]):
        assert abs(float(a - b)) <= 1e-11 * abs(float(b))


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_xc_uks(water, water_grid, xc_code):
    """On a random spin density (5 alpha and 4 beta orbitals)."""
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1 if f.is_gga else 0)
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.standard_normal((2, mol.nao, 5)) * 0.3,
                        device='cuda')
    c[1, :, 4] = 0.0
    dm = c @ c.transpose(1, 2)
    dmao = (aod[0] if f.is_gga else aod) @ dm
    got = kernels.xc_uks(aod, dmao, water_grid.weights, f)
    ref = numint.xc_uks_plain(aod, dmao, water_grid.weights, f)
    assert torch.max(torch.abs(got[0] - ref[0])) <= 1e-11 * ref[0].abs().max()
    assert torch.all(torch.abs(got[1] - ref[1]) <= 1e-11 * torch.abs(ref[1]))
    assert abs(float(got[2] - ref[2])) <= 1e-11 * abs(float(ref[2]))


def test_xc_rks_refuses_a_component_it_lacks(water, water_grid):
    mol, _ = water
    f = xc.parse_xc('b3lypg')
    f = xc.XCFunctional(f.hyb, f.terms + [(0.1, xc.GGA, 'PBE_X')])
    aod = eval_gto.eval_ao(mol, water_grid.coords[:64], 1)
    with pytest.raises(NotImplementedError, match='PBE_X'):
        kernels.xc_rks(aod, aod[0].clone(), water_grid.weights[:64], f)


def test_df_rks_on_card_launches_every_kernel(water):
    kernels.reset_launches()
    mol = tpt.M(atom=refs.WATER, basis='def2-svp')
    mf = tpt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mol.device.type == 'cuda' and mf.converged
    assert abs(e - refs.E_WATER_DF_RKS_B3LYPG_L1) < 1e-8
    launches = kernels.launches()
    assert all(launches[k] > 0 for k in ('int1e_stv', 'int3c2e', 'int2c2e',
                                         'eval_ao', 'becke', 'xc_rks'))


def test_df_uks_on_card_launches_xc_uks(water):
    kernels.reset_launches()
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1)
    mf = mol.UKS(xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mol.device.type == 'cuda' and mf.converged
    assert abs(e - refs.E_WATER_CATION_DF_UKS_B3LYPG_L1) < 1e-8
    assert kernels.launches()['xc_uks'] > 0


def test_int3c2e_ip(water):
    """Every bra class of water/def2-SVP against every aux class, up to
    (dd|g), on seeded Gamma rows."""
    mol, auxmol = water
    aux = j3c.aux_tables(auxmol)
    naux = auxmol.nao
    rng = np.random.default_rng(3)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        G = torch.as_tensor(rng.standard_normal(
            (p[0].shape[0] * (2 * la + 1) * (2 * lb + 1), naux)),
            device='cuda')
        got = kernels.int3c2e_ip(la, lb, *p, aux, G)
        ref = j3c_deriv.int3c2e_ip_plain(la, lb, *p, aux, G)
        assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


def test_int2c2e_ip1(water):
    _, auxmol = water
    aux = j3c.aux_tables(auxmol)
    W = np.random.default_rng(4).standard_normal((auxmol.nao,) * 2)
    W = torch.as_tensor(W + W.T, device='cuda')
    got = kernels.int2c2e_ip1(aux, W)
    ref = j3c_deriv.int2c2e_ip1_plain(aux, W)
    assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


@pytest.mark.parametrize('basis', ['def2-svp', 'cc-pvtz'])
def test_eval_ao_deriv2(water_grid, basis):
    mol = tpt.M(atom=refs.WATER, basis=basis, device='cuda')
    tables = eval_gto.ao_tables(mol)
    kernels.reset_launches()
    got = kernels.eval_ao(tables, water_grid.coords, mol.nao, 2)
    assert kernels.launches()['eval_ao_deriv2'] == len(tables)
    assert kernels.launches()['eval_ao'] == 0
    ref = eval_gto.eval_ao_plain(tables, water_grid.coords, mol.nao, 2)
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_xc_rks_grad(water, water_grid, xc_code):
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 2 if f.is_gga else 1)
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.standard_normal((mol.nao, 5)) * 0.3,
                        device='cuda')
    nd = 4 if f.is_gga else 1
    dmao = (aod[:nd].reshape(-1, mol.nao) @ (2.0 * c @ c.T)).reshape(
        nd, -1, mol.nao)
    g, e = kernels.xc_rks_grad(aod, dmao, water_grid.weights, f)
    g_ref, e_ref = numint.xc_rks_grad_plain(aod, dmao, water_grid.weights, f)
    assert torch.max(torch.abs(g - g_ref)) <= 1e-10 * g_ref.abs().max()
    assert abs(float(e - e_ref)) <= 1e-11 * abs(float(e_ref))


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_xc_uks_grad(water, water_grid, xc_code):
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 2 if f.is_gga else 1)
    rng = np.random.default_rng(6)
    dm = []
    for _ in range(2):
        c = torch.as_tensor(rng.standard_normal((mol.nao, 4)) * 0.3,
                            device='cuda')
        dm.append(c @ c.T)
    nd = 4 if f.is_gga else 1
    dmao = (aod[:nd].reshape(-1, mol.nao) @ torch.stack(dm)).reshape(
        2, nd, -1, mol.nao)
    g, e = kernels.xc_uks_grad(aod, dmao, water_grid.weights, f)
    g_ref, e_ref = numint.xc_uks_grad_plain(aod, dmao, water_grid.weights, f)
    assert torch.max(torch.abs(g - g_ref)) <= 1e-10 * g_ref.abs().max()
    assert abs(float(e - e_ref)) <= 1e-11 * abs(float(e_ref))


def test_int1e_r(water):
    """Every ordered class pair of water/def2-SVP; mol.intor('int1e_r')
    launches one kernel per class pair."""
    mol, _ = water
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        got = kernels.int1e_r(la, lb, *p)
        ref = int1e.class_r(la, lb, *p)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()
    kernels.reset_launches()
    assert mol.intor('int1e_r').shape == (3, mol.nao, mol.nao)
    assert kernels.launches()['int1e_r'] == 9


@pytest.mark.parametrize('case', ['rhf', 'rks', 'uhf', 'uks'])
def test_df_gradient_on_card_launches_its_kernels(water, case):
    """Water/def2-SVP DF-RHF, DF-RKS b3lypg (grids level 1) and the water
    cation's DF-UHF and DF-UKS b3lypg (grids level 1) against the
    recorded JAX gradients, 1e-8."""
    kernels.reset_launches()
    if case == 'uhf':
        mf = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1,
                   spin=1).UHF().density_fit()
        ref = refs.GRAD_WATER_CATION_DF_UHF_DEF2SVP
    elif case == 'uks':
        mf = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1,
                   spin=1).UKS(xc='b3lypg').density_fit()
        mf.grids.level = 1
        ref = refs.GRAD_WATER_CATION_DF_UKS_B3LYPG_L1
    elif case == 'rks':
        mf = tpt.M(atom=refs.WATER, basis='def2-svp').RKS(
            xc='b3lypg').density_fit()
        mf.grids.level = 1
        ref = refs.GRAD_WATER_DF_RKS_B3LYPG_L1
    else:
        mf = tpt.M(atom=refs.WATER, basis='def2-svp').RHF().density_fit()
        ref = refs.GRAD_WATER_DF_RHF_DEF2SVP
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.kernel()
    assert mf.converged
    de = mf.nuc_grad_method().kernel()
    assert np.max(np.abs(de - np.array(ref))) < 1e-8
    names = ['int1e_ip', 'int1e_iprinv', 'int3c2e_ip', 'int2c2e_ip1']
    if case in ('rks', 'uks'):
        names += ['eval_ao_deriv2', f'xc_{case}_grad']
    assert all(kernels.launches()[k] > 0 for k in names)
