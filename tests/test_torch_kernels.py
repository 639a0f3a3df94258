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


# s to g shells, and an aux basis of s to h shells (tests/test_torch_csrc_
# host.py's HOST_BASIS and HOST_AUX), on two centres off the origin
FG_ATOMS = 'O 0.1 0.2 -0.3; H 0.3 -0.7 0.6'
FG_BASIS = {'O': [[0, [3.0, 0.6], [0.8, 0.5]], [1, [1.1, 1.0]],
                  [2, [0.9, 1.0]], [3, [0.7, 0.4], [2.0, 0.7]],
                  [4, [0.6, 1.0]]],
            'H': [[0, [1.2, 1.0]], [1, [0.9, 1.0]], [2, [0.5, 1.0]]]}
FG_AUX = {'O': [[l, [0.7 + 0.4 * l, 1.0]] for l in range(6)],
          'H': [[0, [1.4, 1.0]], [2, [0.8, 1.0]]]}


@pytest.fixture(scope='module')
def fg_mols():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return (tpt.M(atom=FG_ATOMS, basis=FG_BASIS, device='cuda'),
            tpt.M(atom=FG_ATOMS, basis=FG_AUX, device='cuda'))


def _close(got, ref):
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int1e_stv_f_and_g(fg_mols):
    """S/T/V of every class la <= lb to (gg), and S alone of every ordered
    class."""
    mol, _ = fg_mols
    zr = torch.as_tensor(mol.coords, device='cuda')
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device='cuda')
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        _close(kernels.int1e_stv(la, lb, *p, zr, zq),
               int1e.class_stv(la, lb, *p, zr, zq))
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        _close(kernels.int1e_stv(la, lb, *p, with_tv=False),
               int1e.class_stv(la, lb, *p, with_tv=False))


@pytest.mark.parametrize('omega', [None, 0.3])
def test_int3c2e_f_and_g(fg_mols, omega):
    """The (ff) and (gg) bra classes against aux shells to h (lc 5)."""
    mol, auxmol = fg_mols
    aux = j3c.aux_tables(auxmol)
    classes = j3c.screened_pairs(mol)
    for la, lb in ((3, 3), (4, 4)):
        p = classes[(la, lb)][1]
        _close(kernels.int3c2e(la, lb, *p, aux, omega),
               j3c.int3c2e_plain(la, lb, *p, aux, omega))


def test_int2c2e_to_h(fg_mols):
    aux = j3c.aux_tables(fg_mols[1])
    _close(kernels.int2c2e(aux), j3c.int2c2e_plain(aux))


@pytest.mark.parametrize('omega', [None, 0.3])
def test_int2e_f_and_g(fg_mols, omega):
    """(ff|..) and (gg|..) against every ket class to (gg)."""
    mol, _ = fg_mols
    kets = j2e._ket_arrays(mol)
    classes = j3c.screened_pairs(mol)
    for la, lb in ((3, 3), (4, 4)):
        p = classes[(la, lb)][1]
        _close(kernels.int2e(la, lb, *p, kets, omega),
               j2e.int2e_class_plain(la, lb, *p, kets, omega))


def test_f_shell_derivative_kernel_raises(fg_mols):
    """The derivative kernels stop at d: an f class raises on the card."""
    mol, _ = fg_mols
    kets = j2e._ket_arrays(mol)
    p = j3c.screened_pairs(mol)[(3, 3)][1]
    with pytest.raises(NotImplementedError):
        kernels.int2e_ip1(3, 3, *p, kets)


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


def _attenuation_scale(f, r, s):
    """1e-13 of rho_s^(4/3) g_s T(a_s) per point of one spin density r and
    sigma_ss s, T(a) = (8/3) a (sqrt(pi) + 3a + 8a^3): the rounding of the
    range-separated attenuation F(a), which cancels terms of size T(a) to
    ~1e-5 at large a (as tests/test_torch_rsh.py _attenuation_scale
    gates it, where it is held to jax.grad); zero without range
    separation."""
    if not f.omega:
        return torch.zeros_like(r)
    r = torch.clamp(r, min=numint.RHO_THR)
    if f.terms[0][2] == 'CAM_B88':
        y = torch.sqrt(torch.clamp(s, min=1e-30)) / r ** (4 / 3)
        K = 2 * 0.9305257363491002 + 2 * 0.0042 * y * y / (
            1 + 6 * 0.0042 * y * torch.asinh(y))
        k, g = torch.sqrt(9 * np.pi / K) * r ** (1 / 3), 0.5 * K
    else:
        k, g = (6 * np.pi ** 2 * r) ** (1 / 3), 1.0
    a = torch.clamp(f.omega / (2 * k), 1e-10, 50.0)
    return 1e-13 * r ** (4 / 3) * g * (8 / 3) * a * (
        np.sqrt(np.pi) + 3 * a + 8 * a ** 3)


def _density(aod, dmao):
    """(rho, grad rho (3, B)) of dmao = ao @ dm on aod (4, B, nao)."""
    rho = torch.einsum('bi,bi->b', dmao, aod[0])
    return rho, 2.0 * torch.einsum('bi,dbi->db', dmao, aod[1:])


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn', 'blyp', 'wb97x-v',
                                     'camb3lyp', 'b97-1'])
def test_xc_rks(water, water_grid, xc_code):
    """vtmp to 1e-11 of its largest magnitude; for a range-separated
    functional plus, per point and AO, the attenuation's rounding carried
    into vrho and vsigma (over rho and sigma) and from them into vtmp's
    two terms."""
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1 if f.is_gga else 0)
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.standard_normal((mol.nao, 5)) * 0.3,
                        device='cuda')
    dmao = (aod[0] if f.is_gga else aod) @ (2.0 * c @ c.T)
    w = water_grid.weights
    got = kernels.xc_rks(aod, dmao, w, f)
    ref = numint.xc_rks_plain(aod, dmao, w, f)
    gate = 1e-11 * ref[0].abs().max()
    if f.omega:
        rho, grho = _density(aod, dmao)
        sigma = torch.clamp((grho * grho).sum(0), min=numint.SIGMA_FLOOR)
        att = w * _attenuation_scale(f, 0.5 * rho, 0.25 * sigma)
        gate = gate + att[:, None] * (
            0.5 * aod[0].abs() / torch.clamp(rho, min=numint.RHO_THR)[:, None]
            + 2.0 * torch.einsum('db,dbi->bi', grho, aod[1:]).abs()
            / sigma[:, None])
    assert torch.all(torch.abs(got[0] - ref[0]) <= gate)
    for a, b in zip(got[1:], ref[1:]):
        assert abs(float(a - b)) <= 1e-11 * abs(float(b))


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn', 'wb97x-v',
                                     'camb3lyp'])
def test_xc_uks(water, water_grid, xc_code):
    """On a random spin density (5 alpha and 4 beta orbitals); vtmp gated
    as test_xc_rks's, per spin."""
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1 if f.is_gga else 0)
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.standard_normal((2, mol.nao, 5)) * 0.3,
                        device='cuda')
    c[1, :, 4] = 0.0
    dm = c @ c.transpose(1, 2)
    dmao = (aod[0] if f.is_gga else aod) @ dm
    w = water_grid.weights
    got = kernels.xc_uks(aod, dmao, w, f)
    ref = numint.xc_uks_plain(aod, dmao, w, f)
    gate = 1e-11 * ref[0].abs().max()
    if f.omega:
        (ra, ga), (rb, gb) = _density(aod, dmao[0]), _density(aod, dmao[1])
        saa = torch.clamp((ga * ga).sum(0), min=numint.SIGMA_FLOOR)
        sbb = torch.clamp((gb * gb).sum(0), min=numint.SIGMA_FLOOR)
        att = w * (_attenuation_scale(f, ra, saa)
                   + _attenuation_scale(f, rb, sbb))
        gate = gate + torch.stack([att[:, None] * (
            0.5 * aod[0].abs() / torch.clamp(r, min=numint.RHO_THR)[:, None]
            + 2.0 * torch.einsum('db,dbi->bi', g, aod[1:]).abs() / s[:, None]
            + torch.einsum('db,dbi->bi', go, aod[1:]).abs()
            / torch.sqrt(saa * sbb)[:, None])
            for r, g, s, go in ((ra, ga, saa, gb), (rb, gb, sbb, ga))])
    assert torch.all(torch.abs(got[0] - ref[0]) <= gate)
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


# ---- range separation and VV10 ----------------------------------------------

OMEGA = 0.3


def test_int3c2e_lr(water):
    mol, auxmol = water
    aux = j3c.aux_tables(auxmol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int3c2e(la, lb, *p, aux, OMEGA)
        ref = j3c.int3c2e_plain(la, lb, *p, aux, OMEGA)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2c2e_lr(water):
    _, auxmol = water
    aux = j3c.aux_tables(auxmol)
    got, ref = kernels.int2c2e(aux, OMEGA), j3c.int2c2e_plain(aux, OMEGA)
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2e_lr(water):
    mol, _ = water
    kets = j2e._ket_arrays(mol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int2e(la, lb, *p, kets, OMEGA)
        ref = j2e.int2e_class_plain(la, lb, *p, kets, OMEGA)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_vv10(water, water_grid):
    """At a random density (5 orbitals) on water's level-1 grid: E to 1e-11
    relative, the derivatives to 1e-11 of their largest magnitude."""
    from pyscf_tpu_torch.dft import vv10
    mol, _ = water
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1)
    rng = np.random.default_rng(9)
    c = torch.as_tensor(rng.standard_normal((mol.nao, 5)) * 0.3,
                        device='cuda')
    dmao = aod[0] @ (2.0 * c @ c.T)
    rho = torch.clamp(torch.einsum('bi,bi->b', dmao, aod[0]), min=0.0)
    grho = 2.0 * torch.einsum('bi,dbi->db', dmao, aod[1:])
    args = (rho, torch.einsum('db,db->b', grho, grho), water_grid.coords,
            water_grid.weights, 6.0, 0.01)
    got, ref = kernels.vv10(*args), vv10.vv10_plain(*args)
    assert abs(float(got[0] - ref[0])) <= 1e-11 * abs(float(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        assert torch.max(torch.abs(a - b)) <= 1e-11 * b.abs().max()


@pytest.mark.parametrize('case', ['rks', 'uks', 'rks-incore'])
def test_wb97xv_on_card_launches_its_kernels(water, case):
    """Water (cation for UKS) wB97X-V/def2-SVP, level-1 grids, against the
    recorded JAX energies, with vv10, the XC kernel and the long-range
    integral kernels launched."""
    kernels.reset_launches()
    spin = int(case == 'uks')
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=spin, spin=spin)
    mf = mol.UKS(xc='wb97x-v') if spin else mol.RKS(xc='wb97x-v')
    if case != 'rks-incore':
        mf = mf.density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    e = mf.kernel()
    ref = {'rks': refs.E_WATER_DF_RKS_WB97XV_L1,
           'uks': refs.E_WATER_CATION_DF_UKS_WB97XV_L1,
           'rks-incore': refs.E_WATER_RKS_WB97XV_L1}[case]
    assert mf.converged and abs(e - ref) < 1e-8
    launches = kernels.launches()
    lr = ('int2e_lr',) if case == 'rks-incore' else ('int3c2e_lr',
                                                      'int2c2e_lr')
    assert all(launches[k] > 0 for k in ('vv10', 'xc_uks' if spin else
                                         'xc_rks') + lr)
    assert mf.timings['vv10'] > 0.0


def _seeded_cc_card(seed, no=5, nv=9):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((no, nv, no, nv)) * 0.1

    def card(a):
        return torch.as_tensor(a, device='cuda')
    eo = -0.5 - rng.random(no) * 20
    ev = 0.2 + rng.random(nv) * 3
    return dict(
        ovov=card(g + g.transpose(2, 3, 0, 1)), eo=card(eo), ev=card(ev),
        eia=card(eo[:, None] - ev[None, :]),
        t1=card(rng.standard_normal((no, nv)) * 0.02),
        t2=card(rng.standard_normal((no, no, nv, nv)) * 0.05),
        ooov=card(rng.standard_normal((no, no, no, nv)) * 0.1),
        ovvv=card(rng.standard_normal((no, nv, nv, nv)) * 0.1))


def test_mp2_energy(water):
    """The kernel against mp2_energy_plain on the card: MP2 amplitudes to
    1e-13 of their largest, the sums to 1e-12 relative; the CCSD tau read
    in its (i,j,a,b) layout; an opposite-spin block without exchange."""
    from pyscf_tpu_torch.mp.mp2 import mp2_energy_plain
    d = _seeded_cc_card(5)
    ovov, eia = d['ovov'], d['eia']
    t2, dd, dx = kernels.mp2_energy(ovov, eia, eia)
    rt2, rd, rx = mp2_energy_plain(ovov, eia, eia)
    assert torch.max(torch.abs(t2 - rt2)) <= 1e-13 * rt2.abs().max()
    for got, ref in ((dd, rd), (dx, rx)):
        assert abs(float(got - ref)) <= 1e-12 * abs(float(ref))
    tau = (d['t2'] + torch.einsum('ia,jb->ijab', d['t1'], d['t1'])
           ).contiguous()
    got = kernels.mp2_energy(ovov, tau=tau)
    ref = mp2_energy_plain(ovov, None, None, tau)
    assert got[0] is None
    for a, b in zip(got[1:], ref[1:]):
        assert abs(float(a - b)) <= 1e-12 * abs(float(b))
    eib = eia[:3, :7].contiguous()
    ovab = ovov[:, :, :3, :7].contiguous()
    got = kernels.mp2_energy(ovab, eia, eib, exchange=False)
    ref = mp2_energy_plain(ovab, eia, eib, exchange=False)
    assert got[2] is None
    assert abs(float(got[1] - ref[1])) <= 1e-12 * abs(float(ref[1]))


def test_ccsd_t(water, monkeypatch):
    """The kernel against et_plain on the card over every triple of seeded
    tensors (nocc 5, nvir 9; all three multiplicities), 1e-12 relative,
    with the vvov slices staged whole and, under a shared-memory cap, in f
    tiles of 4."""
    from types import SimpleNamespace

    from pyscf_tpu_torch.cc import ccsd_t
    d = _seeded_cc_card(7)
    no = d['t1'].shape[0]
    eris = SimpleNamespace(ovvv=d['ovvv'], ooov=d['ooov'], ovov=d['ovov'],
                           mo_energy=torch.cat([d['eo'], d['ev']]))
    args = ccsd_t.kernel_args(eris, d['t1'], d['t2'])
    ref = ccsd_t.et_plain(*args)
    got = kernels.ccsd_t(*args)
    assert abs(float(got - ref)) <= 1e-12 * abs(float(ref))
    monkeypatch.setattr(kernels, 'CCSD_T_MAX_SMEM', 48 * no * (4 + no))
    got = kernels.ccsd_t(*args)
    assert abs(float(got - ref)) <= 1e-12 * abs(float(ref))


@pytest.mark.parametrize('df', [False, True])
def test_postscf_on_card_launches_its_kernels(water, df):
    """Water/cc-pVDZ MP2, CCSD and (T) on the card: in-core against
    PySCF's goldens (tests/test_postscf.py), DF against the recorded JAX
    energies, within 1e-8, with mp2_energy and ccsd_t launched."""
    kernels.reset_launches()
    mf = tpt.M(atom=refs.WATER, basis='cc-pvdz').RHF()
    if df:
        mf = mf.density_fit()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    e_mp2 = mf.MP2().kernel()[0]
    mycc = mf.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    e_cc = mycc.kernel()[0]
    e_t = mycc.ccsd_t()
    ref = ((refs.E_WATER_DF_MP2_CCPVDZ, refs.E_WATER_DF_CCSD_CCPVDZ,
            refs.E_WATER_DF_CCSD_T_CCPVDZ) if df else
           (-0.204019967288338, -0.213343234198275, -0.003060022611584471))
    assert mycc.converged
    assert np.max(np.abs(np.array([e_mp2, e_cc, e_t]) - ref)) < 1e-8
    launches = kernels.launches()
    assert launches['mp2_energy'] > 0 and launches['ccsd_t'] == 1


def _seeded_density(mol, nspin, seed):
    """A random closed-shell (nspin 1) or spin (nspin 2) density of five
    orbitals per spin on the card."""
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(rng.standard_normal((nspin, mol.nao, 5)) * 0.3,
                        device='cuda')
    return c @ c.transpose(1, 2)


@pytest.mark.parametrize('case', ['singlet', 'triplet', 'uks'])
def test_xc_fxc(water, water_grid, case):
    """The per-point response kernel on water's level-1 grid at a seeded
    density (some points masked) against xc_fxc_plain: 1e-10 x max|H|."""
    mol, _ = water
    f = xc.parse_xc('b3lypg')
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1)
    dm = _seeded_density(mol, 2 if case == 'uks' else 1, 31)
    dmao = torch.matmul(aod[0], dm)
    w = water_grid.weights
    got = kernels.xc_fxc(aod, dmao, w, f, case != 'triplet')
    ref = numint.xc_fxc_plain(aod, dmao, w, f, case != 'triplet')
    assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


def test_xc_fxc_pairs(water, water_grid):
    """P and H P of seeded orbital values against xc_fxc_pairs_plain, one
    and two H blocks: 1e-12 x max."""
    mol, _ = water
    f = xc.parse_xc('b3lypg')
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1)
    dmao = torch.matmul(aod[0], _seeded_density(mol, 2, 5))
    H = kernels.xc_fxc(aod, dmao, water_grid.weights, f)
    rng = np.random.default_rng(3)
    co, cv = (torch.as_tensor(rng.standard_normal((mol.nao, k)),
                              device='cuda') for k in (5, 19))
    oo, ov = torch.matmul(aod, co), torch.matmul(aod, cv)
    for blocks in ((0,), (1, 3)):
        got = kernels.xc_fxc_pairs(oo, ov, H, blocks)
        ref = numint.xc_fxc_pairs_plain(oo, ov, H, blocks)
        for g, r in zip(got, ref):
            assert torch.max(torch.abs(g - r)) <= 1e-12 * r.abs().max()


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
@pytest.mark.parametrize('spin', [1, 2])
def test_xc_fxc_tangents(water, water_grid, xc_code, spin):
    """xc_rks_fxc (spin 1) and xc_uks_fxc (spin 2) along three seeded
    symmetric transition densities against their torch.func.jvp twins:
    1e-10 x max."""
    mol, _ = water
    f = xc.parse_xc(xc_code)
    aod = eval_gto.eval_ao(mol, water_grid.coords, 1 if f.is_gga else 0)
    ao = aod[0] if f.is_gga else aod
    dm = _seeded_density(mol, spin, 11)
    rng = np.random.default_rng(13)
    t = torch.as_tensor(rng.standard_normal((3, spin, mol.nao, mol.nao)),
                        device='cuda')
    t = t + t.transpose(-1, -2)
    if spin == 1:
        dm, t = dm[0], t[:, 0]
        fn, plain = kernels.xc_rks_fxc, numint.xc_rks_fxc_plain
    else:
        fn, plain = kernels.xc_uks_fxc, numint.xc_uks_fxc_plain
    dmao, dmao1 = torch.matmul(ao, dm), torch.matmul(ao, t)
    w = water_grid.weights
    got, ref = fn(aod, dmao, dmao1, w, f), plain(aod, dmao, dmao1, w, f)
    assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


def test_xc_fxc_refuses_a_component_it_lacks(water, water_grid):
    """The response kernels take the B3LYP family only."""
    mol, _ = water
    f = xc.parse_xc('b97-1')
    aod = eval_gto.eval_ao(mol, water_grid.coords[:64], 1)
    dmao = aod[0].clone()[None]
    with pytest.raises(NotImplementedError, match='WB97'):
        kernels.xc_fxc(aod, dmao, water_grid.weights[:64], f)
    with pytest.raises(NotImplementedError, match='WB97'):
        kernels.xc_rks_fxc(aod, dmao[0], dmao, water_grid.weights[:64], f)


def test_tddft_on_card_launches_its_kernels(water):
    """Water DF-RKS b3lypg on the card: TDA by Davidson (dense_cutoff 0),
    singlet and triplet, launches xc_rks_fxc and xc_uks_fxc; TDDFT (dense)
    launches xc_fxc and xc_fxc_pairs; both within 1e-7 Ha of the dense
    TDA, and the TDDFT energies against the recorded JAX values (1e-8 Ha on
    the JAX orbitals)."""
    from pyscf_tpu_torch import compat
    ref = np.load(refs.TDSCF_WATER_REFS)
    mol = tpt.M(atom=refs.WATER, basis='def2-svp')
    mf = tpt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.grids.level = 1
    compat.mean_field_from_numpy(mf, ref['rks_mo_coeff'],
                                 ref['rks_mo_energy'], ref['rks_mo_occ'])
    for singlet in (True, False):
        kernels.reset_launches()
        td = mf.TDA()
        td.singlet = singlet
        td.dense_cutoff = 0
        e = td.kernel(nstates=5)
        launches = kernels.launches()
        assert launches['xc_rks_fxc' if singlet else 'xc_uks_fxc'] > 0
        assert td.converged
        assert np.max(np.abs(e - ref['rks_tda_s' if singlet
                                     else 'rks_tda_t'])) < 1e-7
    kernels.reset_launches()
    e = mf.TDDFT().kernel(nstates=5)
    launches = kernels.launches()
    assert launches['xc_fxc'] > 0 and launches['xc_fxc_pairs'] > 0
    assert np.max(np.abs(e - ref['rks_tdhf_s'])) < 1e-8


def test_hessian_kernels_match_their_twins(water):
    """int1e_ipip, int3c2e_ip1, int2c2e_ip1_full, int3c2e_ipip and
    int2c2e_ipip on water/def2-SVP's classes against their twins, the
    first two built as the Hessian builds them (hessian/rhf.py)."""
    from pyscf_tpu_torch.hessian import rhf as hess_rhf
    mol, auxmol = water
    aux = j3c.aux_tables(auxmol)
    rng = np.random.default_rng(5)
    zr = torch.as_tensor(mol.coords, device='cuda')
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device='cuda')
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        n = p[0].shape[0]
        D, W = (torch.as_tensor(rng.standard_normal(
            (n, (2 * la + 1) * (2 * lb + 1))), device='cuda')
            for _ in range(2))
        got = kernels.int1e_ipip(la, lb, *p, zr, zq, D, W)
        ref = int1e_deriv.class_ipip(la, lb, *p, zr, zq, D, W)
        assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()
    ip1, ip2 = hess_rhf._first_df(mol, auxmol)
    kernels_ip1 = kernels.int3c2e_ip1
    try:
        kernels.int3c2e_ip1 = j3c_deriv.int3c2e_ip1_plain
        ref1, _ = hess_rhf._first_df(mol, auxmol)
    finally:
        kernels.int3c2e_ip1 = kernels_ip1
    assert torch.max(torch.abs(ip1 - ref1)) <= 1e-10 * ref1.abs().max()
    ref2 = j3c_deriv.int2c2e_ip1_full_plain(aux)
    got2 = kernels.int2c2e_ip1_full(aux)
    assert torch.max(torch.abs(got2 - ref2)) <= 1e-10 * ref2.abs().max()
    naux = auxmol.nao
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        G = torch.as_tensor(rng.standard_normal(
            (p[0].shape[0] * (2 * la + 1) * (2 * lb + 1), naux)),
            device='cuda')
        got = kernels.int3c2e_ipip(la, lb, *p, aux, G)
        ref = j3c_deriv.int3c2e_ipip_plain(la, lb, *p, aux, G)
        assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()
    W = torch.as_tensor(rng.standard_normal((naux, naux)), device='cuda')
    W = W + W.T
    got, ref = kernels.int2c2e_ipip(aux, W), j3c_deriv.int2c2e_ipip_plain(
        aux, W)
    assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


def test_hessian_on_card_launches_its_kernels(water):
    """mf.Hessian().kernel() of water/def2-SVP DF-RHF on the card launches
    the five Hessian kernels and obeys the sum rule and symmetry."""
    mol, _ = water
    mf = mol.RHF().density_fit()
    mf.conv_tol = 1e-12
    mf.kernel()
    kernels.reset_launches()
    h = mf.Hessian().kernel()
    got = kernels.launches()
    for k in ('int1e_ipip', 'int3c2e_ip1', 'int2c2e_ip1_full',
              'int3c2e_ipip', 'int2c2e_ipip', 'int1e_ip', 'int1e_iprinv'):
        assert got[k] > 0
    hm = h.reshape(9, 9)
    assert np.abs(h.sum(axis=0)).max() < 1e-7 and np.abs(hm - hm.T).max() < 1e-9
