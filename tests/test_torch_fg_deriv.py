"""f, g and aux h shells in the derivative and Hessian integrals:
pyscf_tpu_torch (the plain twins of int1e_ip, int1e_iprinv, int3c2e_ip,
int2c2e_ip1, int2e_ip1 and the Hessian's int1e_ipip, int3c2e_ip1,
int2c2e_ip1_full, int3c2e_ipip and int2c2e_ipip, on the CPU) against
pyscf_tpu.

The water/cc-pVTZ DF-RHF and water/def2-TZVP DF-RKS gradients (f on O)
are held to the JAX package's, recorded once in pyscf_tpu_torch/refs.py
(tests/port_refs_record.py fg_grad_tz_refs and fg_grad_tzvp_refs: the JAX
gradient takes minutes on the CPU); the f rows (the (f, s) 1e chunks and
Hessian rows, the (ff|s) DF functionals and the (fs|sf) derivative
block) and the g rows (the (g, f)
1e chunks, jax.grad of the DF functionals at (gg|h), the (gg|gg)
derivative block, and the Hessian twins' JAX derivatives at (g, f),
(fg|h) and (h|s)) are read from port_refs.npz and hessian_water_refs.npz
(tests/port_refs_record.py fg_f_refs and fg_grad_refs,
tests/hessian_refs_record.py twins_fg; the f tests keep the names they
had when they ran JAX live); each module's live comparison with the JAX
package is at s to d (test_torch_int_deriv.py, test_torch_grad_df.py,
test_torch_hessian.py). The HF/cc-pVTZ Hessian (f on F) is checked
against central differences of the port's own analytic gradient."""
import numpy as np
import pytest
import torch

from pyscf_tpu.ops.integrals.cart2sph import cart2sph as jax_cart2sph

import hessian_refs_record as rec
import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.ops.integrals import (int1e, int1e_deriv, int2e,
                                           j3c_deriv)

torch.set_num_threads(1)

# one f class on two centres off the origin: an f shell on O, an s shell
# on H; an aux basis of one s shell on each
F_ATOMS = 'O 0.1 0.2 -0.3; H 0.3 -0.7 0.6'
F_BASIS = {'O': [[3, [0.7, 1.0]]], 'H': [[0, [1.2, 1.0]]]}
F_AUX = {'O': [[0, [1.0, 1.0]]], 'H': [[0, [1.4, 1.0]]]}
HF = 'H 0 0 0; F 0 0 0.917'


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _prims(seed, m=6):
    """tests/test_torch_int_deriv.py's seeded primitive pairs."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, m), rng.uniform(0.3, 3.0, m),
            rng.normal(size=(m, 3)), rng.normal(size=(m, 3)),
            rng.normal(size=m))


@pytest.fixture(scope='module')
def recorded():
    return np.load(refs.PORT_REFS)


@pytest.mark.parametrize('basis, xc, e_ref, g_ref', [
    ('cc-pvtz', None, refs.E_WATER_DF_RHF_CCPVTZ,
     refs.GRAD_WATER_DF_RHF_CCPVTZ),
    ('def2-tzvp', 'b3lypg', refs.E_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1,
     refs.GRAD_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1)],
    ids=['rhf-cc-pvtz', 'rks-def2-tzvp'])
def test_water_df_gradient_matches_jax(basis, xc, e_ref, g_ref):
    """Water DF-RHF/cc-pVTZ and DF-RKS b3lypg/def2-TZVP (grids level 1,
    held fixed) forces within 1e-8 Ha/Bohr of the JAX gradients (minao,
    conv_tol 1e-11, conv_tol_grad 1e-7 here; the references at 1e-12 and
    1e-9); the DF-RHF sum rule within 1e-9."""
    mol = tpt.M(atom=refs.WATER, basis=basis, device='cpu')
    assert max(mol.shell_groups) == 3
    mf = (mol.RKS(xc=xc) if xc else mol.RHF()).density_fit()
    if xc:
        mf.grids.level = 1
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.kernel()
    assert mf.converged and abs(mf.e_tot - e_ref) < 1e-8
    de = mf.nuc_grad_method().kernel()
    assert np.max(np.abs(de - np.array(g_ref))) < 1e-8
    if xc is None:
        assert np.max(np.abs(de.sum(axis=0))) < 1e-9


def test_int1e_chunks_at_f_match_live_jax(recorded):
    """ipovlp, ipkin, ipnuc and iprinv of the (f, s) class over seeded
    primitive pairs against the JAX chunks (recorded): 1e-12 x max."""
    a, b, A, B, w = _prims(31, m=3)
    rng = np.random.default_rng(99)
    zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)
    t = [torch.as_tensor(x) for x in (a, b, A, B, w)]
    zt, qt = torch.as_tensor(zr), torch.as_tensor(zq)
    k = 'fg_chunk_30'
    _close(int1e_deriv.ipovlp_chunk(3, 0, *t), recorded[f'{k}_ipovlp'],
           1e-12)
    _close(int1e_deriv.ipkin_chunk(3, 0, *t), recorded[f'{k}_ipkin'], 1e-12)
    _close(int1e_deriv.ipnuc_chunk(3, 0, *t, zt, qt), recorded[f'{k}_ipnuc'],
           1e-12)
    _close(int1e_deriv.iprinv_chunk(3, 0, *t, zt[3]),
           recorded[f'{k}_iprinv'], 1e-12)


def test_int1e_chunks_at_g_match_jax(recorded):
    """The same four chunks of the (g, f) class (recorded)."""
    a, b, A, B, w = _prims(43)
    rng = np.random.default_rng(99)
    zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)
    t = [torch.as_tensor(x) for x in (a, b, A, B, w)]
    k = 'fg_chunk_43'
    _close(int1e_deriv.ipovlp_chunk(4, 3, *t), recorded[f'{k}_ipovlp'],
           1e-12)
    _close(int1e_deriv.ipkin_chunk(4, 3, *t), recorded[f'{k}_ipkin'], 1e-12)
    _close(int1e_deriv.ipnuc_chunk(4, 3, *t, torch.as_tensor(zr),
                                   torch.as_tensor(zq)),
           recorded[f'{k}_ipnuc'], 1e-12)
    _close(int1e_deriv.iprinv_chunk(4, 3, *t, torch.as_tensor(zr[3])),
           recorded[f'{k}_iprinv'], 1e-12)


def _seeded_df(nao, naux, seed=11):
    """tests/port_refs_record.py fg_df_functionals's seeded densities."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((nao, 3)) * 0.3
    D = 2 * C @ C.T
    a = rng.standard_normal(naux)
    b = rng.standard_normal((naux, 3, 3))
    b = b + b.transpose(0, 2, 1)
    W = rng.standard_normal((naux, naux))
    return D, C, a, b, W + W.T


def _port_df(atoms, basis, aux, seed=11):
    mol = tpt.M(atom=atoms, basis=basis, device='cpu')
    auxmol = tpt.M(atom=atoms, basis=aux, device='cpu')
    D, C, a, b, W = _seeded_df(mol.nao, auxmol.nao, seed)
    gamma = torch.as_tensor(a[:, None, None] * D + C @ b @ C.T)
    return (j3c_deriv.grad_3c(mol, auxmol, gamma).numpy(),
            j3c_deriv.grad_2c(auxmol, torch.as_tensor(W)).numpy())


def test_df_derivatives_at_f_match_live_jax(recorded):
    """The twins of int3c2e_ip and int2c2e_ip1 with their sums by atom on
    an (ff|s), (fs|s), (ss|s) system against jax.grad of
    autodiff._df_intermediates and _j2c (recorded): 1e-10 x max."""
    got3, got2 = _port_df(F_ATOMS, F_BASIS, F_AUX)
    _close(got3, recorded['fg_df_f_3c'], 1e-10)
    _close(got2, recorded['fg_df_f_2c'], 1e-10)


def test_df_derivatives_at_g_match_jax(recorded):
    """The same on FG_BASIS (g and s on O, f on H) with FG_AUX (h and s),
    whose classes reach (gg|h), (gf|s) and (h|h) (recorded)."""
    got3, got2 = _port_df(rec.FG_ATOMS, rec.FG_BASIS, rec.FG_AUX)
    _close(got3, recorded['fg_df_3c'], 1e-10)
    _close(got2, recorded['fg_df_2c'], 1e-10)


def _all_pairs(mol, la, lb):
    ga, gb = mol.shell_groups[la], mol.shell_groups[lb]
    sel_a = np.repeat(np.arange(ga.nshl), gb.nshl)
    sel_b = np.tile(np.arange(gb.nshl), ga.nshl)
    return int1e.pair_tables(ga, gb, sel_a, sel_b)


def _ip1_class(atom, basis, bra, ket, blk):
    """int2e_ip1_class_plain of one (bra | ket) class on two centres against
    a JAX cartesian block of _deriv_class_pair_block, taken to sph by the
    JAX package's cart2sph."""
    (la, lb), (lc, ld) = bra, ket
    mol = tpt.M(atom=atom, basis=basis, device='cpu')
    nca, ncb, ncc, ncd = [(l + 1) * (l + 2) // 2 for l in (la, lb, lc, ld)]
    blk = np.asarray(blk).reshape(2, 2, 3, nca, ncb, 2, 2, ncc, ncd)
    ref = np.einsum('mp,nq,abxpqcdrs,kr,ls->xabmncdkl', jax_cart2sph(la),
                    jax_cart2sph(lb), blk, jax_cart2sph(lc),
                    jax_cart2sph(ld), optimize=True)
    got = int2e.int2e_ip1_class_plain(la, lb, *_all_pairs(mol, la, lb),
                                      [(lc, ld, *_all_pairs(mol, lc, ld))])
    _close(got.numpy(), ref.reshape(got.shape), 1e-12)


TOY_ATOM = 'He 0 0 0; He 0.3 -0.4 1.1'


def test_int2e_ip1_at_f_matches_live_jax(recorded):
    """The (fs|sf) class of the int2e_ip1 twin against the JAX package's
    DerivPairClass block (recorded)."""
    _ip1_class(TOY_ATOM, [[3, [0.7, 1.0]], [0, [1.3, 1.0]]], (3, 0), (0, 3),
               recorded['fg_ip1_fssf'])


def test_int2e_ip1_at_g_matches_jax(recorded):
    """The (gs|sg) class of the int2e_ip1 twin against the recorded JAX
    block (tests/port_refs_record.py fg_ip1_refs)."""
    _ip1_class(TOY_ATOM, [[4, [0.6, 1.0]], [0, [1.3, 1.0]]], (4, 0), (0, 4),
               recorded['fg_ip1_gssg'])


def test_hessian_1e_rows_at_f_match_live_jax(recorded):
    """ipip_chunk (the twin of int1e_ipip) of the (f, s) class against
    jax.jacfwd(jax.grad(...)) in the bra centre of sum dm (T + V) - wm S
    over the JAX chunks (recorded): AA per pair, 1e-11 x max."""
    la, lb = 3, 0
    a, b, A, B, w, zr, zq, dm, wm = rec.prims_1e(la, lb, m=3)
    out = int1e_deriv.ipip_chunk(la, lb, *[torch.as_tensor(x) for x in (
        a, b, A, B, w, zr, zq, dm, wm)]).numpy()
    m = out.shape[0]
    got = (out[:, 8, :9] + out[:, :8, :9].sum(axis=1)).reshape(m, 3, 3)
    _close(got, recorded['fg_ipip_30'], 1e-11)


@pytest.fixture(scope='module')
def fg_twins():
    return np.load(refs.HESSIAN_REFS), rec.twin_inputs(fg=True)


def test_hessian_twins_at_g_match_jax(fg_twins):
    """The Hessian twins at g and aux h (recorded by
    tests/hessian_refs_record.py twins_fg): ipip_chunk of the (g, f) class,
    int3c2e_ip1_rows and int3c2e_ipip_plain of the (fg|h) class and
    int2c2e_ip1_full_plain and int2c2e_ipip_plain of (h|s), as
    tests/test_torch_hessian.py checks them to d."""
    r, inputs = fg_twins
    (la, lb), = rec.TWIN_1E_FG
    k = f'twin_1e_{la}{lb}'
    out = int1e_deriv.ipip_chunk(la, lb, *[torch.as_tensor(x) for x in
                                           rec.prims_1e(la, lb)]).numpy()
    m = out.shape[0]
    idx, c8 = np.arange(m), np.arange(8)
    _close((out[:, 8, :9] + out[:, :8, :9].sum(axis=1)).reshape(m, 3, 3),
           r[f'{k}_aa'][idx, :, idx, :], 1e-11)
    _close(out[:, :8, 9:18].reshape(m, 8, 3, 3),
           r[f'{k}_ac'].transpose(0, 2, 1, 3), 1e-11)
    _close(out[:, :8, 18:].sum(axis=0).reshape(8, 3, 3),
           r[f'{k}_cc'][c8, :, c8, :], 1e-11)

    (la, lb, lc), = rec.TWIN_3C_FG
    key = f'twin_3c_{la}{lb}{lc}'
    pairs, ax, G = inputs[key]
    n, nsx = pairs[0].shape[0], ax[1].shape[0]
    i, p = np.arange(n), np.arange(nsx)
    aux = [(lc,) + tuple(torch.as_tensor(t) for t in ax[1:])]
    tp = [torch.as_tensor(t) for t in pairs]
    ip1 = r[f'{key}_ip1'][i, :, :, :, :, i, :]
    got = j3c_deriv.int3c2e_ip1_rows(la, lb, *tp, aux).numpy()
    _close(got, np.moveaxis(ip1, -1, 0).reshape(got.shape), 1e-10)
    got = j3c_deriv.int3c2e_ipip_plain(la, lb, *tp, aux, torch.as_tensor(
        G.reshape(G.shape[0] * G.shape[1] * G.shape[2], -1))).numpy()
    got = got.reshape(n, nsx, 3, 3, 3)
    for k, name in enumerate(('aa', 'ab', 'bb')):
        _close(got[:, :, k].sum(axis=1), r[f'{key}_{name}'][i, :, i, :],
               1e-10)
    aa, ab, bb = got[:, :, 0], got[:, :, 1], got[:, :, 2]
    _close((aa + ab + ab.transpose(0, 1, 3, 2) + bb).sum(axis=0),
           r[f'{key}_cc'][p, :, p, :], 1e-10)

    (lx, ly), = rec.TWIN_2C_FG
    key = f'twin_2c_{lx}{ly}'
    ax, ay, W = inputs[key]
    nx, ny = ax[1].shape[0], ay[1].shape[0]
    dx, dy = 2 * lx + 1, 2 * ly + 1
    p = np.arange(nx)
    aux = [(lx,) + tuple(torch.as_tensor(t) for t in ax[1:]),
           (ly,) + tuple(torch.as_tensor(t) for t in ay[1:])]
    full = j3c_deriv.int2c2e_ip1_full_plain(aux).numpy()
    got = full[:, :nx * dx, nx * dx:].reshape(3, nx, dx, ny, dy)
    _close(got, np.moveaxis(r[f'{key}_ip1'][p, :, :, :, p, :], -1, 0),
           1e-10)
    Wfull = np.zeros((nx * dx + ny * dy,) * 2)
    Wfull[:nx * dx, nx * dx:] = W.reshape(nx * dx, ny * dy)
    pp = j3c_deriv.int2c2e_ipip_plain(aux, torch.as_tensor(Wfull)).numpy()
    _close(pp[:nx, nx:].sum(axis=1).reshape(nx, 3, 3),
           r[f'{key}_pp'][p, :, p, :], 1e-10)


def _hf_tz(conv_tol_grad, mol=None):
    if mol is None:
        mol = tpt.M(atom=HF, basis='cc-pvtz', device='cpu')
    mf = mol.RHF().density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = conv_tol_grad
    mf.kernel()
    assert mf.converged
    return mf


def test_hf_tz_hessian_matches_central_differences():
    """HF/cc-pVTZ (f on F; nao 44) DF-RHF Hessian: the bond's column
    against central differences (step 1e-3 Bohr) of the analytic gradient
    within 1e-5 Ha/Bohr^2, the sum rule within 1e-7 and the symmetry
    within 1e-9."""
    mf = _hf_tz(1e-8)
    assert max(mf.mol.shell_groups) == 3
    h = mf.Hessian().kernel()
    hm = h.reshape(6, 6)
    assert np.abs(h.sum(axis=0)).max() < 1e-7
    assert np.abs(hm - hm.T).max() < 1e-9
    g = []
    for step in (1e-3, -1e-3):
        c = np.asarray(mf.mol.coords).copy()
        c[1, 2] += step
        g.append(_hf_tz(1e-9, mf.mol.copy().set_geom_(c))
                 .nuc_grad_method().kernel())
    assert np.abs(h[1, 2] - (g[0] - g[1]) / 2e-3).max() < 1e-5
