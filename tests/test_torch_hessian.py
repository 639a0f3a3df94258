"""The analytic DF-RHF nuclear Hessian of pyscf_tpu_torch on the CPU
against pyscf_tpu: the plain twins of the kernels int1e_ipip,
int3c2e_ipip, int2c2e_ipip, int3c2e_ip1 and int2c2e_ip1_full against
jax.jacfwd(jax.grad(...)) and jax.jacfwd of the JAX integral programs on
seeded inputs and water's shells (recorded: 10-50 s each live); the
Hessian on the JAX package's
orbitals against its Hessians recorded by tests/hessian_refs_record.py;
central differences of the port's analytic gradient; the nuclear term,
CPHF, harmonic analysis and thermochemistry; and the dispatcher.

The JAX package's DF-RHF Hessian keeps only the diagonal of the occupied
block of its energy-weighted density response (pyscf_tpu/hessian/rhf.py:
316-323); hessian/rhf.py hessian(..., reference_w=True) reproduces that
for the comparison with its recorded Hessians, and the default is the
gradient's derivative, which the central differences confirm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu import hessian as jax_hessian
from pyscf_tpu.grad.autodiff import _enuc as jax_enuc
from pyscf_tpu.hessian.rhf import _cphf_pcg as jax_cphf_pcg
from pyscf_tpu.scf import cphf as jax_cphf

import hessian_refs_record as rec
import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import hessian, refs
from pyscf_tpu_torch.hessian import rhf as hess_rhf
from pyscf_tpu_torch.ops.integrals import int1e_deriv, j3c_deriv
from pyscf_tpu_torch.scf import cphf

torch.set_num_threads(1)

H2 = 'H 0 0 0; H 0 0 0.74'


def _close(got, ref, rel):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


# ---- the nuclear term, CPHF -------------------------------------------------

def test_hess_nuc_matches_jax_hessian():
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu')
    X = jnp.asarray(mol.coords)
    ref = jax.hessian(jax_enuc)(X, jnp.asarray(mol.charges, dtype=float))
    _close(hess_rhf.hess_nuc(mol), ref, 1e-13)


def _seeded_system(n=14, T=3, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.05
    hdiag = rng.uniform(0.5, 2.0, n)
    return a @ a.T, hdiag, rng.standard_normal((T, n))


def test_cphf_solvers_match_jax():
    """scf/cphf.py solve and the Hessian's batched cphf_pcg against the
    JAX package's solve and _cphf_pcg on a seeded SPD system."""
    a, hdiag, rhs = _seeded_system()
    ref = jax_cphf.solve(lambda z: (hdiag * z + a @ z), hdiag, rhs)
    at, ht = torch.as_tensor(a), torch.as_tensor(hdiag)
    got = cphf.solve(lambda z: ht * z + at @ z, ht, torch.as_tensor(rhs))
    _close(got, ref, 1e-12)
    nv, no = 7, 2
    ediff = hdiag.reshape(nv, no)

    def mv(u, a, ediff):
        flat = u.reshape(nv * no, -1)
        return ediff[:, :, None] * u + (a @ flat).reshape(u.shape)

    aj, ej = jnp.asarray(a), jnp.asarray(ediff)
    x_ref, _ = jax_cphf_pcg(lambda u: mv(u, aj, ej), jnp.asarray(
        rhs.T.reshape(nv, no, -1)), ej, 40, 1e-12)
    et = torch.as_tensor(ediff)
    x, r, it = hess_rhf.cphf_pcg(lambda u: mv(u, at, et), torch.as_tensor(
        rhs.T.reshape(nv, no, -1)), et, 40, 1e-12)
    _close(x, x_ref, 1e-12)
    assert 0 < it < 40 and float(r.max()) <= 1e-12


# ---- the twins against the JAX programs' derivatives ------------------------

@pytest.fixture(scope='module')
def jax_twins():
    """The JAX derivatives recorded by tests/hessian_refs_record.py
    ('twins') and the inputs they were taken on."""
    return np.load(refs.HESSIAN_REFS), rec.twin_inputs()


@pytest.mark.parametrize('la,lb', rec.TWIN_1E)
def test_int1e_ipip_chunk_matches_jax(jax_twins, la, lb):
    """ipip_chunk (the twin of int1e_ipip per primitive pair) against
    jax.jacfwd(jax.grad(...)) of sum dm (T + V) - wm S over the JAX chunks,
    eight charges (two of them zero): AA per pair, AC per pair and charge,
    CC per charge; 1e-11 x max."""
    r, _ = jax_twins
    k = f'twin_1e_{la}{lb}'
    aa, ac, cc = (r[f'{k}_{x}'] for x in ('aa', 'ac', 'cc'))
    t = [torch.as_tensor(x) for x in rec.prims_1e(la, lb)]
    out = int1e_deriv.ipip_chunk(la, lb, *t).numpy()        # (m, 9, 27)
    m = out.shape[0]
    idx = np.arange(m)
    got_aa = (out[:, 8, :9] + out[:, :8, :9].sum(axis=1)).reshape(m, 3, 3)
    _close(got_aa, aa[idx, :, idx, :], 1e-11)
    _close(out[:, :8, 9:18].reshape(m, 8, 3, 3),
           ac.transpose(0, 2, 1, 3), 1e-11)
    c8 = np.arange(8)
    _close(out[:, :8, 18:].sum(axis=0).reshape(8, 3, 3),
           cc[c8, :, c8, :], 1e-11)


def _torch(tables):
    return [torch.as_tensor(t) for t in tables]


@pytest.mark.parametrize('la,lb,lc', rec.TWIN_3C)
def test_int3c2e_twins_match_jax(jax_twins, la, lb, lc):
    """int3c2e_ip1_rows and int3c2e_ipip_plain on two two-centre pairs of
    a class and the shells of an aux class of water/def2-SVP against
    jax.jacfwd and jax.jacfwd(jax.grad(...)) of the block and of sum G
    (ij|P) through _eri_core: d/dA per pair; AA, AB and BB per pair and
    the aux centre's CC per aux shell from translational invariance;
    1e-10 x max."""
    r, inputs = jax_twins
    key = f'twin_3c_{la}{lb}{lc}'
    pairs, ax, G = inputs[key]
    n, nsx = pairs[0].shape[0], ax[1].shape[0]
    i, p = np.arange(n), np.arange(nsx)
    aux = [(lc,) + tuple(_torch(ax[1:]))]
    ip1 = r[f'{key}_ip1'][i, :, :, :, :, i, :]       # (n, da, db, P, dc, 3)
    got = j3c_deriv.int3c2e_ip1_rows(la, lb, *_torch(pairs), aux).numpy()
    _close(got, np.moveaxis(ip1, -1, 0).reshape(got.shape), 1e-10)
    if la > lb:
        return
    got = j3c_deriv.int3c2e_ipip_plain(
        la, lb, *_torch(pairs), aux, torch.as_tensor(G.reshape(
            G.shape[0] * G.shape[1] * G.shape[2], -1))).numpy()
    got = got.reshape(n, nsx, 3, 3, 3)
    for k, name in enumerate(('aa', 'ab', 'bb')):
        _close(got[:, :, k].sum(axis=1), r[f'{key}_{name}'][i, :, i, :],
               1e-10)
    aa, ab, bb = got[:, :, 0], got[:, :, 1], got[:, :, 2]
    cc = (aa + ab + ab.transpose(0, 1, 3, 2) + bb).sum(axis=0)
    _close(cc, r[f'{key}_cc'][p, :, p, :], 1e-10)


@pytest.mark.parametrize('lx,ly', rec.TWIN_2C)
def test_int2c2e_twins_match_jax(jax_twins, lx, ly):
    """int2c2e_ip1_full_plain and int2c2e_ipip_plain on the shells of two
    aux classes of water/def2-SVP against jax.jacfwd and
    jax.jacfwd(jax.grad(...)) of the metric's block through _eri_core;
    1e-10 x max."""
    r, inputs = jax_twins
    key = f'twin_2c_{lx}{ly}'
    ax, ay, W = inputs[key]
    nx, ny = ax[1].shape[0], ay[1].shape[0]
    dx, dy = 2 * lx + 1, 2 * ly + 1
    p = np.arange(nx)
    aux = [(lx,) + tuple(_torch(ax[1:])), (ly,) + tuple(_torch(ay[1:]))]
    ref = r[f'{key}_ip1'][p, :, :, :, p, :]         # (P, dx, Q, dy, 3)
    full = j3c_deriv.int2c2e_ip1_full_plain(aux).numpy()
    got = full[:, :nx * dx, nx * dx:].reshape(3, nx, dx, ny, dy)
    _close(got, np.moveaxis(ref, -1, 0), 1e-10)
    Wfull = np.zeros((nx * dx + ny * dy,) * 2)
    Wfull[:nx * dx, nx * dx:] = W.reshape(nx * dx, ny * dy)
    pp = j3c_deriv.int2c2e_ipip_plain(aux, torch.as_tensor(Wfull)).numpy()
    _close(pp[:nx, nx:].sum(axis=1).reshape(nx, 3, 3),
           r[f'{key}_pp'][p, :, p, :], 1e-10)


# ---- the Hessian ------------------------------------------------------------

def _port_on_jax_orbitals(case, atom, basis):
    """The port's DF-RHF on the recorded JAX orbitals of `case`."""
    r = np.load(refs.HESSIAN_REFS)
    mf = tpt.M(atom=atom, basis=basis, device='cpu').RHF().density_fit()
    for k in ('mo_coeff', 'mo_energy', 'mo_occ'):
        setattr(mf, k, torch.as_tensor(r[f'{case}_{k}']))
    mf.e_tot = float(r[f'{case}_e_tot'])
    mf.converged = True
    return mf, r[f'{case}_hess']


def _sum_rule_and_symmetry(h):
    n = h.shape[0]
    hm = h.reshape(3 * n, 3 * n)
    return np.abs(h.sum(axis=0)).max(), np.abs(hm - hm.T).max()


def test_h2_hessian_on_jax_orbitals():
    """H2/sto-3g (tests/test_hessian.py:16): the port's analytic Hessian on
    the JAX run's orbitals within 1e-7 Ha/Bohr^2 of its recorded Hessian
    (one occupied orbital: the W response's occupied block is its
    diagonal); sum rule 1e-7 and symmetry 1e-9 as the JAX test asks."""
    mf, ref = _port_on_jax_orbitals('h2', H2, 'sto-3g')
    hobj = mf.Hessian()
    assert isinstance(hobj, hess_rhf.Hessian)
    h = hobj.kernel()
    assert h.shape == (2, 3, 2, 3)
    assert np.max(np.abs(h - ref)) < 1e-7
    drift, asym = _sum_rule_and_symmetry(h)
    assert drift < 1e-7 and asym < 1e-9
    assert set(hobj.timings) == {'s1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e',
                                 'rows_df', 'rows_3c', 'rows_2c'}


@pytest.fixture(scope='module')
def water_hessians():
    """(mean field on the JAX orbitals, the recorded JAX Hessian, the
    port's Hessian in the reference's W response, the port's own)."""
    mf, ref = _port_on_jax_orbitals('water_sto3g', refs.WATER, 'sto-3g')
    h_ref_w = hess_rhf.hessian(mf, reference_w=True)[0]
    return mf, ref, h_ref_w, hess_rhf.Hessian(mf).kernel()


def test_water_hessian_on_jax_orbitals(water_hessians):
    """Water/sto-3g: with the reference's W response, within 1e-7
    Ha/Bohr^2 of the JAX package's recorded Hessian on the same orbitals;
    both forms obey the sum rule and are symmetric."""
    _, ref, h_ref_w, h = water_hessians
    assert np.max(np.abs(h_ref_w - ref)) < 1e-7
    for x in (h_ref_w, h):
        drift, asym = _sum_rule_and_symmetry(x)
        assert drift < 1e-7 and asym < 1e-9


def test_water_hessian_matches_central_differences(water_hessians):
    """The port's own Hessian against central differences (step 1e-3
    Bohr) of the port's analytic gradient, conv_tol 1e-12 and
    conv_tol_grad 1e-9, on two coordinates: 1e-5 Ha/Bohr^2, the
    reference's gate (tests/test_hessian.py:39); the reference's W
    response misses them by more than 1e-2."""
    mf, _, h_ref_w, h = water_hessians

    def grad(m):
        f = m.RHF().density_fit()
        f.conv_tol, f.conv_tol_grad = 1e-12, 1e-9
        f.kernel()
        return f.Gradients().kernel()

    c0 = np.asarray(mf.mol.coords)
    for a, x in ((0, 2), (1, 1)):
        g = []
        for s in (1e-3, -1e-3):
            c = c0.copy()
            c[a, x] += s
            g.append(grad(mf.mol.copy().set_geom_(c)))
        fd = (g[0] - g[1]) / 2e-3
        assert np.max(np.abs(h[a, x] - fd)) < 1e-5
        assert np.max(np.abs(h_ref_w[a, x] - fd)) > 1e-2


def test_hessian_fd_matches_analytic_on_h2():
    """HessianFD (central differences of the port's analytic gradient)
    against the analytic Hessian of H2/sto-3g: 1e-5 Ha/Bohr^2."""
    mf = tpt.M(atom=H2, basis='sto-3g', device='cpu').RHF().density_fit()
    mf.conv_tol = 1e-12
    mf.kernel()
    h = mf.Hessian().kernel()
    fd = hessian.HessianFD(mf).kernel()
    assert fd.shape == h.shape == (2, 3, 2, 3)
    assert np.max(np.abs(h - fd)) < 1e-5


def test_harmonic_analysis_and_thermo_match_jax():
    """harmonic_analysis and thermo on the recorded JAX water Hessian
    against the JAX package's functions: 1e-8."""
    r = np.load(refs.HESSIAN_REFS)
    h = r['water_sto3g_hess']
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu')
    jmol = jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0)
    got = hessian.harmonic_analysis(mol, h)
    ref = jax_hessian.harmonic_analysis(jmol, h)
    for k in ('freq_wavenumber', 'freq_au'):
        assert np.max(np.abs(got[k] - ref[k])) < 1e-8
    assert np.max(np.abs(np.abs(got['norm_mode'])
                         - np.abs(ref['norm_mode']))) < 1e-8
    e = float(r['water_sto3g_e_tot'])
    t_got = hessian.thermo(mol, got['freq_au'], e)
    t_ref = jax_hessian.thermo(jmol, ref['freq_au'], e)
    assert set(t_got) == set(t_ref)
    for k in t_ref:
        assert abs(t_got[k] - t_ref[k]) < 1e-8


# ---- the dispatcher ---------------------------------------------------------

def _unconverged(kind, **kw):
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu', **kw)
    mf = getattr(mol, kind)(**({'xc': 'b3lypg'} if 'KS' in kind else {}))
    mf.mo_occ = torch.zeros((2, 7) if kind[0] == 'U' else 7,
                            dtype=torch.float64)
    return mf


@pytest.mark.parametrize('kind,spin', [('RKS', 0), ('UHF', 1), ('UKS', 1)])
def test_df_rks_uhf_uks_raise(kind, spin):
    """DF-RKS goes to the analytic Hessian of hessian/rhf.py, DF-UHF and
    DF-UKS to that of hessian/uhf.py (as pyscf_tpu/hessian/__init__.py:
    79-95), never to a finite-difference Hessian; each class raises for
    the other kind of mean field."""
    from pyscf_tpu_torch.hessian import uhf as hess_uhf
    mf = _unconverged(kind, charge=spin, spin=spin).density_fit()
    if kind == 'RKS':
        assert isinstance(mf.Hessian(), hess_rhf.Hessian)
        assert not isinstance(mf.Hessian(), hess_uhf.Hessian)
        with pytest.raises(NotImplementedError, match='unrestricted'):
            hess_uhf.Hessian(mf)
        return
    assert isinstance(mf.Hessian(), hess_uhf.Hessian)
    with pytest.raises(NotImplementedError, match='restricted'):
        hess_rhf.Hessian(mf)


def test_fd_where_the_reference_uses_it():
    """Without density fitting, and for a range-separated functional, the
    reference's dispatcher falls back to HessianFD; so does the port's."""
    mf = _unconverged('RHF')
    assert isinstance(mf.Hessian(), hessian.HessianFD)
    mf = _unconverged('RKS').density_fit()
    mf.xc = 'wb97x-v'
    assert isinstance(mf.Hessian(), hessian.HessianFD)
    mf = _unconverged('RHF').density_fit()
    assert isinstance(mf.Hessian(), hess_rhf.Hessian)
