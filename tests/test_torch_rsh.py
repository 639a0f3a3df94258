"""Range-separated hybrids in pyscf_tpu_torch on the CPU against pyscf_tpu:
the attenuation, CAM-B88 and wB97 energy densities and their derivatives
(torch autograd and the dual numbers of csrc/xc_funcs.cuh built for the host
with g++) against jax.grad (live for the attenuation, the rest and nr_uks
as tests/port_refs_record.py rsh_refs recorded them), the erf(omega r)/r
integrals (3c rows, the metric, the long-range factor, the in-core
tensor) against the JAX
package's engines (as tests/port_refs_record.py recorded them), the He
wB97 golden, the water energies of CAM-B3LYP and
wB97X-V against the recorded JAX runs, and the gradients that raise."""
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu.dft import gen_grid as jax_gen_grid
from pyscf_tpu.dft import numint as jax_numint
from pyscf_tpu.dft import xc as jax_xc
from pyscf_tpu.dft import xc_funcs as jax_F

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.dft import gen_grid, numint, xc
from pyscf_tpu_torch.dft import xc_funcs as F
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import j2e, j3c

torch.set_num_threads(1)

OMEGA = 0.3
GOLDEN_HE_WB97 = -2.89430888240579     # tests/test_ks_variants.py:31-36


# ---- the energy densities -------------------------------------------------

def _attenuation_inputs():
    """a log-uniform in [1e-12, 1e3] and the clamp edges: the clip at 1e-10
    and 50, and the exponent clamp 1/(4a^2) = 700 (a = 1/sqrt(2800))."""
    rng = np.random.default_rng(41)
    a = 10.0 ** rng.uniform(-12, 3, 300)
    edges = [1e-10, 50.0, 1e-10 * (1 + 1e-12), 50.0 * (1 - 1e-12),
             1.0 / np.sqrt(2800.0), 1.0 / np.sqrt(2800.0) * (1 + 1e-9)]
    return np.concatenate([a, edges])


def test_sr_attenuation_matches_jax():
    """F(a) and dF/da. F is a difference of terms of size (8/3) a (sqrt(pi)
    erf + 3a + 4a^3 + ...) that leaves ~1e-5 at large a: both sides keep
    the same operation order, and the limit is 1e-14 of those terms (erf
    and exp round apart by an ulp in the two libraries)."""
    a = _attenuation_inputs()
    aj = jnp.asarray(a)
    fj = np.asarray(jax_F._sr_attenuation(aj))
    dj = np.asarray(jax.grad(lambda x: jnp.sum(jax_F._sr_attenuation(x)))(aj))
    at = torch.as_tensor(a).requires_grad_()
    ft = F._sr_attenuation(at)
    dt, = torch.autograd.grad(ft.sum(), at)
    ac = np.clip(a, 1e-10, 50.0)
    terms = (8.0 / 3.0) * ac * (np.sqrt(np.pi) + 3 * ac + 8 * ac ** 3)
    assert np.all(np.abs(ft.detach().numpy() - fj)
                  <= 1e-12 * np.abs(fj) + 1e-14 * terms)
    assert np.all(np.abs(dt.numpy() - dj)
                  <= 1e-9 * np.abs(dj) + 1e-14 * terms / ac)
    below = a < 1e-10                           # under the clip
    assert np.all(dt.numpy()[below] == 0.0) and np.all(dj[below] == 0.0)


def _open_inputs():
    """rho_s in [1e-10, 1e2], sigma_ss in [1e-20, 1e3], log-uniform,
    sigma_ab with |sigma_ab| <= sqrt(sigma_aa sigma_bb), and points where
    one spin sits at or under RHO_THR/2 (the Stoll partition's
    pw92_eps(rho_s, TINY) at its smallest)."""
    rng = np.random.default_rng(43)
    n = 300
    ra, rb = 10.0 ** rng.uniform(-10, 2, (2, n))
    saa, sbb = 10.0 ** rng.uniform(-20, 3, (2, n))
    sab = rng.uniform(-1, 1, n) * np.sqrt(saa * sbb)
    x = np.stack([ra, rb, saa, sab, sbb])
    small = 0.5 * numint.RHO_THR
    edge = np.array([[small, 2e-3, numint.SIGMA_FLOOR, 0.0, 4e-2],
                     [2e-11, 3e-1, 1e-20, 1e-12, 1e-1],
                     [4e-2, small, 1e-3, 0.0, numint.SIGMA_FLOOR]]).T
    return np.concatenate([x, edge], axis=1)


RSH_NAMES = ['wb97x-v', 'wb97', 'wb97x', 'b97-1', 'b97d', 'camb3lyp']


def _jax_open(name, x):
    """(e, [five derivatives]) of the JAX package's open-shell energy
    density at x (tests/port_refs_record.py rsh_refs records them)."""
    fj = jax_xc.parse_xc(name)
    args = [jnp.asarray(v) for v in x]
    e = np.asarray(fj.exc_density(*args))
    grads = jax.grad(lambda *a: jnp.sum(fj.exc_density(*a)),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return e, [np.asarray(g) for g in grads]


def _closed_inputs():
    """rho in [1e-10, 1e2] and sigma in [1e-20, 1e3], log-uniform."""
    rng = np.random.default_rng(47)
    return np.stack([10.0 ** rng.uniform(-10, 2, 300),
                     10.0 ** rng.uniform(-20, 3, 300)])


def _jax_closed(name, x):
    """[e, vrho, vsigma] of the JAX package's closed-shell energy density
    as pyscf_tpu/dft/numint.py takes it (rsh_refs records them)."""
    fj = jax_xc.parse_xc(name)

    def edens(r, s):
        return fj.exc_density(0.5 * r, 0.5 * r, 0.25 * s, 0.25 * s, 0.25 * s)

    r, s = jnp.asarray(x[0]), jnp.asarray(x[1])
    vr, vs = jax.grad(lambda a, b: jnp.sum(edens(a, b)), argnums=(0, 1))(r, s)
    return [np.asarray(edens(r, s)), np.asarray(vr), np.asarray(vs)]


@pytest.fixture(scope='module')
def recorded():
    """The JAX values that tests/port_refs_record.py rsh_refs recorded
    (each took seconds of JAX's eager dispatch): 'rsh_open_<name>' (e and
    the five derivatives at _open_inputs), 'rsh_closed_<name>' (e, vrho,
    vsigma at _closed_inputs) and nr_uks's 'rsh_nr_uks_{n,e,v}'."""
    return np.load(refs.PORT_REFS)


def _recorded_open(recorded, name):
    r = recorded[f'rsh_open_{name}']
    return r[0], list(r[1:])


def _attenuation_scale(name, ra, rb, saa, sbb):
    """sum_s rho_s^(4/3) g_s T(a_s), T(a) = (8/3) a (sqrt(pi) + 3a + 8a^3):
    the size of the terms that the attenuation F(a_s) cancels down to ~1e-5
    at large a_s (low density), times the exchange energy density that F
    scales, so that the energy density rounds at an ulp of this. a_s is
    wB97's omega / (2 kF_s), kF_s = (6 pi^2 rho_s)^(1/3) (g_s = 1), or
    CAM-B88's omega / (2 k_s) with k_s from B88's K_s (g_s = K_s / 2, which
    reaches 1e3 at large reduced gradients), clipped to [1e-10, 50] as F
    clips it."""
    f = xc.parse_xc(name)
    cam = f.terms[0][2] == 'CAM_B88'
    out = 0.0
    for r, s in ((ra, saa), (rb, sbb)):
        if cam:
            y = np.sqrt(np.maximum(s, 1e-30)) / r ** (4 / 3)
            K = 2 * 0.9305257363491002 + 2 * 0.0042 * y * y / (
                1 + 6 * 0.0042 * y * np.arcsinh(y))
            k = np.sqrt(9 * np.pi / K) * r ** (1 / 3)
            g = 0.5 * K
        else:
            k = (6 * np.pi ** 2 * r) ** (1 / 3)
            g = 1.0
        a = np.clip(f.rsh[0] / (2 * k), 1e-10, 50.0)
        out = out + r ** (4 / 3) * g * (8 / 3) * a * (np.sqrt(np.pi) + 3 * a
                                                      + 8 * a ** 3)
    return out


def _gate(name, x, e, grads, e_ref, grads_ref):
    """e_xc to 1e-12 of itself plus the point's energy scale rho_a^(4/3) +
    rho_b^(4/3), each derivative to 1e-9 of itself plus that scale over its
    own variable (the tangents' rounding, as tests/test_torch_uks.py gates
    LYP); both plus 1e-13 of the attenuation's term scale (over the
    variable for a derivative): erf and exp round apart by an ulp in the
    two libraries, and F cancels that ulp of its terms to the 1e-7 of
    itself at a ~ 40 seen here."""
    ra, rb, saa, sab, sbb = x
    scale = ra ** (4 / 3) + rb ** (4 / 3)
    att = 1e-13 * _attenuation_scale(name, ra, rb, saa, sbb)
    assert np.all(np.isfinite(e))
    assert np.all(np.abs(e - e_ref) <= 1e-12 * (np.abs(e_ref) + scale) + att)
    for g, r, v in zip(grads, grads_ref,
                       (ra, rb, saa, np.sqrt(saa * sbb) + 1e-300, sbb)):
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - r) <= 1e-9 * (np.abs(r) + scale / v)
                      + att / v)


@pytest.mark.parametrize('name', RSH_NAMES)
def test_open_shell_density_matches_jax(recorded, name):
    """The torch energy density of the open-shell functional and its five
    derivatives by autograd against jax.grad (recorded; the module's live
    JAX comparison of the kernels' functional is the attenuation's,
    test_sr_attenuation_matches_jax)."""
    x = _open_inputs()
    leaves = [torch.as_tensor(v).requires_grad_() for v in x]
    e = xc.parse_xc(name).exc_density(*leaves)
    grads = torch.autograd.grad(e.sum(), leaves, allow_unused=True)
    ref = _recorded_open(recorded, name)
    _gate(name, x, e.detach().numpy(),
          [np.zeros(x.shape[1]) if g is None else g.numpy() for g in grads],
          *ref)


# reads the terms (id, coefficient, NPARAM parameters each), the number of
# inputs per point (2 or 5) and the points; prints e_xc and its derivatives
HARNESS = r'''
#include <cstdio>
#include "xc_funcs.cuh"
template <int N>
void print(const ptxc::DualN<N>& e) {
  printf("%.17g", e.v);
  for (int k = 0; k < N; ++k) printf(" %.17g", e.d[k]);
  printf("\n");
}
int main() {
  ptxc::Terms t;
  if (scanf("%d", &t.n) != 1) return 1;
  for (int k = 0; k < t.n; ++k) {
    scanf("%d %lf", &t.id[k], &t.c[k]);
    for (int j = 0; j < ptxc::NPARAM; ++j) scanf("%lf", &t.p[k][j]);
  }
  int m, n;
  if (scanf("%d %d", &m, &n) != 2) return 1;
  for (int i = 0; i < n; ++i) {
    double x[5];
    for (int k = 0; k < m; ++k) scanf("%lf", &x[k]);
    if (m == 2) print(ptxc::edens_closed<true>(t, x[0], x[1]));
    else print(ptxc::edens_open<true>(t, x[0], x[1], x[2], x[3], x[4]));
  }
  return 0;
}
'''


@pytest.fixture(scope='module')
def harness(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build csrc/xc_funcs.cuh for the host')
    d = tmp_path_factory.mktemp('xc_rsh_host')
    (d / 'h.cpp').write_text(HARNESS)
    exe = d / 'h'
    subprocess.run([gxx, '-O0', '-std=c++17', '-ffp-contract=off', '-I',
                    kernels._CSRC, '-o', str(exe), str(d / 'h.cpp')],
                   check=True)
    return exe


def _run_harness(harness, name, x):
    """(1 + m, npts) values and derivatives of the header at the (m, npts)
    inputs x, with the terms and parameters the kernels receive."""
    f = xc.parse_xc(name)
    lines = [str(len(f.terms))]
    for (c, _, comp), p in zip(f.terms, f.params):
        lines.append(' '.join([str(kernels.XC_COMPONENT_IDS[comp]), repr(c)]
                              + [repr(v) for v in
                                 kernels._term_params(comp, p)]))
    lines += [f'{x.shape[0]} {x.shape[1]}']
    lines += [' '.join(repr(float(v)) for v in col) for col in x.T]
    out = subprocess.run([str(harness)], input='\n'.join(lines) + '\n',
                         capture_output=True, text=True, check=True).stdout
    return np.array([[float(v) for v in ln.split()]
                     for ln in out.splitlines()]).T


@pytest.mark.parametrize('name', RSH_NAMES)
def test_dual5_matches_jax_grad(harness, recorded, name):
    """edens_open<true>, the functional of the xc_uks kernel, on dual
    numbers with five tangents (erf, log1p and the clamps' half slopes at
    ties) against jax.grad (recorded)."""
    x = _open_inputs()
    got = _run_harness(harness, name, x)
    _gate(name, x, got[0], got[1:], *_recorded_open(recorded, name))


@pytest.mark.parametrize('name', RSH_NAMES)
def test_dual2_matches_jax_grad(harness, recorded, name):
    """edens_closed<true>, the functional of the xc_rks kernel, against
    jax.grad of the closed-shell energy density as pyscf_tpu/dft/numint.py
    takes it (recorded), rho in [1e-10, 1e2] and sigma in [1e-20, 1e3];
    e_xc, vrho and vsigma gated as _gate gates the open shell (over rho or
    sigma for the derivatives)."""
    x = _closed_inputs()
    got = _run_harness(harness, name, x)
    scale = x[0] ** (4 / 3)
    att = 1e-13 * _attenuation_scale(name, 0.5 * x[0], 0.5 * x[0],
                                     0.25 * x[1], 0.25 * x[1])
    for g, ref, v, rel in zip(got, recorded[f'rsh_closed_{name}'],
                              (1.0, x[0], x[1]), (1e-12, 1e-9, 1e-9)):
        ref = np.asarray(ref)
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - ref) <= rel * (np.abs(ref) + scale / v)
                      + att / v)


# ---- the XC quadrature of the spin-polarized cycle -----------------------

def nr_uks_spin_density(nao):
    """The seeded spin density of test_nr_uks_wb97xv_matches_jax (numpy
    (2, nao, nao)): alpha one tight O 1s-like function, beta four seeded
    orbitals."""
    rng = np.random.default_rng(53)
    dm_np = np.zeros((2, nao, nao))
    dm_np[0, 0, 0] = 1.0
    cb = rng.standard_normal((nao, 4)) * 0.3
    dm_np[1] = cb @ cb.T
    return dm_np


def jax_nr_uks_wb97xv():
    """(n, exc, vxc) of the JAX package's nr_uks of wB97X-V at
    nr_uks_spin_density on the water cation's level-1 grid (rsh_refs
    records them)."""
    mj = jpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
               verbose=0)
    gj = jax_gen_grid.Grids(mj)
    gj.level = 1
    gj.build()
    n, e, v = jax_numint.NumInt().nr_uks(mj, gj, 'wb97x-v', jnp.asarray(
        nr_uks_spin_density(mj.nao)))
    return np.asarray(n), float(e), np.asarray(v)


def test_nr_uks_wb97xv_matches_jax(recorded):
    """nr_uks of wB97X-V (the semilocal part) on the water cation's level-1
    grid at a seeded spin density whose alpha part is one tight O 1s-like
    function: far from O, rho_a falls under RHO_THR/2 where rho_a + rho_b
    passes the mask, the clamp of the open-shell branch; against the JAX
    package's nr_uks (recorded)."""
    mt = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
               device='cpu')
    gt = gen_grid.Grids(mt)
    gt.level = 1
    gt.build()
    dm = compat.spin_density_from_numpy(nr_uks_spin_density(mt.nao), 'cpu')
    ao = numint.eval_ao(mt, gt.coords, 0)
    rho = torch.einsum('bi,sij,bj->sb', ao, dm, ao)
    assert bool(((rho[0] < 0.5 * numint.RHO_THR)
                 & (rho.sum(0) > numint.RHO_THR)).any())
    n, e, v = numint.NumInt().nr_uks(mt, gt, 'wb97x-v', dm)
    nj, ej, vj = (recorded[f'rsh_nr_uks_{k}'] for k in 'nev')
    assert np.all(np.abs(n.numpy() - nj) <= 1e-12 * np.abs(nj))
    assert abs(e - ej) <= 1e-12 * abs(ej)
    assert np.max(np.abs(v.numpy() - vj)) <= 1e-11 * np.max(np.abs(vj))


# ---- parsing ---------------------------------------------------------------

@pytest.mark.parametrize('name', ['wb97x-v', 'WB97X_V', 'wb97', 'wb97x',
                                  'camb3lyp', 'cam-b3lyp', 'b97', 'b97-1',
                                  'b97-2', 'b97-d', 'b97d'])
def test_rsh_parse_matches_jax(name):
    got, ref = xc.parse_xc(name), jax_xc.parse_xc(name)
    assert got.hyb == ref.hyb and got.rsh == ref.rsh and got.nlc == ref.nlc
    assert [c for c, _, _ in got.terms] == [c for c, _, _ in ref.terms]
    assert got.family == ref.family == xc.GGA
    assert numint.NumInt().rsh_and_hybrid_coeff(name) == \
        jax_numint.NumInt().rsh_and_hybrid_coeff(name)


def test_xc_assignment_resolves_nlc():
    """pyscf_tpu/dft/rks.py:26-36: `mf.xc = 'wb97x-v'` turns VV10 on with
    its (b, C), and a functional without it turns it off (the b and C it
    set stay, as in the JAX package)."""
    mf = tpt.M(atom='He 0 0 0', basis='sto-3g', device='cpu').RKS()
    assert mf.nlc == '' and (mf.nlc_b, mf.nlc_C) == (5.9, 0.0093)
    mf.xc = 'wb97x-v'
    assert (mf.nlc, mf.nlc_b, mf.nlc_C) == ('VV10', 6.0, 0.01)
    mf.xc = 'b3lypg'
    assert mf.nlc == '' and (mf.nlc_b, mf.nlc_C) == (6.0, 0.01)


# ---- the erf(omega r)/r integrals -------------------------------------------

@pytest.fixture(scope='module')
def water_aux():
    """(the JAX values of tests/port_refs_record.py, the port's water/
    def2-SVP and its aux mole)."""
    mt = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    return np.load(refs.PORT_REFS), mt, make_auxmol(mt)


def test_lr_metric_matches_jax(water_aux):
    """(P|erf|Q) of def2-universal-jkfit against _j2c_whitener's metric
    (through _eri_2c_sph with rs_omega), grouped aux order, as recorded."""
    jax_refs, _, auxmol = water_aux
    ref = jax_refs['lr_metric']
    got = kernels.int2c2e(j3c.aux_tables(auxmol), OMEGA).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    full = kernels.int2c2e(j3c.aux_tables(auxmol)).numpy()
    assert np.max(np.abs(got - full)) > 1e-2 * np.max(np.abs(full))


def test_lr_3c_rows_match_jax(water_aux):
    """Raw erf(omega r)/r rows of every bra class against _class_program
    with rs_omega and an identity whitener, grouped aux order, as
    recorded."""
    jax_refs, mt, auxmol = water_aux
    aux = j3c.aux_tables(auxmol)
    for (la, lb), (bc, pairs) in j3c.screened_pairs(mt).items():
        ref = jax_refs[f'lr_rows_{la}{lb}']
        got = kernels.int3c2e(la, lb, *pairs, aux, OMEGA).numpy()
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_lr_factor(water_aux):
    """The long-range factor: the metric is singular to rounding at omega
    0.3 (the JAX package's Cholesky gives NaN), so the whitener is the
    eigendecomposition over eigenvalues above LINEAR_DEP_THR; B_LR^T B_LR
    against the same product formed from the JAX package's raw rows and
    metric with numpy's eigendecomposition, and the Mole's cache keeps the
    full-range and the long-range factors apart."""
    jax_refs, mt, auxmol = water_aux
    B, _ = j3c.df_factor(mt, auxmol, omega=OMEGA)
    jg = jax_refs['lr_metric']
    assert torch.linalg.cholesky_ex(torch.as_tensor(jg))[1] > 0
    lam, U = np.linalg.eigh(jg)
    keep = lam > j3c.LINEAR_DEP_THR
    W = U[:, keep] / np.sqrt(lam[keep])
    rows = {cls: kernels.int3c2e(*cls, *p, j3c.aux_tables(auxmol), OMEGA)
            for cls, (_, p) in j3c.screened_pairs(mt).items()}
    B_ref = j3c.whitened_factor(mt, auxmol, rows,
                                torch.as_tensor(np.pad(
                                    W, ((0, 0), (0, lam.size - W.shape[1])))))
    n2 = mt.nao ** 2
    got = (B.reshape(-1, n2).T @ B.reshape(-1, n2)).numpy()
    ref = (B_ref.reshape(-1, n2).T @ B_ref.reshape(-1, n2)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))
    mf = mt.RKS(xc='camb3lyp').density_fit()
    assert mf._df_lr(OMEGA).cderi is not mf.with_df.cderi
    assert set(mt._df_cache) == {('None', None), ('None', OMEGA)}


def test_lr_eri_matches_jax_engines():
    """int2e_dense(omega) of water/sto-3g against the JAX package's
    screened engine (j2e.int2e_dense(omega)) and its legacy host engine
    (int2e.int2e(mol, omega)), which the JAX SCF's in-core long-range K
    takes, as tests/port_refs_record.py recorded them."""
    got = j2e.int2e_dense(tpt.M(atom=refs.WATER, basis='sto-3g',
                                device='cpu'), OMEGA).numpy()
    jax_refs = np.load(refs.PORT_REFS)
    for ref in (jax_refs['lr_eri_j2e'], jax_refs['lr_eri_legacy']):
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


# ---- the SCF ---------------------------------------------------------------

def test_he_wb97_golden():
    """He/cc-pVDZ in-core RKS wB97 (conv_tol 1e-11, default grids): the
    in-core K and the long-range K (int2e_dense(0.4)) against the PySCF
    golden of tests/test_ks_variants.py:31-36."""
    mf = tpt.M(atom='He 0 0 0', basis='cc-pvdz', device='cpu').RKS(xc='wb97')
    mf.conv_tol = 1e-11
    e = mf.kernel()
    assert mf.converged
    assert abs(e - GOLDEN_HE_WB97) < 1e-9
    assert 'eri_lr' in mf.timings


def _water(xc_code, charge=0, spin=0, dm0=None):
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=charge, spin=spin,
                device='cpu')
    mf = (mol.UKS(xc=xc_code) if spin else mol.RKS(xc=xc_code)).density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    return mf, mf.kernel(dm0)


@pytest.mark.parametrize('xc_code,charge,spin,ref', [
    ('camb3lyp', 0, 0, refs.E_WATER_DF_RKS_CAMB3LYP_L1),
    ('wb97x-v', 0, 0, refs.E_WATER_DF_RKS_WB97XV_L1),
    ('wb97x-v', 1, 1, refs.E_WATER_CATION_DF_UKS_WB97XV_L1)])
def test_water_df_energy_matches_jax(xc_code, charge, spin, ref):
    """Water (and its cation) DF-RKS/UKS, def2-SVP, level-1 grids, conv_tol
    1e-10, against the recorded JAX energies (pyscf_tpu_torch/refs.py).
    wB97X-V starts from the recorded density of its converged run
    (port_refs.npz 'rsh_dm_wb97xv_<spin>'): its VV10 pair sums take ~2 s a
    cycle on the CPU; CAM-B3LYP from the minao guess."""
    dm0 = None
    if xc_code == 'wb97x-v':
        dm0 = torch.as_tensor(
            np.load(refs.PORT_REFS)[f'rsh_dm_wb97xv_{spin}'])
    mf, e = _water(xc_code, charge, spin, dm0)
    assert mf.converged
    assert abs(e - ref) < 1e-8
    assert {'j2c_lr', 'j3c_lr'} <= set(mf.timings)


@pytest.mark.parametrize('xc_code,nlc', [('camb3lyp', ''), ('wb97x', ''),
                                         ('b3lypg', 'vv10')])
@pytest.mark.parametrize('spin', [0, 1])
def test_rsh_and_vv10_gradients_raise(xc_code, nlc, spin):
    """The reference's DF gradient (pyscf_tpu/grad/autodiff.py:259-311)
    reads neither rsh_coeff nor nlc, so it has no long-range K or VV10
    term: the port raises instead of returning it."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', charge=spin, spin=spin,
                device='cpu')
    mf = (mol.UKS(xc=xc_code) if spin else mol.RKS(xc=xc_code)).density_fit()
    mf.nlc = nlc
    with pytest.raises(NotImplementedError, match='not ported'):
        mf.nuc_grad_method()
