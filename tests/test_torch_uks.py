"""Open-shell SCF in pyscf_tpu_torch on the CPU against pyscf_tpu: the
two- and five-tangent dual numbers of csrc/xc_funcs.cuh (built for the
host with g++) against jax.grad (as tests/port_refs_record.py
uks_dual_refs recorded it), the spin-polarized XC quadrature, in-core UHF
on O2 and DF-UKS b3lypg on the water cation against JAX runs recorded by
tests/port_refs_record.py."""
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

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.dft import gen_grid, numint, xc
from pyscf_tpu_torch.ops import kernels

torch.set_num_threads(1)

GOLDEN_RHF_STO3G = -74.96306312971071      # tests/test_scf.py:19-25
O2 = 'O 0 0 0; O 0 0 1.21'                 # tests/test_scf.py:49-58

# ---- the dual numbers of the xc_rks and xc_uks kernels, on the host -------

# reads the terms, the number of inputs per point (2: rho, sigma for
# edens_closed; 5: rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb for
# edens_open) and the points; prints e_xc and its derivatives per point
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
  for (int k = 0; k < t.n; ++k) scanf("%d %lf", &t.id[k], &t.c[k]);
  int m, n;
  if (scanf("%d %d", &m, &n) != 2) return 1;
  for (int i = 0; i < n; ++i) {
    double x[5];
    for (int k = 0; k < m; ++k) scanf("%lf", &x[k]);
    if (m == 2) print(ptxc::edens_closed(t, x[0], x[1]));
    else print(ptxc::edens_open(t, x[0], x[1], x[2], x[3], x[4]));
  }
  return 0;
}
'''


@pytest.fixture(scope='module')
def harness(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build csrc/xc_funcs.cuh for the host')
    d = tmp_path_factory.mktemp('xc_host')
    (d / 'h.cpp').write_text(HARNESS)
    exe = d / 'h'
    subprocess.run([gxx, '-O0', '-std=c++17', '-I', kernels._CSRC, '-o',
                    str(exe), str(d / 'h.cpp')], check=True)
    return exe


def _run_harness(harness, name, x):
    """(1 + m, npts) values and derivatives of the header at the (m, npts)
    inputs x."""
    f = xc.parse_xc(name)
    lines = [str(len(f.terms))]
    lines += [f'{kernels.XC_COMPONENT_IDS[comp]} {c!r}' for c, _, comp in
              f.terms]
    lines += [f'{x.shape[0]} {x.shape[1]}']
    lines += [' '.join(repr(float(v)) for v in col) for col in x.T]
    out = subprocess.run([str(harness)], input='\n'.join(lines) + '\n',
                         capture_output=True, text=True, check=True).stdout
    return np.array([[float(v) for v in ln.split()]
                     for ln in out.splitlines()]).T


def _open_inputs():
    """rho_s in [1e-10, 1e2], sigma_ss in [1e-20, 1e3], log-uniform, and
    sigma_ab of either sign with |sigma_ab| <= sqrt(sigma_aa sigma_bb)."""
    rng = np.random.default_rng(17)
    n = 300
    ra, rb = 10.0 ** rng.uniform(-10, 2, (2, n))
    saa, sbb = 10.0 ** rng.uniform(-20, 3, (2, n))
    sab = rng.uniform(-1, 1, n) * np.sqrt(saa * sbb)
    return np.stack([ra, rb, saa, sab, sbb])


DUAL5_NAMES = ('SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'b3lypg', 'blyp')
DUAL2_NAMES = ('SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'b3lypg',
               'lda,vwn_rpa')


def _closed_inputs():
    """rho in [1e-10, 1e2] and sigma in [1e-20, 1e3], log-uniform."""
    rng = np.random.default_rng(23)
    return np.stack([10.0 ** rng.uniform(-10, 2, 300),
                     10.0 ** rng.uniform(-20, 3, 300)])


def jax_dual5(name, x):
    """(6, n): the JAX package's open-shell energy density and jax.grad in
    its five inputs at x."""
    fj = jax_xc.parse_xc(name)
    args = [jnp.asarray(v) for v in x]
    grads = jax.grad(lambda *a: jnp.sum(fj.exc_density(*a)),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return np.stack([np.asarray(fj.exc_density(*args))]
                    + [np.asarray(g) for g in grads])


def jax_dual2(name, x):
    """(3, n): e, vrho, vsigma of the JAX package's closed-shell energy
    density as pyscf_tpu/dft/numint.py:127-137 takes it, at x."""
    fj = jax_xc.parse_xc(name)

    def edens(r, s):
        return fj.exc_density(0.5 * r, 0.5 * r, 0.25 * s, 0.25 * s, 0.25 * s)

    r, s = jnp.asarray(x[0]), jnp.asarray(x[1])
    vr, vs = jax.grad(lambda a, b: jnp.sum(edens(a, b)), argnums=(0, 1))(r, s)
    return np.stack([np.asarray(v) for v in (edens(r, s), vr, vs)])


@pytest.fixture(scope='module')
def recorded():
    """jax_dual5 at _open_inputs ('uks_dual5_<name>') and jax_dual2 at
    _closed_inputs ('uks_dual2_<name>'), as tests/port_refs_record.py
    uks_dual_refs recorded them (seconds each in JAX's eager dispatch;
    the JAX functionals are held live to the port's twins in
    tests/test_torch_xc.py)."""
    return np.load(refs.PORT_REFS)


@pytest.mark.parametrize('name', DUAL5_NAMES)
def test_dual5_matches_jax_grad(harness, recorded, name):
    """e_xc to 1e-12 relative. Each derivative d_k to 1e-9 of |d_k| plus the
    point's energy-density scale rho_a^(4/3) + rho_b^(4/3) over its own
    variable (rho_s, sigma_ss, or sqrt(sigma_aa sigma_bb) for sigma_ab):
    forward-mode tangents and jax.grad's reverse mode round apart where
    LYP's terms cancel (at rho_a = 3e-10, rho_b = 2e-3, sigma_bb = 4e2 its
    d/drho_b differs by 2e-10 relative), and that floor is how much a
    derivative moves the energy density."""
    x = _open_inputs()
    got = _run_harness(harness, name, x)
    e, *grads = recorded[f'uks_dual5_{name}']
    assert np.all(np.abs(got[0] - e) <= 1e-12 * np.abs(e))
    ra, rb, saa, sab, sbb = x
    scale = ra ** (4 / 3) + rb ** (4 / 3)
    for g, r, v in zip(got[1:], grads,
                       (ra, rb, saa, np.sqrt(saa * sbb), sbb)):
        r = np.asarray(r)
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - r) <= 1e-9 * (np.abs(r) + scale / v))


@pytest.mark.parametrize('name', DUAL2_NAMES)
def test_dual2_matches_jax_grad(harness, recorded, name):
    """edens_closed, xc_rks's functional, against jax.grad of the closed-shell
    energy density (jax_dual2, recorded) at _closed_inputs; e_xc, vrho and
    vsigma to 1e-12 relative."""
    got = _run_harness(harness, name, _closed_inputs())
    for g, ref in zip(got, recorded[f'uks_dual2_{name}']):
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - ref) <= 1e-12 * np.abs(ref))


# ---- the spin-polarized quadrature ----------------------------------------

@pytest.fixture(scope='module')
def cation_grids():
    mj = jpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
               verbose=0)
    mt = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
               device='cpu')
    gj, gt = jax_gen_grid.Grids(mj), gen_grid.Grids(mt)
    gj.level = gt.level = 1
    return mj, mt, gj.build(), gt.build()


@pytest.mark.parametrize('xc_code', ['b3lypg', 'lda,vwn'])
def test_nr_uks_matches_jax(cation_grids, xc_code):
    """At one seeded spin density (5 alpha and 4 beta orbitals), made with
    numpy and carried across by compat."""
    mj, mt, gj, gt = cation_grids
    rng = np.random.default_rng(31)
    c = rng.standard_normal((2, mt.nao, 5)) * 0.3
    dm_np = np.einsum('sio,sjo->sij', c, c)
    dm_np[1] -= np.outer(c[1, :, 4], c[1, :, 4])
    dm = compat.spin_density_from_numpy(dm_np, 'cpu')
    n, e, v = numint.NumInt().nr_uks(mt, gt, xc_code, dm)
    nj, ej, vj = jax_numint.NumInt().nr_uks(mj, gj, xc_code,
                                            jnp.asarray(dm_np))
    assert np.all(np.abs(n.numpy() - nj) <= 1e-12 * np.abs(nj))
    assert abs(e - ej) <= 1e-12 * abs(ej)
    vj = np.asarray(vj)
    assert np.max(np.abs(v.numpy() - vj)) <= 1e-11 * np.max(np.abs(vj))


def test_xc_uks_plain_closed_shell_is_xc_rks_plain(cation_grids):
    """Half the density in each spin gives the closed-shell twin's numbers:
    vtmp_a = vtmp_b = vtmp_rks, n_a + n_b = n, the same exc."""
    _, mt, _, gt = cation_grids
    rng = np.random.default_rng(23)
    c = torch.as_tensor(rng.standard_normal((mt.nao, 5)) * 0.3)
    dm = 2.0 * c @ c.T
    aod = numint.eval_ao(mt, gt.coords, 1)
    f = xc.parse_xc('b3lypg')
    vr, nr, er = numint.xc_rks_plain(aod, aod[0] @ dm, gt.weights, f)
    vu, nu, eu = numint.xc_uks_plain(aod, aod[0] @ torch.stack([dm, dm]) / 2,
                                     gt.weights, f)
    scale = torch.max(torch.abs(vr))
    assert torch.max(torch.abs(vu - vr)) <= 1e-12 * scale
    assert abs(float(nu.sum() - nr)) <= 1e-12 * abs(float(nr))
    assert abs(float(eu - er)) <= 1e-12 * abs(float(er))


def test_nr_uks_closed_shell_is_nr_rks(cation_grids):
    _, mt, _, gt = cation_grids
    rng = np.random.default_rng(29)
    c = torch.as_tensor(rng.standard_normal((mt.nao, 5)) * 0.3)
    dm = 2.0 * c @ c.T
    n_r, e_r, v_r = numint.NumInt().nr_rks(mt, gt, 'b3lypg', dm)
    n_u, e_u, v_u = numint.NumInt().nr_uks(mt, gt, 'b3lypg',
                                           torch.stack([dm, dm]) / 2)
    assert abs(float(n_u.sum()) - n_r) <= 1e-12 * abs(n_r)
    assert abs(e_u - e_r) <= 1e-12 * abs(e_r)
    for v in v_u:
        assert torch.max(torch.abs(v - v_r)) <= 1e-12 * torch.max(
            torch.abs(v_r))


# ---- the SCF --------------------------------------------------------------

def test_water_cation_df_uks_matches_jax():
    """Water cation (charge 1, spin 1) DF-UKS b3lypg/def2-SVP, level-1
    grids, against the JAX run that tests/port_refs_record.py recorded."""
    r = np.load(refs.PORT_REFS)
    e_jax, s2_jax = float(r['uks_e']), float(r['uks_s2'])
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
                device='cpu')
    mf = mol.UKS(xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert bool(r['uks_converged']) and mf.converged
    assert abs(e - e_jax) < 1e-8
    assert abs(refs.E_WATER_CATION_DF_UKS_B3LYPG_L1 - e_jax) < 1e-8
    assert mf.mo_energy.shape == (2, mol.nao)
    assert torch.equal(mf.mo_occ.sum(dim=1),
                       torch.tensor([5.0, 4.0], dtype=torch.float64))
    assert abs(mf.spin_square()[0] - s2_jax) < 1e-6


def test_o2_incore_uhf_matches_jax():
    """O2/sto-3g in-core UHF (hcore, conv_tol 1e-10) against the JAX run
    that tests/port_refs_record.py recorded."""
    r = np.load(refs.PORT_REFS)
    e_jax = float(r['o2_e'])
    mf = tpt.M(atom=O2, basis='sto-3g', spin=2, device='cpu').UHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert bool(r['o2_converged']) and mf.converged
    assert abs(e - e_jax) < 1e-8
    ss, mult = mf.spin_square()
    assert abs(ss - float(r['o2_s2'])) < 1e-6 and ss > 1.9
    assert abs(mult - (2 * (ss + 0.25) ** 0.5)) < 1e-12
    dm = mf.make_rdm1()
    vhf = mf._veff_fns()[1](dm)[0]
    e_elec = mf.energy_elec(dm, mf.get_hcore(), vhf)
    assert abs(e_elec + mf.energy_nuc() - e) < 1e-10


def test_uhf_closed_shell_is_the_rhf_golden():
    mf = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu').UHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-11
    e = mf.kernel()
    assert mf.converged and abs(e - GOLDEN_RHF_STO3G) < 1e-8
    dm = mf.make_rdm1()
    assert torch.max(torch.abs(dm[0] - dm[1])) < 1e-8


def test_inconsistent_spin_raises():
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', spin=1, device='cpu')
    with pytest.raises(RuntimeError, match='inconsistent'):
        mol.nelec
    assert tpt.M(atom=O2, basis='sto-3g', spin=2,
                 device='cpu').multiplicity == 3


def test_minao_guess_splits_by_spin():
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
                device='cpu')
    dm = mol.UHF().get_init_guess()
    s = mol.UHF().get_ovlp()
    assert dm.shape == (2, mol.nao, mol.nao)
    na = float(torch.sum(dm[0] * s))
    nb = float(torch.sum(dm[1] * s))
    assert abs(na / nb - 5.0 / 4.0) < 1e-12


def test_oh_radical_df_uks_converges_to_jax():
    """The OH radical's DF-UKS b3lypg/sto-3g on the level-0 grid (minao,
    conv_tol 1e-12, conv_tol_grad 1e-9): the beta pi pair is degenerate in
    the guess, and a hole at an arbitrary angle in it drifted ~5e-9 Ha a
    cycle without converging; aligned with the AOs (lib/linalg.py
    align_degenerate), the SCF converges to the JAX package's state, its
    energy recorded in hessian_water_refs.npz ('oh_uks_e_tot',
    tests/hessian_refs_record.py oh_uks), within 1e-8 Ha."""
    rec = np.load(refs.HESSIAN_REFS)
    mol = tpt.M(atom='O 0 0 0; H 0 0 0.97', basis='sto-3g', spin=1,
                device='cpu')
    mf = mol.UKS(xc='b3lypg').density_fit()
    mf.grids.level = 0
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    e = mf.kernel()
    assert mf.converged
    assert abs(e - float(rec['oh_uks_e_tot'])) < 1e-8
