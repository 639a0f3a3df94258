"""The analytic DF-RKS Hessian and the transition-state search of
pyscf_tpu_torch on the CPU against pyscf_tpu: the plain twins of the AO
third derivatives and of the XC Hessian kernels against the JAX package's
jax.jacfwd and jax.hessian (recorded by tests/hessian_refs_record.py
xc_twins: 4-14 s each live); water's DF-RKS b3lypg Hessian on the JAX
package's orbitals against its recorded Hessian (water_rks); the default
Hessian against central differences of the port's gradient on a fixed
grid; optimize_ts against the JAX package's on a seeded potential with a
saddle, and on NH3's inversion.

The JAX package's dE_xc/dD is not symmetric for a GGA, and its CPHF takes
that matrix's derivatives (pyscf_tpu/hessian/rhf.py:226-233,287); with
reference_vxc=True and reference_w=True the port reproduces its Hessian,
and the default is the derivative of the gradient (ROADMAP section 3)."""
import numpy as np
import pytest
import torch

import pyscf_tpu as jpt
from pyscf_tpu import geomopt as jax_geomopt
from pyscf_tpu import hessian as jax_hessian

import hessian_refs_record as rec
import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import hessian, refs
from pyscf_tpu_torch.dft import gen_grid, numint
from pyscf_tpu_torch.hessian import rhf as hess_rhf
from pyscf_tpu_torch.lib.parameters import BOHR
from pyscf_tpu_torch.tdscf import rhf as tdscf_rhf
from pyscf_tpu_torch.ops import eval_gto

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def recorded():
    return np.load(refs.HESSIAN_REFS)


# ---- the twins against the JAX package's derivatives -----------------------

@pytest.mark.parametrize('l', range(5))
def test_eval_ao_deriv3_matches_jax_jacfwd(recorded, l):
    """eval_ao deriv 3 (the twin of the kernel's deriv 3) on s to g shells
    against jax.jacfwd(jax.jacfwd(...)) of the JAX eval_ao(..., deriv=1,
    atom_coords=X) on each AO's own atom, d_i d_j of -d_k phi being
    +d_i d_j d_k phi: the columns of class l within 1e-12 of the largest
    element; the first ten components are deriv 2's."""
    mol = tpt.M(atom=rec.FG_ATOMS, basis=rec.AO3_BASIS, device='cpu')
    pts = torch.as_tensor(rec.ao3_points())
    got = eval_gto.eval_ao(mol, pts, deriv=3).numpy()
    assert got.shape == (20, pts.shape[0], mol.nao)
    assert np.array_equal(got[:10], eval_gto.eval_ao(mol, pts, 2).numpy())
    ref = recorded['xc_ao3']
    g = mol.shell_groups[l]
    cols = (g.ao_off[:, None] + np.arange(2 * l + 1)).ravel()
    err = np.abs(got[10:][..., cols] - ref[..., cols]).max()
    assert err <= 1e-12 * np.abs(ref).max()


@pytest.fixture(scope='module')
def water_xc_terms(recorded):
    """{functional: (F, hxx)} of rks_xc_hessian (the twins) on the recorded
    grid and density of water/def2-SVP."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    grids = gen_grid.Grids(mol)
    grids.coords = torch.as_tensor(recorded['xc_grid_coords'])
    grids.weights = torch.as_tensor(recorded['xc_grid_weights'])
    D = torch.as_tensor(recorded['xc_dm'])
    ni = numint.NumInt()
    return {name: ni.rks_xc_hessian(mol, grids, code, D, tangent_chunk=4)
            for name, code in rec.XC_TWINS.items()}


def _gate(got, ref):
    """1e-9 of each derivative's size plus the point energy scale (the
    largest element): the XC twins' limit (ROADMAP section 3)."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    tol = 1e-9 * (np.abs(ref) + np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= tol)


@pytest.mark.parametrize('name', list(rec.XC_TWINS))
def test_xc_hessian_at_fixed_d_matches_jax(recorded, water_xc_terms, name):
    """E_xc's second derivative in the nuclear coordinates at a fixed
    seeded D (xc_rks_hess_plain and its GEMMs) against jax.hessian of the
    JAX package's _exc_quadrature in X, on 291 points of water/def2-SVP's
    level-0 grid."""
    _gate(water_xc_terms[name][1].numpy(), recorded[f'xc_{name}_hess'])


@pytest.mark.parametrize('name', list(rec.XC_TWINS))
def test_dvxc_at_fixed_d_matches_jax(recorded, water_xc_terms, name):
    """dV_xc/dX at fixed D: 2 F (xc_rks_deriv1_plain and its GEMMs) against
    jax.jacfwd in X of the JAX package's jax.grad of _exc_quadrature in D
    (unsymmetrised), and F + F^T against its symmetric part."""
    F = water_xc_terms[name][0].numpy()
    ref = np.moveaxis(recorded[f'xc_{name}_dv'], -1, 0)
    _gate(2.0 * F, ref)
    _gate(F + F.transpose(0, 2, 1), 0.5 * (ref + ref.transpose(0, 2, 1)))


# ---- the Hessian ------------------------------------------------------------

def _water_rks(recorded):
    """The port's DF-RKS b3lypg on the recorded JAX orbitals and grid of
    water/sto-3g (tests/hessian_refs_record.py water_rks)."""
    mf = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu').RKS(
        xc='b3lypg').density_fit()
    mf.grids.coords = torch.as_tensor(recorded['water_rks_grid_coords'])
    mf.grids.weights = torch.as_tensor(recorded['water_rks_grid_weights'])
    for k in ('mo_coeff', 'mo_energy', 'mo_occ'):
        setattr(mf, k, torch.as_tensor(recorded[f'water_rks_{k}']))
    mf.e_tot = float(recorded['water_rks_e_tot'])
    mf.converged = True
    return mf


def test_water_rks_hessian_on_jax_orbitals(recorded):
    """With the reference's W response and its unsymmetrised V_xc
    derivatives, within 1e-8 Ha/Bohr^2 of the JAX package's recorded
    Hessian on the same orbitals and grid; with the symmetrised V_xc alone
    more than 1e-3 away (the reference's fault)."""
    mf = _water_rks(recorded)
    ref = recorded['water_rks_hess']
    h = hess_rhf.hessian(mf, reference_w=True, reference_vxc=True)[0]
    assert np.max(np.abs(h - ref)) < 1e-8
    h_sym = hess_rhf.hessian(mf, reference_w=True)[0]
    assert np.max(np.abs(h_sym - ref)) > 1e-3


@pytest.fixture(scope='module')
def water_rks_hessian(recorded):
    """(the mean field of _water_rks, its mf.Hessian() after kernel(), the
    default Hessian)."""
    mf = _water_rks(recorded)
    hobj = mf.Hessian()
    return mf, hobj, hobj.kernel()


def test_rks_hessian_matches_central_differences(water_rks_hessian):
    """The default Hessian (the derivative of the port's gradient) through
    mf.Hessian() against the four-point central differences (step 1e-3
    Bohr) of the port's analytic gradient on the same fixed grid (SCFs at
    conv_tol 1e-12, conv_tol_grad 1e-9) on O's z column, whose diagonal
    the two-point difference misses by ~4e-3: 1e-5 Ha/Bohr^2; the phases
    include xc_rows and xc_F1."""
    mf, hobj, h = water_rks_hessian
    assert isinstance(hobj, hess_rhf.Hessian)
    assert {'xc_rows', 'xc_F1', 'cphf'} <= set(hobj.timings)
    grids = (mf.grids.coords, mf.grids.weights)

    def grad(m):
        f = m.RKS(xc='b3lypg').density_fit()
        f.grids.coords, f.grids.weights = grids
        f.conv_tol, f.conv_tol_grad = 1e-12, 1e-9
        f.kernel()
        assert f.converged
        return f.Gradients().kernel()

    fd = hessian.fd_columns(grad, mf.mol, [(0, 2)], points=4)[0]
    assert np.max(np.abs(h[0, 2] - fd)) < 1e-5


def test_rks_hessian_fxc_routes_agree(water_rks_hessian, monkeypatch):
    """Water's CPHF takes the dense A_xc (xc_fxc and xc_fxc_pairs) in its
    CG steps; with _dense_fxc patched to refuse it, the tangent of V_xc
    (xc_rks_fxc) alone, and no A_xc is built: the two Hessians within
    1e-9."""
    mf, _, h = water_rks_hessian
    nov = int((mf.mo_occ > 0).sum()) * int((mf.mo_occ == 0).sum())
    assert hess_rhf._dense_fxc(mf.mol, nov)
    monkeypatch.setattr(hess_rhf, '_dense_fxc', lambda mol, n: False)

    def no_a_xc(*args, **kwargs):
        raise AssertionError('A_xc built on the tangent route')

    monkeypatch.setattr(tdscf_rhf, '_fxc_ov', no_a_xc)
    assert np.max(np.abs(hess_rhf.Hessian(mf).kernel() - h)) < 1e-9


def test_cphf_xc_response_selection(monkeypatch):
    """_dense_fxc takes the dense A_xc at benzene/def2-TZVP ((nocc nvir)^2
    10.0 x 3 natm nao^2, where the card measured it the faster) and not
    at C6F6/def2-TZVP (43.5 x), nor where A_xc would not fit the memory
    budget."""
    def ratio_and_nov(atom):
        mol = tpt.M(atom=atom, basis='def2-tzvp', device='cpu')
        no = mol.nelectron // 2
        nov = no * (mol.nao - no)
        return mol, nov, nov ** 2 / (3 * mol.natm * mol.nao ** 2)

    mol, nov, r = ratio_and_nov(refs.BENZENE)
    assert abs(r - 10.04) < 0.01 and hess_rhf._dense_fxc(mol, nov)
    mol6, nov6, r6 = ratio_and_nov(refs.C6F6)
    assert abs(r6 - 43.46) < 0.01 and not hess_rhf._dense_fxc(mol6, nov6)
    monkeypatch.setattr(numint, '_budget',
                        lambda device, share: 8 * nov * nov - 1)
    assert not hess_rhf._dense_fxc(mol, nov)


def test_rsh_and_nlc_refused_by_the_analytic_hessian():
    """As pyscf_tpu/hessian/rhf.py:161-165: the analytic Hessian raises for
    range-separated functionals (camb3lyp; wb97x-v, VV10 besides) and for
    VV10 on a global hybrid (b3lypg with nlc set), and the dispatcher
    sends them to HessianFD."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu')

    def mean_field(xc, nlc):
        mf = mol.RKS(xc=xc).density_fit()
        if nlc:
            mf.nlc = 'VV10'
        return mf

    for xc, nlc, what in (('camb3lyp', False, 'range-separated'),
                          ('wb97x-v', False, 'range-separated'),
                          ('b3lypg', True, 'NLC')):
        with pytest.raises(NotImplementedError, match=what):
            hess_rhf.Hessian(mean_field(xc, nlc))
        assert isinstance(mean_field(xc, nlc).Hessian(), hessian.HessianFD)


# ---- optimize_ts ------------------------------------------------------------

class SaddlePotential:
    """E = 1/2 d.A d + beta/4 sum d^4 with d = x - x0 and a seeded A of one
    negative eigenvalue: a first-order saddle at x0. The .e_tot and
    .Gradients().kernel() that optimize_ts reads from a mean field, and
    the analytic Hessian that _Hessian serves, as numpy."""

    def __init__(self, coords, params):
        x0, A, beta = params
        d = np.asarray(coords).ravel() - x0
        self.e_tot = float(0.5 * d @ A @ d + 0.25 * beta * np.sum(d ** 4))
        self._de = (A @ d + beta * d ** 3).reshape(-1, 3)
        self.hess = A + np.diag(3.0 * beta * d ** 2)

    def Gradients(self):
        return self

    def kernel(self):
        return self._de


class _Hessian:
    def __init__(self, mf):
        self.mf = mf

    def kernel(self):
        n = self.mf.hess.shape[0] // 3
        return self.mf.hess.reshape(n, 3, n, 3)


NH3_PYRAMID = 'N 0 0 0.15; H 0.94 0 0; H -0.47 0.814 0; H -0.47 -0.814 0'


def test_optimize_ts_matches_jax_on_seeded_potential(monkeypatch):
    """Both packages' optimize_ts on one seeded saddle potential, with
    hessian.Hessian patched on both to serve its analytic Hessian: every
    step's energy and the final coordinates within 1e-10, converged to
    max|g| < 1e-6 at the saddle."""
    jmol = jpt.M(atom=NH3_PYRAMID, basis='sto-3g', verbose=0)
    mol = tpt.M(atom=NH3_PYRAMID, basis='sto-3g', device='cpu')
    n = 3 * mol.natm
    rng = np.random.default_rng(31)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = q @ np.diag(np.concatenate([[-0.3], rng.uniform(0.2, 1.0, n - 1)])) \
        @ q.T
    x0 = np.asarray(mol.coords).ravel() + 0.3 * rng.standard_normal(n)
    params = (x0, A, 0.5)

    def factory(m):
        return SaddlePotential(np.asarray(m.coords), params)

    monkeypatch.setattr(jax_hessian, 'Hessian', _Hessian)
    monkeypatch.setattr(hessian, 'Hessian', _Hessian)
    jm, je = jax_geomopt.optimize_ts(factory, jmol, gtol=1e-6)
    m, e = tpt.geomopt.optimize_ts(factory, mol, gtol=1e-6)
    assert 3 < len(e) == len(je) < 40
    assert np.max(np.abs(np.array(e) - np.array(je))) < 1e-10
    assert np.max(np.abs(np.asarray(m.coords) - np.asarray(jm.coords))) \
        < 1e-10
    assert m._ts_grad_norm < 1e-6
    assert np.max(np.abs(np.asarray(m.coords).ravel() - x0)) < 1e-5


def _nh3_rhf_search(atom):
    """optimize_ts on DF-RHF/sto-3g (conv_tol 1e-10, conv_tol_grad 1e-7)
    from atom: (final Mole, energies, N's height over the H3 plane in
    Angstrom, harmonic frequencies with the translations and rotations
    projected out)."""
    mol = tpt.M(atom=atom, basis='sto-3g', device='cpu')

    def factory(m):
        mf = m.RHF().density_fit()
        mf.conv_tol, mf.conv_tol_grad = 1e-10, 1e-7
        mf.kernel()
        return mf

    m, e = tpt.geomopt.optimize_ts(factory, mol)
    r = np.asarray(m.coords) * BOHR
    nrm = np.cross(r[2] - r[1], r[3] - r[1])
    height = abs(np.dot(r[0] - r[1], nrm / np.linalg.norm(nrm)))
    h = hessian.project_trans_rot(m, factory(m).Hessian().kernel())
    return m, e, height, hessian.harmonic_analysis(m, h)['freq_wavenumber']


def test_nh3_ts_search_from_outside_the_negative_curvature_falls():
    """The limitation of the reference's P-RFO, ported step for step: it
    follows the lowest Cartesian mode without projecting out the rigid
    ones, so from NH3 0.3 Angstrom off planar, where the umbrella's
    curvature is positive at DF-RHF/sto-3g, it does not climb but falls
    to the pyramidal minimum: converged (max|g| < 3e-4) with N more than
    0.3 Angstrom off the H3 plane, a lower energy than the start's, and
    no imaginary frequency (from 0.2 Angstrom it finds the saddle at this
    level; at B3LYP/def2-SVP on the card it falls from 0.2, ROADMAP
    section 3)."""
    m, e, height, freq = _nh3_rhf_search(
        'N 0 0 0.3; H 0.94 0 0; H -0.47 0.814 0; H -0.47 -0.814 0')
    assert m._ts_grad_norm < 3e-4 and len(e) < 15
    assert height > 0.3 and e[-1] < e[0]
    assert np.all(freq > -1.0) and np.sum(freq < 1.0) == 6


def test_nh3_inversion_saddle():
    """NH3's inversion saddle by optimize_ts on DF-RHF/sto-3g from a
    pyramid 0.15 Angstrom high (analytic Hessian, conv_tol 1e-10,
    conv_tol_grad 1e-7): max|g| < 3e-4, N within 1e-3 Angstrom of the H3
    plane, and exactly one imaginary frequency once the translations and
    rotations are projected out."""
    m, e, height, freq = _nh3_rhf_search(NH3_PYRAMID)
    assert m._ts_grad_norm < 3e-4 and len(e) < 15
    assert height < 1e-3
    assert np.sum(freq < -1.0) == 1 and freq[0] < -500.0
    assert np.sum(np.abs(freq) < 1.0) == 6
