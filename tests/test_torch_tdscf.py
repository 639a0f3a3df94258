"""TDA, TDHF and TDDFT in pyscf_tpu_torch on the CPU, against PySCF's
goldens (tests/test_tdscf_extras.py) and the JAX package.

HF/6-31G TDA and TDHF singlets and triplets, their transition dipoles and
NTOs and TDA-B3LYPG and TDA-LDA are held to PySCF's goldens and
fingerprints (the JAX package's own test file cites them); the Davidson
path to the dense one. Water DF-RKS b3lypg and the water cation's DF-UKS
b3lypg are held to the JAX package's A and B matrices, matrix-free
products and energies on the JAX orbitals, recorded by
tests/tdscf_refs_record.py (refs.TDSCF_WATER_REFS; the JAX run takes
minutes), and the response twins of dft/numint.py to live jax.jvp of the
JAX package's XC cores on seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.dft import numint as jax_numint

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import compat, refs
from pyscf_tpu_torch.dft import numint, xc
from pyscf_tpu_torch.tdscf import rhf as tdrhf
from pyscf_tpu_torch.tdscf import uhf as tduhf

torch.set_num_threads(1)

EV = 27.2114                    # tests/test_tdscf_extras.py


def fp(a):
    """PySCF's lib.misc.fingerprint: cos(arange) . a."""
    a = np.asarray(a).ravel()
    return float(np.dot(np.cos(np.arange(a.size)), a))


@pytest.fixture(scope='module')
def hf_631g():
    """Hydrogen fluoride/6-31G RHF (tests/test_tdscf_extras.py:24-29)."""
    mol = tpt.M(atom='H 0 0 .917; F 0 0 0', basis='6-31g', device='cpu')
    mf = mol.RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    return mf


# PySCF's goldens, tdscf/test/test_tdrhf.py:41-74 (eV), with the
# fingerprint of the singlets' transition-dipole norms
GOLDENS = {
    ('TDA', True): ([11.90276464, 11.90276464, 16.86036434], -0.65616659),
    ('TDA', False): ([11.01747918, 11.01747918, 13.16955056], None),
    ('TDHF', True): ([11.83487199, 11.83487199, 16.66309285], -0.64009191),
    ('TDHF', False): ([10.8919234, 10.8919234, 12.63440705], None),
}


@pytest.mark.parametrize('method,singlet', list(GOLDENS))
def test_hf_631g_golden(hf_631g, method, singlet):
    """mf.TDA() / mf.TDHF() within 1e-4 eV of PySCF's goldens; the
    transition dipoles' fingerprint within 1e-4, triplets' zero;
    oscillator strengths non-negative."""
    td = getattr(hf_631g, method)()
    td.nstates = 5
    td.singlet = singlet
    e = td.kernel() * EV
    ref, dip_fp = GOLDENS[method, singlet]
    assert np.max(np.abs(e[:3] - ref)) < 1e-4
    dip = td.transition_dipole()
    if singlet:
        assert abs(fp(np.linalg.norm(dip, axis=1)) - dip_fp) < 1e-4
        assert np.all(td.oscillator_strength() >= -1e-12)
    else:
        assert np.all(dip == 0)
    assert np.allclose(td.e_tot, hf_631g.e_tot + td.e)


def test_nto(hf_631g):
    """The NTO weights sum to 1; the lowest HF excitation is one pair."""
    td = hf_631g.TDA()
    td.nstates = 3
    td.kernel()
    w, nto = td.get_nto(0)
    assert abs(w.sum() - 1.0) < 1e-10
    assert w[0] > 0.9
    assert tuple(nto.shape) == (hf_631g.mol.nao, 2 * len(w))


@pytest.mark.parametrize('singlet', [True, False])
def test_davidson_matches_dense(hf_631g, singlet):
    """The matrix-free Davidson path (dense_cutoff 0) equals the dense A
    within 1e-7 (tests/test_tdscf_extras.py:83-98)."""
    e = []
    for cutoff in (tdrhf.TDA.dense_cutoff, 0):
        td = hf_631g.TDA()
        td.nstates = 4
        td.singlet = singlet
        td.dense_cutoff = cutoff
        e.append(td.kernel())
    assert td.converged and td.cycles > 1 and td.nmatvec >= 4
    assert np.max(np.abs(e[0] - e[1])) < 1e-7


@pytest.mark.parametrize('xc_code,ref', [('b3lypg', -41.385520327568869),
                                         ('lda,vwn', -41.201828219760415)])
def test_tda_xc_golden(hf_631g, xc_code, ref):
    """TDA-B3LYPG and TDA-LDA of HF/6-31G: the fingerprint of five states
    (eV) within 1e-4 of PySCF's (tdscf/test/test_tdrks.py:141,150), with
    unpruned grids and conv_tol 1e-10; the matrix-free product of each
    spin kind equals the dense A."""
    mf = tpt.dft.RKS(hf_631g.mol, xc=xc_code)
    mf.grids.prune = None
    mf.conv_tol = 1e-10
    mf.kernel()
    assert mf.converged
    td = mf.TDA()
    td.nstates = 5
    assert abs(fp(td.kernel() * EV) - ref) < 1e-4
    for singlet in (True, False):
        a, _ = tdrhf.get_ab(mf, singlet)
        n = a.shape[0] * a.shape[1]
        matvec, _ = tdrhf.gen_tda_operation(mf, singlet)
        az = matvec(torch.eye(n, dtype=torch.float64)[:2])
        assert torch.max(torch.abs(az - a.reshape(n, n)[:2])) < 1e-8


# ---- water against the recorded JAX package --------------------------------

@pytest.fixture(scope='module')
def jax_refs():
    return np.load(refs.TDSCF_WATER_REFS)


@pytest.fixture(scope='module')
def water_rks(jax_refs):
    """Water/def2-SVP DF-RKS b3lypg (grids level 1) on the JAX package's
    converged orbitals."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    mf = tpt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.grids.level = 1
    return compat.mean_field_from_numpy(
        mf, jax_refs['rks_mo_coeff'], jax_refs['rks_mo_energy'],
        jax_refs['rks_mo_occ'])


@pytest.mark.parametrize('tag', ['s', 't'])
def test_water_get_ab_matches_jax(water_rks, jax_refs, tag):
    """get_ab's A and B, singlet and triplet, within 1e-10 x max|A| of the
    JAX package's on the same orbitals."""
    a, b = tdrhf.get_ab(water_rks, singlet=tag == 's')
    for got, key in ((a, f'rks_a_{tag}'), (b, f'rks_b_{tag}')):
        ref = jax_refs[key]
        assert got.shape == ref.shape
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize('tag', ['s', 't'])
def test_water_matvec_matches_jax(water_rks, jax_refs, tag):
    """The matrix-free A z (DF J/K and the jvp of V_xc) of two seeded
    vectors in one batch, within 1e-10 x max|A z| of the JAX package's
    products one vector at a time."""
    matvec, hdiag = tdrhf.gen_tda_operation(water_rks, singlet=tag == 's')
    got = matvec(torch.as_tensor(jax_refs['rks_z'])).numpy()
    ref = jax_refs[f'rks_az_{tag}']
    assert hdiag.shape == (ref.shape[1],)
    assert np.max(np.abs(got - ref)) <= 1e-10 * np.abs(ref).max()


def test_water_energies_match_jax(water_rks, jax_refs):
    """mf.TDA() singlets and triplets and mf.TDDFT() singlets (five
    states, dense) within 1e-8 Ha of the JAX package's, the TDA
    oscillator strengths within 1e-8 (water has no degenerate states)."""
    td = water_rks.TDA()
    e = td.kernel(nstates=5)
    assert np.max(np.abs(e - jax_refs['rks_tda_s'])) < 1e-8
    assert np.max(np.abs(td.oscillator_strength()
                         - jax_refs['rks_tda_s_f'])) < 1e-8
    td = water_rks.TDA()
    td.singlet = False
    assert np.max(np.abs(td.kernel(nstates=5) - jax_refs['rks_tda_t'])) < 1e-8
    e = water_rks.TDDFT().kernel(nstates=5)
    assert np.max(np.abs(e - jax_refs['rks_tdhf_s'])) < 1e-8


def test_water_cation_tda_uks_matches_jax(jax_refs):
    """The water cation's DF-UKS b3lypg TDA on the JAX orbitals: the
    stacked A (in-core ERIs, as in the reference) within 1e-10 x max|A| and
    tdscf.TDAUKS's five energies within 1e-8 Ha of the JAX package's."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
                device='cpu')
    mf = mol.UKS(xc='b3lypg').density_fit()
    mf.grids.level = 1
    compat.mean_field_from_numpy(mf, jax_refs['uks_mo_coeff'],
                                 jax_refs['uks_mo_energy'],
                                 jax_refs['uks_mo_occ'])
    a, dims = tduhf.get_ab_uhf(mf)
    ref = jax_refs['uks_a']
    assert sum(dims) == ref.shape[0]
    assert np.max(np.abs(a.numpy() - ref)) <= 1e-10 * np.abs(ref).max()
    e = tpt.tdscf.TDAUKS(mf).kernel(nstates=5)
    assert np.max(np.abs(e - jax_refs['uks_tda'])) < 1e-8


def test_closed_shell_union():
    """TDAUHF of water/sto-3g UHF equals the union of the RHF singlet and
    triplet TDA spectra within 1e-6 (tests/test_tdscf_extras.py:130-150,
    the HF part)."""
    mol = tpt.M(atom=refs.WATER, basis='sto-3g', device='cpu')
    mf = mol.RHF()
    mf.conv_tol = 1e-12
    mf.init_guess = 'hcore'
    mf.kernel()
    es = []
    for singlet in (True, False):
        td = mf.TDA()
        td.nstates = 4
        td.singlet = singlet
        es.append(td.kernel())
    union = np.sort(np.concatenate(es))
    umf = mol.UHF()
    umf.conv_tol = 1e-12
    umf.kernel()
    assert mf.converged and umf.converged
    eu = tpt.tdscf.TDAUHF(umf).kernel(nstates=6)
    assert np.max(np.abs(np.sort(eu) - union[:6])) < 1e-6


def test_unported_paths_raise(hf_631g):
    """The excited-state gradient, and the response of range-separated and
    VV10 functionals (the reference's A and B lack their long-range
    exchange and non-local kernels), raise NotImplementedError."""
    with pytest.raises(NotImplementedError):
        hf_631g.TDA().nuc_grad_method()
    mol = hf_631g.mol
    eye = np.eye(mol.nao)
    occ = np.array([2.0] * 5 + [0.0] * (mol.nao - 5))
    for xc_code in ('camb3lyp', 'wb97x-v'):
        mf = compat.mean_field_from_numpy(
            tpt.dft.RKS(mol, xc=xc_code), eye, np.arange(mol.nao), occ)
        for td in (mf.TDA(), mf.TDDFT()):
            with pytest.raises(NotImplementedError, match='long-range'):
                td.kernel()
        umf = compat.mean_field_from_numpy(
            mol.UKS(xc=xc_code), np.stack([eye, eye]),
            np.stack([np.arange(mol.nao)] * 2), np.stack([occ / 2] * 2))
        with pytest.raises(NotImplementedError, match='long-range'):
            tpt.tdscf.TDAUKS(umf).kernel()


# ---- the response twins against live jax.jvp --------------------------------

def test_response_twins_match_live_jax():
    """xc_rks_fxc_plain and xc_uks_fxc_plain (torch.func.jvp of the block
    maps) against jax.jvp of the JAX package's _get_rks_core_aod and
    _get_uks_core_aod on seeded AO values, densities (some points masked)
    and symmetric tangents, b3lypg: V_xc's tangent within 1e-12 x max."""
    rng = np.random.default_rng(5)
    B, nao = 200, 7
    aod = rng.standard_normal((4, B, nao)) * 0.5
    c = rng.standard_normal((nao, 3))
    dm = c @ c.T * 0.3
    t = rng.standard_normal((nao, nao))
    t = t + t.T
    w = rng.random(B)
    f = xc.parse_xc('b3lypg')
    A, W = torch.as_tensor(aod), torch.as_tensor(w)
    ao = A[0]
    for spin in (1, 2):
        jnum = jax_numint.NumInt()
        if spin == 1:
            d0, d1 = dm, t
            core = jnum._get_rks_core_aod(None, 'b3lypg')
            dv = numint.xc_rks_fxc_plain(
                A, ao @ torch.as_tensor(d0), (ao @ torch.as_tensor(d1))[None],
                W, f)[0]
        else:
            d0, d1 = np.stack([0.6 * dm, 0.4 * dm]), np.stack([t, -0.7 * t])
            core = jnum._get_uks_core_aod(None, 'b3lypg')
            dv = numint.xc_uks_fxc_plain(
                A, torch.matmul(ao, torch.as_tensor(d0)),
                torch.matmul(ao, torch.as_tensor(d1))[None], W, f)[0]
        _, ref = jax.jvp(
            lambda d: core(jnp.asarray(aod)[None], jnp.asarray(w)[None], d)[2],
            (jnp.asarray(d0),), (jnp.asarray(d1),))
        got = torch.matmul(ao.T, dv)
        got = (got + got.transpose(-1, -2)).numpy()
        ref = np.asarray(ref)
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.abs(ref).max()
