"""The port's k-point periodic SCF (pyscf_tpu_torch/pbc: KFFTDF, KRHF,
KUHF, KRKS, KUKS, the tools) against the JAX package's (pyscf_tpu/pbc) on
the diamond primitive cell of BASELINE config 5 (gth-szv, gth-pade;
tests/test_pbc.py DIAMOND) at mesh [9]^3 with the shifted 2x1x1
Monkhorst-Pack mesh, on the CPU: the Bloch AO values (the plain twin of
the kernel `eval_ao_kpts`) live against eval_ao_kpts at a short rcut and
against the port's Γ values at kpts = Γ; S_k, T_k and the pseudopotential;
J and K at the JAX package's converged KRHF density; the KRHF, KRKS (LDA,
PBE), KUHF and KUKS (PBE, the spin-2 cell) energies; and identities of
the port's own: KRKS at Γ is the Γ RKS, closed-shell KUKS is KRKS, KRHF
on the Γ-centred 2x1x1 mesh is half the RHF of the doubled supercell
(tests/test_pbc.py:79-106's oracle), get_bands at the SCF k-points gives
the SCF orbital energies, and k2gamma_mo's supercell orbitals are
orthonormal. The JAX values that take more than a few seconds are
recorded in pyscf_tpu_torch/data/kpts_refs.npz by
tests/kpts_refs_record.py."""
import os

import numpy as np
import pytest
import torch

from pyscf_tpu.pbc import tools as jax_tools
from pyscf_tpu.pbc.df.fft import eval_ao_kpts as jax_eval_ao_kpts
from pyscf_tpu.pbc.gto import Cell as JaxCell

from pyscf_tpu_torch import pbc
from pyscf_tpu_torch.dft.numint import RHO_THR, SIGMA_FLOOR
from pyscf_tpu_torch.pbc.df.fft import (KFFTDF, eval_ao_kpts,
                                        eval_ao_periodic)

torch.set_num_threads(1)

DIAMOND = dict(
    atom='C 0 0 0; C 0.8917 0.8917 0.8917',
    a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834], [1.7834, 1.7834, 0]],
    basis='gth-szv', pseudo='gth-pade', verbose=0)
REFS = np.load(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'pyscf_tpu_torch', 'data', 'kpts_refs.npz'))


def _cell(spin=0):
    return pbc.gto.M(mesh=[9] * 3, spin=spin, device='cpu', **DIAMOND)


def _kpts(cell):
    return cell.make_kpts([2, 1, 1], with_gamma_point=False)


@pytest.fixture(scope='module')
def cell9():
    return _cell()


@pytest.fixture(scope='module')
def cell9_s2():
    return _cell(spin=2)


def _scf(mf, conv_tol=1e-10):
    mf.conv_tol = conv_tol
    e = mf.kernel()
    assert mf.converged
    return e


@pytest.fixture(scope='module')
def krks_pbe(cell9):
    mf = pbc.dft.KRKS(cell9, kpts=_kpts(cell9), xc='pbe')
    return mf, _scf(mf)


@pytest.mark.parametrize('deriv', [0, 1])
def test_eval_ao_kpts_live(deriv):
    """The twin against the JAX function live on 30 seeded points for 3
    seeded k-points, over the images within 6 Bohr, 1e-12 x max."""
    cell = _cell()
    ref_cell = JaxCell(mesh=[9] * 3, **DIAMOND).build()
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(30, 3)) @ cell.lattice_vectors()
    kpts = rng.uniform(-0.5, 0.5, size=(3, 3)) @ cell.reciprocal_vectors()
    got = eval_ao_kpts(cell, coords, kpts, deriv, rcut=6.0).numpy()
    ref = np.asarray(jax_eval_ao_kpts(ref_cell, coords, kpts, deriv,
                                      rcut=6.0))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_eval_ao_kpts_gamma(cell9):
    """At kpts = Γ the Bloch sums are the lattice sums of
    eval_ao_periodic (the cell's rcut, 1,505 images), 1e-13 x max."""
    coords = cell9.get_uniform_grids()[::7]
    got = eval_ao_kpts(cell9, coords, np.zeros((1, 3)), 1)[0]
    ref = eval_ao_periodic(cell9, coords, 1)
    assert torch.abs(got.imag).max() == 0.0
    assert torch.abs(got.real - ref).max() <= 1e-13 * ref.abs().max()


@pytest.mark.parametrize('name', ['ovlp_k', 'kin_k', 'pp_k'])
def test_one_electron(cell9, name):
    """S_k and T_k (int1e_stv over every image, phased by a GEMM) and the
    pseudopotential (the local part on the Bloch AO values, the phased
    projector overlaps) against the JAX KFFTDF's, 1e-10."""
    df = KFFTDF(cell9, _kpts(cell9))
    got = {'ovlp_k': df.get_ovlp_kpts, 'kin_k': df.get_kin_kpts,
           'pp_k': df.get_pp_kpts}[name]()
    assert np.abs(got.numpy() - REFS[name]).max() <= 1e-10


def test_jk_at_jax_density(cell9):
    """FFT J and K at the JAX package's converged KRHF density against the
    JAX values (no exxdiv term), 1e-10; the Madelung constant of the k
    mesh, 1e-10."""
    kpts = _kpts(cell9)
    vj, vk = KFFTDF(cell9, kpts).get_jk_kpts(torch.as_tensor(REFS['dm_krhf']))
    assert np.abs(vj.numpy() - REFS['vj_k']).max() <= 1e-10
    assert np.abs(vk.numpy() - REFS['vk_k']).max() <= 1e-10
    assert abs(pbc.scf.madelung(cell9, kpts)
               - float(REFS['madelung_k'])) < 1e-10


@pytest.mark.parametrize('kind', ['krhf', 'krks_lda'])
def test_closed_shell_energies(cell9, kind):
    """KRHF (exxdiv 'ewald') and KRKS-LDA against the JAX energies, 1e-8
    Ha."""
    kpts = _kpts(cell9)
    mf = (pbc.scf.KRHF(cell9, kpts=kpts) if kind == 'krhf'
          else pbc.dft.KRKS(cell9, kpts=kpts, xc='lda,vwn'))
    assert abs(_scf(mf) - float(REFS[f'e_{kind}'])) < 1e-8


def test_krks_pbe_and_closed_shell_kuks(cell9, krks_pbe):
    """KRKS-PBE against the JAX energy, 1e-8 Ha (the JAX k-point V_xc is
    dE_xc/dD); KUKS-PBE on the same closed-shell cell equals it, 1e-9."""
    _, e = krks_pbe
    assert abs(e - float(REFS['e_krks_pbe'])) < 1e-8
    mf = pbc.dft.KUKS(cell9, kpts=_kpts(cell9), xc='pbe')
    assert abs(_scf(mf) - e) < 1e-9


@pytest.mark.parametrize('kind', ['kuhf', 'kuks_pbe'])
def test_open_shell_energies(cell9_s2, kind):
    """KUHF and KUKS-PBE of the spin-2 cell against the JAX energies, 1e-8
    Ha. For KUKS the kernel's floors (rho_s >= RHO_THR / 2, sigma_ss >=
    SIGMA_FLOOR) bind at no grid point, so its mask is the JAX package's
    (rho_a + rho_b > RHO_THR, no floor)."""
    kpts = _kpts(cell9_s2)
    mf = (pbc.scf.KUHF(cell9_s2, kpts=kpts) if kind == 'kuhf'
          else pbc.dft.KUKS(cell9_s2, kpts=kpts, xc='pbe'))
    assert abs(_scf(mf) - float(REFS[f'e_{kind}_s2'])) < 1e-8
    if kind == 'kuks_pbe':
        df = mf.with_df
        dm = mf.make_rdm1()
        aod = df._ao_on_grid_kpts(1)
        for s in range(2):
            dmao = aod[:, 0] @ dm[s]
            rho = torch.sum(dmao * aod[:, 0].conj(), (0, 2)).real / 2
            grad = 2 * torch.sum(dmao[:, None] * aod[:, 1:].conj(),
                                 (0, 3)).real / 2
            assert float(rho.min()) > 0.5 * RHO_THR
            assert float((grad * grad).sum(0).min()) > SIGMA_FLOOR


def test_open_shell_gamma_centred_converged(cell9_s2):
    """KUKS-PBE of the spin-2 cell on the Γ-centred 2x1x1 mesh at [9]^3
    converges, as the JAX package's does, to its energy within 1e-8 Ha."""
    mf = pbc.dft.KUKS(cell9_s2, kpts=cell9_s2.make_kpts([2, 1, 1]),
                      xc='pbe')
    assert abs(_scf(mf) - float(REFS['e_kuks_pbe_s2_g'])) < 1e-8


def test_open_shell_gamma_centred_oscillates():
    """At [17]^3 on the Γ-centred 2x1x1 mesh the JAX KUKS-PBE of the
    spin-2 cell does not converge in 100 cycles (the recorded run's flag),
    nor does the port's: the port's first 12 cycles follow the JAX
    energies within 1e-9 Ha, before the oscillation parts them."""
    assert not REFS['kuks_pbe_s2_g17_converged']
    cell = pbc.gto.M(mesh=[17] * 3, spin=2, device='cpu', **DIAMOND)
    mf = pbc.dft.KUKS(cell, kpts=cell.make_kpts([2, 1, 1]), xc='pbe')
    mf.conv_tol, mf.max_cycle = 1e-10, 12
    trace = []
    energy_elec = mf.energy_elec
    mf.energy_elec = lambda *a: trace.append(energy_elec(*a)) or trace[-1]
    mf.kernel()
    assert not mf.converged
    ref = REFS['kuks_pbe_s2_g17_trace'][:12]
    assert np.abs(np.asarray(trace[:12]) - ref).max() < 1e-9


def test_krks_gamma_is_rks(cell9):
    """KRKS-PBE with the one k-point Γ equals the port's Γ-point RKS,
    1e-9 Ha."""
    e_k = _scf(pbc.dft.KRKS(cell9, xc='pbe'))
    mf = pbc.dft.RKS(cell9, xc='pbe')
    mf.init_guess = 'hcore'
    assert abs(_scf(mf) - e_k) < 1e-9


def test_krhf_supercell_oracle_and_k2gamma(cell9):
    """KRHF on the Γ-centred 2x1x1 mesh equals half the Γ RHF of the
    doubled supercell, 1e-8 Ha; k2gamma_mo unfolds its orbitals into
    supercell orbitals orthonormal under the supercell's overlap, 1e-8."""
    kpts = cell9.make_kpts([2, 1, 1])
    mf = pbc.scf.KRHF(cell9, kpts=kpts)
    ek = _scf(mf, 1e-9)
    sc = pbc.tools.super_cell(cell9, [2, 1, 1])
    mfs = pbc.scf.RHF(sc)
    mfs.init_guess = 'hcore'
    assert abs(ek - _scf(mfs, 1e-9) / 2) < 1e-8
    c = pbc.tools.k2gamma_mo(cell9, kpts, mf.mo_coeff, [2, 1, 1])
    s = mfs.get_ovlp().to(torch.complex128)
    eye = torch.eye(c.shape[1], dtype=torch.complex128)
    assert float(torch.abs(c.conj().T @ s @ c - eye).max()) < 1e-8


def test_get_bands_at_scf_kpts(krks_pbe):
    """get_bands at the SCF k-points reproduces the SCF orbital energies,
    1e-7 Ha. The GGA builds its Bloch AO values once, with gradients: the
    pseudopotential's and J's values are their first component."""
    mf, _ = krks_pbe
    df = mf.with_df
    assert df.ao_deriv == 1
    assert (df._ao_on_grid_kpts(0).data_ptr()
            == df._ao_on_grid_kpts(1).data_ptr())
    e, _ = mf.get_bands(mf.kpts)
    assert float(torch.abs(e - mf.mo_energy).max()) < 1e-7


def test_tools_match_jax(cell9):
    """pbc.tools against the JAX package's on the same cell: fft and ifft
    of seeded functions (1e-12 x max, and ifft(fft(f)) = f), get_coulG at
    a k-point (1e-12 x max) and madelung at Γ (1e-10). With kpts the
    port's madelung is the Born-von Karman supercell's, the JAX
    hf.madelung(cell, kpts) of REFS (1e-10), where the JAX tools.madelung
    drops its kpts and returns the Γ value."""
    ref_cell = JaxCell(mesh=[9] * 3, **DIAMOND).build()
    mesh = cell9.mesh
    f = np.random.default_rng(5).standard_normal((2, int(np.prod(mesh))))
    g = pbc.tools.fft(torch.as_tensor(f), mesh)
    g_ref = jax_tools.fft(f, mesh)
    assert np.abs(g.numpy() - g_ref).max() <= 1e-12 * np.abs(g_ref).max()
    back = pbc.tools.ifft(g, mesh)
    assert np.abs(back.numpy() - jax_tools.ifft(g_ref, mesh)).max() <= 1e-12
    assert torch.abs(back - torch.as_tensor(f)).max() <= 1e-12
    k = _kpts(cell9)[1]
    c = pbc.tools.get_coulG(cell9, k).numpy()
    c_ref = np.asarray(jax_tools.get_coulG(ref_cell, k))
    assert np.abs(c - c_ref).max() <= 1e-12 * np.abs(c_ref).max()
    mad = jax_tools.madelung(ref_cell)
    assert abs(pbc.tools.madelung(cell9) - mad) < 1e-10
    assert abs(pbc.tools.madelung(cell9, _kpts(cell9))
               - float(REFS['madelung_k'])) < 1e-10
    assert jax_tools.madelung(ref_cell, _kpts(cell9)) == mad
