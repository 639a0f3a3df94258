"""MP2, UMP2, ao2mo and DIIS of pyscf_tpu_torch on the CPU against
pyscf_tpu: the plain twin of the `mp2_energy` kernel against the JAX
package's pair-energy programs on seeded tensors, ao2mo and the DIIS step
against theirs, and the port's MP2 entry points end to end against
PySCF's golden (tests/test_postscf.py) and the recorded JAX energies
(pyscf_tpu_torch/refs.py)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu import ao2mo as jax_ao2mo
from pyscf_tpu.lib.diis import DIIS as JaxDIIS
from pyscf_tpu.mp import mp2 as jax_mp2
from pyscf_tpu.mp import ump2 as jax_ump2

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import ao2mo, refs
from pyscf_tpu_torch.lib.diis import DIIS
from pyscf_tpu_torch.ops import kernels

torch.set_num_threads(1)

GOLDEN_MP2 = -0.204019967288338     # tests/test_postscf.py:28


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


def _seeded_ovov(rng, no, nv, no2=None, nv2=None):
    """A seeded (ia|jb)-like block and eia's of occupied below -0.5 and
    virtual above 0.2 orbital energies."""
    no2, nv2 = no2 or no, nv2 or nv
    g = rng.standard_normal((no, nv, no2, nv2)) * 0.1
    if (no2, nv2) == (no, nv):
        g = g + g.transpose(2, 3, 0, 1)

    def eia(n, m):
        return (-0.5 - rng.random(n))[:, None] - (0.2 + rng.random(m))[None]
    return g, eia(no, nv), eia(no2, nv2)


def test_mp2_energy_twin_against_jax():
    """_emp2_from_ovov, _emp2_os_ss and ump2._emp2_uhf against
    kernels.mp2_energy on CPU tensors (its plain twin): 1e-12 relative,
    and the amplitudes to 1e-13 of their largest."""
    rng = np.random.default_rng(3)
    g, eia, _ = _seeded_ovov(rng, 4, 7)
    t2, d, x = kernels.mp2_energy(torch.as_tensor(g), torch.as_tensor(eia),
                                  torch.as_tensor(eia))
    e_ref, t2_ref = jax_mp2._emp2_from_ovov(jnp.asarray(g), jnp.asarray(eia))
    assert _rel(2 * d - x, e_ref) < 1e-12
    assert np.max(np.abs(t2.numpy() - np.asarray(t2_ref))) \
        <= 1e-13 * np.max(np.abs(np.asarray(t2_ref)))
    os_ref, ss_ref = jax_mp2._emp2_os_ss(jnp.asarray(g), jnp.asarray(eia))
    assert _rel(d, os_ref) < 1e-12 and _rel(d - x, ss_ref) < 1e-12
    # UMP2: alpha (4, 7), beta (3, 8), mixed (4, 7, 3, 8)
    gaa, ea, _ = _seeded_ovov(rng, 4, 7)
    gbb, eb, _ = _seeded_ovov(rng, 3, 8)
    gab = rng.standard_normal((4, 7, 3, 8)) * 0.1
    e_ss = 0.0
    for gs, es in ((gaa, ea), (gbb, eb)):
        _, d, x = kernels.mp2_energy(torch.as_tensor(gs), torch.as_tensor(es),
                                     torch.as_tensor(es), with_t2=False)
        e_ss += 0.5 * float(d - x)
    _, e_os, none = kernels.mp2_energy(
        torch.as_tensor(gab), torch.as_tensor(ea), torch.as_tensor(eb),
        exchange=False, with_t2=False)
    assert none is None
    ref = jax_ump2._emp2_uhf(*[jnp.asarray(a) for a in
                               (gaa, gbb, gab, ea, eb)])
    assert _rel(e_ss + float(e_os), ref[0]) < 1e-12
    assert _rel(e_os, ref[1]) < 1e-12 and _rel(e_ss, ref[2]) < 1e-12


def test_ao2mo_against_jax():
    """full and general on a seeded (8, 8, 8, 8) tensor against the JAX
    package's, 1e-12 of the largest value; restore s1 and its refusal."""
    rng = np.random.default_rng(4)
    eri = rng.standard_normal((8, 8, 8, 8))
    cs = [rng.standard_normal((8, k)) for k in (3, 5, 2, 8)]
    got = ao2mo.general(torch.as_tensor(eri), [torch.as_tensor(c)
                                                for c in cs])
    ref = np.asarray(jax_ao2mo.general(jnp.asarray(eri), cs))
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    got = ao2mo.kernel(torch.as_tensor(eri), torch.as_tensor(cs[3]))
    ref = np.asarray(jax_ao2mo.full(jnp.asarray(eri), cs[3]))
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    flat = torch.as_tensor(eri).reshape(64, 64)
    assert ao2mo.restore('s1', flat, 8).shape == (8, 8, 8, 8)
    with pytest.raises(NotImplementedError):
        ao2mo.restore(4, flat, 8)


def test_diis_against_jax():
    """Eight DIIS steps on seeded (t1, t2)-shaped vectors with a subspace
    of 4 (the oldest dropped from the fifth step on): the extrapolated
    vectors of the port and of the JAX DIIS agree to 1e-12 of their
    largest value."""
    rng = np.random.default_rng(5)
    ours, theirs = DIIS(4), JaxDIIS(4)
    for _ in range(8):
        x = [rng.standard_normal((3, 5)), rng.standard_normal((3, 3, 5, 5))]
        e = [0.1 * rng.standard_normal(a.shape) for a in x]
        got = ours.update(tuple(torch.as_tensor(a) for a in x),
                          tuple(torch.as_tensor(a) for a in e))
        ref = theirs.update(tuple(jnp.asarray(a) for a in x),
                            tuple(jnp.asarray(a) for a in e))
        for a, b in zip(got, ref):
            b = np.asarray(b)
            assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * np.abs(b).max()


@pytest.fixture(scope='module')
def water_rhf():
    """Water/cc-pVDZ in-core RHF (hcore guess, conv_tol 1e-12), the
    set-up of tests/test_postscf.py."""
    mf = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cpu').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    return mf


def test_mp2_golden(water_rhf):
    """mf.MP2().kernel() within 1e-8 of PySCF's golden; the SCS and SOS
    energies against _emp2_os_ss on the same (ia|jb), 1e-12 relative."""
    mp = water_rhf.MP2()
    e, t2 = mp.kernel()
    assert abs(e - GOLDEN_MP2) < 1e-8 and mp.e_tot < water_rhf.e_tot
    assert t2.shape == (5, 19, 5, 19)
    assert abs(mp.energy_scs(1.0, 1.0) - e) < 1e-12
    occ = water_rhf.mo_occ > 0
    eia = (water_rhf.mo_energy[occ][:, None]
           - water_rhf.mo_energy[~occ][None, :]).numpy()
    os_ref, ss_ref = jax_mp2._emp2_os_ss(jnp.asarray(mp.get_ovov().numpy()),
                                         jnp.asarray(eia))
    for p_os, p_ss in ((1.2, 1 / 3), (1.3, 0.0)):
        assert _rel(mp.energy_scs(p_os, p_ss),
                    p_os * os_ref + p_ss * ss_ref) < 1e-12


def test_mp2_frozen_against_jax(water_rhf):
    """frozen=1: the JAX package's _emp2_from_ovov on the port's own
    (ia|jb) without the 1s orbital, and its make_rdm1 and make_fno on the
    port's amplitudes, against the port's."""
    mp = water_rhf.MP2(frozen=1)
    e, t2 = mp.kernel()
    assert mp.nocc == 4 and t2.shape == (4, 19, 4, 19)
    occ = water_rhf.mo_occ > 0
    e_mo = water_rhf.mo_energy
    eia = (e_mo[occ][1:, None] - e_mo[~occ][None, :]).numpy()
    ovov = mp.get_ovov().numpy()
    ref, _ = jax_mp2._emp2_from_ovov(jnp.asarray(ovov), jnp.asarray(eia))
    assert _rel(e, ref) < 1e-12
    assert e > GOLDEN_MP2       # the core's correlation is left out
    jmp = SimpleNamespace(t2=jnp.asarray(t2.numpy()),
                          mo_occ=water_rhf.mo_occ.numpy(),
                          mo_coeff=water_rhf.mo_coeff.numpy())
    dm = mp.make_rdm1()
    dm_ref = np.asarray(jax_mp2.MP2.make_rdm1(jmp))
    assert np.max(np.abs(dm.numpy() - dm_ref)) < 1e-12
    assert abs(float(torch.trace(dm)) - 8.0) < 1e-10
    nv, c = mp.make_fno(thresh=1e-4)
    nv_ref, c_ref = jax_mp2.MP2.make_fno(jmp, thresh=1e-4)
    assert nv == nv_ref and 0 < nv < 19
    # natural orbitals are defined up to sign
    assert np.max(np.abs(np.abs(c) - np.abs(c_ref))) < 1e-9


def test_df_mp2_against_jax():
    """Water/cc-pVDZ DF-RHF (cc-pvdz-jkfit) then MP2, against the recorded
    JAX energy within 1e-8."""
    mf = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cpu').RHF() \
        .density_fit()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    assert abs(mf.MP2().kernel()[0] - refs.E_WATER_DF_MP2_CCPVDZ) < 1e-8


def test_ump2_against_jax():
    """The water cation's in-core UHF/def2-SVP then mf.MP2() (UMP2): the
    energy and its opposite- and same-spin parts within 1e-8 of the
    recorded JAX values; energy_scs(1, 1) is the energy."""
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1,
                device='cpu')
    mf = mol.UHF()
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    mp = mf.MP2()
    e, _ = mp.kernel()
    assert abs(e - refs.E_WATER_CATION_UMP2_DEF2SVP) < 1e-8
    os_ref, ss_ref = refs.E_WATER_CATION_UMP2_OS_SS_DEF2SVP
    assert abs(mp.e_corr_os - os_ref) < 1e-8
    assert abs(mp.e_corr_ss - ss_ref) < 1e-8
    assert abs(mp.energy_scs(1.0, 1.0) - e) < 1e-12
