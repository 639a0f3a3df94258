"""Record the JAX package's values that the port's CPU tests compare with
where the JAX run takes more than a few seconds (its first compiles on the
CPU), so that the fast tests read them instead of recomputing them:

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port_refs_record.py

writes pyscf_tpu_torch/data/port_refs.npz (about 15 minutes on the CPU) with,
water being refs.WATER:

  scf_*        tests/test_torch_scf.py: water/cc-pVDZ DF-RHF (minao, conv_tol
               1e-10): its energy 'scf_e', density 'scf_dm', DF factor
               'scf_B', sqrt(occ)-scaled occupied orbitals 'scf_co', and
               df_jk.get_jk's vj, vk and vk through the orbitals
               ('scf_vj', 'scf_vk', 'scf_vk_occ');
  df_factor    tests/test_torch_df.py: j3c.df_factor of water/def2-SVP;
  eri_svp_u    tests/test_torch_int2e.py: the legacy mol.intor('int2e') of
               water/def2-SVP, its elements (ij|kl) with i >= j, k >= l and
               ij >= kl (the test rebuilds the tensor);
  lr_*         tests/test_torch_rsh.py, omega 0.3: _j2c_whitener's
               long-range metric of water/def2-SVP 'lr_metric', the raw
               long-range rows of _class_program per bra class
               'lr_rows_<la><lb>', and water/sto-3g's int2e_dense(omega)
               of j2e.py 'lr_eri_j2e' and of the legacy engine
               'lr_eri_legacy';
  chunk_*      tests/test_torch_int_deriv.py: ipovlp_chunk, ipkin_chunk,
               ipnuc_chunk and iprinv_chunk on the test's seeded primitive
               pairs, 'chunk_<la><lb>_<name>';
  grad_*       tests/test_torch_grad.py: water/sto-3g in-core RHF (hcore,
               conv_tol 1e-12): its orbitals, the gradient of
               nuc_grad_method(), grad_elec and grad_nuc;
  ana_*        tests/test_torch_analysis.py: water/sto-3g RHF (hcore,
               conv_tol 1e-11) and the OH radical's UHF (conv_tol 1e-11):
               densities, dip_moment (Debye, au), quad_moment,
               mulliken_pop and, for OH, mulliken_spin_pop;
  uks_*        tests/test_torch_uks.py: the water cation's DF-UKS b3lypg
               (def2-SVP, grids level 1, minao, conv_tol 1e-10): energy,
               convergence and <S^2>;
  rks_*        tests/test_torch_dft.py: water DF-RKS b3lypg (def2-SVP, grids
               level 1, minao, conv_tol 1e-10): energy and convergence;
  o2_*         tests/test_torch_uks.py: O2/sto-3g (spin 2) in-core UHF (hcore,
               conv_tol 1e-10): energy, convergence and <S^2>;
  df_metric    tests/test_torch_df.py: _j2c_whitener's metric of water's
               def2-universal-jkfit (grouped aux order);
  int1e_r_svp  tests/test_torch_analysis.py: int1e_r of water/def2-SVP;
  int2e_ip1_sto3g  tests/test_torch_int_deriv.py: int2e_ip1 of water/sto-3g;
  wilson_*     tests/test_torch_geomopt.py: for refs.BENZENE and
               refs.PHENYL (sto-3g), q_func of detect_internals at the
               coordinates ('wilson_<atom>_q') and its jax.jacobian
               ('wilson_<atom>_B');
  rsh_*        tests/test_torch_rsh.py: the JAX energy densities and
               derivatives of the range-separated functionals and nr_uks
               of wB97X-V (rsh_refs's docstring; PYTHONPATH=.:tests), and
               the starting densities of its wB97X-V SCFs, the port's own
               (rsh_dm_refs);
  uks_dual*    tests/test_torch_uks.py: the JAX energy densities and
               derivatives that its dual numbers are held to
               (uks_dual_refs's docstring; PYTHONPATH=.:tests);
  grad_df_xc_* tests/test_torch_grad_df.py: the restricted XC quadrature's
               energy and gradient (grad_df_refs; PYTHONPATH=.:tests);
  eri_sto3g_legacy, int1e_ipkin_sto3g, int1e_ipnuc_sto3g
               tests/test_torch_int2e.py and test_torch_int_deriv.py:
               water/sto-3g matrices (int_matrix_refs);
  vv10_nr_*    tests/test_torch_vv10.py: the JAX nr_vv10 (vv10_refs;
               PYTHONPATH=.:tests);
  hermite_R_*  tests/test_torch_boys_hermite.py: the JAX hermite_R
               (hermite_refs; PYTHONPATH=.:tests);
  xc_closed_*  tests/test_torch_xc.py: the JAX closed-shell energy
               densities and derivatives, the PBE family's too (xc_refs;
               PYTHONPATH=.:tests);
  int1e_hcore_parts_ccpvdz  tests/test_torch_int1e.py: S, T, V of
               water/cc-pVDZ (int1e_refs);
  int2e_ip1_class_*  tests/test_torch_int_deriv.py: the JAX class blocks
               of int2e_ip1 (int_deriv_refs; PYTHONPATH=.:tests);
  pbe_*        tests/test_torch_hessian_uhf.py: the PBE family's energies
               and DF gradients (pbe_refs's docstring);
  fg_*         tests/test_torch_fg_shells.py: f, g and aux h shells (the
               docstrings of fg_water_refs and fg_neon_refs; '<key>_seconds'
               the seconds of each timed JAX run). The energies are also
               constants in pyscf_tpu_torch/refs.py.

Run with the names of the recording functions (scf_refs, ...) to record
only those into the existing file.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import pyscf_tpu as jpt
from pyscf_tpu.df.addons import make_auxmol as jax_make_auxmol
from pyscf_tpu.df.df_jk import get_jk as jax_get_jk
from pyscf_tpu.grad import rhf as jax_grad
from pyscf_tpu.ops.integrals import int1e_deriv as jax_deriv
from pyscf_tpu.ops.integrals import int2e as jax_int2e
from pyscf_tpu.ops.integrals import j2e as jax_j2e
from pyscf_tpu.ops.integrals import j3c as jj3c

WATER = 'O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587'
OMEGA = 0.3
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyscf_tpu_torch', 'data', 'port_refs.npz')


def chunk_prims(seed, m=6):
    """tests/test_torch_int_deriv.py's _prims."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, m), rng.uniform(0.3, 3.0, m),
            rng.normal(size=(m, 3)), rng.normal(size=(m, 3)),
            rng.normal(size=m))


def eri_unique(eri):
    n = eri.shape[0]
    i, j = np.tril_indices(n)
    pair = eri[i, j][:, i, j]                 # (npair, npair)
    p, q = np.tril_indices(pair.shape[0])
    return pair[p, q]


def scf_refs(out):
    mol = jpt.M(atom=WATER, basis='cc-pvdz', verbose=0)
    mf = mol.RHF().density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mf.converged
    occ = np.asarray(mf.mo_occ)
    co = np.asarray(mf.mo_coeff)[:, occ > 0] * np.sqrt(occ[occ > 0])
    dm = np.asarray(mf.make_rdm1())
    vj, vk = jax_get_jk(mf.with_df, jnp.asarray(dm))
    _, vk_occ = jax_get_jk(mf.with_df, jnp.asarray(dm),
                           mo_coeff_occ=jnp.asarray(co))
    out.update(scf_e=e, scf_dm=dm, scf_B=np.asarray(mf.with_df.cderi),
               scf_co=co, scf_vj=np.asarray(vj), scf_vk=np.asarray(vk),
               scf_vk_occ=np.asarray(vk_occ))


def integral_refs(out):
    mol = jpt.M(atom=WATER, basis='def2-svp', verbose=0)
    auxmol = jax_make_auxmol(mol)
    out['df_factor'] = np.asarray(jj3c.df_factor(mol, auxmol))
    out['eri_svp_u'] = eri_unique(np.asarray(mol.intor('int2e')))
    meta, raw = jj3c._aux_meta(auxmol)
    aux_data = jj3c._aux_prep(meta, tuple(
        (jnp.asarray(e), jnp.asarray(c), jnp.asarray(r)) for e, c, r in raw))
    out['lr_metric'] = np.asarray(jj3c._j2c_whitener(
        meta, aux_data, rs_omega=OMEGA)[0])
    eye = jnp.eye(auxmol.nao)
    for (la, lb), bc in jj3c._bra_classes(mol).items():
        if not bc.nsel:
            continue
        npc, tiles = jj3c._class_tiles(bc, meta)
        arrays, _ = bc.chunk_arrays(npc)
        out[f'lr_rows_{la}{lb}'] = np.asarray(jj3c._class_program(
            la, lb, meta, tiles, *[jnp.asarray(a) for a in arrays],
            aux_data, eye, rs_omega=OMEGA))[:bc.nsel * bc.da * bc.db]
    mj = jpt.M(atom=WATER, basis='sto-3g', verbose=0)
    out['lr_eri_j2e'] = np.asarray(jax_j2e.int2e_dense(mj, OMEGA))
    out['lr_eri_legacy'] = np.asarray(jax_int2e.int2e(mj, omega=OMEGA))
    for la in range(3):
        for lb in range(3):
            a, b, A, B, w = chunk_prims(10 * la + lb)
            rng = np.random.default_rng(99)
            zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)
            k = f'chunk_{la}{lb}'
            out[f'{k}_ipovlp'] = np.asarray(
                jax_deriv.ipovlp_chunk(la, lb, a, b, A, B, w))
            out[f'{k}_ipkin'] = np.asarray(
                jax_deriv.ipkin_chunk(la, lb, a, b, A, B, w))
            out[f'{k}_ipnuc'] = np.asarray(
                jax_deriv.ipnuc_chunk(la, lb, a, b, A, B, w, zr, zq))
            out[f'{k}_iprinv'] = np.asarray(
                jax_deriv.iprinv_chunk(la, lb, a, b, A, B, w, zr[3]))


def grad_refs(out):
    mf = jpt.M(atom=WATER, basis='sto-3g', verbose=0).RHF()
    mf.verbose = 0
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    out.update(grad_mo_energy=np.asarray(mf.mo_energy),
               grad_mo_coeff=np.asarray(mf.mo_coeff),
               grad_mo_occ=np.asarray(mf.mo_occ),
               grad_de=np.asarray(mf.nuc_grad_method().kernel()),
               grad_elec=np.asarray(jax_grad.grad_elec(mf)),
               grad_nuc=np.asarray(jax_grad.grad_nuc(mf.mol)))


def analysis_refs(out):
    rhf = jpt.M(atom=WATER, basis='sto-3g', verbose=0).RHF()
    rhf.init_guess = 'hcore'
    rhf.conv_tol = 1e-11
    rhf.kernel()
    uhf = jpt.M(atom='O 0 0 0; H 0 0 0.97', basis='sto-3g', spin=1,
                verbose=0).UHF()
    uhf.conv_tol = 1e-11
    uhf.kernel()
    for tag, mf in (('rhf', rhf), ('uhf', uhf)):
        assert mf.converged
        dm = mf.make_rdm1()
        k = f'ana_{tag}'
        out[f'{k}_dm'] = np.asarray(dm)
        out[f'{k}_dip_debye'] = np.asarray(mf.dip_moment(dm=dm, unit='Debye'))
        out[f'{k}_dip_au'] = np.asarray(mf.dip_moment(dm=dm, unit='au'))
        out[f'{k}_quad'] = np.asarray(mf.quad_moment(dm=dm))
        pop, chg = mf.mulliken_pop(dm=dm)
        out[f'{k}_pop'], out[f'{k}_chg'] = np.asarray(pop), np.asarray(chg)
    pop, spin = uhf.mulliken_spin_pop(dm=uhf.make_rdm1())
    out['ana_uhf_spin_pop'], out['ana_uhf_spin'] = (np.asarray(pop),
                                                    np.asarray(spin))


def scf_energy_refs(out):
    mf = jpt.M(atom=WATER, basis='def2-svp', charge=1, spin=1,
               verbose=0).UKS(xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-10
    out['uks_e'] = mf.kernel()
    out['uks_converged'] = mf.converged
    out['uks_s2'] = mf.spin_square()[0]
    mf = jpt.M(atom=WATER, basis='def2-svp', verbose=0).RKS(
        xc='b3lypg').density_fit()
    mf.grids.level = 1
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-10
    out['rks_e'] = mf.kernel()
    out['rks_converged'] = mf.converged


def more_refs(out):
    from pyscf_tpu.geomopt import internal as jax_internal
    from pyscf_tpu.ops.integrals.int1e import int1e_r as jax_int1e_r
    mf = jpt.scf.UHF(jpt.M(atom='O 0 0 0; O 0 0 1.21', basis='sto-3g',
                           spin=2, verbose=0))
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-10
    out['o2_e'] = mf.kernel()
    out['o2_converged'] = mf.converged
    out['o2_s2'] = mf.spin_square()[0]
    mol = jpt.M(atom=WATER, basis='def2-svp', verbose=0)
    meta, raw = jj3c._aux_meta(jax_make_auxmol(mol))
    aux_data = jj3c._aux_prep(meta, tuple(
        (jnp.asarray(e), jnp.asarray(c), jnp.asarray(r)) for e, c, r in raw))
    out['df_metric'] = np.asarray(jj3c._j2c_whitener(meta, aux_data)[0])
    out['int1e_r_svp'] = np.asarray(jax_int1e_r(mol))
    out['int2e_ip1_sto3g'] = np.asarray(jax_int2e.int2e_ip1(
        jpt.M(atom=WATER, basis='sto-3g', verbose=0)))
    import pyscf_tpu_torch.refs as port_refs
    for name in ('BENZENE', 'PHENYL'):
        jmol = jpt.M(atom=getattr(port_refs, name), basis='sto-3g',
                     verbose=0)
        jq = jax_internal.q_func(*jax_internal.detect_internals(jmol))
        x = jnp.asarray(np.asarray(jmol.coords))
        out[f'wilson_{name}_q'] = np.asarray(jq(x))
        out[f'wilson_{name}_B'] = np.asarray(jax.jacobian(jq)(x))


def pbe_refs(out):
    """The PBE family (tests/test_torch_hessian_uhf.py): water/sto-3g
    DF-RKS PBE0 and PBE and the water cation's (charge 1, spin 1) DF-UKS
    PBE0, each on the level-0 grid (minao, conv_tol 1e-12, conv_tol_grad
    1e-9): 'pbe_<case>_e' and, for the PBE0 cases, the DF gradient
    'pbe_<case>_grad'. (The OH radical's DF-UKS PBE0 converges in neither
    package on these grids: its beta pi hole drifts.)"""
    for case, charge, xc_code, grad in (('pbe0_rks', 0, 'pbe0', True),
                                        ('pbe_rks', 0, 'pbe', False),
                                        ('pbe0_uks', 1, 'pbe0', True)):
        mol = jpt.M(atom=WATER, basis='sto-3g', charge=charge, spin=charge,
                    verbose=0)
        mf = (mol.UKS if charge else mol.RKS)(xc=xc_code).density_fit()
        mf.grids.level = 0
        mf.init_guess = 'minao'
        mf.conv_tol = 1e-12
        mf.conv_tol_grad = 1e-9
        out[f'pbe_{case}_e'] = mf.kernel()
        assert mf.converged
        if grad:
            out[f'pbe_{case}_grad'] = np.asarray(mf.Gradients().kernel())


def rsh_refs(out):
    """tests/test_torch_rsh.py's JAX values, seconds each in JAX's eager
    dispatch: for every name of its RSH_NAMES the open-shell energy
    density and its five derivatives at _open_inputs ('rsh_open_<name>',
    (6, n)) and the closed-shell e, vrho, vsigma at _closed_inputs
    ('rsh_closed_<name>', (3, 300)), and nr_uks of wB97X-V at its seeded
    spin density ('rsh_nr_uks_n', '_e', '_v'). Needs tests/ on the path
    (PYTHONPATH=.:tests)."""
    import test_torch_rsh as t
    for name in t.RSH_NAMES:
        e, g = t._jax_open(name, t._open_inputs())
        out[f'rsh_open_{name}'] = np.stack([e] + g)
        out[f'rsh_closed_{name}'] = np.stack(
            t._jax_closed(name, t._closed_inputs()))
    n, e, v = t.jax_nr_uks_wb97xv()
    out.update(rsh_nr_uks_n=n, rsh_nr_uks_e=e, rsh_nr_uks_v=v)


def rsh_dm_refs(out):
    """tests/test_torch_rsh.py's starting densities of its two wB97X-V
    SCFs (water DF-RKS and the cation's DF-UKS, def2-SVP, level-1 grids),
    the port's own converged densities at conv_tol 1e-10
    ('rsh_dm_wb97xv_<spin>'): from them the test's SCFs take a few cycles
    of VV10 in place of the whole run (~30 s each on the CPU). The energy
    they reach is held to the recorded JAX energy as before."""
    import pyscf_tpu_torch as tpt
    from pyscf_tpu_torch import refs
    for spin in (0, 1):
        mol = tpt.M(atom=refs.WATER, basis='def2-svp', charge=spin,
                    spin=spin, device='cpu')
        mf = (mol.UKS(xc='wb97x-v') if spin
              else mol.RKS(xc='wb97x-v')).density_fit()
        mf.grids.level = 1
        mf.conv_tol = 1e-10
        mf.kernel()
        assert mf.converged
        out[f'rsh_dm_wb97xv_{spin}'] = mf.make_rdm1().numpy()


def uks_dual_refs(out):
    """tests/test_torch_uks.py's JAX energy densities and derivatives,
    seconds each in JAX's eager dispatch: jax_dual5 at _open_inputs
    ('uks_dual5_<name>', (6, 300)) and jax_dual2 at _closed_inputs
    ('uks_dual2_<name>', (3, 300)). Needs tests/ on the path
    (PYTHONPATH=.:tests)."""
    import test_torch_uks as t
    for name in t.DUAL5_NAMES:
        out[f'uks_dual5_{name}'] = t.jax_dual5(name, t._open_inputs())
    for name in t.DUAL2_NAMES:
        out[f'uks_dual2_{name}'] = t.jax_dual2(name, t._closed_inputs())


def grad_df_refs(out):
    """tests/test_torch_grad_df.py's jax_xc_grad (~6 s of jit): exc
    'grad_df_xc_exc' and its gradient 'grad_df_xc_grad' (natm, 3). Needs
    tests/ on the path (PYTHONPATH=.:tests)."""
    import test_torch_grad_df as t
    out['grad_df_xc_exc'], out['grad_df_xc_grad'] = t.jax_xc_grad(
        t._water_grid())


def int_matrix_refs(out):
    """Water/sto-3g's JAX matrices that tests read as data: the legacy
    mol.intor('int2e') 'eri_sto3g_legacy' (tests/test_torch_int2e.py's
    assigned tensor) and int1e_ipkin, int1e_ipnuc 'int1e_<name>_sto3g'
    (tests/test_torch_int_deriv.py), seconds of compiles each."""
    import pyscf_tpu as jpt
    from pyscf_tpu.ops.integrals import int1e_deriv
    from pyscf_tpu_torch import refs
    mol = jpt.M(atom=refs.WATER, basis='sto-3g', verbose=0)
    out['eri_sto3g_legacy'] = np.asarray(mol.intor('int2e'))
    for name in ('int1e_ipkin', 'int1e_ipnuc'):
        out[f'{name}_sto3g'] = np.asarray(getattr(int1e_deriv, name)(mol))


def vv10_refs(out):
    """tests/test_torch_vv10.py's JAX nr_vv10 (jax_nr_vv10): 'vv10_nr_e',
    'vv10_nr_v'. Needs tests/ on the path (PYTHONPATH=.:tests)."""
    import test_torch_vv10 as t
    out['vv10_nr_e'], out['vv10_nr_v'] = t.jax_nr_vv10()


def hermite_refs(out):
    """tests/test_torch_boys_hermite.py's jax_hermite_R for L = 0..8
    ('hermite_R_<L>', (300, n_tuv(L))). Needs tests/ on the path
    (PYTHONPATH=.:tests)."""
    import test_torch_boys_hermite as t
    for L in range(9):
        out[f'hermite_R_{L}'] = t.jax_hermite_R(L)


def xc_refs(out):
    """tests/test_torch_xc.py's _jax_closed at _inputs for every name of
    its NAMES and PBE_NAMES ('xc_closed_<name>', (3, 404): e, vrho,
    vsigma). Needs tests/ on the path (PYTHONPATH=.:tests)."""
    import test_torch_xc as t
    for name in t.NAMES + t.PBE_NAMES:
        out[f'xc_closed_{name}'] = np.stack(t._jax_closed(name,
                                                          *t._inputs()))


def int1e_refs(out):
    """tests/test_torch_int1e.py's S, T and V of water/cc-pVDZ, the JAX
    package's j1e.hcore_parts ('int1e_hcore_parts_ccpvdz', (3, 24, 24);
    ~8 s of compiles)."""
    import pyscf_tpu as jpt
    from pyscf_tpu.ops.integrals.j1e import hcore_parts
    from pyscf_tpu_torch import refs
    mol = jpt.M(atom=refs.WATER, basis='cc-pvdz', verbose=0)
    out['int1e_hcore_parts_ccpvdz'] = np.asarray(hcore_parts(mol))


def int_deriv_refs(out):
    """tests/test_torch_int_deriv.py's jax_int2e_ip1_class for each case
    of its INT2E_IP1_CLASSES ('int2e_ip1_class_<la><lb><lc><ld>'; one JAX
    program each, seconds of compile). Needs tests/ on the path
    (PYTHONPATH=.:tests)."""
    import test_torch_int_deriv as t
    for (la, lb), (lc, ld) in t.INT2E_IP1_CLASSES:
        out[f'int2e_ip1_class_{la}{lb}{lc}{ld}'] = t.jax_int2e_ip1_class(
            (la, lb), (lc, ld))


def _raw_rows(mol, auxmol, la, lb):
    """The raw (ij|P) rows of _class_program for one bra class (identity
    whitener), the screened pairs only."""
    meta, raw = jj3c._aux_meta(auxmol)
    aux_data = jj3c._aux_prep(meta, tuple(
        (jnp.asarray(e), jnp.asarray(c), jnp.asarray(r)) for e, c, r in raw))
    bc = jj3c._bra_classes(mol)[(la, lb)]
    npc, tiles = jj3c._class_tiles(bc, meta)
    arrays, _ = bc.chunk_arrays(npc)
    return np.asarray(jj3c._class_program(
        la, lb, meta, tiles, *[jnp.asarray(a) for a in arrays], aux_data,
        jnp.eye(auxmol.nao)))[:bc.nsel * bc.da * bc.db]


def _timed(out, key, fn):
    import time
    t0 = time.perf_counter()
    value = fn()
    out[f'{key}_seconds'] = time.perf_counter() - t0
    print(key, repr(value) if np.ndim(value) == 0 else np.shape(value),
          f'{out[key + "_seconds"]:.1f} s', flush=True)
    return value


def fg_water_refs(out):
    """tests/test_torch_fg_shells.py, f shells: water/cc-pVTZ (aux
    cc-pvtz-jkfit, to g) DF-RHF (minao, conv_tol 1e-10) 'fg_tz_rhf_e' and
    DF-RKS b3lypg (grids level 1) 'fg_tz_rks_e', water/def2-TZVP DF-RKS
    b3lypg 'fg_tzvp_rks_e'; water/cc-pVTZ's hcore_parts 'fg_tz_stv',
    mol.intor of 'int1e_ovlp', 'int1e_kin', 'int1e_nuc' and 'int2c2e'
    ('fg_tz_intor_<name>')."""
    from pyscf_tpu.ops.integrals import j1e as jax_j1e
    mol = jpt.M(atom=WATER, basis='cc-pvtz', verbose=0)

    def scf(mf):
        mf.init_guess = 'minao'
        mf.conv_tol = 1e-10
        e = mf.kernel()
        assert mf.converged
        return e

    out['fg_tz_rhf_e'] = _timed(out, 'fg_tz_rhf_e', lambda: scf(
        mol.RHF().density_fit()))
    for key, basis in (('fg_tz_rks_e', 'cc-pvtz'),
                       ('fg_tzvp_rks_e', 'def2-tzvp')):
        mf = jpt.M(atom=WATER, basis=basis, verbose=0).RKS(
            xc='b3lypg').density_fit()
        mf.grids.level = 1
        out[key] = _timed(out, key, lambda: scf(mf))
    mol = jpt.M(atom=WATER, basis='cc-pvtz', verbose=0)
    out['fg_tz_stv'] = np.asarray(jax_j1e.hcore_parts(mol))
    for name in ('int1e_ovlp', 'int1e_kin', 'int1e_nuc', 'int2c2e'):
        out[f'fg_tz_intor_{name}'] = np.asarray(mol.intor(name))


NEON = 'Ne 0 0 0'


def _neon_class_rows(bra):
    """The rows of j2e.py's _class_pair_program of one bra class of
    Ne/cc-pVQZ against every ket class, as int2e_dense calls it (the other
    bra classes' programs replaced by zeros of their shape): (bra,
    {(lc, ld): rows})."""
    real = jax_j2e._class_pair_program
    rows = {}

    def one(la, lb, lc, ld, npk, *arrays, rs_omega=None):
        if (la, lb) != bra:
            return jnp.zeros((arrays[0].shape[0] * arrays[0].shape[1]
                              * (2 * la + 1) * (2 * lb + 1),
                              arrays[6].shape[0] * (2 * lc + 1)
                              * (2 * ld + 1)))
        out = real(la, lb, lc, ld, npk, *arrays, rs_omega=rs_omega)
        rows[(lc, ld)] = np.asarray(out)
        return out

    jax_j2e._class_pair_program = one
    try:
        jax_j2e.int2e_dense(jpt.M(atom=NEON, basis='cc-pvqz', verbose=0))
    finally:
        jax_j2e._class_pair_program = real
    return bra, rows


def fg_neon_refs(out):
    """tests/test_torch_fg_shells.py, g shells: Ne/cc-pVQZ's ERI tensor from
    j2e.py's int2e_dense (the engine of PYSCF_TPU_INT2E=v2), its (gg|..)
    block, the g AOs as bra and the f and g AOs as ket, 'fg_ne_eri_gg';
    in-core RHF on it (minao, conv_tol 1e-12, conv_tol_grad 1e-9) 'fg_ne_e'
    with MP2 'fg_ne_mp2', CCSD (conv_tol 1e-10, conv_tol_normt 1e-8)
    'fg_ne_ccsd' and (T) 'fg_ne_t'; the raw rows of the (gg) bra class
    against cc-pvqz-jkfit (to h) 'fg_ne_rows_44'.

    Run with XLA_FLAGS=--xla_disable_hlo_passes=constant_folding: XLA's
    constant folding of the (gg|..) classes' one-hot combination tensor
    took more than 16 GB of the CPU's memory (for j2e.py and for the
    default engine, ops/integrals/int2e.py); without it the (gg|gg)
    program compiles in 12 s. Each bra class's fifteen class-pair programs
    compile in a process of their own: the 225 programs of one process ran
    out of its memory maps (LLVM 'Cannot allocate memory')."""
    import multiprocessing
    if 'constant_folding' not in os.environ.get('XLA_FLAGS', ''):
        raise SystemExit('fg_neon_refs needs XLA_FLAGS='
                         '--xla_disable_hlo_passes=constant_folding')
    mol = jpt.M(atom=NEON, basis='cc-pvqz', verbose=0)
    classes = [k for k, bc in jj3c._bra_classes(mol).items() if bc.nsel]
    with multiprocessing.get_context('spawn').Pool(
            3, maxtasksperchild=1) as pool:
        pieces = dict(pool.map(_neon_class_rows, classes, chunksize=1))
    real = jax_j2e._class_pair_program
    jax_j2e._class_pair_program = (
        lambda la, lb, lc, ld, *a, **k:
        jnp.asarray(pieces[(la, lb)][(lc, ld)]))
    try:
        eri = jax_j2e.int2e_dense(mol)
    finally:
        jax_j2e._class_pair_program = real
    g = np.arange(mol.nao - 9, mol.nao)          # the last shell is the g
    fg = np.arange(mol.nao - 23, mol.nao)        # two f shells before it
    out['fg_ne_eri_gg'] = np.asarray(eri)[np.ix_(g, g, fg, fg)]
    mf = mol.RHF()
    mf._eri = eri
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    out['fg_ne_e'] = _timed(out, 'fg_ne_e', mf.kernel)
    assert mf.converged
    out['fg_ne_mp2'] = _timed(out, 'fg_ne_mp2',
                              lambda: jpt.mp.MP2(mf).kernel()[0])
    cc = jpt.cc.CCSD(mf)
    cc.conv_tol = 1e-10
    cc.conv_tol_normt = 1e-8
    out['fg_ne_ccsd'] = _timed(out, 'fg_ne_ccsd', lambda: cc.kernel()[0])
    assert cc.converged
    out['fg_ne_t'] = _timed(out, 'fg_ne_t', cc.ccsd_t)
    out['fg_ne_rows_44'] = _raw_rows(mol, jax_make_auxmol(mol), 4, 4)


def fg_df_functionals(mol, auxmol, seed=11):
    """jax.grad of tests/test_torch_grad_df.py's seeded DF functionals (the
    3c one of autodiff._df_intermediates, the 2c one of _j2c) at the
    coordinates: ('3c', '2c')."""
    from pyscf_tpu.grad import autodiff
    pairs, auxes = autodiff._build_host_data_cached(mol, auxmol)
    nao, naux = mol.nao, auxmol.nao
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((nao, 3)) * 0.3
    D = 2 * C @ C.T
    a = rng.standard_normal(naux)
    b = rng.standard_normal((naux, 3, 3))
    b = b + b.transpose(0, 2, 1)
    W = rng.standard_normal((naux, naux))
    W = W + W.T
    dm_blocks = [sp.mat_blocks(D) for sp in pairs]
    co_sets = [[sp.co_blocks(C) for sp in pairs]]

    def f3(X):
        gam, Os = autodiff._df_intermediates(pairs, auxes, naux, X,
                                             dm_blocks, co_sets)
        return jnp.dot(gam, a) + jnp.sum(Os[0] * b)

    def f2(X):
        return jnp.sum(autodiff._j2c(auxes, naux, X) * W)

    X = jnp.asarray(np.asarray(mol.coords))
    return (np.asarray(jax.jit(jax.grad(f3))(X)),
            np.asarray(jax.jit(jax.grad(f2))(X)))


def _grad_inputs(basis, state):
    """mol, pairs, auxes and the blocks of autodiff.build_grad_fn's fn for
    the restricted state (mo_coeff, mo_occ, mo_energy, dm) of water/basis
    with its default aux basis."""
    from pyscf_tpu.grad import autodiff
    mol = jpt.M(atom=WATER, basis=basis, verbose=0)
    pairs, auxes = autodiff._build_host_data_cached(mol,
                                                     jax_make_auxmol(mol))
    mo_coeff, mo_occ, mo_energy, dm = state
    sel = mo_occ > 0
    co = mo_coeff[:, sel] * np.sqrt(mo_occ[sel])
    wdm = (mo_coeff[:, sel] * (mo_occ[sel] * mo_energy[sel])) \
        @ mo_coeff[:, sel].T
    return (mol, pairs, auxes, [sp.mat_blocks(dm) for sp in pairs],
            [sp.mat_blocks(wdm) for sp in pairs],
            [[sp.co_blocks(co) for sp in pairs]])


def _grad_piece(task):
    """One term of autodiff.build_grad_fn's jax.value_and_grad(energy), in
    a process of its own: 'fwd' (gamma and O of one pair class, and the
    metric with the first), '1e' (jax.grad of one pair class's
    _one_electron), '3c' (jax.grad of one pair class's gamma and O
    contracted with their cotangents), '2c' (jax.grad of _j2c contracted
    with its cotangent) or 'xc' (jax.grad of _exc_quadrature)."""
    from pyscf_tpu.grad import autodiff
    kind, basis, xc, state, ip, extra = task
    mol, pairs, auxes, dmb, wb, co_sets = _grad_inputs(basis, state)
    naux = sum(ax.cols.size for ax in auxes)
    X0 = jnp.asarray(np.asarray(mol.coords))
    natm = mol.natm
    natm_pad = -(-natm // autodiff.ATOM_PAD) * autodiff.ATOM_PAD
    Z = jnp.asarray(np.asarray(mol.charges, dtype=np.float64))

    def df(X):
        return autodiff._df_intermediates(
            [pairs[ip]], auxes, naux, X, [dmb[ip]],
            [[cs[ip]] for cs in co_sets])

    if kind == 'fwd':
        gam, Os = jax.jit(df)(X0)
        j2c = autodiff._j2c(auxes, naux, X0) if ip == 0 else None
        return np.asarray(gam), [np.asarray(o) for o in Os], (
            None if j2c is None else np.asarray(j2c))
    if kind == '1e':
        def f(X):
            Xpad = jnp.zeros((natm_pad, 3)).at[:natm].set(X)
            Zpad = jnp.zeros(natm_pad).at[:natm].set(Z)
            return autodiff._one_electron([pairs[ip]], X, [dmb[ip]],
                                          [wb[ip]], Xpad, Zpad)
    elif kind == '3c':
        gbar, obars = extra

        def f(X):
            gam, Os = df(X)
            return jnp.dot(gam, gbar) + sum(jnp.sum(o * b)
                                            for o, b in zip(Os, obars))
    elif kind == '2c':
        def f(X):
            return jnp.sum(autodiff._j2c(auxes, naux, X) * extra)
    else:
        from pyscf_tpu.dft import xc as xc_mod
        coords, weights = extra

        def f(X):
            return autodiff._exc_quadrature(
                mol, xc_mod.parse_xc(xc), X, jnp.asarray(state[3]),
                jnp.asarray(coords), jnp.asarray(weights), True)
    return np.asarray(jax.jit(jax.grad(f))(X0))


def _fg_gradient(out, key, basis, xc):
    """The JAX package's DF-RHF or DF-RKS gradient of water/basis, minao,
    conv_tol 1e-12, conv_tol_grad 1e-9, as autodiff.build_grad_fn builds it
    but term by term: its one traced program at f shells uses up the
    memory maps of the process (LLVM 'Cannot allocate memory'). The energy
    is a sum over pair classes (the one-electron terms, gamma and O) and
    the metric, so jax.grad of each term runs in a process of its own, the
    DF terms against the cotangents of 0.5 |L^-1 gamma|^2 - 1/4 hyb sum
    |L^-1 O|^2 at the converged geometry (jax.grad in gamma, O and the
    metric); the nuclear repulsion's and the XC quadrature's (fixed grid)
    are added."""
    import multiprocessing
    from pyscf_tpu.grad import autodiff
    if 'constant_folding' not in os.environ.get('XLA_FLAGS', ''):
        raise SystemExit('the fg_* recordings need XLA_FLAGS='
                         '--xla_disable_hlo_passes=constant_folding')
    mol = jpt.M(atom=WATER, basis=basis, verbose=0)
    mf = (mol.RKS(xc=xc) if xc else mol.RHF()).density_fit()
    if xc:
        mf.grids.level = 1
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    out[f'{key}_e'] = _timed(out, f'{key}_e', mf.kernel)
    assert mf.converged
    state = tuple(np.asarray(x) for x in (mf.mo_coeff, mf.mo_occ,
                                          mf.mo_energy, mf.make_rdm1()))
    hyb = float(mf._numint.hybrid_coeff(mf.xc)) if xc else 1.0
    npair = len(_grad_inputs(basis, state)[1])

    def run(tasks):
        with multiprocessing.get_context('spawn').Pool(
                3, maxtasksperchild=1) as pool:
            return pool.map(_grad_piece, tasks, chunksize=1)

    def gradient():
        fwd = run([('fwd', basis, xc, state, ip, None)
                   for ip in range(npair)])
        gam = sum(f[0] for f in fwd)
        Os = [sum(f[1][k] for f in fwd) for k in range(len(fwd[0][1]))]

        def e_df(g, os_, j2c):
            L = jnp.linalg.cholesky(j2c)
            u = jax.scipy.linalg.solve_triangular(L, g, lower=True)
            e = 0.5 * jnp.dot(u, u)
            for O in os_:
                no = O.shape[-1]
                V = jax.scipy.linalg.solve_triangular(
                    L, O.reshape(-1, no * no), lower=True)
                e = e - 0.25 * hyb * jnp.sum(V * V)
            return e

        gbar, obars, jbar = jax.grad(e_df, argnums=(0, 1, 2))(
            jnp.asarray(gam), [jnp.asarray(o) for o in Os],
            jnp.asarray(fwd[0][2]))
        extra3c = (np.asarray(gbar), [np.asarray(o) for o in obars])
        tasks = [('1e', basis, xc, state, ip, None) for ip in range(npair)]
        tasks += [('3c', basis, xc, state, ip, extra3c)
                  for ip in range(npair)]
        tasks.append(('2c', basis, xc, state, 0, np.asarray(jbar)))
        if xc:
            from pyscf_tpu.dft.numint import _pad_grid
            tasks.append(('xc', basis, xc, state, 0, tuple(
                np.asarray(a) for a in _pad_grid(mf.grids.coords,
                                                 mf.grids.weights))))
        X = jnp.asarray(np.asarray(mol.coords))
        Z = jnp.asarray(np.asarray(mol.charges, dtype=np.float64))
        return (np.asarray(jax.grad(autodiff._enuc)(X, Z))
                + sum(run(tasks)))

    out[key] = _timed(out, key, gradient)


def fg_grad_tz_refs(out):
    """tests/test_torch_fg_deriv.py: water/cc-pVTZ DF-RHF (cc-pvtz-jkfit;
    minao, conv_tol 1e-12, conv_tol_grad 1e-9; converged) and its gradient
    'fg_grad_tz_rhf', energy 'fg_grad_tz_rhf_e'. Run with
    XLA_FLAGS=--xla_disable_hlo_passes=constant_folding, in a process of
    its own (the gradient's programs use up one process's memory maps)."""
    _fg_gradient(out, 'fg_grad_tz_rhf', 'cc-pvtz', None)


def fg_grad_tzvp_refs(out):
    """The same for water/def2-TZVP DF-RKS b3lypg (grids level 1, held
    fixed) 'fg_grad_tzvp_rks'."""
    _fg_gradient(out, 'fg_grad_tzvp_rks', 'def2-tzvp', 'b3lypg')


def fg_grad_refs(out):
    """tests/test_torch_fg_deriv.py: the g rows of the derivative programs:
    ipovlp_chunk, ipkin_chunk, ipnuc_chunk and iprinv_chunk of the (g, f)
    class on tests/test_torch_int_deriv.py's seeded primitive pairs
    ('fg_chunk_43_<name>'), jax.grad of the seeded DF functionals of
    tests/test_torch_grad_df.py on tests/hessian_refs_record.py's FG_BASIS
    with FG_AUX ('fg_df_3c', 'fg_df_2c': (gg|h), (fg|s) and (h|h) among
    the classes).

    Run with XLA_FLAGS=--xla_disable_hlo_passes=constant_folding (as
    fg_neon_refs)."""
    if 'constant_folding' not in os.environ.get('XLA_FLAGS', ''):
        raise SystemExit('fg_grad_refs needs XLA_FLAGS='
                         '--xla_disable_hlo_passes=constant_folding')
    a, b, A, B, w = chunk_prims(43)
    rng = np.random.default_rng(99)
    zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)
    k = 'fg_chunk_43'
    out[f'{k}_ipovlp'] = np.asarray(jax_deriv.ipovlp_chunk(4, 3, a, b, A, B,
                                                           w))
    out[f'{k}_ipkin'] = np.asarray(jax_deriv.ipkin_chunk(4, 3, a, b, A, B, w))
    out[f'{k}_ipnuc'] = np.asarray(jax_deriv.ipnuc_chunk(4, 3, a, b, A, B, w,
                                                         zr, zq))
    out[f'{k}_iprinv'] = np.asarray(jax_deriv.iprinv_chunk(4, 3, a, b, A, B,
                                                           w, zr[3]))
    from hessian_refs_record import FG_ATOMS, FG_AUX, FG_BASIS
    mol = jpt.M(atom=FG_ATOMS, basis=FG_BASIS, verbose=0)
    auxmol = jpt.M(atom=FG_ATOMS, basis=FG_AUX, verbose=0)
    out['fg_df_3c'], out['fg_df_2c'] = _timed(
        out, 'fg_df', lambda: fg_df_functionals(mol, auxmol))


def fg_ip1_refs(out):
    """tests/test_torch_fg_deriv.py: the (gs|sg) block of int2e.py
    _deriv_class_pair_block (DerivPairClass of the (g, s) bra, the cart
    blocks) on a g and an s shell on each of two centres 'fg_ip1_gssg'
    (the (gg|gg) block's program was killed compiling on the CPU). Run
    with XLA_FLAGS=--xla_disable_hlo_passes=constant_folding, in a process
    of its own."""
    gs = jpt.M(atom='He 0 0 0; He 0.3 -0.4 1.1',
               basis=[[4, [0.6, 1.0]], [0, [1.3, 1.0]]], verbose=0)
    out['fg_ip1_gssg'] = _timed(out, 'fg_ip1_gssg', lambda: np.asarray(
        jax_int2e._deriv_class_pair_block(jax_int2e.DerivPairClass(gs, 4, 0),
                                          jax_int2e.PairClass(gs, 0, 4))))


def fg_f_refs(out):
    """tests/test_torch_fg_deriv.py's f-class JAX values (each module's
    live comparison stays at s to d in test_torch_int_deriv.py,
    test_torch_grad_df.py and test_torch_hessian.py): the four 1e chunks
    of the (f, s) class on its seeded primitive pairs ('fg_chunk_30_<name>'),
    jax.grad of the seeded DF functionals on its (ff|s) system
    ('fg_df_f_3c', 'fg_df_f_2c'), the (fs|sf) block of
    _deriv_class_pair_block ('fg_ip1_fssf') and the bra-centre Hessian of
    the 1e energy of the (f, s) class ('fg_ipip_30'). Needs tests/ on the
    path (PYTHONPATH=.:tests); ~30 s."""
    import test_torch_fg_deriv as t
    from pyscf_tpu.ops.integrals import int1e as jax_int1e
    from hessian_refs_record import prims_1e
    a, b, A, B, w = t._prims(31, m=3)
    rng = np.random.default_rng(99)
    zr, zq = rng.normal(size=(8, 3)), np.arange(8.0)
    k = 'fg_chunk_30'
    out[f'{k}_ipovlp'] = np.asarray(jax_deriv.ipovlp_chunk(3, 0, a, b, A, B,
                                                           w))
    out[f'{k}_ipkin'] = np.asarray(jax_deriv.ipkin_chunk(3, 0, a, b, A, B, w))
    out[f'{k}_ipnuc'] = np.asarray(jax_deriv.ipnuc_chunk(3, 0, a, b, A, B, w,
                                                         zr, zq))
    out[f'{k}_iprinv'] = np.asarray(jax_deriv.iprinv_chunk(3, 0, a, b, A, B,
                                                           w, zr[3]))
    mol = jpt.M(atom=t.F_ATOMS, basis=t.F_BASIS, verbose=0)
    auxmol = jpt.M(atom=t.F_ATOMS, basis=t.F_AUX, verbose=0)
    out['fg_df_f_3c'], out['fg_df_f_2c'] = fg_df_functionals(mol, auxmol)
    toy = jpt.M(atom=t.TOY_ATOM, basis=[[3, [0.7, 1.0]], [0, [1.3, 1.0]]],
                verbose=0)
    out['fg_ip1_fssf'] = np.asarray(jax_int2e._deriv_class_pair_block(
        jax_int2e.DerivPairClass(toy, 3, 0), jax_int2e.PairClass(toy, 0, 3)))
    la, lb = 3, 0
    a, b, A, B, w, zr, zq, dm, wm = prims_1e(la, lb, m=3)

    def f(A_):
        s1 = jax_int1e.ovlp_chunk(la, lb, a, b, A_, B, w)
        t1 = jax_int1e.kin_chunk(la, lb, a, b, A_, B, w)
        v1 = jax_int1e.nuc_chunk(la, lb, a, b, A_, B, w, zr, zq)
        return jnp.sum(dm * (t1 + v1)) - jnp.sum(wm * s1)

    aa = np.asarray(jax.jacfwd(jax.grad(f))(jnp.asarray(A)))
    idx = np.arange(aa.shape[0])
    out['fg_ipip_30'] = aa[idx, :, idx, :]


FUNCTIONS = (scf_refs, integral_refs, grad_refs, analysis_refs,
             scf_energy_refs, more_refs, fg_water_refs, fg_neon_refs,
             fg_grad_tz_refs, fg_grad_tzvp_refs, fg_grad_refs, fg_ip1_refs,
             pbe_refs, rsh_refs, rsh_dm_refs, fg_f_refs, uks_dual_refs,
             grad_df_refs, int_matrix_refs, vv10_refs, hermite_refs,
             xc_refs, int1e_refs, int_deriv_refs)


def main(names):
    out = dict(np.load(OUT)) if names and os.path.exists(OUT) else {}
    for fn in FUNCTIONS:
        if names and fn.__name__ not in names:
            continue
        fn(out)
        print(fn.__name__, 'done', flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == '__main__':
    main(sys.argv[1:])
