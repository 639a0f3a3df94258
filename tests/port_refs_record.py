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


FUNCTIONS = (scf_refs, integral_refs, grad_refs, analysis_refs,
             scf_energy_refs, more_refs, fg_water_refs, fg_neon_refs)


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
