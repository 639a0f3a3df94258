#!/usr/bin/env python3
"""Smoke run of pyscf_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's five paths for benzene/def2-SVP and the phenyl radical
on the card, in order:
  1. refuses to run without CUDA; prints the card's name and power limit;
  2. builds the eleven CUDA kernels from pyscf_tpu_torch/csrc (nvcc,
     sm_90a, one process per library, all at once);
  3. integral kernel phases at the main path's shapes: each kernel against
     its plain PyTorch twin on the same card inputs (S/T/V <= 1e-12; raw 3c
     rows and (P|Q) <= 1e-12 x max|value|; the whitened factor B <= 1e-10);
  4. DF-RHF through the public entry points,
     M(...).RHF().density_fit().kernel() with the minao guess and conv_tol
     1e-8: the recorded JAX energy within 1e-8 Ha, every integral kernel
     launched in that run;
  5. grid, AO and XC kernel phases at the main path's shapes (benzene,
     default grids): becke <= 1e-12 x max w; eval_ao <= 1e-13 on all four
     components; xc_rks at the converged DF-RHF density, vtmp <= 1e-11 x
     max|vtmp| and n, exc <= 1e-11 relative;
  6. the main path, DF-RKS b3lypg through the public entry points,
     dft.RKS(M(...), xc='b3lypg').density_fit().kernel() with the minao
     guess and conv_tol 1e-8 on the default device: converged, the recorded
     JAX energy within 1e-8 Ha, and its six kernels launched in that run;
  7. the int2e phase: every ordered pair of benzene's screened shell-pair
     classes through the `int2e` kernel and its plain twin, <= 1e-12 x
     max|value|;
  8. in-core RHF, M(...).RHF().kernel() without density fitting (minao,
     conv_tol 1e-8): converged, the recorded JAX energy within 1e-8 Ha,
     int2e and int1e_stv launched in that run;
  9. DF-UKS b3lypg of the phenyl radical, M(..., spin=1).UKS(xc='b3lypg')
     .density_fit().kernel() (minao, conv_tol 1e-8): converged, the
     recorded JAX energy within 1e-8 Ha, <S^2> printed, its six kernels
     launched in that run;
 10. the xc_uks phase at the converged phenyl spin density: vtmp <= 1e-11
     x max|vtmp|, n_a, n_b and exc <= 1e-11 relative;
 11. the derivative-integral phases at benzene's shapes: int1e_ip,
     int1e_iprinv (all twelve atoms as centres) and int2e_ip1 over every
     ordered bra class, each against its plain twin, <= 1e-12 x max|value|;
 12. the conventional RHF gradient, M(...).RHF() converged (minao,
     conv_tol 1e-11, the recorded JAX energy within 1e-8 Ha), then
     nuc_grad_method().kernel(): |sum_A de[A]| < 1e-9, the geometry's
     three mirror planes (its six-decimal coordinates are exactly D2h)
     within 1e-8 and the six C and the six H gradient norms within 1e-6
     (they are D6h to 3e-7 Angstrom only) and, on the ring symmetrised to
     D6h in float64, within 1e-8; central differences of the
     port's own energy on one C and one H coordinate within 1e-6, the
     three derivative kernels launched in that run; warm gradient times,
     their phases and the peak device memory printed; and the water/
     def2-SVP gradient through the same entry point within 1e-8 of the
     recorded JAX gradient;
 13. one JSON line with the per-kernel numbers (times from CUDA events, the
     bound computed from this run's inputs, launches from the path that
     runs the kernel: int2e from 8, xc_uks from 9, the three derivative
     kernels from 12, the others from 6), then the result line
     {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is non-zero.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the FP64 rate outside the
# tensor cores (the kernels here do no matrix products), at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12


def cuda_ms(fn, reps=3):
    """Mean milliseconds of fn() over reps calls on the current stream,
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(pairs):
    """(max |a-b|, max |b|) over a list of (kernel, plain) tensor pairs."""
    err = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    return err, scale


def check(ok, what):
    if not ok:
        raise SystemExit(f'FAILED: {what}')


def bound(nbytes, nops):
    """(ms, 'bytes' or 'operations'): the least time for the work, bytes
    over HBM bandwidth or FP64 operations over the FP64 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP64_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def record(report, name, source, replaces, err, kernel_fn, plain_fn, nbytes,
           nops, plain_reps=3):
    bound_ms, bound_by = bound(nbytes, nops)
    report[name] = dict(
        source=source, replaces=replaces, max_abs_err=err,
        ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, plain_reps),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    r = report[name]
    print(f'{name}: max_abs_err {err:.3e}  kernel {r["ms"]:.3f} ms  plain '
          f'{r["plain_ms"]:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})',
          flush=True)


# ---- operation counts of the integral kernels -------------------------------
# FP64 operations of the main loops of csrc/hermite.cuh coulomb_block,
# csrc/int2e.cu and csrc/int1e_stv.cu, for the primitives these inputs hold
# (zero coefficients are skipped as the kernels skip them). The Boys
# function is not counted, so these are lower bounds of the work.

def _carts(l):
    return [(ix, iy, l - ix - iy) for ix in range(l, -1, -1)
            for iy in range(l - ix, -1, -1)]


def _ntuv(L):
    return (L + 1) * (L + 2) * (L + 3) // 6


def _r_ops(L):
    """hermite_R recursion: 3 operations per entry and level."""
    return 3 * sum((k + 1) * (k + 2) // 2
                   for n in range(L) for k in range(1, L - n + 1))


def _e1d_ops(la, lb):
    return 5 * sum(i + j + 1 for i in range(la + 1) for j in range(lb + 1))


def _herm_terms(la, lb):
    return sum((ix + jx + 1) * (iy + jy + 1) * (iz + jz + 1)
               for ix, iy, iz in _carts(la) for jx, jy, jz in _carts(lb))


def _ket_ops(lc, l1):
    """Ket fold per primitive triple: the nonzero S and E_c terms."""
    from pyscf_tpu_torch.ops.integrals.cart2sph import cart2sph
    S = np.asarray(cart2sph(lc))
    n = 0
    for sc in range(2 * lc + 1):
        for jc, (kx, ky, kz) in enumerate(_carts(lc)):
            if S[sc, jc] != 0.0:
                n += sum(1 for tx in range(kx + 1) for ty in range(ky + 1)
                         for tz in range(kz + 1)
                         if (kx - tx) % 2 == 0 and (ky - ty) % 2 == 0
                         and (kz - tz) % 2 == 0)
    return n * (5 + 2 * _ntuv(l1))


def _nnz(c):
    return (c != 0).sum(dim=1).double()


def coulomb_ops(la, lb, lc, pair_prims, nthreads_per_pair, triples):
    """coulomb_block: per bra primitive pair (and thread) the E tables and
    the bra contraction, per primitive triple R and the ket fold."""
    per_pair = (3 * _e1d_ops(la, lb)
                + _herm_terms(la, lb) * (2 + 2 * (2 * lc + 1)))
    per_triple = _r_ops(la + lb + lc) + _ket_ops(lc, la + lb)
    return pair_prims * nthreads_per_pair * per_pair + triples * per_triple


def _same_centre(pairs):
    """Per shell pair: whether both shells sit on one centre."""
    return (pairs[2] == pairs[5]).all(dim=1)


def _fold_terms(lc, ld, sd, same):
    """Ket fold terms of csrc/int2e.cu for one sd: the (tx, ty, tz) of every
    nonzero (sc, jc, jd) entry, and on one centre only those whose E_t is
    not zero (i + j - t even)."""
    from pyscf_tpu_torch.ops.integrals.cart2sph import cart2sph
    Sc, Sd = np.asarray(cart2sph(lc)), np.asarray(cart2sph(ld))
    n = 0
    for sc in range(2 * lc + 1):
        for jc, kc in enumerate(_carts(lc)):
            if Sc[sc, jc] == 0.0:
                continue
            for jd, kd in enumerate(_carts(ld)):
                if Sd[sd, jd] == 0.0:
                    continue
                m = 1
                for i, j in zip(kc, kd):
                    m *= (i + j) // 2 + 1 if same else i + j + 1
                n += m
    return n


def _prim_pairs(pairs):
    return _nnz(pairs[1]) * _nnz(pairs[4])


def _bra_terms(la, lb, deriv):
    """Hermite terms of the bra's cartesian blocks: the shell pair itself,
    or the raised and lowered bra shells of a derivative."""
    if not deriv:
        return _herm_terms(la, lb)
    return _herm_terms(la + 1, lb) + (_herm_terms(la - 1, lb) if la else 0)


def pair_e_ops(la, lb, pairs, bra, deriv=False):
    """The E tables of a class of shell pairs and, for the bra, their
    products E_x E_y E_z: once per primitive pair, whatever the other side.
    A derivative bra has tables to la + 1."""
    per_pp = 3 * _e1d_ops(la + deriv, lb) \
        + (2 * _bra_terms(la, lb, deriv) if bra else 0)
    return float(_prim_pairs(pairs).sum()) * per_pp


def quartet_ops(la, lb, bra, lc, ld, ket, deriv=False):
    """csrc/int2e.cu (csrc/int2e_ip1.cu with deriv) for one ordered class
    pair, less the E tables: per primitive quartet R_tuv and, per sph
    component sd of the ket's second shell, the fold into Y; per (bra
    primitive pair, ket pair, sd) the bra contraction. The kernel redoes
    R_tuv and the E tables for every sd and every pair of the other side;
    that is not counted."""
    l1 = la + lb + deriv
    nt1 = _ntuv(l1)
    bra_pp = float(_prim_pairs(bra).sum())
    kp = _prim_pairs(ket)
    same = _same_centre(ket)
    ops = bra_pp * float(kp.sum()) * _r_ops(l1 + lc + ld)
    for sd in range(2 * ld + 1):
        for s in (True, False):
            kpp = float(kp[same == s].sum())
            ops += bra_pp * kpp * _fold_terms(lc, ld, sd, s) * (5 + 2 * nt1)
        ops += (bra_pp * ket[0].shape[0]
                * _bra_terms(la, lb, deriv) * 2 * (2 * lc + 1))
    return ops


def stv_ops(la, lb, pairs, natm, with_tv):
    ea, ca, _, eb, cb, _ = pairs
    prims = float((_nnz(ca) * _nnz(cb)).sum())
    ops = 3 * _e1d_ops(la, lb + 2)
    if with_tv:
        ops += natm * (_r_ops(la + lb) + 2 * _ntuv(la + lb))
        ops += 34 * len(_carts(la)) * len(_carts(lb)) \
            + 3 * _herm_terms(la, lb)
    else:
        ops += 4 * len(_carts(la)) * len(_carts(lb))
    return prims * ops


def ip_ops(la, lb, pairs, natm):
    """csrc/int1e_ip.cu: per primitive pair the E tables to (la + 1,
    lb + 2), R_tuv to order la + lb + 1 per atom, and the S/T/V terms of
    the raised and lowered bra shells."""
    ops = 3 * _e1d_ops(la + 1, lb + 2)
    ops += natm * (_r_ops(la + lb + 1) + 2 * _ntuv(la + lb + 1))
    for ls in ([la + 1, la - 1] if la else [la + 1]):
        ops += 34 * len(_carts(ls)) * len(_carts(lb)) \
            + 3 * _herm_terms(ls, lb)
    return float(_prim_pairs(pairs).sum()) * ops


def iprinv_ops(la, lb, pairs, ncentre):
    """csrc/int1e_iprinv.cu: per primitive pair the E tables (counted once,
    the kernel redoes them per centre) and, per centre, R_tuv to order
    la + lb + 1 and three shifted reads of it per Hermite term."""
    ops = 3 * _e1d_ops(la, lb) \
        + ncentre * (_r_ops(la + lb + 1) + 8 * _herm_terms(la, lb))
    return float(_prim_pairs(pairs).sum()) * ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- phases ---------------------------------------------------------------

def integral_phases(pt, refs, report):
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.ops import kernels
    from pyscf_tpu_torch.ops.integrals import int1e, j3c

    dev = torch.device('cuda')
    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device=dev)
    auxmol = make_auxmol(mol)
    minao = pt.M(atom=list(zip(mol.raw_symbols, mol.coords)), basis='minao',
                 unit='bohr', device=dev)
    print(f'benzene/def2-SVP: nao {mol.nao}, naux {auxmol.nao}')
    classes = j3c.screened_pairs(mol)
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    cross = int1e.cross_pairs(mol, minao)   # minao guess, S only
    aux = j3c.aux_tables(auxmol)

    def stv(fn):
        out = [fn(la, lb, *p, zr, zq) for (la, lb), (_, p) in classes.items()]
        return out + [fn(la, lb, *p, with_tv=False)
                      for la, lb, _, _, p in cross]

    k_out, p_out = stv(kernels.int1e_stv), stv(int1e.class_stv)
    err, _ = max_abs(list(zip(k_out, p_out)))
    ops = sum(stv_ops(la, lb, p, mol.natm, True)
              for (la, lb), (_, p) in classes.items())
    ops += sum(stv_ops(la, lb, p, 0, False) for la, lb, _, _, p in cross)
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*p) for *_, p in cross) + nbytes(*k_out)
    record(report, 'int1e_stv', 'pyscf_tpu_torch/csrc/int1e_stv.cu',
           'pyscf_tpu/ops/integrals/j1e.py:30', err,
           lambda: stv(kernels.int1e_stv), lambda: stv(int1e.class_stv),
           io, ops)
    check(err <= 1e-12, f'int1e_stv vs plain: {err:.3e} > 1e-12')

    def rows(fn):
        return {cls: fn(*cls, *p, aux) for cls, (_, p) in classes.items()}

    rows_k, rows_p = rows(kernels.int3c2e), rows(j3c.int3c2e_plain)
    err, scale = max_abs([(rows_k[c], rows_p[c]) for c in rows_k])
    aux_nnz = {l: float(_nnz(c).sum()) for l, _, c, _ in aux}
    ops = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float((_nnz(p[1]) * _nnz(p[4])).sum())
        for l, e, _, _ in aux:
            ops += coulomb_ops(la, lb, l, prims, e.shape[0],
                               prims * aux_nnz[l])
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*a[1:]) for a in aux) + nbytes(*rows_k.values())
    record(report, 'int3c2e', 'pyscf_tpu_torch/csrc/int3c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:188', err,
           lambda: rows(kernels.int3c2e), lambda: rows(j3c.int3c2e_plain),
           io, ops)
    check(err <= 1e-12 * scale, f'int3c2e vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    jg_k, jg_p = kernels.int2c2e(aux), j3c.int2c2e_plain(aux)
    err, scale = max_abs([(jg_k, jg_p)])
    ops = 0.0
    for i, (lx, ex, cx, _) in enumerate(aux):
        for ly, ey, cy, _ in aux[i:]:
            prims = float(_nnz(cx).sum())
            ops += coulomb_ops(lx, 0, ly, prims, ey.shape[0],
                               prims * float(_nnz(cy).sum()))
    record(report, 'int2c2e', 'pyscf_tpu_torch/csrc/int2c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:266', err,
           lambda: kernels.int2c2e(aux), lambda: j3c.int2c2e_plain(aux),
           sum(nbytes(*a[1:]) for a in aux) + nbytes(jg_k), ops)
    check(err <= 1e-12 * scale, f'int2c2e vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    # B from the kernel rows against B from the plain rows, whitened by the
    # same (L^-1)^T: the metric's condition number amplifies the rounding
    # difference of the two metrics into B, so that part is reported apart
    linv_k = j3c.whitener(jg_k)
    B_k = j3c.whitened_factor(mol, auxmol, rows_k, linv_k)
    B_p = j3c.whitened_factor(mol, auxmol, rows_p, linv_k)
    err_b, _ = max_abs([(B_k, B_p)])
    B_pp = j3c.whitened_factor(mol, auxmol, rows_p, j3c.whitener(jg_p))
    err_w, _ = max_abs([(B_k, B_pp)])
    ev = torch.linalg.eigvalsh(jg_k)
    print(f'B: max_abs_err {err_b:.3e} (same whitener); {err_w:.3e} with '
          f'each side\'s own whitener; (P|Q) condition number '
          f'{float(ev[-1] / ev[0]):.3e}')
    check(err_b <= 1e-10, f'B (kernels) vs B (plain): {err_b:.3e} > 1e-10')


def run_path(name, kernels, names, build):
    """Drive one path with the launch counts set to 0 just before it; every
    kernel in `names` must have launched. Returns (mf, e, launches)."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf = build()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    print(f'{name}: E = {e!r}  converged {mf.converged}  cycles '
          f'{mf.scf_cycles}  wall {wall:.3f} s')
    order = ('hcore', 'j2c', 'j3c', 'eri', 'guess', 'grids', 'ao',
             'scf_loop')
    print('phase seconds: ' + '  '.join(f'{k} {mf.timings[k]:.4f}'
                                        for k in order if k in mf.timings))
    print(f'launches: {launches}')
    check(mf.converged, f'{name}: SCF did not converge')
    check(mf.mo_energy.shape[-1] == mf.mol.nao
          and bool(torch.isfinite(mf.mo_energy).all()),
          f'{name}: mo_energy is not finite of shape (..., nao)')
    for k in names:
        check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return mf, e, launches


def df_rhf_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
        mf = mol.RHF().density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, _ = run_path('DF-RHF benzene/def2-SVP', kernels,
                        ('int1e_stv', 'int3c2e', 'int2c2e'), build)
    de = e - refs.E_BENZENE_DF_RHF_DEF2SVP
    print(f'DF-RHF E - E_ref = {de:.3e}')
    check(abs(de) < 1e-8, f'DF-RHF |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return mf


def eigh_residual(mf):
    """eigh residual at n = nao on the converged Fock, orthogonal basis."""
    from pyscf_tpu_torch.lib.linalg import EIGH_REFINE, canonical_orth
    _, veff_dm_fn = mf._veff_fns()
    fock = mf.get_hcore() + veff_dm_fn(mf.make_rdm1())[0]
    x = canonical_orth(mf.get_ovlp())
    fp = x.T @ fock @ x
    w, v = torch.linalg.eigh(fp)
    resid = float((fp @ v - v * w).abs().max())
    print(f'torch.linalg.eigh n={fp.shape[0]}: max |AV - VW| = {resid:.3e} '
          f'(EIGH_REFINE = {EIGH_REFINE})')
    check(EIGH_REFINE > 0 or resid < 1e-12,
          f'eigh residual {resid:.3e} >= 1e-12 with refinement off')


def grid_xc_phases(pt, kernels, mol, dm, report):
    from pyscf_tpu_torch.dft import gen_grid, numint, xc
    from pyscf_tpu_torch.ops import eval_gto

    tab = gen_grid.gen_atomic_grids(mol)
    inputs = gen_grid.partition_inputs(mol, tab)
    w_k = kernels.becke(*inputs)
    w_p = gen_grid.becke_weights_plain(*inputs)
    err, scale = max_abs([(w_k, w_p)])
    npts, natm = w_k.shape[0], mol.natm
    print(f'grid: {npts} points, {natm} atoms')
    record(report, 'becke', 'pyscf_tpu_torch/csrc/becke.cu',
           'pyscf_tpu/dft/gen_grid.py:179', err,
           lambda: kernels.becke(*inputs),
           lambda: gen_grid.becke_weights_plain(*inputs),
           nbytes(*inputs) + nbytes(w_k),
           npts * (natm * 11 + natm * (natm - 1) * 20))
    check(err <= 1e-12 * scale, f'becke vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    coords, weights = inputs[0], w_k
    tables = eval_gto.ao_tables(mol)
    ao_k = kernels.eval_ao(tables, coords, mol.nao, 1)
    ao_p = eval_gto.eval_ao_plain(tables, coords, mol.nao, 1)
    err, _ = max_abs([(ao_k, ao_p)])
    ops = 0.0
    for l, e, c, _, _ in tables:
        nc, d = (l + 1) * (l + 2) // 2, 2 * l + 1
        ops += npts * e.shape[0] * (8 + 7 * e.shape[1]
                                    + 4 * nc * (l + 4 + 2 * d))
    record(report, 'eval_ao', 'pyscf_tpu_torch/csrc/eval_ao.cu',
           'pyscf_tpu/ops/eval_gto.py:19', err,
           lambda: kernels.eval_ao(tables, coords, mol.nao, 1),
           lambda: eval_gto.eval_ao_plain(tables, coords, mol.nao, 1),
           nbytes(coords, ao_k) + sum(nbytes(*t[1:]) for t in tables), ops)
    check(err <= 1e-13, f'eval_ao vs plain: {err:.3e} > 1e-13')
    del ao_p

    f = xc.parse_xc('b3lypg')
    dmao = ao_k[0] @ dm
    vt_k, n_k, e_k = kernels.xc_rks(ao_k, dmao, weights, f)
    vt_p, n_p, e_p = numint.xc_rks_plain(ao_k, dmao, weights, f)
    err, scale = max_abs([(vt_k, vt_p)])
    rel_n = abs(float(n_k - n_p)) / abs(float(n_p))
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    print(f'xc_rks at the DF-RHF density: n {float(n_k):.12f} (rel diff '
          f'{rel_n:.2e}), exc {float(e_k):.12f} (rel diff {rel_e:.2e})')
    # reductions and vtmp: 16 operations per point and AO; the functional's
    # few hundred per point are not counted
    record(report, 'xc_rks', 'pyscf_tpu_torch/csrc/xc_rks.cu',
           'pyscf_tpu/dft/numint.py:117', err,
           lambda: kernels.xc_rks(ao_k, dmao, weights, f),
           lambda: numint.xc_rks_plain(ao_k, dmao, weights, f),
           nbytes(ao_k, dmao, weights, vt_k), 16 * npts * mol.nao)
    check(err <= 1e-11 * scale, f'xc_rks vtmp vs plain: {err:.3e} > 1e-11 x '
          f'{scale:.3e}')
    check(rel_n <= 1e-11 and rel_e <= 1e-11,
          f'xc_rks n/exc vs plain: {rel_n:.2e}, {rel_e:.2e} > 1e-11')


def df_rks_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
        check(mol.device.type == 'cuda', 'M() without a device is not on '
              'the card')
        mf = pt.dft.RKS(mol, xc='b3lypg').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = run_path('DF-RKS b3lypg benzene/def2-SVP', kernels,
                               ('int1e_stv', 'int3c2e', 'int2c2e', 'eval_ao',
                                'becke', 'xc_rks'), build)
    de = e - refs.E_BENZENE_DF_RKS_B3LYPG_DEF2SVP
    print(f'DF-RKS E - E_ref = {de:.3e}  ngrid {mf.grids.size}')
    check(abs(de) < 1e-8, f'DF-RKS |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return launches


def int2e_phase(pt, refs, kernels, report):
    from pyscf_tpu_torch.ops.integrals import j2e, j3c

    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    classes = j3c.screened_pairs(mol)
    kets = j2e._ket_arrays(mol)

    def pieces(fn):
        return [fn(la, lb, *p, kets) for (la, lb), (_, p) in classes.items()]

    k_out = pieces(kernels.int2e)
    p_out = pieces(j2e.int2e_class_plain)
    err, scale = max_abs(list(zip(k_out, p_out)))
    nrow = sum(p.shape[0] for p in k_out)
    print(f'int2e: {len(classes)} bra classes x {len(kets)} ket classes, '
          f'stacked rows {nrow} x {k_out[0].shape[1]}, dense (nao)^4 '
          f'{mol.nao ** 4 * 8 / 1e9:.3f} GB')
    del p_out
    ops = sum(quartet_ops(la, lb, p, lc, ld, ket)
              for (la, lb), (_, p) in classes.items()
              for lc, ld, *ket in kets)
    ops += sum(pair_e_ops(la, lb, p, True)
               for (la, lb), (_, p) in classes.items())
    ops += sum(pair_e_ops(lc, ld, ket, False) for lc, ld, *ket in kets)
    io = sum(nbytes(*p) for _, p in classes.values()) + nbytes(*k_out)
    record(report, 'int2e', 'pyscf_tpu_torch/csrc/int2e.cu',
           'pyscf_tpu/ops/integrals/j2e.py:42', err,
           lambda: pieces(kernels.int2e),
           lambda: pieces(j2e.int2e_class_plain), io, ops, plain_reps=1)
    check(err <= 1e-12 * scale, f'int2e vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')


def incore_rhf_path(pt, refs, kernels):
    def build():
        mf = pt.M(atom=refs.BENZENE, basis='def2-svp').RHF()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    torch.cuda.reset_peak_memory_stats()
    mf, e, launches = run_path('in-core RHF benzene/def2-SVP', kernels,
                               ('int2e', 'int1e_stv'), build)
    de = e - refs.E_BENZENE_RHF_DEF2SVP
    print(f'in-core RHF E - E_ref = {de:.3e}  eri '
          f'{tuple(mf._eri.shape)}  peak device memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    check(abs(de) < 1e-8, f'in-core RHF |E - E_ref| = {abs(de):.3e} >= 1e-8')
    # the K strategy of scf/hf.py, a batched GEMV on the tensor's own
    # layout, against an axis-swapped copy of the tensor (once per kernel())
    # and then a GEMV per K, and against torch.einsum as the JAX package
    # writes K
    eri, dm = mf._eri, mf.make_rdm1()
    n = eri.shape[0]
    get_k = mf._jk_fns()[1]
    bgemv_ms = cuda_ms(lambda: get_k(dm))
    copy_ms = cuda_ms(lambda: eri.permute(0, 2, 1, 3).contiguous())
    eri_k = eri.permute(0, 2, 1, 3).reshape(n * n, n * n)
    gemv_ms = cuda_ms(lambda: eri_k @ dm.reshape(-1))
    err, scale = max_abs([(get_k(dm),
                           (eri_k @ dm.reshape(-1)).reshape(n, n))])
    del eri_k
    einsum_ms = cuda_ms(lambda: torch.einsum('ilkj,lk->ij', eri, dm))
    print(f'in-core K: batched GEMV {bgemv_ms:.3f} ms per K; axis-swapped '
          f'copy {copy_ms:.3f} ms then a GEMV {gemv_ms:.3f} ms per K (max '
          f'|diff| {err:.3e}); torch.einsum {einsum_ms:.3f} ms per K')
    check(err <= 1e-12 * scale, f'in-core K: batched GEMV vs GEMV '
          f'{err:.3e} > 1e-12 x {scale:.3e}')
    return launches


def df_uks_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
        mf = mol.UKS(xc='b3lypg').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = run_path(
        'DF-UKS b3lypg phenyl/def2-SVP', kernels,
        ('int1e_stv', 'int3c2e', 'int2c2e', 'eval_ao', 'becke', 'xc_uks'),
        build)
    de = e - refs.E_PHENYL_DF_UKS_B3LYPG_DEF2SVP
    ss, mult = mf.spin_square()
    print(f'DF-UKS E - E_ref = {de:.3e}  <S^2> {ss!r}  2S+1 {mult!r}  '
          f'nelec {mf.mol.nelec}  ngrid {mf.grids.size}')
    check(abs(de) < 1e-8, f'DF-UKS |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return mf, launches


def xc_uks_phase(kernels, mf, report):
    from pyscf_tpu_torch.dft import numint, xc

    f = xc.parse_xc('b3lypg')
    aods, weights = mf._numint.grid_ao(mf.mol, mf.grids, 1, spins=2)
    check(len(aods) == 1, 'the phenyl grid does not fit one block')
    aod, w = aods[0], weights[0]
    dmao = aod[0] @ mf.make_rdm1()
    vt_k, n_k, e_k = kernels.xc_uks(aod, dmao, w, f)
    vt_p, n_p, e_p = numint.xc_uks_plain(aod, dmao, w, f)
    err, scale = max_abs([(vt_k, vt_p)])
    rel_n = float(torch.max(torch.abs(n_k - n_p) / torch.abs(n_p)))
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    print(f'xc_uks at the DF-UKS spin density: n {n_k.tolist()} (rel diff '
          f'{rel_n:.2e}), exc {float(e_k):.12f} (rel diff {rel_e:.2e})')
    npts, nao = w.shape[0], aod.shape[-1]
    # reductions and the two vtmp rows: 30 operations per point and AO;
    # the functional's few thousand per point are not counted
    record(report, 'xc_uks', 'pyscf_tpu_torch/csrc/xc_uks.cu',
           'pyscf_tpu/dft/numint.py:224', err,
           lambda: kernels.xc_uks(aod, dmao, w, f),
           lambda: numint.xc_uks_plain(aod, dmao, w, f),
           nbytes(aod, dmao, w, vt_k), 30 * npts * nao)
    check(err <= 1e-11 * scale, f'xc_uks vtmp vs plain: {err:.3e} > 1e-11 x '
          f'{scale:.3e}')
    check(rel_n <= 1e-11 and rel_e <= 1e-11,
          f'xc_uks n/exc vs plain: {rel_n:.2e}, {rel_e:.2e} > 1e-11')


def deriv_phases(pt, refs, kernels, report):
    from pyscf_tpu_torch.ops.integrals import int1e, int1e_deriv, int2e, j2e

    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    dev = mol.device
    classes = int1e.cross_pairs(mol, mol)     # every ordered class and pair
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    pair_bytes = sum(nbytes(*p) for *_, p in classes)

    def per_class(fn, *extra):
        return [fn(la, lb, *p, *extra) for la, lb, _, _, p in classes]

    k_out = per_class(kernels.int1e_ip, zr, zq)
    p_out = per_class(int1e_deriv.class_ip, zr, zq)
    err, scale = max_abs(list(zip(k_out, p_out)))
    record(report, 'int1e_ip', 'pyscf_tpu_torch/csrc/int1e_ip.cu',
           'pyscf_tpu/ops/integrals/int1e_deriv.py:32', err,
           lambda: per_class(kernels.int1e_ip, zr, zq),
           lambda: per_class(int1e_deriv.class_ip, zr, zq),
           pair_bytes + nbytes(*k_out),
           sum(ip_ops(la, lb, p, mol.natm) for la, lb, _, _, p in classes))
    check(err <= 1e-12 * scale, f'int1e_ip vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    k_out = per_class(kernels.int1e_iprinv, zr)
    p_out = per_class(int1e_deriv.class_iprinv, zr)
    err, scale = max_abs(list(zip(k_out, p_out)))
    record(report, 'int1e_iprinv', 'pyscf_tpu_torch/csrc/int1e_iprinv.cu',
           'pyscf_tpu/ops/integrals/int1e_deriv.py:136', err,
           lambda: per_class(kernels.int1e_iprinv, zr),
           lambda: per_class(int1e_deriv.class_iprinv, zr),
           pair_bytes + nbytes(*k_out),
           sum(iprinv_ops(la, lb, p, mol.natm)
               for la, lb, _, _, p in classes))
    check(err <= 1e-12 * scale, f'int1e_iprinv vs plain: {err:.3e} > 1e-12 '
          f'x {scale:.3e}')

    kets = j2e._ket_arrays(mol)
    k_out = per_class(kernels.int2e_ip1, kets)
    p_out = per_class(int2e.int2e_ip1_class_plain, kets)
    err, scale = max_abs(list(zip(k_out, p_out)))
    nrow = sum(p.shape[1] for p in k_out)
    print(f'int2e_ip1: {len(classes)} ordered bra classes x {len(kets)} ket '
          f'classes, stacked rows 3 x {nrow} x {k_out[0].shape[2]} '
          f'({nbytes(*k_out) / 1e9:.3f} GB), dense 3 x (nao)^4 '
          f'{3 * mol.nao ** 4 * 8 / 1e9:.3f} GB')
    del p_out
    ops = sum(quartet_ops(la, lb, p, lc, ld, ket, deriv=True)
              for la, lb, _, _, p in classes for lc, ld, *ket in kets)
    ops += sum(pair_e_ops(la, lb, p, True, deriv=True)
               for la, lb, _, _, p in classes)
    ops += sum(pair_e_ops(lc, ld, ket, False) for lc, ld, *ket in kets)
    io = pair_bytes + nbytes(*k_out)
    del k_out
    record(report, 'int2e_ip1', 'pyscf_tpu_torch/csrc/int2e_ip1.cu',
           'pyscf_tpu/ops/integrals/int2e.py:727', err,
           lambda: per_class(kernels.int2e_ip1, kets),
           lambda: per_class(int2e.int2e_ip1_class_plain, kets), io, ops,
           plain_reps=1)
    check(err <= 1e-12 * scale, f'int2e_ip1 vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')


def mirror_defect(coords, de, axis):
    """max |de[image of A] - mirrored de[A]| for the mirror plane normal
    to `axis`, which must map the atoms onto each other exactly."""
    sign = np.ones(3)
    sign[axis] = -1.0
    dist = np.abs(coords[:, None, :] * sign - coords[None, :, :]).max(-1)
    image = dist.argmin(axis=1)
    check(float(dist.min(axis=1).max()) == 0.0,
          f'the geometry has no exact mirror plane normal to axis {axis}')
    return float(np.abs(de[image] - de * sign).max())


def d6h_ring(coords):
    """coords (12, 3) of a planar ring about the origin, six C then six H,
    with every atom moved to its element's mean radius at the nearest
    multiple of 30 degrees: D6h to the rounding of float64."""
    out = np.zeros_like(coords)
    for ring in (slice(0, 6), slice(6, 12)):
        r = np.linalg.norm(coords[ring], axis=1).mean()
        step = np.pi / 6
        ang = step * np.round(np.arctan2(coords[ring, 1], coords[ring, 0])
                              / step)
        out[ring, 0] = r * np.cos(ang)
        out[ring, 1] = r * np.sin(ang)
    return out


GRAD_KERNELS = ('int1e_ip', 'int1e_iprinv', 'int2e_ip1')


def tight_rhf(mol):
    """In-core RHF converged far enough for gradients and their central
    differences (the gradient's error is linear in the orbital gradient)."""
    mf = mol.RHF()
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.init_guess = 'minao'
    return mf


def rhf_grad_path(pt, refs, kernels):
    torch.cuda.reset_peak_memory_stats()
    mf, e, _ = run_path('in-core RHF benzene/def2-SVP for the gradient',
                        kernels, ('int2e', 'int1e_stv'),
                        lambda: tight_rhf(pt.M(atom=refs.BENZENE,
                                               basis='def2-svp')))
    de_ref = abs(e - refs.E_BENZENE_RHF_DEF2SVP)
    check(de_ref < 1e-8, f'gradient SCF |E - E_ref| = {de_ref:.3e} >= 1e-8')
    t0 = time.perf_counter()
    grad = mf.nuc_grad_method()
    de = grad.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    print(f'RHF gradient benzene/def2-SVP (first call): wall {wall:.3f} s  '
          + '  '.join(f'{k} {v:.4f}' for k, v in grad.timings.items())
          + f'  peak device memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    print(f'launches: {launches}')
    print('de (Ha/Bohr):\n' + np.array2string(de, precision=10))
    for k in GRAD_KERNELS:
        check(launches[k] > 0, f'RHF gradient: kernel {k} never launched')
    check(de.shape == (mf.mol.natm, 3) and bool(np.isfinite(de).all()),
          'the gradient is not finite of shape (natm, 3)')
    drift = float(np.abs(de.sum(axis=0)).max())
    check(drift < 1e-9, f'gradient sum rule: {drift:.3e} >= 1e-9')
    # The geometry's six-decimal coordinates are exactly D2h (the mirrors
    # x, y and z) and D6h only to 3e-7 Angstrom, so the mirrors hold to
    # 1e-8 and the six-fold equalities to 1e-6.
    mirror = max(mirror_defect(mf.mol.coords, de, ax) for ax in range(3))
    norms = np.linalg.norm(de, axis=1)
    spread_c = float(np.ptp(norms[:6]))
    spread_h = float(np.ptp(norms[6:]))
    print(f'|sum_A de[A]| {drift:.3e}  mirror defect {mirror:.3e}  |de| C '
          f'{norms[0]:.10f} (spread {spread_c:.3e})  H {norms[6]:.10f} '
          f'(spread {spread_h:.3e})')
    check(mirror < 1e-8, f'D2h: the gradient breaks a mirror plane by '
          f'{mirror:.3e} >= 1e-8')
    check(spread_c < 1e-6 and spread_h < 1e-6,
          f'D6h: gradient norms differ by {spread_c:.3e} (C), '
          f'{spread_h:.3e} (H) >= 1e-6')

    from pyscf_tpu_torch.grad import finite_difference_gradient
    picks = [(0, 1), (6, 1)]      # the radial coordinate of one C, one H
    fd = finite_difference_gradient(lambda m: tight_rhf(m).kernel(), mf.mol,
                                    1e-4, picks)
    for a, x in picks:
        diff = abs(de[a, x] - fd[a, x])
        print(f'de[{a},{x}] analytic {de[a, x]:.10f}  central differences '
              f'{fd[a, x]:.10f}  diff {diff:.3e}')
        check(diff < 1e-6, f'gradient vs central differences at ({a},{x}): '
              f'{diff:.3e} >= 1e-6')

    # the same molecule on coordinates that are D6h to float64's rounding
    # (moved by up to 3e-7 Angstrom): the six-fold equalities to 1e-8
    mfs = tight_rhf(mf.mol.copy().set_geom_(d6h_ring(mf.mol.coords)))
    mfs.kernel()
    norms = np.linalg.norm(mfs.nuc_grad_method().kernel(), axis=1)
    sym_c = float(np.ptp(norms[:6]))
    sym_h = float(np.ptp(norms[6:]))
    print(f'on the D6h-symmetrised ring: |de| C {norms[0]:.10f} (spread '
          f'{sym_c:.3e})  H {norms[6]:.10f} (spread {sym_h:.3e})')
    check(mfs.converged and sym_c < 1e-8 and sym_h < 1e-8,
          f'D6h ring: gradient norms differ by {sym_c:.3e} (C), '
          f'{sym_h:.3e} (H) >= 1e-8')
    del mfs
    torch.cuda.empty_cache()

    walls, phases = [], []
    for _ in range(3):
        mf.mol._j3c_cache.pop('ip1e')     # a warm call rebuilds everything
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad.kernel()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(grad.timings))
    print(f'RHF gradient warm: wall median {np.median(walls):.4f} s '
          f'(min {min(walls):.4f}, max {max(walls):.4f})  '
          + '  '.join(f'{k} {np.median([p[k] for p in phases]):.4f}'
                      for k in phases[0]))
    del mf, grad
    torch.cuda.empty_cache()

    mfw = tight_rhf(pt.M(atom=refs.WATER, basis='def2-svp'))
    dew = mfw.run().nuc_grad_method().kernel()
    ew = mfw.e_tot
    err = float(np.abs(dew - np.array(refs.GRAD_WATER_RHF_DEF2SVP)).max())
    print(f'water/def2-SVP RHF: E - E_ref {ew - refs.E_WATER_RHF_DEF2SVP:.3e}'
          f'  max |de - de_ref| {err:.3e}')
    check(mfw.converged and err < 1e-8,
          f'water gradient vs the recorded JAX gradient: {err:.3e} >= 1e-8')
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit('CUDA is not available: chip_smoke.py runs only on '
                         'a machine with an NVIDIA GPU')
    import pyscf_tpu_torch as pt
    from pyscf_tpu_torch import refs
    from pyscf_tpu_torch.ops import kernels

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          'python', sys.version.split()[0])
    print(f'kernel build: {kernels.build():.1f} s', flush=True)

    report = {}
    integral_phases(pt, refs, report)
    rhf = df_rhf_path(pt, refs, kernels)
    eigh_residual(rhf)
    grid_xc_phases(pt, kernels, rhf.mol, rhf.make_rdm1(), report)
    del rhf
    launches = df_rks_path(pt, refs, kernels)
    int2e_phase(pt, refs, kernels, report)
    torch.cuda.empty_cache()
    launches['int2e'] = incore_rhf_path(pt, refs, kernels)['int2e']
    torch.cuda.empty_cache()
    uks, uks_launches = df_uks_path(pt, refs, kernels)
    launches['xc_uks'] = uks_launches['xc_uks']
    xc_uks_phase(kernels, uks, report)
    del uks
    torch.cuda.empty_cache()
    deriv_phases(pt, refs, kernels, report)
    torch.cuda.empty_cache()
    grad_launches = rhf_grad_path(pt, refs, kernels)
    launches.update({k: grad_launches[k] for k in GRAD_KERNELS})

    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', launches=launches[name], **r)
        for name, r in report.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
