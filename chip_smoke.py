#!/usr/bin/env python3
"""Smoke run of pyscf_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's DF-RHF path for benzene/def2-SVP on the card, in order:
  1. refuses to run without CUDA; prints the card's name and power limit;
  2. builds the CUDA kernels from pyscf_tpu_torch/csrc (nvcc, sm_90a);
  3. kernel phases at the main path's shapes: each kernel against its plain
     PyTorch twin on the same card inputs (S/T/V <= 1e-12; raw 3c rows and
     (P|Q) <= 1e-12 x max|value|; the whitened factor B <= 1e-10), with
     both times from CUDA events;
  4. the main path through the public entry points,
     M(..., device='cuda').RHF().density_fit().kernel() with the minao guess
     and conv_tol 1e-8: it must converge to the recorded JAX energy within
     1e-8 Ha, and every kernel must have launched in that run;
  5. one JSON line with the per-kernel numbers, then the result line
     {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is non-zero.
"""
import json
import subprocess
import sys
import time

import torch


def cuda_ms(fn, reps=3):
    """Mean milliseconds of fn() on the current stream, after one warm-up."""
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


def show(name, r):
    print(f'{name}: max_abs_err {r["max_abs_err"]:.3e}  '
          f'kernel {r["ms"]:.3f} ms  plain {r["plain_ms"]:.3f} ms', flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f'FAILED: {what}')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('CUDA is not available: chip_smoke.py runs only on '
                         'a machine with an NVIDIA GPU')
    import pyscf_tpu_torch as pt
    from pyscf_tpu_torch import refs
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.lib.linalg import EIGH_REFINE, canonical_orth
    from pyscf_tpu_torch.ops import kernels
    from pyscf_tpu_torch.ops.integrals import int1e, j3c

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          'python', sys.version.split()[0])

    print(f'kernel build: {kernels.build():.1f} s')

    # ---- kernel phases at the main path's shapes --------------------------
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
    report = {}

    def stv(fn):
        out = [fn(la, lb, *p, zr, zq) for (la, lb), (_, p) in classes.items()]
        return out + [fn(la, lb, *p, with_tv=False)
                      for la, lb, _, _, p in cross]

    k_out, p_out = stv(kernels.int1e_stv), stv(int1e.class_stv)
    err, _ = max_abs(list(zip(k_out, p_out)))
    report['int1e_stv'] = dict(
        source='pyscf_tpu_torch/csrc/int1e_stv.cu',
        replaces='pyscf_tpu/ops/integrals/j1e.py:30', max_abs_err=err,
        ms=cuda_ms(lambda: stv(kernels.int1e_stv)),
        plain_ms=cuda_ms(lambda: stv(int1e.class_stv)))
    show('int1e_stv', report['int1e_stv'])
    check(err <= 1e-12, f'int1e_stv vs plain: {err:.3e} > 1e-12')

    def rows(fn):
        return {cls: fn(*cls, *p, aux) for cls, (_, p) in classes.items()}

    rows_k, rows_p = rows(kernels.int3c2e), rows(j3c.int3c2e_plain)
    err, scale = max_abs([(rows_k[c], rows_p[c]) for c in rows_k])
    report['int3c2e'] = dict(
        source='pyscf_tpu_torch/csrc/int3c2e.cu',
        replaces='pyscf_tpu/ops/integrals/j3c.py:188', max_abs_err=err,
        ms=cuda_ms(lambda: rows(kernels.int3c2e)),
        plain_ms=cuda_ms(lambda: rows(j3c.int3c2e_plain)))
    show('int3c2e', report['int3c2e'])
    check(err <= 1e-12 * scale, f'int3c2e vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    jg_k, jg_p = kernels.int2c2e(aux), j3c.int2c2e_plain(aux)
    err, scale = max_abs([(jg_k, jg_p)])
    report['int2c2e'] = dict(
        source='pyscf_tpu_torch/csrc/int2c2e.cu',
        replaces='pyscf_tpu/ops/integrals/j3c.py:266', max_abs_err=err,
        ms=cuda_ms(lambda: kernels.int2c2e(aux)),
        plain_ms=cuda_ms(lambda: j3c.int2c2e_plain(aux)))
    show('int2c2e', report['int2c2e'])
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
    del rows_k, rows_p, B_k, B_p, B_pp

    # ---- main path ---------------------------------------------------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    mf = mol.RHF().density_fit()
    mf.conv_tol = 1e-8
    mf.init_guess = 'minao'
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    de = e - refs.E_BENZENE_DF_RHF_DEF2SVP
    print(f'DF-RHF benzene/def2-SVP: E = {e!r}  E - E_ref = {de:.3e}  '
          f'converged {mf.converged}  cycles {mf.scf_cycles}  '
          f'wall {wall:.3f} s')
    t = dict(mf.timings, df_factor=mf.timings['j2c'] + mf.timings['j3c'])
    print('phase seconds: ' + '  '.join(f'{k} {v:.4f}' for k, v in t.items()))
    print(f'launches: {launches}')
    check(mf.converged, 'SCF did not converge')
    check(abs(de) < 1e-8, f'|E - E_ref| = {abs(de):.3e} >= 1e-8')
    check(mf.mo_energy.shape == (mol.nao,)
          and bool(torch.isfinite(mf.mo_energy).all()),
          'mo_energy is not finite of shape (nao,)')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} never launched on the main path')

    # eigh residual at n = nao, on the converged Fock in the orthogonal basis
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

    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', launches=launches[name], **r)
        for name, r in report.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
