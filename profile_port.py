#!/usr/bin/env python3
"""Phase times and a device profile of the port's paths on one NVIDIA GPU.

    python3 profile_port.py [--runs 10] [--top 12] [--paths NAME ...]

Builds the kernels, then for the paths of chip_smoke.py (minao guess,
conv_tol 1e-8): benzene/def2-SVP DF-RHF, DF-RKS b3lypg and in-core RHF,
the phenyl radical's DF-UKS b3lypg/def2-SVP, benzene's in-core RHF
(conv_tol 1e-11) followed by its analytic gradient, benzene's DF-RKS
b3lypg and DF-RHF and phenyl's DF-UKS b3lypg (conv_tol 1e-10,
conv_tol_grad 1e-7) followed by theirs (one geometry step of the phenyl
optimisation), and benzene's DF-RKS and phenyl's DF-UKS wB97X-V (the
long-range factor's phases j2c_lr and j3c_lr, and vv10, the seconds of
the `vv10` launches inside scf_loop from their CUDA events), and
benzene's in-core and DF RHF (conv_tol 1e-12, conv_tol_grad 1e-9)
followed by MP2, CCSD (conv_tol 1e-10, conv_tol_normt 1e-8) and (T)
(phases mp2, ccsd_eris, ccsd, ccsd_cycle, the median cycle, ccsd_ncycle,
the cycle count, and ccsd_t), and benzene's DF-RKS b3lypg (conv_tol 1e-10,
conv_tol_grad 1e-7) followed by mf.TDA() (four singlets by Davidson:
phases tda, tda_cycles, tda_matvecs) and mf.TDDFT() (five singlets,
dense: tddft_get_ab, tddft_eigh), and benzene's DF-RHF (conv_tol 1e-12,
conv_tol_grad 1e-8) followed by mf.Hessian().kernel() (the phases of
hessian/rhf.py prefixed hess_, hessian, hess_cphf_cycles), and BASELINE
configs 3 and 4: (H2O)10 DF-RHF/cc-pVTZ and N2/cc-pVQZ in-core RHF
(conv_tol 1e-12, conv_tol_grad 1e-9) followed by MP2, CCSD and (T), as
benzene's; or for the paths named by --paths, runs
each once cold and `--runs` times warm, every run
from a fresh Mole, and prints the median, quartiles, min and max of each
phase of mf.timings (and of the gradient's timings, prefixed grad_) and
of the wall time from M() to the energy or gradient (host clock, ended by
a synchronize). Then one
more warm run of each under torch.profiler prints the device time (the sum
of the device's own events: kernels, copies and memsets), the wall, the
device-busy share, the share of the XC response kernels (`xc_fxc`,
`xc_fxc_pairs`, `xc_rks_fxc`, `xc_uks_fxc`) in the device time and the
device events that take the most time. The last line is one JSON object
with these numbers.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch


GRADIENT = 'in-core RHF + gradient'
DF_GRADIENTS = ('DF-RKS b3lypg + gradient', 'DF-RHF + gradient',
                'DF-UKS phenyl + gradient')
POSTSCF = ('in-core CCSD(T)', 'DF-CCSD(T)', 'N2/cc-pVQZ CCSD(T)')
TDDFT = 'DF-RKS TDA'
HESSIAN = 'DF-RHF + Hessian'
PATHS = {
    'DF-RHF': lambda pt, refs: pt.M(atom=refs.BENZENE, basis='def2-svp')
    .RHF().density_fit(),
    'DF-RKS b3lypg': lambda pt, refs: pt.dft.RKS(
        pt.M(atom=refs.BENZENE, basis='def2-svp'), xc='b3lypg').density_fit(),
    'in-core RHF': lambda pt, refs: pt.M(atom=refs.BENZENE,
                                         basis='def2-svp').RHF(),
    'DF-UKS b3lypg phenyl': lambda pt, refs: pt.M(
        atom=refs.PHENYL, basis='def2-svp', spin=1).UKS(
        xc='b3lypg').density_fit(),
    GRADIENT: lambda pt, refs: pt.M(atom=refs.BENZENE,
                                    basis='def2-svp').RHF(),
    DF_GRADIENTS[0]: lambda pt, refs: pt.dft.RKS(
        pt.M(atom=refs.BENZENE, basis='def2-svp'), xc='b3lypg').density_fit(),
    DF_GRADIENTS[1]: lambda pt, refs: pt.M(atom=refs.BENZENE,
                                           basis='def2-svp').RHF()
    .density_fit(),
    DF_GRADIENTS[2]: lambda pt, refs: pt.M(
        atom=refs.PHENYL, basis='def2-svp', spin=1).UKS(
        xc='b3lypg').density_fit(),
    'DF-RKS wb97x-v': lambda pt, refs: pt.dft.RKS(
        pt.M(atom=refs.BENZENE, basis='def2-svp'), xc='wb97x-v').density_fit(),
    'DF-UKS wb97x-v phenyl': lambda pt, refs: pt.M(
        atom=refs.PHENYL, basis='def2-svp', spin=1).UKS(
        xc='wb97x-v').density_fit(),
    POSTSCF[0]: lambda pt, refs: pt.M(atom=refs.BENZENE,
                                      basis='def2-svp').RHF(),
    POSTSCF[1]: lambda pt, refs: pt.M(atom=refs.BENZENE,
                                      basis='def2-svp').RHF().density_fit(),
    TDDFT: lambda pt, refs: pt.dft.RKS(
        pt.M(atom=refs.BENZENE, basis='def2-svp'), xc='b3lypg').density_fit(),
    HESSIAN: lambda pt, refs: pt.M(atom=refs.BENZENE,
                                   basis='def2-svp').RHF().density_fit(),
    # BASELINE configs 3 and 4 (f and g shells)
    'DF-RHF (H2O)10/cc-pVTZ': lambda pt, refs: pt.scf.RHF(
        pt.M(atom=refs.H2O10, basis='cc-pvtz')).density_fit(),
    POSTSCF[2]: lambda pt, refs: pt.M(atom=refs.N2, basis='cc-pvqz').RHF(),
}


def synced(fn):
    """(fn(), seconds) on the host clock, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def postscf_timings(mf):
    """MP2, CCSD and (T) of a converged RHF: their seconds, the CCSD's
    MO-block phase, median cycle and cycle count."""
    _, mp2 = synced(lambda: mf.MP2().kernel())
    mycc = mf.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    _, cc = synced(mycc.kernel)
    if not mycc.converged:
        raise SystemExit('CCSD did not converge')
    _, et = synced(mycc.ccsd_t)
    return dict(mp2=mp2, ccsd_eris=mycc.timings['eris'], ccsd=cc,
                ccsd_cycle=float(np.median(mycc.timings['cycles'])),
                ccsd_ncycle=mycc.cycles, ccsd_t=et)


def tddft_timings(mf):
    """mf.TDA() by Davidson (four singlets: its seeds are then the four
    degenerate HOMO -> LUMO pairs) and mf.TDDFT() (five singlets, dense):
    their seconds, the Davidson's iterations and matvecs, and the dense
    path's get_ab and eigh."""
    td = mf.TDA()
    _, tda = synced(lambda: td.kernel(nstates=4))
    if not td.converged:
        raise SystemExit('TDA did not converge')
    rpa = mf.TDDFT()
    _, tddft = synced(lambda: rpa.kernel(nstates=5))
    return dict(tda=tda, tda_cycles=td.cycles, tda_matvecs=td.nmatvec,
                tddft=tddft, tddft_get_ab=rpa.timings['get_ab'],
                tddft_eigh=rpa.timings['eigh'])


def one_run(pt, refs, name):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf = PATHS[name](pt, refs)
    mf.conv_tol = 1e-11 if name == GRADIENT else 1e-8
    if name in DF_GRADIENTS or name == TDDFT:
        mf.conv_tol = 1e-10
        mf.conv_tol_grad = 1e-7
    if name in POSTSCF:
        mf.conv_tol = 1e-12
        mf.conv_tol_grad = 1e-9
    if name == HESSIAN:
        mf.conv_tol = 1e-12
        mf.conv_tol_grad = 1e-8
    mf.init_guess = 'minao'
    e = mf.kernel()
    timings = dict(mf.timings)
    if name in POSTSCF:
        timings.update(postscf_timings(mf))
    if name == TDDFT:
        timings.update(tddft_timings(mf))
    if name == HESSIAN:
        hobj = mf.Hessian()
        _, t = synced(hobj.kernel)
        timings.update({f'hess_{k}': v for k, v in hobj.timings.items()},
                       hessian=t, hess_cphf_cycles=hobj.cphf_cycles)
    if name == GRADIENT or name in DF_GRADIENTS:
        grad = mf.nuc_grad_method()
        grad.kernel()
        timings.update({f'grad_{k}': v for k, v in grad.timings.items()})
    torch.cuda.synchronize()
    if not mf.converged:
        raise SystemExit(f'{name}: SCF did not converge')
    return dict(timings, wall=time.perf_counter() - t0), e, mf.scf_cycles


def stats(xs):
    q = np.quantile(xs, [0.0, 0.25, 0.5, 0.75, 1.0])
    return dict(min=q[0], q1=q[1], median=q[2], q3=q[3], max=q[4])


def profiled(pt, refs, name, top):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t, _, _ = one_run(pt, refs, name)
    # the device's own events (kernels, copies, sets) only: a host op such
    # as aten::mm reports its kernels' time again
    dev = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0.0))
            dev.append((us, ev.count, ev.key))
    dev.sort(reverse=True)
    device_s = sum(us for us, _, _ in dev) * 1e-6
    fxc_s = sum(us for us, _, key in dev if 'fxc' in key) * 1e-6
    wall = t['wall']
    print(f'profiled {name}: wall {wall:.6f} s, device '
          f'{device_s:.6f} s, busy {device_s / wall:.3f}, idle '
          f'{1 - device_s / wall:.3f}, XC response kernels {fxc_s:.6f} s '
          f'({fxc_s / device_s:.3f} of the device time)')
    for us, n, key in dev[:top]:
        print(f'  {us * 1e-3:10.3f} ms  {n:6d}x  {key[:90]}')
    return dict(wall=wall, device_s=device_s, busy=device_s / wall,
                fxc_s=fxc_s,
                top=[dict(ms=us * 1e-3, count=n, name=key)
                     for us, n, key in dev[:top]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=10)
    ap.add_argument('--top', type=int, default=12)
    ap.add_argument('--paths', nargs='+', choices=list(PATHS),
                    default=list(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('CUDA is not available: profile_port.py measures '
                         'the card')
    import pyscf_tpu_torch as pt
    from pyscf_tpu_torch import refs
    from pyscf_tpu_torch.ops import kernels
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'kernel build: {kernels.build():.1f} s')
    out = {'card': card}
    for name in args.paths:
        cold, e, ncyc = one_run(pt, refs, name)
        runs = [one_run(pt, refs, name)[0] for _ in range(args.runs)]
        print(f'{name}: E = {e!r}, {ncyc} cycles; cold run '
              + ' '.join(f'{k} {v:.6f}' for k, v in cold.items()))
        table = {k: stats([r[k] for r in runs]) for k in runs[0]}
        for k, s in table.items():
            print(f'  {k:9s} median {s["median"]:.6f}  min {s["min"]:.6f}  '
                  f'max {s["max"]:.6f}  q1 {s["q1"]:.6f}  q3 {s["q3"]:.6f}')
        out[name] = dict(energy=e, cycles=ncyc, cold=cold, warm=table,
                         profile=profiled(pt, refs, name, args.top))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
