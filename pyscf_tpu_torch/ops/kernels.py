"""Wrappers of the hand-written CUDA kernels.

Thirty-nine kernels carry the DF-RHF/RKS/UKS and in-core paths with the
range-separated and VV10 functionals, the conventional RHF gradient, the
DF-RHF/RKS/UHF/UKS gradients, the dipole of the SCF analysis, MP2, UMP2,
CCSD and CCSD(T), TDA/TDHF/TDDFT and the DF-RHF, DF-RKS, DF-UHF and
DF-UKS nuclear Hessians, and the Γ-point and k-point periodic SCF (sources in
pyscf_tpu_torch/csrc/):

  int1e_stv  S/T/V rows per screened shell pair   (csrc/int1e_stv.cu)
  int3c2e    raw (ij|P) rows of one bra class     (csrc/int3c2e.cu)
  int3c2e_lr the same of erf(omega r)/r, counted  (csrc/int3c2e.cu)
             apart
  int2c2e    the (P|Q) metric                     (csrc/int2c2e.cu)
  int2c2e_lr the same of erf(omega r)/r           (csrc/int2c2e.cu)
  int2e      (ab|cd) rows of one bra class        (csrc/int2e.cu)
  int2e_lr   the same of erf(omega r)/r           (csrc/int2e.cu)
  int1e_ip   d/dA of S/T/V per ordered shell pair (csrc/int1e_ip.cu)
  int1e_iprinv  d/dC of <a|1/|r-C||b> per ordered (csrc/int1e_iprinv.cu)
             shell pair and centre
  int2e_ip1  d/dA (ab|cd) rows of one ordered bra (csrc/int2e_ip1.cu)
             class
  int3c2e_ip d(ij|P)/dA, /dB of one bra class,    (csrc/int3c2e_ip.cu,
             contracted with Gamma^P_ij            csrc/coulomb_ip.cuh)
  int2c2e_ip1  d(P|Q)/dP contracted with W_PQ      (csrc/int2c2e_ip1.cu)
  eval_ao    AO values and gradients on points    (csrc/eval_ao.cu)
  eval_ao_deriv2  the same kernel's deriv 2: with the second derivatives,
             counted apart
  eval_ao_deriv3  its deriv 3: with the third derivatives, counted apart
  eval_ao_pbc  AO values and gradients summed    (csrc/eval_ao_pbc.cu)
             over the lattice images
  eval_ao_kpts  Bloch sums of the AO values and   (csrc/eval_ao_kpts.cu)
             gradients, sum_L e^{ik.L} phi(r - L),
             for every k-point at once
  becke      Becke partition weights of the grid  (csrc/becke.cu)
  xc_rks     density, functional (B3LYP and PBE   (csrc/xc_rks.cu,
             families, CAM-B88, the B97 series)     csrc/xc_funcs.cuh)
             and the V_xc
             half-product per point
  xc_uks     the same for two spin densities      (csrc/xc_uks.cu)
  xc_rks_grad  the XC energy's nuclear gradient   (csrc/xc_rks_grad.cu)
             per AO on a fixed grid
  xc_uks_grad  the same for two spin densities    (csrc/xc_uks_grad.cu)
  int1e_r    dipole integrals <a|r|b> per shell  (csrc/int1e_r.cu)
             pair
  vv10       the VV10 pair sum over the grid and  (csrc/vv10.cu)
             its derivatives per point
  mp2_energy the MP2 amplitudes and the direct and (csrc/mp2_energy.cu)
             exchange pair-energy sums of (ia|jb)
  ccsd_t     the (T) energy over a list of virtual (csrc/ccsd_t.cu)
             triples a >= b >= c
  xc_fxc     the XC response kernel per point,    (csrc/xc_fxc.cu,
             second-order dual numbers              csrc/xc_funcs.cuh)
  xc_fxc_pairs  the pair features P and H P per   (csrc/xc_fxc.cu,
             point and occupied-virtual pair        PT_FXC_PAIRS)
  xc_rks_fxc the tangent of xc_rks's vtmp along   (csrc/xc_rks_fxc.cu)
             transition densities
  xc_uks_fxc the same of xc_uks's                 (csrc/xc_uks_fxc.cu)
  int1e_ipip second derivatives of S, T and V per (csrc/int1e_ipip.cu,
             ordered shell pair, contracted with D   csrc/hess2.cuh)
             and W
  int3c2e_ip1  d(ij|P)/dA_i written out, every    (csrc/int3c2e_ip1.cu,
             ordered pair                           csrc/coulomb_ipip.cuh)
  int2c2e_ip1_full  d(P|Q)/dP written out         (csrc/int2c2e_ipip.cu,
                                                    PT_IP1_FULL)
  int3c2e_ipip  d2(ij|P) on A and B contracted    (csrc/int3c2e_ipip.cu)
             with Gamma^P_ij
  int2c2e_ipip  d2(P|Q)/dP dP contracted with     (csrc/int2c2e_ipip.cu)
             W_PQ
  xc_rks_hess  the XC energy's fixed-D second    (csrc/xc_rks_hess.cu)
             derivative along the geometry per
             point: u_t, w H u_t, the same-atom
             blocks, the explicit rows
  xc_rks_deriv1  the rows of dV_xc/dX at fixed D (csrc/xc_rks_hess.cu,
             per point and tangent                  PT_XC_DERIV1)
  xc_uks_hess  the same as xc_rks_hess for two    (csrc/xc_uks_hess.cu)
             spin densities
  xc_uks_deriv1  the same as xc_rks_deriv1 for   (csrc/xc_uks_hess.cu,
             both spins                             PT_XC_DERIV1)

Each wrapper takes float64 (int32 for indices) contiguous tensors on one
device. On a CPU tensor it runs the kernel's plain PyTorch twin; on a CUDA
tensor it launches the kernel on torch.cuda.current_stream() or raises. A
wrapper adds one to its `launches` count for every kernel launch it makes.

The integral, derivative and Hessian kernels take s to g shells and aux
shells to h (la, lb <= 4, lc <= 5: la <= lb where the kernel's
contraction is symmetric, every ordered pair for the derivative bras of
int1e_ip, int1e_iprinv, int1e_ipip and int3c2e_ip1), except int2e_ip1,
the in-core gradient's, which stops at d (every ordered la, lb <= 2, lc <=
ld <= 2); a class that has no instantiation raises NotImplementedError.
The kernels are compiled at first use with nvcc for sm_90a, one shared
library per source (five each for int3c2e.cu, int3c2e_ip.cu,
int3c2e_ip1.cu and int3c2e_ipip.cu, one per bra momentum; fifteen for
int2e.cu, one per bra class la <= lb; nine for int2e_ip1.cu, one per
ordered bra class; two each for xc_fxc.cu, int2c2e_ipip.cu, xc_rks_hess.cu
and xc_uks_hess.cu, one per kernel: seventy-two libraries) with a plain C
interface loaded by ctypes, into
pyscf_tpu_torch/_build/<hash of the sources and flags>/, so a fresh
checkout builds them once and an edit to a source rebuilds them; nvcc's
output, with ptxas's registers, stack frame and spills per kernel
instantiation, and the library's compile seconds, is kept beside each
library as <library>.log.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..dft import gen_grid, numint
from ..dft import vv10 as vv10_mod
from . import eval_gto
from .integrals import (int1e, int1e_deriv, int2e as int2e_mod, j2e, j3c,
                        j3c_deriv)
from .integrals.int1e import sph

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
_HEADERS = ('boys.cuh', 'coulomb_ip.cuh', 'coulomb_ipip.cuh', 'hermite.cuh',
            'hess2.cuh', 'int1e.cuh', 'quartet.cuh', 'xc_funcs.cuh',
            'xc_point.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ERI_ARGS = [_I] * 7 + [_P] * 6 + [_I] * 3 + [_P] * 11 + [_I, _I, _P]
# library -> (source, exported C function, its ctypes argtypes, extra nvcc
# flags)
_LIBRARIES = {
    'int1e_stv': ('int1e_stv.cu', 'pt_int1e_stv',
                  [_I] * 6 + [_P] * 6 + [_I] + [_P] * 6, ()),
    'int2c2e': ('int2c2e.cu', 'pt_int2c2e', [_I] * 4 + [_P] * 3 + [_I, _I]
                + [_P] * 6 + [_I, _I, _I, _D, _P], ()),
    'int1e_ip': ('int1e_ip.cu', 'pt_int1e_ip',
                 [_I] * 5 + [_P] * 6 + [_I] + [_P] * 6, ()),
    'int1e_iprinv': ('int1e_iprinv.cu', 'pt_int1e_iprinv',
                     [_I] * 5 + [_P] * 6 + [_I] + [_P] * 5, ()),
    # no FMA contraction: the AO values keep the plain twin's rounding
    'eval_ao': ('eval_ao.cu', 'pt_eval_ao', [_I] * 5 + [_P] * 7 + [_I, _P],
                ('-fmad=false',)),
    'becke': ('becke.cu', 'pt_becke', [_I, _I] + [_P] * 8, ()),
    'eval_ao_pbc': ('eval_ao_pbc.cu', 'pt_eval_ao_pbc', [_I] * 6 + [_P] * 6
                    + [_D, _P, _P, _I, _P], ()),
    'eval_ao_kpts': ('eval_ao_kpts.cu', 'pt_eval_ao_kpts', [_I] * 7
                     + [_P] * 7 + [_D, _P, _P, _I, _P], ()),
    # no FMA contraction: the range-separated attenuation cancels to ~1e-5
    # of its terms, and the plain twin's rounding is kept
    'xc_rks': ('xc_rks.cu', 'pt_xc_rks', [_I] * 3 + [_P] * 3 + [_I]
               + [_P] * 5 + [_I, _P], ('-fmad=false',)),
    'xc_uks': ('xc_uks.cu', 'pt_xc_uks', [_I] * 3 + [_P] * 3 + [_I]
               + [_P] * 5 + [_I, _P], ('-fmad=false',)),
    'int2c2e_ip1': ('int2c2e_ip1.cu', 'pt_int2c2e_ip1', [_I] * 4 + [_P] * 3
                    + [_I, _I] + [_P] * 6 + [_I] * 3 + [_P] + [_I] * 3 + [_P],
                    ()),
    'xc_rks_grad': ('xc_rks_grad.cu', 'pt_xc_rks_grad', [_I] * 3 + [_P] * 3
                    + [_I] + [_P] * 4 + [_I, _I, _P], ()),
    'xc_uks_grad': ('xc_uks_grad.cu', 'pt_xc_uks_grad', [_I] * 3 + [_P] * 3
                    + [_I] + [_P] * 4 + [_I, _I, _P], ()),
    'int1e_r': ('int1e_r.cu', 'pt_int1e_r', [_I] * 5 + [_P] * 10, ()),
    'vv10': ('vv10.cu', 'pt_vv10', [_I] + [_P] * 4 + [_D, _D, _P, _I, _P],
             ()),
    'mp2_energy': ('mp2_energy.cu', 'pt_mp2_energy', [_I] * 4 + [_P] * 4
                   + [_I, _P, _P, _I, _P], ()),
    'ccsd_t': ('ccsd_t.cu', 'pt_ccsd_t', [_I] * 4 + [_P] * 2 + [_I]
               + [_P] * 10 + [_I, _P], ()),
    # the XC response: no FMA contraction, as in xc_rks and xc_uks; the
    # pair features are a second launch from the same source; the kernels
    # on second-order dual numbers call the XC components as functions
    # (PT_XC_NOINLINE, csrc/xc_funcs.cuh)
    'xc_fxc': ('xc_fxc.cu', 'pt_xc_fxc', [_I, _D, _I, _I] + [_P] * 3 + [_I]
               + [_P] * 3 + [_I, _P], ('-fmad=false', '-DPT_XC_NOINLINE')),
    'xc_fxc_pairs': ('xc_fxc.cu', 'pt_xc_fxc_pairs', [_I] * 3 + [_P] * 3
                     + [_I] * 4 + [_P] * 2 + [_I, _P], ('-DPT_FXC_PAIRS',)),
    'xc_rks_fxc': ('xc_rks_fxc.cu', 'pt_xc_rks_fxc', [_I] * 4 + [_P] * 4
                   + [_I] + [_P] * 4, ('-fmad=false', '-DPT_XC_NOINLINE')),
    'xc_uks_fxc': ('xc_uks_fxc.cu', 'pt_xc_uks_fxc', [_I] * 4 + [_P] * 4
                   + [_I] + [_P] * 4, ('-fmad=false', '-DPT_XC_NOINLINE')),
    # the nuclear Hessian's second-derivative integrals; the metric's
    # uncontracted first derivative is a second launch from int2c2e_ipip.cu
    'int1e_ipip': ('int1e_ipip.cu', 'pt_int1e_ipip',
                   [_I] * 5 + [_P] * 6 + [_I] + [_P] * 8, ()),
    'int2c2e_ipip': ('int2c2e_ipip.cu', 'pt_int2c2e_ipip', [_I] * 4
                     + [_P] * 3 + [_I, _I] + [_P] * 6 + [_I] * 3 + [_P]
                     + [_I] * 3 + [_P], ()),
    'int2c2e_ip1_full': ('int2c2e_ipip.cu', 'pt_int2c2e_ip1_full', [_I] * 4
                         + [_P] * 3 + [_I, _I] + [_P] * 6 + [_I] * 3 + [_P]
                         + [_I] * 3 + [_P], ('-DPT_IP1_FULL',)),
    # the DF-RKS Hessian's XC terms: no FMA contraction in the functional,
    # as in the other XC kernels; the rows of dV_xc/dX a second launch
    'xc_rks_hess': ('xc_rks_hess.cu', 'pt_xc_rks_hess', [_I] * 4 + [_P] * 4
                    + [_I] + [_P] * 8, ('-fmad=false', '-DPT_XC_NOINLINE')),
    'xc_rks_deriv1': ('xc_rks_hess.cu', 'pt_xc_rks_deriv1', [_I] * 5
                      + [_P] * 7, ('-DPT_XC_DERIV1',)),
    # the DF-UKS Hessian's: the same two launches for both spins
    'xc_uks_hess': ('xc_uks_hess.cu', 'pt_xc_uks_hess', [_I] * 4 + [_P] * 4
                    + [_I] + [_P] * 8, ('-fmad=false', '-DPT_XC_NOINLINE')),
    'xc_uks_deriv1': ('xc_uks_hess.cu', 'pt_xc_uks_deriv1', [_I] * 5
                      + [_P] * 7, ('-DPT_XC_DERIV1',)),
}
# int3c2e.cu, int3c2e_ip.cu, int3c2e_ip1.cu and int3c2e_ipip.cu once per bra
# momentum la <= 4, int2e.cu once per bra class la <= lb <= 4 and
# int2e_ip1.cu once per ordered bra class la, lb <= 2: so that their
# instantiations compile side by side
_LIBRARIES.update({
    f'int3c2e_la{la}': ('int3c2e.cu', 'pt_int3c2e', [_I] * 6 + [_P] * 6
                        + [_I, _I] + [_P] * 7 + [_I, _I, _D, _P],
                        (f'-DPT_LA={la}',)) for la in range(5)})
_LIBRARIES.update({
    f'int2e_{la}{lb}': ('int2e.cu', 'pt_int2e', _ERI_ARGS[:-1] + [_D, _P],
                        (f'-DPT_LA={la}', f'-DPT_LB={lb}'))
    for la in range(5) for lb in range(la, 5)})
_LIBRARIES.update({
    f'int2e_ip1_{la}{lb}': ('int2e_ip1.cu', 'pt_int2e_ip1', _ERI_ARGS,
                            (f'-DPT_LA={la}', f'-DPT_LB={lb}'))
    for la in range(3) for lb in range(3)})
_LIBRARIES.update({
    f'int3c2e_ip_la{la}': ('int3c2e_ip.cu', 'pt_int3c2e_ip',
                           [_I] * 6 + [_P] * 6 + [_I, _I] + [_P] * 7
                           + [_I, _I, _P, _I, _I, _P], (f'-DPT_LA={la}',))
    for la in range(5)})
_LIBRARIES.update({
    f'int3c2e_ip1_la{la}': ('int3c2e_ip1.cu', 'pt_int3c2e_ip1',
                            [_I] * 6 + [_P] * 6 + [_I, _I] + [_P] * 8
                            + [_I] * 3 + [_P, _P], (f'-DPT_LA={la}',))
    for la in range(5)})
_LIBRARIES.update({
    f'int3c2e_ipip_la{la}': ('int3c2e_ipip.cu', 'pt_int3c2e_ipip',
                             [_I] * 6 + [_P] * 6 + [_I, _I] + [_P] * 7
                             + [_I, _I, _P, _I, _I, _P], (f'-DPT_LA={la}',))
    for la in range(5)})
_LIBS = {}      # library -> loaded ctypes function


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (PATH or /usr/local/cuda/bin)')
    return path


def _build_dir():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for lib, (src, _, _, extra) in _LIBRARIES.items():
        h.update(f'{lib} {src} {" ".join(extra)}\0'.encode())
    for name in sorted({src for src, _, _, _ in _LIBRARIES.values()}
                       | set(_HEADERS)):
        with open(os.path.join(_CSRC, name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return os.path.join(_BUILD, h.hexdigest()[:16])


def build():
    """Compile the kernel libraries that are missing and load them all.

    Returns the seconds spent. The libraries compile in parallel; each
    output is written under a temporary name and renamed, so concurrent
    builds in one checkout do not see half-written libraries."""
    if len(_LIBS) == len(_LIBRARIES):
        return 0.0
    t0 = time.perf_counter()
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for lib, (src, _, _, extra) in _LIBRARIES.items():
        so = os.path.join(out_dir, lib + '.so')
        if os.path.exists(so):
            continue
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, '-I', _CSRC, '-o', tmp,
               os.path.join(_CSRC, src)]
        with open(tmp + '.log', 'w') as log:
            jobs.append((lib, so, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    errors = []
    while jobs:
        # each library's compile seconds, taken when its nvcc ends
        time.sleep(0.1)
        for job in [j for j in jobs if j[4].poll() is not None]:
            jobs.remove(job)
            lib, so, tmp, t_start, proc = job
            seconds = time.perf_counter() - t_start
            with open(tmp + '.log') as f:
                log = f.read()
            os.remove(tmp + '.log')
            if proc.returncode != 0:
                errors.append(f'nvcc failed on {lib}:\n{log}')
                continue
            with open(so[:-3] + '.log', 'w') as f:
                f.write(f'{log}compile seconds: {seconds:.1f}\n')
            os.replace(tmp, so)
    if errors:
        raise RuntimeError('\n'.join(errors))
    for lib, (_, name, argtypes, _) in _LIBRARIES.items():
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, lib + '.so')), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[lib] = fn
    return time.perf_counter() - t0


def _fn(lib):
    if lib not in _LIBRARIES:
        raise NotImplementedError(f'{lib}: no such CUDA kernel library (the '
                                  'class is not instantiated)')
    build()
    return _LIBS[lib]


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc, what):
    if rc == -1:
        raise NotImplementedError(f'{what}: not instantiated in the CUDA '
                                  'kernel')
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {rc}')


def _check(device, *named):
    """float64, contiguous, on `device`, with the given shape."""
    for name, t, shape in named:
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, expected {device}')
        if t.dtype != torch.float64:
            raise TypeError(f'{name} has dtype {t.dtype}, expected float64')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {tuple(shape)}')


def _check_index(device, name, t, n):
    """int32, contiguous, on `device`, of shape (n,)."""
    if (t.device != device or t.dtype != torch.int32
            or tuple(t.shape) != (n,) or not t.is_contiguous()):
        raise ValueError(f'{name} must be a contiguous int32 ({n},) tensor '
                         f'on {device}')


def _device_of(t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {t.device}')
    return t.device


def _check_pairs(dev, ea, ca, ra, eb, cb, rb):
    n, Ka = ea.shape
    Kb = eb.shape[1]
    _check(dev, ('ea', ea, (n, Ka)), ('ca', ca, (n, Ka)), ('ra', ra, (n, 3)),
           ('eb', eb, (n, Kb)), ('cb', cb, (n, Kb)), ('rb', rb, (n, 3)))
    return n, Ka, Kb


def _check_aux(dev, aux):
    ls = [l for l, _, _, _ in aux]
    if ls != sorted(set(ls)):
        raise ValueError(f'aux classes must be in ascending l, got {ls}')
    for l, e, c, r in aux:
        nsx, K = e.shape
        _check(dev, ('aux exps', e, (nsx, K)), ('aux coeffs', c, (nsx, K)),
               ('aux coords', r, (nsx, 3)))


def int1e_stv(la, lb, ea, ca, ra, eb, cb, rb, atom_coords=None,
              atom_charges=None, with_tv=True, sb=None):
    """S/T/V rows of n shell pairs: (n, (2la+1)(2lb+1), 3), or the S rows
    alone, (n, (2la+1)(2lb+1)), when with_tv is False.

    ea/ca (n, Ka), eb/cb (n, Kb), ra/rb (n, 3); atom_coords (natm, 3) and
    atom_charges (natm,) for V; sb, a (2lb+1, ncart(lb)) matrix, in place
    of the ket's cart->sph transform."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    if with_tv:
        natm = atom_coords.shape[0]
        _check(dev, ('atom_coords', atom_coords, (natm, 3)),
               ('atom_charges', atom_charges, (natm,)))
    if sb is not None:
        _check(dev, ('sb', sb, (2 * lb + 1, (lb + 1) * (lb + 2) // 2)))
    if dev.type == 'cpu':
        return int1e.class_stv(la, lb, ea, ca, ra, eb, cb, rb, atom_coords,
                               atom_charges, with_tv, sb)
    ns1 = (2 * la + 1) * (2 * lb + 1)
    out = torch.empty((n, ns1, 3) if with_tv else (n, ns1),
                      dtype=torch.float64, device=dev)
    if n == 0:
        return out
    zr = atom_coords.data_ptr() if with_tv else None
    zq = atom_charges.data_ptr() if with_tv else None
    rc = _fn('int1e_stv')(
        la, lb, int(with_tv), n, Ka, Kb, ea.data_ptr(), ca.data_ptr(),
        ra.data_ptr(), eb.data_ptr(), cb.data_ptr(), rb.data_ptr(),
        natm if with_tv else 0, zr, zq, sph(la, dev).data_ptr(),
        (sph(lb, dev) if sb is None else sb).data_ptr(), out.data_ptr(),
        _stream())
    _raise_on(rc, f'int1e_stv({la},{lb})')
    int1e_stv.launches += 1
    return out


def int3c2e(la, lb, ea, ca, ra, eb, cb, rb, aux, omega=None):
    """Raw (ij|P) rows of n shell pairs of class (la, lb) against every aux
    shell: (n*(2la+1)(2lb+1), naux) in grouped aux order.

    aux: [(l, exps (nsx, K), coeffs (nsx, K), coords (nsx, 3))] by l. With
    omega, the rows of erf(omega r)/r: int3c2e_lr's."""
    if omega:
        return int3c2e_lr(la, lb, ea, ca, ra, eb, cb, rb, aux, omega)
    return _int3c2e(int3c2e, la, lb, ea, ca, ra, eb, cb, rb, aux, 0.0)


def int3c2e_lr(la, lb, ea, ca, ra, eb, cb, rb, aux, omega):
    """int3c2e's rows of the erf(omega r)/r attenuated operator (omega > 0),
    the long-range DF factor of a range-separated functional's K; the same
    kernel, counted apart."""
    return _int3c2e(int3c2e_lr, la, lb, ea, ca, ra, eb, cb, rb, aux,
                    float(omega))


def _int3c2e(wrapper, la, lb, ea, ca, ra, eb, cb, rb, aux, omega):
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    _check_aux(dev, aux)
    if dev.type == 'cpu':
        return j3c.int3c2e_plain(la, lb, ea, ca, ra, eb, cb, rb, aux, omega)
    ns1 = (2 * la + 1) * (2 * lb + 1)
    naux = sum(e.shape[0] * (2 * l + 1) for l, e, _, _ in aux)
    out = torch.empty((n * ns1, naux), dtype=torch.float64, device=dev)
    col = 0
    for l, e, c, r in aux:
        nsx, Kc = e.shape
        if n and nsx:
            rc = _fn(f'int3c2e_la{la}')(
                la, lb, l, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(),
                ra.data_ptr(), eb.data_ptr(), cb.data_ptr(), rb.data_ptr(),
                nsx, Kc, e.data_ptr(), c.data_ptr(), r.data_ptr(),
                sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(),
                sph(l, dev).data_ptr(), out.data_ptr(), naux, col, omega,
                _stream())
            _raise_on(rc, f'{wrapper.__name__}({la},{lb}|{l})')
            wrapper.launches += 1
        col += nsx * (2 * l + 1)
    return out


def int2c2e(aux, omega=None):
    """(P|Q) metric over every aux shell: (naux, naux), grouped aux order;
    with omega, of erf(omega r)/r: int2c2e_lr's."""
    if omega:
        return int2c2e_lr(aux, omega)
    return _int2c2e(int2c2e, aux, 0.0)


def int2c2e_lr(aux, omega):
    """int2c2e's metric of the erf(omega r)/r attenuated operator (omega >
    0); the same kernel, counted apart."""
    return _int2c2e(int2c2e_lr, aux, float(omega))


def _int2c2e(wrapper, aux, omega):
    dev = _device_of(aux[0][1])
    _check_aux(dev, aux)
    if dev.type == 'cpu':
        return j3c.int2c2e_plain(aux, omega)
    offs = [0]
    for l, e, _, _ in aux:
        offs.append(offs[-1] + e.shape[0] * (2 * l + 1))
    naux = offs[-1]
    out = torch.empty((naux, naux), dtype=torch.float64, device=dev)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j in range(i, len(aux)):
            ly, ey, cy, ry = aux[j]
            rc = _fn('int2c2e')(
                lx, ly, ex.shape[0], ex.shape[1], ex.data_ptr(),
                cx.data_ptr(), rx.data_ptr(), ey.shape[0], ey.shape[1],
                ey.data_ptr(), cy.data_ptr(), ry.data_ptr(),
                sph(lx, dev).data_ptr(), sph(ly, dev).data_ptr(),
                out.data_ptr(), naux, offs[i], offs[j], omega, _stream())
            _raise_on(rc, f'{wrapper.__name__}({lx}|{ly})')
            wrapper.launches += 1
    return out


def _aux_offsets(aux):
    """(function offsets, shell offsets) of the aux classes, with the totals
    last."""
    offs, shs = [0], [0]
    for l, e, _, _ in aux:
        offs.append(offs[-1] + e.shape[0] * (2 * l + 1))
        shs.append(shs[-1] + e.shape[0])
    return offs, shs


def int3c2e_ip(la, lb, ea, ca, ra, eb, cb, rb, aux, G):
    """d(ij|P)/dA and d(ij|P)/dB of n shell pairs of class (la, lb), la <=
    lb <= 4, against every aux shell (l <= 5), contracted with G: (n,
    nshells, 6), per pair and aux shell the sums over the block of G times
    d/dA_xyz, then d/dB_xyz.

    G (n*(2la+1)(2lb+1), naux): rows in the layout of int3c2e's output
    (grouped aux order); aux as int3c2e's."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    _check_aux(dev, aux)
    offs, shs = _aux_offsets(aux)
    ns1 = (2 * la + 1) * (2 * lb + 1)
    _check(dev, ('G', G, (n * ns1, offs[-1])))
    if dev.type == 'cpu':
        return j3c_deriv.int3c2e_ip_plain(la, lb, ea, ca, ra, eb, cb, rb, aux,
                                          G)
    out = torch.empty((n, shs[-1], 6), dtype=torch.float64, device=dev)
    for i, (l, e, c, r) in enumerate(aux):
        nsx, Kc = e.shape
        if n and nsx:
            rc = _fn(f'int3c2e_ip_la{la}')(
                la, lb, l, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(),
                ra.data_ptr(), eb.data_ptr(), cb.data_ptr(), rb.data_ptr(),
                nsx, Kc, e.data_ptr(), c.data_ptr(), r.data_ptr(),
                sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(),
                sph(l, dev).data_ptr(), G.data_ptr(), offs[-1], offs[i],
                out.data_ptr(), shs[-1], shs[i], _stream())
            _raise_on(rc, f'int3c2e_ip({la},{lb}|{l})')
            int3c2e_ip.launches += 1
    return out


def int2c2e_ip1(aux, W):
    """d(P|Q)/dR_P of every ordered aux shell pair contracted with W:
    (nshells, nshells, 3), entry (P, Q) the sum over the block of W times
    d(P|Q)/dR_P. W (naux, naux) in grouped aux order, symmetric."""
    dev = _device_of(aux[0][1])
    _check_aux(dev, aux)
    offs, shs = _aux_offsets(aux)
    _check(dev, ('W', W, (offs[-1], offs[-1])))
    if dev.type == 'cpu':
        return j3c_deriv.int2c2e_ip1_plain(aux, W)
    out = torch.empty((shs[-1], shs[-1], 3), dtype=torch.float64, device=dev)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j, (ly, ey, cy, ry) in enumerate(aux):
            rc = _fn('int2c2e_ip1')(
                lx, ly, ex.shape[0], ex.shape[1], ex.data_ptr(),
                cx.data_ptr(), rx.data_ptr(), ey.shape[0], ey.shape[1],
                ey.data_ptr(), cy.data_ptr(), ry.data_ptr(),
                sph(lx, dev).data_ptr(), sph(ly, dev).data_ptr(),
                W.data_ptr(), offs[-1], offs[i], offs[j], out.data_ptr(),
                shs[-1], shs[i], shs[j], _stream())
            _raise_on(rc, f'int2c2e_ip1({lx}|{ly})')
            int2c2e_ip1.launches += 1
    return out


def int3c2e_ip1(la, lb, ea, ca, ra, eb, cb, rb, aux, ia, jb, out):
    """d(ij|P)/dA_i of n ordered shell pairs of class (la, lb), la, lb <= 4,
    against every aux shell (l <= 5), written into out (3, nao, nao, naux) at rows
    ia[k] + sa, columns jb[k] + sb of pair k, the aux index in grouped
    order; the rest of out is left as it is. ia, jb: the AO offsets of the
    pairs' shells, int32 (n,). Returns out."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    _check_aux(dev, aux)
    offs, _ = _aux_offsets(aux)
    nao = out.shape[1]
    _check(dev, ('out', out, (3, nao, nao, offs[-1])))
    _check_index(dev, 'ia', ia, n)
    _check_index(dev, 'jb', jb, n)
    if dev.type == 'cpu':
        return j3c_deriv.int3c2e_ip1_plain(la, lb, ea, ca, ra, eb, cb, rb,
                                           aux, ia, jb, out)
    for k, (l, e, c, r) in enumerate(aux):
        nsx, Kc = e.shape
        if n and nsx:
            rc = _fn(f'int3c2e_ip1_la{la}')(
                la, lb, l, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(),
                ra.data_ptr(), eb.data_ptr(), cb.data_ptr(), rb.data_ptr(),
                nsx, Kc, e.data_ptr(), c.data_ptr(), r.data_ptr(),
                sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(),
                sph(l, dev).data_ptr(), ia.data_ptr(), jb.data_ptr(), nao,
                offs[-1], offs[k], out.data_ptr(), _stream())
            _raise_on(rc, f'int3c2e_ip1({la},{lb}|{l})')
            int3c2e_ip1.launches += 1
    return out


def int3c2e_ipip(la, lb, ea, ca, ra, eb, cb, rb, aux, G):
    """Second derivatives of (ij|P) of n shell pairs of class (la, lb), la <=
    lb <= 4, against every aux shell (l <= 5), contracted with G: (n,
    nshells, 27), per pair and aux shell the sums over the block of G times
    d2/dA dA, d2/dA dB and d2/dB dB (3 x 3 each, row-major). G and aux as
    int3c2e_ip's."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    _check_aux(dev, aux)
    offs, shs = _aux_offsets(aux)
    ns1 = (2 * la + 1) * (2 * lb + 1)
    _check(dev, ('G', G, (n * ns1, offs[-1])))
    if dev.type == 'cpu':
        return j3c_deriv.int3c2e_ipip_plain(la, lb, ea, ca, ra, eb, cb, rb,
                                            aux, G)
    out = torch.empty((n, shs[-1], 27), dtype=torch.float64, device=dev)
    for i, (l, e, c, r) in enumerate(aux):
        nsx, Kc = e.shape
        if n and nsx:
            rc = _fn(f'int3c2e_ipip_la{la}')(
                la, lb, l, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(),
                ra.data_ptr(), eb.data_ptr(), cb.data_ptr(), rb.data_ptr(),
                nsx, Kc, e.data_ptr(), c.data_ptr(), r.data_ptr(),
                sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(),
                sph(l, dev).data_ptr(), G.data_ptr(), offs[-1], offs[i],
                out.data_ptr(), shs[-1], shs[i], _stream())
            _raise_on(rc, f'int3c2e_ipip({la},{lb}|{l})')
            int3c2e_ipip.launches += 1
    return out


def int2c2e_ip1_full(aux):
    """d(P|Q)/dR_P of every aux function pair: (3, naux, naux) in grouped
    aux order, the derivative's centre on the rows."""
    dev = _device_of(aux[0][1])
    _check_aux(dev, aux)
    offs, _ = _aux_offsets(aux)
    if dev.type == 'cpu':
        return j3c_deriv.int2c2e_ip1_full_plain(aux)
    out = torch.empty((3, offs[-1], offs[-1]), dtype=torch.float64,
                      device=dev)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j, (ly, ey, cy, ry) in enumerate(aux):
            rc = _fn('int2c2e_ip1_full')(
                lx, ly, ex.shape[0], ex.shape[1], ex.data_ptr(),
                cx.data_ptr(), rx.data_ptr(), ey.shape[0], ey.shape[1],
                ey.data_ptr(), cy.data_ptr(), ry.data_ptr(),
                sph(lx, dev).data_ptr(), sph(ly, dev).data_ptr(), None,
                offs[-1], offs[i], offs[j], out.data_ptr(), 0, 0, 0,
                _stream())
            _raise_on(rc, f'int2c2e_ip1_full({lx}|{ly})')
            int2c2e_ip1_full.launches += 1
    return out


def int2c2e_ipip(aux, W):
    """d2(P|Q)/dR_P dR_P of every ordered aux shell pair contracted with W:
    (nshells, nshells, 9), entry (P, Q) the sum over the block of W times
    the second derivatives (row-major). W as int2c2e_ip1's."""
    dev = _device_of(aux[0][1])
    _check_aux(dev, aux)
    offs, shs = _aux_offsets(aux)
    _check(dev, ('W', W, (offs[-1], offs[-1])))
    if dev.type == 'cpu':
        return j3c_deriv.int2c2e_ipip_plain(aux, W)
    out = torch.empty((shs[-1], shs[-1], 9), dtype=torch.float64, device=dev)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j, (ly, ey, cy, ry) in enumerate(aux):
            rc = _fn('int2c2e_ipip')(
                lx, ly, ex.shape[0], ex.shape[1], ex.data_ptr(),
                cx.data_ptr(), rx.data_ptr(), ey.shape[0], ey.shape[1],
                ey.data_ptr(), cy.data_ptr(), ry.data_ptr(),
                sph(lx, dev).data_ptr(), sph(ly, dev).data_ptr(),
                W.data_ptr(), offs[-1], offs[i], offs[j], out.data_ptr(),
                shs[-1], shs[i], shs[j], _stream())
            _raise_on(rc, f'int2c2e_ipip({lx}|{ly})')
            int2c2e_ipip.launches += 1
    return out


def _check_quartets(ea, ca, ra, eb, cb, rb, kets):
    """(device, bra pairs n, rows per pair, columns) of a bra class against
    the ket classes kets."""
    dev = _device_of(ea)
    n, _, _ = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    for _, _, *ket in kets:
        _check_pairs(dev, *ket)
    ncol = sum(k[2].shape[0] * (2 * k[0] + 1) * (2 * k[1] + 1) for k in kets)
    return dev, n, ncol


def _launch_quartets(wrapper, lib, la, lb, bra, kets, out, ncol, *extra):
    """One launch of lib's kernel per ket class, each writing its columns
    of out (leading dimension ncol), with the arguments extra after them;
    counted on wrapper.launches."""
    dev = out.device
    n, Ka, Kb = bra[0].shape[0], bra[0].shape[1], bra[3].shape[1]
    col = 0
    for lc, ld, *ket in kets:
        nk, Kc, Kd = ket[0].shape[0], ket[0].shape[1], ket[3].shape[1]
        if n and nk:
            rc = _fn(lib)(
                la, lb, lc, ld, n, Ka, Kb, *[t.data_ptr() for t in bra],
                nk, Kc, Kd, *[t.data_ptr() for t in ket],
                sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(),
                sph(lc, dev).data_ptr(), sph(ld, dev).data_ptr(),
                out.data_ptr(), ncol, col, *extra, _stream())
            _raise_on(rc, f'{wrapper.__name__}({la},{lb}|{lc},{ld})')
            wrapper.launches += 1
        col += nk * (2 * lc + 1) * (2 * ld + 1)


def int2e(la, lb, ea, ca, ra, eb, cb, rb, kets, omega=None):
    """(ab|cd) sph rows of n bra shell pairs of class (la, lb) against the
    ket pairs of every class in kets: (n*(2la+1)(2lb+1), sum over kets of
    nket*(2lc+1)(2ld+1)), the ket classes' columns in the order given.

    kets: [(lc, ld, ec, cc, rc, ed, cd, rd)] with lc <= ld, the pair tables
    of each ket class (as j3c.screened_pairs gives them). With omega, the
    rows of erf(omega r)/r: int2e_lr's."""
    if omega:
        return int2e_lr(la, lb, ea, ca, ra, eb, cb, rb, kets, omega)
    return _int2e(int2e, la, lb, (ea, ca, ra, eb, cb, rb), kets, 0.0)


def int2e_lr(la, lb, ea, ca, ra, eb, cb, rb, kets, omega):
    """int2e's rows of the erf(omega r)/r attenuated operator (omega > 0),
    the long-range in-core tensor of a range-separated functional's K; the
    same kernel, counted apart."""
    return _int2e(int2e_lr, la, lb, (ea, ca, ra, eb, cb, rb), kets,
                  float(omega))


def _int2e(wrapper, la, lb, bra, kets, omega):
    dev, n, ncol = _check_quartets(*bra, kets)
    if dev.type == 'cpu':
        return j2e.int2e_class_plain(la, lb, *bra, kets, omega)
    out = torch.empty((n * (2 * la + 1) * (2 * lb + 1), ncol),
                      dtype=torch.float64, device=dev)
    _launch_quartets(wrapper, f'int2e_{la}{lb}', la, lb, bra, kets, out, ncol,
                     omega)
    return out


def int1e_r(la, lb, ea, ca, ra, eb, cb, rb):
    """Dipole rows <a|r|b> (origin at the coordinate origin) of n shell
    pairs: (n, (2la+1)(2lb+1), 3) of [x, y, z]. Arguments as int1e_stv's;
    any la, lb <= 4."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    if dev.type == 'cpu':
        return int1e.class_r(la, lb, ea, ca, ra, eb, cb, rb)
    out = torch.empty((n, (2 * la + 1) * (2 * lb + 1), 3),
                      dtype=torch.float64, device=dev)
    if n == 0:
        return out
    rc = _fn('int1e_r')(
        la, lb, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(), ra.data_ptr(),
        eb.data_ptr(), cb.data_ptr(), rb.data_ptr(), sph(la, dev).data_ptr(),
        sph(lb, dev).data_ptr(), out.data_ptr(), _stream())
    _raise_on(rc, f'int1e_r({la},{lb})')
    int1e_r.launches += 1
    return out


def int1e_ip(la, lb, ea, ca, ra, eb, cb, rb, atom_coords, atom_charges):
    """Bra-centre derivatives of S, T and V of n ordered shell pairs:
    (n, (2la+1)(2lb+1), 9), [ipovlp, ipkin, ipnuc] x [x, y, z] with the
    operator major. Arguments as int1e_stv's; any la, lb <= 4."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    natm = atom_coords.shape[0]
    _check(dev, ('atom_coords', atom_coords, (natm, 3)),
           ('atom_charges', atom_charges, (natm,)))
    if dev.type == 'cpu':
        return int1e_deriv.class_ip(la, lb, ea, ca, ra, eb, cb, rb,
                                    atom_coords, atom_charges)
    out = torch.empty((n, (2 * la + 1) * (2 * lb + 1), 9),
                      dtype=torch.float64, device=dev)
    if n == 0:
        return out
    rc = _fn('int1e_ip')(
        la, lb, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(), ra.data_ptr(),
        eb.data_ptr(), cb.data_ptr(), rb.data_ptr(), natm,
        atom_coords.data_ptr(), atom_charges.data_ptr(),
        sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(), out.data_ptr(),
        _stream())
    _raise_on(rc, f'int1e_ip({la},{lb})')
    int1e_ip.launches += 1
    return out


def int1e_iprinv(la, lb, ea, ca, ra, eb, cb, rb, centers):
    """Operator-centre derivatives d/dC <a|1/|r-C||b> of n ordered shell
    pairs for every centre of centers (nc, 3), in one launch:
    (nc, 3, n, (2la+1)(2lb+1)). Any la, lb <= 4."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    nc = centers.shape[0]
    _check(dev, ('centers', centers, (nc, 3)))
    if dev.type == 'cpu':
        return int1e_deriv.class_iprinv(la, lb, ea, ca, ra, eb, cb, rb,
                                        centers)
    out = torch.empty((nc, 3, n, (2 * la + 1) * (2 * lb + 1)),
                      dtype=torch.float64, device=dev)
    if n == 0 or nc == 0:
        return out
    rc = _fn('int1e_iprinv')(
        la, lb, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(), ra.data_ptr(),
        eb.data_ptr(), cb.data_ptr(), rb.data_ptr(), nc, centers.data_ptr(),
        sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(), out.data_ptr(),
        _stream())
    _raise_on(rc, f'int1e_iprinv({la},{lb})')
    int1e_iprinv.launches += 1
    return out


def int1e_ipip(la, lb, ea, ca, ra, eb, cb, rb, atom_coords, atom_charges, D,
               W):
    """Second derivatives of S, T and V of n ordered shell pairs contracted
    with their density blocks D and W (n, (2la+1)(2lb+1)): (n, natm + 1,
    27). Slot c < natm: d2/dA dA, dA dC and dC dC (3 x 3 each, row-major;
    A the bra's centre, C atom c's) of sum D V_c, V_c the attraction of
    the charge of atom c; slot natm: d2/dA dA of sum D T - W S (9 numbers,
    then zeros). Arguments as int1e_ip's; any la, lb <= 4."""
    dev = _device_of(ea)
    n, Ka, Kb = _check_pairs(dev, ea, ca, ra, eb, cb, rb)
    natm = atom_coords.shape[0]
    ns1 = (2 * la + 1) * (2 * lb + 1)
    _check(dev, ('atom_coords', atom_coords, (natm, 3)),
           ('atom_charges', atom_charges, (natm,)), ('D', D, (n, ns1)),
           ('W', W, (n, ns1)))
    if dev.type == 'cpu':
        return int1e_deriv.class_ipip(la, lb, ea, ca, ra, eb, cb, rb,
                                      atom_coords, atom_charges, D, W)
    out = torch.empty((n, natm + 1, 27), dtype=torch.float64, device=dev)
    if n == 0:
        return out
    rc = _fn('int1e_ipip')(
        la, lb, n, Ka, Kb, ea.data_ptr(), ca.data_ptr(), ra.data_ptr(),
        eb.data_ptr(), cb.data_ptr(), rb.data_ptr(), natm,
        atom_coords.data_ptr(), atom_charges.data_ptr(),
        sph(la, dev).data_ptr(), sph(lb, dev).data_ptr(), D.data_ptr(),
        W.data_ptr(), out.data_ptr(), _stream())
    _raise_on(rc, f'int1e_ipip({la},{lb})')
    int1e_ipip.launches += 1
    return out


def int2e_ip1(la, lb, ea, ca, ra, eb, cb, rb, kets):
    """d/dA (ab|cd) sph rows of n bra shell pairs of the ordered class
    (la, lb), la, lb <= 2, against the ket pairs of every class in kets:
    (3, n*(2la+1)(2lb+1), sum over kets of nket*(2lc+1)(2ld+1)).

    kets as int2e's: lc <= ld <= 2, the (cd) = (dc) fold kept."""
    bra = (ea, ca, ra, eb, cb, rb)
    dev, n, ncol = _check_quartets(*bra, kets)
    if dev.type == 'cpu':
        return int2e_mod.int2e_ip1_class_plain(la, lb, *bra, kets)
    out = torch.empty((3, n * (2 * la + 1) * (2 * lb + 1), ncol),
                      dtype=torch.float64, device=dev)
    _launch_quartets(int2e_ip1, f'int2e_ip1_{la}{lb}', la, lb, bra, kets, out,
                     ncol)
    return out


def _check_tables(dev, tables, coords):
    n = coords.shape[0]
    _check(dev, ('coords', coords, (n, 3)))
    for l, e, c, r, off in tables:
        ns, K = e.shape
        _check(dev, ('exps', e, (ns, K)), ('coeffs', c, (ns, K)),
               ('centers', r, (ns, 3)))
        _check_index(dev, 'ao_off', off, ns)
    return n


def _launch_eval_ao(wrapper, tables, coords, nao, deriv):
    """One `eval_ao` launch per l-class into a fresh output, counted on
    wrapper.launches."""
    dev = coords.device
    n = coords.shape[0]
    out = torch.empty((eval_gto.NCOMP[deriv], n, nao) if deriv else (n, nao),
                      dtype=torch.float64, device=dev)
    for l, e, c, r, off in tables:
        ns, K = e.shape
        if n == 0 or ns == 0:
            continue
        rc = _fn('eval_ao')(
            l, deriv, n, ns, K, coords.data_ptr(), e.data_ptr(),
            c.data_ptr(), r.data_ptr(), off.data_ptr(), sph(l, dev).data_ptr(),
            out.data_ptr(), nao, _stream())
        _raise_on(rc, f'eval_ao(l={l}, deriv={deriv})')
        wrapper.launches += 1
    return out


def eval_ao(tables, coords, nao, deriv=0):
    """AO values on coords (n, 3): (n, nao) for deriv 0, (4, n, nao)
    [value, d/dx, d/dy, d/dz] for deriv 1; deriv 2 is eval_ao_deriv2's and
    deriv 3 eval_ao_deriv3's.

    tables: [(l, exps (ns, K), coeffs (ns, K), centers (ns, 3),
    ao_off (ns,) int32)] per l-class; every AO column belongs to one shell."""
    if deriv == 2:
        return eval_ao_deriv2(tables, coords, nao)
    if deriv == 3:
        return eval_ao_deriv3(tables, coords, nao)
    dev = _device_of(coords)
    _check_tables(dev, tables, coords)
    if dev.type == 'cpu':
        return eval_gto.eval_ao_plain(tables, coords, nao, deriv)
    return _launch_eval_ao(eval_ao, tables, coords, nao, deriv)


def eval_ao_pbc(tables, coords, Ls, nao, deriv, lcut):
    """Lattice-summed AO values on coords (n, 3), sum over the translations
    Ls (nimg, 3) of phi(r - L): (n, nao) for deriv 0, (4, n, nao) [value,
    d/dx, d/dy, d/dz] for deriv 1. One launch per l-class; the kernel skips
    an image, or a primitive, whose exponent a makes a r^2 > lcut, as
    its twin does. tables as eval_ao's."""
    dev = _device_of(coords)
    n = _check_tables(dev, tables, coords)
    _check(dev, ('Ls', Ls, (Ls.shape[0], 3)))
    if deriv not in (0, 1):
        raise NotImplementedError(f'eval_ao_pbc deriv={deriv}: only 0 and 1')
    if dev.type == 'cpu':
        return eval_gto.eval_ao_pbc_plain(tables, coords, Ls, nao, deriv,
                                          lcut)
    out = torch.empty((4, n, nao) if deriv else (n, nao),
                      dtype=torch.float64, device=dev)
    for l, e, c, r, off in tables:
        ns, K = e.shape
        if n == 0 or ns == 0:
            continue
        rc = _fn('eval_ao_pbc')(
            l, deriv, n, ns, K, Ls.shape[0], coords.data_ptr(), e.data_ptr(),
            c.data_ptr(), r.data_ptr(), off.data_ptr(), Ls.data_ptr(),
            float(lcut), sph(l, dev).data_ptr(), out.data_ptr(), nao,
            _stream())
        _raise_on(rc, f'eval_ao_pbc(l={l}, deriv={deriv})')
        eval_ao_pbc.launches += 1
    return out


def eval_ao_kpts(tables, coords, Ls, phases, nao, deriv, lcut):
    """Bloch sums of the AO values on coords (n, 3) for nk k-points,
    sum_L e^{ik.L} phi(r - L) over the translations Ls (nimg, 3) with
    phases (nk, nimg) complex128 e^{ik.L}: (nk, n, nao) for deriv 0, (nk,
    4, n, nao) [value, d/dx, d/dy, d/dz] for deriv 1, complex128. One launch
    per l-class; the kernel skips an image, or a primitive, whose exponent
    a makes a r^2 > lcut, as its twin does. tables as eval_ao's."""
    dev = _device_of(coords)
    n = _check_tables(dev, tables, coords)
    nimg = Ls.shape[0]
    _check(dev, ('Ls', Ls, (nimg, 3)))
    nk = phases.shape[0]
    if (phases.dtype != torch.complex128 or phases.device != dev
            or tuple(phases.shape) != (nk, nimg)):
        raise ValueError(f'phases must be complex128 ({nk}, {nimg}) on {dev}')
    if deriv not in (0, 1):
        raise NotImplementedError(f'eval_ao_kpts deriv={deriv}: only 0 and 1')
    if dev.type == 'cpu':
        return eval_gto.eval_ao_kpts_plain(tables, coords, Ls, phases, nao,
                                           deriv, lcut)
    out = torch.empty((nk, 4, n, nao) if deriv else (nk, n, nao),
                      dtype=torch.complex128, device=dev)
    ph = phases.T.contiguous()          # (nimg, nk): a k tile's phases
    for l, e, c, r, off in tables:
        ns, K = e.shape
        if n == 0 or ns == 0 or nk == 0:
            continue
        rc = _fn('eval_ao_kpts')(
            l, deriv, n, ns, K, nimg, nk, coords.data_ptr(), e.data_ptr(),
            c.data_ptr(), r.data_ptr(), off.data_ptr(), Ls.data_ptr(),
            ph.data_ptr(), float(lcut), sph(l, dev).data_ptr(),
            out.data_ptr(), nao, _stream())
        _raise_on(rc, f'eval_ao_kpts(l={l}, deriv={deriv})')
        eval_ao_kpts.launches += 1
    return out


def eval_ao_deriv2(tables, coords, nao):
    """AO values with their first and second derivatives on coords (n, 3):
    (10, n, nao) [value, x, y, z, xx, xy, xz, yy, yz, zz], the `eval_ao`
    kernel's deriv 2, counted apart from deriv 0 and 1. tables as
    eval_ao's."""
    dev = _device_of(coords)
    _check_tables(dev, tables, coords)
    if dev.type == 'cpu':
        return eval_gto.eval_ao_plain(tables, coords, nao, 2)
    return _launch_eval_ao(eval_ao_deriv2, tables, coords, nao, 2)


def eval_ao_deriv3(tables, coords, nao):
    """AO values with their first, second and third derivatives on coords
    (n, 3): (20, n, nao), eval_ao_deriv2's ten components followed by
    [xxx, xxy, xxz, xyy, xyz, xzz, yyy, yyz, yzz, zzz], the `eval_ao`
    kernel's deriv 3, counted apart. tables as eval_ao's."""
    dev = _device_of(coords)
    _check_tables(dev, tables, coords)
    if dev.type == 'cpu':
        return eval_gto.eval_ao_plain(tables, coords, nao, 3)
    return _launch_eval_ao(eval_ao_deriv3, tables, coords, nao, 3)


def becke(coords, w0, owner, atm_coords, inv_dist, a_adj):
    """Becke partition weights (n,) of the points coords (n, 3) with atomic
    weights w0 (n,) and owning atoms owner (n,) int32; atm_coords (natm, 3),
    inv_dist = 1/R_ij and the Treutler a_ij (natm, natm)."""
    dev = _device_of(coords)
    n, natm = coords.shape[0], atm_coords.shape[0]
    _check(dev, ('coords', coords, (n, 3)), ('w0', w0, (n,)),
           ('atm_coords', atm_coords, (natm, 3)),
           ('inv_dist', inv_dist, (natm, natm)),
           ('a_adj', a_adj, (natm, natm)))
    _check_index(dev, 'owner', owner, n)
    if dev.type == 'cpu':
        return gen_grid.becke_weights_plain(coords, w0, owner, atm_coords,
                                            inv_dist, a_adj)
    w = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return w
    rc = _fn('becke')(n, natm, coords.data_ptr(), w0.data_ptr(),
                      owner.data_ptr(), atm_coords.data_ptr(),
                      inv_dist.data_ptr(), a_adj.data_ptr(), w.data_ptr(),
                      _stream())
    _raise_on(rc, 'becke')
    becke.launches += 1
    return w


# component of dft/xc.py -> id in csrc/xc_funcs.cuh
XC_COMPONENT_IDS = {'SLATER': 0, 'VWN5': 1, 'VWN3': 2, 'B88': 3, 'LYP': 4,
                    'CAM_B88': 5, 'WB97': 6, 'PBE_X': 7, 'PBE_C': 8}
# the components of the gradient kernels xc_rks_grad and xc_uks_grad: all
# but the range-separated CAM_B88 and WB97
XC_GRAD_COMPONENTS = ('SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'PBE_X',
                      'PBE_C')
# per-term parameters in csrc/xc_funcs.cuh Terms: omega, alpha, beta, then
# three power series of XC_NSERIES coefficients (cx, css, cos)
XC_NSERIES = 5
XC_NPARAM = 3 + 3 * XC_NSERIES
XC_WARPS_PER_BLOCK = 8
# points and warps per thread block of xc_rks_grad
XC_GRAD_POINTS = 64
XC_GRAD_WARPS = 4


def _term_params(comp, params):
    """One term's XC_NPARAM parameters: [omega, alpha, beta] for CAM_B88,
    [omega, 0, 0, cx, css, cos] with each series padded with zeros to
    XC_NSERIES for WB97, zeros for a component without parameters."""
    out = [0.0] * XC_NPARAM
    if comp == 'CAM_B88':
        out[:3] = params
    elif comp == 'WB97':
        out[0] = params[0]
        for k, series in enumerate(params[1:]):
            if len(series) > XC_NSERIES:
                raise NotImplementedError(
                    f'a B97 series of {len(series)} terms (the kernels take '
                    f'{XC_NSERIES})')
            off = 3 + k * XC_NSERIES
            out[off:off + len(series)] = series
    return out


def _xc_terms(xc, kernel, allowed=tuple(XC_COMPONENT_IDS)):
    """ctypes arrays (component ids, coefficients, parameters) of xc's
    terms; NotImplementedError for a component outside `allowed`."""
    unknown = [comp for _, _, comp in xc.terms if comp not in allowed]
    if unknown or xc.is_mgga:
        raise NotImplementedError(
            f'{kernel} kernel: components {unknown} or a meta-GGA are not '
            'in the kernel')
    ids = (ctypes.c_int * len(xc.terms))(
        *[XC_COMPONENT_IDS[comp] for _, _, comp in xc.terms])
    coeffs = (ctypes.c_double * len(xc.terms))(*[c for c, _, _ in xc.terms])
    params = (ctypes.c_double * (XC_NPARAM * len(xc.terms)))(
        *[v for (_, _, comp), p in zip(xc.terms, xc.params)
          for v in _term_params(comp, p)])
    return ids, coeffs, params


def xc_rks(aod, dmao, weights, xc):
    """The pointwise XC part of one block of B points: (vtmp (B, nao), n, exc)
    with n = sum w rho and exc = sum over unmasked points of w e_xc (0-d).

    aod (B, nao) for an LDA or (4, B, nao) for a GGA; dmao = ao @ dm
    (B, nao); weights (B,); xc a dft.xc.XCFunctional."""
    dev = _device_of(aod)
    gga = aod.dim() == 3
    B, nao = aod.shape[-2:]
    _check(dev, ('aod', aod, (4, B, nao) if gga else (B, nao)),
           ('dmao', dmao, (B, nao)), ('weights', weights, (B,)))
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the AO gradients (4, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_rks_plain(aod, dmao, weights, xc)
    ids, coeffs, params = _xc_terms(xc, 'xc_rks')
    vtmp = torch.empty((B, nao), dtype=torch.float64, device=dev)
    nblk = -(-B // XC_WARPS_PER_BLOCK)
    partials = torch.zeros((max(nblk, 1), 2), dtype=torch.float64, device=dev)
    if B:
        rc = _fn('xc_rks')(int(gga), B, nao, aod.data_ptr(),
                           dmao.data_ptr(), weights.data_ptr(),
                           len(xc.terms), ids, coeffs, params,
                           vtmp.data_ptr(),
                           partials.data_ptr(), XC_WARPS_PER_BLOCK,
                           _stream())
        _raise_on(rc, 'xc_rks')
        xc_rks.launches += 1
    sums = partials.sum(dim=0)
    return vtmp, sums[0], sums[1]


def xc_uks(aod, dmao, weights, xc):
    """The pointwise spin-polarized XC part of one block of B points:
    (vtmp (2, B, nao), n (2,), exc) with n_s = sum w rho_s and exc = sum
    over unmasked points of w e_xc (0-d).

    aod (B, nao) for an LDA or (4, B, nao) for a GGA; dmao = ao @ dm_s
    stacked (2, B, nao); weights (B,); xc a dft.xc.XCFunctional."""
    dev = _device_of(aod)
    gga = aod.dim() == 3
    B, nao = aod.shape[-2:]
    _check(dev, ('aod', aod, (4, B, nao) if gga else (B, nao)),
           ('dmao', dmao, (2, B, nao)), ('weights', weights, (B,)))
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the AO gradients (4, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_uks_plain(aod, dmao, weights, xc)
    ids, coeffs, params = _xc_terms(xc, 'xc_uks')
    vtmp = torch.empty((2, B, nao), dtype=torch.float64, device=dev)
    nblk = -(-B // XC_WARPS_PER_BLOCK)
    partials = torch.zeros((max(nblk, 1), 3), dtype=torch.float64, device=dev)
    if B:
        rc = _fn('xc_uks')(int(gga), B, nao, aod.data_ptr(),
                           dmao.data_ptr(), weights.data_ptr(),
                           len(xc.terms), ids, coeffs, params,
                           vtmp.data_ptr(),
                           partials.data_ptr(), XC_WARPS_PER_BLOCK,
                           _stream())
        _raise_on(rc, 'xc_uks')
        xc_uks.launches += 1
    sums = partials.sum(dim=0)
    return vtmp, sums[:2], sums[2]


def xc_rks_grad(aod, dmao, weights, xc):
    """The closed-shell XC energy's nuclear gradient on a fixed grid, per
    AO, over one block of B points: (g (3, nao), exc), dE_xc/dX_A the sum of
    g over the AOs on atom A and exc the sum over unmasked points of w e_xc.

    aod (10, B, nao) [value, x, y, z, xx, xy, xz, yy, yz, zz] with dmao =
    aod[:4] @ dm (4, B, nao) for a GGA; aod (4, B, nao) with dmao =
    aod[:1] @ dm (1, B, nao) for an LDA; weights (B,)."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 10
    B, nao = aod.shape[1:]
    nd = 4 if gga else 1
    _check(dev, ('aod', aod, (10 if gga else 4, B, nao)),
           ('dmao', dmao, (nd, B, nao)), ('weights', weights, (B,)))
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the second AO derivatives '
                         '(10, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_rks_grad_plain(aod, dmao, weights, xc)
    ids, coeffs, _ = _xc_terms(xc, 'xc_rks_grad', XC_GRAD_COMPONENTS)
    nblk = max(-(-B // XC_GRAD_POINTS), 1)
    partials = torch.zeros((nblk, 3, nao), dtype=torch.float64, device=dev)
    exc = torch.zeros(nblk, dtype=torch.float64, device=dev)
    if B:
        rc = _fn('xc_rks_grad')(int(gga), B, nao, aod.data_ptr(),
                                dmao.data_ptr(), weights.data_ptr(),
                                len(xc.terms), ids, coeffs, partials.data_ptr(),
                                exc.data_ptr(), XC_GRAD_POINTS,
                                XC_GRAD_WARPS, _stream())
        _raise_on(rc, 'xc_rks_grad')
        xc_rks_grad.launches += 1
    return partials.sum(dim=0), exc.sum()


def xc_uks_grad(aod, dmao, weights, xc):
    """The spin-polarized XC energy's nuclear gradient on a fixed grid, per
    AO, over one block of B points: (g (3, nao), exc), as xc_rks_grad's.

    aod (10, B, nao) with dmao = aod[:4] @ dm_s stacked (2, 4, B, nao) for
    a GGA; aod (4, B, nao) with dmao = aod[:1] @ dm_s (2, 1, B, nao) for an
    LDA; weights (B,)."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 10
    B, nao = aod.shape[1:]
    nd = 4 if gga else 1
    _check(dev, ('aod', aod, (10 if gga else 4, B, nao)),
           ('dmao', dmao, (2, nd, B, nao)), ('weights', weights, (B,)))
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the second AO derivatives '
                         '(10, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_uks_grad_plain(aod, dmao, weights, xc)
    ids, coeffs, _ = _xc_terms(xc, 'xc_uks_grad', XC_GRAD_COMPONENTS)
    nblk = max(-(-B // XC_GRAD_POINTS), 1)
    partials = torch.zeros((nblk, 3, nao), dtype=torch.float64, device=dev)
    exc = torch.zeros(nblk, dtype=torch.float64, device=dev)
    if B:
        rc = _fn('xc_uks_grad')(int(gga), B, nao, aod.data_ptr(),
                                dmao.data_ptr(), weights.data_ptr(),
                                len(xc.terms), ids, coeffs,
                                partials.data_ptr(), exc.data_ptr(),
                                XC_GRAD_POINTS, XC_GRAD_WARPS, _stream())
        _raise_on(rc, 'xc_uks_grad')
        xc_uks_grad.launches += 1
    return partials.sum(dim=0), exc.sum()


VV10_THREADS = 128


def vv10(rho, g2, coords, weights, b, C):
    """VV10 non-local correlation on a grid: (E (0-d), dE/drho (ng,),
    dE/dg2 (ng,)) of rho, g2 = |grad rho|^2 and weights (ng,) on the points
    coords (ng, 3), with the parameters b and C; points with rho <= 1e-8
    take no part (dft/vv10.py RHO_CUT)."""
    dev = _device_of(rho)
    n = rho.shape[0]
    _check(dev, ('rho', rho, (n,)), ('g2', g2, (n,)),
           ('coords', coords, (n, 3)), ('weights', weights, (n,)))
    if dev.type == 'cpu':
        return vv10_mod.vv10_plain(rho, g2, coords, weights, b, C)
    out = torch.zeros((3, n), dtype=torch.float64, device=dev)
    if n:
        rc = _fn('vv10')(n, coords.data_ptr(), rho.data_ptr(),
                         g2.data_ptr(), weights.data_ptr(),
                         float(b), float(C), out.data_ptr(), VV10_THREADS,
                         _stream())
        _raise_on(rc, 'vv10')
        vv10.launches += 1
    return out[0].sum(), out[1], out[2]


MP2_THREADS = 256


def mp2_energy(ovov, eia1=None, eia2=None, tau=None, exchange=True,
               with_t2=True):
    """The pair-energy pass over ovov (no1, nv1, no2, nv2): (t2, direct,
    exchange) with direct = sum ovov[i,a,j,b] x[i,a,j,b] and exchange =
    sum ovov[i,a,j,b] x[i,b,j,a] (0-d; None unless `exchange`, which needs
    nv1 == nv2).

    Without tau, x = t2 = ovov / (eia1[i,a] + eia2[j,b]) (eia1 (no1, nv1),
    eia2 (no2, nv2)), returned when with_t2, else None; with tau, the
    CCSD amplitudes tau (no1, no2, nv1, nv2), x[i,a,j,b] = tau[i,j,a,b],
    and t2 is None."""
    dev = _device_of(ovov)
    no1, nv1, no2, nv2 = ovov.shape
    _check(dev, ('ovov', ovov, (no1, nv1, no2, nv2)))
    if tau is None:
        _check(dev, ('eia1', eia1, (no1, nv1)), ('eia2', eia2, (no2, nv2)))
    else:
        _check(dev, ('tau', tau, (no1, no2, nv1, nv2)))
    if exchange and nv1 != nv2:
        raise ValueError('the exchange sum needs nv1 == nv2')
    if dev.type == 'cpu':
        from ..mp.mp2 import mp2_energy_plain
        return mp2_energy_plain(ovov, eia1, eia2, tau, exchange, with_t2)
    t2 = (torch.empty_like(ovov) if tau is None and with_t2 else None)
    nblk = no1 * no2
    partials = torch.zeros((max(nblk, 1), 2), dtype=torch.float64,
                           device=dev)
    if nblk:
        rc = _fn('mp2_energy')(
            no1, nv1, no2, nv2, ovov.data_ptr(),
            None if tau is not None else eia1.data_ptr(),
            None if tau is not None else eia2.data_ptr(),
            None if tau is None else tau.data_ptr(), int(exchange),
            None if t2 is None else t2.data_ptr(), partials.data_ptr(),
            MP2_THREADS, _stream())
        _raise_on(rc, 'mp2_energy')
        mp2_energy.launches += 1
    sums = partials.sum(dim=0)
    return t2, sums[0], sums[1] if exchange else None


CCSD_T_THREADS = 256
# bytes of dynamic shared memory a block can have: 227 KB less the
# reduction's 8 bytes per thread
CCSD_T_MAX_SMEM = 232448 - 8 * CCSD_T_THREADS


def ccsd_t(abc, mult, vvov, vooo, ovov, t2, t1, e_occ, e_vir):
    """The (T) sum over the virtual triples abc (n, 3) int32 with their
    multiplicities mult (n,): a 0-d tensor, half of E_(T) when abc holds
    every a >= b >= c.

    vvov (v, v, o, v), vooo (v, o, o, o), ovov (o, v, o, v), t2 (o, o, v,
    v), t1 (o, v), e_occ (o,), e_vir (v,), as cc/ccsd_t.py et_plain's."""
    dev = _device_of(t2)
    no, nv = t1.shape
    n = abc.shape[0]
    _check(dev, ('mult', mult, (n,)), ('vvov', vvov, (nv, nv, no, nv)),
           ('vooo', vooo, (nv, no, no, no)), ('ovov', ovov, (no, nv, no, nv)),
           ('t2', t2, (no, no, nv, nv)), ('t1', t1, (no, nv)),
           ('e_occ', e_occ, (no,)), ('e_vir', e_vir, (nv,)))
    if (abc.device != dev or abc.dtype != torch.int32
            or tuple(abc.shape) != (n, 3) or not abc.is_contiguous()):
        raise ValueError(f'abc must be a contiguous int32 ({n}, 3) tensor '
                         f'on {dev}')
    if dev.type == 'cpu':
        from ..cc.ccsd_t import et_plain
        return et_plain(abc, mult, vvov, vooo, ovov, t2, t1, e_occ, e_vir)
    # the f tile of the staged vvov slices: all of nvir where it fits
    ft = min(nv, (CCSD_T_MAX_SMEM // 48 - no * no) // no)
    if ft < 1:
        raise NotImplementedError(
            f'ccsd_t: the t2 slices of nocc {no} need {48 * no * (no + 1)} '
            f'bytes of shared memory per block, more than {CCSD_T_MAX_SMEM}')
    ijk = torch.tensor([(i, j, k) for i in range(no) for j in range(i + 1)
                        for k in range(j + 1)], dtype=torch.int32,
                       device=dev).reshape(-1, 3)
    t2T = t2.permute(2, 3, 0, 1).contiguous()
    partials = torch.zeros(max(n, 1), dtype=torch.float64, device=dev)
    if n:
        rc = _fn('ccsd_t')(
            no, nv, ft, n, abc.data_ptr(), mult.data_ptr(), ijk.shape[0],
            ijk.data_ptr(), vvov.data_ptr(), vooo.data_ptr(), t2.data_ptr(),
            t2T.data_ptr(), ovov.data_ptr(), t1.data_ptr(), e_occ.data_ptr(),
            e_vir.data_ptr(), partials.data_ptr(), CCSD_T_THREADS, _stream())
        _raise_on(rc, 'ccsd_t')
        ccsd_t.launches += 1
    return partials.sum()


# the response kernels take the components of the gradient kernels
XC_FXC_COMPONENTS = XC_GRAD_COMPONENTS
XC_FXC_WARPS = 4
XC_FXC_PAIR_THREADS = 256


def xc_fxc(aod, dmao, weights, xc, singlet=True):
    """The XC response kernel per point of one block of B points, weighted
    and masked, in 4x4 blocks over (rho, grad rho): (B, 1, 4, 4) of w (H_aa
    + H_ab) for a closed-shell dmao (1, B, nao) of the total density
    (singlet; H_aa - H_ab for a triplet), (B, 4, 4, 4) of w [H_aa, H_ab,
    H_ba, H_bb] for dmao (2, B, nao) of each spin, H the Hessian of e_xc
    over (rho_a, rho_b, grad rho_a, grad rho_b) as the JAX package's _fxc_ov
    and _fxc_ov_uks take it.

    aod (4, B, nao); weights (B,); xc a dft.xc.XCFunctional of the B3LYP
    family."""
    dev = _device_of(aod)
    B, nao = aod.shape[1:]
    nspin = dmao.shape[0]
    if nspin not in (1, 2):
        raise ValueError(f'dmao must hold 1 or 2 densities, got {nspin}')
    _check(dev, ('aod', aod, (4, B, nao)), ('dmao', dmao, (nspin, B, nao)),
           ('weights', weights, (B,)))
    if dev.type == 'cpu':
        return numint.xc_fxc_plain(aod, dmao, weights, xc, singlet)
    ids, coeffs, _ = _xc_terms(xc, 'xc_fxc', XC_FXC_COMPONENTS)
    out = torch.empty((B, 1 if nspin == 1 else 4, 4, 4), dtype=torch.float64,
                      device=dev)
    if B:
        rc = _fn('xc_fxc')(nspin, 1.0 if singlet else -1.0, B, nao,
                           aod.data_ptr(), dmao.data_ptr(),
                           weights.data_ptr(), len(xc.terms), ids, coeffs,
                           out.data_ptr(), XC_FXC_WARPS, _stream())
        _raise_on(rc, 'xc_fxc')
        xc_fxc.launches += 1
    return out


def xc_fxc_pairs(oo, ov, H, blocks):
    """The pair features of one block of B points: (P (4, B, nov), HP (nh,
    4, B, nov)) with P = [phi_i phi_a, grad(phi_i phi_a)] over the pairs
    (i, a), i major, and HP[h] = H[:, blocks[h]] P per point.

    oo (4, B, nocc), ov (4, B, nvir): the orbital values and gradients; H
    (B, nblk, 4, 4) from xc_fxc; blocks one or two indices into nblk."""
    dev = _device_of(oo)
    _, B, nocc = oo.shape
    nvir = ov.shape[2]
    nblk = H.shape[1]
    _check(dev, ('oo', oo, (4, B, nocc)), ('ov', ov, (4, B, nvir)),
           ('H', H, (B, nblk, 4, 4)))
    if not 1 <= len(blocks) <= 2 or not all(0 <= h < nblk for h in blocks):
        raise ValueError(f'blocks {blocks} must be one or two of {nblk}')
    if dev.type == 'cpu':
        return numint.xc_fxc_pairs_plain(oo, ov, H, blocks)
    nov = nocc * nvir
    P = torch.empty((4, B, nov), dtype=torch.float64, device=dev)
    HP = torch.empty((len(blocks), 4, B, nov), dtype=torch.float64,
                     device=dev)
    if B and nov:
        rc = _fn('xc_fxc_pairs')(
            B, nocc, nvir, oo.data_ptr(), ov.data_ptr(), H.data_ptr(), nblk,
            len(blocks), blocks[0], blocks[-1], P.data_ptr(), HP.data_ptr(),
            XC_FXC_PAIR_THREADS, _stream())
        _raise_on(rc, 'xc_fxc_pairs')
        xc_fxc_pairs.launches += 1
    return P, HP


def _fxc_tangent(wrapper, lib, plain, nspin, aod, dmao, dmao1, weights, xc):
    dev = _device_of(aod)
    gga = aod.dim() == 3
    B, nao = aod.shape[-2:]
    nvec = dmao1.shape[0]
    rows = (B, nao) if nspin == 1 else (nspin, B, nao)
    _check(dev, ('aod', aod, (4, B, nao) if gga else (B, nao)),
           ('dmao', dmao, rows), ('dmao1', dmao1, (nvec,) + rows),
           ('weights', weights, (B,)))
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the AO gradients (4, B, nao)')
    if dev.type == 'cpu':
        return plain(aod, dmao, dmao1, weights, xc)
    ids, coeffs, _ = _xc_terms(xc, lib, XC_FXC_COMPONENTS)
    out = torch.empty((nvec,) + rows, dtype=torch.float64, device=dev)
    if B and nvec:
        rc = _fn(lib)(int(gga), B, nao, nvec, aod.data_ptr(), dmao.data_ptr(),
                      dmao1.data_ptr(), weights.data_ptr(), len(xc.terms),
                      ids, coeffs, out.data_ptr(), _stream())
        _raise_on(rc, lib)
        wrapper.launches += 1
    return out


def xc_rks_fxc(aod, dmao, dmao1, weights, xc):
    """The tangent of xc_rks's vtmp along nvec transition densities at one
    block of B points: (nvec, B, nao), as jax.jvp of the JAX package's
    _get_rks_core_aod takes it.

    aod (B, nao) for an LDA or (4, B, nao) for a GGA; dmao = ao @ dm
    (B, nao) of the ground density; dmao1 = ao @ ddm_v (nvec, B, nao);
    weights (B,); xc a dft.xc.XCFunctional of the B3LYP or PBE family."""
    return _fxc_tangent(xc_rks_fxc, 'xc_rks_fxc', numint.xc_rks_fxc_plain, 1,
                        aod, dmao, dmao1, weights, xc)


def xc_uks_fxc(aod, dmao, dmao1, weights, xc):
    """The tangent of xc_uks's vtmp along nvec spin transition densities at
    one block of B points: (nvec, 2, B, nao), as jax.jvp of the JAX
    package's _get_uks_core_aod takes it.

    aod as xc_rks_fxc's; dmao = ao @ dm_s (2, B, nao); dmao1 = ao @ ddm_vs
    (nvec, 2, B, nao); weights (B,)."""
    return _fxc_tangent(xc_uks_fxc, 'xc_uks_fxc', numint.xc_uks_fxc_plain, 2,
                        aod, dmao, dmao1, weights, xc)


def xc_rks_hess(aod, dmao, weights, xc, atom_off):
    """The closed-shell XC energy's fixed-D second derivative along the
    nuclear coordinates, per point of one block of B points, for the
    tangents t = 3 A + x of the natm atoms:
      wv (B, 4)            w v, v = de/du of u = (rho, grad rho)
      ut (3 natm, B, 4)    u_t, the features' derivative along t
      ht (3 natm, B, 4)    w H u_t, H = d2e/du2
      same (B, natm, 6)    the same-atom blocks of w v . d2u/dA_x dA_y
                           (xx, xy, xz, yy, yz, zz)
      xr (4, B, nao)       the explicit rows vtmp0 = 1/2 w v_0 phi +
                           sum_j w v_j d_j phi and G_x = sum_j w v_j d_x
                           d_j phi
    all zero where rho <= RHO_THR (csrc/xc_rks_hess.cu says how).

    aod (20, B, nao) with dmao = aod[:4] @ D (4, B, nao) for a GGA; aod
    (10, B, nao) with dmao = aod[:1] @ D (1, B, nao) for an LDA; weights
    (B,); atom_off (natm + 1,) int32, the first AO of each atom (an atom's
    AOs consecutive); xc a dft.xc.XCFunctional of the B3LYP or PBE family."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 20
    B, nao = aod.shape[1:]
    nd = 4 if gga else 1
    natm = atom_off.shape[0] - 1
    _check(dev, ('aod', aod, (20 if gga else 10, B, nao)),
           ('dmao', dmao, (nd, B, nao)), ('weights', weights, (B,)))
    _check_index(dev, 'atom_off', atom_off, natm + 1)
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the third AO derivatives '
                         '(20, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_rks_hess_plain(aod, dmao, weights, xc, atom_off)
    ids, coeffs, _ = _xc_terms(xc, 'xc_rks_hess', XC_FXC_COMPONENTS)
    f64 = dict(dtype=torch.float64, device=dev)
    wv = torch.empty((B, 4), **f64)
    ut = torch.empty((3 * natm, B, 4), **f64)
    ht = torch.empty((3 * natm, B, 4), **f64)
    same = torch.empty((B, natm, 6), **f64)
    xr = torch.empty((4, B, nao), **f64)
    if B:
        rc = _fn('xc_rks_hess')(
            int(gga), B, nao, natm, atom_off.data_ptr(), aod.data_ptr(),
            dmao.data_ptr(), weights.data_ptr(), len(xc.terms), ids, coeffs,
            wv.data_ptr(), ut.data_ptr(), ht.data_ptr(), same.data_ptr(),
            xr.data_ptr(), _stream())
        _raise_on(rc, 'xc_rks_hess')
        xc_rks_hess.launches += 1
    return wv, ut, ht, same, xr


def xc_rks_deriv1(aod, wv, ht, xr, ao_atom, t0, nt):
    """The rows of dV_xc/dX at fixed D for the tangents t0 .. t0 + nt - 1
    of one block of B points: (B, nt, nao) with
      vt'_t[b, nu] = 1/2 ht_0 phi_nu + sum_j ht_j d_j phi_nu
                     - 1/2 [nu on A] (w v_0 d_x phi_nu + 2 G_x[nu])
    (t = 3 A + x), so that F_t = phi^T vt'_t - [rows on A] (d_x phi)^T vtmp0
    and V'_t = F_t + F_t^T.

    aod (20 or 10, B, nao) as xc_rks_hess's (its first four components are
    read); wv, ht and xr from xc_rks_hess; ao_atom (nao,) int32."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 20
    B, nao = aod.shape[1:]
    ntan = ht.shape[0]
    _check(dev, ('aod', aod, (20 if gga else 10, B, nao)),
           ('wv', wv, (B, 4)), ('ht', ht, (ntan, B, 4)),
           ('xr', xr, (4, B, nao)))
    _check_index(dev, 'ao_atom', ao_atom, nao)
    if not (0 <= t0 and nt >= 0 and t0 + nt <= ntan):
        raise ValueError(f'tangents {t0} .. {t0 + nt - 1} outside 0 .. '
                         f'{ntan - 1}')
    if dev.type == 'cpu':
        return numint.xc_rks_deriv1_plain(aod, wv, ht, xr, ao_atom, t0, nt)
    out = torch.empty((B, nt, nao), dtype=torch.float64, device=dev)
    if B and nt:
        rc = _fn('xc_rks_deriv1')(
            int(gga), B, nao, t0, nt, ao_atom.data_ptr(), aod.data_ptr(),
            wv.data_ptr(), ht.data_ptr(), xr.data_ptr(), out.data_ptr(),
            _stream())
        _raise_on(rc, 'xc_rks_deriv1')
        xc_rks_deriv1.launches += 1
    return out


def xc_uks_hess(aod, dmao, weights, xc, atom_off):
    """The spin-polarized XC energy's fixed-D second derivative along the
    nuclear coordinates, per point of one block of B points, with the
    features u = (rho_a, grad rho_a, rho_b, grad rho_b):
      wv (B, 8)            w v, v = de/du
      ut (3 natm, B, 8)    u_t, the features' derivative along t = 3 A + x
      ht (3 natm, B, 8)    w H u_t, H = d2e/du2
      same (B, natm, 6)    the same-atom blocks of w v . d2u/dA_x dA_y
                           summed over the spins (xx, xy, xz, yy, yz, zz)
      xr (2, 4, B, nao)    per spin the explicit rows vtmp0_s = 1/2 w v_rho_s
                           phi + sum_j w v_g_sj d_j phi and G_s,x = sum_j
                           w v_g_sj d_x d_j phi
    all zero where rho_a + rho_b <= RHO_THR (csrc/xc_uks_hess.cu says
    how).

    aod (20, B, nao) with dmao = aod[:4] @ D_s stacked (2, 4, B, nao) for a
    GGA; aod (10, B, nao) with (2, 1, B, nao) for an LDA; weights (B,);
    atom_off (natm + 1,) int32 (an atom's AOs consecutive); xc a
    dft.xc.XCFunctional of the B3LYP or PBE family."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 20
    B, nao = aod.shape[1:]
    nd = 4 if gga else 1
    natm = atom_off.shape[0] - 1
    _check(dev, ('aod', aod, (20 if gga else 10, B, nao)),
           ('dmao', dmao, (2, nd, B, nao)), ('weights', weights, (B,)))
    _check_index(dev, 'atom_off', atom_off, natm + 1)
    if xc.is_gga and not gga:
        raise ValueError('a GGA functional needs the third AO derivatives '
                         '(20, B, nao)')
    if dev.type == 'cpu':
        return numint.xc_uks_hess_plain(aod, dmao, weights, xc, atom_off)
    ids, coeffs, _ = _xc_terms(xc, 'xc_uks_hess', XC_FXC_COMPONENTS)
    f64 = dict(dtype=torch.float64, device=dev)
    wv = torch.empty((B, 8), **f64)
    ut = torch.empty((3 * natm, B, 8), **f64)
    ht = torch.empty((3 * natm, B, 8), **f64)
    same = torch.empty((B, natm, 6), **f64)
    xr = torch.empty((2, 4, B, nao), **f64)
    if B:
        rc = _fn('xc_uks_hess')(
            int(gga), B, nao, natm, atom_off.data_ptr(), aod.data_ptr(),
            dmao.data_ptr(), weights.data_ptr(), len(xc.terms), ids, coeffs,
            wv.data_ptr(), ut.data_ptr(), ht.data_ptr(), same.data_ptr(),
            xr.data_ptr(), _stream())
        _raise_on(rc, 'xc_uks_hess')
        xc_uks_hess.launches += 1
    return wv, ut, ht, same, xr


def xc_uks_deriv1(aod, wv, ht, xr, ao_atom, t0, nt):
    """The rows of dV_xc,s/dX at fixed D of both spins for the tangents t0
    .. t0 + nt - 1 of one block of B points: (2, B, nt, nao), for spin s
    xc_rks_deriv1's rows on that spin's features, so that F_t,s = phi^T
    vt'_t,s - [rows on A] (d_x phi)^T vtmp0_s and V'_t,s = F_t,s +
    F_t,s^T.

    aod (20 or 10, B, nao) as xc_uks_hess's (its first four components are
    read); wv (B, 8), ht (3 natm, B, 8) and xr (2, 4, B, nao) from
    xc_uks_hess; ao_atom (nao,) int32."""
    dev = _device_of(aod)
    gga = aod.shape[0] == 20
    B, nao = aod.shape[1:]
    ntan = ht.shape[0]
    _check(dev, ('aod', aod, (20 if gga else 10, B, nao)),
           ('wv', wv, (B, 8)), ('ht', ht, (ntan, B, 8)),
           ('xr', xr, (2, 4, B, nao)))
    _check_index(dev, 'ao_atom', ao_atom, nao)
    if not (0 <= t0 and nt >= 0 and t0 + nt <= ntan):
        raise ValueError(f'tangents {t0} .. {t0 + nt - 1} outside 0 .. '
                         f'{ntan - 1}')
    if dev.type == 'cpu':
        return numint.xc_uks_deriv1_plain(aod, wv, ht, xr, ao_atom, t0, nt)
    out = torch.empty((2, B, nt, nao), dtype=torch.float64, device=dev)
    if B and nt:
        rc = _fn('xc_uks_deriv1')(
            int(gga), B, nao, t0, nt, ao_atom.data_ptr(), aod.data_ptr(),
            wv.data_ptr(), ht.data_ptr(), xr.data_ptr(), out.data_ptr(),
            _stream())
        _raise_on(rc, 'xc_uks_deriv1')
        xc_uks_deriv1.launches += 1
    return out


KERNELS = (int1e_stv, int3c2e, int2c2e, int2e, eval_ao, becke, xc_rks,
           xc_uks, int1e_ip, int1e_iprinv, int2e_ip1, int3c2e_ip, int2c2e_ip1,
           eval_ao_deriv2, xc_rks_grad, xc_uks_grad, int1e_r, int3c2e_lr,
           int2c2e_lr, int2e_lr, vv10, mp2_energy, ccsd_t, xc_fxc,
           xc_fxc_pairs, xc_rks_fxc, xc_uks_fxc, int1e_ipip, int3c2e_ip1,
           int2c2e_ip1_full, int3c2e_ipip, int2c2e_ipip, eval_ao_deriv3,
           xc_rks_hess, xc_rks_deriv1, xc_uks_hess, xc_uks_deriv1,
           eval_ao_pbc, eval_ao_kpts)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset_launches()}."""
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
