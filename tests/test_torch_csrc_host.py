"""The integral kernels', the VV10 kernel's and the post-HF kernels' CUDA
sources, compiled for the host with g++, against their plain twins.

There is no CUDA compiler or card where the fast tests run, so this file
compiles csrc/int1e_stv.cu, int3c2e.cu, int2c2e.cu, int2e.cu, int1e_ip.cu,
int1e_iprinv.cu, int2e_ip1.cu, int3c2e_ip.cu, int2c2e_ip1.cu, int1e_r.cu,
vv10.cu, mp2_energy.cu, ccsd_t.cu and the nuclear Hessian's int1e_ipip.cu,
int3c2e_ip1.cu, int3c2e_ipip.cu and int2c2e_ipip.cu (both of its kernels)
as C++ behind a small stand-in for
cuda_runtime.h (the qualifiers defined away, shared arrays static, the
dynamic shared memory a static array, a launch turned into a loop over
blocks and threads, in order, so that vv10.cu, mp2_energy.cu and
ccsd_t.cu run with one thread per block) and calls them through the C
interface the wrappers use, on water/def2-SVP, whose classes reach
(dd|dd) and whose aux basis reaches g, with and without the erf(omega
r)/r attenuation; int1e_stv.cu, int3c2e.cu, int2c2e.cu and int2e.cu
also on a basis of s to g shells with an aux basis of s to h, at the (ff)
and (gg) bra classes and aux l 5; the dipole kernel on that basis; vv10.cu
on a water grid, and mp2_energy.cu and ccsd_t.cu on seeded tensors of a
water-sized correlated calculation; and the second-order dual numbers of
xc_funcs.cuh (HDualN, the functional of the XC response kernels xc_fxc,
xc_rks_fxc and xc_uks_fxc) through a small harness program, against
torch.func.hessian of dft/xc_funcs.py and jax.hessian of the JAX
package's functional. It checks the kernels' arithmetic and indexing, not
that nvcc accepts them: that is tests/test_torch_kernels.py on the
card."""
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_tpu.dft import xc as jax_xc

import pyscf_tpu_torch as tpt

from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.dft import numint, xc
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import (int1e, int1e_deriv, int2e, j2e,
                                           j3c, j3c_deriv)
from pyscf_tpu_torch.ops.integrals.int1e import sph

torch.set_num_threads(1)

SHIM = '''
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
#define PT_DYNAMIC_SMEM(name) static double name[1 << 16]
inline void __syncthreads() {}
struct Dim { int x; };
static thread_local Dim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
using std::fmax;
template <class F, class... A>
void host_launch(int blocks, int threads, F f, A... a) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b; threadIdx.x = t; f(a...);
    }
}
'''
# int3c2e.cu and int2e.cu are built only for the bra momenta and classes
# that the tests below run: water/def2-SVP's to d, and one f and one g
LIBS = ('int1e_stv', 'int3c2e_la0', 'int3c2e_la1', 'int3c2e_la2',
        'int3c2e_la3', 'int3c2e_la4', 'int2c2e', 'int2e_00', 'int2e_01',
        'int2e_02', 'int2e_11', 'int2e_12', 'int2e_22', 'int2e_33',
        'int2e_44', 'int1e_ip',
        'int1e_iprinv', 'int2e_ip1_la0', 'int2e_ip1_la1', 'int2e_ip1_la2',
        'int3c2e_ip_la0', 'int3c2e_ip_la1', 'int3c2e_ip_la2', 'int2c2e_ip1',
        'int1e_r', 'vv10', 'mp2_energy', 'ccsd_t', 'int1e_ipip',
        'int3c2e_ip1_la0', 'int3c2e_ip1_la1', 'int3c2e_ip1_la2',
        'int3c2e_ipip_la0', 'int3c2e_ipip_la1', 'int3c2e_ipip_la2',
        'int2c2e_ip1_full', 'int2c2e_ipip')
OMEGA = 0.3
DEV = torch.device('cpu')


class _HostLibs:
    """{library: ctypes function} of the sources built for the host, each
    built at its first use together with the other libraries of its
    source (one g++ process each, side by side), into a directory named
    by the hash of the sources that the test processes of one run share:
    a source is built once per run, under a file lock, whichever process
    asks first."""

    def __init__(self, gxx, out):
        self.gxx, self.out, self.fns = gxx, out, {}
        out.mkdir(parents=True, exist_ok=True)
        (out / 'cuda_runtime.h').write_text(SHIM)

    def __getitem__(self, lib):
        if lib not in self.fns:
            src = kernels._LIBRARIES[lib][0]
            libs = [k for k in LIBS if kernels._LIBRARIES[k][0] == src]
            with open(self.out / f'{src}.lock', 'w') as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                todo = [k for k in libs if not (self.out / f'{k}.so').exists()]
                if todo:
                    self._build(todo)
            for k in libs:
                _, name, argtypes, _ = kernels._LIBRARIES[k]
                fn = getattr(ctypes.CDLL(str(self.out / f'{k}.so')), name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self.fns[k] = fn
        return self.fns[lib]

    def _build(self, libs):
        out, jobs = self.out, []
        for lib in libs:
            src, _, _, flags = kernels._LIBRARIES[lib]
            text = open(f'{kernels._CSRC}/{src}').read()
            text, n = re.subn(
                r'(\w+<[^;<>]*>)<<<blocks, threads, \w+, stream>>>\(\s*',
                r'host_launch(blocks, threads, \1, ', text)
            assert n == 1
            (out / f'{lib}.cpp').write_text(text)
            jobs.append((lib, subprocess.Popen(
                [self.gxx, '-O0', '-std=c++17', '-shared', '-fPIC', '-w',
                 *flags, '-I', str(out), '-I', kernels._CSRC, '-o',
                 str(out / f'{lib}.so.tmp'), str(out / f'{lib}.cpp')])))
        assert all(j.wait() == 0 for _, j in jobs)
        for lib, _ in jobs:
            os.replace(out / f'{lib}.so.tmp', out / f'{lib}.so')


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """The sources built for the host with g++, at first use."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the CUDA sources for the host')
    h = hashlib.sha256(SHIM.encode())
    for name in sorted(os.listdir(kernels._CSRC)):
        with open(os.path.join(kernels._CSRC, name), 'rb') as f:
            h.update(name.encode() + f.read())
    base = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        base = base.parent          # shared by the run's worker processes
    return _HostLibs(gxx, base / f'csrc_host_{h.hexdigest()[:16]}')


@pytest.fixture(scope='module')
def water():
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    zr = torch.as_tensor(mol.coords)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64)
    return mol, zr, zq


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _close(got, ref):
    """1e-12 x max |value|, the limit the card's comparison uses."""
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def _dims(p):
    return p[0].shape[0], p[0].shape[1], p[3].shape[1]


def test_int1e_stv(host, water):
    mol, zr, zq = water
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        n, Ka, Kb = _dims(p)
        out = torch.empty((n, (2 * la + 1) * (2 * lb + 1), 3),
                          dtype=torch.float64)
        assert host['int1e_stv'](
            la, lb, 1, n, Ka, Kb, *_ptrs(*p), mol.natm,
            *_ptrs(zr, zq, sph(la, DEV), sph(lb, DEV), out), None) == 0
        _close(out, int1e.class_stv(la, lb, *p, zr, zq))


def test_int1e_ip_and_iprinv(host, water):
    mol, zr, zq = water
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        n, Ka, Kb = _dims(p)
        ns1 = (2 * la + 1) * (2 * lb + 1)
        out = torch.empty((n, ns1, 9), dtype=torch.float64)
        assert host['int1e_ip'](
            la, lb, n, Ka, Kb, *_ptrs(*p), mol.natm,
            *_ptrs(zr, zq, sph(la, DEV), sph(lb, DEV), out), None) == 0
        ref = int1e_deriv.class_ip(la, lb, *p, zr, zq)
        for x in range(3):      # each operator against its own scale
            _close(out[..., 3 * x:3 * x + 3], ref[..., 3 * x:3 * x + 3])
        out = torch.empty((mol.natm, 3, n, ns1), dtype=torch.float64)
        assert host['int1e_iprinv'](
            la, lb, n, Ka, Kb, *_ptrs(*p), mol.natm,
            *_ptrs(zr, sph(la, DEV), sph(lb, DEV), out), None) == 0
        _close(out, int1e_deriv.class_iprinv(la, lb, *p, zr))


# s to g shells, two of them contracted, for the dipole kernel's classes
# up to (g|g)
HOST_BASIS = {'O': [[0, [3.0, 0.6], [0.8, 0.5]], [1, [1.1, 1.0]],
                    [2, [0.9, 1.0]], [3, [0.7, 0.4], [2.0, 0.7]],
                    [4, [0.6, 1.0]]],
              'H': [[0, [1.2, 1.0]], [1, [0.9, 1.0]], [2, [0.5, 1.0]]]}


def test_int1e_r(host):
    """Every ordered class pair of s to g shells on two centres off the
    origin (so that no class vanishes by parity) against class_r (r_chunk
    folded to sph rows)."""
    mol = tpt.M(atom='O 0.1 0.2 -0.3; H 0.3 -0.7 0.6', basis=HOST_BASIS,
                device='cpu')
    classes = int1e.cross_pairs(mol, mol)
    assert len(classes) == 25
    for la, lb, _, _, p in classes:
        n, Ka, Kb = _dims(p)
        out = torch.empty((n, (2 * la + 1) * (2 * lb + 1), 3),
                          dtype=torch.float64)
        assert host['int1e_r'](
            la, lb, n, Ka, Kb, *_ptrs(*p),
            *_ptrs(sph(la, DEV), sph(lb, DEV), out), None) == 0
        _close(out, int1e.class_r(la, lb, *p))


def _quartets(fn, la, lb, p, kets, out, ncol, *extra):
    n, Ka, Kb = _dims(p)
    col = 0
    for lc, ld, *ket in kets:
        nk, Kc, Kd = _dims(ket)
        assert fn(la, lb, lc, ld, n, Ka, Kb, *_ptrs(*p), nk, Kc, Kd,
                  *_ptrs(*ket), *_ptrs(*[sph(l, DEV) for l in
                                         (la, lb, lc, ld)]),
                  out.data_ptr(), ncol, col, *extra, None) == 0
        col += nk * (2 * lc + 1) * (2 * ld + 1)
    return out


def _int2e(host, water, omega):
    mol, _, _ = water
    kets = j2e._ket_arrays(mol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        ref = j2e.int2e_class_plain(la, lb, *p, kets, omega)
        got = _quartets(host[f'int2e_{la}{lb}'], la, lb, p, kets,
                        torch.empty_like(ref), ref.shape[1], omega)
        _close(got, ref)


def test_int2e(host, water):
    _int2e(host, water, 0.0)


def test_int2e_lr(host, water):
    """The erf(omega r)/r attenuated quartets (omega 0.3)."""
    _int2e(host, water, OMEGA)


@pytest.mark.parametrize('omega', [0.0, OMEGA])
def test_int3c2e(host, water, omega):
    """Raw (ij|P) rows of every bra class against the def2-universal-jkfit
    aux classes, up to (dd|g)."""
    mol, _, _ = water
    aux = j3c.aux_tables(make_auxmol(mol))
    offs, _ = kernels._aux_offsets(aux)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        n, Ka, Kb = _dims(p)
        out = torch.empty((n * (2 * la + 1) * (2 * lb + 1), offs[-1]),
                          dtype=torch.float64)
        for i, (l, e, c, r) in enumerate(aux):
            assert host[f'int3c2e_la{la}'](
                la, lb, l, n, Ka, Kb, *_ptrs(*p), *e.shape,
                *_ptrs(e, c, r, sph(la, DEV), sph(lb, DEV), sph(l, DEV),
                       out), offs[-1], offs[i], omega, None) == 0
        _close(out, j3c.int3c2e_plain(la, lb, *p, aux, omega))


@pytest.mark.parametrize('omega', [0.0, OMEGA])
def test_int2c2e(host, water, omega):
    """The (P|Q) metric over every aux class pair, up to (g|g)."""
    mol, _, _ = water
    aux = j3c.aux_tables(make_auxmol(mol))
    offs, _ = kernels._aux_offsets(aux)
    out = torch.empty((offs[-1], offs[-1]), dtype=torch.float64)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j in range(i, len(aux)):
            ly, ey, cy, ry = aux[j]
            assert host['int2c2e'](
                lx, ly, *ex.shape, *_ptrs(ex, cx, rx), *ey.shape,
                *_ptrs(ey, cy, ry, sph(lx, DEV), sph(ly, DEV), out),
                offs[-1], offs[i], offs[j], omega, None) == 0
    _close(out, j3c.int2c2e_plain(aux, omega))


# an aux basis of s to h shells on O (h: the lc 5 of cc-pvqz-jkfit) and two
# on H
HOST_AUX = {'O': [[l, [0.7 + 0.4 * l, 1.0]] for l in range(6)],
            'H': [[0, [1.4, 1.0]], [2, [0.8, 1.0]]]}
HOST_ATOMS = 'O 0.1 0.2 -0.3; H 0.3 -0.7 0.6'


@pytest.fixture(scope='module')
def fg_mols():
    """HOST_BASIS (s to g) and HOST_AUX (s to h) on two centres off the
    origin."""
    return (tpt.M(atom=HOST_ATOMS, basis=HOST_BASIS, device='cpu'),
            tpt.M(atom=HOST_ATOMS, basis=HOST_AUX, device='cpu'))


def test_int1e_stv_f_and_g(host, fg_mols):
    """S/T/V of every class la <= lb of s to g shells, (ff) and (gg)
    among them, and S alone of every ordered class, against class_stv."""
    mol, _ = fg_mols
    zr = torch.as_tensor(mol.coords)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64)
    classes = j3c.screened_pairs(mol)
    assert (3, 3) in classes and (4, 4) in classes
    for (la, lb), (_, p) in classes.items():
        n, Ka, Kb = _dims(p)
        out = torch.empty((n, (2 * la + 1) * (2 * lb + 1), 3),
                          dtype=torch.float64)
        assert host['int1e_stv'](
            la, lb, 1, n, Ka, Kb, *_ptrs(*p), mol.natm,
            *_ptrs(zr, zq, sph(la, DEV), sph(lb, DEV), out), None) == 0
        _close(out, int1e.class_stv(la, lb, *p, zr, zq))
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        n, Ka, Kb = _dims(p)
        out = torch.empty((n, (2 * la + 1) * (2 * lb + 1)),
                          dtype=torch.float64)
        assert host['int1e_stv'](
            la, lb, 0, n, Ka, Kb, *_ptrs(*p), 0, None, None,
            *_ptrs(sph(la, DEV), sph(lb, DEV), out), None) == 0
        _close(out, int1e.class_stv(la, lb, *p, with_tv=False))


@pytest.mark.parametrize('omega', [0.0, OMEGA])
def test_int3c2e_f_and_g(host, fg_mols, omega):
    """Raw (ij|P) rows of the (ff) and (gg) bra classes against an aux basis
    of s to h shells (lc 5), with and without the attenuation."""
    mol, auxmol = fg_mols
    aux = j3c.aux_tables(auxmol)
    assert [a[0] for a in aux] == list(range(6))
    offs, _ = kernels._aux_offsets(aux)
    classes = j3c.screened_pairs(mol)
    for la, lb in ((3, 3), (4, 4)):
        p = classes[(la, lb)][1]
        n, Ka, Kb = _dims(p)
        out = torch.empty((n * (2 * la + 1) * (2 * lb + 1), offs[-1]),
                          dtype=torch.float64)
        for i, (l, e, c, r) in enumerate(aux):
            assert host[f'int3c2e_la{la}'](
                la, lb, l, n, Ka, Kb, *_ptrs(*p), *e.shape,
                *_ptrs(e, c, r, sph(la, DEV), sph(lb, DEV), sph(l, DEV),
                       out), offs[-1], offs[i], omega, None) == 0
        _close(out, j3c.int3c2e_plain(la, lb, *p, aux, omega))


def test_int2c2e_to_h(host, fg_mols):
    """The (P|Q) metric of an aux basis of s to h shells, (h|h) among its
    class pairs."""
    _, auxmol = fg_mols
    aux = j3c.aux_tables(auxmol)
    offs, _ = kernels._aux_offsets(aux)
    out = torch.empty((offs[-1], offs[-1]), dtype=torch.float64)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j in range(i, len(aux)):
            ly, ey, cy, ry = aux[j]
            assert host['int2c2e'](
                lx, ly, *ex.shape, *_ptrs(ex, cx, rx), *ey.shape,
                *_ptrs(ey, cy, ry, sph(lx, DEV), sph(ly, DEV), out),
                offs[-1], offs[i], offs[j], 0.0, None) == 0
    _close(out, j3c.int2c2e_plain(aux))


@pytest.mark.parametrize('omega', [0.0, OMEGA])
def test_int2e_f_and_g(host, fg_mols, omega):
    """(ff|..) and (gg|..) rows against every ket class of s to g shells,
    (ff|ff), (ff|gg), (gg|ff) and (gg|gg) among them, with and without the
    attenuation."""
    mol, _ = fg_mols
    kets = j2e._ket_arrays(mol)
    classes = j3c.screened_pairs(mol)
    for la, lb in ((3, 3), (4, 4)):
        p = classes[(la, lb)][1]
        ref = j2e.int2e_class_plain(la, lb, *p, kets, omega)
        got = _quartets(host[f'int2e_{la}{lb}'], la, lb, p, kets,
                        torch.empty_like(ref), ref.shape[1], omega)
        _close(got, ref)


def test_vv10(host):
    """vv10.cu, one thread per block, on water's level-1 grid at a seeded
    density (some points under RHO_CUT) against vv10_plain: the energy to
    1e-12 relative, dE/drho and dE/dg2 to 1e-12 of their largest
    magnitude."""
    from pyscf_tpu_torch.dft import gen_grid, vv10
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cpu')
    grids = gen_grid.Grids(mol)
    grids.level = 0
    grids.build()
    n = grids.size
    rng = np.random.default_rng(61)
    rho = torch.as_tensor(10.0 ** rng.uniform(-10, 1, n))
    g2 = torch.as_tensor(rho.numpy() ** (8 / 3) * 10.0 ** rng.uniform(
        -3, 2, n))
    assert bool((rho <= vv10.RHO_CUT).any())
    out = torch.empty((3, n), dtype=torch.float64)
    assert host['vv10'](n, *_ptrs(grids.coords, rho, g2, grids.weights),
                        6.0, 0.01, out.data_ptr(), 1, None) == 0
    e, dr, dg = vv10.vv10_plain(rho, g2, grids.coords, grids.weights, 6.0,
                                0.01)
    assert abs(float(out[0].sum() - e)) <= 1e-12 * abs(float(e))
    _close(out[1], dr)
    _close(out[2], dg)


def test_int2e_ip1(host, water):
    mol, _, _ = water
    kets = j2e._ket_arrays(mol)
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        ref = int2e.int2e_ip1_class_plain(la, lb, *p, kets)
        got = _quartets(host[f'int2e_ip1_la{la}'], la, lb, p, kets,
                        torch.empty_like(ref), ref.shape[2])
        _close(got, ref)


def _close_contracted(got, ref):
    """1e-10 x max |value|, the card's limit for the contracted sums."""
    assert torch.max(torch.abs(got - ref)) <= 1e-10 * ref.abs().max()


def test_int3c2e_ip(host, water):
    """Every bra class of water/def2-SVP against the def2-universal-jkfit
    aux classes, up to (dd|g), on seeded Gamma rows."""
    mol, _, _ = water
    aux = j3c.aux_tables(make_auxmol(mol))
    offs, shs = kernels._aux_offsets(aux)
    rng = np.random.default_rng(3)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        n, Ka, Kb = _dims(p)
        G = torch.as_tensor(rng.standard_normal(
            (n * (2 * la + 1) * (2 * lb + 1), offs[-1])))
        out = torch.empty((n, shs[-1], 6), dtype=torch.float64)
        for i, (l, e, c, r) in enumerate(aux):
            assert host[f'int3c2e_ip_la{la}'](
                la, lb, l, n, Ka, Kb, *_ptrs(*p), e.shape[0], e.shape[1],
                *_ptrs(e, c, r, sph(la, DEV), sph(lb, DEV), sph(l, DEV), G),
                offs[-1], offs[i], out.data_ptr(), shs[-1], shs[i],
                None) == 0
        _close_contracted(out, j3c_deriv.int3c2e_ip_plain(la, lb, *p, aux, G))


def test_int2c2e_ip1(host, water):
    """Every ordered aux class pair of def2-universal-jkfit on water, up to
    (g|g), on a seeded symmetric W."""
    mol, _, _ = water
    aux = j3c.aux_tables(make_auxmol(mol))
    offs, shs = kernels._aux_offsets(aux)
    W = np.random.default_rng(4).standard_normal((offs[-1], offs[-1]))
    W = torch.as_tensor(W + W.T)
    out = torch.empty((shs[-1], shs[-1], 3), dtype=torch.float64)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j, (ly, ey, cy, ry) in enumerate(aux):
            assert host['int2c2e_ip1'](
                lx, ly, *ex.shape, *_ptrs(ex, cx, rx), *ey.shape,
                *_ptrs(ey, cy, ry, sph(lx, DEV), sph(ly, DEV), W), offs[-1],
                offs[i], offs[j], out.data_ptr(), shs[-1], shs[i], shs[j],
                None) == 0
    _close_contracted(out, j3c_deriv.int2c2e_ip1_plain(aux, W))


def _few(pairs, k):
    """The first k shell pairs of a class's pair tables."""
    return [t[:k].contiguous() for t in pairs]


def _few_aux(aux, k=2):
    """The first k shells of every aux class."""
    return [(l,) + tuple(t[:k].contiguous() for t in rest)
            for l, *rest in aux]


def test_int1e_ipip(host, water):
    """Every ordered class of water/def2-SVP (three shell pairs each) with
    its three charges against the twin, on seeded density blocks."""
    mol, zr, zq = water
    rng = np.random.default_rng(5)
    for la, lb, _, _, p in int1e.cross_pairs(mol, mol):
        p = _few(p, 3)
        n, Ka, Kb = _dims(p)
        D, W = (torch.as_tensor(rng.standard_normal(
            (n, (2 * la + 1) * (2 * lb + 1)))) for _ in range(2))
        out = torch.empty((n, mol.natm + 1, 27), dtype=torch.float64)
        assert host['int1e_ipip'](
            la, lb, n, Ka, Kb, *_ptrs(*p), mol.natm,
            *_ptrs(zr, zq, sph(la, DEV), sph(lb, DEV), D, W),
            out.data_ptr(), None) == 0
        _close(out, int1e_deriv.class_ipip(la, lb, *p, zr, zq, D, W))


def test_int3c2e_ip1_and_ipip(host, water):
    """Every bra class of water/def2-SVP (two pairs each, and the mirrored
    pairs for int3c2e_ip1) against two shells of every aux class up to g,
    on seeded Gamma rows: int3c2e_ip1 written into a (3, nao, nao, naux)
    tensor, int3c2e_ipip contracted."""
    mol, _, _ = water
    aux = _few_aux(j3c.aux_tables(make_auxmol(mol)))
    offs, shs = kernels._aux_offsets(aux)
    nao = mol.nao
    rng = np.random.default_rng(6)
    for (la, lb), (bc, p) in j3c.screened_pairs(mol).items():
        p = _few(p, 2)
        n, Ka, Kb = _dims(p)
        ia = torch.as_tensor(bc.ga.ao_off[bc.sel_a[:n]], dtype=torch.int32)
        jb = torch.as_tensor(bc.gb.ao_off[bc.sel_b[:n]], dtype=torch.int32)
        for a, b, pp, i0, j0 in ((la, lb, p, ia, jb),
                                 (lb, la, p[3:] + p[:3], jb, ia)):
            out = torch.zeros((3, nao, nao, offs[-1]), dtype=torch.float64)
            ref = kernels.int3c2e_ip1(a, b, *pp, aux, i0, j0,
                                      torch.zeros_like(out))
            for k, (l, e, c, r) in enumerate(aux):
                assert host[f'int3c2e_ip1_la{a}'](
                    a, b, l, n, Ka if a == la else Kb, Kb if a == la else Ka,
                    *_ptrs(*pp), e.shape[0], e.shape[1],
                    *_ptrs(e, c, r, sph(a, DEV), sph(b, DEV), sph(l, DEV),
                           i0, j0), nao, offs[-1], offs[k], out.data_ptr(),
                    None) == 0
            _close(out, ref)
        G = torch.as_tensor(rng.standard_normal(
            (n * (2 * la + 1) * (2 * lb + 1), offs[-1])))
        out = torch.empty((n, shs[-1], 27), dtype=torch.float64)
        for i, (l, e, c, r) in enumerate(aux):
            assert host[f'int3c2e_ipip_la{la}'](
                la, lb, l, n, Ka, Kb, *_ptrs(*p), e.shape[0], e.shape[1],
                *_ptrs(e, c, r, sph(la, DEV), sph(lb, DEV), sph(l, DEV), G),
                offs[-1], offs[i], out.data_ptr(), shs[-1], shs[i],
                None) == 0
        _close_contracted(out, j3c_deriv.int3c2e_ipip_plain(la, lb, *p, aux,
                                                             G))


def test_int2c2e_ip1_full_and_ipip(host, water):
    """Every ordered aux class pair of def2-universal-jkfit on water (two
    shells a class), up to (g|g): d(P|Q)/dP written out, and its second
    derivative contracted with a seeded symmetric W."""
    mol, _, _ = water
    aux = _few_aux(j3c.aux_tables(make_auxmol(mol)))
    offs, shs = kernels._aux_offsets(aux)
    naux = offs[-1]
    W = np.random.default_rng(8).standard_normal((naux, naux))
    W = torch.as_tensor(W + W.T)
    full = torch.empty((3, naux, naux), dtype=torch.float64)
    pp = torch.empty((shs[-1], shs[-1], 9), dtype=torch.float64)
    for i, (lx, ex, cx, rx) in enumerate(aux):
        for j, (ly, ey, cy, ry) in enumerate(aux):
            args = (lx, ly, *ex.shape, *_ptrs(ex, cx, rx), *ey.shape,
                    *_ptrs(ey, cy, ry, sph(lx, DEV), sph(ly, DEV)))
            assert host['int2c2e_ip1_full'](
                *args, None, naux, offs[i], offs[j], full.data_ptr(), 0, 0,
                0, None) == 0
            assert host['int2c2e_ipip'](
                *args, W.data_ptr(), naux, offs[i], offs[j], pp.data_ptr(),
                shs[-1], shs[i], shs[j], None) == 0
    _close(full, j3c_deriv.int2c2e_ip1_full_plain(aux))
    _close_contracted(pp, j3c_deriv.int2c2e_ipip_plain(aux, W))


def _seeded_cc(seed, no=5, nv=9):
    """Seeded tensors of a water-sized correlated calculation: ovov, t1,
    t2 (o, o, v, v), ooov, ovvv, the orbital energies (occupied below
    -0.5, virtual above 0.2) and eia."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((no, nv, no, nv)) * 0.1
    ovov = torch.as_tensor(g + g.transpose(2, 3, 0, 1))
    eo = torch.as_tensor(-0.5 - rng.random(no) * 20)
    ev = torch.as_tensor(0.2 + rng.random(nv) * 3)
    return dict(
        ovov=ovov, eo=eo, ev=ev, eia=eo[:, None] - ev[None, :],
        t1=torch.as_tensor(rng.standard_normal((no, nv)) * 0.02),
        t2=torch.as_tensor(rng.standard_normal((no, no, nv, nv)) * 0.05),
        ooov=torch.as_tensor(rng.standard_normal((no, no, no, nv)) * 0.1),
        ovvv=torch.as_tensor(rng.standard_normal((no, nv, nv, nv)) * 0.1))


def _mp2_host(host, ovov, eia1, eia2, tau, exchange, with_t2):
    no1, nv1, no2, nv2 = ovov.shape
    t2 = torch.empty_like(ovov) if with_t2 else None
    partials = torch.empty((no1 * no2, 2), dtype=torch.float64)
    assert host['mp2_energy'](
        no1, nv1, no2, nv2, ovov.data_ptr(),
        None if eia1 is None else eia1.data_ptr(),
        None if eia2 is None else eia2.data_ptr(),
        None if tau is None else tau.data_ptr(), int(exchange),
        None if t2 is None else t2.data_ptr(), partials.data_ptr(), 1,
        None) == 0
    return t2, partials.sum(dim=0)


def test_mp2_energy(host):
    """mp2_energy.cu, one thread per block, against mp2_energy_plain: the
    amplitudes to 1e-13 of their largest and the sums to 1e-12 relative;
    MP2 with its exchange sum, the CCSD tau read in its (i,j,a,b) layout,
    and an opposite-spin block of other sizes without exchange."""
    from pyscf_tpu_torch.mp.mp2 import mp2_energy_plain
    d = _seeded_cc(5)
    ovov, eia = d['ovov'], d['eia']
    no, nv = eia.shape

    def close(got, ref):
        assert abs(float(got - ref)) <= 1e-12 * abs(float(ref))

    t2, sums = _mp2_host(host, ovov, eia, eia, None, True, True)
    rt2, rd, rx = mp2_energy_plain(ovov, eia, eia)
    assert torch.max(torch.abs(t2 - rt2)) <= 1e-13 * rt2.abs().max()
    close(sums[0], rd)
    close(sums[1], rx)
    tau = d['t2'] + torch.einsum('ia,jb->ijab', d['t1'], d['t1'])
    _, sums = _mp2_host(host, ovov, None, None, tau, True, False)
    _, rd, rx = mp2_energy_plain(ovov, None, None, tau)
    close(sums[0], rd)
    close(sums[1], rx)
    rng = np.random.default_rng(6)
    ovab = torch.as_tensor(rng.standard_normal((no, nv, 3, 7)))
    eib = torch.as_tensor(-1.0 - rng.random((3, 7)))
    _, sums = _mp2_host(host, ovab, eia, eib, None, False, False)
    _, rd, _ = mp2_energy_plain(ovab, eia, eib, exchange=False)
    close(sums[0], rd)


def test_ccsd_t(host):
    """ccsd_t.cu, one thread per block, against et_plain triple by triple
    on seeded tensors (nocc 5, nvir 9: 165 triples, 9 with a = b = c, 72
    with one pair equal) to 1e-12 of the largest triple's magnitude (an
    a = b = c triple sums to zero up to rounding), and the sum to 1e-12
    relative, with the vvov slices staged whole and in f tiles of 4 (the
    last one short)."""
    from types import SimpleNamespace

    from pyscf_tpu_torch.cc import ccsd_t
    d = _seeded_cc(7)
    no, nv = d['t1'].shape
    eris = SimpleNamespace(ovvv=d['ovvv'], ooov=d['ooov'], ovov=d['ovov'],
                           mo_energy=torch.cat([d['eo'], d['ev']]))
    args = ccsd_t.kernel_args(eris, d['t1'], d['t2'])
    abc_t, mult_t, vvov, vooo, ovov, t2, t1, eo, ev = args
    assert sorted(np.unique(mult_t, return_counts=True)[1]) == [9, 72, 84]
    ijk = torch.tensor([(i, j, k) for i in range(no) for j in range(i + 1)
                        for k in range(j + 1)], dtype=torch.int32)
    t2T = t2.permute(2, 3, 0, 1).contiguous()
    ref = torch.stack([ccsd_t.et_plain(abc_t[n:n + 1], mult_t[n:n + 1],
                                       *args[2:]) for n in range(len(abc_t))])
    total = ccsd_t.et_plain(*args)
    for ft in (nv, 4):
        partials = torch.empty(len(abc_t), dtype=torch.float64)
        assert host['ccsd_t'](
            no, nv, ft, len(abc_t), abc_t.data_ptr(), mult_t.data_ptr(),
            ijk.shape[0], *_ptrs(ijk, vvov, vooo, t2, t2T, ovov, t1, eo, ev,
                                 partials), 1, None) == 0
        assert (torch.max(torch.abs(partials - ref))
                <= 1e-12 * ref.abs().max())
        assert (abs(float(partials.sum() - total))
                <= 1e-12 * abs(float(total)))


# ---- the second-order dual numbers of the XC response kernels --------------

# reads the terms, the number of inputs per point (2: rho, sigma for
# edens_closed2; 5: rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb for
# edens_open2) and the points; prints e_xc, its first and its packed second
# derivatives per point
HDUAL_HARNESS = r'''
#include <cstdio>
#include "xc_funcs.cuh"
template <int N>
void print(const ptxc::HDualN<N>& e) {
  printf("%.17g", e.v);
  for (int k = 0; k < N; ++k) printf(" %.17g", e.d[k]);
  for (int k = 0; k < ptxc::HDualN<N>::M; ++k) printf(" %.17g", e.h[k]);
  printf("\n");
}
int main() {
  ptxc::Terms t;
  if (scanf("%d", &t.n) != 1) return 1;
  for (int k = 0; k < t.n; ++k) scanf("%d %lf", &t.id[k], &t.c[k]);
  int m, n;
  if (scanf("%d %d", &m, &n) != 2) return 1;
  for (int i = 0; i < n; ++i) {
    double x[5];
    for (int k = 0; k < m; ++k) scanf("%lf", &x[k]);
    if (m == 2) print(ptxc::edens_closed2(t, x[0], x[1]));
    else print(ptxc::edens_open2(t, x[0], x[1], x[2], x[3], x[4]));
  }
  return 0;
}
'''
HDUAL_NAMES = ['SLATER', 'VWN5', 'VWN3', 'B88', 'LYP', 'b3lypg']


@pytest.fixture(scope='module')
def hdual(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build csrc/xc_funcs.cuh for the host')
    d = tmp_path_factory.mktemp('hdual_host')
    (d / 'h.cpp').write_text(HDUAL_HARNESS)
    subprocess.run([gxx, '-O1', '-std=c++17', '-I', kernels._CSRC, '-o',
                    str(d / 'h'), str(d / 'h.cpp')], check=True)
    return d / 'h'


def _run_hdual(exe, name, x):
    """(npts, 1 + m + m(m+1)/2) of the harness at the (m, npts) inputs x."""
    f = xc.parse_xc(name)
    lines = [str(len(f.terms))]
    lines += [f'{kernels.XC_COMPONENT_IDS[comp]} {c!r}' for c, _, comp in
              f.terms]
    lines += [f'{x.shape[0]} {x.shape[1]}']
    lines += [' '.join(repr(float(v)) for v in col) for col in x.T]
    out = subprocess.run([str(exe)], input='\n'.join(lines) + '\n',
                         capture_output=True, text=True, check=True).stdout
    return np.array([[float(v) for v in ln.split()]
                     for ln in out.splitlines()])


def _hdual_points():
    """64 seeded points: rho_s in [1e-10, 1e2], sigma_ss in [1e-20, 1e3],
    log-uniform (the extremes included), |sigma_ab| <= sqrt(sigma_aa
    sigma_bb) of either sign."""
    rng = np.random.default_rng(29)
    n = 64
    ra, rb = 10.0 ** rng.uniform(-10, 2, (2, n))
    saa, sbb = 10.0 ** rng.uniform(-20, 3, (2, n))
    ra[:2], rb[:2], saa[:2], sbb[:2] = (1e-10, 1e2), (1e2, 1e-10), \
        (1e-20, 1e3), (1e3, 1e-20)
    sab = rng.uniform(-1, 1, n) * np.sqrt(saa * sbb)
    return np.stack([ra, rb, saa, sab, sbb])


def _hdual_gate(got, e, g, h, x):
    """e_xc to 1e-12 relative; each first and second derivative to 1e-9 of
    its size plus the point's energy-density scale rho_a^(4/3) +
    rho_b^(4/3) over its variables (rho_s, sigma_ss, sqrt(sigma_aa
    sigma_bb) for sigma_ab): LYP's terms cancel at extreme inputs, where
    forward and reverse modes round apart (tests/test_torch_uks.py)."""
    m = x.shape[0]
    if m == 5:
        scale = x[0] ** (4 / 3) + x[1] ** (4 / 3)
        v = np.stack([x[0], x[1], x[2], np.sqrt(x[2] * x[4]), x[4]]).T
    else:
        scale = x[0] ** (4 / 3)
        v = x.T
    iu = np.triu_indices(m)
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got[:, 0] - e) <= 1e-12 * np.abs(e))
    assert np.all(np.abs(got[:, 1:1 + m] - g)
                  <= 1e-9 * (np.abs(g) + scale[:, None] / v))
    hp = h[:, iu[0], iu[1]]
    assert np.all(np.abs(got[:, 1 + m:] - hp) <= 1e-9 * (
        np.abs(hp) + scale[:, None] / (v[:, iu[0]] * v[:, iu[1]])))


@pytest.mark.parametrize('name', HDUAL_NAMES)
def test_hdual_matches_torch_hessian(hdual, name):
    """edens_open2 and edens_closed2 (HDualN<5>, HDualN<2>) against
    torch.func.hessian of the port's energy densities: the open shell's
    over (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb), the closed shell's
    over (rho, sigma) of numint.edens_closed."""
    f = xc.parse_xc(name)
    x = _hdual_points()
    X = torch.as_tensor(x.T.copy())

    def e5(u):
        return f.exc_density(*u)

    H = torch.func.vmap(torch.func.hessian(e5))(X).numpy()
    G = torch.func.vmap(torch.func.grad(e5))(X).numpy()
    _hdual_gate(_run_hdual(hdual, name, x), e5(X.T).numpy(), G, H, x)
    xc2 = x[[0, 2]] * np.array([[2.0], [4.0]])      # rho, sigma

    def e2(u):
        return numint.edens_closed(f, u[0], u[1])

    X2 = torch.as_tensor(xc2.T.copy())
    _hdual_gate(_run_hdual(hdual, name, xc2), e2(X2.T).numpy(),
                torch.func.vmap(torch.func.grad(e2))(X2).numpy(),
                torch.func.vmap(torch.func.hessian(e2))(X2).numpy(), xc2)


def test_hdual_matches_jax_hessian(hdual):
    """edens_open2 of b3lypg against jax.hessian of the JAX package's
    exc_density at the same points, the live reference of the Hessian
    route (pyscf_tpu/tdscf/rhf.py:101)."""
    fj = jax_xc.parse_xc('b3lypg')
    x = _hdual_points()

    def e5(u):
        return fj.exc_density(*u)

    X = jnp.asarray(x.T)
    H = np.asarray(jax.jit(jax.vmap(jax.hessian(e5)))(X))
    G = np.asarray(jax.jit(jax.vmap(jax.grad(e5)))(X))
    _hdual_gate(_run_hdual(hdual, 'b3lypg', x), np.asarray(e5(X.T)), G, H, x)
