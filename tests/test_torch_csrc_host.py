"""The integral kernels' CUDA sources, compiled for the host with g++,
against their plain twins.

There is no CUDA compiler or card where the fast tests run, so this file
compiles csrc/int1e_stv.cu, int2e.cu, int1e_ip.cu, int1e_iprinv.cu,
int2e_ip1.cu, int3c2e_ip.cu, int2c2e_ip1.cu and int1e_r.cu as C++ behind
a small stand-in for cuda_runtime.h (the qualifiers defined away, a
launch turned into a loop over blocks and threads) and calls them through
the C interface the wrappers use, on water/def2-SVP, whose classes reach
(dd|dd), and the dipole kernel on a basis of s to g shells. It checks the
kernels' arithmetic and indexing, not that nvcc accepts them: that is
tests/test_torch_kernels.py on the card."""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

import pyscf_tpu_torch as tpt
import numpy as np

from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
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
struct Dim { int x; };
static thread_local Dim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
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
LIBS = ('int1e_stv', 'int2e', 'int1e_ip', 'int1e_iprinv', 'int2e_ip1_la0',
        'int2e_ip1_la1', 'int2e_ip1_la2', 'int3c2e_ip_la0', 'int3c2e_ip_la1',
        'int3c2e_ip_la2', 'int2c2e_ip1', 'int1e_r')
DEV = torch.device('cpu')


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """{library: ctypes function} of the sources built for the host."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the CUDA sources for the host')
    out = tmp_path_factory.mktemp('csrc_host')
    (out / 'cuda_runtime.h').write_text(SHIM)
    jobs = []
    for lib in LIBS:
        src, _, _, flags = kernels._LIBRARIES[lib]
        text = open(f'{kernels._CSRC}/{src}').read()
        text, n = re.subn(
            r'(\w+<[^;<>]*>)<<<blocks, threads, 0, stream>>>\(\s*',
            r'host_launch(blocks, threads, \1, ', text)
        assert n == 1
        (out / f'{lib}.cpp').write_text(text)
        jobs.append(subprocess.Popen(
            [gxx, '-O1', '-std=c++17', '-shared', '-fPIC', '-w', *flags,
             '-I', str(out), '-I', kernels._CSRC, '-o', str(out / f'{lib}.so'),
             str(out / f'{lib}.cpp')]))
    assert all(j.wait() == 0 for j in jobs)
    fns = {}
    for lib in LIBS:
        _, name, argtypes, _ = kernels._LIBRARIES[lib]
        fns[lib] = getattr(ctypes.CDLL(str(out / f'{lib}.so')), name)
        fns[lib].argtypes = argtypes
        fns[lib].restype = ctypes.c_int
    return fns


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


def _quartets(fn, la, lb, p, kets, out, ncol):
    n, Ka, Kb = _dims(p)
    col = 0
    for lc, ld, *ket in kets:
        nk, Kc, Kd = _dims(ket)
        assert fn(la, lb, lc, ld, n, Ka, Kb, *_ptrs(*p), nk, Kc, Kd,
                  *_ptrs(*ket), *_ptrs(*[sph(l, DEV) for l in
                                         (la, lb, lc, ld)]),
                  out.data_ptr(), ncol, col, None) == 0
        col += nk * (2 * lc + 1) * (2 * ld + 1)
    return out


def test_int2e(host, water):
    mol, _, _ = water
    kets = j2e._ket_arrays(mol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        ref = j2e.int2e_class_plain(la, lb, *p, kets)
        got = _quartets(host['int2e'], la, lb, p, kets,
                        torch.empty_like(ref), ref.shape[1])
        _close(got, ref)


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
