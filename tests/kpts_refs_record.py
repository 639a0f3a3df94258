"""Record the JAX package's k-point periodic values that
tests/test_torch_kpts.py compares the port with (its image loops of
eval_ao_kpts and of the 1e cross integrals dispatch ~1500 jitted calls
each, ~50 s for the AO values alone at [9]^3):

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/kpts_refs_record.py [names]

writes pyscf_tpu_torch/data/kpts_refs.npz. The cell is the diamond
primitive cell of BASELINE config 5 (tests/test_pbc.py DIAMOND: gth-szv,
gth-pade) at mesh [9]^3 with the shifted 2x1x1 Monkhorst-Pack mesh
(make_kpts([2, 1, 1], with_gamma_point=False): fractions -1/4 and 1/4
along the first reciprocal vector, so every phase is complex), and for
the open-shell pair the same cell with spin=2. With the names of
recording functions only those run and the file keeps the other keys
(each name may run in a process of its own and merge into the file):

  int1e_refs   KFFTDF: the phased overlap 'ovlp_k', kinetic 'kin_k' and
               GTH pseudopotential 'pp_k' (local + non-local);
  krhf_refs    KRHF (exxdiv 'ewald', conv_tol 1e-10): 'e_krhf', its
               converged density 'dm_krhf', the FFT J and K at that
               density without the exxdiv term ('vj_k', 'vk_k') and the
               Madelung constant of the k mesh 'madelung_k';
  krks_refs    KRKS lda,vwn 'e_krks_lda' and pbe 'e_krks_pbe';
  open_refs    the spin-2 cell: KUHF 'e_kuhf_s2' and KUKS pbe
               'e_kuks_pbe_s2';
  open_gamma_refs  the spin-2 cell on the Γ-centred 2x1x1 mesh
               (make_kpts([2, 1, 1])): KUHF and KUKS pbe, each run's last
               energy, whether it converged, its cycles and the electronic
               energy of every cycle ('e_kuhf_s2_g', 'kuhf_s2_g_converged',
               'kuhf_s2_g_cycles', 'kuhf_s2_g_trace', and the same for
               'kuks_pbe_s2_g'), recorded whatever the outcome;
  open_gamma17_refs  the same at mesh [17]^3 (keys ending '_g17').

The JAX package's eval_ao_kpts is memoized per (cell, deriv, k-points,
rcut) and its S_k per KFFTDF while recording: its KRKS recomputes the AO
values in every cycle and its exchange S_k in every get_jk call, and the
memo returns the same arrays. Each '<key>_seconds' is the JAX run's wall
on the CPU it was recorded on.
"""
import os
import sys
import time

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyscf_tpu_torch', 'data', 'kpts_refs.npz')

DIAMOND = dict(
    atom='C 0 0 0; C 0.8917 0.8917 0.8917',
    a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834], [1.7834, 1.7834, 0]],
    basis='gth-szv', pseudo='gth-pade', verbose=0)
MESH = [9] * 3
NKS = [2, 1, 1]


def _memoize():
    from pyscf_tpu.pbc.df import fft
    ao_memo, ovlp_memo = {}, {}
    eval_ao_kpts = fft.eval_ao_kpts
    get_ovlp_kpts = fft.KFFTDF.get_ovlp_kpts

    def ao(cell, coords, kpts, deriv=0, rcut=None):
        key = (id(cell), deriv, np.asarray(kpts).tobytes(), rcut)
        if key not in ao_memo:
            ao_memo[key] = eval_ao_kpts(cell, coords, kpts, deriv, rcut)
        return ao_memo[key]

    def ovlp(self):
        if id(self) not in ovlp_memo:
            ovlp_memo[id(self)] = get_ovlp_kpts(self)
        return ovlp_memo[id(self)]

    fft.eval_ao_kpts = ao
    fft.KFFTDF.get_ovlp_kpts = ovlp


def _cell(spin=0):
    from pyscf_tpu.pbc.gto import Cell
    cell = Cell(mesh=MESH, spin=spin, **DIAMOND).build()
    return cell, cell.make_kpts(NKS, with_gamma_point=False)


def _scf(out, key, mf):
    mf.conv_tol = 1e-10
    t0 = time.time()
    out[key] = float(mf.kernel())
    out[f'{key}_seconds'] = time.time() - t0
    assert mf.converged, key
    return mf


def int1e_refs(out):
    from pyscf_tpu.pbc.df.fft import KFFTDF
    cell, kpts = _cell()
    df = KFFTDF(cell, kpts)
    t0 = time.time()
    out['ovlp_k'] = np.asarray(df.get_ovlp_kpts())
    out['kin_k'] = np.asarray(df.get_kin_kpts())
    out['pp_k'] = np.asarray(df.get_pp_kpts())
    out['int1e_k_seconds'] = time.time() - t0


def krhf_refs(out):
    from pyscf_tpu.pbc.scf.hf import madelung
    from pyscf_tpu.pbc.scf.khf import KRHF
    cell, kpts = _cell()
    mf = _scf(out, 'e_krhf', KRHF(cell, kpts=kpts))
    dm = mf.make_rdm1()
    out['dm_krhf'] = dm
    out['vj_k'], out['vk_k'] = mf.with_df.get_jk_kpts(dm)
    out['madelung_k'] = madelung(cell, kpts)


def krks_refs(out):
    from pyscf_tpu.pbc.dft.krks import KRKS
    cell, kpts = _cell()
    _scf(out, 'e_krks_lda', KRKS(cell, kpts=kpts, xc='lda,vwn'))
    _scf(out, 'e_krks_pbe', KRKS(cell, kpts=kpts, xc='pbe'))


def open_refs(out):
    from pyscf_tpu.pbc.dft.kuks import KUKS
    from pyscf_tpu.pbc.scf.kuhf import KUHF
    cell, kpts = _cell(spin=2)
    _scf(out, 'e_kuhf_s2', KUHF(cell, kpts=kpts))
    _scf(out, 'e_kuks_pbe_s2', KUKS(cell, kpts=kpts, xc='pbe'))


def _open_gamma(out, mesh, tag):
    from pyscf_tpu.pbc.dft.kuks import KUKS
    from pyscf_tpu.pbc.gto import Cell
    from pyscf_tpu.pbc.scf.kuhf import KUHF
    cell = Cell(mesh=mesh, spin=2, **DIAMOND).build()
    kpts = cell.make_kpts(NKS)
    for key, mf in ((f'kuhf_s2_{tag}', KUHF(cell, kpts=kpts)),
                    (f'kuks_pbe_s2_{tag}', KUKS(cell, kpts=kpts, xc='pbe'))):
        mf.conv_tol = 1e-10
        trace = []                  # the electronic energy of each cycle
        energy_elec = mf.energy_elec
        mf.energy_elec = lambda *a, f=energy_elec, t=trace: t.append(
            f(*a)) or t[-1]
        t0 = time.time()
        out[f'e_{key}'] = float(mf.kernel())
        out[f'{key}_seconds'] = time.time() - t0
        out[f'{key}_converged'] = bool(mf.converged)
        out[f'{key}_cycles'] = len(trace)
        out[f'{key}_trace'] = np.asarray(trace, dtype=np.float64)
        print(key, out[f'e_{key}'], 'converged', mf.converged, 'cycles',
              len(trace), flush=True)


def open_gamma_refs(out):
    _open_gamma(out, MESH, 'g')


def open_gamma17_refs(out):
    _open_gamma(out, [17] * 3, 'g17')


FUNCTIONS = (int1e_refs, krhf_refs, krks_refs, open_refs, open_gamma_refs,
             open_gamma17_refs)


def main(names):
    import pyscf_tpu  # noqa: F401  (float64 on)
    _memoize()
    res = {}
    for fn in FUNCTIONS:
        if names and fn.__name__ not in names:
            continue
        fn(res)
        print(fn.__name__, 'done', flush=True)
    import fcntl
    import tempfile
    with open(os.path.join(tempfile.gettempdir(), 'kpts_refs.lock'),
              'w') as lock:                         # one merge at a time
        fcntl.flock(lock, fcntl.LOCK_EX)
        out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
        out.update(res)
        np.savez_compressed(OUT, **out)


if __name__ == '__main__':
    main(sys.argv[1:])
