"""Record the JAX package's Γ-point periodic values that
tests/test_torch_pbc.py compares the port with, where the JAX run takes
more than a few seconds (its image loops of eval_ao and of the 1e cross
integrals dispatch ~1500 jitted calls each):

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/pbc_refs_record.py [names]

writes pyscf_tpu_torch/data/pbc_refs.npz. The cell is the diamond
primitive cell of BASELINE config 5 (tests/test_pbc.py DIAMOND: gth-szv,
gth-pade). With the names of recording functions only those run and the
file keeps the other keys (each name may run in a process of its own and
merge into the file):

  ao_refs      eval_ao_periodic on the [9]^3 uniform grid at the cell's
               rcut, deriv 0 'ao9_d0' and deriv 1 'ao9_d1';
  int1e_refs   FFTDF at [15]^3: the lattice-summed overlap 'ovlp', kinetic
               'kin', the GTH local part 'pp_loc' (get_pp less get_pp_nl)
               and the non-local part 'pp_nl';
  lda_refs     RKS lda,vwn at [17]^3 (hcore, conv_tol 1e-9): 'e_lda17';
  rhf_refs     RHF at [17]^3 (exxdiv 'ewald'; hcore, conv_tol 1e-9):
               'e_rhf17', and madelung 'madelung17';
  pbe_refs     RKS pbe at [15]^3 (hcore, conv_tol 1e-9), FFTDF 'e_pbe15_fft'
               and GDF's Cholesky route 'e_pbe15_gdf';
  etb_refs     RKS pbe at [9]^3 (its ETB aux cell has 4,213 images, so
               the port's test takes the small mesh) through FFTDF
               'e_pbe9_fft' and through GDF's ETB aux cell 'e_pbe9_etb',
               with the aux count after the eigenvalue cut 'etb_naux'.

For each PBE energy '<key>' the converged density '<key>_dm' is kept
too, and the energy is checked to be the functional at that density: the
JAX package's periodic RKS puts half the GGA term into V_xc
(pyscf_tpu/pbc/dft/rks.py:68-70), so its converged density is not the
functional's stationary point and the port's SCF ends below it; the port
is held to the functional at this density.

Each '<key>_seconds' is the JAX run's wall on the CPU it was recorded on.
"""
import os
import sys
import time

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyscf_tpu_torch', 'data', 'pbc_refs.npz')

DIAMOND = dict(
    atom='C 0 0 0; C 0.8917 0.8917 0.8917',
    a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834], [1.7834, 1.7834, 0]],
    basis='gth-szv', pseudo='gth-pade', verbose=0)


def _cell(n):
    from pyscf_tpu.pbc.gto import Cell
    return Cell(mesh=[n] * 3, **DIAMOND).build()


def _scf(mf):
    mf.conv_tol = 1e-9
    mf.init_guess = 'hcore'
    mf.verbose = 0
    t0 = time.time()
    e = float(mf.kernel())
    assert mf.converged
    return e, time.time() - t0


def _pbe(out, key, mf):
    """'<key>', its seconds and the converged density '<key>_dm'."""
    out[key], out[f'{key}_seconds'] = _scf(mf)
    dm = mf.make_rdm1()
    out[f'{key}_dm'] = np.asarray(dm)
    e_dm = mf.energy_tot(dm, mf.get_hcore(), mf.get_veff(mf.cell, dm))
    assert abs(e_dm - out[key]) < 1e-12, (key, e_dm - out[key])


def ao_refs(out):
    from pyscf_tpu.pbc.df.fft import eval_ao_periodic
    cell = _cell(9)
    for d in (0, 1):
        t0 = time.time()
        out[f'ao9_d{d}'] = np.asarray(eval_ao_periodic(
            cell, cell.get_uniform_grids(), d))
        out[f'ao9_d{d}_seconds'] = time.time() - t0


def int1e_refs(out):
    from pyscf_tpu.pbc.df.fft import FFTDF
    df = FFTDF(_cell(15))
    t0 = time.time()
    out['ovlp'] = np.asarray(df.get_ovlp())
    out['kin'] = np.asarray(df.get_kin())
    out['pp_nl'] = np.asarray(df.get_pp_nl())
    out['pp_loc'] = np.asarray(df.get_pp()) - out['pp_nl']
    out['int1e_seconds'] = time.time() - t0


def lda_refs(out):
    from pyscf_tpu.pbc.dft import RKS
    out['e_lda17'], out['e_lda17_seconds'] = _scf(RKS(_cell(17),
                                                      xc='lda,vwn'))


def rhf_refs(out):
    from pyscf_tpu.pbc.scf import RHF
    from pyscf_tpu.pbc.scf.hf import madelung
    cell = _cell(17)
    out['madelung17'] = madelung(cell)
    out['e_rhf17'], out['e_rhf17_seconds'] = _scf(RHF(cell))


def pbe_refs(out):
    from pyscf_tpu.pbc.dft import RKS
    cell = _cell(15)
    _pbe(out, 'e_pbe15_fft', RKS(cell, xc='pbe'))
    _pbe(out, 'e_pbe15_gdf', RKS(cell, xc='pbe').density_fit())


def etb_refs(out):
    from pyscf_tpu.pbc.dft import RKS
    cell = _cell(9)
    _pbe(out, 'e_pbe9_fft', RKS(cell, xc='pbe'))
    # any auxbasis that is not a basis name selects the ETB aux cell
    mf = RKS(cell, xc='pbe').density_fit(auxbasis=True)
    _pbe(out, 'e_pbe9_etb', mf)
    out['etb_naux'] = mf.with_df.naux


FUNCTIONS = (ao_refs, int1e_refs, lda_refs, rhf_refs, pbe_refs, etb_refs)


def main(names):
    import pyscf_tpu  # noqa: F401  (float64 on)
    res = {}
    for fn in FUNCTIONS:
        if names and fn.__name__ not in names:
            continue
        fn(res)
        print(fn.__name__, 'done', flush=True)
    import fcntl
    import tempfile
    with open(os.path.join(tempfile.gettempdir(), 'pbc_refs.lock'),
              'w') as lock:                         # one merge at a time
        fcntl.flock(lock, fcntl.LOCK_EX)
        out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
        out.update(res)
        np.savez_compressed(OUT, **out)


if __name__ == '__main__':
    main(sys.argv[1:])
