"""Record the JAX package's TDA/TDHF references of water that
tests/test_torch_tdscf.py compares the port with (the JAX run takes
minutes on the CPU, too long for the fast tests):

  JAX_PLATFORMS=cpu PYSCF_TPU_INT2E=v2 PYTHONPATH=. \
    python tests/tdscf_refs_record.py

writes pyscf_tpu_torch/data/tdscf_water_refs.npz with, for water/def2-SVP
DF-RKS b3lypg (grids level 1, minao guess, conv_tol 1e-12, conv_tol_grad
1e-9), the converged orbitals ('rks_mo_coeff', 'rks_mo_energy',
'rks_mo_occ', 'rks_e_tot'), get_ab's A and B of the singlet and the
triplet ('rks_a_s', 'rks_b_s', 'rks_a_t', 'rks_b_t'), the matrix-free
products of gen_tda_operation on seeded vectors ('rks_z', 'rks_az_s',
'rks_az_t'), the dense TDA singlet and triplet and the TDHF singlet
energies of five states with the TDA singlet's oscillator strengths; and
for the water cation's DF-UKS b3lypg (charge 1, spin 1, the same settings)
its orbitals ('uks_*'), get_ab_uhf's A ('uks_a', on the in-core ERIs of
mol.intor('int2e'), PYSCF_TPU_INT2E=v2 selecting the screened engine) and
TDAUKS's five lowest energies."""
import os

import numpy as np

import pyscf_tpu as pt
from pyscf_tpu.tdscf import rhf as tdrhf
from pyscf_tpu.tdscf import uhf as tduhf

WATER = 'O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587'
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyscf_tpu_torch', 'data', 'tdscf_water_refs.npz')


def scf(mf):
    mf.grids.level = 1
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    return mf


def main():
    out = {}
    mol = pt.M(atom=WATER, basis='def2-svp', verbose=0)
    mf = scf(mol.RKS(xc='b3lypg').density_fit())
    out.update(rks_mo_coeff=mf.mo_coeff, rks_mo_energy=mf.mo_energy,
               rks_mo_occ=mf.mo_occ, rks_e_tot=mf.e_tot)
    for tag, singlet in (('s', True), ('t', False)):
        a, b = tdrhf.get_ab(mf, singlet=singlet)
        out[f'rks_a_{tag}'] = np.asarray(a)
        out[f'rks_b_{tag}'] = np.asarray(b)
    nov = out['rks_a_s'].shape[0] * out['rks_a_s'].shape[1]
    z = np.random.default_rng(9).standard_normal((2, nov))
    out['rks_z'] = z
    for tag, singlet in (('s', True), ('t', False)):
        matvec, _ = tdrhf.gen_tda_operation(mf, singlet=singlet)
        out[f'rks_az_{tag}'] = np.stack([np.asarray(matvec(v)) for v in z])
    td = tdrhf.TDA(mf)
    out['rks_tda_s'] = td.kernel(nstates=5)
    out['rks_tda_s_f'] = td.oscillator_strength()
    td = tdrhf.TDA(mf)
    td.singlet = False
    out['rks_tda_t'] = td.kernel(nstates=5)
    out['rks_tdhf_s'] = tdrhf.TDHF(mf).kernel(nstates=5)

    mol = pt.M(atom=WATER, basis='def2-svp', charge=1, spin=1, verbose=0)
    mf = scf(mol.UKS(xc='b3lypg').density_fit())
    out.update(uks_mo_coeff=mf.mo_coeff, uks_mo_energy=mf.mo_energy,
               uks_mo_occ=mf.mo_occ, uks_e_tot=mf.e_tot)
    out['uks_a'] = np.asarray(tduhf.get_ab_uhf(mf)[0])
    out['uks_tda'] = tduhf.TDAUKS(mf).kernel(nstates=5)
    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in out.items()})
    print({k: np.asarray(v).shape for k, v in out.items()})


if __name__ == '__main__':
    main()
