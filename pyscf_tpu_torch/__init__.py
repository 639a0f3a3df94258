"""pyscf_tpu_torch: the PyTorch/CUDA port of pyscf_tpu for one NVIDIA H100.

Mirrors pyscf_tpu's module paths. The integral, grid and XC kernels are
hand-written CUDA (csrc/), each with a plain PyTorch twin that runs on
the CPU. A Mole runs on the card unless it is given device='cpu':

    import pyscf_tpu_torch as pt
    mol = pt.M(atom='O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587',
               basis='def2-svp')
    e = pt.dft.RKS(mol, xc='b3lypg').density_fit().kernel()
    e = pt.M(atom=..., basis='def2-svp', spin=1).UKS(xc='b3lypg') \
        .density_fit().kernel()            # open shell
    e = mol.RHF().kernel()                 # in-core ERIs, no density fitting
    de = mol.RHF().run().nuc_grad_method().kernel()   # (natm, 3) Ha/Bohr
    mol.RHF().run().analyze()              # Mulliken charges, dipole
    mf = mol.RHF().run()                   # or .density_fit().run()
    e_mp2, t2 = mf.MP2().kernel()
    mycc = mf.CCSD()
    e_ccsd, t1, t2 = mycc.kernel()
    e_t = mycc.ccsd_t()                    # CCSD(T)
    mf = pt.dft.RKS(mol, xc='b3lypg').density_fit().run()
    td = mf.TDA()                          # or mf.TDDFT(); mol.RHF().TDHF()
    e_exc = td.kernel(nstates=5)           # Hartree
    f = td.oscillator_strength()
    e_u = pt.tdscf.TDAUKS(mol.UKS(xc='b3lypg').run()).kernel()
    mf = mol.RHF().density_fit().run()
    h = mf.Hessian().kernel()              # (natm, 3, natm, 3) Ha/Bohr^2
    freq = pt.hessian.harmonic_analysis(mol, h)['freq_wavenumber']

    def mf_factory(m):                     # forces of any DF mean field
        mf = m.UKS(xc='b3lypg').density_fit()
        mf.kernel()
        return mf
    mol_opt, energies = pt.geomopt.internal.optimize(mf_factory, mol)
"""
from .gto.mole import M, Mole  # noqa: F401
from . import (ao2mo, cc, dft, geomopt, grad, hessian, mp, scf,  # noqa: F401
               tdscf)
