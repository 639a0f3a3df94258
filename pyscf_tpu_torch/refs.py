"""Reference energies and gradients recorded once from the JAX package on
the CPU.

The card's machine has no JAX, so the references reach it as constants.
Each was produced from the repository root by (BENZENE as in bench.py):

  JAX_PLATFORMS=cpu PYSCF_TPU_JIT_CACHE=0 python -c "import dev_env, \\
    pyscf_tpu as pt; from bench import BENZENE; \\
    mol = pt.M(atom=BENZENE, basis='def2-svp', verbose=0); \\
    mf = mol.RHF().density_fit(); mf.conv_tol = 1e-8; \\
    mf.init_guess = 'minao'; print(repr(mf.kernel()), mf.converged)"

and the same with atom=WATER, basis='cc-pvdz', conv_tol=1e-10. The DF-RKS
references replace `mol.RHF()` by `mol.RKS(xc='b3lypg')`, with the default
grids (level 3) for benzene and `mf.grids.level = 1` for water
(def2-svp, conv_tol 1e-10). The in-core RHF reference drops
`.density_fit()` and sets PYSCF_TPU_INT2E=v2, so that mol.intor('int2e')
is the screened engine ops/integrals/j2e.py (180 s on the CPU); the CPU's
default, the legacy host engine, took 47 minutes and gave
-230.5355483340263, 8.4e-13 from it. The DF-UKS references are

  mol = pt.M(atom=PHENYL, basis='def2-svp', spin=1, verbose=0)
  mf = mol.UKS(xc='b3lypg').density_fit(); mf.conv_tol = 1e-8
  mf.init_guess = 'minao'; print(repr(mf.kernel()), mf.converged,
  mf.spin_square())

and the same with atom=WATER, charge=1, spin=1, mf.grids.level = 1,
conv_tol 1e-10. Every run converged. tests/test_torch_scf.py,
tests/test_torch_dft.py and tests/test_torch_uks.py check the water
values against live JAX runs. The conventional RHF gradient is

  mol = pt.M(atom=WATER, basis='def2-svp', verbose=0)
  mf = mol.RHF(); mf.conv_tol = 1e-13; mf.conv_tol_grad = 1e-9
  mf.init_guess = 'minao'; print(repr(mf.kernel()), mf.converged)
  print(np.asarray(mf.nuc_grad_method().kernel()).tolist())

(83 s on the CPU for the derivative integrals of grad/rhf.py, too long for
the fast tests; tests/test_torch_grad.py checks water/sto-3g against a
live JAX run; with conv_tol 1e-11 and the default conv_tol_grad the JAX
gradient moved by 5e-9, its SCF's residue). No JAX gradient of benzene is
recorded: its in-core ERIs alone took the host engine 47 minutes, and
int2e_ip1 is three of those.
"""

BENZENE = '''
C  0.000000  1.396792  0.000000
C  1.209657  0.698396  0.000000
C  1.209657 -0.698396  0.000000
C  0.000000 -1.396792  0.000000
C -1.209657 -0.698396  0.000000
C -1.209657  0.698396  0.000000
H  0.000000  2.484212  0.000000
H  2.151390  1.242106  0.000000
H  2.151390 -1.242106  0.000000
H  0.000000 -2.484212  0.000000
H -2.151390 -1.242106  0.000000
H -2.151390  1.242106  0.000000
'''
# the bench geometry without the hydrogen at (0, 2.484212, 0): the phenyl
# radical C6H5, a sigma radical (charge 0, spin 1: na 21, nb 20)
PHENYL = '\n'.join(line for line in BENZENE.splitlines()
                   if line.split()[1:3] != ['0.000000', '2.484212'])
WATER = 'O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587'

# DF-RHF, def2-universal-jkfit, minao guess, conv_tol 1e-8
E_BENZENE_DF_RHF_DEF2SVP = -230.5354323974008
# in-core RHF (no density fitting), minao guess, conv_tol 1e-8
E_BENZENE_RHF_DEF2SVP = -230.53554833402714
# DF-RHF, cc-pvdz-jkfit, minao guess, conv_tol 1e-10
E_WATER_DF_RHF_CCPVDZ = -76.02674473735726
# DF-RKS b3lypg/def2-SVP, def2-universal-jkfit, minao guess, conv_tol 1e-8,
# default grids (level 3, 143,556 points)
E_BENZENE_DF_RKS_B3LYPG_DEF2SVP = -232.08462612041947
# DF-RKS b3lypg/def2-SVP, minao guess, conv_tol 1e-10, grids level 1
E_WATER_DF_RKS_B3LYPG_L1 = -76.35813097538731
# DF-UKS b3lypg/def2-SVP of PHENYL (spin=1), def2-universal-jkfit, minao
# guess, conv_tol 1e-8, default grids (level 3); <S^2> 0.7583947676912928
E_PHENYL_DF_UKS_B3LYPG_DEF2SVP = -231.39400216004216
# DF-UKS b3lypg/def2-SVP of the water cation (charge=1, spin=1), minao
# guess, conv_tol 1e-10, grids level 1; <S^2> 0.752270419625451
E_WATER_CATION_DF_UKS_B3LYPG_L1 = -75.9018940566669
# in-core RHF/def2-SVP, minao guess, conv_tol 1e-13, conv_tol_grad 1e-9, and
# its analytic gradient (Ha/Bohr)
E_WATER_RHF_DEF2SVP = -75.96097516698609
GRAD_WATER_RHF_DEF2SVP = [
    [1.2179834743296348e-12, -4.2878457396487306e-14, -0.018369727076083198],
    [-4.56997935964616e-12, -0.011110437548206509, 0.009184863538075128],
    [3.351995885316638e-12, 0.011110437548247365, 0.009184863538013621]]
