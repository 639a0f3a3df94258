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

The density-fitted gradients (grad/autodiff.py, jax.grad of a rebuilt
energy) are the same run with `mol.RHF().density_fit()`, with
`mol.RKS(xc='b3lypg').density_fit()` and `mf.grids.level = 1`, and, for
the water cation (charge=1, spin=1), with `mol.UHF().density_fit()` and
`mol.UKS(xc='b3lypg').density_fit()` (grids level 1); each took 50-70 s
of SCF and 140-220 s of gradient on the CPU, and water/sto-3g DF-RHF
(basis='sto-3g') 28 s and 67 s, too long for the fast tests. The water
analysis is the in-core RHF/def2-SVP run with conv_tol 1e-11 and
conv_tol_grad 1e-9, then `mf.dip_moment()` and `mf.mulliken_pop()[1]`
(60 s on the CPU); the water optimisation is tests/test_grad.py's
test_internal_coordinate_optimizer run as it stands (50 s). The
DF derivative integrals alone are checked on seeded inputs
(tests/test_torch_grad_df.py): with mol = water in basis b and auxmol =
make_auxmol(mol), pairs, auxes = autodiff._build_host_data_cached(mol,
auxmol) and

  rng = np.random.default_rng(11); C = rng.standard_normal((nao, 3)) * 0.3
  D = 2 C C^T; a = rng.standard_normal(naux)
  b = rng.standard_normal((naux, 3, 3)); b = b + b^T
  W = rng.standard_normal((naux, naux)); W = W + W^T

DF_DERIV_FUNCTIONALS[b] holds jax.jit(jax.grad(f))(X) at X = mol.coords
for f(X) = gamma . a + sum(O * b) of autodiff._df_intermediates(pairs,
auxes, naux, X, [D blocks], [[C blocks]]) ('3c') and for f(X) =
sum(autodiff._j2c(auxes, naux, X) * W) ('2c'), 23-54 s each on the CPU.
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

# density-fitted gradients, conv_tol 1e-13, conv_tol_grad 1e-9, minao guess
# water/sto-3g DF-RHF (def2-universal-jkfit)
E_WATER_DF_RHF_STO3G = -74.9631499176466
GRAD_WATER_DF_RHF_STO3G = [
    [3.55419716686979e-14, -3.764766276503906e-12, 0.061032391820871085],
    [2.3863443043022873e-12, 0.02360133517462487, -0.030516195909422894],
    [-2.4218862759709644e-12, -0.02360133517086005, -0.030516195911451938]]
# water/def2-SVP DF-RHF
E_WATER_DF_RHF_DEF2SVP = -75.96091927371799
GRAD_WATER_DF_RHF_DEF2SVP = [
    [-4.294827265160788e-15, -2.1094237467877974e-15, -0.018384450756409522],
    [4.186820528681439e-15, -0.011107859399779842, 0.009192225378205684],
    [1.0800673647930924e-16, 0.011107859399783183, 0.009192225378205198]]
# water/def2-SVP DF-RKS b3lypg, grids level 1 (held fixed: no grid response;
# the SCF gave E_WATER_DF_RKS_B3LYPG_L1 + 2.7e-13)
GRAD_WATER_DF_RKS_B3LYPG_L1 = [
    [-1.8636474711654925e-14, 1.2791226411401624e-12, 0.012266193146710742],
    [3.1071590564701237e-14, 0.00560723939805801, -0.006209432425517865],
    [-1.4826376684021847e-14, -0.005607239399337445, -0.006209432427037583]]
# water cation/def2-SVP DF-UHF (charge 1, spin 1)
E_WATER_CATION_DF_UHF_DEF2SVP = -75.56222814171319
GRAD_WATER_CATION_DF_UHF_DEF2SVP = [
    [1.7117420734445356e-10, 2.9264785039728736e-15, 0.019955197591733004],
    [-7.595505111330884e-11, 0.030479261773378005, -0.009977598795812228],
    [-9.521915623114288e-11, -0.030479261773380395, -0.00997759879592482]]
# water cation/def2-SVP DF-UKS b3lypg (charge 1, spin 1), grids level 1
# (held fixed); the SCF gave E_WATER_CATION_DF_UKS_B3LYPG_L1 - 1.5e-13
GRAD_WATER_CATION_DF_UKS_B3LYPG_L1 = [
    [-6.266935149157756e-11, 5.4251776682168185e-12, 0.049762306582345525],
    [3.643121253767748e-11, 0.04595624625613754, -0.0249550592626861],
    [2.6255976985383644e-11, -0.04595624626156123, -0.02495505927044731]]
# the analysis of in-core RHF/def2-SVP water (minao, conv_tol 1e-11,
# conv_tol_grad 1e-9): mf.dip_moment() in Debye and mf.mulliken_pop()[1]
DIP_WATER_RHF_DEF2SVP = [-9.545711891008863e-12, -4.5912401786762926e-12,
                         2.134576133675371]
CHG_WATER_RHF_DEF2SVP = [-0.3474845103958631, 0.17374225519873834,
                         0.17374225519712355]
# geomopt.internal.optimize of tests/test_grad.py's water (RHF/sto-3g, hcore
# guess, conv_tol 1e-11, from 'O 0 0 0; H 0 -0.9 0.4; H 0 0.9 0.4'): the
# energy of every step
E_WATER_OPT_RHF_STO3G = [-74.92789381482277, -74.95671203427062,
                         -74.96568740945375, -74.9658982450076,
                         -74.9659011908348]
# the DF derivative integrals on seeded inputs (see the docstring)
DF_DERIV_FUNCTIONALS = {
    'sto-3g': {
        '3c': [[-1.1199517605018836, 15.791546214573735, 11.364175476465403],
               [-2.3740211893225247, -3.9655174588429625, -3.713335777508342],
               [3.4939729498244074, -11.826028755730771, -7.650839698957061]],
        '2c': [[47.62180343215476, -48.96444577655239, 84.16412191142571],
               [-12.326807668214919, 89.3905905402087, -89.64227038944125],
               [-35.29499576393984, -40.426144763656296, 5.47814847801547]]},
    'def2-svp': {
        '3c': [[-20.655948557571136, -1.7528229286629102, -2.83487781789108],
               [16.261537853811095, -7.412854546467009, -1.3153449383201732],
               [4.39441070376002, 9.165677475129929, 4.150222756211255]],
        '2c': [[-89.9162990465078, -32.3459125228605, -100.1761777167811],
               [122.45305670573372, 13.864459001249074, 41.804487676729245],
               [-32.53675765922591, 18.481453521611428, 58.371690040051895]]},
}
