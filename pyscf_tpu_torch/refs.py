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

The range-separated references are the water runs above (def2-svp,
mf.grids.level = 1, conv_tol 1e-10, minao guess) with xc='camb3lyp'
(DF-RKS, 75 s on the CPU) and xc='wb97x-v' (DF-RKS, and DF-UKS of the
cation, charge=1, spin=1, 130-150 s each, most of it VV10's
jax.value_and_grad). The JAX package's own DF-wB97X-V run gives NaN: its
Cholesky factor of the erf(omega r)/r metric at omega 0.3 fails (the
metric is singular to rounding; jnp.linalg.cholesky returns NaN rather
than raising), and the SCF stops unconverged. The wB97X-V references were
therefore recorded with pyscf_tpu.ops.integrals.j3c._j2c_whitener wrapped,
in the recording process only, so that where its whitener is NaN it is
replaced by U diag(lam^-1/2) over the metric's eigenvalues lam > 1e-9 with
zero columns for the rest (92 of 113 kept), the port's rule
(ops/integrals/j3c.py whitener, PySCF's decompose_j2c). At camb3lyp's
omega 0.33 the JAX Cholesky happens to succeed, and its energy is recorded
as it is. The in-core wB97X-V references drop .density_fit(): the JAX
SCF then takes its long-range K from the legacy engine's int2e(mol,
omega=0.3) and needs no whitener (145-166 s each).

The post-HF references are, with mf the converged SCF,

  mf.conv_tol = 1e-12; mf.conv_tol_grad = 1e-9; mf.kernel()
  emp2 = pt.mp.MP2(mf).kernel()[0]
  cc = pt.cc.CCSD(mf); cc.conv_tol = 1e-10; cc.conv_tol_normt = 1e-8
  ecc = cc.kernel()[0]; et = cc.ccsd_t()

for benzene/def2-SVP in-core RHF (minao guess, PYSCF_TPU_INT2E=v2: 270 s
of SCF, 130 s of CCSD and 294 s of (T) on the CPU) and DF-RHF (minao; 63
s, 364 s and 286 s), and water/cc-pVDZ DF-RHF (hcore guess); every SCF
and CCSD converged. The water cation's UMP2 is the in-core UHF/def2-SVP
(charge=1, spin=1, minao guess, the same SCF tolerances) with `m =
mf.MP2(); m.kernel()`, then m.e_corr_os and m.e_corr_ss.

The TDA/TDHF references of water are arrays (orbitals, A and B matrices,
matrix-free products, excitation energies), kept in the file
TDSCF_WATER_REFS, which tests/tdscf_refs_record.py writes from the JAX
package (its docstring holds the command and the settings: water/def2-SVP
DF-RKS b3lypg and the cation's DF-UKS b3lypg, grids level 1, conv_tol
1e-12, conv_tol_grad 1e-9).
"""
import math
import os

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
# hexafluorobenzene: the bench ring with each H replaced by an F 1.34
# Angstrom from its C along the C-H bond (45 occupied orbitals on 12 atoms)
C6F6 = '\n'.join(BENZENE.strip().splitlines()[:6]) + '''
F  0.000000  2.736792  0.000000
F  2.370131  1.368396  0.000000
F  2.370131 -1.368396  0.000000
F  0.000000 -2.736792  0.000000
F -2.370131 -1.368396  0.000000
F -2.370131  1.368396  0.000000
'''
WATER = 'O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587'


def _h2o10():
    """BASELINE.md config 3, (H2O)10, built as examples/scaling_h2o10.py:16-28
    builds it: two stacked pentagonal rings of waters, O-O ~2.8 Angstrom;
    [(symbol, (x, y, z))] in Angstrom."""
    atoms = []
    for ring, z in ((0, 0.0), (1, 2.8)):
        for k in range(5):
            th = 2 * math.pi * k / 5 + (math.pi / 5 if ring else 0)
            x, y = 2.4 * math.cos(th), 2.4 * math.sin(th)
            atoms += [('O', (x, y, z)), ('H', (x + 0.7571, y, z + 0.5861)),
                      ('H', (x - 0.7571, y, z + 0.5861))]
    return atoms


H2O10 = _h2o10()
# config 4's N2 (examples/scaling_n2_qz.py:22)
N2 = 'N 0 0 0; N 0 0 1.0977'
# ammonia pyramidal, N 0.15 Angstrom above the plane of its three H (1.01
# Angstrom from the axis): the start of the inversion saddle search, inside
# the umbrella mode's region of negative curvature at B3LYP/def2-SVP (from
# 0.2 Angstrom the P-RFO of geomopt.optimize_ts, which follows the lowest
# Cartesian mode, falls to the pyramidal minimum)
NH3_PYRAMID = ('N 0 0 0.15; H 1.01 0 0; H -0.505 0.874686 0; '
               'H -0.505 -0.874686 0')
# np.load-able arrays of the JAX package's values that the CPU tests read
# (tests/port_refs_record.py and tests/hessian_refs_record.py say how each
# was made)
PORT_REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                         'port_refs.npz')
HESSIAN_REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'data', 'hessian_water_refs.npz')
# np.load-able arrays of the JAX package's water TDA/TDHF (see the docstring)
TDSCF_WATER_REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'data', 'tdscf_water_refs.npz')

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
# range-separated functionals, def2-SVP, minao guess, conv_tol 1e-10, grids
# level 1 (see the docstring): DF-RKS camb3lyp (the JAX Cholesky whitener)
E_WATER_DF_RKS_CAMB3LYP_L1 = -76.32974901114858
# DF-RKS wb97x-v and the water cation's DF-UKS wb97x-v (the eigendecomposed
# long-range whitener); <S^2> 0.7518602285814122
E_WATER_DF_RKS_WB97XV_L1 = -76.19198407077467
E_WATER_CATION_DF_UKS_WB97XV_L1 = -75.73078113391307
# in-core RKS wb97x-v and UKS wb97x-v of the cation (no whitener);
# <S^2> 0.7518603219223583
E_WATER_RKS_WB97XV_L1 = -76.19197147587373
E_WATER_CATION_UKS_WB97XV_L1 = -75.73076006583429
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
# f shells (tests/port_refs_record.py fg_water_refs; minao, conv_tol 1e-10,
# every SCF converged): water/cc-pVTZ DF-RHF (cc-pvtz-jkfit, to g; 89 s of
# JAX on the CPU), DF-RKS b3lypg (grids level 1; 11 s) and water/def2-TZVP
# DF-RKS b3lypg (def2-universal-jkfit, grids level 1; 101 s)
E_WATER_DF_RHF_CCPVTZ = -76.05710789750125
E_WATER_DF_RKS_B3LYPG_CCPVTZ_L1 = -76.45984141526318
E_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1 = -76.46295262803359
# their DF gradients (tests/port_refs_record.py fg_grad_tz_refs and
# fg_grad_tzvp_refs: minao, conv_tol 1e-12, conv_tol_grad 1e-9, converged;
# build_grad_fn's jax.grad term by term, each pair class's in a process of
# its own, as the one traced program uses up a process's memory maps at f:
# water/def2-SVP's that way is 1.3e-11 from GRAD_WATER_DF_RHF_DEF2SVP);
# water/cc-pVTZ DF-RHF (206 s on the CPU; the SCF gave
# -76.05710789750121) and water/def2-TZVP DF-RKS b3lypg (grids level 1,
# held fixed; 209 s; the SCF gave -76.46295262803366)
GRAD_WATER_DF_RHF_CCPVTZ = [
    [-1.3492705849835816e-12, -1.8019281871444423e-13, -0.025122180692019214],
    [-1.5124125884637554e-12, -0.013582322762787591, 0.012561090346169479],
    [2.8616831734473547e-12, 0.013582322762967003, 0.012561090345851733]]
GRAD_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1 = [
    [-8.86517163894818e-15, 3.044261327831814e-13, 0.003863430105823795],
    [8.626487959723824e-15, 0.005122051000987504, -0.0019850462111417055],
    [3.0595842402693557e-16, -0.0051220510012925935, -0.001985046211397723]]
# g shells (tests/port_refs_record.py fg_neon_refs, 11 min on the CPU, most
# of it compiling j2e.py's 225 class-pair programs): Ne/cc-pVQZ in-core RHF
# (minao, conv_tol 1e-12, conv_tol_grad 1e-9; converged, 71 s), MP2, CCSD
# (conv_tol 1e-10, conv_tol_normt 1e-8; converged) and (T), all electrons
E_NE_RHF_CCPVQZ = -128.54346965912123
E_NE_MP2_CCPVQZ = -0.32625844379442426
E_NE_CCSD_CCPVQZ = -0.32758571691000243
E_NE_CCSD_T_CCPVQZ = -0.005706135787231147
# post-HF correlation energies (all electrons correlated; SCF conv_tol
# 1e-12, conv_tol_grad 1e-9; CCSD conv_tol 1e-10, conv_tol_normt 1e-8;
# see the docstring). Benzene/def2-SVP in-core RHF (PYSCF_TPU_INT2E=v2,
# minao; the SCF gave -230.53554833402782): MP2, CCSD and (T)
E_BENZENE_MP2_DEF2SVP = -0.7982300899085772
E_BENZENE_CCSD_DEF2SVP = -0.8373498941817031
E_BENZENE_CCSD_T_DEF2SVP = -0.03640730660716575
# the same on benzene DF-RHF (def2-universal-jkfit, minao; the SCF gave
# -230.53543239740063)
E_BENZENE_DF_MP2_DEF2SVP = -0.798020447612889
E_BENZENE_DF_CCSD_DEF2SVP = -0.8375061946572273
E_BENZENE_DF_CCSD_T_DEF2SVP = -0.03645013330527562
# Water/cc-pVDZ DF-RHF (cc-pvdz-jkfit, hcore guess;
# the SCF gave -76.02674473735746): MP2, CCSD and (T)
E_WATER_DF_MP2_CCPVDZ = -0.20397709445803405
E_WATER_DF_CCSD_CCPVDZ = -0.21341299039849787
E_WATER_DF_CCSD_T_CCPVDZ = -0.0030626888274802866
# the water cation/def2-SVP (charge 1, spin 1) in-core UHF (minao; the SCF
# gave -75.56227212291358): UMP2, and its opposite- and same-spin parts
E_WATER_CATION_UMP2_DEF2SVP = -0.152702219444926
E_WATER_CATION_UMP2_OS_SS_DEF2SVP = (-0.11708544321840653,
                                     -0.03561677622651948)
