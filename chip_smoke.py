#!/usr/bin/env python3
"""Smoke run of pyscf_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's paths for benzene/def2-SVP, the phenyl radical and
water, then BASELINE configs 3 ((H2O)10/cc-pVTZ) and 4 (N2/cc-pVQZ), the
forces and frequencies of the f and g shells, the DF-RKS Hessian and the
transition-state search, the DF-UHF/UKS Hessian with PBE and PBE0 in
every XC kernel, the Γ-point periodic SCF (BASELINE config 5 and a
64-atom diamond cell) and the k-point periodic SCF (KRHF, KRKS, KUHF and
KUKS over FFTDF, diamond on up to 64 k-points), on the card, in order:
  1. refuses to run without CUDA; prints the card's name and power limit;
  2. builds the seventy-two kernel libraries of the thirty-nine kernels
     from the thirty sources of pyscf_tpu_torch/csrc (nvcc, sm_90a,
     one process per library, all at once), and prints the compile seconds
     and ptxas register lines of eval_ao and of every XC library;
  3. integral kernel phases at the main path's shapes: each kernel against
     its plain PyTorch twin on the same card inputs (S/T/V <= 1e-12; raw 3c
     rows and (P|Q) <= 1e-12 x max|value|; the whitened factor B <= 1e-10);
  4. DF-RHF through the public entry points,
     M(...).RHF().density_fit().kernel() with the minao guess and conv_tol
     1e-8: the recorded JAX energy within 1e-8 Ha, every integral kernel
     launched in that run;
  5. grid, AO and XC kernel phases at the main path's shapes (benzene,
     default grids): becke <= 1e-12 x max w; eval_ao <= 1e-13 on all four
     components; xc_rks at the converged DF-RHF density, vtmp <= 1e-11 x
     max|vtmp| and n, exc <= 1e-11 relative;
  6. the main path, DF-RKS b3lypg through the public entry points,
     dft.RKS(M(...), xc='b3lypg').density_fit().kernel() with the minao
     guess and conv_tol 1e-8 on the default device: converged, the recorded
     JAX energy within 1e-8 Ha, and its six kernels launched in that run;
  7. the int2e phase: every ordered pair of benzene's screened shell-pair
     classes through the `int2e` kernel and its plain twin, <= 1e-12 x
     max|value|;
  8. in-core RHF, M(...).RHF().kernel() without density fitting (minao,
     conv_tol 1e-8): converged, the recorded JAX energy within 1e-8 Ha,
     int2e and int1e_stv launched in that run;
  9. DF-UKS b3lypg of the phenyl radical, M(..., spin=1).UKS(xc='b3lypg')
     .density_fit().kernel() (minao, conv_tol 1e-8): converged, the
     recorded JAX energy within 1e-8 Ha, <S^2> printed, its six kernels
     launched in that run;
 10. the xc_uks phase at the converged phenyl spin density: vtmp <= 1e-11
     x max|vtmp|, n_a, n_b and exc <= 1e-11 relative;
 11. the derivative-integral phases at benzene's shapes: int1e_ip,
     int1e_iprinv (all twelve atoms as centres) and int2e_ip1 over every
     ordered bra class, each against its plain twin, <= 1e-12 x max|value|;
 12. the conventional RHF gradient, M(...).RHF() converged (minao,
     conv_tol 1e-11, the recorded JAX energy within 1e-8 Ha), then
     nuc_grad_method().kernel(): |sum_A de[A]| < 1e-9, the geometry's
     three mirror planes (its six-decimal coordinates are exactly D2h)
     within 1e-8 and the six C and the six H gradient norms within 1e-6
     (they are D6h to 3e-7 Angstrom only) and, on the ring symmetrised to
     D6h in float64, within 1e-8; central differences of the
     port's own energy on one C and one H coordinate within 1e-6, the
     three derivative kernels launched in that run; warm gradient times,
     their phases and the peak device memory printed; and the water/
     def2-SVP gradient through the same entry point within 1e-8 of the
     recorded JAX gradient;
 13. the main path with its forces, benzene DF-RKS b3lypg/def2-SVP from
     M() through kernel() (conv_tol 1e-10, conv_tol_grad 1e-7) and
     nuc_grad_method().kernel(): the recorded JAX energy within 1e-8 Ha,
     the gradient's energy check within 1e-6, |de_z| < 1e-8 and the three
     mirror planes within 1e-8 (the grid is held fixed, as in the JAX
     package, so the sum rule is the missing grid response: printed),
     central differences with the grid held fixed within 1e-6 on one C and
     one H coordinate (with the grid moving: printed), its kernels
     launched in that run; warm gradient times and phases, peak memory;
 14. the DF gradient's kernel phases at benzene's shapes: int3c2e_ip on
     the DF-RKS Gamma, int2c2e_ip1 on its W (<= 1e-10 x max), eval_ao
     deriv 2 on its grid (<= 1e-12 x max) and xc_rks_grad at its density
     (<= 1e-10 x max, exc <= 1e-11 relative), each against its twin;
 15. benzene DF-RHF/def2-SVP + gradient: sum rule < 1e-9, mirror planes
     1e-8, central differences within 1e-6; then water/def2-SVP DF-RHF,
     DF-RKS b3lypg (grids level 1) and the water cation's DF-UHF within
     1e-8 of the recorded JAX gradients;
 16. the xc_uks_grad phase at the converged phenyl spin density of 9 on
     its whole grid, block by block: g <= 1e-10 x max|g|, exc <= 1e-11
     relative;
 17. the phenyl radical's DF-UKS b3lypg/def2-SVP gradient, M(...,
     spin=1).UKS(xc='b3lypg').density_fit() (conv_tol 1e-10,
     conv_tol_grad 1e-7) and nuc_grad_method().kernel(): the recorded JAX
     energy within 1e-8 Ha, the energy check within 1e-6, |de_z| < 1e-8,
     the x -> -x mirror within 1e-8, central differences with the grid
     held fixed within 1e-6 on the radical carbon's and the para
     hydrogen's radial coordinates (the moving grid's and the sum rule
     printed), its kernels launched in that run; warm gradient times and
     phases, peak memory;
 18. the water cation's DF-UKS b3lypg gradient (grids level 1) within 1e-8
     of the recorded JAX gradient;
 19. the int1e_r phase: every ordered class pair of benzene/def2-SVP
     against its twin, <= 1e-12 x max|value|;
 20. water in-core RHF/def2-SVP (minao, conv_tol 1e-11, conv_tol_grad
     1e-9), dip_moment() within 1e-8 Debye and mulliken_pop() charges
     within 1e-8 of the recorded JAX values, int1e_r launched;
 21. the optimisation path: geomopt.internal.optimize of the phenyl
     radical from the benzene geometry less one H, DF-UKS b3lypg/def2-SVP
     forces at conv_tol 1e-10 and conv_tol_grad 1e-7 (the process's first
     torch.func.jacrev timed apart before it; energy, max|g| and seconds
     of every step printed): max|g| < 3e-4 within 30 steps, the last
     energy below the first, the x-mirror within 1e-6 Bohr and |z| <
     1e-8 Bohr; then analyze(): charges summing to 0 and spin populations
     to 1 within 1e-8, the dipole printed; int1e_r and xc_uks_grad
     launched on that path;
 22. the erf(omega r)/r integral phases at benzene's shapes (omega 0.3):
     int3c2e_lr and int2c2e_lr against their twins, <= 1e-12 x max|value|;
     the long-range metric's eigenvalues and Cholesky status printed; the
     long-range factor B_LR from kernel and plain rows with the same
     (eigendecomposed) whitener, <= 1e-10 x max|B_LR|;
 23. benzene DF-RKS wB97X-V/def2-SVP through the public entry points,
     dft.RKS(M(...), xc='wb97x-v').density_fit().kernel() (minao, conv_tol
     1e-8): converged, the energy, the long-range factor's phases and the
     vv10 launches' seconds and share of scf_loop printed, int3c2e_lr,
     int2c2e_lr, xc_rks and vv10 launched in that run (no JAX reference
     exists at this width: the kernels are held by their twins);
 24. the vv10 phase at its converged density on the whole grid: E <= 1e-11
     relative, dE/drho and dE/dg2 <= 1e-11 x max; xc_rks with the WB97
     component at the same density, as in 5;
 25. the phenyl radical's DF-UKS wB97X-V (minao, conv_tol 1e-8): converged,
     energy and <S^2> printed, xc_uks and vv10 launched; xc_uks with the
     WB97 component at its spin density, as in 10;
 26. int2e_lr over every ordered pair of benzene's classes against its
     twin, <= 1e-12 x max|value|;
 27. water DF-RKS CAM-B3LYP and wB97X-V, the water cation's DF-UKS
     wB97X-V and water's in-core RKS wB97X-V (def2-SVP, level-1 grids,
     conv_tol 1e-10) within 1e-8 of the recorded JAX energies, the
     long-range kernels and vv10 launched;
 28. the post-HF path, in-core: benzene/def2-SVP M(...).RHF().run() (minao,
     conv_tol 1e-12, conv_tol_grad 1e-9, the references' settings), then
     mf.MP2().kernel(), mf.CCSD() (conv_tol 1e-10, conv_tol_normt 1e-8)
     .kernel() and ccsd_t(), all electrons: SCF and CCSD converged, E_MP2,
     E_CCSD and E_(T) within 1e-8 Ha of the recorded JAX values,
     mp2_energy and ccsd_t launched in that run; the ao2mo, MP2, per-cycle
     CCSD and (T) seconds (host clock after a synchronize; MP2 and (T)
     again warm), the cycle count and the peak device memory printed;
 29. the ccsd_t phase at that CCSD's tensors: the kernel against its
     batched twin (run once) over all 138,415 triples within 1e-10
     relative, its vvov slices staged in f tiles of 32 against the untiled
     run within 1e-12, and on seeded tensors whose triples hold all three
     multiplicities, untiled and in f tiles of 4, within 1e-12;
 30. the mp2_energy phase at benzene's (ia|jb): t2 within 1e-13 of its
     largest, both sums within 1e-12 relative of the twin's;
 31. the same post-HF path on benzene DF-RHF (def2-universal-jkfit): the
     recorded JAX energies within 1e-8 Ha, both kernels launched, times
     printed ((T) by the kernel only);
 32. UMP2 of the water cation (in-core UHF/def2-SVP) within 1e-8 Ha of the
     recorded JAX energy and its os/ss split, mp2_energy launched once per
     spin block; the phenyl radical's UMP2 and its time printed (its UHF
     does not converge from minao, in the JAX package either: printed,
     not checked);
 33. the excited-state path: benzene DF-RKS b3lypg/def2-SVP from M()
     (minao, conv_tol 1e-10, conv_tol_grad 1e-7), mf.TDA() singlets and
     triplets (four each, Davidson: nov 1953 is above dense_cutoff;
     kernels xc_rks_fxc and xc_uks_fxc) and mf.TDDFT() singlets (five,
     dense: xc_fxc and xc_fxc_pairs), all four kernels launched in that
     run; their energies, oscillator strengths, seconds, the Davidson's
     iterations and matvecs, the wall from M() and the peak memory
     printed; then the dense TDA of both spin kinds: each Davidson state
     within 1e-7 Ha of its dense eigenvalue (the lower dense states that
     its seeds' symmetries do not reach printed), the singlets'
     oscillator strengths summed over degenerate sets within 1e-3 of the
     largest (no JAX reference could be recorded at this width);
 34. the response kernels at its density on the whole grid against their
     plain twins on the card: xc_fxc <= 1e-10 x max|H|, xc_fxc_pairs on a
     chunk of get_ab's size <= 1e-10 x max, xc_rks_fxc and xc_uks_fxc
     along five seeded transition densities <= 1e-10 x max; the A_xc
     GEMM of one chunk timed;
 35. the phenyl radical's DF-UKS b3lypg (conv_tol 1e-10, conv_tol_grad
     1e-7) and tdscf.TDAUKS(mf).kernel(nstates=5): time, peak memory,
     xc_fxc, xc_fxc_pairs and int2e launched; the same A built with the
     plain twins on the card: its five lowest eigenvalues within 1e-8 Ha;
 36. HF/6-31G in-core RHF on the card: TDA and TDHF singlets and triplets
     within 1e-4 eV of PySCF's goldens;
 37. the Hessian path: benzene DF-RHF/def2-SVP from M() (minao, conv_tol
     1e-12, conv_tol_grad 1e-8) and mf.Hessian().kernel(): the five
     Hessian kernels, int1e_ip and int1e_iprinv launched in that run;
     |sum_A H[A]| <= 1e-7, |H - H^T| <= 1e-9, twelve columns (every
     direction of two neighbouring C and their H) against central
     differences of the analytic gradient (step 1e-3 Bohr, SCFs at
     conv_tol 1e-12 and conv_tol_grad 1e-9) within 1e-5 Ha/Bohr^2; one
     warm time, the phases, the CPHF iterations, the peak memory, the
     harmonic frequencies and the thermochemistry printed;
 38. the Hessian kernels at benzene's shapes against their twins (<= 1e-10
     x max): int1e_ipip with the SCF's D and W, int3c2e_ip1 and
     int2c2e_ip1_full written out, int3c2e_ipip and int2c2e_ipip with the
     DF gradient's Gamma and W_PQ;
 39. BASELINE config 3 at full width, (H2O)10 DF-RHF/cc-pVTZ (cc-pvtz-
     jkfit; nao 580, naux 1390; f shells, aux to g) through
     scf.RHF(M(...)).density_fit().kernel() (minao, conv_tol 1e-8):
     converged, int1e_stv, int3c2e and int2c2e launched in that run, its
     wall, phases and peak memory, E beside the TPU-era energy (not gated:
     that SCF stalled); the eigh residual at n = 580 (torch.linalg.eigh and
     one and two refinement steps; the SCF's setting < 1e-12); the three
     kernels against their twins at its shapes (S/T/V and the minao cross
     overlap, every (ij|P) class and (P|Q), <= 1e-12 x max) and B under
     one whitener (<= 1e-10); the SCF at conv_tol 1e-10 on the kernels'
     integrals and on the twins' within 1e-8 Ha of each other (no JAX
     reference at this width: refs.py says why);
 40. water/cc-pVTZ DF-RHF and water/def2-TZVP DF-RKS b3lypg (grids level
     1, conv_tol 1e-10) within 1e-8 Ha of the recorded JAX energies;
 41. BASELINE config 4 at full width, N2/cc-pVQZ in-core (nao 110, g
     shells): int1e_stv and int2e against their twins over every class
     (<= 1e-12 x max, each (gg|..) bra class to its own size); RHF (minao,
     conv_tol 1e-12, conv_tol_grad 1e-9), MP2, CCSD (conv_tol 1e-10,
     conv_tol_normt 1e-8) and (T) on the twins' ERI tensor, then through the
     entry points M(...).RHF().run(), MP2(), CCSD(), ccsd_t(): converged,
     E_HF, E_MP2, E_CCSD and E_(T) within 1e-8 Ha of the twins', int2e,
     int1e_stv, mp2_energy and ccsd_t launched in that run, times and peak
     memory printed;
 42. Ne/cc-pVQZ in-core RHF, MP2, CCSD and (T) (the same settings) within
     1e-8 Ha of the recorded JAX energies;
 43. the f and g phase: every class of the nine derivative and Hessian
     kernels but int2e_ip1 (which stops at d) at water/cc-pVQZ's shapes
     (every ordered class to (g, g), cc-pvqz-jkfit to h), on seeded
     densities and weights, against their twins within 1e-12 of the
     twin's largest element (rows <kernel>_qz); the card's free memory
     after them (the local memory the largest stacks reserve);
 44. BASELINE config 3's forces at full width: (H2O)10 DF-RHF/cc-pVTZ
     from M() (conv_tol 1e-10, conv_tol_grad 1e-7) through
     nuc_grad_method().kernel(): the sum rule within 1e-9, central
     differences on one O and one H coordinate within 1e-6, the same
     gradient on the twins' derivative integrals within 1e-8; the wall
     from M(), the gradient's phases, its warm time and the peak memory;
     then its four kernels against their twins at its shapes (int1e_ip,
     int1e_iprinv 1e-12 x max; int3c2e_ip, int2c2e_ip1 on its Gamma and
     W_PQ 1e-10 x max; rows <kernel>_tz);
 45. water/cc-pVTZ DF-RHF and water/def2-TZVP DF-RKS b3lypg (grids level
     1) forces within 1e-8 of the recorded JAX gradients; water/cc-pVQZ
     DF-RHF forces (g, aux h) with the sum rule within 1e-9;
 46. the north-star level, benzene DF-RKS b3lypg/def2-TZVP forces as in
     13 (|de_z| and the mirror planes within 1e-8, central differences
     with the grid held fixed within 1e-6; no JAX reference at this
     width);
 47. the DF-RHF Hessian and harmonic frequencies of benzene/cc-pVTZ (nao
     264, naux 654) and water/cc-pVQZ from M() (conv_tol 1e-12,
     conv_tol_grad 1e-8), as in 37: the seven kernels launched, the sum
     rule within 1e-7, the symmetry within 1e-9, central differences of
     the analytic gradient within 1e-5 on four columns (one C x and z, one
     H x and y) and on all nine; the eight phases, the peak memory and the
     frequencies printed; after benzene/cc-pVTZ's, its five kernels
     against their twins at its shapes as in 38 (rows <kernel>_tz);
 48. int3c2e_ipip's (gg|h) class, R_tuv to order 15, on two g shells and
     an h aux shell whose primitive triples put the Boys argument on both
     sides of 18, against its twin within 1e-12 of the twin's largest
     element;
 49. the DF-RKS Hessian of the main path's mean field, benzene DF-RKS
     b3lypg/def2-SVP (nao 114, 143,556 grid points) from M() (minao,
     conv_tol 1e-12, conv_tol_grad 1e-8) through mf.Hessian().kernel():
     the RHF Hessian's seven kernels, eval_ao_deriv3, xc_rks_hess,
     xc_rks_deriv1, xc_fxc, xc_fxc_pairs and xc_rks_fxc launched in that
     run, |H - H^T| <= 1e-9
     (the sum rule printed: no grid response), six columns (every
     direction of one C and of one H) against the
     four-point central differences of the analytic gradient on the same
     fixed grid within 1e-5 Ha/Bohr^2; the phases (xc_rows, xc_F1 among
     them), a warm time, the CPHF iterations, the peak memory, the
     frequencies and the thermochemistry printed;
 50. the three new kernels at its shapes against their twins: eval_ao
     deriv 3 <= 1e-12 x max, xc_rks_hess and xc_rks_deriv1 <= 1e-10 x max;
 51. the same Hessian at the north-star level, benzene DF-RKS
     b3lypg/def2-TZVP (f on C): four columns ((0,0), (0,2), (6,0), (6,1))
     against the fixed-grid four-point central differences within 1e-5,
     the same prints, and a warm Hessian through each XC response of
     CPHF's CG steps (the dense A_xc of xc_fxc and xc_fxc_pairs, which
     hessian/rhf.py _dense_fxc selects here; the tangent by xc_rks_fxc),
     the two within 1e-8; then the three
     kernels against their twins at its shapes (rows <kernel>_tz);
 52. geomopt.optimize_ts of NH3's inversion, DF-RKS b3lypg/def2-SVP from a
     pyramid 0.15 Angstrom high: max|g| < 3e-4, N within 1e-3 Angstrom of
     the H3 plane, the DF-RKS Hessian's kernels launched, exactly one
     imaginary frequency at the saddle;
 53. the DF-UKS Hessian of the phenyl radical, DF-UKS b3lypg/def2-SVP
     (nao 109, 11 atoms, 33 tangents, its default grid) from M() (minao,
     conv_tol 1e-12, conv_tol_grad 1e-8) through mf.Hessian().kernel()
     (hessian/uhf.py): the RHF Hessian's seven kernels, eval_ao_deriv3,
     xc_uks_hess, xc_uks_deriv1 and xc_uks_fxc launched, |H - H^T| <=
     1e-9, the nine columns of the radical carbon, its ortho carbon and
     the ortho hydrogen against the fixed-grid four-point central
     differences within 1e-5 Ha/Bohr^2; the phases, a warm time, the CPHF
     iterations, the peak memory and the frequencies printed; then
     eval_ao deriv 3 (<= 1e-12 x max, row eval_ao_deriv3_phenyl),
     xc_uks_hess and xc_uks_deriv1 (<= 1e-10 x max) at its shapes against
     their twins;
 54. the same path with PBE0 (its forces too: energy check 1e-6, |de_z|
     and the x-mirror 1e-8; three columns of the radical carbon), and the
     open-shell XC kernels with PBE0 against their twins at its density:
     xc_uks, xc_uks_grad, xc_uks_fxc (five seeded transition densities),
     xc_uks_hess and xc_uks_deriv1 (rows <kernel>_pbe0);
 55. benzene DF-RKS PBE/def2-SVP from M(): energy, forces (energy check
     1e-6, |de_z| and the mirror planes 1e-8) and Hessian (symmetric to
     1e-9), and the closed-shell XC kernels with PBE against their twins
     at its density: xc_rks, xc_rks_grad, xc_fxc, xc_fxc_pairs,
     xc_rks_fxc, xc_rks_hess and xc_rks_deriv1 (rows <kernel>_pbe);
 56. tests/test_ts_opt.py's H + H2 exchange saddle by geomopt.optimize_ts
     on DF-UHF/sto-3g with that test's asserts (max|g| < 5e-4, equal H-H
     distances within 5e-3 Bohr between 1.5 and 2.1, one negative
     eigenvalue of the analytic Hessian), the DF-UHF Hessian's kernels
     launched;
 57. the DF-UHF Hessian of the methyl radical at triple zeta, CH3/
     def2-TZVP (f on C; 12 tangents), as step 37 for DF-RHF: sum rule
     1e-7, symmetry 1e-9, all 12 columns against two-point central
     differences of the gradient within 1e-5;
 58. the Γ-point periodic SCF, BASELINE config 5 as published
     (examples/scaling_diamond.py: the diamond primitive cell, gth-szv,
     gth-pade, mesh [15]^3, nao 8, 1,505 lattice images): from
     pbc.gto.M(), pbc.dft.RKS(cell, xc='pbe').density_fit() and the same
     without density_fit() (hcore guess, conv_tol 1e-9), converged, GDF -
     FFTDF within 1e-8, eval_ao_pbc, int1e_stv and xc_rks launched in each
     run; each route's energy functional at the JAX package's converged
     density within 1e-10 Ha of the JAX energy, and each SCF
     1e-8 to 1e-6 Ha below the JAX energy (the JAX package's V_xc holds
     half the GGA term, so its density is not stationary;
     pyscf_tpu_torch/data/pbc_refs.npz); walls, cycles, phases and peak
     memory printed;
 59. diamond Γ LDA at [17]^3 against the PySCF golden (1e-6) and the JAX
     energy (1e-8), and Γ RHF at [17]^3 (FFT K with the Madelung term)
     against the JAX energy (1e-8);
 60. the 64-atom diamond cell (2x2x2 conventional cells, a = 7.1336
     Angstrom, gth-szv: nao 256, its default mesh [79]^3 = 493,039 points,
     57 images), FFTDF PBE from pbc.gto.M() (hcore, conv_tol 1e-9):
     converged; the wall from M(), the cycles, the seconds of the AO
     values, of XC and of FFT-J (their per-call ms from CUDA events times
     the calls) and the peak memory printed; xc_rks against its twin at
     the converged density (row xc_rks_d64), and int1e_stv against its
     twin on every call of the cell's S/T lattice sums and S-only
     projector overlaps (row int1e_stv_pbc, 1e-12 x max); then the same
     SCF from a fresh cell with eval_ao_pbc, int1e_stv and xc_rks replaced
     by their plain twins on the card, none of the three launched: the
     two energies within 1e-8 Ha;
 61. eval_ao_pbc against its twin, deriv 0 and 1, at config 5's shape and
     the 64-atom cell's (<= 1e-12 x max; rows eval_ao_pbc and
     eval_ao_pbc_d64 at deriv 1, the operations bound counted from the
     points, atoms and images in range in this run);
 62. the k-point SCF's golden: diamond KRKS-LDA on the shifted 2x2x2
     Monkhorst-Pack mesh at [17]^3 within 2e-6 of PySCF's
     -11.353643583707452 (tests/test_pbc.py:109-118), and KRKS-PBE and
     KUKS-PBE on that closed-shell cell within 1e-9 Ha of each other;
     each k-point SCF from pbc.gto.M() with conv_tol 1e-10, its kernels
     launched, energy, cycles, wall, peak memory and with_df.timings
     printed;
 63. diamond gth-dzvp PBE on the Γ-centred 4x4x4 mesh (64 k-points, nao
     26, the default mesh [25]^3): converged; xc_rks at its stacked
     k-point rows (row xc_rks_k64, 1e-11), int1e_stv on every call of its
     phased S/T and projector overlaps (row int1e_stv_kpts, 1e-12 x max)
     and eval_ao_kpts at deriv 0 and 1 (row eval_ao_kpts, 1e-12 x max; its
     operations bound the in-range image work of this run at the FP64
     rate and its phase products, over the spherical functions, at the
     tensor cores') against their twins; then the same SCF with eval_ao_kpts,
     int1e_stv, xc_rks and xc_uks replaced by their twins, none launched,
     within 1e-9 Ha;
 64. KRHF and KRKS-PBE0 (FFT K over every k pair, the Ewald exxdiv) on the
     gth-dzvp cell at 3x3x3, each within 1e-9 Ha of the same run on the
     twins;
 65. KUKS-PBE of the spin-2 primitive cell on the shifted 2x1x1 mesh at
     [17]^3, within 1e-9 Ha of the same run on the twins;
 66. one JSON line with the per-kernel numbers (times from CUDA events, the
     bound computed from this run's inputs, launches from the path that
     runs the kernel: int2e from 8, xc_uks from 9, int1e_ip, int1e_iprinv
     and int2e_ip1 from 12, int3c2e_ip, int2c2e_ip1, eval_ao_deriv2 and
     xc_rks_grad from 13, xc_uks_grad from 17, int1e_r from 20,
     int3c2e_lr, int2c2e_lr, vv10 and xc_rks with WB97 from 23, xc_uks
     with WB97 from 25, int2e_lr from 27's in-core run, mp2_energy and
     ccsd_t from 28, xc_fxc, xc_fxc_pairs, xc_rks_fxc and xc_uks_fxc from
     33, int1e_ipip, int3c2e_ip1, int2c2e_ip1_full, int3c2e_ipip and
     int2c2e_ipip from 37, int1e_stv_tz, int3c2e_tz and int2c2e_tz (the
     kernels at config 3's classes) from 39, int1e_stv_qz and int2e_qz
     (at config 4's) from 41, the DF gradient's four <kernel>_tz from 44
     and <kernel>_qz from 45's water/cc-pVQZ, the Hessian's five
     <kernel>_tz and <kernel>_qz from 47, eval_ao_deriv3, xc_rks_hess and
     xc_rks_deriv1 from 49 and their <kernel>_tz from 51, xc_uks_hess,
     xc_uks_deriv1 and eval_ao_deriv3_phenyl from 53, the <kernel>_pbe0
     from 54, the <kernel>_pbe from 55, eval_ao_pbc from 58's GDF run,
     eval_ao_pbc_d64, int1e_stv_pbc and xc_rks_d64 from 60,
     eval_ao_kpts, int1e_stv_kpts and xc_rks_k64 from 63, the others
     from 6), then the
     result line {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is non-zero.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, at 700 W: HBM3 bandwidth, the FP64 rate
# outside the tensor cores (the peak of the kernels whose work is no matrix
# product) and the FP64 tensor cores' (DMMA) rate, the peak of ccsd_t,
# whose w builds are small matrix products.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12


def cuda_ms(fn, reps=3, warmup=True):
    """Mean milliseconds of fn() over reps calls on the current stream,
    after one warm-up call unless warmup is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(pairs):
    """(max |a-b|, max |b|) over a list of (kernel, plain) tensor pairs."""
    err = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    return err, scale


def check(ok, what):
    if not ok:
        raise SystemExit(f'FAILED: {what}')


def bound(nbytes, nops, peak=FP64_FLOPS, tc_ops=0):
    """(ms, 'bytes' or 'operations'): the least time for the work, bytes
    over HBM bandwidth or FP64 operations over the card's peak rate for
    them: nops at peak, and tc_ops, the operations of matrix products, at
    the tensor cores' FP64_TC_FLOPS."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (nops / peak + tc_ops / FP64_TC_FLOPS) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def record(report, name, source, replaces, err, kernel, plain, nbytes,
           nops, plain_reps=3, peak=FP64_FLOPS, tc_ops=0):
    """Keep the kernel's line of the report. kernel and plain: each a
    callable, timed here by CUDA events (the mean of 3 calls, of plain_reps
    for the twin; the caller's comparison on the same inputs served as the
    warm-up), or the milliseconds the caller measured: a long twin's one
    comparison call on the host clock, ended by a synchronize."""
    def ms(t, reps):
        return cuda_ms(t, reps, warmup=False) if callable(t) else t

    bound_ms, bound_by = bound(nbytes, nops, peak, tc_ops)
    report[name] = dict(
        source=source, replaces=replaces, max_abs_err=err,
        ms=ms(kernel, 3), plain_ms=ms(plain, plain_reps),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    r = report[name]
    print(f'{name}: max_abs_err {err:.3e}  kernel {r["ms"]:.3f} ms  plain '
          f'{r["plain_ms"]:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})',
          flush=True)


# ---- operation counts of the integral kernels -------------------------------
# FP64 operations of the main loops of csrc/hermite.cuh coulomb_block,
# csrc/int2e.cu and csrc/int1e_stv.cu, for the primitives these inputs hold
# (zero coefficients are skipped as the kernels skip them). The Boys
# function is not counted, so these are lower bounds of the work.

def _carts(l):
    return [(ix, iy, l - ix - iy) for ix in range(l, -1, -1)
            for iy in range(l - ix, -1, -1)]


def _ntuv(L):
    return (L + 1) * (L + 2) * (L + 3) // 6


def _r_ops(L):
    """hermite_R recursion: 3 operations per entry and level."""
    return 3 * sum((k + 1) * (k + 2) // 2
                   for n in range(L) for k in range(1, L - n + 1))


def _e1d_ops(la, lb):
    return 5 * sum(i + j + 1 for i in range(la + 1) for j in range(lb + 1))


def _herm_terms(la, lb):
    return sum((ix + jx + 1) * (iy + jy + 1) * (iz + jz + 1)
               for ix, iy, iz in _carts(la) for jx, jy, jz in _carts(lb))


def _ket_ops(lc, l1):
    """Ket fold per primitive triple: the nonzero S and E_c terms."""
    from pyscf_tpu_torch.ops.integrals.cart2sph import cart2sph
    S = np.asarray(cart2sph(lc))
    n = 0
    for sc in range(2 * lc + 1):
        for jc, (kx, ky, kz) in enumerate(_carts(lc)):
            if S[sc, jc] != 0.0:
                n += sum(1 for tx in range(kx + 1) for ty in range(ky + 1)
                         for tz in range(kz + 1)
                         if (kx - tx) % 2 == 0 and (ky - ty) % 2 == 0
                         and (kz - tz) % 2 == 0)
    return n * (5 + 2 * _ntuv(l1))


def _nnz(c):
    return (c != 0).sum(dim=1).double()


def coulomb_ops(la, lb, lc, pair_prims, nthreads_per_pair, triples):
    """coulomb_block: per bra primitive pair (and thread) the E tables and
    the bra contraction, per primitive triple R and the ket fold."""
    per_pair = (3 * _e1d_ops(la, lb)
                + _herm_terms(la, lb) * (2 + 2 * (2 * lc + 1)))
    per_triple = _r_ops(la + lb + lc) + _ket_ops(lc, la + lb)
    return pair_prims * nthreads_per_pair * per_pair + triples * per_triple


def _same_centre(pairs):
    """Per shell pair: whether both shells sit on one centre."""
    return (pairs[2] == pairs[5]).all(dim=1)


def _fold_terms(lc, ld, sd, same):
    """Ket fold terms of csrc/int2e.cu for one sd: the (tx, ty, tz) of every
    nonzero (sc, jc, jd) entry, and on one centre only those whose E_t is
    not zero (i + j - t even)."""
    from pyscf_tpu_torch.ops.integrals.cart2sph import cart2sph
    Sc, Sd = np.asarray(cart2sph(lc)), np.asarray(cart2sph(ld))
    n = 0
    for sc in range(2 * lc + 1):
        for jc, kc in enumerate(_carts(lc)):
            if Sc[sc, jc] == 0.0:
                continue
            for jd, kd in enumerate(_carts(ld)):
                if Sd[sd, jd] == 0.0:
                    continue
                m = 1
                for i, j in zip(kc, kd):
                    m *= (i + j) // 2 + 1 if same else i + j + 1
                n += m
    return n


def _prim_pairs(pairs):
    return _nnz(pairs[1]) * _nnz(pairs[4])


def _bra_terms(la, lb, deriv):
    """Hermite terms of the bra's cartesian blocks: the shell pair itself,
    or the raised and lowered bra shells of a derivative."""
    if not deriv:
        return _herm_terms(la, lb)
    return _herm_terms(la + 1, lb) + (_herm_terms(la - 1, lb) if la else 0)


def pair_e_ops(la, lb, pairs, bra, deriv=False):
    """The E tables of a class of shell pairs and, for the bra, their
    products E_x E_y E_z: once per primitive pair, whatever the other side.
    A derivative bra has tables to la + 1."""
    per_pp = 3 * _e1d_ops(la + deriv, lb) \
        + (2 * _bra_terms(la, lb, deriv) if bra else 0)
    return float(_prim_pairs(pairs).sum()) * per_pp


def quartet_ops(la, lb, bra, lc, ld, ket, deriv=False):
    """csrc/int2e.cu (csrc/int2e_ip1.cu with deriv) for one ordered class
    pair, less the E tables: per primitive quartet R_tuv and, per sph
    component sd of the ket's second shell, the fold into Y; per (bra
    primitive pair, ket pair, sd) the bra contraction. The kernel redoes
    R_tuv and the E tables for every sd and every pair of the other side;
    that is not counted."""
    l1 = la + lb + deriv
    nt1 = _ntuv(l1)
    bra_pp = float(_prim_pairs(bra).sum())
    kp = _prim_pairs(ket)
    same = _same_centre(ket)
    ops = bra_pp * float(kp.sum()) * _r_ops(l1 + lc + ld)
    for sd in range(2 * ld + 1):
        for s in (True, False):
            kpp = float(kp[same == s].sum())
            ops += bra_pp * kpp * _fold_terms(lc, ld, sd, s) * (5 + 2 * nt1)
        ops += (bra_pp * ket[0].shape[0]
                * _bra_terms(la, lb, deriv) * 2 * (2 * lc + 1))
    return ops


def stv_ops(la, lb, pairs, natm, with_tv):
    ea, ca, _, eb, cb, _ = pairs
    prims = float((_nnz(ca) * _nnz(cb)).sum())
    ops = 3 * _e1d_ops(la, lb + 2)
    if with_tv:
        ops += natm * (_r_ops(la + lb) + 2 * _ntuv(la + lb))
        ops += 34 * len(_carts(la)) * len(_carts(lb)) \
            + 3 * _herm_terms(la, lb)
    else:
        ops += 4 * len(_carts(la)) * len(_carts(lb))
    return prims * ops


def ip_ops(la, lb, pairs, natm):
    """csrc/int1e_ip.cu: per primitive pair the E tables to (la + 1,
    lb + 2), R_tuv to order la + lb + 1 per atom, and the S/T/V terms of
    the raised and lowered bra shells."""
    ops = 3 * _e1d_ops(la + 1, lb + 2)
    ops += natm * (_r_ops(la + lb + 1) + 2 * _ntuv(la + lb + 1))
    for ls in ([la + 1, la - 1] if la else [la + 1]):
        ops += 34 * len(_carts(ls)) * len(_carts(lb)) \
            + 3 * _herm_terms(ls, lb)
    return float(_prim_pairs(pairs).sum()) * ops


def iprinv_ops(la, lb, pairs, ncentre):
    """csrc/int1e_iprinv.cu: per primitive pair the E tables (counted once,
    the kernel redoes them per centre) and, per centre, R_tuv to order
    la + lb + 1 and three shifted reads of it per Hermite term."""
    ops = 3 * _e1d_ops(la, lb) \
        + ncentre * (_r_ops(la + lb + 1) + 8 * _herm_terms(la, lb))
    return float(_prim_pairs(pairs).sum()) * ops


def coulomb_ip_ops(la, lb, lc, pair_prims, nthreads_per_pair, triples,
                   with_a=True):
    """csrc/coulomb_ip.cuh: per bra primitive pair (and thread) the E tables
    (to la + 1 for d/dA), the raised and lowered bra contraction and the
    contraction of Y shifted by one Hermite order with the weights; per
    primitive triple R_tuv to order la + lb + lc + 1 and the fold of the
    ket into Y to order la + lb + 1. The weights' cart transform is not
    counted."""
    dc = 2 * lc + 1
    per_pair = (3 * _e1d_ops(la + with_a, lb)
                + _herm_terms(la, lb) * (2 + 6 * dc))
    if with_a:
        per_pair += _bra_terms(la, lb, True) * (2 + 2 * dc)
    per_triple = _r_ops(la + lb + lc + 1) + _ket_ops(lc, la + lb + 1)
    return pair_prims * nthreads_per_pair * per_pair + triples * per_triple


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def int3c2e_ops(classes, aux):
    """coulomb_ops of every bra class against every aux class."""
    aux_nnz = {l: float(_nnz(c).sum()) for l, _, c, _ in aux}
    ops = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float((_nnz(p[1]) * _nnz(p[4])).sum())
        for l, e, _, _ in aux:
            ops += coulomb_ops(la, lb, l, prims, e.shape[0],
                               prims * aux_nnz[l])
    return ops


def int2c2e_ops(aux):
    """coulomb_ops of every aux class pair lx <= ly."""
    ops = 0.0
    for i, (lx, ex, cx, _) in enumerate(aux):
        for ly, ey, cy, _ in aux[i:]:
            prims = float(_nnz(cx).sum())
            ops += coulomb_ops(lx, 0, ly, prims, ey.shape[0],
                               prims * float(_nnz(cy).sum()))
    return ops


# ---- phases ---------------------------------------------------------------

def integral_phases(pt, refs, report):
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.ops import kernels

    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    auxmol = make_auxmol(mol)
    print(f'benzene/def2-SVP: nao {mol.nao}, naux {auxmol.nao}')
    stv_phase(kernels, mol, 'int1e_stv', report)
    df_integral_phase(kernels, mol, auxmol, '', report)


def df_integral_phase(kernels, mol, auxmol, suffix, report):
    """int3c2e (every (ij|P) class) and int2c2e against their twins on the
    card, <= 1e-12 x max, recorded as 'int3c2e' and 'int2c2e' + suffix; B
    from the kernel rows against B from the twin's rows under the same
    whitener, <= 1e-10. Returns the twin's rows and metric."""
    from pyscf_tpu_torch.ops.integrals import j3c

    classes = j3c.screened_pairs(mol)
    aux = j3c.aux_tables(auxmol)

    def rows(fn):
        return {cls: fn(*cls, *p, aux) for cls, (_, p) in classes.items()}

    rows_k = rows(kernels.int3c2e)
    rows_p, plain_s = host_s(lambda: rows(j3c.int3c2e_plain))
    err, scale = max_abs([(rows_k[c], rows_p[c]) for c in rows_k])
    for cls in classes:
        if max(cls) > 2:        # the f and g classes, each to its own size
            e_c, s_c = max_abs([(rows_k[cls], rows_p[cls])])
            print(f'int3c2e{suffix} {cls}: max_abs_err {e_c:.3e} of '
                  f'{s_c:.3e}')
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*a[1:]) for a in aux) + nbytes(*rows_k.values())
    record(report, 'int3c2e' + suffix, 'pyscf_tpu_torch/csrc/int3c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:188', err,
           lambda: rows(kernels.int3c2e), plain_s * 1e3, io,
           int3c2e_ops(classes, aux))
    check(err <= 1e-12 * scale, f'int3c2e{suffix} vs plain: {err:.3e} > '
          f'1e-12 x {scale:.3e}')

    jg_k = kernels.int2c2e(aux)
    jg_p, plain_s = host_s(lambda: j3c.int2c2e_plain(aux))
    err, scale = max_abs([(jg_k, jg_p)])
    record(report, 'int2c2e' + suffix, 'pyscf_tpu_torch/csrc/int2c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:266', err,
           lambda: kernels.int2c2e(aux), plain_s * 1e3,
           sum(nbytes(*a[1:]) for a in aux) + nbytes(jg_k),
           int2c2e_ops(aux))
    check(err <= 1e-12 * scale, f'int2c2e{suffix} vs plain: {err:.3e} > '
          f'1e-12 x {scale:.3e}')

    # B from the kernel rows against B from the plain rows, whitened by the
    # same (L^-1)^T: the metric's condition number amplifies the rounding
    # difference of the two metrics into B, so that part is reported apart
    linv_k = j3c.whitener(jg_k)
    B_k = j3c.whitened_factor(mol, auxmol, rows_k, linv_k)
    del rows_k
    err_b, _ = max_abs([(B_k, j3c.whitened_factor(mol, auxmol, rows_p,
                                                   linv_k))])
    err_w, _ = max_abs([(B_k, j3c.whitened_factor(mol, auxmol, rows_p,
                                                   j3c.whitener(jg_p)))])
    ev = torch.linalg.eigvalsh(jg_k)
    print(f'B{suffix}: max_abs_err {err_b:.3e} (same whitener); {err_w:.3e} '
          f'with each side\'s own whitener; (P|Q) condition number '
          f'{float(ev[-1] / ev[0]):.3e}')
    check(err_b <= 1e-10, f'B{suffix} (kernels) vs B (plain): {err_b:.3e} > '
          f'1e-10')
    return rows_p, jg_p


def run_path(name, kernels, names, build):
    """Drive one path with the launch counts set to 0 just before it; every
    kernel in `names` must have launched. Returns (mf, e, launches)."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf = build()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    print(f'{name}: E = {e!r}  converged {mf.converged}  cycles '
          f'{mf.scf_cycles}  wall {wall:.3f} s')
    order = ('hcore', 'j2c', 'j3c', 'eri', 'guess', 'grids', 'ao',
             'scf_loop')
    print('phase seconds: ' + '  '.join(f'{k} {mf.timings[k]:.4f}'
                                        for k in order if k in mf.timings))
    print(f'launches: {launches}')
    check(mf.converged, f'{name}: SCF did not converge')
    check(mf.mo_energy.shape[-1] == mf.mol.nao
          and bool(torch.isfinite(mf.mo_energy).all()),
          f'{name}: mo_energy is not finite of shape (..., nao)')
    for k in names:
        check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return mf, e, launches


def df_rhf_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
        mf = mol.RHF().density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, _ = run_path('DF-RHF benzene/def2-SVP', kernels,
                        ('int1e_stv', 'int3c2e', 'int2c2e'), build)
    de = e - refs.E_BENZENE_DF_RHF_DEF2SVP
    print(f'DF-RHF E - E_ref = {de:.3e}')
    check(abs(de) < 1e-8, f'DF-RHF |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return mf


def eigh_residual(mf):
    """eigh residuals at n = nao on the converged Fock, orthogonal basis:
    max |AV - VW| of torch.linalg.eigh and of lib.linalg.eigh with one and
    two Ogita-Aishima steps; the SCF's own setting must stay under
    1e-12."""
    from pyscf_tpu_torch.lib.linalg import EIGH_REFINE, canonical_orth, eigh
    _, veff_dm_fn = mf._veff_fns()
    fock = mf.get_hcore() + veff_dm_fn(mf.make_rdm1())[0]
    x = canonical_orth(mf.get_ovlp())
    fp = x.T @ fock @ x
    resid = {}
    for refine in (0, 1, 2):
        w, v = eigh(fp, refine)
        resid[refine] = float((fp @ v - v * w).abs().max())
    print(f'eigh n={fp.shape[0]}: max |AV - VW| = {resid[0]:.3e} '
          f'(torch.linalg.eigh), {resid[1]:.3e} and {resid[2]:.3e} (one and '
          f'two refinement steps); EIGH_REFINE = {EIGH_REFINE}')
    check(resid[EIGH_REFINE] < 1e-12,
          f'eigh residual {resid[EIGH_REFINE]:.3e} >= 1e-12 at EIGH_REFINE '
          f'{EIGH_REFINE}')


def grid_xc_phases(pt, kernels, mol, dm, report):
    from pyscf_tpu_torch.dft import gen_grid
    from pyscf_tpu_torch.ops import eval_gto

    tab = gen_grid.gen_atomic_grids(mol)
    inputs = gen_grid.partition_inputs(mol, tab)
    w_k = kernels.becke(*inputs)
    w_p = gen_grid.becke_weights_plain(*inputs)
    err, scale = max_abs([(w_k, w_p)])
    npts, natm = w_k.shape[0], mol.natm
    print(f'grid: {npts} points, {natm} atoms')
    record(report, 'becke', 'pyscf_tpu_torch/csrc/becke.cu',
           'pyscf_tpu/dft/gen_grid.py:179', err,
           lambda: kernels.becke(*inputs),
           lambda: gen_grid.becke_weights_plain(*inputs),
           nbytes(*inputs) + nbytes(w_k),
           npts * (natm * 11 + natm * (natm - 1) * 20))
    check(err <= 1e-12 * scale, f'becke vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    coords, weights = inputs[0], w_k
    tables = eval_gto.ao_tables(mol)
    ao_k = kernels.eval_ao(tables, coords, mol.nao, 1)
    ao_p = eval_gto.eval_ao_plain(tables, coords, mol.nao, 1)
    err, _ = max_abs([(ao_k, ao_p)])
    ops = 0.0
    for l, e, c, _, _ in tables:
        nc, d = (l + 1) * (l + 2) // 2, 2 * l + 1
        ops += npts * e.shape[0] * (8 + 7 * e.shape[1]
                                    + 4 * nc * (l + 4 + 2 * d))
    record(report, 'eval_ao', 'pyscf_tpu_torch/csrc/eval_ao.cu',
           'pyscf_tpu/ops/eval_gto.py:19', err,
           lambda: kernels.eval_ao(tables, coords, mol.nao, 1),
           lambda: eval_gto.eval_ao_plain(tables, coords, mol.nao, 1),
           nbytes(coords, ao_k) + sum(nbytes(*t[1:]) for t in tables), ops)
    check(err <= 1e-13, f'eval_ao vs plain: {err:.3e} > 1e-13')
    del ao_p

    xc_rks_phase(kernels, 'xc_rks', 'b3lypg', ao_k, dm, weights, report)


def xc_rks_phase(kernels, name, xc_code, aod, dm, weights, report,
                 dmao=None, replaces='pyscf_tpu/dft/numint.py:117'):
    """kernel xc_rks with the functional xc_code at the density dm (or at
    the rows dmao, if given) on the AO values aod (4, npts, nao) against
    its twin: vtmp <= 1e-11 x max|vtmp|, n and exc <= 1e-11 relative;
    recorded as `name`."""
    from pyscf_tpu_torch.dft import numint, xc

    f = xc.parse_xc(xc_code)
    dmao = aod[0] @ dm if dmao is None else dmao
    vt_k, n_k, e_k = kernels.xc_rks(aod, dmao, weights, f)
    vt_p, n_p, e_p = numint.xc_rks_plain(aod, dmao, weights, f)
    err, scale = max_abs([(vt_k, vt_p)])
    rel_n = abs(float(n_k - n_p)) / abs(float(n_p))
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    print(f'{name} ({xc_code}): n {float(n_k):.12f} (rel diff {rel_n:.2e}), '
          f'exc {float(e_k):.12f} (rel diff {rel_e:.2e})')
    npts, nao = weights.shape[0], aod.shape[-1]
    # reductions and vtmp: 16 operations per point and AO; the functional's
    # few hundred per point are not counted
    record(report, name, 'pyscf_tpu_torch/csrc/xc_rks.cu', replaces, err,
           lambda: kernels.xc_rks(aod, dmao, weights, f),
           lambda: numint.xc_rks_plain(aod, dmao, weights, f),
           nbytes(aod, dmao, weights, vt_k), 16 * npts * nao)
    check(err <= 1e-11 * scale, f'{name} vtmp vs plain: {err:.3e} > 1e-11 x '
          f'{scale:.3e}')
    check(rel_n <= 1e-11 and rel_e <= 1e-11,
          f'{name} n/exc vs plain: {rel_n:.2e}, {rel_e:.2e} > 1e-11')


def df_rks_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
        check(mol.device.type == 'cuda', 'M() without a device is not on '
              'the card')
        mf = pt.dft.RKS(mol, xc='b3lypg').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = run_path('DF-RKS b3lypg benzene/def2-SVP', kernels,
                               ('int1e_stv', 'int3c2e', 'int2c2e', 'eval_ao',
                                'becke', 'xc_rks'), build)
    de = e - refs.E_BENZENE_DF_RKS_B3LYPG_DEF2SVP
    print(f'DF-RKS E - E_ref = {de:.3e}  ngrid {mf.grids.size}')
    check(abs(de) < 1e-8, f'DF-RKS |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return launches


def int2e_phase(pt, refs, kernels, report, omega=None):
    """Every ordered pair of benzene's screened classes through the `int2e`
    kernel and its twin, <= 1e-12 x max; with omega, the erf(omega r)/r
    quartets, recorded as int2e_lr."""
    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    int2e_rows(kernels, mol, 'int2e_lr' if omega else 'int2e', report,
               omega)


def incore_rhf_path(pt, refs, kernels):
    def build():
        mf = pt.M(atom=refs.BENZENE, basis='def2-svp').RHF()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    torch.cuda.reset_peak_memory_stats()
    mf, e, launches = run_path('in-core RHF benzene/def2-SVP', kernels,
                               ('int2e', 'int1e_stv'), build)
    de = e - refs.E_BENZENE_RHF_DEF2SVP
    print(f'in-core RHF E - E_ref = {de:.3e}  eri '
          f'{tuple(mf._eri.shape)}  peak device memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    check(abs(de) < 1e-8, f'in-core RHF |E - E_ref| = {abs(de):.3e} >= 1e-8')
    # the K strategy of scf/hf.py, a batched GEMV on the tensor's own
    # layout, against an axis-swapped copy of the tensor (once per kernel())
    # and then a GEMV per K, and against torch.einsum as the JAX package
    # writes K
    eri, dm = mf._eri, mf.make_rdm1()
    n = eri.shape[0]
    get_k = mf._jk_fns()[1]
    bgemv_ms = cuda_ms(lambda: get_k(dm))
    copy_ms = cuda_ms(lambda: eri.permute(0, 2, 1, 3).contiguous())
    eri_k = eri.permute(0, 2, 1, 3).reshape(n * n, n * n)
    gemv_ms = cuda_ms(lambda: eri_k @ dm.reshape(-1))
    err, scale = max_abs([(get_k(dm),
                           (eri_k @ dm.reshape(-1)).reshape(n, n))])
    del eri_k
    einsum_ms = cuda_ms(lambda: torch.einsum('ilkj,lk->ij', eri, dm))
    print(f'in-core K: batched GEMV {bgemv_ms:.3f} ms per K; axis-swapped '
          f'copy {copy_ms:.3f} ms then a GEMV {gemv_ms:.3f} ms per K (max '
          f'|diff| {err:.3e}); torch.einsum {einsum_ms:.3f} ms per K')
    check(err <= 1e-12 * scale, f'in-core K: batched GEMV vs GEMV '
          f'{err:.3e} > 1e-12 x {scale:.3e}')
    return launches


def df_uks_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
        mf = mol.UKS(xc='b3lypg').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = run_path(
        'DF-UKS b3lypg phenyl/def2-SVP', kernels,
        ('int1e_stv', 'int3c2e', 'int2c2e', 'eval_ao', 'becke', 'xc_uks'),
        build)
    de = e - refs.E_PHENYL_DF_UKS_B3LYPG_DEF2SVP
    ss, mult = mf.spin_square()
    print(f'DF-UKS E - E_ref = {de:.3e}  <S^2> {ss!r}  2S+1 {mult!r}  '
          f'nelec {mf.mol.nelec}  ngrid {mf.grids.size}')
    check(abs(de) < 1e-8, f'DF-UKS |E - E_ref| = {abs(de):.3e} >= 1e-8')
    return mf, launches


def xc_uks_phase(kernels, mf, report, name='xc_uks', xc_code='b3lypg'):
    from pyscf_tpu_torch.dft import numint, xc

    f = xc.parse_xc(xc_code)
    aods, weights = mf._numint.grid_ao(mf.mol, mf.grids, 1, spins=2)
    check(len(aods) == 1, 'the phenyl grid does not fit one block')
    aod, w = aods[0], weights[0]
    dmao = aod[0] @ mf.make_rdm1()
    vt_k, n_k, e_k = kernels.xc_uks(aod, dmao, w, f)
    vt_p, n_p, e_p = numint.xc_uks_plain(aod, dmao, w, f)
    err, scale = max_abs([(vt_k, vt_p)])
    rel_n = float(torch.max(torch.abs(n_k - n_p) / torch.abs(n_p)))
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    print(f'{name} ({xc_code}) at the DF-UKS spin density: n {n_k.tolist()} '
          f'(rel diff {rel_n:.2e}), exc {float(e_k):.12f} (rel diff '
          f'{rel_e:.2e})')
    npts, nao = w.shape[0], aod.shape[-1]
    # reductions and the two vtmp rows: 30 operations per point and AO;
    # the functional's few thousand per point are not counted
    record(report, name, 'pyscf_tpu_torch/csrc/xc_uks.cu',
           'pyscf_tpu/dft/numint.py:224', err,
           lambda: kernels.xc_uks(aod, dmao, w, f),
           lambda: numint.xc_uks_plain(aod, dmao, w, f),
           nbytes(aod, dmao, w, vt_k), 30 * npts * nao)
    check(err <= 1e-11 * scale, f'{name} vtmp vs plain: {err:.3e} > 1e-11 x '
          f'{scale:.3e}')
    check(rel_n <= 1e-11 and rel_e <= 1e-11,
          f'{name} n/exc vs plain: {rel_n:.2e}, {rel_e:.2e} > 1e-11')


def one_e_deriv_phases(kernels, mol, report, suffix=''):
    """int1e_ip and int1e_iprinv over every ordered class and pair of mol
    against their twins (1e-12 x max), recorded as int1e_ip<suffix> and
    int1e_iprinv<suffix>."""
    from pyscf_tpu_torch.ops.integrals import int1e, int1e_deriv

    dev = mol.device
    classes = int1e.cross_pairs(mol, mol)     # every ordered class and pair
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    pair_bytes = sum(nbytes(*p) for *_, p in classes)

    def per_class(fn, *extra):
        return [fn(la, lb, *p, *extra) for la, lb, _, _, p in classes]

    k_out = per_class(kernels.int1e_ip, zr, zq)
    p_out, plain_s = host_s(lambda: per_class(int1e_deriv.class_ip, zr, zq))
    err, scale = max_abs(list(zip(k_out, p_out)))
    record(report, f'int1e_ip{suffix}', 'pyscf_tpu_torch/csrc/int1e_ip.cu',
           'pyscf_tpu/ops/integrals/int1e_deriv.py:32', err,
           lambda: per_class(kernels.int1e_ip, zr, zq), plain_s * 1e3,
           pair_bytes + nbytes(*k_out),
           sum(ip_ops(la, lb, p, mol.natm) for la, lb, _, _, p in classes))
    check(err <= 1e-12 * scale, f'int1e_ip{suffix} vs plain: {err:.3e} > '
          f'1e-12 x {scale:.3e}')

    k_out = per_class(kernels.int1e_iprinv, zr)
    p_out, plain_s = host_s(lambda: per_class(int1e_deriv.class_iprinv, zr))
    err, scale = max_abs(list(zip(k_out, p_out)))
    record(report, f'int1e_iprinv{suffix}',
           'pyscf_tpu_torch/csrc/int1e_iprinv.cu',
           'pyscf_tpu/ops/integrals/int1e_deriv.py:136', err,
           lambda: per_class(kernels.int1e_iprinv, zr), plain_s * 1e3,
           pair_bytes + nbytes(*k_out),
           sum(iprinv_ops(la, lb, p, mol.natm)
               for la, lb, _, _, p in classes))
    check(err <= 1e-12 * scale, f'int1e_iprinv{suffix} vs plain: {err:.3e} '
          f'> 1e-12 x {scale:.3e}')


def int2e_ip1_phase(kernels, mol, report):
    """int2e_ip1 over every ordered bra class of mol against every ket
    class, against its twin (1e-12 x max)."""
    from pyscf_tpu_torch.ops.integrals import int1e, int2e, j2e

    classes = int1e.cross_pairs(mol, mol)     # every ordered class and pair

    def per_class(fn, *extra):
        return [fn(la, lb, *p, *extra) for la, lb, _, _, p in classes]

    kets = j2e._ket_arrays(mol)
    k_out = per_class(kernels.int2e_ip1, kets)
    p_out, plain_s = host_s(lambda: per_class(int2e.int2e_ip1_class_plain,
                                              kets))
    err, scale = max_abs(list(zip(k_out, p_out)))
    nrow = sum(p.shape[1] for p in k_out)
    print(f'int2e_ip1: {len(classes)} ordered bra classes x {len(kets)} ket '
          f'classes, stacked rows 3 x {nrow} x {k_out[0].shape[2]} '
          f'({nbytes(*k_out) / 1e9:.3f} GB), dense 3 x (nao)^4 '
          f'{3 * mol.nao ** 4 * 8 / 1e9:.3f} GB')
    del p_out
    ops = sum(quartet_ops(la, lb, p, lc, ld, ket, deriv=True)
              for la, lb, _, _, p in classes for lc, ld, *ket in kets)
    ops += sum(pair_e_ops(la, lb, p, True, deriv=True)
               for la, lb, _, _, p in classes)
    ops += sum(pair_e_ops(lc, ld, ket, False) for lc, ld, *ket in kets)
    io = sum(nbytes(*p) for *_, p in classes) + nbytes(*k_out)
    del k_out
    record(report, 'int2e_ip1', 'pyscf_tpu_torch/csrc/int2e_ip1.cu',
           'pyscf_tpu/ops/integrals/int2e.py:727', err,
           lambda: per_class(kernels.int2e_ip1, kets), plain_s * 1e3, io, ops)
    check(err <= 1e-12 * scale, f'int2e_ip1 vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')


def mirror_defect(coords, de, axis):
    """max |de[image of A] - mirrored de[A]| for the mirror plane normal
    to `axis`, which must map the atoms onto each other exactly."""
    sign = np.ones(3)
    sign[axis] = -1.0
    dist = np.abs(coords[:, None, :] * sign - coords[None, :, :]).max(-1)
    image = dist.argmin(axis=1)
    check(float(dist.min(axis=1).max()) == 0.0,
          f'the geometry has no exact mirror plane normal to axis {axis}')
    return float(np.abs(de[image] - de * sign).max())


def d6h_ring(coords):
    """coords (12, 3) of a planar ring about the origin, six C then six H,
    with every atom moved to its element's mean radius at the nearest
    multiple of 30 degrees: D6h to the rounding of float64."""
    out = np.zeros_like(coords)
    for ring in (slice(0, 6), slice(6, 12)):
        r = np.linalg.norm(coords[ring], axis=1).mean()
        step = np.pi / 6
        ang = step * np.round(np.arctan2(coords[ring, 1], coords[ring, 0])
                              / step)
        out[ring, 0] = r * np.cos(ang)
        out[ring, 1] = r * np.sin(ang)
    return out


GRAD_KERNELS = ('int1e_ip', 'int1e_iprinv', 'int2e_ip1')


def tight_rhf(mol):
    """In-core RHF converged far enough for gradients and their central
    differences (the gradient's error is linear in the orbital gradient)."""
    mf = mol.RHF()
    mf.conv_tol = 1e-11
    mf.conv_tol_grad = 1e-7
    mf.init_guess = 'minao'
    return mf


def rhf_grad_path(pt, refs, kernels):
    torch.cuda.reset_peak_memory_stats()
    mf, e, _ = run_path('in-core RHF benzene/def2-SVP for the gradient',
                        kernels, ('int2e', 'int1e_stv'),
                        lambda: tight_rhf(pt.M(atom=refs.BENZENE,
                                               basis='def2-svp')))
    de_ref = abs(e - refs.E_BENZENE_RHF_DEF2SVP)
    check(de_ref < 1e-8, f'gradient SCF |E - E_ref| = {de_ref:.3e} >= 1e-8')
    t0 = time.perf_counter()
    grad = mf.nuc_grad_method()
    de = grad.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    print(f'RHF gradient benzene/def2-SVP (first call): wall {wall:.3f} s  '
          + '  '.join(f'{k} {v:.4f}' for k, v in grad.timings.items())
          + f'  peak device memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    print(f'launches: {launches}')
    print('de (Ha/Bohr):\n' + np.array2string(de, precision=10))
    for k in GRAD_KERNELS:
        check(launches[k] > 0, f'RHF gradient: kernel {k} never launched')
    check(de.shape == (mf.mol.natm, 3) and bool(np.isfinite(de).all()),
          'the gradient is not finite of shape (natm, 3)')
    drift = float(np.abs(de.sum(axis=0)).max())
    check(drift < 1e-9, f'gradient sum rule: {drift:.3e} >= 1e-9')
    # The geometry's six-decimal coordinates are exactly D2h (the mirrors
    # x, y and z) and D6h only to 3e-7 Angstrom, so the mirrors hold to
    # 1e-8 and the six-fold equalities to 1e-6.
    mirror = max(mirror_defect(mf.mol.coords, de, ax) for ax in range(3))
    norms = np.linalg.norm(de, axis=1)
    spread_c = float(np.ptp(norms[:6]))
    spread_h = float(np.ptp(norms[6:]))
    print(f'|sum_A de[A]| {drift:.3e}  mirror defect {mirror:.3e}  |de| C '
          f'{norms[0]:.10f} (spread {spread_c:.3e})  H {norms[6]:.10f} '
          f'(spread {spread_h:.3e})')
    check(mirror < 1e-8, f'D2h: the gradient breaks a mirror plane by '
          f'{mirror:.3e} >= 1e-8')
    check(spread_c < 1e-6 and spread_h < 1e-6,
          f'D6h: gradient norms differ by {spread_c:.3e} (C), '
          f'{spread_h:.3e} (H) >= 1e-6')

    from pyscf_tpu_torch.grad import finite_difference_gradient
    picks = [(0, 1), (6, 1)]      # the radial coordinate of one C, one H
    fd = finite_difference_gradient(lambda m: tight_rhf(m).kernel(), mf.mol,
                                    1e-4, picks)
    for a, x in picks:
        diff = abs(de[a, x] - fd[a, x])
        print(f'de[{a},{x}] analytic {de[a, x]:.10f}  central differences '
              f'{fd[a, x]:.10f}  diff {diff:.3e}')
        check(diff < 1e-6, f'gradient vs central differences at ({a},{x}): '
              f'{diff:.3e} >= 1e-6')

    # the same molecule on coordinates that are D6h to float64's rounding
    # (moved by up to 3e-7 Angstrom): the six-fold equalities to 1e-8
    mfs = tight_rhf(mf.mol.copy().set_geom_(d6h_ring(mf.mol.coords)))
    mfs.kernel()
    norms = np.linalg.norm(mfs.nuc_grad_method().kernel(), axis=1)
    sym_c = float(np.ptp(norms[:6]))
    sym_h = float(np.ptp(norms[6:]))
    print(f'on the D6h-symmetrised ring: |de| C {norms[0]:.10f} (spread '
          f'{sym_c:.3e})  H {norms[6]:.10f} (spread {sym_h:.3e})')
    check(mfs.converged and sym_c < 1e-8 and sym_h < 1e-8,
          f'D6h ring: gradient norms differ by {sym_c:.3e} (C), '
          f'{sym_h:.3e} (H) >= 1e-8')
    del mfs
    torch.cuda.empty_cache()

    walls, phases = [], []
    for _ in range(3):
        mf.mol._j3c_cache.pop('ip1e')     # a warm call rebuilds everything
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad.kernel()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(grad.timings))
    print(f'RHF gradient warm: wall median {np.median(walls):.4f} s '
          f'(min {min(walls):.4f}, max {max(walls):.4f})  '
          + '  '.join(f'{k} {np.median([p[k] for p in phases]):.4f}'
                      for k in phases[0]))
    del mf, grad
    torch.cuda.empty_cache()

    mfw = tight_rhf(pt.M(atom=refs.WATER, basis='def2-svp'))
    dew = mfw.run().nuc_grad_method().kernel()
    ew = mfw.e_tot
    err = float(np.abs(dew - np.array(refs.GRAD_WATER_RHF_DEF2SVP)).max())
    print(f'water/def2-SVP RHF: E - E_ref {ew - refs.E_WATER_RHF_DEF2SVP:.3e}'
          f'  max |de - de_ref| {err:.3e}')
    check(mfw.converged and err < 1e-8,
          f'water gradient vs the recorded JAX gradient: {err:.3e} >= 1e-8')
    return launches


# ---- the density-fitted gradients -------------------------------------------

DF_GRAD_KERNELS = ('int1e_ip', 'int1e_iprinv', 'int3c2e_ip', 'int2c2e_ip1')
# the radial coordinate of one C and of one H of benzene
RADIAL_PICKS = [(0, 1), (6, 1)]
XC_GRAD_KERNELS = ('eval_ao_deriv2', 'xc_rks_grad')


def tight(mf):
    """Converged far enough for gradients and their central differences."""
    mf.conv_tol = 1e-10
    mf.conv_tol_grad = 1e-7
    mf.init_guess = 'minao'
    return mf


def fixed_grid(mf0):
    """A function that makes moved copies of the DF-RKS or DF-UKS mean
    field mf0 which keep its grid points and weights, so that their
    central differences are the fixed-grid gradient; grid=False lets the
    grid follow the atoms."""
    kind = 'UKS' if mf0.mo_occ.dim() == 2 else 'RKS'

    def build(mol, grid=True):
        mf = tight(getattr(mol, kind)(xc=mf0.xc).density_fit())
        if grid:
            mf.grids.coords = mf0.grids.coords
            mf.grids.weights = mf0.grids.weights
        return mf
    return build


def df_grad_path(name, kernels, build, e_ref, names):
    """M() through kernel() (run_path, which sets the launch counts to 0)
    and nuc_grad_method().kernel(); every kernel in `names` must have
    launched by the end; E within 1e-8 of e_ref unless e_ref is None (no
    JAX reference at the path's width). Returns (mf, grad, de,
    launches)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf, e, _ = run_path(name, kernels, (), build)
    grad = mf.nuc_grad_method()
    de = grad.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    ref = f'E - E_ref {e - e_ref:.3e}' if e_ref is not None else f'E {e!r}'
    print(f'{name}: {ref}  energy check |e_chk - E| '
          f'{abs(grad.e_chk - e):.3e}  wall from M() {wall:.3f} s  peak '
          f'device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    print('gradient phases: ' + '  '.join(
        f'{k} {v:.4f}' for k, v in grad.timings.items()))
    print(f'launches: {launches}')
    print('de (Ha/Bohr):\n' + np.array2string(de, precision=10))
    if e_ref is not None:
        check(abs(e - e_ref) < 1e-8, f'{name}: |E - E_ref| '
              f'{abs(e - e_ref):.3e}')
    check(abs(grad.e_chk - e) < 1e-6, f'{name}: energy check')
    check(de.shape == (mf.mol.natm, 3) and bool(np.isfinite(de).all()),
          f'{name}: the gradient is not finite of shape (natm, 3)')
    for k in names:
        check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return mf, grad, de, launches


def central_differences(name, de, efun, mol, picks, limit):
    from pyscf_tpu_torch.grad import finite_difference_gradient
    fd = finite_difference_gradient(efun, mol, 1e-4, picks)
    for a, x in picks:
        diff = abs(de[a, x] - fd[a, x])
        print(f'{name} de[{a},{x}] analytic {de[a, x]:.10f}  central '
              f'differences {fd[a, x]:.10f}  diff {diff:.3e}')
        if limit is not None:
            check(diff < limit, f'{name}: gradient vs central differences '
                  f'at ({a},{x}): {diff:.3e} >= {limit}')
    return fd


def warm_gradient(name, grad, runs=3):
    """Median wall and phases of `runs` more gradients of one mean field."""
    walls, phases = [], []
    for _ in range(runs):
        grad.mol._j3c_cache.pop('ip1e')     # rebuilt, as a new geometry would
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad.kernel()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(dict(grad.timings))
    print(f'{name} gradient warm: wall median {np.median(walls):.4f} s '
          f'(min {min(walls):.4f}, max {max(walls):.4f})  '
          + '  '.join(f'{k} {np.median([p[k] for p in phases]):.4f}'
                      for k in phases[0]))


def df_rks_grad_path(pt, refs, kernels, tzvp=False):
    """The main path with its forces: benzene DF-RKS b3lypg/def2-SVP; with
    tzvp, the north-star basis def2-TZVP (f shells; no JAX reference at
    that width, no moving-grid differences and no warm runs)."""
    basis = 'def2-TZVP' if tzvp else 'def2-SVP'
    mf, grad, de, launches = df_grad_path(
        f'DF-RKS b3lypg benzene/{basis} + gradient', kernels,
        lambda: tight(pt.dft.RKS(pt.M(atom=refs.BENZENE, basis=basis),
                                 xc='b3lypg').density_fit()),
        None if tzvp else refs.E_BENZENE_DF_RKS_B3LYPG_DEF2SVP,
        ('int1e_stv', 'int3c2e', 'int2c2e', 'eval_ao', 'becke', 'xc_rks')
        + DF_GRAD_KERNELS + XC_GRAD_KERNELS)
    # the grid is held fixed (no grid response, as in the JAX package), so
    # the sum over atoms is not zero; the planar molecule's out-of-plane
    # components and its mirror planes still hold
    out = float(np.abs(de[:, 2]).max())
    mirror = max(mirror_defect(mf.mol.coords, de, ax) for ax in range(3))
    print(f'|de_z| {out:.3e}  mirror defect {mirror:.3e}  |sum_A de[A]| '
          f'(the missing grid response) {np.abs(de.sum(axis=0)).max():.3e}')
    check(out < 1e-8, f'DF-RKS gradient: |de_z| {out:.3e} >= 1e-8')
    check(mirror < 1e-8, f'DF-RKS gradient: mirror defect {mirror:.3e}')
    build = fixed_grid(mf)
    fd = central_differences(f'DF-RKS {basis} (grid fixed)', de,
                             lambda m: build(m).kernel(), mf.mol,
                             RADIAL_PICKS, 1e-6)
    if tzvp:
        return mf, launches
    fdm = central_differences('DF-RKS (grid moving)', de,
                              lambda m: build(m, grid=False).kernel(),
                              mf.mol, RADIAL_PICKS, None)
    for a, x in RADIAL_PICKS:
        print(f'grid response at ({a},{x}): moving-grid minus fixed-grid '
              f'central differences {fdm[a, x] - fd[a, x]:.3e}')
    warm_gradient('DF-RKS', grad)
    return mf, launches


def df_rhf_grad_path(pt, refs, kernels):
    mf, grad, de, _ = df_grad_path(
        'DF-RHF benzene/def2-SVP + gradient', kernels,
        lambda: tight(pt.M(atom=refs.BENZENE, basis='def2-svp').RHF()
                      .density_fit()),
        refs.E_BENZENE_DF_RHF_DEF2SVP, DF_GRAD_KERNELS)
    drift = float(np.abs(de.sum(axis=0)).max())
    mirror = max(mirror_defect(mf.mol.coords, de, ax) for ax in range(3))
    print(f'|sum_A de[A]| {drift:.3e}  mirror defect {mirror:.3e}')
    check(drift < 1e-9, f'DF-RHF gradient sum rule: {drift:.3e} >= 1e-9')
    check(mirror < 1e-8, f'DF-RHF gradient: mirror defect {mirror:.3e}')
    central_differences(
        'DF-RHF', de, lambda m: tight(m.RHF().density_fit()).kernel(),
        mf.mol, RADIAL_PICKS, 1e-6)
    warm_gradient('DF-RHF', grad)


def df_water_gradients(pt, refs, names):
    """Water/def2-SVP DF-RHF, DF-RKS b3lypg (grids level 1) and the water
    cation's DF-UHF and DF-UKS b3lypg (grids level 1), those of `names`,
    against the recorded JAX gradients, 1e-8."""
    def ks(kind):
        def build(mol):
            mf = getattr(mol, kind)(xc='b3lypg').density_fit()
            mf.grids.level = 1
            return mf
        return build

    cation = dict(charge=1, spin=1)
    cases = {'DF-RHF': ({}, lambda m: m.RHF().density_fit(),
                        refs.GRAD_WATER_DF_RHF_DEF2SVP),
             'DF-RKS b3lypg': ({}, ks('RKS'),
                               refs.GRAD_WATER_DF_RKS_B3LYPG_L1),
             'DF-UHF cation': (cation, lambda m: m.UHF().density_fit(),
                               refs.GRAD_WATER_CATION_DF_UHF_DEF2SVP),
             'DF-UKS b3lypg cation': (cation, ks('UKS'),
                                      refs.GRAD_WATER_CATION_DF_UKS_B3LYPG_L1)}
    for name in names:
        kw, build, ref = cases[name]
        mf = tight(build(pt.M(atom=refs.WATER, basis='def2-svp', **kw)))
        de = mf.run().nuc_grad_method().kernel()
        err = float(np.abs(de - np.array(ref)).max())
        print(f'water/def2-SVP {name}: max |de - de_ref| {err:.3e}')
        check(mf.converged and err < 1e-8, f'water {name} gradient vs the '
              f'recorded JAX gradient: {err:.3e} >= 1e-8')


def df_grad_phases(kernels, mf, report, suffix=''):
    """int3c2e_ip and int2c2e_ip1 against their twins at the shapes of mf's
    DF gradient, on the Gamma and W_PQ of the converged mean field (1e-10 x
    max), recorded as int3c2e_ip<suffix> and int2c2e_ip1<suffix>."""
    from pyscf_tpu_torch.grad import df
    from pyscf_tpu_torch.ops.integrals import j3c, j3c_deriv

    mol, auxmol = mf.mol, mf.with_df.auxmol
    dev = mol.device
    dm, cos, _, kfac = df.occupied(mf)
    _, gamma, W = df.fitted_weights(mf, dm, cos, kfac)
    naux, nao = auxmol.nao, mol.nao
    order = torch.as_tensor(j3c._grouped_order(auxmol), device=dev)
    gflat = gamma.reshape(naux, nao * nao).index_select(0, order)
    del gamma
    bra = j3c._bra_classes(mol)
    classes = j3c.screened_pairs(mol)
    aux = j3c.aux_tables(auxmol)
    G = {cls: j3c_deriv._gamma_rows(mol, bra[cls], gflat) for cls in classes}
    del gflat

    def rows(fn):
        return [fn(*cls, *p, aux, G[cls]) for cls, (_, p) in classes.items()]

    k_out = rows(kernels.int3c2e_ip)
    p_out, plain_s = host_s(lambda: rows(j3c_deriv.int3c2e_ip_plain))
    err, scale = max_abs(list(zip(k_out, p_out)))
    aux_nnz = {l: float(_nnz(c).sum()) for l, _, c, _ in aux}
    ops = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float(_prim_pairs(p).sum())
        for l, e, _, _ in aux:
            ops += coulomb_ip_ops(la, lb, l, prims, e.shape[0],
                                  prims * aux_nnz[l])
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*a[1:]) for a in aux) + nbytes(*G.values(), *k_out)
    record(report, f'int3c2e_ip{suffix}',
           'pyscf_tpu_torch/csrc/int3c2e_ip.cu',
           'pyscf_tpu/grad/autodiff.py:148', err,
           lambda: rows(kernels.int3c2e_ip), plain_s * 1e3, io, ops)
    check(err <= 1e-10 * scale, f'int3c2e_ip{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')
    del G, k_out, p_out

    Wg = W.index_select(0, order).index_select(1, order).contiguous()
    k_out = kernels.int2c2e_ip1(aux, Wg)
    err, scale = max_abs([(k_out, j3c_deriv.int2c2e_ip1_plain(aux, Wg))])
    ops = 0.0
    for lx, ex, cx, _ in aux:
        for ly, ey, cy, _ in aux:
            prims = float(_nnz(cy).sum())
            ops += coulomb_ip_ops(ly, 0, lx, prims, ex.shape[0],
                                  prims * float(_nnz(cx).sum()), False)
    record(report, f'int2c2e_ip1{suffix}',
           'pyscf_tpu_torch/csrc/int2c2e_ip1.cu',
           'pyscf_tpu/grad/autodiff.py:131', err,
           lambda: kernels.int2c2e_ip1(aux, Wg),
           lambda: j3c_deriv.int2c2e_ip1_plain(aux, Wg),
           sum(nbytes(*a[1:]) for a in aux) + nbytes(Wg, k_out), ops)
    check(err <= 1e-10 * scale, f'int2c2e_ip1{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')


def eval_ao_phase(kernels, mf, report, name, deriv):
    """eval_ao at `deriv` (2 or 3) on mf's whole grid against its twin:
    <= 1e-12 x max; recorded as name."""
    from pyscf_tpu_torch.ops import eval_gto

    mol, nao = mf.mol, mf.mol.nao
    coords = mf.grids.coords
    npts = coords.shape[0]
    tables = eval_gto.ao_tables(mol)
    kernel = getattr(kernels, f'eval_ao_deriv{deriv}')
    ao_k = kernel(tables, coords, nao)
    ao_p = eval_gto.eval_ao_plain(tables, coords, nao, deriv)
    err, scale = max_abs([(ao_k, ao_p)])
    del ao_p
    ncomp = (deriv + 1) * (deriv + 2) * (deriv + 3) // 6
    ops = 0.0
    for l, e, c, _, _ in tables:
        nc, d = (l + 1) * (l + 2) // 2, 2 * l + 1
        ops += npts * e.shape[0] * (8 + (2 * deriv + 5) * e.shape[1]
                                    + ncomp * nc * (l + 8 * (deriv - 1)
                                                    + 2 * d))
    record(report, name, 'pyscf_tpu_torch/csrc/eval_ao.cu',
           'pyscf_tpu/ops/eval_gto.py:63' if deriv == 2
           else 'pyscf_tpu/ops/eval_gto.py:19', err,
           lambda: kernel(tables, coords, nao),
           lambda: eval_gto.eval_ao_plain(tables, coords, nao, deriv),
           nbytes(coords, ao_k) + sum(nbytes(*t[1:]) for t in tables), ops)
    check(err <= 1e-12 * scale, f'{name} vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')


def xc_grad_phases(kernels, mf, report, suffix=''):
    """xc_rks_grad against its twin on the converged DF-RKS's grid and
    density; recorded as xc_rks_grad<suffix>."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.grad import df
    from pyscf_tpu_torch.ops import eval_gto

    mol, nao = mf.mol, mf.mol.nao
    dm = df.occupied(mf)[0]
    coords, weights = mf.grids.coords, mf.grids.weights
    tables = eval_gto.ao_tables(mol)
    ao_k = kernels.eval_ao_deriv2(tables, coords, nao)
    npts = coords.shape[0]

    f = mf.xc_obj
    dmao = (ao_k[:4].reshape(-1, nao) @ dm).reshape(4, -1, nao)
    g_k, e_k = kernels.xc_rks_grad(ao_k, dmao, weights, f)
    g_p, e_p = numint.xc_rks_grad_plain(ao_k, dmao, weights, f)
    err, scale = max_abs([(g_k, g_p)])
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    print(f'xc_rks_grad{suffix} ({mf.xc}) at the DF-RKS density: exc '
          f'{float(e_k):.12f} (rel diff {rel_e:.2e})')
    # per point and AO 13 reads and ~40 operations; the functional's few
    # hundred per point are not counted
    record(report, f'xc_rks_grad{suffix}',
           'pyscf_tpu_torch/csrc/xc_rks_grad.cu',
           'pyscf_tpu/grad/autodiff.py:199', err,
           lambda: kernels.xc_rks_grad(ao_k, dmao, weights, f),
           lambda: numint.xc_rks_grad_plain(ao_k, dmao, weights, f),
           nbytes(ao_k, dmao, weights) + 8 * 4 * nao * (npts // 64 + 1),
           40 * npts * nao)
    check(err <= 1e-10 * scale, f'xc_rks_grad vs plain: {err:.3e} > 1e-10 x '
          f'{scale:.3e}')
    check(rel_e <= 1e-11, f'xc_rks_grad exc vs plain: {rel_e:.2e} > 1e-11')


# ---- DF-UKS forces, the dipole and geometry optimisation ------------------

def xc_uks_grad_phase(kernels, mf, report, name='xc_uks_grad'):
    """xc_uks_grad against its twin at the converged phenyl DF-UKS spin
    density on its whole default grid, block by block as uks_grad cuts
    it: g <= 1e-10 x max|g|, exc <= 1e-11 relative."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.ops import eval_gto

    mol, grids, f = mf.mol, mf.grids, mf.xc_obj
    nao, npts = mol.nao, grids.size
    dm = mf.make_rdm1()
    blk = numint._block_size(npts, nao, 18, mol.device)
    pairs, e_k, e_p = [], 0.0, 0.0
    for i in range(0, npts, blk):
        aod = eval_gto.eval_ao(mol, grids.coords[i:i + blk], 2)
        dmao = (aod[:4].reshape(-1, nao) @ dm).reshape(2, 4, -1, nao)
        w = grids.weights[i:i + blk]
        g_k, ek = kernels.xc_uks_grad(aod, dmao, w, f)
        g_p, ep = numint.xc_uks_grad_plain(aod, dmao, w, f)
        pairs.append((g_k, g_p))
        e_k, e_p = e_k + float(ek), e_p + float(ep)
        if i == 0:
            first = (aod, dmao, w)
    err, scale = max_abs(pairs)
    rel_e = abs(e_k - e_p) / abs(e_p)
    aod, dmao, w = first
    nb = w.shape[0]
    print(f'{name} ({mf.xc}) at the DF-UKS phenyl spin density: {npts} '
          f'points in blocks of {blk}, exc {e_k:.12f} (rel diff '
          f'{rel_e:.2e})')
    # per point and AO 18 reads and ~75 operations; the functional's few
    # thousand per point are not counted
    record(report, name, 'pyscf_tpu_torch/csrc/xc_uks_grad.cu',
           'pyscf_tpu/grad/autodiff.py:228', err,
           lambda: kernels.xc_uks_grad(aod, dmao, w, f),
           lambda: numint.xc_uks_grad_plain(aod, dmao, w, f),
           nbytes(aod, dmao, w) + 8 * 4 * nao * (nb // 64 + 1),
           75 * nb * nao)
    check(err <= 1e-10 * scale, f'xc_uks_grad vs plain: {err:.3e} > 1e-10 x '
          f'{scale:.3e}')
    check(rel_e <= 1e-11, f'xc_uks_grad exc vs plain: {rel_e:.2e} > 1e-11')


def x_mirror(coords):
    """image[A]: the atom that the mirror x -> -x maps A onto."""
    flip = coords * np.array([-1.0, 1.0, 1.0])
    return np.abs(flip[:, None, :] - coords[None, :, :]).max(-1).argmin(1)


def df_uks_grad_path(pt, refs, kernels):
    """The phenyl radical's DF-UKS b3lypg/def2-SVP gradient at full width."""
    mf, grad, de, launches = df_grad_path(
        'DF-UKS b3lypg phenyl/def2-SVP + gradient', kernels,
        lambda: tight(pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
                      .UKS(xc='b3lypg').density_fit()),
        refs.E_PHENYL_DF_UKS_B3LYPG_DEF2SVP,
        DF_GRAD_KERNELS + ('eval_ao_deriv2', 'xc_uks_grad'))
    # planar, with the mirror x -> -x; the grid is held fixed, so the sum
    # over atoms is the missing grid response
    out = float(np.abs(de[:, 2]).max())
    mirror = mirror_defect(mf.mol.coords, de, 0)
    print(f'|de_z| {out:.3e}  x-mirror defect {mirror:.3e}  |sum_A de[A]| '
          f'(the missing grid response) {np.abs(de.sum(axis=0)).max():.3e}')
    check(out < 1e-8, f'DF-UKS gradient: |de_z| {out:.3e} >= 1e-8')
    check(mirror < 1e-8, f'DF-UKS gradient: x-mirror defect {mirror:.3e}')
    # the radical carbon's and the para hydrogen's radial coordinates
    picks = [(0, 1), (8, 1)]
    build = fixed_grid(mf)
    fd = central_differences('DF-UKS (grid fixed)', de,
                             lambda m: build(m).kernel(), mf.mol, picks, 1e-6)
    fdm = central_differences('DF-UKS (grid moving)', de,
                              lambda m: build(m, grid=False).kernel(),
                              mf.mol, picks, None)
    for a, x in picks:
        print(f'grid response at ({a},{x}): moving-grid minus fixed-grid '
              f'central differences {fdm[a, x] - fd[a, x]:.3e}')
    warm_gradient('DF-UKS', grad)
    return launches


def r_ops(la, lb, pairs):
    """csrc/int1e_r.cu per primitive pair: the E tables to lb + 1 and, per
    cartesian pair, three components of 8 operations."""
    nc = len(_carts(la)) * len(_carts(lb))
    return float(_prim_pairs(pairs).sum()) * (3 * _e1d_ops(la, lb + 1)
                                              + nc * (6 + 3 * 8))


def int1e_r_phase(pt, refs, kernels, report):
    """int1e_r over every ordered class pair of benzene/def2-SVP against
    class_r: <= 1e-12 x max|value|."""
    from pyscf_tpu_torch.ops.integrals import int1e

    mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
    classes = int1e.cross_pairs(mol, mol)

    def per_class(fn):
        return [fn(la, lb, *p) for la, lb, _, _, p in classes]

    k_out, p_out = per_class(kernels.int1e_r), per_class(int1e.class_r)
    err, scale = max_abs(list(zip(k_out, p_out)))
    print(f'int1e_r: {len(classes)} ordered class pairs, '
          f'{sum(p[0].shape[0] for *_, p in classes)} shell pairs')
    record(report, 'int1e_r', 'pyscf_tpu_torch/csrc/int1e_r.cu',
           'pyscf_tpu/ops/integrals/int1e.py:93', err,
           lambda: per_class(kernels.int1e_r),
           lambda: per_class(int1e.class_r),
           sum(nbytes(*p) for *_, p in classes) + nbytes(*k_out),
           sum(r_ops(la, lb, p) for la, lb, _, _, p in classes))
    check(err <= 1e-12 * scale, f'int1e_r vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')


def water_analysis_path(pt, refs, kernels):
    """In-core RHF/def2-SVP water, then dip_moment() and mulliken_pop()
    against the recorded JAX values: 1e-8 Debye, 1e-8."""
    def build():
        mf = pt.M(atom=refs.WATER, basis='def2-svp').RHF()
        mf.conv_tol = 1e-11
        mf.conv_tol_grad = 1e-9
        mf.init_guess = 'minao'
        return mf

    mf, _, _ = run_path('in-core RHF water/def2-SVP', kernels, ('int2e',),
                        build)
    mu = mf.dip_moment()
    _, chg = mf.mulliken_pop()
    launches = kernels.launches()
    err_mu = float(np.abs(mu - np.array(refs.DIP_WATER_RHF_DEF2SVP)).max())
    err_q = float(np.abs(chg - np.array(refs.CHG_WATER_RHF_DEF2SVP)).max())
    print(f'water dipole (Debye) {mu.tolist()}  max |mu - mu_ref| '
          f'{err_mu:.3e}; Mulliken charges {chg.tolist()}  max |q - q_ref| '
          f'{err_q:.3e}; int1e_r launches {launches["int1e_r"]}')
    check(err_mu < 1e-8, f'water dipole vs the recorded JAX dipole: '
          f'{err_mu:.3e} >= 1e-8 Debye')
    check(err_q < 1e-8, f'water Mulliken charges vs the recorded JAX '
          f'charges: {err_q:.3e} >= 1e-8')
    check(launches['int1e_r'] > 0, 'dip_moment: int1e_r never launched')
    return launches


def phenyl_optimisation_path(pt, refs, kernels):
    """The optimisation path: geomopt.internal.optimize of the phenyl radical
    with DF-UKS b3lypg/def2-SVP forces from the benzene geometry less one
    H, then analyze() at the optimised geometry."""
    from pyscf_tpu_torch.geomopt import internal

    steps, last = [], {}

    def mf_factory(m):
        t0 = time.perf_counter()
        mf = tight(m.UKS(xc='b3lypg').density_fit())
        mf.kernel()
        check(mf.converged, f'step {len(steps)}: SCF did not converge')
        gradients = mf.Gradients

        class Logged:
            """mf.Gradients() whose kernel() prints and keeps the step."""
            def kernel(self):
                de = gradients().kernel()
                torch.cuda.synchronize()
                steps.append((mf.e_tot, float(np.abs(de).max()),
                              time.perf_counter() - t0))
                print(f'step {len(steps)}: E {mf.e_tot:.10f}  max|g| '
                      f'{steps[-1][1]:.3e}  {steps[-1][2]:.3f} s  cycles '
                      f'{mf.scf_cycles}', flush=True)
                return de

        mf.Gradients = Logged
        last['mf'] = mf
        return mf

    mol0 = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
    # the first torch.func call of a process loads its machinery: timed
    # apart, so that the optimisation's wall below holds only its own work
    ints = internal.detect_internals(mol0)
    x0 = torch.as_tensor(mol0.coords)
    t0 = time.perf_counter()
    torch.func.jacrev(internal.q_func(*ints))(x0)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.func.jacrev(internal.q_func(*ints))(x0)
    print(f'Wilson B of {sum(map(len, ints))} internal coordinates by '
          f'torch.func.jacrev on the CPU: the process\'s first call '
          f'{first:.3f} s, the next {time.perf_counter() - t0:.4f} s')
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mol, energies = internal.optimize(mf_factory, mol0, gtol=3e-4,
                                      maxsteps=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(steps) == len(energies) <= 30 and steps[-1][1] < 3e-4,
          f'phenyl optimisation: max|g| {steps[-1][1]:.3e} after '
          f'{len(steps)} steps')
    mf = last['mf']
    check(np.array_equal(mf.mol.coords, mol.coords),
          'the last mean field is not at the optimised geometry')
    pop, chg, mu = mf.analyze()
    _, spin = mf.mulliken_spin_pop()
    torch.cuda.synchronize()
    launches = kernels.launches()
    x = mol.coords
    image = x_mirror(mol0.coords)
    flip = x[image] * np.array([-1.0, 1.0, 1.0])
    mirror = float(np.abs(flip - x).max())
    planar = float(np.abs(x[:, 2]).max())
    u, v = x[1] - x[0], x[5] - x[0]
    angle = np.degrees(np.arccos(u @ v / np.linalg.norm(u)
                                 / np.linalg.norm(v)))
    in_steps = sum(t for _, _, t in steps)
    print(f'phenyl optimisation: {len(energies)} steps in {wall:.3f} s '
          f'({in_steps:.3f} s in the steps\' SCF and gradient, '
          f'{wall - in_steps:.3f} s in the optimiser: Mole builds, q, B and '
          f'the back-transformation), '
          f'E {energies[0]:.10f} -> {energies[-1]:.10f} '
          f'({energies[-1] - energies[0]:.3e} Ha); C5-C0-C1 at the radical '
          f'carbon {angle:.4f} deg; x-mirror {mirror:.3e} Bohr, |z| '
          f'{planar:.3e} Bohr')
    print(f'analyze: sum of charges {chg.sum():.3e}, of spin populations '
          f'{spin.sum():.12f}, spin on the radical carbon {spin[0]:.6f}, '
          f'dipole (Debye) {mu.tolist()}')
    print(f'launches: {launches}')
    check(energies[-1] < energies[0], 'phenyl optimisation: the energy rose')
    check(mirror < 1e-6, f'phenyl optimisation broke the x-mirror: '
          f'{mirror:.3e} Bohr')
    check(planar < 1e-8, f'phenyl optimisation left the plane: '
          f'{planar:.3e} Bohr')
    check(abs(chg.sum()) < 1e-8, f'Mulliken charges sum to {chg.sum():.3e}')
    check(abs(spin.sum() - 1.0) < 1e-8,
          f'spin populations sum to {spin.sum():.12f}')
    for k in ('int1e_r', 'xc_uks_grad'):
        check(launches[k] > 0, f'phenyl optimisation: kernel {k} never '
              'launched')


# ---- wB97X-V: range-separated DF exchange and VV10 -------------------------

OMEGA = 0.3                 # wB97X-V's (pyscf_tpu_torch/dft/xc_funcs.py)
# FP64 operations per point pair of csrc/vv10.cu's loop (3 differences, r^2
# 5, g_i and g_j 4, the sum and product 3, one reciprocal, U, W and V 9)
VV10_PAIR_OPS = 25


def lr_integral_phases(pt, refs, kernels, report):
    """The erf(omega r)/r rows and metric at benzene's shapes against their
    twins (<= 1e-12 x max), and the long-range factor: B_LR from kernel and
    plain rows with the same whitener (<= 1e-10 x max)."""
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.ops.integrals import j3c

    mol = pt.M(atom=refs.BENZENE, basis='def2-svp', device='cuda')
    auxmol = make_auxmol(mol)
    classes = j3c.screened_pairs(mol)
    aux = j3c.aux_tables(auxmol)

    def rows(fn):
        return {cls: fn(*cls, *p, aux, OMEGA)
                for cls, (_, p) in classes.items()}

    rows_k, rows_p = rows(kernels.int3c2e), rows(j3c.int3c2e_plain)
    err, scale = max_abs([(rows_k[c], rows_p[c]) for c in rows_k])
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*a[1:]) for a in aux) + nbytes(*rows_k.values())
    record(report, 'int3c2e_lr', 'pyscf_tpu_torch/csrc/int3c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:188', err,
           lambda: rows(kernels.int3c2e), lambda: rows(j3c.int3c2e_plain),
           io, int3c2e_ops(classes, aux))
    check(err <= 1e-12 * scale, f'int3c2e_lr vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    jg_k = kernels.int2c2e(aux, OMEGA)
    jg_p = j3c.int2c2e_plain(aux, OMEGA)
    err, scale = max_abs([(jg_k, jg_p)])
    record(report, 'int2c2e_lr', 'pyscf_tpu_torch/csrc/int2c2e.cu',
           'pyscf_tpu/ops/integrals/j3c.py:266', err,
           lambda: kernels.int2c2e(aux, OMEGA),
           lambda: j3c.int2c2e_plain(aux, OMEGA),
           sum(nbytes(*a[1:]) for a in aux) + nbytes(jg_k), int2c2e_ops(aux))
    check(err <= 1e-12 * scale, f'int2c2e_lr vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')

    ev = torch.linalg.eigvalsh(jg_k)
    info = int(torch.linalg.cholesky_ex(jg_k)[1])
    kept = int((ev > j3c.LINEAR_DEP_THR).sum())
    print(f'(P|erf|Q) at omega {OMEGA}: eigenvalues {float(ev[0]):.3e} to '
          f'{float(ev[-1]):.3e}; Cholesky info {info}; whitener keeps '
          f'{kept} of {ev.shape[0]} (> {j3c.LINEAR_DEP_THR:g})')
    linv = j3c.whitener(jg_k)
    B_k = j3c.whitened_factor(mol, auxmol, rows_k, linv)
    B_p = j3c.whitened_factor(mol, auxmol, rows_p, linv)
    err, scale = max_abs([(B_k, B_p)])
    print(f'B_LR: max_abs_err {err:.3e} (same whitener), max |B_LR| '
          f'{scale:.3e}')
    check(err <= 1e-10 * scale, f'B_LR (kernels) vs B_LR (plain): {err:.3e} '
          f'> 1e-10 x {scale:.3e}')


def wb97xv_path(pt, refs, kernels, name, build, spin_names):
    """One wB97X-V SCF through the public entry points with its kernels
    launched; prints the energy, the phases with the long-range factor's
    (j2c_lr, j3c_lr) and the vv10 launches' seconds inside scf_loop from
    their CUDA events, and VV10's share of the loop."""
    names = ('int1e_stv', 'int3c2e', 'int2c2e', 'int3c2e_lr', 'int2c2e_lr',
             'eval_ao', 'becke', 'vv10') + spin_names
    mf, e, launches = run_path(name, kernels, names, build)
    t = mf.timings
    print(f'{name}: j2c_lr {t["j2c_lr"]:.4f} s  j3c_lr {t["j3c_lr"]:.4f} s  '
          f'vv10 {t["vv10"]:.4f} s in {launches["vv10"]} launches, '
          f'{t["vv10"] / t["scf_loop"]:.3f} of scf_loop; ngrid '
          f'{mf.grids.size}')
    return mf, e, launches


def benzene_wb97xv_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
        mf = pt.dft.RKS(mol, xc='wb97x-v').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = wb97xv_path(pt, refs, kernels,
                                  'DF-RKS wb97x-v benzene/def2-SVP', build,
                                  ('xc_rks',))
    check(np.isfinite(e) and mf.nlc == 'VV10', 'DF-RKS wb97x-v: no energy')
    return mf, launches


def phenyl_wb97xv_path(pt, refs, kernels):
    def build():
        mol = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
        mf = mol.UKS(xc='wb97x-v').density_fit()
        mf.conv_tol = 1e-8
        mf.init_guess = 'minao'
        return mf

    mf, e, launches = wb97xv_path(pt, refs, kernels,
                                  'DF-UKS wb97x-v phenyl/def2-SVP', build,
                                  ('xc_uks',))
    ss, mult = mf.spin_square()
    print(f'DF-UKS wb97x-v phenyl: <S^2> {ss!r}  2S+1 {mult!r}')
    check(np.isfinite(e) and abs(ss - 0.75) < 0.1,
          f'DF-UKS wb97x-v phenyl: E {e!r}, <S^2> {ss!r}')
    return mf, launches


def vv10_phase(kernels, mf, report):
    """kernel vv10 at benzene's converged wB97X-V density on its whole grid
    against the twin: E <= 1e-11 relative, dE/drho and dE/dg2 <= 1e-11 x
    their largest magnitude."""
    from pyscf_tpu_torch.dft import vv10

    aods, wblocks = mf._numint.grid_ao(mf.mol, mf.grids, 1)
    rho, g2, _ = vv10.density_features(aods, mf.make_rdm1())
    del aods
    args = (rho, g2, mf.grids.coords, torch.cat(wblocks), mf.nlc_b,
            mf.nlc_C)
    e_k, dr_k, dg_k = kernels.vv10(*args)
    e_p, dr_p, dg_p = vv10.vv10_plain(*args)
    rel_e = abs(float(e_k - e_p)) / abs(float(e_p))
    err_r, scale_r = max_abs([(dr_k, dr_p)])
    err_g, scale_g = max_abs([(dg_k, dg_p)])
    n = rho.shape[0]
    m = int((rho > vv10.RHO_CUT).sum())
    print(f'vv10: {n} points, {m} above RHO_CUT ({m * m:.4e} pairs); E_nlc '
          f'{float(e_k):.12f} (rel diff {rel_e:.2e}); dE/drho {err_r:.3e} of '
          f'{scale_r:.3e}; dE/dg2 {err_g:.3e} of {scale_g:.3e}')
    # inputs read once (coords, rho, g2, weights: 48 B per point) and the
    # three outputs (24 B per point); the pair loop over the unmasked
    # points, plus ~60 operations per point for its features and epilogue
    record(report, 'vv10', 'pyscf_tpu_torch/csrc/vv10.cu',
           'pyscf_tpu/dft/vv10.py:25', max(err_r, err_g),
           lambda: kernels.vv10(*args), lambda: vv10.vv10_plain(*args),
           72 * n, VV10_PAIR_OPS * float(m) * m + 60 * n, plain_reps=1)
    check(rel_e <= 1e-11, f'vv10 E vs plain: {rel_e:.2e} > 1e-11')
    check(err_r <= 1e-11 * scale_r and err_g <= 1e-11 * scale_g,
          f'vv10 derivatives vs plain: {err_r:.3e} of {scale_r:.3e}, '
          f'{err_g:.3e} of {scale_g:.3e} > 1e-11')


def water_rsh_references(pt, refs, kernels):
    """Water's DF-RKS camb3lyp and wb97x-v, the cation's DF-UKS wb97x-v and
    water's in-core RKS wb97x-v (def2-SVP, level-1 grids, conv_tol 1e-10)
    within 1e-8 of the recorded JAX energies; returns the launches of the
    in-core run (int2e_lr)."""
    cases = [('DF-RKS camb3lyp', 'camb3lyp', 0, True,
              refs.E_WATER_DF_RKS_CAMB3LYP_L1),
             ('DF-RKS wb97x-v', 'wb97x-v', 0, True,
              refs.E_WATER_DF_RKS_WB97XV_L1),
             ('DF-UKS wb97x-v cation', 'wb97x-v', 1, True,
              refs.E_WATER_CATION_DF_UKS_WB97XV_L1),
             ('in-core RKS wb97x-v', 'wb97x-v', 0, False,
              refs.E_WATER_RKS_WB97XV_L1)]
    for name, xc_code, spin, df, ref in cases:
        kernels.reset_launches()
        mol = pt.M(atom=refs.WATER, basis='def2-svp', charge=spin, spin=spin)
        mf = mol.UKS(xc=xc_code) if spin else mol.RKS(xc=xc_code)
        if df:
            mf = mf.density_fit()
        mf.grids.level = 1
        mf.conv_tol = 1e-10
        e = mf.kernel()
        launches = kernels.launches()
        print(f'water {name}: E - E_ref = {e - ref:.3e}  converged '
              f'{mf.converged}  cycles {mf.scf_cycles}')
        check(mf.converged and abs(e - ref) < 1e-8,
              f'water {name}: |E - E_ref| = {abs(e - ref):.3e}')
        lr = ('int3c2e_lr', 'int2c2e_lr') if df else ('int2e_lr',)
        for k in lr + (('vv10',) if xc_code == 'wb97x-v' else ()):
            check(launches[k] > 0, f'water {name}: kernel {k} never '
                  'launched')
    return launches


# ---- post-HF: MP2, UMP2, CCSD and CCSD(T) -----------------------------------

def tight_scf(mf):
    """The post-HF references' SCF: minao, conv_tol 1e-12, conv_tol_grad
    1e-9 (pyscf_tpu_torch/refs.py)."""
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    return mf


def host_s(fn):
    """(fn(), seconds) on the host clock, ended by a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def postscf_path(name, kernels, build, e_refs):
    """SCF, mf.MP2().kernel(), mf.CCSD().kernel() and ccsd_t() of benzene
    through the entry points, with the launch counts set to 0 just before
    and read just after; the converged energies against the recorded JAX
    ones (1e-8 Ha); then warm repeats of MP2 and (T), not counted.
    Returns (mf, mycc, launches)."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mf, scf_s = host_s(lambda: tight_scf(build()).run())
    (e_mp2, _), mp2_s = host_s(lambda: mf.MP2().kernel())
    mycc = mf.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    (e_cc, _, _), cc_s = host_s(mycc.kernel)
    e_t, t_s = host_s(mycc.ccsd_t)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, mp2_warm = host_s(lambda: mf.MP2().kernel())
    _, t_warm = host_s(mycc.ccsd_t)
    cyc = mycc.timings['cycles']
    print(f'{name}: E_SCF {mf.e_tot!r} ({mf.scf_cycles} cycles, {scf_s:.3f} '
          f's)  E_MP2 {e_mp2!r}  E_CCSD {e_cc!r} ({mycc.cycles} cycles)  '
          f'E_(T) {e_t!r}')
    print(f'{name} seconds: ao2mo (CCSD blocks) {mycc.timings["eris"]:.4f}  '
          f'MP2 {mp2_s:.4f} (warm {mp2_warm:.4f})  CCSD {cc_s:.4f}: per '
          f'cycle median {np.median(cyc):.4f} (first {cyc[0]:.4f}, min '
          f'{min(cyc):.4f}, max {max(cyc):.4f})  (T) {t_s:.4f} (warm '
          f'{t_warm:.4f})  SCF to (T) {scf_s + mp2_s + cc_s + t_s:.3f}  '
          f'peak device memory {peak:.3f} GB')
    print(f'launches: {launches}')
    check(mf.converged and mycc.converged, f'{name}: SCF converged '
          f'{mf.converged}, CCSD converged {mycc.converged}')
    for what, e, ref in zip(('MP2', 'CCSD', '(T)'), (e_mp2, e_cc, e_t),
                            e_refs):
        print(f'{name} {what}: E - E_ref = {e - ref:.3e}')
        check(abs(e - ref) < 1e-8, f'{name} {what}: |E - E_ref| = '
              f'{abs(e - ref):.3e} >= 1e-8')
    for k in ('mp2_energy', 'ccsd_t'):
        check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return mf, mycc, launches


def incore_postscf_path(pt, refs, kernels):
    return postscf_path(
        'in-core CCSD(T) benzene/def2-SVP', kernels,
        lambda: pt.M(atom=refs.BENZENE, basis='def2-svp').RHF(),
        (refs.E_BENZENE_MP2_DEF2SVP, refs.E_BENZENE_CCSD_DEF2SVP,
         refs.E_BENZENE_CCSD_T_DEF2SVP))


def df_postscf_path(pt, refs, kernels):
    return postscf_path(
        'DF-CCSD(T) benzene/def2-SVP', kernels,
        lambda: pt.M(atom=refs.BENZENE, basis='def2-svp').RHF()
        .density_fit(),
        (refs.E_BENZENE_DF_MP2_DEF2SVP, refs.E_BENZENE_DF_CCSD_DEF2SVP,
         refs.E_BENZENE_DF_CCSD_T_DEF2SVP))


def ccsd_t_phase(kernels, mycc, report):
    """The `ccsd_t` kernel at the converged CCSD's tensors over every a >=
    b >= c against its batched twin (once), 1e-10 relative, and with its
    vvov slices staged in f tiles of 32 against the untiled run, 1e-12
    relative; and on seeded tensors whose triples hold all three
    multiplicities, untiled and in f tiles of 4, 1e-12 relative."""
    from types import SimpleNamespace

    from pyscf_tpu_torch.cc import ccsd_t
    nocc, nvir = mycc.t1.shape

    def tiled(args, ft):
        """kernels.ccsd_t with the shared memory capped to f tiles of ft."""
        no = args[-2].shape[0]
        full = kernels.CCSD_T_MAX_SMEM
        kernels.CCSD_T_MAX_SMEM = 48 * no * (ft + no)
        try:
            return kernels.ccsd_t(*args)
        finally:
            kernels.CCSD_T_MAX_SMEM = full

    args = ccsd_t.kernel_args(mycc._eris, mycc.t1, mycc.t2)
    got = kernels.ccsd_t(*args)
    ref, plain_s = host_s(lambda: ccsd_t.et_plain(*args))
    err = abs(float(got - ref))
    tgot, tiled_s = host_s(lambda: tiled(args, 32))
    terr = abs(float(tgot - got)) / abs(float(got))
    print(f'ccsd_t: {len(args[0])} triples, nocc {nocc}, nvir {nvir}: '
          f'kernel {2 * float(got)!r}, twin {2 * float(ref)!r}, relative '
          f'{err / abs(float(ref)):.3e}; f tiles of 32 against untiled '
          f'{terr:.3e} ({tiled_s:.4f} s)')
    check(err <= 1e-10 * abs(float(ref)), f'ccsd_t vs plain: {err:.3e} > '
          f'1e-10 x {abs(float(ref)):.3e}')
    check(terr <= 1e-12, f'ccsd_t tiled vs untiled: {terr:.3e} > 1e-12')
    rng = np.random.default_rng(8)
    no, nv = 5, 9
    card = [torch.as_tensor(a, device='cuda') for a in (
        rng.standard_normal((no, nv, nv, nv)) * 0.1,
        rng.standard_normal((no, no, no, nv)) * 0.1,
        rng.standard_normal((no, nv, no, nv)) * 0.1,
        rng.standard_normal((no, no, nv, nv)) * 0.05,
        rng.standard_normal((no, nv)) * 0.02,
        np.concatenate([-0.5 - rng.random(no) * 20,
                        0.2 + rng.random(nv) * 3]))]
    seeded = SimpleNamespace(ovvv=card[0], ooov=card[1], ovov=card[2],
                             mo_energy=card[5])
    sargs = ccsd_t.kernel_args(seeded, card[4], card[3])
    check(set(sargs[1].tolist()) == {1.0, 2.0, 6.0},
          'seeded triples lack a multiplicity')
    sref = ccsd_t.et_plain(*sargs)
    serr = [abs(float(e - sref)) / abs(float(sref))
            for e in (kernels.ccsd_t(*sargs), tiled(sargs, 4))]
    print(f'ccsd_t seeded (nocc {no}, nvir {nv}, {len(sargs[0])} triples): '
          f'relative {serr[0]:.3e}, in f tiles of 4 {serr[1]:.3e}')
    check(max(serr) <= 1e-12, f'ccsd_t seeded vs plain: {max(serr):.3e} > '
          f'1e-12')
    # the w builds: 2 FMA operations x o^3 (v + o) per ordering and triple,
    # small matrix products that the FP64 tensor cores can run
    ops = 12.0 * nocc ** 3 * (nvir + nocc) * len(args[0])
    record(report, 'ccsd_t', 'pyscf_tpu_torch/csrc/ccsd_t.cu',
           'pyscf_tpu/cc/ccsd_t.py:70', err, lambda: kernels.ccsd_t(*args),
           plain_s * 1e3, nbytes(*args), ops,
           peak=FP64_TC_FLOPS)


def mp2_energy_phase(kernels, mf, report):
    """The `mp2_energy` kernel at benzene's (ia|jb) against its twin: the
    amplitudes to 1e-13 of their largest, both sums to 1e-12 relative."""
    from pyscf_tpu_torch.mp.mp2 import mp2_energy_plain
    mp = mf.MP2()
    ovov = mp.get_ovov()
    eia = mp._orbitals()[2].contiguous()
    got = kernels.mp2_energy(ovov, eia, eia)
    ref = mp2_energy_plain(ovov, eia, eia)
    err, scale = max_abs([(got[0], ref[0])])
    rel = [abs(float(a - b)) / abs(float(b)) for a, b in zip(got[1:],
                                                             ref[1:])]
    print(f'mp2_energy: ovov {tuple(ovov.shape)} ({nbytes(ovov) / 1e6:.1f} '
          f'MB): t2 {err:.3e} of max {scale:.3e}, sums relative {rel[0]:.3e}'
          f', {rel[1]:.3e}')
    check(err <= 1e-13 * scale, f'mp2_energy t2 vs plain: {err:.3e} > '
          f'1e-13 x {scale:.3e}')
    check(max(rel) <= 1e-12, f'mp2_energy sums vs plain: {max(rel):.3e}')
    # per element: the denominator and the divide, twice (the exchange
    # partner), and the two multiply-adds
    record(report, 'mp2_energy', 'pyscf_tpu_torch/csrc/mp2_energy.cu',
           'pyscf_tpu/mp/mp2.py:11', err,
           lambda: kernels.mp2_energy(ovov, eia, eia),
           lambda: mp2_energy_plain(ovov, eia, eia),
           2 * nbytes(ovov) + nbytes(eia), 8.0 * ovov.numel())


def ump2_path(pt, refs, kernels):
    """The water cation's in-core UHF/def2-SVP then mf.MP2() (UMP2) against
    the recorded JAX energy and its os/ss split (1e-8 Ha), mp2_energy
    launched; then the phenyl radical's (minao, conv_tol 1e-8), printed
    with its time and its SCF's state."""
    kernels.reset_launches()
    mol = pt.M(atom=refs.WATER, basis='def2-svp', charge=1, spin=1)
    mf = tight_scf(mol.UHF()).run()
    mp = mf.MP2()
    e = mp.kernel()[0]
    launches = kernels.launches()
    os_ref, ss_ref = refs.E_WATER_CATION_UMP2_OS_SS_DEF2SVP
    de = np.array([e - refs.E_WATER_CATION_UMP2_DEF2SVP,
                   mp.e_corr_os - os_ref, mp.e_corr_ss - ss_ref])
    print(f'water cation UMP2: E {e!r}, E - E_ref (total, os, ss) {de}')
    check(mf.converged and np.max(np.abs(de)) < 1e-8,
          f'water cation UMP2: |E - E_ref| {np.max(np.abs(de)):.3e}')
    check(launches['mp2_energy'] == 3, 'UMP2: mp2_energy not launched once '
          'per spin block')
    # the phenyl radical's UHF/def2-SVP does not converge from minao, in
    # the JAX package either (ROADMAP section 3): its UMP2 at the last
    # cycle's orbitals is printed for the time at this width, not checked
    mf = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1).UHF()
    mf.conv_tol = 1e-8
    mf.init_guess = 'minao'
    mf.kernel()
    (e, _), s = host_s(lambda: mf.MP2().kernel())
    (e2, _), s2 = host_s(lambda: mf.MP2().kernel())
    print(f'phenyl UMP2/def2-SVP (in-core UHF: converged {mf.converged} in '
          f'{mf.scf_cycles} cycles, <S^2> {mf.spin_square()[0]:.4f}): E_UHF '
          f'{mf.e_tot!r} E_UMP2 {e!r} ({s:.4f} s, warm {s2:.4f} s)')
    check(np.isfinite(e) and e < 0.0 and abs(e - e2) < 1e-12,
          'phenyl UMP2 not finite or not repeatable')


# ---- excited states: TDA, TDHF and TDDFT ------------------------------------

EV = 27.2114                  # tests/test_tdscf_extras.py
TD_NSTATES = 5
# the TDA's Davidson states at benzene: its seeds, the argsort of the
# orbital-energy differences, are then exactly the four degenerate HOMO ->
# LUMO pairs (e1g x e2u = B1u + B2u + E1u). The diagonal preconditioner
# keeps the point group, so the solver reaches no symmetry its seeds lack,
# and five seeds cut the next degenerate set of pairs: it then returns the
# lowest states of the seeded symmetries, not the five lowest (ROADMAP
# section 3, a property of the reference's solver)
TDA_NSTATES = 4
# the dense TDA's states among which each Davidson state is found
TD_DENSE_STATES = 40
# points per call of the xc_fxc twin, whose vmapped Hessian keeps every
# intermediate of the functional per point
FXC_PLAIN_CHUNK = 16384


def plain_fxc(aod, dmao, weights, xc, singlet=True):
    """numint.xc_fxc_plain over chunks of FXC_PLAIN_CHUNK points."""
    from pyscf_tpu_torch.dft import numint
    n = weights.shape[0]
    return torch.cat([
        numint.xc_fxc_plain(aod[:, i:i + FXC_PLAIN_CHUNK],
                            dmao[:, i:i + FXC_PLAIN_CHUNK],
                            weights[i:i + FXC_PLAIN_CHUNK], xc, singlet)
        for i in range(0, n, FXC_PLAIN_CHUNK)])


@contextlib.contextmanager
def fxc_twins(kernels):
    """kernels.xc_fxc and xc_fxc_pairs replaced by their plain twins (on the
    card's tensors), so that the same A is built both ways."""
    from pyscf_tpu_torch.dft import numint
    saved = kernels.xc_fxc, kernels.xc_fxc_pairs
    kernels.xc_fxc, kernels.xc_fxc_pairs = plain_fxc, numint.xc_fxc_pairs_plain
    try:
        yield
    finally:
        kernels.xc_fxc, kernels.xc_fxc_pairs = saved


def degenerate_sums(e, f, tol=1e-6):
    """f summed over the sets of states whose energies lie within tol Ha."""
    sums, start = [], 0
    for i in range(1, len(e) + 1):
        if i == len(e) or e[i] - e[i - 1] > tol:
            sums.append(float(np.sum(f[start:i])))
            start = i
    return np.array(sums)


def tdscf_benzene_path(pt, refs, kernels):
    """Benzene DF-RKS b3lypg/def2-SVP (minao, conv_tol 1e-10, conv_tol_grad
    1e-7) from M(), then mf.TDA() singlets (Davidson: nov 1953 is above
    dense_cutoff) and triplets, TDA_NSTATES each, and mf.TDDFT() singlets
    (dense), TD_NSTATES, with the launch counts set to 0 just before and
    read just after; then the dense TDA (dense_cutoff raised) of both spin
    kinds: each Davidson energy within 1e-7 Ha of the nearest dense
    eigenvalue not taken by a lower one, the lower dense states it does
    not reach printed (the
    JAX package's benzene TDA could not be recorded: its P and HP alone
    take 9 GB each), and the oscillator strengths of those states summed
    over degenerate sets within 1e-3 of the largest. Returns (mf,
    launches)."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
    mf = pt.dft.RKS(mol, xc='b3lypg').density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-10
    mf.conv_tol_grad = 1e-7
    mf.run()
    torch.cuda.synchronize()
    scf_s = time.perf_counter() - t0
    tda = {}
    for singlet in (True, False):
        td = mf.TDA()
        td.singlet = singlet
        e, s = host_s(lambda: td.kernel(nstates=TDA_NSTATES))
        tda[singlet] = (td, e, s)
    rpa = mf.TDDFT()
    e_rpa, rpa_s = host_s(lambda: rpa.kernel(nstates=TD_NSTATES))
    f_rpa = rpa.oscillator_strength()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    nocc, nvir = (int((mf.mo_occ > 0).sum()), int((mf.mo_occ == 0).sum()))
    print(f'TDDFT benzene DF-RKS b3lypg/def2-SVP: E_SCF {mf.e_tot!r} '
          f'({mf.scf_cycles} cycles, {scf_s:.3f} s from M()), nocc {nocc} '
          f'nvir {nvir} nov {nocc * nvir}, ngrid {mf.grids.size}')
    for singlet in (True, False):
        td, e, s = tda[singlet]
        print(f'TDA {"singlet" if singlet else "triplet"} (Davidson): '
              f'{s:.4f} s, {td.cycles} iterations, {td.nmatvec} matvecs, '
              f'converged {td.converged}; E (eV) {(e * EV).tolist()}')
    print(f'TDDFT singlet (dense RPA): {rpa_s:.4f} s (get_ab '
          f'{rpa.timings["get_ab"]:.4f} s, eigh {rpa.timings["eigh"]:.4f} '
          f's); E (eV) {(e_rpa * EV).tolist()}; f {f_rpa.tolist()}')
    print(f'TDDFT path: wall from M() {wall:.3f} s, peak device memory '
          f'{peak:.3f} GB')
    print(f'launches: {launches}')
    check(mf.converged, 'benzene DF-RKS did not converge')
    for k in ('xc_rks_fxc', 'xc_uks_fxc', 'xc_fxc', 'xc_fxc_pairs'):
        check(launches[k] > 0, f'benzene TDDFT: kernel {k} never launched')
    check(np.all(np.isfinite(e_rpa)) and e_rpa.shape == (TD_NSTATES,)
          and np.all(np.diff(e_rpa) >= 0) and e_rpa[0] > 0,
          'TDDFT energies not finite, positive and ascending')
    for singlet in (True, False):
        td, e, _ = tda[singlet]
        dense = mf.TDA()
        dense.singlet = singlet
        dense.dense_cutoff = 10 ** 6
        e_d, s = host_s(lambda: dense.kernel(nstates=TD_DENSE_STATES))
        # each Davidson state against the nearest dense eigenvalue not
        # taken by a lower one (a near-degenerate pair maps to both)
        idx = []
        for x in e:
            dist = np.abs(e_d - x)
            dist[idx] = np.inf
            idx.append(int(np.argmin(dist)))
        de = float(np.max(np.abs(e - e_d[idx])))
        missed = [float(x) * EV for k, x in enumerate(e_d[:max(idx) + 1])
                  if k not in idx]
        kind = 'singlet' if singlet else 'triplet'
        print(f'TDA {kind} dense ({s:.4f} s, get_ab '
              f'{dense.timings["get_ab"]:.4f} s): E (eV) '
              f'{(e_d[:TD_NSTATES + 2] * EV).tolist()}; the Davidson states '
              f'are dense states {idx}, within {de:.3e} Ha; lower dense '
              f'states of symmetries its seeds lack (eV): {missed}')
        check(td.converged and de < 1e-7,
              f'TDA {kind}: Davidson vs dense {de:.3e} >= 1e-7 Ha')
        if singlet:
            fs = [degenerate_sums(e, f) for f in (
                td.oscillator_strength(), dense.oscillator_strength()[idx])]
            df = float(np.max(np.abs(fs[0] - fs[1])))
            print(f'TDA singlet oscillator strengths over degenerate sets: '
                  f'{fs[1].tolist()} (Davidson - dense {df:.3e})')
            # the solver stops once its Ritz values settle with residuals
            # under sqrt(conv_tol) = 1e-4, so its vectors, and f, carry
            # errors of that order
            check(df < 1e-3 * float(np.max(fs[1])), f'TDA oscillator '
                  f'strengths: {df:.3e} >= 1e-3 x {float(np.max(fs[1])):.3e}')
    return mf, launches


def fxc_phases(kernels, mf, report, suffix='',
               tangents=('xc_rks_fxc', 'xc_uks_fxc')):
    """The response kernels xc_fxc, xc_fxc_pairs and `tangents` (recorded
    as <kernel><suffix>) at the converged benzene DF-RKS density on its
    whole grid, each against its plain twin on the card: xc_fxc
    (singlet kernel) <= 1e-10 x max|H|; xc_fxc_pairs on one chunk of the
    size get_ab uses <= 1e-10 x max; xc_rks_fxc and xc_uks_fxc along five
    seeded transition densities (the Davidson's first batch) <= 1e-10 x
    max|dvtmp|; and the A_xc GEMM of that chunk timed."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.tdscf import rhf as tdrhf

    f = mf.xc_obj
    aods, wblocks = mf._numint.grid_ao(mf.mol, mf.grids, 1)
    check(len(aods) == 1, 'the benzene grid does not fit one block')
    aod, w = aods[0], wblocks[0]
    npts, nao = w.shape[0], aod.shape[-1]
    dm = mf.make_rdm1()
    dmao = (aod[0] @ dm)[None]
    h_k = kernels.xc_fxc(aod, dmao, w, f)
    h_p, plain_s = host_s(lambda: plain_fxc(aod, dmao, w, f))
    err, scale = max_abs([(h_k, h_p)])
    print(f'xc_fxc{suffix} ({mf.xc}): {npts} points, max|H| {scale:.3e}, '
          f'twin {plain_s:.3f} s')
    # reductions of rho and grad rho (8 per point and AO) and the 8x8
    # chain rule (1040 per point); the functional's tens of thousands per
    # point on second-order dual numbers are not counted
    record(report, f'xc_fxc{suffix}', 'pyscf_tpu_torch/csrc/xc_fxc.cu',
           'pyscf_tpu/tdscf/rhf.py:96', err,
           lambda: kernels.xc_fxc(aod, dmao, w, f), plain_s * 1e3,
           nbytes(aod, dmao, w, h_k), 8.0 * npts * nao + 1040.0 * npts)
    check(err <= 1e-10 * scale, f'xc_fxc vs plain: {err:.3e} > 1e-10 x '
          f'{scale:.3e}')
    del h_p

    co, cv = tdrhf._orbitals(mf)[:2]
    nov = co.shape[1] * cv.shape[1]
    step = tdrhf.pair_step(npts, 8 * nov, w.device)
    blk = aod[:, :step]
    oo, ov = torch.matmul(blk, co), torch.matmul(blk, cv)
    hs = h_k[:step]
    got = kernels.xc_fxc_pairs(oo, ov, hs, (0,))
    ref = numint.xc_fxc_pairs_plain(oo, ov, hs, (0,))
    err, scale = max_abs(list(zip(got, ref)))
    del ref
    print(f'xc_fxc_pairs: a chunk of {step} points x {nov} pairs, P and HP '
          f'{2 * nbytes(got[0]) / 1e9:.3f} GB, {-(-npts // step)} chunks '
          f'per grid')
    # P: 10 operations per point and pair, H P: 28
    record(report, f'xc_fxc_pairs{suffix}', 'pyscf_tpu_torch/csrc/xc_fxc.cu',
           'pyscf_tpu/tdscf/rhf.py:130', err,
           lambda: kernels.xc_fxc_pairs(oo, ov, hs, (0,)),
           lambda: numint.xc_fxc_pairs_plain(oo, ov, hs, (0,)),
           nbytes(oo, ov, hs, *got), 38.0 * step * nov)
    check(err <= 1e-10 * scale, f'xc_fxc_pairs vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')
    P, HP = got
    gemm_ms = cuda_ms(lambda: P.reshape(-1, nov).T @ HP[0].reshape(-1, nov))
    flops = 2.0 * nov * nov * 4 * step
    print(f'A_xc GEMM of one chunk (cuBLAS): {gemm_ms:.3f} ms, '
          f'{flops / gemm_ms / 1e9:.1f} TFLOP/s; the whole grid '
          f'{flops * npts / step / 1e12:.2f} TFLOP')
    del P, HP, got, oo, ov

    rng = np.random.default_rng(19)
    z = torch.as_tensor(rng.standard_normal((5, co.shape[1], cv.shape[1])),
                        device='cuda')
    ddm = co @ z @ cv.T
    ddm = ddm + ddm.transpose(1, 2)
    d0, d1 = dmao[0], torch.matmul(aod[0], ddm)
    for name, args, ops, replaces in (
            ('xc_rks_fxc', (aod, d0, d1, w, f), (8.0 + 16.0 * 5) * npts * nao,
             'pyscf_tpu/tdscf/rhf.py:218'),
            ('xc_uks_fxc', (aod, torch.stack([0.5 * d0, 0.5 * d0]),
                            torch.stack([0.5 * d1, -0.5 * d1], dim=1)
                            .contiguous(), w, f),
             (16.0 + 32.0 * 5) * npts * nao, 'pyscf_tpu/tdscf/rhf.py:237')):
        if name in tangents:
            tangent_fxc_phase(kernels, report, name, name + suffix, args,
                              ops, replaces)


def tangent_fxc_phase(kernels, report, kernel, name, args, ops, replaces):
    """The tangent response kernel `kernel` (xc_rks_fxc or xc_uks_fxc) on
    args against its plain twin: <= 1e-10 x max|dvtmp|; recorded as name
    with ops, its reductions (8 per point and AO per density) and rows (8
    per point and AO per output); the functional is not counted."""
    from pyscf_tpu_torch.dft import numint

    fn, plain = getattr(kernels, kernel), getattr(numint, kernel + '_plain')
    got, ref = fn(*args), plain(*args)
    err, scale = max_abs([(got, ref)])
    del ref
    record(report, name, f'pyscf_tpu_torch/csrc/{kernel}.cu', replaces, err,
           lambda: fn(*args), lambda: plain(*args), nbytes(*args[:-1], got),
           ops)
    check(err <= 1e-10 * scale, f'{name} vs plain: {err:.3e} > 1e-10 x '
          f'{scale:.3e}')


def tdscf_phenyl_path(pt, refs, kernels):
    """The phenyl radical's DF-UKS b3lypg/def2-SVP (minao, conv_tol 1e-10,
    conv_tol_grad 1e-7), then tdscf.TDAUKS(mf).kernel(nstates=5) (dense,
    in-core ERIs as in the reference) with its time and peak memory, xc_fxc
    and xc_fxc_pairs launched; then the same A with the plain twins of
    both on the card: the five lowest eigenvalues within 1e-8 Ha (no JAX
    reference at this width)."""
    from pyscf_tpu_torch.tdscf import uhf as tduhf
    mol = pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1)
    mf = mol.UKS(xc='b3lypg').density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-10
    mf.conv_tol_grad = 1e-7
    mf.run()
    check(mf.converged, 'phenyl DF-UKS did not converge')
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    td = pt.tdscf.TDAUKS(mf)
    e, s = host_s(lambda: td.kernel(nstates=TD_NSTATES))
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, s2 = host_s(lambda: pt.tdscf.TDAUKS(mf).kernel(nstates=TD_NSTATES))
    a_k, dims = tduhf.get_ab_uhf(mf)
    with fxc_twins(kernels):
        a_p, _ = host_s(lambda: tduhf.get_ab_uhf(mf)[0])
    err, scale = max_abs([(a_k, a_p)])
    w_k = torch.linalg.eigvalsh(a_k)[:TD_NSTATES].cpu().numpy()
    w_p = torch.linalg.eigvalsh(a_p)[:TD_NSTATES].cpu().numpy()
    dw = float(np.max(np.abs(w_k - w_p)))
    print(f'TDA-UKS phenyl DF-UKS b3lypg/def2-SVP: dims {dims} (ntot '
          f'{sum(dims)}), {s:.3f} s (again {s2:.3f} s), peak device memory '
          f'{peak:.3f} GB; E (eV) {(e * EV).tolist()}')
    print(f'TDA-UKS A with kernels vs plain twins: max|dA| {err:.3e} of '
          f'{scale:.3e}; lowest eigenvalues differ by {dw:.3e} Ha')
    print(f'launches: {launches}')
    for k in ('xc_fxc', 'xc_fxc_pairs', 'int2e'):
        check(launches[k] > 0, f'phenyl TDA-UKS: kernel {k} never launched')
    check(np.all(np.isfinite(e)) and float(np.max(np.abs(e - w_k))) < 1e-12,
          'TDA-UKS energies not finite or not those of its A')
    check(dw < 1e-8, f'TDA-UKS eigenvalues kernels vs twins {dw:.3e} >= '
          '1e-8 Ha')


# PySCF's goldens, tdscf/test/test_tdrhf.py:41-74 (eV)
TD_GOLDENS = {
    ('TDA', True): [11.90276464, 11.90276464, 16.86036434],
    ('TDA', False): [11.01747918, 11.01747918, 13.16955056],
    ('TDHF', True): [11.83487199, 11.83487199, 16.66309285],
    ('TDHF', False): [10.8919234, 10.8919234, 12.63440705],
}


def tdscf_goldens(pt):
    """HF/6-31G in-core RHF on the card (hcore, conv_tol 1e-12): TDA and
    TDHF singlets and triplets within 1e-4 eV of PySCF's goldens."""
    mf = pt.M(atom='H 0 0 .917; F 0 0 0', basis='6-31g').RHF()
    mf.init_guess = 'hcore'
    mf.conv_tol = 1e-12
    mf.run()
    check(mf.converged, 'HF/6-31G RHF did not converge')
    for (method, singlet), ref in TD_GOLDENS.items():
        td = getattr(mf, method)()
        td.singlet = singlet
        e = td.kernel(nstates=5) * EV
        de = float(np.max(np.abs(e[:3] - ref)))
        print(f'HF/6-31G {method} {"singlet" if singlet else "triplet"}: '
              f'{e[:3].tolist()} eV, golden - port {de:.2e} eV')
        check(de < 1e-4, f'HF/6-31G {method}: {de:.2e} eV >= 1e-4')

# ---- the analytic DF-RHF Hessian --------------------------------------------

HESS_KERNELS = ('int1e_ipip', 'int3c2e_ip1', 'int2c2e_ip1_full',
                'int3c2e_ipip', 'int2c2e_ipip')
HESS_PHASES = ('s1h1', 'ip1_3c', 'F1', 'cphf', 'rows_1e', 'rows_df',
               'rows_3c', 'rows_2c')
# the kernels of the DF-RHF Hessian's path
HESS_PATH_KERNELS = HESS_KERNELS + ('int1e_ip', 'int1e_iprinv')


def hess_terms_ops(la, lb, with_a):
    """csrc/hess2.cuh hess_terms per cartesian component pair: the shifted
    Hermite sums (2 operations a term) of CC, and with the bra's
    derivatives of AC (raised and lowered) and AA (two steps)."""
    t0 = _herm_terms(la, lb)
    ops = 6 * t0
    if with_a:
        ops += 3 * (_herm_terms(la + 1, lb)
                    + (_herm_terms(la - 1, lb) if la else 0))
        ops += 2 * (_herm_terms(la + 2, lb) + t0
                    + (_herm_terms(la - 2, lb) if la > 1 else 0))
    return 2 * ops


def coulomb_ipip_ops(la, lb, lc, pair_prims, nthreads_per_pair, triples,
                     with_a=True):
    """csrc/coulomb_ipip.cuh coulomb_ipip_block: per bra primitive pair
    (and thread) the E tables (to la + 2 with the bra's derivatives), per
    cartesian component pair the weights' contraction of Y and the
    shifted sums; per primitive triple R_tuv to order la + lb + lc + 2 and
    the fold into Y to order la + lb + 2."""
    l1 = la + lb
    ncomp = len(_carts(la)) * len(_carts(lb))
    per_pair = (3 * _e1d_ops(la + 2 * with_a, lb)
                + ncomp * 2 * _ntuv(l1 + 2) * (2 * lc + 1)
                + hess_terms_ops(la, lb, with_a))
    per_triple = _r_ops(l1 + lc + 2) + _ket_ops(lc, l1 + 2)
    return pair_prims * nthreads_per_pair * per_pair + triples * per_triple


def coulomb_ip1_ops(la, lb, lc, pair_prims, nthreads_per_pair, triples):
    """csrc/coulomb_ipip.cuh coulomb_ip1_block: per bra primitive pair the
    E tables to la + 1 and the raised and lowered bra contraction with Y;
    per primitive triple R_tuv to order la + lb + lc + 1 and the fold."""
    per_pair = (3 * _e1d_ops(la + 1, lb)
                + _bra_terms(la, lb, True) * 2 * (2 * lc + 1))
    per_triple = _r_ops(la + lb + lc + 1) + _ket_ops(lc, la + lb + 1)
    return pair_prims * nthreads_per_pair * per_pair + triples * per_triple


def ipip_1e_ops(la, lb, pairs, natm):
    """csrc/int1e_ipip.cu per primitive pair and slot: the E tables to
    (la + 2, lb + 2), per charge R_tuv to order la + lb + 2 and
    hess_terms per component pair; S and T's 1D factors (about 60
    operations a component pair and direction)."""
    ncomp = len(_carts(la)) * len(_carts(lb))
    ops = (natm + 1) * 3 * _e1d_ops(la + 2, lb + 2)
    ops += natm * (_r_ops(la + lb + 2) + _ntuv(la + lb + 2)
                   + ncomp * hess_terms_ops(la, lb, True))
    ops += ncomp * (3 * 60 + 9 * 12)
    return float(_prim_pairs(pairs).sum()) * ops


@contextlib.contextmanager
def plain_kernels(kernels, names):
    """The named derivative and Hessian kernel wrappers replaced by their
    plain twins on the card's tensors, so that the same gradient or Hessian
    is built both ways."""
    from pyscf_tpu_torch.ops.integrals import int1e_deriv, int2e, j3c_deriv

    twin = {'int1e_ip': int1e_deriv.class_ip,
            'int1e_iprinv': int1e_deriv.class_iprinv,
            'int2e_ip1': int2e.int2e_ip1_class_plain,
            'int3c2e_ip': j3c_deriv.int3c2e_ip_plain,
            'int2c2e_ip1': j3c_deriv.int2c2e_ip1_plain,
            'int1e_ipip': int1e_deriv.class_ipip,
            'int3c2e_ip1': j3c_deriv.int3c2e_ip1_plain,
            'int2c2e_ip1_full': j3c_deriv.int2c2e_ip1_full_plain,
            'int3c2e_ipip': j3c_deriv.int3c2e_ipip_plain,
            'int2c2e_ipip': j3c_deriv.int2c2e_ipip_plain}
    saved = {k: getattr(kernels, k) for k in names}
    for k in names:
        setattr(kernels, k, twin[k])
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)


def ip1_all(fn, mol, classes, aux):
    """d(ij|P)/dA_i of every ordered shell pair through fn (int3c2e_ip1 or
    its twin) into a fresh (3, nao, nao, naux) tensor, as the Hessian's
    _first_df writes it: each screened class, then its mirrored pairs."""
    dev = mol.device
    naux = sum(e.shape[0] * (2 * l + 1) for l, e, _, _ in aux)
    out = torch.zeros((3, mol.nao, mol.nao, naux), dtype=torch.float64,
                      device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    for (la, lb), (bc, p) in classes.items():
        ia, jb = bc.ga.ao_off[bc.sel_a], bc.gb.ao_off[bc.sel_b]
        fn(la, lb, *p, aux, torch.as_tensor(ia, **i32),
           torch.as_tensor(jb, **i32), out)
        keep = ~((la == lb) & (bc.sel_a == bc.sel_b))
        if not keep.any():
            continue
        k = torch.as_tensor(np.flatnonzero(keep), device=dev)
        q = [t.index_select(0, k) for t in p]
        fn(lb, la, *q[3:], *q[:3], aux, torch.as_tensor(jb[keep], **i32),
           torch.as_tensor(ia[keep], **i32), out)
    return out


def hessian_phases(kernels, mf, report, suffix=''):
    """The Hessian's five kernels against their twins at the shapes of
    mf's Hessian (1e-10 x max): int1e_ipip with the SCF's D and W over
    every ordered class, int3c2e_ip1 and int2c2e_ip1_full written out as
    the Hessian writes them, int3c2e_ipip and int2c2e_ipip contracted with
    the DF gradient's Gamma and W_PQ; each timed over the full set of
    launches the Hessian makes; recorded as <kernel><suffix>."""
    from pyscf_tpu_torch.grad import df
    from pyscf_tpu_torch.hessian import rhf as hess_rhf
    from pyscf_tpu_torch.ops.integrals import (int1e, int1e_deriv, j3c,
                                               j3c_deriv)

    mol, auxmol = mf.mol, mf.with_df.auxmol
    dev = mol.device
    dm, cos, dme, kfac = df.occupied(mf)
    natm, nao, naux = mol.natm, mol.nao, auxmol.nao
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    aux = j3c.aux_tables(auxmol)
    aux_nnz = {l: float(_nnz(c).sum()) for l, _, c, _ in aux}
    print(f'the Hessian kernels against their twins at the Hessian path\'s '
          f'shapes (nao {nao}, naux {naux}, every class)')

    cross = int1e.cross_pairs(mol, mol)
    blocks = []
    for la, lb, ga, gb, p in cross:
        sel_a = np.repeat(np.arange(ga.nshl), gb.nshl)
        sel_b = np.tile(np.arange(gb.nshl), ga.nshl)
        ia = torch.as_tensor(ga.ao_off[sel_a][:, None]
                             + np.arange(2 * la + 1), device=dev)
        jb = torch.as_tensor(gb.ao_off[sel_b][:, None]
                             + np.arange(2 * lb + 1), device=dev)
        n = ia.shape[0]
        blocks.append((la, lb, p, dm[ia[:, :, None], jb[:, None, :]]
                       .reshape(n, -1).contiguous(),
                       dme[ia[:, :, None], jb[:, None, :]]
                       .reshape(n, -1).contiguous()))

    def one_e(fn):
        return [fn(la, lb, *p, zr, zq, D, W) for la, lb, p, D, W in blocks]

    k_out = one_e(kernels.int1e_ipip)
    p_out, plain_s = host_s(lambda: one_e(int1e_deriv.class_ipip))
    err, scale = max_abs(list(zip(k_out, p_out)))
    ops = sum(ipip_1e_ops(la, lb, p, natm) for la, lb, p, _, _ in blocks)
    io = sum(nbytes(*p, D, W) for _, _, p, D, W in blocks) \
        + nbytes(*k_out, zr, zq)
    record(report, f'int1e_ipip{suffix}', 'pyscf_tpu_torch/csrc/int1e_ipip.cu',
           'pyscf_tpu/hessian/rhf.py:327', err, lambda: one_e(
               kernels.int1e_ipip), plain_s * 1e3, io, ops)
    check(err <= 1e-10 * scale, f'int1e_ipip{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')
    del k_out, p_out

    with plain_kernels(kernels, HESS_KERNELS):
        ip1_p, _ = hess_rhf._first_df(mol, auxmol)
    ip1_k, _ = hess_rhf._first_df(mol, auxmol)
    err, scale = max_abs([(ip1_k, ip1_p)])
    del ip1_p
    classes = j3c.screened_pairs(mol)
    ops = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float(_prim_pairs(p).sum())
        for a, b in {(la, lb), (lb, la)}:
            for l, e, _, _ in aux:
                ops += coulomb_ip1_ops(a, b, l, prims, e.shape[0],
                                       prims * aux_nnz[l])

    record(report, f'int3c2e_ip1{suffix}',
           'pyscf_tpu_torch/csrc/int3c2e_ip1.cu',
           'pyscf_tpu/hessian/rhf.py:270', err,
           lambda: ip1_all(kernels.int3c2e_ip1, mol, classes, aux),
           lambda: ip1_all(j3c_deriv.int3c2e_ip1_plain, mol, classes, aux),
           nbytes(ip1_k) + sum(nbytes(*p) for _, p in classes.values())
           + sum(nbytes(*a[1:]) for a in aux), ops, plain_reps=1)
    check(err <= 1e-10 * scale, f'int3c2e_ip1{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')
    del ip1_k

    full_k = kernels.int2c2e_ip1_full(aux)
    full_p = j3c_deriv.int2c2e_ip1_full_plain(aux)
    err, scale = max_abs([(full_k, full_p)])
    ops = 0.0
    for lx, ex, cx, _ in aux:
        for ly, ey, cy, _ in aux:
            prims = float(_nnz(cx).sum())
            ops += coulomb_ip1_ops(lx, 0, ly, prims, ey.shape[0],
                                   prims * float(_nnz(cy).sum()))
    record(report, f'int2c2e_ip1_full{suffix}',
           'pyscf_tpu_torch/csrc/int2c2e_ipip.cu',
           'pyscf_tpu/hessian/rhf.py:270', err,
           lambda: kernels.int2c2e_ip1_full(aux),
           lambda: j3c_deriv.int2c2e_ip1_full_plain(aux),
           nbytes(full_k) + sum(nbytes(*a[1:]) for a in aux), ops)
    check(err <= 1e-10 * scale, f'int2c2e_ip1_full{suffix} vs plain: '
          f'{err:.3e} > 1e-10 x {scale:.3e}')
    del full_k, full_p

    _, gamma, Wpq = df.fitted_weights(mf, dm, cos, kfac)
    order = torch.as_tensor(j3c._grouped_order(auxmol), device=dev)
    gflat = gamma.reshape(naux, nao * nao).index_select(0, order)
    del gamma
    bra = j3c._bra_classes(mol)
    G = {cls: j3c_deriv._gamma_rows(mol, bra[cls], gflat) for cls in classes}
    del gflat

    def rows(fn):
        return [fn(*cls, *p, aux, G[cls]) for cls, (_, p) in classes.items()]

    k_out = rows(kernels.int3c2e_ipip)
    p_out, plain_s = host_s(lambda: rows(j3c_deriv.int3c2e_ipip_plain))
    err, scale = max_abs(list(zip(k_out, p_out)))
    ops = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float(_prim_pairs(p).sum())
        for l, e, _, _ in aux:
            ops += coulomb_ipip_ops(la, lb, l, prims, e.shape[0],
                                    prims * aux_nnz[l])
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*a[1:]) for a in aux) + nbytes(*G.values(), *k_out)
    record(report, f'int3c2e_ipip{suffix}',
           'pyscf_tpu_torch/csrc/int3c2e_ipip.cu',
           'pyscf_tpu/hessian/rhf.py:327', err,
           lambda: rows(kernels.int3c2e_ipip), plain_s * 1e3, io, ops)
    check(err <= 1e-10 * scale, f'int3c2e_ipip{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')
    del G, k_out, p_out

    Wg = Wpq.index_select(0, order).index_select(1, order).contiguous()
    k_out = kernels.int2c2e_ipip(aux, Wg)
    err, scale = max_abs([(k_out, j3c_deriv.int2c2e_ipip_plain(aux, Wg))])
    ops = 0.0
    for lx, ex, cx, _ in aux:
        for ly, ey, cy, _ in aux:
            prims = float(_nnz(cy).sum())
            ops += coulomb_ipip_ops(ly, 0, lx, prims, ex.shape[0],
                                    prims * float(_nnz(cx).sum()), False)
    record(report, f'int2c2e_ipip{suffix}',
           'pyscf_tpu_torch/csrc/int2c2e_ipip.cu',
           'pyscf_tpu/hessian/rhf.py:327', err,
           lambda: kernels.int2c2e_ipip(aux, Wg),
           lambda: j3c_deriv.int2c2e_ipip_plain(aux, Wg),
           sum(nbytes(*a[1:]) for a in aux) + nbytes(Wg, k_out), ops)
    check(err <= 1e-10 * scale, f'int2c2e_ipip{suffix} vs plain: {err:.3e} > '
          f'1e-10 x {scale:.3e}')


def tight_df(mol, kind, conv_tol_grad, xc_code=None, grids=None):
    """The density-fitted mean field `kind` ('RHF', 'UHF', 'RKS' or 'UKS',
    the last two with xc_code) converged as far as a Hessian and the
    central differences of its gradient need: minao, conv_tol 1e-12; on
    the grid `grids` (points, weights) where given, so that the
    differences are the fixed-grid gradient's."""
    make = getattr(mol, kind)
    mf = (make(xc=xc_code) if xc_code else make()).density_fit()
    if grids is not None:
        mf.grids.coords, mf.grids.weights = grids
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = conv_tol_grad
    mf.kernel()
    check(mf.converged, f'DF-{kind} {xc_code or ""}'.rstrip()
          + ' (Hessian) did not converge')
    return mf



def hessian_path(pt, kernels, name, atom, basis, picks, e_ref=None, spin=0):
    """The DF-RHF (DF-UHF with spin) Hessian and harmonic frequencies at
    atom/basis from M()
    (minao, conv_tol 1e-12, conv_tol_grad 1e-8) through
    mf.Hessian().kernel(), the launch counts set to 0 just before and read
    just after: its seven kernels launched, |sum_A H[A]| <= 1e-7, |H - H^T|
    <= 1e-9, and the columns `picks` (atom, direction) against central
    differences (step 1e-3 Bohr) of the analytic gradient (SCFs at conv_tol
    1e-12 and conv_tol_grad 1e-9) within 1e-5 Ha/Bohr^2, the reference's
    gate (tests/test_hessian.py:39); the wall from M(), the eight phases of
    the first call and of one warm call, the CPHF iterations, the peak
    memory, the harmonic frequencies and the thermochemistry printed (the
    geometries are no RHF minima: not gated); E - e_ref printed where there
    is a reference. Returns (mf, launches)."""
    from pyscf_tpu_torch import hessian

    kind = 'UHF' if spin else 'RHF'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf = tight_df(pt.M(atom=atom, basis=basis, spin=spin), kind, 1e-8)
    torch.cuda.synchronize()
    t_scf = time.perf_counter() - t0
    if e_ref is not None:
        print(f'{name}: E {mf.e_tot!r} (E - E_ref {mf.e_tot - e_ref:.3e}, '
              f'the reference at conv_tol 1e-8)')
    kernels.reset_launches()
    hobj = mf.Hessian()
    h, s = host_s(hobj.kernel)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    mol = mf.mol
    print(f'{name} Hessian: nao {mol.nao}, naux {mf.with_df.auxmol.nao}; '
          f'SCF {t_scf:.3f} s, Hessian {s:.3f} s, wall from M() '
          f'{t_scf + s:.3f} s; CPHF {hobj.cphf_cycles} iterations; peak '
          f'device memory {peak:.3f} GB')
    print(f'{name} Hessian phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in HESS_PHASES))
    print(f'launches: {launches}')
    for k in HESS_PATH_KERNELS:
        check(launches[k] > 0, f'{name} Hessian: kernel {k} never launched')
    natm = mol.natm
    hm = h.reshape(3 * natm, 3 * natm)
    drift = float(np.abs(h.sum(axis=0)).max())
    asym = float(np.abs(hm - hm.T).max())
    print(f'{name} Hessian |sum_A H[A]| {drift:.3e}  |H - H^T| {asym:.3e}')
    check(np.all(np.isfinite(h)) and h.shape == (natm, 3, natm, 3),
          f'{name} Hessian not finite of shape (natm, 3, natm, 3)')
    check(drift <= 1e-7, f'{name} Hessian sum rule {drift:.3e} > 1e-7')
    check(asym <= 1e-9, f'{name} Hessian symmetry {asym:.3e} > 1e-9')
    _, s = host_s(hobj.kernel)
    print(f'{name} Hessian warm {s:.4f} s; phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in HESS_PHASES))
    t0 = time.perf_counter()
    fd = hessian.fd_columns(
        lambda m: tight_df(m, kind, 1e-9).Gradients().kernel(), mol, picks)
    worst = max(float(np.abs(h[a, x] - col).max())
                for (a, x), col in zip(picks, fd))
    print(f'{name} Hessian vs central differences of the gradient on '
          f'{len(picks)} columns ({2 * len(picks)} SCF + gradient runs, '
          f'{time.perf_counter() - t0:.1f} s): max |H - H_fd| {worst:.3e} '
          f'Ha/Bohr^2')
    check(worst <= 1e-5, f'{name} Hessian vs central differences '
          f'{worst:.3e} > 1e-5')
    res = hessian.harmonic_analysis(mol, h)
    print(f'{name} harmonic frequencies (cm^-1): '
          + ' '.join(f'{f:.2f}' for f in res['freq_wavenumber']))
    th = hessian.thermo(mol, res['freq_au'], mf.e_tot)
    print(f'{name} thermochemistry (Ha): ' + '  '.join(
        f'{k} {v:.8f}' for k, v in th.items()))
    return mf, launches


# ---- the DF-RKS Hessian and the transition-state search --------------------

KS_HESS_KERNELS = ('eval_ao_deriv3', 'xc_rks_hess', 'xc_rks_deriv1')
# the kernels of the DF-RKS Hessian's path: the RHF Hessian's, the XC
# terms' and the XC response's (the dense A_xc in the CG steps, the
# tangent of V_xc for the right-hand side and dW)
KS_HESS_PATH_KERNELS = HESS_PATH_KERNELS + KS_HESS_KERNELS + (
    'xc_fxc', 'xc_fxc_pairs', 'xc_rks_fxc')
KS_HESS_PHASES = HESS_PHASES[:1] + ('xc_rows', 'xc_F1') + HESS_PHASES[1:]
# tangents per xc_rks_deriv1 launch in the Hessian (2 tangent_chunk)
KS_DERIV1_CHUNK = 12


def library_logs(kernels, names):
    """Print each library's compile seconds and ptxas register lines from
    its <library>.log in the build directory, then the twelve libraries
    that took longest and the sum over all."""
    import os
    out = kernels._build_dir()
    for lib in names:
        with open(os.path.join(out, lib + '.log')) as f:
            lines = f.read().splitlines()
        regs = [ln.strip() for ln in lines if 'registers' in ln]
        print(f'library {lib}: {lines[-1]}; ' + ' | '.join(regs))
    secs = {}
    for lib in kernels._LIBRARIES:
        with open(os.path.join(out, lib + '.log')) as f:
            secs[lib] = float(f.read().splitlines()[-1].split()[-1])
    top = sorted(secs, key=secs.get, reverse=True)[:12]
    print(f'compile seconds of {len(secs)} libraries, sum '
          f'{sum(secs.values()):.1f} s; the longest: '
          + ', '.join(f'{k} {secs[k]:.1f}' for k in top))


def ks_hessian_path(pt, refs, kernels, basis, picks, fxc_routes=False):
    """The DF-RKS b3lypg Hessian and harmonic frequencies of benzene/basis
    from M() (minao, conv_tol 1e-12, conv_tol_grad 1e-8) through
    mf.Hessian().kernel(), the launch counts set to 0 just before and read
    just after: the RHF Hessian's seven kernels, eval_ao_deriv3,
    xc_rks_hess, xc_rks_deriv1, xc_fxc, xc_fxc_pairs and xc_rks_fxc
    launched, |H - H^T| <= 1e-9
    (the sum rule printed, not gated: no grid response, as in the JAX
    package), and the columns `picks` against the four-point central
    differences (step 1e-3 Bohr) of the analytic gradient on the same fixed
    grid (SCFs at conv_tol 1e-12 and conv_tol_grad 1e-9) within 1e-5
    Ha/Bohr^2; the wall from M(), the phases of the first call and of a
    warm call, the CPHF iterations, the peak memory, the frequencies (the
    translations and rotations projected out) and the thermochemistry
    printed, and which XC response hessian/rhf.py _dense_fxc selects for
    CPHF's CG steps. With fxc_routes, one warm call more through the other
    one (the dense A_xc of xc_fxc and xc_fxc_pairs, or the tangent of V_xc
    by xc_rks_fxc), its phases printed and its Hessian within 1e-8 of the
    selected route's. Returns (mf, launches)."""
    from pyscf_tpu_torch import hessian
    from pyscf_tpu_torch.hessian import rhf as hess_rhf

    name = f'DF-RKS b3lypg benzene/{basis}'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf = tight_df(pt.M(atom=refs.BENZENE, basis=basis), 'RKS', 1e-8,
                  'b3lypg')
    torch.cuda.synchronize()
    t_scf = time.perf_counter() - t0
    kernels.reset_launches()
    hobj = mf.Hessian()
    h, s = host_s(hobj.kernel)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    mol = mf.mol
    nov = int((mf.mo_occ > 0).sum()) * int((mf.mo_occ == 0).sum())
    dense = hess_rhf._dense_fxc(mol, nov)
    routes = ('dense A_xc', 'tangent of V_xc')
    print(f'{name} Hessian: CPHF XC response {routes[not dense]} (nocc nvir '
          f'{nov}, (nocc nvir)^2 / (3 natm nao^2) '
          f'{nov ** 2 / (3 * mol.natm * mol.nao ** 2):.2f})')
    print(f'{name} Hessian: nao {mol.nao}, naux {mf.with_df.auxmol.nao}, '
          f'{mf.grids.size} grid points; E {mf.e_tot!r}; SCF {t_scf:.3f} s, '
          f'Hessian {s:.3f} s, wall from M() {t_scf + s:.3f} s; CPHF '
          f'{hobj.cphf_cycles} iterations; peak device memory {peak:.3f} GB')
    print(f'{name} Hessian phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in KS_HESS_PHASES))
    print(f'launches: {launches}')
    for k in KS_HESS_PATH_KERNELS:
        check(launches[k] > 0, f'{name} Hessian: kernel {k} never launched')
    natm = mol.natm
    hm = h.reshape(3 * natm, 3 * natm)
    asym = float(np.abs(hm - hm.T).max())
    print(f'{name} Hessian |H - H^T| {asym:.3e}  |sum_A H[A]| (no grid '
          f'response) {np.abs(h.sum(axis=0)).max():.3e}')
    check(np.all(np.isfinite(h)) and h.shape == (natm, 3, natm, 3),
          f'{name} Hessian not finite of shape (natm, 3, natm, 3)')
    check(asym <= 1e-9, f'{name} Hessian symmetry {asym:.3e} > 1e-9')
    _, s = host_s(hobj.kernel)
    print(f'{name} Hessian warm {s:.4f} s; phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in KS_HESS_PHASES))
    if fxc_routes:
        selected = hess_rhf._dense_fxc
        hess_rhf._dense_fxc = lambda m, n: not dense
        try:
            hd, s = host_s(hobj.kernel)
        finally:
            hess_rhf._dense_fxc = selected
        diff = float(np.abs(hd - h).max())
        print(f'{name} Hessian warm, CPHF XC response {routes[dense]} '
              f'{s:.4f} s; CPHF {hobj.cphf_cycles} iterations; phases: '
              + '  '.join(f'{k} {hobj.timings[k]:.4f}'
                          for k in KS_HESS_PHASES)
              + f'; max |H - H_selected| {diff:.3e}')
        check(diff <= 1e-8, f'{name} Hessian: the XC responses of CPHF '
              f'differ by {diff:.3e} > 1e-8')
    grids = (mf.grids.coords, mf.grids.weights)
    t0 = time.perf_counter()
    fd = hessian.fd_columns(
        lambda m: tight_df(m, 'RKS', 1e-9, 'b3lypg', grids)
        .Gradients().kernel(), mol, picks, points=4)
    worst = max(float(np.abs(h[a, x] - col).max())
                for (a, x), col in zip(picks, fd))
    print(f'{name} Hessian vs four-point central differences of the '
          f'gradient on the fixed grid on {len(picks)} columns '
          f'({4 * len(picks)} SCF + gradient runs, '
          f'{time.perf_counter() - t0:.1f} s): max |H - H_fd| {worst:.3e} '
          f'Ha/Bohr^2')
    check(worst <= 1e-5, f'{name} Hessian vs central differences '
          f'{worst:.3e} > 1e-5')
    res = hessian.harmonic_analysis(mol, hessian.project_trans_rot(mol, h))
    print(f'{name} harmonic frequencies (cm^-1, translations and rotations '
          'projected out): '
          + ' '.join(f'{f:.2f}' for f in res['freq_wavenumber']))
    th = hessian.thermo(mol, res['freq_au'], mf.e_tot)
    print(f'{name} thermochemistry (Ha): ' + '  '.join(
        f'{k} {v:.8f}' for k, v in th.items()))
    return mf, launches


def ks_hessian_phases(kernels, mf, report, suffix=''):
    """The DF-RKS Hessian's XC kernels against their twins on mf's grid
    at its density, at the shapes its Hessian gives them: xc_rks_hess
    (each output <= 1e-10 x its max) and xc_rks_deriv1 over every tangent
    in the Hessian's chunks of KS_DERIV1_CHUNK (<= 1e-10 x max); the twins
    timed once on the host clock; recorded as <kernel><suffix>."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.ops import eval_gto

    mol, nao, natm = mf.mol, mf.mol.nao, mf.mol.natm
    nt = 3 * natm
    dm = mf.make_rdm1()
    coords, weights = mf.grids.coords, mf.grids.weights
    npts = coords.shape[0]
    f = mf.xc_obj
    tables = eval_gto.ao_tables(mol)
    print(f'the DF-RKS Hessian\'s kernels against their twins at nao {nao}, '
          f'{npts} grid points')
    ao_k = kernels.eval_ao_deriv3(tables, coords, nao)

    atom_off, ao_atom = numint.atom_ranges(mol)
    dmao = (ao_k[:4].reshape(-1, nao) @ dm).reshape(4, npts, nao)
    out_k = kernels.xc_rks_hess(ao_k, dmao, weights, f, atom_off)
    # the twin's second call is timed: its first builds torch.func's vmap of
    # the functional's Hessian
    for _ in range(2):
        out_p, plain_s = host_s(lambda: numint.xc_rks_hess_plain(
            ao_k, dmao, weights, f, atom_off))
    errs = [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(out_k, out_p)]
    del out_p
    for (e_, s_), what in zip(errs, ('wv', 'ut', 'ht', 'same', 'xr')):
        check(e_ <= 1e-10 * s_, f'xc_rks_hess{suffix} {what} vs plain: '
              f'{e_:.3e} > 1e-10 x {s_:.3e}')
    # per point and AO ~200 operations (the density, the atoms' sums, the
    # explicit rows); the functional's few thousand per point not counted
    record(report, f'xc_rks_hess{suffix}',
           'pyscf_tpu_torch/csrc/xc_rks_hess.cu',
           'pyscf_tpu/hessian/rhf.py:327', max(e_ for e_, _ in errs),
           lambda: kernels.xc_rks_hess(ao_k, dmao, weights, f, atom_off),
           plain_s * 1e3, nbytes(ao_k, dmao, weights, *out_k),
           200.0 * npts * nao)
    wv, _, ht, _, xr = out_k
    del dmao

    def chunks(fn):
        return [fn(ao_k, wv, ht, xr, ao_atom, a, min(KS_DERIV1_CHUNK, nt - a))
                for a in range(0, nt, KS_DERIV1_CHUNK)]

    err = scale = 0.0
    plain_s = 0.0
    for a in range(0, nt, KS_DERIV1_CHUNK):
        m = min(KS_DERIV1_CHUNK, nt - a)
        v_k = kernels.xc_rks_deriv1(ao_k, wv, ht, xr, ao_atom, a, m)
        v_p, s_ = host_s(lambda: numint.xc_rks_deriv1_plain(
            ao_k, wv, ht, xr, ao_atom, a, m))
        plain_s += s_
        err = max(err, float((v_k - v_p).abs().max()))
        scale = max(scale, float(v_p.abs().max()))
        del v_k, v_p
    record(report, f'xc_rks_deriv1{suffix}',
           'pyscf_tpu_torch/csrc/xc_rks_hess.cu',
           'pyscf_tpu/hessian/rhf.py:279', err,
           lambda: chunks(kernels.xc_rks_deriv1), plain_s * 1e3,
           8 * npts * nao * (nt + 7) + nbytes(wv, ht), 8.0 * npts * nao * nt)
    check(err <= 1e-10 * scale, f'xc_rks_deriv1{suffix} vs plain: '
          f'{err:.3e} > 1e-10 x {scale:.3e}')


def nh3_ts_path(pt, refs, kernels):
    """geomopt.optimize_ts of NH3's inversion with DF-RKS b3lypg/def2-SVP
    (minao, conv_tol 1e-10, conv_tol_grad 1e-7, each geometry's own grid)
    from refs.NH3_PYRAMID (N 0.15 Angstrom above the H3 plane), the launch
    counts set to 0 just before: max|g| < 3e-4, N within 1e-3 Angstrom of
    the plane of its three H, the DF-RKS Hessian's kernels launched, and
    exactly one imaginary frequency at the saddle once the translations and
    rotations are projected out (the six of them within 1 cm^-1 of 0); the
    energy, max|g| and the seconds printed."""
    from pyscf_tpu_torch import hessian
    from pyscf_tpu_torch.lib.parameters import BOHR

    def factory(m):
        mf = tight(m.RKS(xc='b3lypg').density_fit())
        mf.kernel()
        check(mf.converged, 'NH3 DF-RKS did not converge')
        return mf

    mol = pt.M(atom=refs.NH3_PYRAMID, basis='def2-svp')
    kernels.reset_launches()
    (m, es), s = host_s(lambda: pt.geomopt.optimize_ts(factory, mol))
    launches = kernels.launches()
    r = np.asarray(m.coords) * BOHR
    nrm = np.cross(r[2] - r[1], r[3] - r[1])
    off = abs(float(np.dot(r[0] - r[1], nrm / np.linalg.norm(nrm))))
    print(f'NH3 DF-RKS b3lypg/def2-SVP optimize_ts: {len(es)} geometries, '
          f'{s:.3f} s; E {es[0]:.10f} -> {es[-1]:.10f}; max|g| '
          f'{m._ts_grad_norm:.3e}; N {off:.3e} Angstrom off the H3 plane')
    check(m._ts_grad_norm < 3e-4, f'NH3 TS: max|g| {m._ts_grad_norm:.3e}')
    check(off < 1e-3, f'NH3 TS: N {off:.3e} Angstrom off the plane')
    for k in KS_HESS_KERNELS:
        check(launches[k] > 0, f'NH3 TS: kernel {k} never launched')
    mf = factory(m)
    h = hessian.project_trans_rot(m, mf.Hessian().kernel())
    freq = hessian.harmonic_analysis(m, h)['freq_wavenumber']
    print('NH3 saddle frequencies (cm^-1, translations and rotations '
          'projected out): ' + ' '.join(f'{f:.2f}' for f in freq))
    check(int(np.sum(freq < -1.0)) == 1, 'NH3 TS: not one imaginary '
          'frequency')
    check(int(np.sum(np.abs(freq) < 1.0)) == 6, 'NH3 TS: the six '
          'translations and rotations are not at 0')
    return launches


# ---- the DF-UHF/UKS Hessian, the PBE family and the DF-UHF TS search -------

UKS_HESS_KERNELS = ('eval_ao_deriv3', 'xc_uks_hess', 'xc_uks_deriv1')
# the kernels of the DF-UKS Hessian's path: the RHF Hessian's, the XC
# terms' and the XC response's (the tangent of V_xc, in every CG step)
UKS_HESS_PATH_KERNELS = HESS_PATH_KERNELS + UKS_HESS_KERNELS + ('xc_uks_fxc',)
# every XC library, whose compile seconds (each holds PBE) and
# ptxas lines are printed
XC_LIBRARIES = ('xc_rks', 'xc_uks', 'xc_rks_grad', 'xc_uks_grad', 'xc_fxc',
                'xc_fxc_pairs', 'xc_rks_fxc', 'xc_uks_fxc', 'xc_rks_hess',
                'xc_rks_deriv1', 'xc_uks_hess', 'xc_uks_deriv1')
# the phenyl radical's radical carbon, its ortho carbon and the ortho
# hydrogen (refs.PHENYL atoms 0, 1 and 6), every direction
PHENYL_PICKS = [(a, x) for a in (0, 1, 6) for x in range(3)]
# tests/test_ts_opt.py's H + H2 exchange
H3 = 'H 0 0 -1.05; H 0 0 0.0; H 0 0 0.85'
# planar methyl, C-H 1.079 Angstrom
CH3 = 'C 0 0 0; H 1.079 0 0; H -0.5395 0.934441 0; H -0.5395 -0.934441 0'


def uks_hessian_path(pt, refs, kernels, xc_code, picks, forces=False):
    """The phenyl radical's DF-UKS xc_code/def2-SVP Hessian at full width
    from M() (minao, conv_tol 1e-12, conv_tol_grad 1e-8; with forces, its
    gradient too: energy check 1e-6, |de_z| and the x-mirror 1e-8) through
    mf.Hessian().kernel(), the launch counts set to 0 before M() and read
    after the Hessian: the analytic DF-UHF/UKS Hessian (hessian/uhf.py),
    the RHF Hessian's kernels, eval_ao_deriv3, xc_uks_hess, xc_uks_deriv1
    and xc_uks_fxc launched, |H - H^T| <= 1e-9, and the columns `picks`
    against the four-point central differences (step 1e-3 Bohr) of the
    analytic gradient on the same fixed grid (SCFs at conv_tol 1e-12 and
    conv_tol_grad 1e-9) within 1e-5 Ha/Bohr^2; the wall, the phases of the
    first and of a warm call, the CPHF iterations, the peak memory, the
    gap to the reference's dW (reference_w=True) and the frequencies
    (translations and rotations projected out) printed. Returns (mf,
    launches)."""
    from pyscf_tpu_torch import hessian
    from pyscf_tpu_torch.hessian import uhf as hess_uhf

    name = f'DF-UKS {xc_code} phenyl/def2-SVP'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mf = tight_df(pt.M(atom=refs.PHENYL, basis='def2-svp', spin=1), 'UKS',
                  1e-8, xc_code)
    torch.cuda.synchronize()
    t_scf = time.perf_counter() - t0
    print(f'{name}: E {mf.e_tot!r}, {mf.scf_cycles} cycles, <S^2> '
          f'{mf.spin_square()[0]:.6f}, {mf.grids.size} grid points')
    if forces:
        grad = mf.nuc_grad_method()
        de, s = host_s(grad.kernel)
        out = float(np.abs(de[:, 2]).max())
        mirror = mirror_defect(mf.mol.coords, de, 0)
        print(f'{name} forces {s:.3f} s: energy check |e_chk - E| '
              f'{abs(grad.e_chk - mf.e_tot):.3e}  |de_z| {out:.3e}  '
              f'x-mirror defect {mirror:.3e}\nde (Ha/Bohr):\n'
              + np.array2string(de, precision=10))
        check(abs(grad.e_chk - mf.e_tot) < 1e-6, f'{name}: energy check')
        check(out < 1e-8 and mirror < 1e-8, f'{name} gradient: |de_z| '
              f'{out:.3e} or x-mirror {mirror:.3e} >= 1e-8')
    hobj = mf.Hessian()
    check(isinstance(hobj, hess_uhf.Hessian), f'{name}: mf.Hessian() is not '
          'the analytic DF-UHF/UKS Hessian')
    h, s = host_s(hobj.kernel)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    mol = mf.mol
    print(f'{name} Hessian: nao {mol.nao}, naux {mf.with_df.auxmol.nao}; '
          f'SCF {t_scf:.3f} s, Hessian {s:.3f} s, wall from M() '
          f'{t_scf + s:.3f} s; CPHF {hobj.cphf_cycles} iterations; peak '
          f'device memory {peak:.3f} GB')
    print(f'{name} Hessian phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in KS_HESS_PHASES))
    print(f'launches: {launches}')
    for k in UKS_HESS_PATH_KERNELS:
        check(launches[k] > 0, f'{name} Hessian: kernel {k} never launched')
    natm = mol.natm
    hm = h.reshape(3 * natm, 3 * natm)
    asym = float(np.abs(hm - hm.T).max())
    print(f'{name} Hessian |H - H^T| {asym:.3e}  |sum_A H[A]| (no grid '
          f'response) {np.abs(h.sum(axis=0)).max():.3e}')
    check(np.all(np.isfinite(h)) and h.shape == (natm, 3, natm, 3),
          f'{name} Hessian not finite of shape (natm, 3, natm, 3)')
    check(asym <= 1e-9, f'{name} Hessian symmetry {asym:.3e} > 1e-9')
    _, s = host_s(hobj.kernel)
    print(f'{name} Hessian warm {s:.4f} s; phases: ' + '  '.join(
        f'{k} {hobj.timings[k]:.4f}' for k in KS_HESS_PHASES))
    gap = float(np.abs(hess_uhf.hessian(mf, reference_w=True)[0] - h).max())
    print(f'{name} Hessian: the reference\'s dW (the diagonal of each '
          f'spin\'s occupied block, reference_w=True) moves it by '
          f'{gap:.3e} Ha/Bohr^2')
    grids = (mf.grids.coords, mf.grids.weights)
    t0 = time.perf_counter()
    fd = hessian.fd_columns(
        lambda m: tight_df(m, 'UKS', 1e-9, xc_code, grids)
        .Gradients().kernel(), mol, picks, points=4)
    worst = max(float(np.abs(h[a, x] - col).max())
                for (a, x), col in zip(picks, fd))
    print(f'{name} Hessian vs four-point central differences of the '
          f'gradient on the fixed grid on {len(picks)} columns '
          f'({4 * len(picks)} SCF + gradient runs, '
          f'{time.perf_counter() - t0:.1f} s): max |H - H_fd| {worst:.3e} '
          f'Ha/Bohr^2')
    check(worst <= 1e-5, f'{name} Hessian vs central differences '
          f'{worst:.3e} > 1e-5')
    res = hessian.harmonic_analysis(mol, hessian.project_trans_rot(mol, h))
    print(f'{name} harmonic frequencies (cm^-1, translations and rotations '
          'projected out): '
          + ' '.join(f'{f:.2f}' for f in res['freq_wavenumber']))
    return mf, launches


def uks_hessian_phases(kernels, mf, report, suffix=''):
    """The DF-UKS Hessian's XC kernels against their twins on mf's grid at
    its spin density, at the shapes its Hessian gives them: xc_uks_hess
    (each output <= 1e-10 x its max) and xc_uks_deriv1 over every tangent
    in the Hessian's chunks of KS_DERIV1_CHUNK (<= 1e-10 x max); the twins
    timed once on the host clock; recorded as <kernel><suffix>."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.ops import eval_gto

    mol, nao, natm = mf.mol, mf.mol.nao, mf.mol.natm
    nt = 3 * natm
    dm = mf.make_rdm1()
    coords, weights = mf.grids.coords, mf.grids.weights
    npts = coords.shape[0]
    f = mf.xc_obj
    tables = eval_gto.ao_tables(mol)
    print(f'the DF-UKS Hessian\'s kernels ({mf.xc}) against their twins at '
          f'nao {nao}, {npts} grid points')
    ao_k = kernels.eval_ao_deriv3(tables, coords, nao)

    atom_off, ao_atom = numint.atom_ranges(mol)
    dmao = torch.matmul(ao_k[:4].reshape(-1, nao), dm).reshape(
        2, 4, npts, nao)
    out_k = kernels.xc_uks_hess(ao_k, dmao, weights, f, atom_off)
    # the twin's second call is timed: its first builds torch.func's vmap of
    # the functional's Hessian
    for _ in range(2):
        out_p, plain_s = host_s(lambda: numint.xc_uks_hess_plain(
            ao_k, dmao, weights, f, atom_off))
    errs = [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(out_k, out_p)]
    del out_p
    for (e_, s_), what in zip(errs, ('wv', 'ut', 'ht', 'same', 'xr')):
        check(e_ <= 1e-10 * s_, f'xc_uks_hess{suffix} {what} vs plain: '
              f'{e_:.3e} > 1e-10 x {s_:.3e}')
    # per point and AO ~400 operations (both densities, the atoms' sums,
    # both spins' explicit rows); the functional's and the chain rule's
    # tens of thousands per point not counted
    record(report, f'xc_uks_hess{suffix}',
           'pyscf_tpu_torch/csrc/xc_uks_hess.cu',
           'pyscf_tpu/hessian/uhf.py:256', max(e_ for e_, _ in errs),
           lambda: kernels.xc_uks_hess(ao_k, dmao, weights, f, atom_off),
           plain_s * 1e3, nbytes(ao_k, dmao, weights, *out_k),
           400.0 * npts * nao)
    wv, _, ht, _, xr = out_k
    del dmao

    def chunks(fn):
        return [fn(ao_k, wv, ht, xr, ao_atom, a, min(KS_DERIV1_CHUNK, nt - a))
                for a in range(0, nt, KS_DERIV1_CHUNK)]

    err = scale = 0.0
    plain_s = 0.0
    for a in range(0, nt, KS_DERIV1_CHUNK):
        m = min(KS_DERIV1_CHUNK, nt - a)
        v_k = kernels.xc_uks_deriv1(ao_k, wv, ht, xr, ao_atom, a, m)
        v_p, s_ = host_s(lambda: numint.xc_uks_deriv1_plain(
            ao_k, wv, ht, xr, ao_atom, a, m))
        plain_s += s_
        err = max(err, float((v_k - v_p).abs().max()))
        scale = max(scale, float(v_p.abs().max()))
        del v_k, v_p
    record(report, f'xc_uks_deriv1{suffix}',
           'pyscf_tpu_torch/csrc/xc_uks_hess.cu',
           'pyscf_tpu/hessian/uhf.py:176', err,
           lambda: chunks(kernels.xc_uks_deriv1), plain_s * 1e3,
           8 * npts * nao * (2 * nt + 10) + nbytes(wv, ht),
           16.0 * npts * nao * nt)
    check(err <= 1e-10 * scale, f'xc_uks_deriv1{suffix} vs plain: '
          f'{err:.3e} > 1e-10 x {scale:.3e}')


def uks_fxc_phase(kernels, mf, report, name):
    """xc_uks_fxc at the converged DF-UKS spin density on its whole grid
    along five seeded spin transition densities (one chunk of the
    Hessian's CG steps) against its twin, as tangent_fxc_phase."""
    f = mf.xc_obj
    aods, wblocks = mf._numint.grid_ao(mf.mol, mf.grids, 1, spins=2)
    check(len(aods) == 1, 'the phenyl grid does not fit one block')
    aod, w = aods[0], wblocks[0]
    npts, nao = w.shape[0], aod.shape[-1]
    d0 = torch.matmul(aod[0], mf.make_rdm1())
    rng = np.random.default_rng(23)
    t = torch.as_tensor(rng.standard_normal((5, 2, nao, nao)),
                        device='cuda') * 1e-2
    d1 = torch.matmul(aod[0], t + t.transpose(-1, -2))
    tangent_fxc_phase(kernels, report, 'xc_uks_fxc', name,
                      (aod, d0, d1, w, f), (16.0 + 32.0 * 5) * npts * nao,
                      'pyscf_tpu/hessian/uhf.py:196')


def benzene_pbe_path(pt, refs, kernels):
    """Benzene DF-RKS PBE/def2-SVP from M() (minao, conv_tol 1e-10,
    conv_tol_grad 1e-7): its energy, its forces (energy check 1e-6, |de_z|
    and the mirror planes 1e-8) and its Hessian (symmetric to 1e-9), the
    launch counts set to 0 before M() and read at the end: xc_rks,
    xc_rks_grad, xc_rks_hess, xc_rks_deriv1 and the CPHF response kernels
    launched with PBE. Returns (mf, launches)."""
    kernels.reset_launches()
    mf, s = host_s(lambda: tight(pt.dft.RKS(
        pt.M(atom=refs.BENZENE, basis='def2-svp'), xc='pbe').density_fit()))
    e, s_scf = host_s(mf.kernel)
    check(mf.converged, 'DF-RKS PBE benzene did not converge')
    grad = mf.nuc_grad_method()
    de, s_grad = host_s(grad.kernel)
    out = float(np.abs(de[:, 2]).max())
    mirror = max(mirror_defect(mf.mol.coords, de, ax) for ax in (0, 1))
    print(f'DF-RKS PBE benzene/def2-SVP: E {e!r}, {mf.scf_cycles} cycles, '
          f'SCF {s + s_scf:.3f} s, forces {s_grad:.3f} s: energy check '
          f'{abs(grad.e_chk - e):.3e}  |de_z| {out:.3e}  mirror defect '
          f'{mirror:.3e}')
    check(abs(grad.e_chk - e) < 1e-6, 'DF-RKS PBE: energy check')
    check(out < 1e-8 and mirror < 1e-8, f'DF-RKS PBE gradient: |de_z| '
          f'{out:.3e} or mirror {mirror:.3e} >= 1e-8')
    hobj = mf.Hessian()
    h, s = host_s(hobj.kernel)
    launches = kernels.launches()
    hm = h.reshape(36, 36)
    asym = float(np.abs(hm - hm.T).max())
    print(f'DF-RKS PBE benzene/def2-SVP Hessian {s:.3f} s, CPHF '
          f'{hobj.cphf_cycles} iterations, |H - H^T| {asym:.3e}')
    print(f'launches: {launches}')
    check(np.all(np.isfinite(h)) and asym <= 1e-9, 'DF-RKS PBE Hessian not '
          f'finite or not symmetric ({asym:.3e})')
    for k in ('xc_rks', 'xc_rks_grad', 'xc_rks_hess', 'xc_rks_deriv1',
              'xc_fxc', 'xc_fxc_pairs', 'xc_rks_fxc'):
        check(launches[k] > 0, f'DF-RKS PBE: kernel {k} never launched')
    return mf, launches


def h3_ts_path(pt, kernels):
    """tests/test_ts_opt.py's H + H2 exchange saddle by geomopt.optimize_ts
    on DF-UHF/sto-3g (spin 1, conv_tol 1e-11, gtol 5e-4, maxsteps 25), the
    launch counts set to 0 just before, with that test's asserts: max|g|
    under gtol, the two H-H distances within 5e-3 Bohr of each other and
    between 1.5 and 2.1 Bohr, and one eigenvalue of the analytic Hessian
    under -1e-4; the DF-UHF Hessian's kernels launched."""
    from pyscf_tpu_torch import hessian

    def factory(m):
        mf = m.UHF().density_fit()
        mf.conv_tol = 1e-11
        mf.kernel()
        check(mf.converged, 'H3 DF-UHF did not converge')
        return mf

    mol = pt.M(atom=H3, basis='sto-3g', spin=1)
    kernels.reset_launches()
    (ts, es), s = host_s(lambda: pt.geomopt.optimize_ts(
        factory, mol, maxsteps=25, gtol=5e-4))
    launches = kernels.launches()
    r = np.asarray(ts.coords)
    d01 = float(np.linalg.norm(r[1] - r[0]))
    d12 = float(np.linalg.norm(r[2] - r[1]))
    h = hessian.Hessian(factory(ts)).kernel().reshape(9, 9)
    w = np.linalg.eigvalsh(0.5 * (h + h.T))
    print(f'H3 DF-UHF/sto-3g optimize_ts: {len(es)} geometries, {s:.3f} s; '
          f'E {es[0]:.10f} -> {es[-1]:.10f}; max|g| {ts._ts_grad_norm:.3e}; '
          f'H-H {d01:.6f} and {d12:.6f} Bohr; Hessian eigenvalues '
          + ' '.join(f'{x:.5f}' for x in w))
    check(ts._ts_grad_norm < 5e-4, f'H3 TS: max|g| {ts._ts_grad_norm:.3e}')
    check(abs(d01 - d12) < 5e-3 and 1.5 < d01 < 2.1,
          f'H3 TS: H-H {d01:.4f}, {d12:.4f} Bohr')
    check(int((w < -1e-4).sum()) == 1, 'H3 TS: not one negative eigenvalue')
    for k in HESS_PATH_KERNELS:
        check(launches[k] > 0, f'H3 TS: kernel {k} never launched')


# ---- f and g shells: BASELINE configs 3 and 4 ------------------------------

# the JAX package's (H2O)10 DF-RHF/cc-pVTZ run on the TPU
# (results/scaling_h2o10.log): its reported energy (:91) and the electronic
# energy its SCF stalled at, |g| 2.48e-5, in cycles 33-34 (:85, :87); the
# reported energy is a DIIS spike's. Printed beside the port's, not gated.
E_H2O10_TPU = -760.5090479322669
E_ELEC_H2O10_TPU_PLATEAU = -1480.98178908


def stv_rows(mol, fn):
    """S/T/V rows of every screened class and the minao guess's S-only
    cross rows (mol x minao, every ordered class), through fn (the
    int1e_stv kernel or its twin class_stv)."""
    from pyscf_tpu_torch.ops.integrals import int1e, j3c
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=mol.device)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=mol.device)
    out = [fn(la, lb, *p, zr, zq)
           for (la, lb), (_, p) in j3c.screened_pairs(mol).items()]
    return out + [fn(la, lb, *p, with_tv=False)
                  for la, lb, _, _, p in int1e.cross_pairs(mol, minao(mol))]


def minao(mol):
    """The minao guess's basis on mol's atoms."""
    import pyscf_tpu_torch as pt
    return pt.M(atom=list(zip(mol.raw_symbols, mol.coords)), basis='minao',
                unit='bohr', device=mol.device)


def stv_phase(kernels, mol, name, report):
    """int1e_stv against its twin on every class of mol (S/T/V) and of its
    minao cross overlap (S), <= 1e-12; recorded as name."""
    from pyscf_tpu_torch.ops.integrals import int1e, j3c
    k_out = stv_rows(mol, kernels.int1e_stv)
    p_out, plain_s = host_s(lambda: stv_rows(mol, int1e.class_stv))
    err, _ = max_abs(list(zip(k_out, p_out)))
    classes = j3c.screened_pairs(mol)
    cross = int1e.cross_pairs(mol, minao(mol))
    ops = sum(stv_ops(la, lb, p, mol.natm, True)
              for (la, lb), (_, p) in classes.items())
    ops += sum(stv_ops(la, lb, p, 0, False) for la, lb, _, _, p in cross)
    io = sum(nbytes(*p) for _, p in classes.values()) \
        + sum(nbytes(*p) for *_, p in cross) + nbytes(*k_out)
    record(report, name, 'pyscf_tpu_torch/csrc/int1e_stv.cu',
           'pyscf_tpu/ops/integrals/j1e.py:30', err,
           lambda: stv_rows(mol, kernels.int1e_stv), plain_s * 1e3, io, ops)
    check(err <= 1e-12, f'{name} vs plain: {err:.3e} > 1e-12')


def plain_hcore_parts(mol):
    """ops/integrals/j1e.py hcore_parts with the twin class_stv."""
    from pyscf_tpu_torch.ops.integrals import int1e, j3c
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=mol.device)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=mol.device)
    pieces, row_ids = [], []
    for (la, lb), (bc, p) in j3c.screened_pairs(mol).items():
        pieces.append(int1e.class_stv(la, lb, *p, zr, zq).reshape(-1, 3))
        row_ids.append(j3c._row_maps(mol, bc))
    nao = mol.nao
    return j3c._assemble(pieces, row_ids, nao).T.reshape(3, nao, nao)


def h2o10_path(pt, refs, kernels, report):
    """BASELINE config 3 at full width: (H2O)10 DF-RHF/cc-pVTZ
    (cc-pvtz-jkfit, nao 580, naux 1390) through
    scf.RHF(M(...)).density_fit().kernel() (minao, conv_tol 1e-8) with the
    launch counts set to 0 just before and read just after; its wall, phases
    and peak memory, the eigh residual at n = nao; int1e_stv (1e-12),
    int3c2e and int2c2e (1e-12 x max) against their twins at its shapes and
    B under one whitener (1e-10); then the SCF at conv_tol 1e-10 on the
    kernels' integrals and on the twins' (S/T/V, rows and metric from the
    plain versions on the card), within 1e-8 Ha of each other. Returns
    launches."""
    from pyscf_tpu_torch.ops.integrals import j3c

    def build():
        mf = pt.scf.RHF(pt.M(atom=refs.H2O10, basis='cc-pvtz')).density_fit()
        mf.init_guess = 'minao'
        mf.conv_tol = 1e-8
        return mf

    torch.cuda.reset_peak_memory_stats()
    mf, e, launches = run_path('DF-RHF (H2O)10/cc-pVTZ', kernels,
                               ('int1e_stv', 'int3c2e', 'int2c2e'), build)
    mol, auxmol = mf.mol, mf.with_df.auxmol
    plateau = E_ELEC_H2O10_TPU_PLATEAU + mf.energy_nuc()
    print(f'(H2O)10/cc-pVTZ: nao {mol.nao}, naux {auxmol.nao}, B '
          f'{mf.with_df.cderi.numel() * 8 / 1e9:.3f} GB, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; E {e!r}; the '
          f'JAX package on the TPU (not gated: its SCF stalled) reported '
          f'{E_H2O10_TPU!r} ({e - E_H2O10_TPU:.3e} from the port) and '
          f'stalled at {plateau!r} ({e - plateau:.3e})')
    check(mol.nao == 580 and auxmol.nao == 1390, '(H2O)10: nao or naux')
    eigh_residual(mf)

    stv_phase(kernels, mol, 'int1e_stv_tz', report)
    rows_p, jg_p = df_integral_phase(kernels, mol, auxmol, '_tz', report)

    # the same SCF on the twins' integrals: S/T/V and the factor of a fresh
    # Mole replaced before its first use
    mf.conv_tol = 1e-10
    e_k, s_k = host_s(mf.kernel)
    check(mf.converged, '(H2O)10 at conv_tol 1e-10 did not converge')
    mol_p = pt.M(atom=refs.H2O10, basis='cc-pvtz')
    mol_p._j3c_cache['stv'] = plain_hcore_parts(mol_p)
    linv_p = j3c.whitener(jg_p)
    B_p = j3c.whitened_factor(mol_p, auxmol, rows_p, linv_p)
    del rows_p
    ao = j3c._to_ao_order(auxmol, B_p.device)
    mol_p._df_cache[(str(None), None)] = (auxmol, B_p,
                                          linv_p[ao][:, ao])
    mf_p = pt.scf.RHF(mol_p).density_fit()
    mf_p.init_guess = 'minao'
    mf_p.conv_tol = 1e-10
    e_p = mf_p.kernel()
    print(f'(H2O)10 at conv_tol 1e-10: kernels E {e_k!r} ({mf.scf_cycles} '
          f'cycles, {s_k:.3f} s), twins E {e_p!r} ({mf_p.scf_cycles} '
          f'cycles); difference {e_k - e_p:.3e}; conv_tol 1e-8 - 1e-10 '
          f'{e - e_k:.3e}')
    check(mf_p.converged, '(H2O)10 on the twins\' integrals did not converge')
    check(abs(e_k - e_p) < 1e-8, f'(H2O)10: |E(kernels) - E(twins)| '
          f'{abs(e_k - e_p):.3e} >= 1e-8')
    return launches


def tz_water_references(pt, refs):
    """Water/cc-pVTZ DF-RHF and water/def2-TZVP DF-RKS b3lypg (grids level
    1; minao, conv_tol 1e-10) on the card within 1e-8 Ha of the recorded
    JAX energies: f shells on O, and the aux to g."""
    for name, basis, xc, ref in (
            ('DF-RHF', 'cc-pvtz', None, refs.E_WATER_DF_RHF_CCPVTZ),
            ('DF-RKS b3lypg', 'def2-tzvp', 'b3lypg',
             refs.E_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1)):
        mol = pt.M(atom=refs.WATER, basis=basis)
        mf = (mol.RKS(xc=xc) if xc else mol.RHF()).density_fit()
        if xc:
            mf.grids.level = 1
        mf.init_guess = 'minao'
        mf.conv_tol = 1e-10
        e = mf.kernel()
        print(f'water {name}/{basis}: E {e!r}, E - E_ref {e - ref:.3e}')
        check(mf.converged and abs(e - ref) < 1e-8,
              f'water {name}/{basis}: converged {mf.converged}, '
              f'|E - E_ref| {abs(e - ref):.3e}')


def int2e_rows(kernels, mol, name, report, omega=None):
    """Every ordered pair of mol's screened classes through the `int2e`
    kernel and its twin, <= 1e-12 x max; recorded as name. Returns the
    twin's pieces."""
    from pyscf_tpu_torch.ops.integrals import j2e, j3c

    classes = j3c.screened_pairs(mol)
    kets = j2e._ket_arrays(mol)

    def pieces(fn):
        return [fn(la, lb, *p, kets, omega)
                for (la, lb), (_, p) in classes.items()]

    k_out = pieces(kernels.int2e)
    p_out, plain_s = host_s(lambda: pieces(j2e.int2e_class_plain))
    err, scale = max_abs(list(zip(k_out, p_out)))
    nrow = sum(p.shape[0] for p in k_out)
    print(f'{name}: {len(classes)} bra classes x {len(kets)} ket classes, '
          f'stacked rows {nrow} x {k_out[0].shape[1]}, dense (nao)^4 '
          f'{mol.nao ** 4 * 8 / 1e9:.3f} GB')
    for cls, k, p in zip(classes, k_out, p_out):
        if max(cls) == 4:       # the g bra classes, each to its own size
            e_c, s_c = max_abs([(k, p)])
            print(f'{name} {cls}: max_abs_err {e_c:.3e} of {s_c:.3e}')
            check(e_c <= 1e-12 * s_c, f'{name} {cls} vs plain: {e_c:.3e} '
                  f'> 1e-12 x {s_c:.3e}')
    ops = sum(quartet_ops(la, lb, p, lc, ld, ket)
              for (la, lb), (_, p) in classes.items()
              for lc, ld, *ket in kets)
    ops += sum(pair_e_ops(la, lb, p, True)
               for (la, lb), (_, p) in classes.items())
    ops += sum(pair_e_ops(lc, ld, ket, False) for lc, ld, *ket in kets)
    io = sum(nbytes(*p) for _, p in classes.values()) + nbytes(*k_out)
    record(report, name, 'pyscf_tpu_torch/csrc/int2e.cu',
           'pyscf_tpu/ops/integrals/j2e.py:42', err,
           lambda: pieces(kernels.int2e), plain_s * 1e3, io, ops)
    check(err <= 1e-12 * scale, f'{name} vs plain: {err:.3e} > 1e-12 x '
          f'{scale:.3e}')
    return p_out


def post_hf_energies(mf):
    """(E_MP2, E_CCSD, E_(T)) of a converged RHF, CCSD at conv_tol 1e-10
    and conv_tol_normt 1e-8."""
    e_mp2 = mf.MP2().kernel()[0]
    mycc = mf.CCSD()
    mycc.conv_tol = 1e-10
    mycc.conv_tol_normt = 1e-8
    e_cc = mycc.kernel()[0]
    check(mycc.converged, 'CCSD did not converge')
    return e_mp2, e_cc, mycc.ccsd_t()


def n2_qz_path(pt, refs, kernels, report):
    """BASELINE config 4 at full width: N2/cc-pVQZ (nao 110, g shells)
    in-core. int2e against its twin over every ordered class pair (1e-12 x
    max, each (gg|..) block to its own size) and int1e_stv likewise; the
    twin's ERI tensor assembled and RHF (minao, conv_tol 1e-12,
    conv_tol_grad 1e-9), MP2, CCSD and (T) run on it (mf._eri assigned);
    then the same through the entry points, M(...).RHF().run(), MP2(),
    CCSD(), ccsd_t(), with the launch counts set to 0 just before and read
    just after: converged, every energy within 1e-8 Ha of the twins'.
    Returns launches."""
    from pyscf_tpu_torch.ops.integrals import j2e, j3c

    mol = pt.M(atom=refs.N2, basis='cc-pvqz')
    check(mol.nao == 110 and max(mol.shell_groups) == 4, 'N2/cc-pVQZ shells')
    stv_phase(kernels, mol, 'int1e_stv_qz', report)
    p_out = int2e_rows(kernels, mol, 'int2e_qz', report)
    bcs = [bc for bc in j3c._bra_classes(mol).values() if bc.nsel]
    n = sum(p.shape[0] for p in p_out)
    eri_p = j2e._assemble_4c(p_out, j2e._index_map(mol, bcs, n), mol.nao)
    del p_out
    mf_p = tight_scf(pt.M(atom=refs.N2, basis='cc-pvqz').RHF())
    mf_p._eri = eri_p
    mf_p.run()
    check(mf_p.converged, 'N2/cc-pVQZ RHF on the twins\' ERIs did not '
          'converge')
    e_p = (mf_p.e_tot,) + post_hf_energies(mf_p)
    print(f'N2/cc-pVQZ on the twins\' ERIs: E_HF, E_MP2, E_CCSD, E_(T) '
          f'{e_p}')
    del mf_p, eri_p
    torch.cuda.empty_cache()
    mf, _, launches = postscf_path(
        'N2/cc-pVQZ CCSD(T)', kernels,
        lambda: pt.M(atom=refs.N2, basis='cc-pvqz').RHF(), e_p[1:])
    print(f'N2/cc-pVQZ E_HF {mf.e_tot!r}, E - E(twins) '
          f'{mf.e_tot - e_p[0]:.3e}; nocc {mf.mol.nelectron // 2}, nvir '
          f'{mf.mol.nao - mf.mol.nelectron // 2}')
    check(abs(mf.e_tot - e_p[0]) < 1e-8, f'N2/cc-pVQZ E_HF |E - E(twins)| '
          f'{abs(mf.e_tot - e_p[0]):.3e}')
    for k in ('int2e', 'int1e_stv'):
        check(launches[k] > 0, f'N2/cc-pVQZ: kernel {k} never launched')
    return launches


def neon_qz_references(pt, refs, kernels):
    """Ne/cc-pVQZ in-core RHF (minao, conv_tol 1e-12, conv_tol_grad 1e-9),
    MP2, CCSD and (T) on the card within 1e-8 Ha of the recorded JAX
    energies: the g shells' quartets through the whole post-HF path."""
    mf, _, _ = postscf_path(
        'Ne/cc-pVQZ CCSD(T)', kernels,
        lambda: pt.M(atom='Ne 0 0 0', basis='cc-pvqz').RHF(),
        (refs.E_NE_MP2_CCPVQZ, refs.E_NE_CCSD_CCPVQZ, refs.E_NE_CCSD_T_CCPVQZ))
    de = mf.e_tot - refs.E_NE_RHF_CCPVQZ
    print(f'Ne/cc-pVQZ RHF: E - E_ref {de:.3e}')
    check(abs(de) < 1e-8, f'Ne/cc-pVQZ RHF |E - E_ref| {abs(de):.3e}')


# ---- f and g shells in the derivative and Hessian kernels -------------------

# the sources and the JAX programs of the derivative and Hessian kernels
DERIV_SOURCES = {
    'int1e_ip': ('int1e_ip.cu', 'pyscf_tpu/ops/integrals/int1e_deriv.py:32'),
    'int1e_iprinv': ('int1e_iprinv.cu',
                     'pyscf_tpu/ops/integrals/int1e_deriv.py:136'),
    'int3c2e_ip': ('int3c2e_ip.cu', 'pyscf_tpu/grad/autodiff.py:148'),
    'int2c2e_ip1': ('int2c2e_ip1.cu', 'pyscf_tpu/grad/autodiff.py:131'),
    'int1e_ipip': ('int1e_ipip.cu', 'pyscf_tpu/hessian/rhf.py:327'),
    'int3c2e_ip1': ('int3c2e_ip1.cu', 'pyscf_tpu/hessian/rhf.py:270'),
    'int2c2e_ip1_full': ('int2c2e_ipip.cu', 'pyscf_tpu/hessian/rhf.py:270'),
    'int3c2e_ipip': ('int3c2e_ipip.cu', 'pyscf_tpu/hessian/rhf.py:327'),
    'int2c2e_ipip': ('int2c2e_ipip.cu', 'pyscf_tpu/hessian/rhf.py:327')}


def fg_deriv_phase(pt, refs, kernels, report, tag, basis):
    """Every class of the derivative and Hessian kernels at water/<basis>'s
    shapes with its JKFIT set (cc-pVQZ: every ordered class to (g, g), aux
    to h) against the plain twins on the card on the same inputs (seeded
    D, W, Gamma rows and W_PQ), each kernel within 1e-12 of its twin's
    largest element; recorded as <kernel>_<tag>."""
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.ops.integrals import int1e, int1e_deriv, j3c

    mol = pt.M(atom=refs.WATER, basis=basis, device='cuda')
    auxmol = make_auxmol(mol)
    dev, natm = mol.device, mol.natm
    print(f'water/{basis}: nao {mol.nao}, naux {auxmol.nao}, shells to l '
          f'{max(mol.shell_groups)}, aux to l {max(auxmol.shell_groups)}')
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(12)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    cross = int1e.cross_pairs(mol, mol)
    classes = j3c.screened_pairs(mol)
    aux = j3c.aux_tables(auxmol)
    aux_nnz = {l: float(_nnz(c).sum()) for l, _, c, _ in aux}
    aux_bytes = sum(nbytes(*a[1:]) for a in aux)
    naux = auxmol.nao

    def compare(name, calls, ops, in_bytes):
        """calls(fn) -> outputs through fn, the kernel or its twin."""
        k_fn = getattr(kernels, name)
        k_out = calls(k_fn)
        with plain_kernels(kernels, (name,)):
            p_fn = getattr(kernels, name)
            p_out, plain_s = host_s(lambda: calls(p_fn))
        k_out = k_out if isinstance(k_out, list) else [k_out]
        p_out = p_out if isinstance(p_out, list) else [p_out]
        err, scale = max_abs(list(zip(k_out, p_out)))
        src, replaces = DERIV_SOURCES[name]
        record(report, f'{name}_{tag}', f'pyscf_tpu_torch/csrc/{src}',
               replaces, err, lambda: calls(k_fn), plain_s * 1e3,
               in_bytes + nbytes(*k_out), ops)
        check(err <= 1e-12 * scale, f'{name}_{tag} vs plain: {err:.3e} > '
              f'1e-12 x {scale:.3e}')

    pair_bytes = sum(nbytes(*p) for *_, p in cross) + nbytes(zr, zq)
    compare('int1e_ip', lambda fn: [fn(la, lb, *p, zr, zq)
                                    for la, lb, _, _, p in cross],
            sum(ip_ops(la, lb, p, natm) for la, lb, _, _, p in cross),
            pair_bytes)
    compare('int1e_iprinv', lambda fn: [fn(la, lb, *p, zr)
                                        for la, lb, _, _, p in cross],
            sum(iprinv_ops(la, lb, p, natm) for la, lb, _, _, p in cross),
            pair_bytes)
    dw = [(normal(p[0].shape[0], (2 * la + 1) * (2 * lb + 1)),
           normal(p[0].shape[0], (2 * la + 1) * (2 * lb + 1)))
          for la, lb, _, _, p in cross]
    compare('int1e_ipip', lambda fn: [
        fn(la, lb, *p, zr, zq, D, W)
        for (la, lb, _, _, p), (D, W) in zip(cross, dw)],
        sum(ipip_1e_ops(la, lb, p, natm) for la, lb, _, _, p in cross),
        pair_bytes + sum(nbytes(D, W) for D, W in dw))

    G = {cls: normal(p[0].shape[0] * (2 * cls[0] + 1) * (2 * cls[1] + 1),
                     naux) for cls, (_, p) in classes.items()}
    rows_bytes = sum(nbytes(*p) for _, p in classes.values()) + aux_bytes
    ops_ip = ops_ipip = ops_ip1 = 0.0
    for (la, lb), (_, p) in classes.items():
        prims = float(_prim_pairs(p).sum())
        for l, e, _, _ in aux:
            triples = prims * aux_nnz[l]
            ops_ip += coulomb_ip_ops(la, lb, l, prims, e.shape[0], triples)
            ops_ipip += coulomb_ipip_ops(la, lb, l, prims, e.shape[0],
                                         triples)
            for a, b in {(la, lb), (lb, la)}:
                ops_ip1 += coulomb_ip1_ops(a, b, l, prims, e.shape[0],
                                           triples)
    for name, ops in (('int3c2e_ip', ops_ip), ('int3c2e_ipip', ops_ipip)):
        compare(name, lambda fn: [fn(*cls, *p, aux, G[cls])
                                  for cls, (_, p) in classes.items()],
                ops, rows_bytes + nbytes(*G.values()))
    del G
    compare('int3c2e_ip1', lambda fn: ip1_all(fn, mol, classes, aux),
            ops_ip1, rows_bytes)

    W = normal(naux, naux)
    W = W + W.T
    ops_2c = {'int2c2e_ip1': 0.0, 'int2c2e_ip1_full': 0.0,
              'int2c2e_ipip': 0.0}
    for lx, ex, cx, _ in aux:
        for ly, ey, cy, _ in aux:
            px, py = float(_nnz(cx).sum()), float(_nnz(cy).sum())
            ops_2c['int2c2e_ip1'] += coulomb_ip_ops(
                ly, 0, lx, py, ex.shape[0], py * px, False)
            ops_2c['int2c2e_ip1_full'] += coulomb_ip1_ops(
                lx, 0, ly, px, ey.shape[0], px * py)
            ops_2c['int2c2e_ipip'] += coulomb_ipip_ops(
                ly, 0, lx, py, ex.shape[0], py * px, False)
    compare('int2c2e_ip1', lambda fn: fn(aux, W), ops_2c['int2c2e_ip1'],
            aux_bytes + nbytes(W))
    compare('int2c2e_ip1_full', lambda fn: fn(aux), ops_2c['int2c2e_ip1_full'],
            aux_bytes)
    compare('int2c2e_ipip', lambda fn: fn(aux, W), ops_2c['int2c2e_ipip'],
            aux_bytes + nbytes(W))


def boys_both_sides(pt, kernels):
    """int3c2e_ipip's (gg|h) class, where R_tuv reaches order 15, the
    highest of the derivative and Hessian kernels: two g shells of two
    primitives (exponents 6 and 0.3) on two centres 3 Angstrom apart
    against an h aux shell of the same two primitives on each centre, so
    that the Boys argument T = rho |P - C|^2 of the primitive triples lies
    on both sides of the series' limit 18; on seeded Gamma rows, within
    1e-12 of the twin's largest element."""
    from pyscf_tpu_torch.ops.integrals import j3c, j3c_deriv

    atom = 'Ne 0 0 0; Ne 0 0 3.0'
    mol = pt.M(atom=atom, basis=[[4, [6.0, 0.5], [0.3, 0.5]]])
    auxmol = pt.M(atom=atom, basis=[[5, [6.0, 0.5], [0.3, 0.5]]])
    gg = j3c.screened_pairs(mol)[(4, 4)][1]
    aux = j3c.aux_tables(auxmol)
    a, b = gg[0][:, :, None], gg[3][:, None, :]
    p = (a + b).reshape(-1)
    P = ((a[..., None] * gg[2][:, None, None, :] + b[..., None]
          * gg[5][:, None, None, :]) / (a + b)[..., None]).reshape(-1, 3)
    T = []
    for _, e, _, r in aux:
        c = e.reshape(-1)
        C = r[:, None, :].expand(-1, e.shape[1], -1).reshape(-1, 3)
        rho = p[:, None] * c[None, :] / (p[:, None] + c[None, :])
        T.append((rho * ((P[:, None, :] - C[None, :, :]) ** 2).sum(-1))
                 .reshape(-1))
    T = torch.cat(T)
    below, above = int((T < 18).sum()), int((T >= 18).sum())
    G = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (gg[0].shape[0] * 81, auxmol.nao)), device=mol.device)
    err, scale = max_abs([(kernels.int3c2e_ipip(4, 4, *gg, aux, G),
                           j3c_deriv.int3c2e_ipip_plain(4, 4, *gg, aux, G))])
    print(f'int3c2e_ipip (gg|h) at R_tuv order 15, Boys T from '
          f'{float(T.min()):.3e} to {float(T.max()):.3e} ({below} primitive '
          f'triples below 18, {above} at or above): max_abs_err {err:.3e} '
          f'of {scale:.3e}')
    check(below > 0 and above > 0, 'Boys T not on both sides of 18')
    check(err <= 1e-12 * scale, f'int3c2e_ipip (gg|h) on both sides of T = '
          f'18 vs plain: {err:.3e} > 1e-12 x {scale:.3e}')


def h2o10_forces_path(pt, refs, kernels):
    """BASELINE config 3's forces at full width: (H2O)10 DF-RHF/cc-pVTZ
    from M() (minao, conv_tol 1e-10, conv_tol_grad 1e-7) through
    nuc_grad_method().kernel(), the launch counts set to 0 before M() and
    read after the gradient: |sum_A de[A]| < 1e-9, central differences on
    one O and one H coordinate within 1e-6, and the same gradient with the
    four derivative kernels replaced by their plain twins on the card
    within 1e-8; the wall from M(), the gradient's phases, its warm time
    and the peak memory printed. Returns (mf, launches)."""
    mf, grad, de, launches = df_grad_path(
        'DF-RHF (H2O)10/cc-pVTZ + gradient', kernels,
        lambda: tight(pt.scf.RHF(pt.M(atom=refs.H2O10, basis='cc-pvtz'))
                      .density_fit()), None, DF_GRAD_KERNELS)
    drift = float(np.abs(de.sum(axis=0)).max())
    print(f'(H2O)10 |sum_A de[A]| {drift:.3e}')
    check(drift < 1e-9, f'(H2O)10 gradient sum rule: {drift:.3e} >= 1e-9')
    central_differences(
        '(H2O)10', de, lambda m: tight(m.RHF().density_fit()).kernel(),
        mf.mol, [(0, 2), (1, 0)], 1e-6)
    warm_gradient('(H2O)10', grad)
    cache = mf.mol._j3c_cache
    cache.pop('ip1e')
    with plain_kernels(kernels, DF_GRAD_KERNELS):
        de_p, s_p = host_s(mf.nuc_grad_method().kernel)
    cache.pop('ip1e')
    diff = float(np.abs(de - de_p).max())
    print(f'(H2O)10 gradient on the twins\' integrals ({s_p:.1f} s): max '
          f'|de - de_twins| {diff:.3e}')
    check(diff < 1e-8, f'(H2O)10 gradient vs the twins\' {diff:.3e} >= 1e-8')
    return mf, launches


def tz_water_gradients(pt, refs):
    """Water/cc-pVTZ DF-RHF and water/def2-TZVP DF-RKS b3lypg (grids level
    1) forces on the card within 1e-8 of the recorded JAX gradients."""
    for name, basis, xc, ref in (
            ('DF-RHF', 'cc-pvtz', None, refs.GRAD_WATER_DF_RHF_CCPVTZ),
            ('DF-RKS b3lypg', 'def2-tzvp', 'b3lypg',
             refs.GRAD_WATER_DF_RKS_B3LYPG_DEF2TZVP_L1)):
        mol = pt.M(atom=refs.WATER, basis=basis)
        mf = tight((mol.RKS(xc=xc) if xc else mol.RHF()).density_fit())
        if xc:
            mf.grids.level = 1
        de = mf.run().nuc_grad_method().kernel()
        err = float(np.abs(de - np.array(ref)).max())
        print(f'water/{basis} {name}: max |de - de_ref| {err:.3e}')
        check(mf.converged and err < 1e-8, f'water/{basis} {name} gradient '
              f'vs the recorded JAX gradient: {err:.3e} >= 1e-8')


def qz_water_gradient(pt, refs, kernels):
    """Water/cc-pVQZ DF-RHF (cc-pvqz-jkfit: g, aux to h) from M() through
    the gradient: the sum rule within 1e-9. Returns launches."""
    mf, _, de, launches = df_grad_path(
        'DF-RHF water/cc-pVQZ + gradient', kernels,
        lambda: tight(pt.M(atom=refs.WATER, basis='cc-pvqz').RHF()
                      .density_fit()), None, DF_GRAD_KERNELS)
    drift = float(np.abs(de.sum(axis=0)).max())
    print(f'water/cc-pVQZ |sum_A de[A]| {drift:.3e}')
    check(drift < 1e-9, f'water/cc-pVQZ gradient sum rule: {drift:.3e}')
    return launches


# ---- the Γ-point periodic SCF -----------------------------------------------
# BASELINE config 5's cell (examples/scaling_diamond.py)
DIAMOND = dict(
    atom='C 0 0 0; C 0.8917 0.8917 0.8917',
    a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834], [1.7834, 1.7834, 0]],
    basis='gth-szv', pseudo='gth-pade', verbose=0)
# the PySCF golden of diamond Γ LDA at [17]^3 (tests/test_pbc.py:35)
E_DIAMOND_LDA17_GOLDEN = -10.221426445656439
PBC_KERNELS = ('eval_ao_pbc', 'int1e_stv', 'xc_rks')


def diamond64():
    """The 64-atom diamond cell: 2x2x2 conventional cubic cells of a =
    3.5668 Angstrom (the config 5 cell's), gth-szv, gth-pade."""
    a0 = 3.5668
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0],
                      [.25, .25, .25], [.25, .75, .75], [.75, .25, .75],
                      [.75, .75, .25]])
    shifts = np.array([(i, j, k) for i in range(2) for j in range(2)
                       for k in range(2)])
    frac = (basis[None] + shifts[:, None]).reshape(-1, 3) / 2
    xyz = frac * 2 * a0
    return dict(atom=[('C', tuple(r)) for r in xyz],
                a=np.eye(3) * 2 * a0, basis='gth-szv', pseudo='gth-pade',
                verbose=0)


def pbc_refs():
    import os
    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'pyscf_tpu_torch', 'data', 'pbc_refs.npz'))


def pbc_scf(pt, kernels, name, cell_kw, make_mf, names=PBC_KERNELS,
            conv_tol=1e-9):
    """One periodic SCF from pbc.gto.M() (hcore guess, conv_tol 1e-9 unless
    given) with the launch counts set to 0 just before and read just
    after: converged, `names` launched; wall, cycles, phases and peak
    memory printed. Returns (mf, e, launches, wall)."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell = pt.pbc.gto.M(**cell_kw)
    mf = make_mf(cell)
    mf.init_guess = 'hcore'
    mf.conv_tol = conv_tol
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    phases = dict(mf.timings, **mf.with_df.timings)
    print(f'{name}: E = {e!r}  converged {mf.converged}  cycles '
          f'{mf.scf_cycles}  wall {wall:.6f} s  peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB  nk '
          f'{getattr(mf, "nkpts", 1)}  nao {cell.nao}  mesh {cell.mesh}  '
          f'images {len(cell.get_lattice_Ls())}')
    print('phase seconds: ' + '  '.join(f'{k} {v:.6f}'
                                        for k, v in phases.items()))
    print(f'launches: { {k: v for k, v in launches.items() if v} }')
    check(mf.converged, f'{name}: SCF did not converge')
    for k in names:
        check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return mf, e, launches, wall


def pbc_config5_path(pt, kernels):
    """BASELINE config 5 as published: GDF and FFTDF PBE within 1e-8 Ha of
    each other. The JAX package's periodic RKS puts half its GGA term into
    V_xc (pyscf_tpu/pbc/dft/rks.py:68-70), so its converged density is not
    the functional's stationary point: each route's energy functional at
    the recorded JAX density within 1e-10 of the JAX energy (the JAX
    functional at that density), and each SCF 1e-8 to 1e-6 Ha below it.
    Returns the GDF run's launches."""
    ref = pbc_refs()
    kw = dict(DIAMOND, mesh=[15] * 3)
    e, launches = {}, None

    def rks(c, gdf):
        mf = pt.pbc.dft.RKS(c, xc='pbe')
        return mf.density_fit() if gdf else mf

    for gdf in (True, False):
        what = 'GDF' if gdf else 'FFTDF'
        key = f'e_pbe15_{"gdf" if gdf else "fft"}'
        mf, e[gdf], runs, _ = pbc_scf(pt, kernels, f'config 5 {what} PBE',
                                      kw, lambda c, g=gdf: rks(c, g))
        launches = launches or runs
        e_dm = mf.energy_tot(torch.as_tensor(ref[f'{key}_dm'],
                                             device='cuda'))
        d_dm = e_dm - float(ref[key])
        below = float(ref[key]) - e[gdf]
        print(f'config 5 {what}: E[D_JAX] - E_JAX = {d_dm:.3e}; '
              f'E_JAX - E = {below:.3e}')
        check(abs(d_dm) < 1e-10, f'config 5 {what}: |E[D_JAX] - E_JAX| = '
              f'{abs(d_dm):.3e} >= 1e-10')
        check(1e-8 < below < 1e-6, f'config 5 {what}: E_JAX - E = '
              f'{below:.3e} outside (1e-8, 1e-6)')
    gap = e[True] - e[False]
    print(f'config 5: E(GDF) - E(FFTDF) = {gap:.3e}')
    check(abs(gap) < 1e-8, 'config 5: |E(GDF) - E(FFTDF)| >= 1e-8')
    return launches


def pbc_lda_rhf_path(pt, kernels):
    """Diamond Γ LDA at [17]^3 against the golden (1e-6) and the JAX energy
    (1e-8); Γ RHF at [17]^3 against the JAX energy (1e-8)."""
    ref = pbc_refs()
    kw = dict(DIAMOND, mesh=[17] * 3)
    _, e, _, _ = pbc_scf(pt, kernels, 'diamond LDA [17]^3', kw,
                         lambda c: pt.pbc.dft.RKS(c, xc='lda,vwn'))
    print(f'LDA: E - golden {e - E_DIAMOND_LDA17_GOLDEN:.3e}, E - E_JAX '
          f'{e - float(ref["e_lda17"]):.3e}')
    check(abs(e - E_DIAMOND_LDA17_GOLDEN) < 1e-6, 'diamond LDA vs golden')
    check(abs(e - float(ref['e_lda17'])) < 1e-8, 'diamond LDA vs JAX')
    _, e, _, _ = pbc_scf(pt, kernels, 'diamond RHF [17]^3', kw,
                         lambda c: pt.pbc.scf.RHF(c),
                         ('eval_ao_pbc', 'int1e_stv'))
    print(f'RHF: E - E_JAX {e - float(ref["e_rhf17"]):.3e}')
    check(abs(e - float(ref['e_rhf17'])) < 1e-8, 'diamond RHF vs JAX')


@contextlib.contextmanager
def plain_pbc(kernels):
    """eval_ao_pbc, eval_ao_kpts, int1e_stv, xc_rks and xc_uks replaced by
    their plain twins on the card's tensors."""
    from pyscf_tpu_torch.dft import numint
    from pyscf_tpu_torch.ops import eval_gto
    from pyscf_tpu_torch.ops.integrals import int1e

    twin = {'eval_ao_pbc': eval_gto.eval_ao_pbc_plain,
            'eval_ao_kpts': eval_gto.eval_ao_kpts_plain,
            'int1e_stv': int1e.class_stv, 'xc_rks': numint.xc_rks_plain,
            'xc_uks': numint.xc_uks_plain}
    saved = {k: getattr(kernels, k) for k in twin}
    for k, fn in twin.items():
        setattr(kernels, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)


def pbc_64_path(pt, kernels, report):
    """The 64-atom diamond cell, FFTDF PBE at its default mesh, through
    the kernels and then through their twins (1e-8 Ha), none of the three
    kernels launched in the twins' run; the seconds of XC and of FFT-J
    from their per-call CUDA-event ms at the converged density; xc_rks
    (row xc_rks_d64) and int1e_stv (row int1e_stv_pbc) against their
    twins at the shapes this cell gives them. Returns (mf, launches)."""
    make = lambda c: pt.pbc.dft.RKS(c, xc='pbe')      # noqa: E731
    mf, e, launches, wall = pbc_scf(pt, kernels, '64-atom diamond FFTDF PBE',
                                    diamond64(), make)
    df = mf.with_df
    check(mf.mol.nao == 256 and df.ngrid == 79 ** 3, '64-atom: nao or mesh')
    dm = mf.make_rdm1()
    aod = df._ao_on_grid(1)
    w = torch.full((df.ngrid,), df.weight, dtype=torch.float64,
                   device='cuda')
    core = mf._numint._get_rks_core_aod('pbe')
    ms_xc = cuda_ms(lambda: core([aod], [w], dm))
    ms_j = cuda_ms(lambda: df.get_j(dm))
    calls = mf.scf_cycles + 3        # the seed, the cycles, finalize's two
    print(f'64-atom: {mf.scf_cycles} cycles, AO values {df.timings["ao"]:.6f}'
          f' s, XC {ms_xc:.3f} ms x {calls} = {ms_xc * calls / 1e3:.6f} s, '
          f'FFT-J {ms_j:.3f} ms x {calls} = {ms_j * calls / 1e3:.6f} s, of '
          f'{wall:.6f} s')
    xc_rks_phase(kernels, 'xc_rks_d64', 'pbe', aod, dm, w, report)
    del aod
    pbc_stv_phase(kernels, mf.mol, report)
    torch.cuda.empty_cache()
    with plain_pbc(kernels):
        _, e_p, l_p, _ = pbc_scf(pt, kernels, '64-atom diamond, twins',
                                 diamond64(), make, ())
    check(all(l_p[k] == 0 for k in PBC_KERNELS),
          f'64-atom twins: a kernel launched: { {k: l_p[k] for k in PBC_KERNELS} }')
    print(f'64-atom: E(kernels) - E(twins) = {e - e_p:.3e}')
    check(abs(e - e_p) < 1e-8, '64-atom: |E(kernels) - E(twins)| >= 1e-8')
    return mf, launches


def pbc_stv_calls(cell, kernels, kpts=None):
    """The (args, kwargs) of every int1e_stv call of the cell's S/T
    lattice sums and S-only projector overlaps (pbc/df/fft.py; phased to
    kpts, if given), recorded while they run through the kernel."""
    from pyscf_tpu_torch.pbc.df.fft import FFTDF
    calls, stv = [], kernels.int1e_stv

    def spy(*args, **kw):
        calls.append((args, kw))
        return stv(*args, **kw)

    spy.launches = 0        # the wrapper counts into the name it is bound to
    kernels.int1e_stv = spy
    try:
        df = FFTDF(cell)
        df._build_st(kpts)
        df._projector_overlaps(kpts)
    finally:
        kernels.int1e_stv = stv
    return calls


def pbc_stv_phase(kernels, cell, report, name='int1e_stv_pbc', kpts=None,
                  replaces='pyscf_tpu/ops/integrals/int1e.py:36'):
    """int1e_stv against its twin on every call of the cell's S/T lattice
    sums (S, T over every (shell, shell + L) pair, no atoms) and S-only
    projector overlaps (the GTH projector's monomial combination as the
    ket's transform, sb), <= 1e-12 x max; recorded as `name`."""
    from pyscf_tpu_torch.ops.integrals import int1e
    calls = pbc_stv_calls(cell, kernels, kpts)
    run = lambda fn: [fn(*a, **kw) for a, kw in calls]   # noqa: E731
    k_out = run(kernels.int1e_stv)
    p_out, plain_s = host_s(lambda: run(int1e.class_stv))
    err, scale = max_abs(list(zip(k_out, p_out)))
    npairs = sum(a[2].shape[0] for a, _ in calls)
    print(f'{name}: {len(calls)} calls, {npairs} image pairs, '
          f'max_abs_err {err:.3e} of {scale:.3e}')
    ops = sum(stv_ops(a[0], a[1], a[2:8], 0, kw.get('with_tv', True))
              for a, kw in calls)
    io = sum(nbytes(*a[2:8]) for a, _ in calls) + nbytes(*k_out)
    del p_out
    record(report, name, 'pyscf_tpu_torch/csrc/int1e_stv.cu', replaces, err,
           lambda: run(kernels.int1e_stv), plain_s * 1e3, io, ops)
    check(err <= 1e-12 * scale, f'{name} vs plain: {err:.3e} > '
          f'1e-12 x {scale:.3e}')


def eval_ao_pbc_ops(cell, tables, coords, Ls, deriv, bloch=False):
    """FP64 operations that the lattice-summed AO values need on these
    inputs, counted on the card an image at a time: per (block of 128
    points, atom, image) a bounding-sphere cull (10); per (point, atom,
    image) in range of the atom's most diffuse primitive (a_min r^2 <=
    lcut) the distance and its screen (10), once per atom whatever its
    shells; per (point, shell, image) in range the powers, and per
    cartesian component the monomial and its accumulation (4; 28 with the
    gradients); per primitive in range the screen, the exponential
    (counted as 20) and the radial sums (5, 7 with the gradients); per
    (point, shell) the cart->sph transform. The kernel itself measures
    every (point, shell, image): that is more than the function needs and
    is not counted. bloch: the image's real values only (3; 24 with the
    gradients, per cartesian component), without the accumulation over
    images and the transform, which the Bloch sums do in their place
    (bloch_ops)."""
    from pyscf_tpu_torch.pbc.df.fft import lattice_cut
    lcut = lattice_cut(cell)
    n = coords.shape[0]
    atoms = torch.as_tensor(cell.coords, dtype=torch.float64,
                            device=coords.device)
    amin_atom = torch.full((atoms.shape[0],), 1e300, dtype=torch.float64,
                           device=coords.device)
    shells = []
    for l, e, c, r, off in tables:
        amin = torch.where(c != 0, e, torch.full_like(e, 1e300)).min(1).values
        owner = torch.cdist(r, atoms).argmin(1)
        amin_atom = amin_atom.scatter_reduce(0, owner, amin, 'amin')
        shells.append((l, e, c, r))
    nblocks = -(-n // 128)
    ops = 10 * nblocks * atoms.shape[0] * Ls.shape[0]
    for l, e, c, r in shells:
        nc = (l + 1) * (l + 2) // 2
        if not bloch:
            ops += 2 * nc * (2 * l + 1) * n * e.shape[0] * (4 if deriv else 1)
    per_cart = (28 if deriv else 4) - (4 if deriv else 1) * bloch
    for L in Ls:
        d = coords[:, None, :] - atoms[None] - L
        ops += 10 * int((amin_atom[None] * torch.sum(d * d, dim=-1)
                         <= lcut).sum())
        for l, e, c, r in shells:
            amin = torch.where(c != 0, e,
                               torch.full_like(e, 1e300)).min(1).values
            d = coords[:, None, :] - r[None] - L
            r2 = torch.sum(d * d, dim=-1)                  # (n, ns)
            near = amin[None] * r2 <= lcut
            prims = ((e[None] * r2[..., None] <= lcut) & (c[None] != 0)
                     & near[..., None])
            nc = (l + 1) * (l + 2) // 2
            ops += int(near.sum()) * (3 * max(l - 1, 0) + nc * per_cart)
            ops += int(prims.sum()) * (27 if deriv else 25)
    return ops


def eval_ao_pbc_phase(kernels, cell, report, name):
    """eval_ao_pbc against its twin on the cell's grid, deriv 0 and 1
    (<= 1e-12 x max), recorded at deriv 1 as name."""
    from pyscf_tpu_torch.ops import eval_gto
    from pyscf_tpu_torch.pbc.df.fft import lattice_cut
    tables = eval_gto.ao_tables(cell)
    coords = torch.as_tensor(cell.get_uniform_grids(), device='cuda')
    Ls = torch.as_tensor(cell.get_lattice_Ls(), device='cuda')
    lcut = lattice_cut(cell)
    for deriv in (0, 1):
        got = kernels.eval_ao_pbc(tables, coords, Ls, cell.nao, deriv, lcut)
        ref, plain_s = host_s(lambda: eval_gto.eval_ao_pbc_plain(
            tables, coords, Ls, cell.nao, deriv, lcut))
        err, scale = max_abs([(got, ref)])
        print(f'{name} deriv {deriv}: max_abs_err {err:.3e} of {scale:.3e}')
        check(err <= 1e-12 * scale, f'{name} deriv {deriv} vs plain: '
              f'{err:.3e} > 1e-12 x {scale:.3e}')
        del got, ref
    io = nbytes(coords, Ls, *[t for tab in tables for t in tab[1:]]) \
        + 4 * coords.shape[0] * cell.nao * 8
    record(report, name, 'pyscf_tpu_torch/csrc/eval_ao_pbc.cu',
           'pyscf_tpu/pbc/df/fft.py:14', err,
           lambda: kernels.eval_ao_pbc(tables, coords, Ls, cell.nao, 1, lcut),
           lambda: eval_gto.eval_ao_pbc_plain(tables, coords, Ls, cell.nao,
                                              1, lcut),
           io, eval_ao_pbc_ops(cell, tables, coords, Ls, 1), plain_reps=1)


def pbc_paths(pt, kernels, report, launches):
    """Config 5, the LDA golden and Γ RHF, the 64-atom cell and
    eval_ao_pbc's phases at both shapes."""
    launches['eval_ao_pbc'] = pbc_config5_path(pt, kernels)['eval_ao_pbc']
    torch.cuda.empty_cache()
    pbc_lda_rhf_path(pt, kernels)
    torch.cuda.empty_cache()
    mf, l64 = pbc_64_path(pt, kernels, report)
    launches['eval_ao_pbc_d64'] = l64['eval_ao_pbc']
    launches['int1e_stv_pbc'] = l64['int1e_stv']
    launches['xc_rks_d64'] = l64['xc_rks']
    cell64 = mf.mol
    del mf
    torch.cuda.empty_cache()
    eval_ao_pbc_phase(kernels, pt.pbc.gto.M(mesh=[15] * 3, **DIAMOND),
                      report, 'eval_ao_pbc')
    cell64._pbc_cache.clear()
    torch.cuda.empty_cache()
    eval_ao_pbc_phase(kernels, cell64, report, 'eval_ao_pbc_d64')


# ---- the k-point periodic SCF ----------------------------------------------
# PySCF's golden of diamond KRKS-LDA on the shifted 2x2x2 mesh at [17]^3
# (tests/test_pbc.py:109-118, after pbc/dft/test/test_krks.py:121)
E_DIAMOND_KRKS_LDA_222 = -11.353643583707452
# the primitive cell at double zeta with polarisation (nao 26, its default
# mesh [25]^3)
DIAMOND_DZVP = dict(DIAMOND, basis='gth-dzvp')
KPTS_KERNELS = ('eval_ao_kpts', 'int1e_stv')
TWINNED = ('eval_ao_kpts', 'int1e_stv', 'xc_rks', 'xc_uks')


def kpts_scf(pt, kernels, name, cell_kw, make_mf, kmesh, gamma=True,
             names=KPTS_KERNELS + ('xc_rks',)):
    """pbc_scf of make_mf(cell, kpts) on the kmesh Monkhorst-Pack mesh
    (Γ-centred, or shifted unless gamma), conv_tol 1e-10."""
    return pbc_scf(pt, kernels, name, cell_kw, lambda c: make_mf(
        c, c.make_kpts(kmesh, with_gamma_point=gamma)), names, 1e-10)


def kpts_twins(pt, kernels, name, e, *args, **kw):
    """The same k-point SCF with eval_ao_kpts, int1e_stv, xc_rks and
    xc_uks replaced by their plain twins: none of them launched, the
    energy within 1e-9 Ha of e."""
    torch.cuda.empty_cache()
    with plain_pbc(kernels):
        _, e_p, l_p, _ = kpts_scf(pt, kernels, f'{name}, twins', *args,
                                  names=(), **kw)
    check(all(l_p[k] == 0 for k in TWINNED), f'{name} twins: a kernel '
          f'launched: { {k: l_p[k] for k in TWINNED} }')
    print(f'{name}: E(kernels) - E(twins) = {e - e_p:.3e}')
    check(abs(e - e_p) < 1e-9, f'{name}: |E(kernels) - E(twins)| >= 1e-9')


def kpts_golden_path(pt, kernels):
    """Diamond KRKS-LDA on the shifted 2x2x2 mesh at [17]^3 against PySCF's
    golden (2e-6); KRKS-PBE and KUKS-PBE on the same closed-shell cell
    within 1e-9 Ha of each other."""
    kw = dict(DIAMOND, mesh=[17] * 3)
    _, e, _, _ = kpts_scf(
        pt, kernels, 'diamond KRKS-LDA 2x2x2 [17]^3', kw,
        lambda c, k: pt.pbc.dft.KRKS(c, kpts=k, xc='lda,vwn'), [2, 2, 2],
        gamma=False)
    print(f'KRKS-LDA 2x2x2: E - golden {e - E_DIAMOND_KRKS_LDA_222:.3e}')
    check(abs(e - E_DIAMOND_KRKS_LDA_222) < 2e-6, 'KRKS-LDA 2x2x2 vs golden')
    _, e_r, _, _ = kpts_scf(
        pt, kernels, 'diamond KRKS-PBE 2x2x2 [17]^3', kw,
        lambda c, k: pt.pbc.dft.KRKS(c, kpts=k, xc='pbe'), [2, 2, 2],
        gamma=False)
    _, e_u, _, _ = kpts_scf(
        pt, kernels, 'diamond KUKS-PBE 2x2x2 [17]^3', kw,
        lambda c, k: pt.pbc.dft.KUKS(c, kpts=k, xc='pbe'), [2, 2, 2],
        gamma=False, names=KPTS_KERNELS + ('xc_uks',))
    print(f'closed-shell KUKS - KRKS (PBE) = {e_u - e_r:.3e}')
    check(abs(e_u - e_r) < 1e-9, 'closed-shell |KUKS - KRKS| >= 1e-9')


def bloch_ops(cell, tables, coords, Ls, nk, deriv):
    """(FP64 operations, tensor-core FP64 operations) of the Bloch sums,
    with the cart->sph transform before the phases: per (point, shell,
    image) in range of the shell's most diffuse primitive (a_min r^2 <=
    lcut) the transform of each component, 2 per nonzero of the cart->sph
    matrix for l >= 2 (at l <= 1 it is a scale that the coefficients can
    hold), and the phase products, 4 per k, component and spherical
    function: a contraction over the image axis, a matrix product."""
    from pyscf_tpu_torch.ops.integrals.int1e import sph
    from pyscf_tpu_torch.pbc.df.fft import lattice_cut
    lcut = lattice_cut(cell)
    ncomp = 4 if deriv else 1
    ops = tc_ops = 0
    for l, e, c, r, off in tables:
        amin = torch.where(c != 0, e, torch.full_like(e, 1e300)).min(1).values
        nnz = int((sph(l, 'cpu') != 0).sum()) if l >= 2 else 0
        near = 0
        for L in Ls:
            d = coords[:, None, :] - r[None] - L
            near += int((amin[None] * torch.sum(d * d, dim=-1) <= lcut).sum())
        ops += 2 * nnz * ncomp * near
        tc_ops += 4 * nk * ncomp * (2 * l + 1) * near
    return ops, tc_ops


def eval_ao_kpts_phase(kernels, cell, kpts, report):
    """eval_ao_kpts against its twin on the cell's grid for kpts, deriv 0
    and 1 (<= 1e-12 x max), recorded at deriv 1 as eval_ao_kpts; its
    operations bound eval_ao_pbc's in-range work of each image plus the
    Bloch sums (bloch_ops), their phase products at the tensor cores'
    rate."""
    from pyscf_tpu_torch.ops import eval_gto
    from pyscf_tpu_torch.pbc.df.fft import kpts_phases, lattice_cut
    tables = eval_gto.ao_tables(cell)
    coords = torch.as_tensor(cell.get_uniform_grids(), device='cuda')
    Ls_np = cell.get_lattice_Ls()
    Ls = torch.as_tensor(Ls_np, device='cuda')
    ph = kpts_phases(kpts, Ls_np, 'cuda')
    lcut = lattice_cut(cell)
    args = (tables, coords, Ls, ph, cell.nao)
    for deriv in (0, 1):
        got = kernels.eval_ao_kpts(*args, deriv, lcut)
        ref, plain_s = host_s(lambda: eval_gto.eval_ao_kpts_plain(
            *args, deriv, lcut))
        err, scale = max_abs([(got, ref)])
        print(f'eval_ao_kpts deriv {deriv} ({len(kpts)} k): max_abs_err '
              f'{err:.3e} of {scale:.3e} (twin {plain_s:.3f} s)')
        check(err <= 1e-12 * scale, f'eval_ao_kpts deriv {deriv} vs plain: '
              f'{err:.3e} > 1e-12 x {scale:.3e}')
        del got, ref
        torch.cuda.empty_cache()
    io = nbytes(coords, Ls, torch.view_as_real(ph),
                *[t for tab in tables for t in tab[1:]]) \
        + len(kpts) * 4 * coords.shape[0] * cell.nao * 16
    ops, tc_ops = bloch_ops(cell, tables, coords, Ls, len(kpts), 1)
    ops += eval_ao_pbc_ops(cell, tables, coords, Ls, 1, bloch=True)
    print(f'eval_ao_kpts: {ops:.4e} FP64 operations, {tc_ops:.4e} in the '
          f'phase products')
    record(report, 'eval_ao_kpts', 'pyscf_tpu_torch/csrc/eval_ao_kpts.cu',
           'pyscf_tpu/pbc/df/fft.py:332', err,
           lambda: kernels.eval_ao_kpts(*args, 1, lcut), plain_s * 1e3, io,
           ops, tc_ops=tc_ops)


def kpts_64_path(pt, kernels, report):
    """Diamond gth-dzvp PBE on the Γ-centred 4x4x4 mesh (64 k-points) at
    its default mesh: converged; xc_rks at the stacked k-point rows of the
    converged density (row xc_rks_k64), int1e_stv on every call of the
    cell's phased S/T and projector overlaps (row int1e_stv_kpts) and
    eval_ao_kpts (row eval_ao_kpts) against their twins; then the same SCF
    on the twins, none launched, within 1e-9 Ha. Returns its launches."""
    from pyscf_tpu_torch.pbc.dft.krks import stack_kpts
    make = lambda c, k: pt.pbc.dft.KRKS(c, kpts=k, xc='pbe')  # noqa: E731
    args = ('4x4x4 diamond gth-dzvp KRKS-PBE', DIAMOND_DZVP, make, [4, 4, 4])
    mf, e, launches, wall = kpts_scf(pt, kernels, *args)
    df = mf.with_df
    cell, kpts = mf.cell, mf.kpts
    check(mf.nkpts == 64 and cell.nao == 26 and df.ngrid == 25 ** 3,
          '4x4x4: nk, nao or mesh')
    aod = df._ao_on_grid_kpts(1)
    w = torch.full((df.ngrid,), df.weight, dtype=torch.float64,
                   device='cuda')
    rows = stack_kpts(aod)
    dmao = stack_kpts(aod[:, 0] @ (mf.make_rdm1() / mf.nkpts))
    ms_j = cuda_ms(lambda: df.get_j_kpts(mf.make_rdm1()))
    print(f'4x4x4: {mf.scf_cycles} cycles, wall {wall:.6f} s, FFT-J '
          f'{ms_j:.3f} ms a call; with_df.timings {df.timings}')
    xc_rks_phase(kernels, 'xc_rks_k64', 'pbe', rows, None, w, report,
                 dmao=dmao, replaces='pyscf_tpu/pbc/dft/krks.py:18')
    del aod, rows, dmao
    cell._pbc_cache.clear()
    torch.cuda.empty_cache()
    pbc_stv_phase(kernels, cell, report, 'int1e_stv_kpts', kpts,
                  'pyscf_tpu/pbc/df/fft.py:364')
    eval_ao_kpts_phase(kernels, cell, kpts, report)
    del mf, df
    kpts_twins(pt, kernels, '4x4x4', e, *args[1:])
    return launches


def kpts_exchange_path(pt, kernels):
    """KRHF and KRKS-PBE0 (FFT K over every k pair with the Ewald exxdiv)
    on the gth-dzvp cell at 3x3x3, each held to the same run on the twins
    (1e-9 Ha)."""
    for name, make, xc_k in (
            ('KRHF', lambda c, k: pt.pbc.scf.KRHF(c, kpts=k), ()),
            ('KRKS-PBE0', lambda c, k: pt.pbc.dft.KRKS(c, kpts=k, xc='pbe0'),
             ('xc_rks',))):
        args = (DIAMOND_DZVP, make, [3, 3, 3])
        name = f'3x3x3 diamond gth-dzvp {name}'
        _, e, _, _ = kpts_scf(pt, kernels, name, *args,
                              names=KPTS_KERNELS + xc_k)
        kpts_twins(pt, kernels, name, e, *args)


def kpts_open_shell_path(pt, kernels):
    """KUKS-PBE of the spin-polarised primitive cell (spin 2) on the
    shifted 2x1x1 mesh at [17]^3 (tests/test_torch_kpts.py's mesh; on the
    Γ-centred one this cell's Aufbau oscillates and neither the JAX
    package's SCF nor the port's converges in 100 cycles, ROADMAP §3),
    held to the same run on the twins (1e-9 Ha)."""
    args = (dict(DIAMOND, mesh=[17] * 3, spin=2),
            lambda c, k: pt.pbc.dft.KUKS(c, kpts=k, xc='pbe'), [2, 1, 1])
    kw = dict(gamma=False)
    name = 'diamond spin 2 KUKS-PBE shifted 2x1x1 [17]^3'
    _, e, _, _ = kpts_scf(pt, kernels, name, *args,
                          names=KPTS_KERNELS + ('xc_uks',), **kw)
    kpts_twins(pt, kernels, name, e, *args, **kw)


def kpts_paths(pt, kernels, report, launches):
    """The golden, the 64-k-point cell with its three kernel rows, exchange
    and the open shell."""
    kpts_golden_path(pt, kernels)
    torch.cuda.empty_cache()
    k64 = kpts_64_path(pt, kernels, report)
    launches['eval_ao_kpts'] = k64['eval_ao_kpts']
    launches['int1e_stv_kpts'] = k64['int1e_stv']
    launches['xc_rks_k64'] = k64['xc_rks']
    torch.cuda.empty_cache()
    kpts_exchange_path(pt, kernels)
    torch.cuda.empty_cache()
    kpts_open_shell_path(pt, kernels)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('CUDA is not available: chip_smoke.py runs only on '
                         'a machine with an NVIDIA GPU')
    import pyscf_tpu_torch as pt
    from pyscf_tpu_torch import refs
    from pyscf_tpu_torch.ops import kernels

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          'python', sys.version.split()[0])
    print(f'kernel build: {kernels.build():.1f} s', flush=True)
    library_logs(kernels, ('eval_ao', 'eval_ao_kpts') + XC_LIBRARIES)

    report = {}
    integral_phases(pt, refs, report)
    rhf = df_rhf_path(pt, refs, kernels)
    eigh_residual(rhf)
    grid_xc_phases(pt, kernels, rhf.mol, rhf.make_rdm1(), report)
    del rhf
    launches = df_rks_path(pt, refs, kernels)
    int2e_phase(pt, refs, kernels, report)
    torch.cuda.empty_cache()
    launches['int2e'] = incore_rhf_path(pt, refs, kernels)['int2e']
    torch.cuda.empty_cache()
    uks, uks_launches = df_uks_path(pt, refs, kernels)
    launches['xc_uks'] = uks_launches['xc_uks']
    xc_uks_phase(kernels, uks, report)
    torch.cuda.empty_cache()
    mol = pt.M(atom=refs.BENZENE, basis='def2-svp')
    one_e_deriv_phases(kernels, mol, report)
    int2e_ip1_phase(kernels, mol, report)
    del mol
    torch.cuda.empty_cache()
    grad_launches = rhf_grad_path(pt, refs, kernels)
    launches.update({k: grad_launches[k] for k in GRAD_KERNELS})
    torch.cuda.empty_cache()
    rks, rks_launches = df_rks_grad_path(pt, refs, kernels)
    launches.update({k: rks_launches[k] for k in
                     ('int3c2e_ip', 'int2c2e_ip1') + XC_GRAD_KERNELS})
    df_grad_phases(kernels, rks, report)
    eval_ao_phase(kernels, rks, report, 'eval_ao_deriv2', 2)
    xc_grad_phases(kernels, rks, report)
    del rks
    torch.cuda.empty_cache()
    df_rhf_grad_path(pt, refs, kernels)
    df_water_gradients(pt, refs, ('DF-RHF', 'DF-RKS b3lypg', 'DF-UHF cation'))
    torch.cuda.empty_cache()
    # DF-UKS forces, the dipole and geometry optimisation
    xc_uks_grad_phase(kernels, uks, report)
    del uks
    torch.cuda.empty_cache()
    launches['xc_uks_grad'] = df_uks_grad_path(pt, refs, kernels)[
        'xc_uks_grad']
    df_water_gradients(pt, refs, ('DF-UKS b3lypg cation',))
    int1e_r_phase(pt, refs, kernels, report)
    launches['int1e_r'] = water_analysis_path(pt, refs, kernels)['int1e_r']
    torch.cuda.empty_cache()
    phenyl_optimisation_path(pt, refs, kernels)
    torch.cuda.empty_cache()
    # wB97X-V: range-separated DF exchange and VV10
    lr_integral_phases(pt, refs, kernels, report)
    rks, rks_launches = benzene_wb97xv_path(pt, refs, kernels)
    launches.update({k: rks_launches[k] for k in
                     ('int3c2e_lr', 'int2c2e_lr', 'vv10')})
    launches['xc_rks_wb97x_v'] = rks_launches['xc_rks']
    vv10_phase(kernels, rks, report)
    aods, wblocks = rks._numint.grid_ao(rks.mol, rks.grids, 1)
    check(len(aods) == 1, 'the benzene grid does not fit one block')
    xc_rks_phase(kernels, 'xc_rks_wb97x_v', 'wb97x-v', aods[0],
                 rks.make_rdm1(), wblocks[0], report)
    del rks, aods, wblocks
    torch.cuda.empty_cache()
    uks, uks_launches = phenyl_wb97xv_path(pt, refs, kernels)
    launches['xc_uks_wb97x_v'] = uks_launches['xc_uks']
    xc_uks_phase(kernels, uks, report, 'xc_uks_wb97x_v', 'wb97x-v')
    del uks
    torch.cuda.empty_cache()
    int2e_phase(pt, refs, kernels, report, OMEGA)
    torch.cuda.empty_cache()
    launches['int2e_lr'] = water_rsh_references(pt, refs, kernels)[
        'int2e_lr']
    torch.cuda.empty_cache()
    # post-HF: MP2, CCSD and CCSD(T), in-core and DF, and UMP2
    rhf, mycc, cc_launches = incore_postscf_path(pt, refs, kernels)
    launches.update({k: cc_launches[k] for k in ('mp2_energy', 'ccsd_t')})
    ccsd_t_phase(kernels, mycc, report)
    mp2_energy_phase(kernels, rhf, report)
    del rhf, mycc
    torch.cuda.empty_cache()
    df_postscf_path(pt, refs, kernels)
    torch.cuda.empty_cache()
    ump2_path(pt, refs, kernels)
    torch.cuda.empty_cache()
    # excited states: TDA, TDHF and TDDFT
    rks, td_launches = tdscf_benzene_path(pt, refs, kernels)
    launches.update({k: td_launches[k] for k in
                     ('xc_fxc', 'xc_fxc_pairs', 'xc_rks_fxc', 'xc_uks_fxc')})
    fxc_phases(kernels, rks, report)
    del rks
    torch.cuda.empty_cache()
    tdscf_phenyl_path(pt, refs, kernels)
    torch.cuda.empty_cache()
    tdscf_goldens(pt)
    torch.cuda.empty_cache()
    # the analytic DF-RHF Hessian
    rhf, hess_launches = hessian_path(
        pt, kernels, 'benzene/def2-SVP', refs.BENZENE, 'def2-svp',
        [(a, x) for a in (0, 1, 6, 7) for x in range(3)],
        refs.E_BENZENE_DF_RHF_DEF2SVP)
    launches.update({k: hess_launches[k] for k in HESS_KERNELS})
    hessian_phases(kernels, rhf, report)
    del rhf
    torch.cuda.empty_cache()
    # f and g shells: BASELINE configs 3 and 4 at full width
    tz_launches = h2o10_path(pt, refs, kernels, report)
    launches.update({f'{k}_tz': tz_launches[k]
                     for k in ('int1e_stv', 'int3c2e', 'int2c2e')})
    torch.cuda.empty_cache()
    tz_water_references(pt, refs)
    torch.cuda.empty_cache()
    qz_launches = n2_qz_path(pt, refs, kernels, report)
    launches.update({f'{k}_qz': qz_launches[k]
                     for k in ('int1e_stv', 'int2e')})
    torch.cuda.empty_cache()
    neon_qz_references(pt, refs, kernels)
    torch.cuda.empty_cache()
    # f and g shells in the derivative and Hessian kernels: their forces
    # and frequencies at triple and quadruple zeta
    fg_deriv_phase(pt, refs, kernels, report, 'qz', 'cc-pvqz')
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f'device memory after the f and g kernels: {free / 1e9:.2f} GB '
          f'free of {total / 1e9:.2f} GB')
    h2o10, tz_launches = h2o10_forces_path(pt, refs, kernels)
    launches.update({f'{k}_tz': tz_launches[k] for k in DF_GRAD_KERNELS})
    one_e_deriv_phases(kernels, h2o10.mol, report, '_tz')
    df_grad_phases(kernels, h2o10, report, '_tz')
    del h2o10
    torch.cuda.empty_cache()
    tz_water_gradients(pt, refs)
    qz_launches = qz_water_gradient(pt, refs, kernels)
    launches.update({f'{k}_qz': qz_launches[k] for k in DF_GRAD_KERNELS})
    torch.cuda.empty_cache()
    df_rks_grad_path(pt, refs, kernels, tzvp=True)
    torch.cuda.empty_cache()
    rhf, tz_launches = hessian_path(
        pt, kernels, 'benzene/cc-pVTZ', refs.BENZENE, 'cc-pvtz',
        [(0, 0), (0, 2), (6, 0), (6, 1)])
    launches.update({f'{k}_tz': tz_launches[k] for k in HESS_KERNELS})
    hessian_phases(kernels, rhf, report, '_tz')
    del rhf
    torch.cuda.empty_cache()
    _, qz_launches = hessian_path(
        pt, kernels, 'water/cc-pVQZ', refs.WATER, 'cc-pvqz',
        [(a, x) for a in range(3) for x in range(3)])
    launches.update({f'{k}_qz': qz_launches[k] for k in HESS_KERNELS})
    torch.cuda.empty_cache()
    boys_both_sides(pt, kernels)
    torch.cuda.empty_cache()
    # the analytic DF-RKS Hessian and the transition-state search
    rks, ks_launches = ks_hessian_path(
        pt, refs, kernels, 'def2-SVP', [(a, x) for a in (0, 6)
                                        for x in range(3)])
    launches.update({k: ks_launches[k] for k in KS_HESS_KERNELS})
    eval_ao_phase(kernels, rks, report, 'eval_ao_deriv3', 3)
    ks_hessian_phases(kernels, rks, report)
    del rks
    torch.cuda.empty_cache()
    rks, tz_launches = ks_hessian_path(
        pt, refs, kernels, 'def2-TZVP', [(0, 0), (0, 2), (6, 0), (6, 1)],
        fxc_routes=True)
    launches.update({f'{k}_tz': tz_launches[k] for k in KS_HESS_KERNELS})
    eval_ao_phase(kernels, rks, report, 'eval_ao_deriv3_tz', 3)
    ks_hessian_phases(kernels, rks, report, '_tz')
    del rks
    torch.cuda.empty_cache()
    nh3_ts_path(pt, refs, kernels)
    torch.cuda.empty_cache()
    # the DF-UHF/UKS Hessian, PBE and PBE0 through every XC kernel, and the
    # DF-UHF transition-state search
    uks, uks_launches = uks_hessian_path(pt, refs, kernels, 'b3lypg',
                                         PHENYL_PICKS)
    launches.update({k: uks_launches[k]
                     for k in ('xc_uks_hess', 'xc_uks_deriv1')})
    launches['eval_ao_deriv3_phenyl'] = uks_launches['eval_ao_deriv3']
    eval_ao_phase(kernels, uks, report, 'eval_ao_deriv3_phenyl', 3)
    uks_hessian_phases(kernels, uks, report)
    del uks
    torch.cuda.empty_cache()
    uks, pbe0_launches = uks_hessian_path(
        pt, refs, kernels, 'pbe0', [(0, x) for x in range(3)], forces=True)
    launches.update({f'{k}_pbe0': pbe0_launches[k] for k in (
        'xc_uks', 'xc_uks_grad', 'xc_uks_fxc', 'xc_uks_hess',
        'xc_uks_deriv1')})
    xc_uks_phase(kernels, uks, report, 'xc_uks_pbe0', 'pbe0')
    xc_uks_grad_phase(kernels, uks, report, 'xc_uks_grad_pbe0')
    uks_fxc_phase(kernels, uks, report, 'xc_uks_fxc_pbe0')
    uks_hessian_phases(kernels, uks, report, '_pbe0')
    del uks
    torch.cuda.empty_cache()
    rks, pbe_launches = benzene_pbe_path(pt, refs, kernels)
    launches.update({f'{k}_pbe': pbe_launches[k] for k in (
        'xc_rks', 'xc_rks_grad', 'xc_fxc', 'xc_fxc_pairs', 'xc_rks_fxc',
        'xc_rks_hess', 'xc_rks_deriv1')})
    aods, wblocks = rks._numint.grid_ao(rks.mol, rks.grids, 1)
    check(len(aods) == 1, 'the benzene grid does not fit one block')
    xc_rks_phase(kernels, 'xc_rks_pbe', 'pbe', aods[0], rks.make_rdm1(),
                 wblocks[0], report)
    del aods, wblocks
    xc_grad_phases(kernels, rks, report, '_pbe')
    fxc_phases(kernels, rks, report, '_pbe', tangents=('xc_rks_fxc',))
    ks_hessian_phases(kernels, rks, report, '_pbe')
    del rks
    torch.cuda.empty_cache()
    h3_ts_path(pt, kernels)
    hessian_path(pt, kernels, 'DF-UHF CH3/def2-TZVP', CH3, 'def2-tzvp',
                 [(a, x) for a in range(4) for x in range(3)], spin=1)
    torch.cuda.empty_cache()
    # the Γ-point periodic SCF: BASELINE config 5 and the 64-atom cell
    pbc_paths(pt, kernels, report, launches)
    torch.cuda.empty_cache()
    # the k-point periodic SCF over FFTDF
    kpts_paths(pt, kernels, report, launches)
    for name in report:
        check(launches[name] > 0, f'kernel {name} never launched on its path')

    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', launches=launches[name], **r)
        for name, r in report.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
