"""Record the JAX package's DF Hessians that tests/test_torch_hessian.py,
test_torch_hessian_rks.py and test_torch_hessian_uhf.py compare the port
with (the JAX Hessian is the jvp of its analytic gradient and takes
minutes to hours on the CPU, too long for the fast tests):

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/hessian_refs_record.py \
    h2 water_sto3g twins [water_svp] [twins_fg] [oh_uhf] [oh_uks] \
    [cation_pbe0]

adds to pyscf_tpu_torch/data/hessian_water_refs.npz, for each case named,
the converged DF-RHF (DF-UHF, DF-RKS, DF-UKS) orbitals ('<case>_mo_coeff', '<case>_mo_energy',
'<case>_mo_occ', '<case>_e_tot'; minao guess, conv_tol 1e-12,
conv_tol_grad 1e-9, def2-universal-jkfit) and mf.Hessian().kernel()
('<case>_hess', (natm, 3, natm, 3) in Ha/Bohr^2), with the seconds of the
SCF and of the Hessian ('<case>_seconds'). Cases that are already in the
file are kept, so the cases may be recorded by separate processes.
'compare' alone prints the port's Hessians against the recorded ones (for
water_rks also with reference_vxc, the asymmetry of the JAX package's
dE_xc/dD and the two- and four-point central differences of O's z
column).

The cases: 'h2' is H2/sto-3g at 0.74 Angstrom (tests/test_hessian.py's
molecule), 'water_sto3g' and 'water_svp' water (refs.WATER) in sto-3g and
def2-SVP. Wall times on the CPU (8 cores, shared with other work): h2
11.5 s SCF and 81.6 s Hessian, water_sto3g 22.7 s and 691.4 s.
water_svp's Hessian ran out of XLA's compile memory after 20 minutes, and
an f-shell case, HF/cc-pVTZ at 0.917 Angstrom (with
XLA_FLAGS=--xla_disable_hlo_passes=constant_folding), out of the
process's memory maps (LLVM 'Cannot allocate memory') after 4 minutes:
neither is in the file, and tests/test_torch_fg_deriv.py holds the
port's HF/cc-pVTZ Hessian to central differences of its gradient.

'twins' records, for the plain twins of the Hessian's kernels, the JAX
package's derivatives on the inputs that twin_inputs() builds (seeded
primitive pairs; two-centre shell pairs and aux shells of water/def2-SVP
from the port's tables, so that both sides read the same numbers):
'twin_1e_<la><lb>_{aa,ac,cc}' jax.jacfwd(jax.grad(...)) of sum dm (T + V)
- wm S over the chunks of ops/integrals/int1e.py; '<3c key>_{aa,ab,bb,cc}'
of sum G (ij|P) and '<3c key>_ip1' jax.jacfwd of the block through
ops/integrals/int2e.py _eri_core, _paired_data_kernel and
_aux_data_kernel; '<2c key>_{ip1,pp}' the same for the metric's block
(each 10-50 s on the CPU). At a one-centre pair (A = B),
jax.jacfwd(jax.grad(...)) in A alone departs from central differences of
jax.grad (by 0.73 of 4.5 for a (p d|p) pair), so the pairs are two-centre
ones.

'twins_fg' records the same derivatives at f, g and aux h, on FG_BASIS
and FG_AUX (TWIN_1E_FG, TWIN_3C_FG, TWIN_2C_FG; run with
XLA_FLAGS=--xla_disable_hlo_passes=constant_folding, about 2 minutes).

'water_rks' is water/sto-3g DF-RKS b3lypg on the level-0 Becke grid
(KS_CASES; its points and weights stored as '<case>_grid_coords' and
'_grid_weights'): SCF 37.0 s, Hessian 537.4 s on the CPU.

'oh_uhf' and 'oh_uks' are the OH radical of tests/test_hessian.py:72-110
(spin 1, sto-3g) in DF-UHF and in DF-UKS b3lypg on the level-0 grid,
'cation_pbe0' the water cation (charge 1, spin 1, sto-3g) in DF-UKS PBE0
on the level-0 grid: the OH radical's PBE0 converges in neither package on
these grids (its beta pi hole drifts, 5e-9 Ha a cycle), its b3lypg only in
the JAX package. SCF and Hessian seconds on the CPU: oh_uhf 22.1 and
374.1, oh_uks 25.5 and 425.1, cation_pbe0 33.7 and 553.3. Run each in a
process of its own, not under xdist.

'xc_twins' records the JAX derivatives that the DF-RKS Hessian's XC kernels
are held to (about 45 s): 'xc_ao3', the third derivatives of the AO values
of s to g shells (AO3_BASIS on FG_ATOMS, at AO3_POINTS seeded points) as
jax.jacfwd(jax.jacfwd(...)) of eval_ao(..., deriv=1, atom_coords=X) on the
AO's own atom, (10, npts, nao) in the order xxx, xxy, ..., zzz; and per
functional of XC_TWINS, on water/def2-SVP's level-0 grid (every eighth
point) with a seeded density matrix, 'xc_<name>_hess' jax.hessian of
_exc_quadrature in X (3 natm, 3 natm) and 'xc_<name>_dv' jax.jacfwd in X
of its jax.grad in D (nao, nao, 3 natm), with the inputs
'xc_grid_coords', 'xc_grid_weights' and 'xc_dm'."""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import pyscf_tpu as pt
from pyscf_tpu.ops.integrals import int1e as jax_int1e
from pyscf_tpu.ops.integrals.cart2sph import cart2sph
from pyscf_tpu.ops.integrals.hermite import n_tuv
from pyscf_tpu.ops.integrals.int2e import (_aux_data_kernel, _eri_core,
                                           _paired_data_kernel)

WATER = 'O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587'
# the OH radical of tests/test_hessian.py:72-110 (spin 1)
OH = 'O 0 0 0; H 0 0 0.97'
CASES = {'h2': ('H 0 0 0; H 0 0 0.74', 'sto-3g'),
         'water_sto3g': (WATER, 'sto-3g'),
         'water_svp': (WATER, 'def2-svp'),
         'water_rks': (WATER, 'sto-3g'),
         'oh_uhf': (OH, 'sto-3g'),
         'oh_uks': (OH, 'sto-3g'),
         'cation_pbe0': (WATER, 'sto-3g')}
# the open-shell cases: (charge, spin)
SPIN = {'oh_uhf': (0, 1), 'oh_uks': (0, 1), 'cation_pbe0': (1, 1)}
# the DF-KS cases: the functional and the level of the Becke grid
KS_CASES = {'water_rks': ('b3lypg', 0), 'oh_uks': ('b3lypg', 0),
            'cation_pbe0': ('pbe0', 0)}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'pyscf_tpu_torch', 'data', 'hessian_water_refs.npz')
# the twins' classes: one-electron (la, lb); three-centre (la, lb, lc) on
# two pairs and up to three aux shells; two-centre (lx, ly)
TWIN_1E = ((0, 1), (1, 0), (2, 1), (2, 2))
TWIN_3C = ((0, 1, 2), (1, 2, 1), (2, 1, 2), (2, 2, 0))
TWIN_2C = ((1, 2), (4, 0))
CHARGES = np.array([8.0, 1.0, 1.0, 6.0, 0.0, 3.0, 0.0, 2.0])
# Bohr; moves a shell off a centre it shares (see twin_inputs)
OFFSET = np.array([0.3, -0.2, 0.5])
# f and g shells ('twins_fg'): two centres off the origin, a g and an s
# shell on O and an f shell on H; an aux basis of an h and an s shell (also
# tests/port_refs_record.py fg_grad_refs's); the classes of its twins
FG_ATOMS = 'O 0.1 0.2 -0.3; H 0.3 -0.7 0.6'
FG_BASIS = {'O': [[4, [0.6, 1.0]], [0, [1.3, 1.0]]], 'H': [[3, [0.7, 1.0]]]}
FG_AUX = {'O': [[5, [1.1, 1.0]], [0, [2.0, 1.0]]], 'H': [[0, [1.4, 1.0]]]}
TWIN_1E_FG = ((4, 3),)
# 'xc_twins': s to g shells for the AO third derivatives, seeded points;
# the functionals of the XC terms
AO3_BASIS = {'O': [[0, [3.0, 0.6], [0.8, 0.5]], [1, [1.1, 1.0]],
                   [2, [0.9, 1.0]], [3, [0.7, 0.4], [2.0, 0.7]],
                   [4, [0.6, 1.0]]],
             'H': [[0, [1.2, 1.0]], [1, [0.9, 1.0]]]}
AO3_POINTS = 40
XC_TWINS = {'lda': 'lda,vwn', 'b3lypg': 'b3lypg'}
TWIN_3C_FG = ((3, 4, 5),)
TWIN_2C_FG = ((5, 0),)


def record(case):
    atom, basis = CASES[case]
    charge, spin = SPIN.get(case, (0, 0))
    mol = pt.M(atom=atom, basis=basis, charge=charge, spin=spin, verbose=0)
    extra = {}
    if case in KS_CASES:
        xc, level = KS_CASES[case]
        mf = (mol.UKS if spin else mol.RKS)(xc=xc).density_fit()
        mf.grids.level = level
        mf.grids.build()
        extra = {f'{case}_grid_coords': np.asarray(mf.grids.coords),
                 f'{case}_grid_weights': np.asarray(mf.grids.weights)}
    else:
        mf = (mol.UHF if spin else mol.RHF)().density_fit()
    mf.init_guess = 'minao'
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    t0 = time.perf_counter()
    mf.kernel()
    assert mf.converged
    t1 = time.perf_counter()
    h = np.asarray(mf.Hessian().kernel())
    t2 = time.perf_counter()
    print(case, 'scf', t1 - t0, 's; hessian', t2 - t1, 's', flush=True)
    return {f'{case}_mo_coeff': np.asarray(mf.mo_coeff),
            f'{case}_mo_energy': np.asarray(mf.mo_energy),
            f'{case}_mo_occ': np.asarray(mf.mo_occ),
            f'{case}_e_tot': float(mf.e_tot), f'{case}_hess': h,
            f'{case}_seconds': np.array([t1 - t0, t2 - t1]), **extra}


# ---- the twins' inputs and the JAX derivatives ------------------------------

def prims_1e(la, lb, m=5):
    """Seeded primitive pairs, densities and eight centres of a class."""
    rng = np.random.default_rng(10 * la + lb)
    a, b = rng.uniform(0.3, 3.0, m), rng.uniform(0.3, 3.0, m)
    A, B = rng.normal(size=(m, 3)), rng.normal(size=(m, 3))
    w = rng.normal(size=m)
    rng = np.random.default_rng(7)
    nca, ncb = (la + 1) * (la + 2) // 2, (lb + 1) * (lb + 2) // 2
    dm = rng.standard_normal((m, nca, ncb))
    wm = rng.standard_normal((m, nca, ncb))
    return a, b, A, B, w, rng.normal(size=(8, 3)), CHARGES, dm, wm


def twin_inputs(fg=False):
    """{key: numpy inputs} of the twins' Coulomb checks, from the port's
    water/def2-SVP tables (with fg, of FG_BASIS and FG_AUX on FG_ATOMS and
    the classes TWIN_3C_FG and TWIN_2C_FG): per TWIN_3C entry the pair tables (ea, ca, ra,
    eb, cb, rb) of two two-centre pairs of the class (mirrored for la >
    lb; where a class has one-centre pairs only, the first two with the
    ket shell moved by OFFSET), up to three aux shells (l, e, c, r) of lc
    and the weights G (n, da, db, nsx, dc); per TWIN_2C entry the two aux
    classes' first three shells, the second's moved by OFFSET (a
    one-centre (g|s) has zero second derivatives), and W (nsx, dx, nsy,
    dy)."""
    import torch
    import pyscf_tpu_torch as tpt
    from pyscf_tpu_torch.df.addons import make_auxmol
    from pyscf_tpu_torch.ops.integrals import j3c
    if fg:
        mol = tpt.M(atom=FG_ATOMS, basis=FG_BASIS, device='cpu')
        aux = j3c.aux_tables(tpt.M(atom=FG_ATOMS, basis=FG_AUX,
                                   device='cpu'))
        twin_3c, twin_2c = TWIN_3C_FG, TWIN_2C_FG
    else:
        mol = tpt.M(atom=WATER, basis='def2-svp', device='cpu')
        aux = j3c.aux_tables(make_auxmol(mol))
        twin_3c, twin_2c = TWIN_3C, TWIN_2C
    classes = j3c.screened_pairs(mol)

    def shells(l, k=3):
        t = next(a for a in aux if a[0] == l)
        return (l,) + tuple(x[:k].numpy() for x in t[1:])

    out = {}
    for la, lb, lc in twin_3c:
        cls = (min(la, lb), max(la, lb))
        pairs = [t.numpy() for t in classes[cls][1]]
        two = np.flatnonzero(np.abs(pairs[2] - pairs[5]).sum(axis=1) > 0)[:2]
        if two.size:
            pairs = [t[two] for t in pairs]
        else:
            # one-centre pairs only (d d on O): the ket shell moved off
            pairs = [t[:2] for t in pairs]
            pairs[5] = pairs[5] + OFFSET
        if la > lb:
            pairs = pairs[3:] + pairs[:3]
        ax = shells(lc)
        n, nsx = pairs[0].shape[0], ax[1].shape[0]
        G = np.random.default_rng(3).standard_normal(
            (n, 2 * la + 1, 2 * lb + 1, nsx, 2 * lc + 1))
        out[f'twin_3c_{la}{lb}{lc}'] = (pairs, ax, G)
    for lx, ly in twin_2c:
        ax, ay = shells(lx), shells(ly)
        ay = ay[:3] + (ay[3] + OFFSET,)
        W = np.random.default_rng(4).standard_normal(
            (ax[1].shape[0], 2 * lx + 1, ay[1].shape[0], 2 * ly + 1))
        out[f'twin_2c_{lx}{ly}'] = (ax, ay, W)
    del torch
    return out


def j3c_block(la, lb, lc, pairs, ax):
    """(ra, rb, rc) -> the sph (n, da, db, nsx, dc) block of the JAX
    programs."""
    ea, ca, _, eb, cb, _ = [jnp.asarray(t) for t in pairs]
    ec, cc = jnp.asarray(ax[1]), jnp.asarray(ax[2])
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    nsx, K = ec.shape
    nc = [(l + 1) * (l + 2) // 2 for l in (la, lb, lc)]
    S = [jnp.asarray(cart2sph(l)) for l in (la, lb, lc)]

    def blk(ra, rb, rc):
        p1, P1, E1 = _paired_data_kernel(la, lb, ea, ca, ra, eb, cb, rb)
        px, Px, Ex = _aux_data_kernel(lc, ec, cc, rc)
        v = _eri_core(la + lb, lc, n_tuv(la + lb), n_tuv(lc), p1, P1, E1,
                      px, Px, Ex)
        v = v.reshape(n, KK, nc[0], nc[1], nsx, K, nc[2]).sum(axis=(1, 5))
        return jnp.einsum('mp,nq,er,spqxr->smnxe', *S, v)

    return blk


def j2c_block(ax, ay):
    """(rx, ry) -> the sph (nsx, dx, nsy, dy) block of the metric."""
    (lx, ex, cx, _), (ly, ey, cy, _) = ax, ay
    Sx, Sy = jnp.asarray(cart2sph(lx)), jnp.asarray(cart2sph(ly))

    def blk(rx, ry):
        px, Px, Ex = _aux_data_kernel(lx, jnp.asarray(ex), jnp.asarray(cx),
                                      rx)
        py, Py, Ey = _aux_data_kernel(ly, jnp.asarray(ey), jnp.asarray(cy),
                                      ry)
        v = _eri_core(lx, ly, n_tuv(lx), n_tuv(ly), px, Px, Ex, py, Py, Ey)
        v = v.reshape(ex.shape[0], ex.shape[1], -1, ey.shape[0],
                      ey.shape[1], v.shape[-1]).sum(axis=(1, 4))
        return jnp.einsum('mp,xpyq,nq->xmyn', Sx, v, Sy)

    return blk


def twins(fg=False):
    out = {}
    for la, lb in TWIN_1E_FG if fg else TWIN_1E:
        a, b, A, B, w, zr, zq, dm, wm = prims_1e(la, lb)

        def f(A_, B_, C_):
            s = jax_int1e.ovlp_chunk(la, lb, a, b, A_, B_, w)
            t = jax_int1e.kin_chunk(la, lb, a, b, A_, B_, w)
            v = jax_int1e.nuc_chunk(la, lb, a, b, A_, B_, w, C_, zq)
            return jnp.sum(dm * (t + v)) - jnp.sum(wm * s)

        args = [jnp.asarray(x) for x in (A, B, zr)]
        k = f'twin_1e_{la}{lb}'
        out[f'{k}_aa'] = np.asarray(jax.jacfwd(jax.grad(f, 0), 0)(*args))
        out[f'{k}_ac'] = np.asarray(jax.jacfwd(jax.grad(f, 0), 2)(*args))
        out[f'{k}_cc'] = np.asarray(jax.jacfwd(jax.grad(f, 2), 2)(*args))
        print(k, flush=True)
    for key, inputs in twin_inputs(fg).items():
        if key.startswith('twin_3c'):
            pairs, ax, G = inputs
            la, lb, lc = (int(c) for c in key[-3:])
            blk = j3c_block(la, lb, lc, pairs, ax)
            args = [jnp.asarray(t) for t in (pairs[2], pairs[5], ax[3])]
            out[f'{key}_ip1'] = np.asarray(jax.jacfwd(blk, 0)(*args))

            def f(ra, rb, rc):
                return jnp.sum(blk(ra, rb, rc) * G)

            for name, (x, y) in (('aa', (0, 0)), ('ab', (0, 1)),
                                 ('bb', (1, 1)), ('cc', (2, 2))):
                out[f'{key}_{name}'] = np.asarray(
                    jax.jacfwd(jax.grad(f, x), y)(*args))
        else:
            ax, ay, W = inputs
            blk = j2c_block(ax, ay)
            args = [jnp.asarray(ax[3]), jnp.asarray(ay[3])]
            out[f'{key}_ip1'] = np.asarray(jax.jacfwd(blk, 0)(*args))
            out[f'{key}_pp'] = np.asarray(jax.jacfwd(jax.grad(
                lambda rx, ry: jnp.sum(blk(rx, ry) * W), 0), 0)(*args))
        print(key, flush=True)
    return out


def ao3_points():
    return np.random.default_rng(0).normal(size=(AO3_POINTS, 3))


def xc_dm(nao):
    c = np.random.default_rng(2).standard_normal((nao, 5)) * 0.3
    return 2.0 * c @ c.T


def xc_twins():
    from pyscf_tpu.dft import gen_grid as jax_gen_grid
    from pyscf_tpu.dft import xc as jax_xc
    from pyscf_tpu.dft.numint import _pad_grid
    from pyscf_tpu.grad.autodiff import _exc_quadrature
    from pyscf_tpu.ops.eval_gto import eval_ao as jax_eval_ao
    out = {}
    jmol = pt.M(atom=FG_ATOMS, basis=AO3_BASIS, verbose=0)
    pts = ao3_points()
    jac = np.asarray(jax.jit(jax.jacfwd(jax.jacfwd(lambda X: jax_eval_ao(
        jmol, pts, deriv=1, atom_coords=X))))(jnp.asarray(jmol.coords)))
    import pyscf_tpu_torch as tpt
    from pyscf_tpu_torch.grad.rhf import _ao2atom_map
    from pyscf_tpu_torch.ops.eval_gto import THIRD_DERIVS
    atom = _ao2atom_map(tpt.M(atom=FG_ATOMS, basis=AO3_BASIS, device='cpu'))
    # the AOs' order is the same in both packages
    out['xc_ao3'] = np.stack([
        np.stack([jac[1 + k, :, m, atom[m], i, atom[m], j]
                  for m in range(jac.shape[2])], axis=1)
        for i, j, k in THIRD_DERIVS])
    print('xc_ao3', flush=True)
    jmol = pt.M(atom=WATER, basis='def2-svp', verbose=0)
    grids = jax_gen_grid.Grids(jmol)
    grids.level = 0
    grids.build()
    c = np.asarray(grids.coords)[::8]
    w = np.asarray(grids.weights)[::8]
    cb, wb = _pad_grid(jnp.asarray(c), jnp.asarray(w), blk=c.shape[0])
    D = xc_dm(jmol.nao)
    X = jnp.asarray(np.asarray(jmol.coords))
    out.update(xc_grid_coords=c, xc_grid_weights=w, xc_dm=D)
    for name, code in XC_TWINS.items():
        xc = jax_xc.parse_xc(code)

        def f(X_, d):
            return _exc_quadrature(jmol, xc, X_, d, cb, wb, True)

        nt = 3 * jmol.natm
        out[f'xc_{name}_hess'] = np.asarray(jax.jit(jax.hessian(f))(
            X, jnp.asarray(D))).reshape(nt, nt)
        out[f'xc_{name}_dv'] = np.asarray(jax.jit(jax.jacfwd(jax.grad(
            f, argnums=1)))(X, jnp.asarray(D))).reshape(jmol.nao, jmol.nao,
                                                        nt)
        print(f'xc_{name}', flush=True)
    return out


def compare():
    """Print max |H_port - H_jax| (Ha/Bohr^2) of the recorded cases on the
    JAX orbitals, the port's own Hessian and with the reference's W
    response (hessian/rhf.py hessian(..., reference_w=True)); for
    water_rks also with the reference's unsymmetrised dE_xc/dD
    (reference_vxc=True), the asymmetry of the JAX package's jax.grad of
    _exc_quadrature in D at the recorded density, and O's z diagonal of
    the port's own Hessian against the two- and four-point central
    differences (step 1e-3 Bohr) of the port's gradient on the recorded
    fixed grid."""
    import torch
    import pyscf_tpu_torch as tpt
    from pyscf_tpu_torch import hessian
    from pyscf_tpu_torch.hessian import rhf, uhf
    r = np.load(OUT)
    for case in CASES:
        if f'{case}_hess' not in r.files:
            continue
        atom, basis = CASES[case]
        charge, spin = SPIN.get(case, (0, 0))
        mol = tpt.M(atom=atom, basis=basis, charge=charge, spin=spin,
                    device='cpu')
        if case in KS_CASES:
            mf = (mol.UKS if spin else mol.RKS)(
                xc=KS_CASES[case][0]).density_fit()
            mf.grids.coords = torch.as_tensor(r[f'{case}_grid_coords'])
            mf.grids.weights = torch.as_tensor(r[f'{case}_grid_weights'])
        else:
            mf = (mol.UHF if spin else mol.RHF)().density_fit()
        for k in ('mo_coeff', 'mo_energy', 'mo_occ'):
            setattr(mf, k, torch.as_tensor(r[f'{case}_{k}']))
        ref = r[f'{case}_hess']
        hess = uhf.hessian if spin else rhf.hessian
        h = hess(mf)[0]
        diffs = [float(np.abs(h - ref).max()), float(np.abs(
            hess(mf, reference_w=True)[0] - ref).max())]
        print(case, 'port', diffs[0], 'port with reference_w', diffs[1])
        if case not in KS_CASES:
            continue
        print(case, 'port with reference_w and reference_vxc', float(np.abs(
            hess(mf, reference_w=True, reference_vxc=True)[0]
            - ref).max()))
        if spin:
            continue
        from pyscf_tpu.dft import xc as jax_xc
        from pyscf_tpu.dft.numint import _pad_grid
        from pyscf_tpu.grad.autodiff import _exc_quadrature
        jmol = pt.M(atom=atom, basis=basis, verbose=0)
        cb, wb = _pad_grid(jnp.asarray(r[f'{case}_grid_coords']),
                           jnp.asarray(r[f'{case}_grid_weights']))
        co = r[f'{case}_mo_coeff'][:, r[f'{case}_mo_occ'] > 0]
        xc = jax_xc.parse_xc(KS_CASES[case][0])
        v = np.asarray(jax.grad(lambda d: _exc_quadrature(
            jmol, xc, jnp.asarray(jmol.coords), d, cb, wb, True))(
            jnp.asarray(2.0 * co @ co.T)))
        print(case, 'JAX dE_xc/dD: max |V - V^T|', float(np.abs(
            v - v.T).max()), 'of max |V|', float(np.abs(v).max()))
        grids = (mf.grids.coords, mf.grids.weights)

        def grad(m):
            f = m.RKS(xc=KS_CASES[case][0]).density_fit()
            f.grids.coords, f.grids.weights = grids
            f.conv_tol, f.conv_tol_grad = 1e-12, 1e-9
            f.kernel()
            return f.Gradients().kernel()

        for points in (2, 4):
            fd = hessian.fd_columns(grad, mol, [(0, 2)], points=points)[0]
            print(case, f'{points}-point central differences of O z: '
                  f'|H - H_fd| at O z {abs(h[0, 2, 0, 2] - fd[0, 2]):.3e}, '
                  f'max over the column {np.abs(h[0, 2] - fd).max():.3e}')


def main(cases):
    if cases == ['compare']:
        compare()
        return
    for case in cases:
        if case in ('twins', 'twins_fg'):
            rec = twins(case == 'twins_fg')
        elif case == 'xc_twins':
            rec = xc_twins()
        else:
            rec = record(case)
        out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
        out.update(rec)
        tmp = f'{OUT}.{os.getpid()}.tmp.npz'
        np.savez_compressed(tmp, **out)
        os.replace(tmp, OUT)


if __name__ == '__main__':
    main(sys.argv[1:] or ['h2', 'water_sto3g', 'twins'])
