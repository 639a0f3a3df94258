"""Record the JAX package's DF-RHF Hessians that tests/test_torch_hessian.py
compares the port with (the JAX Hessian is the jvp of its analytic gradient
and takes minutes to hours on the CPU, too long for the fast tests):

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/hessian_refs_record.py \
    h2 water_sto3g twins [water_svp]

adds to pyscf_tpu_torch/data/hessian_water_refs.npz, for each case named,
the converged DF-RHF orbitals ('<case>_mo_coeff', '<case>_mo_energy',
'<case>_mo_occ', '<case>_e_tot'; minao guess, conv_tol 1e-12,
conv_tol_grad 1e-9, def2-universal-jkfit) and mf.Hessian().kernel()
('<case>_hess', (natm, 3, natm, 3) in Ha/Bohr^2), with the seconds of the
SCF and of the Hessian ('<case>_seconds'). Cases that are already in the
file are kept, so the cases may be recorded by separate processes.
'compare' alone prints the port's Hessians against the recorded ones.

The cases: 'h2' is H2/sto-3g at 0.74 Angstrom (tests/test_hessian.py's
molecule), 'water_sto3g' and 'water_svp' water (refs.WATER) in sto-3g and
def2-SVP. Wall times on the CPU (8 cores, shared with other work): h2
11.5 s SCF and 81.6 s Hessian, water_sto3g 22.7 s and 691.4 s, water_svp
as its '<case>_seconds' say.

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
ones."""
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
CASES = {'h2': ('H 0 0 0; H 0 0 0.74', 'sto-3g'),
         'water_sto3g': (WATER, 'sto-3g'),
         'water_svp': (WATER, 'def2-svp')}
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


def record(case):
    atom, basis = CASES[case]
    mol = pt.M(atom=atom, basis=basis, verbose=0)
    mf = mol.RHF().density_fit()
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
            f'{case}_seconds': np.array([t1 - t0, t2 - t1])}


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


def twin_inputs():
    """{key: numpy inputs} of the twins' Coulomb checks, from the port's
    water/def2-SVP tables: per TWIN_3C entry the pair tables (ea, ca, ra,
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
    mol = tpt.M(atom=WATER, basis='def2-svp', device='cpu')
    aux = j3c.aux_tables(make_auxmol(mol))
    classes = j3c.screened_pairs(mol)

    def shells(l, k=3):
        t = next(a for a in aux if a[0] == l)
        return (l,) + tuple(x[:k].numpy() for x in t[1:])

    out = {}
    for la, lb, lc in TWIN_3C:
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
    for lx, ly in TWIN_2C:
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


def twins():
    out = {}
    for la, lb in TWIN_1E:
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
    for key, inputs in twin_inputs().items():
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


def compare():
    """Print max |H_port - H_jax| (Ha/Bohr^2) of the recorded cases on the
    JAX orbitals, the port's own Hessian and with the reference's W
    response (hessian/rhf.py hessian(..., reference_w=True))."""
    import torch
    import pyscf_tpu_torch as tpt
    from pyscf_tpu_torch.hessian import rhf
    r = np.load(OUT)
    for case in ('h2', 'water_sto3g', 'water_svp'):
        if f'{case}_hess' not in r.files:
            continue
        atom, basis = CASES[case]
        mf = tpt.M(atom=atom, basis=basis, device='cpu').RHF().density_fit()
        for k in ('mo_coeff', 'mo_energy', 'mo_occ'):
            setattr(mf, k, torch.as_tensor(r[f'{case}_{k}']))
        diffs = [float(np.abs(rhf.hessian(mf, reference_w=w)[0]
                              - r[f'{case}_hess']).max())
                 for w in (False, True)]
        print(case, 'port', diffs[0], 'port with reference_w', diffs[1])


def main(cases):
    if cases == ['compare']:
        compare()
        return
    for case in cases:
        rec = twins() if case == 'twins' else record(case)
        out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
        out.update(rec)
        tmp = f'{OUT}.{os.getpid()}.tmp.npz'
        np.savez_compressed(tmp, **out)
        os.replace(tmp, OUT)


if __name__ == '__main__':
    main(sys.argv[1:] or ['h2', 'water_sto3g', 'twins'])
