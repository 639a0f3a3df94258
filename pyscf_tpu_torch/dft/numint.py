"""Numerical XC integration for closed and open shells.

Counterpart of pyscf_tpu/dft/numint.py (NumInt.nr_rks, nr_uks, grid_ao
and the cores over precomputed AO values, _get_rks_core_aod and
_get_uks_core_aod). Per block of grid points, closed shell:

    dmao = ao @ dm                                  torch.matmul (cuBLAS)
    rho, grad rho, sigma, the functional and its    CUDA kernel `xc_rks`
    derivatives, vtmp = 1/2 w vrho ao                (csrc/xc_rks.cu); plain
                        + 2 w vsigma grad rho . grad ao   twin xc_rks_plain
    V += ao^T @ vtmp                                torch.matmul (cuBLAS)

and V_xc = V + V^T. Open shell, the same with a spin axis:

    dmao_s = ao @ dm_s                              one batched torch.matmul
    rho_s, grad rho_s, sigma_aa/ab/bb, the          CUDA kernel `xc_uks`
    functional and its five derivatives, vtmp_s      (csrc/xc_uks.cu); plain
                                                     twin xc_uks_plain
    V_s += ao^T @ vtmp_s                            one batched torch.matmul

The nuclear gradient of E_xc on the fixed grid (rks_grad; what jax.grad
makes of pyscf_tpu/grad/autodiff.py _exc_quadrature, restricted branch):

    aod with second derivatives                     CUDA kernel `eval_ao`,
                                                     deriv 2
    dmao4 = aod[:4] @ dm                            torch.matmul (cuBLAS)
    rho, sigma, vrho, vsigma and the per-AO         CUDA kernel `xc_rks_grad`
    gradient integrand summed over the block         (csrc/xc_rks_grad.cu);
                                                     twin xc_rks_grad_plain

and for a spin density (uks_grad; the unrestricted branch,
autodiff.py:228-245):

    dmao_s = aod[:4] @ dm_s                         one batched torch.matmul
    rho_s, the three sigmas, their derivatives and  CUDA kernel `xc_uks_grad`
    the per-AO integrand of both spins               (csrc/xc_uks_grad.cu);
                                                     twin xc_uks_grad_plain

The KS terms of the analytic DF-RKS Hessian on the fixed grid at the
fixed density D (rks_xc_hessian; what jax.jvp of jax.grad makes of
_exc_quadrature in pyscf_tpu/hessian/rhf.py:226-233,327):

    aod with third derivatives                      CUDA kernel `eval_ao`,
                                                     deriv 3 (second for an
                                                     LDA)
    dmao4 = aod[:4] @ D                             torch.matmul (cuBLAS)
    per point: v, H = d2e/du2 of u = (rho, grad     CUDA kernel `xc_rks_hess`
    rho), u_t and w H u_t per tangent (atom-         (csrc/xc_rks_hess.cu);
    segmented sums over the AOs), the same-atom      twin xc_rks_hess_plain
    blocks, the explicit rows
    the quadratic term sum u_s . w H u_t, the       torch.matmul (cuBLAS)
    explicit cross term's Z
    per point and tangent, the rows vt'_t of        CUDA kernel
    dV_xc/dX                                         `xc_rks_deriv1`; twin
                                                     xc_rks_deriv1_plain
    F_t = phi^T vt'_t - [rows on A] (d_x phi)^T     torch.matmul (cuBLAS)
    vtmp0

and of the DF-UKS Hessian (uks_xc_hessian; pyscf_tpu/hessian/uhf.py:
176-186,256 on _exc_quadrature's unrestricted branch): the same with the
features of both spins, u = (rho_a, grad rho_a, rho_b, grad rho_b), on
one set of AO values, by the kernels `xc_uks_hess` and `xc_uks_deriv1`
(twins xc_uks_hess_plain and xc_uks_deriv1_plain).

The XC response of TDA/TDDFT, on a closed- or open-shell ground density:

    the Hessian route (tdscf get_ab): w f_xc per    CUDA kernel `xc_fxc`;
    point in 4x4 blocks over (rho, grad rho),        twin xc_fxc_plain
    no clamps (pyscf_tpu/tdscf/rhf.py _fxc_ov)
    the pair features P and H P                     CUDA kernel
                                                     `xc_fxc_pairs`; twin
                                                     xc_fxc_pairs_plain
    the jvp route (the Davidson matvec): dmao1 =    torch.matmul (cuBLAS)
    ao @ ddm, the tangent of vtmp through the SCF's  CUDA kernel `xc_rks_fxc`
    clamps (rks_response), or of both spins'         or `xc_uks_fxc`; twins
    (uks_response), dV = ao^T @ dvtmp                xc_rks_fxc_plain and
                                                     xc_uks_fxc_plain
                                                     (torch.func.jvp)

The grid is not padded, and blocks are sized by
memory, not by the TPU's budget: on the card one block usually holds the
whole grid. The AO values are evaluated once per SCF (grid_ao) and reused
every cycle.
"""
import time

import torch

from ..ops.eval_gto import NCOMP, SECOND_DERIVS, THIRD_DERIVS, eval_ao
from ..ops.integrals.j3c import sync
from . import xc as xc_mod
from .xc_funcs import _max

# The JAX package's thresholds, kept so both give the same energies.
RHO_THR = 1e-10
SIGMA_FLOOR = 1e-20
# bytes a block of grid points may take in AO values and per-cycle
# temporaries: half the free memory on the card, this much on the CPU
CPU_BLOCK_BYTES = 1 << 28


def _masked(rho, sigma):
    mask = rho > RHO_THR
    rho_s = torch.where(mask, _max(rho, RHO_THR), 1.0)
    sigma_s = torch.where(mask, _max(sigma, SIGMA_FLOOR), 1.0)
    return mask, rho_s, sigma_s


def _closed_derivs(xc, rho_s, sigma_s):
    """(e_xc, vrho, vsigma) per point at the clamped inputs, by
    torch.func.grad: a block map built on them differentiates again under
    torch.func.jvp, as jax.jvp of jax.grad does in the JAX package."""
    def esum(r, s):
        e = edens_closed(xc, r, s)
        return e.sum(), e
    (vrho, vsigma), e = torch.func.grad(esum, argnums=(0, 1),
                                        has_aux=True)(rho_s, sigma_s)
    return e, vrho, vsigma


def edens_closed(xc, rho, sigma):
    """Closed-shell energy density: rho_a = rho_b = rho/2 and
    sigma_aa = sigma_ab = sigma_bb = sigma/4."""
    ra = 0.5 * rho
    s4 = 0.25 * sigma
    return xc.exc_density(ra, ra, s4, s4, s4)


def xc_rks_plain(aod, dmao, weights, xc):
    """Plain PyTorch twin of the `xc_rks` kernel on one block of B points.

    aod (B, nao) for an LDA or (4, B, nao) for a GGA, dmao = ao @ dm
    (B, nao), weights (B,). Returns (vtmp (B, nao), n, exc) with
    n = sum w rho and exc = sum over unmasked points of w e_xc; vrho and
    vsigma come from torch.func.grad through the functional's clamps."""
    gga = aod.dim() == 3
    ao = aod[0] if gga else aod
    rho = torch.clamp(torch.einsum('bi,bi->b', dmao, ao), min=0.0)
    if gga:
        grho = 2.0 * torch.einsum('bi,dbi->db', dmao, aod[1:])
        sigma = torch.einsum('db,db->b', grho, grho)
    else:
        sigma = torch.zeros_like(rho)
    mask, rho_s, sigma_s = _masked(rho, sigma)
    e, vrho, vsigma = _closed_derivs(xc, rho_s, sigma_s)
    exc = torch.sum(torch.where(mask, weights * e, 0.0))
    wv = torch.where(mask, weights * vrho, 0.0)
    vtmp = 0.5 * wv[:, None] * ao
    if gga:
        wvs = torch.where(mask, weights * vsigma, 0.0)
        vtmp = vtmp + 2.0 * torch.einsum('b,db,dbi->bi', wvs, grho, aod[1:])
    return vtmp, torch.sum(weights * rho), exc


def _spin_densities(ao, ao_grad, dmao):
    """(rho (2, B), grad rho (2, 3, B) or None, [sigma_aa, sigma_ab,
    sigma_bb]) of dmao = ao @ dm_s (2, B, nao); ao_grad (3, B, nao) for a
    GGA, None for an LDA (the sigmas are then zero)."""
    rho = torch.clamp(torch.einsum('sbi,bi->sb', dmao, ao), min=0.0)
    if ao_grad is None:
        return rho, None, [torch.zeros_like(rho[0])] * 3
    grho = 2.0 * torch.einsum('sbi,dbi->sdb', dmao, ao_grad)
    return rho, grho, [torch.einsum('db,db->b', grho[i], grho[j])
                       for i, j in ((0, 0), (0, 1), (1, 1))]


def _open_shell_derivs(rho, sig, xc):
    """(mask, [vrho_a, vrho_b, vsigma_aa, vsigma_ab, vsigma_bb], e_xc) per
    point of the spin densities rho (2, B) and sig [sigma_aa, sigma_ab,
    sigma_bb], with the JAX package's mask and clamps (numint.py:265-273):
    rho_a + rho_b > RHO_THR, rho_s >= RHO_THR/2, sigma_ss >= SIGMA_FLOOR,
    sigma_ab as it is; the derivatives by torch.func.grad at the clamped
    values (so that torch.func.jvp differentiates them again)."""
    mask = (rho[0] + rho[1]) > RHO_THR

    def sf(x, lo):
        return torch.where(mask, x if lo is None else _max(x, lo), 1.0)

    def esum(*a):
        e = xc.exc_density(*a)
        return e.sum(), e

    args = [sf(rho[0], 0.5 * RHO_THR), sf(rho[1], 0.5 * RHO_THR),
            sf(sig[0], SIGMA_FLOOR), sf(sig[1], None), sf(sig[2], SIGMA_FLOOR)]
    grads, e = torch.func.grad(esum, argnums=(0, 1, 2, 3, 4),
                               has_aux=True)(*args)
    return mask, list(grads), e


def xc_uks_plain(aod, dmao, weights, xc):
    """Plain PyTorch twin of the `xc_uks` kernel on one block of B points.

    aod (B, nao) for an LDA or (4, B, nao) for a GGA, dmao = ao @ dm_s
    stacked (2, B, nao), weights (B,). Returns (vtmp (2, B, nao), n (2,),
    exc) with n_s = sum w rho_s and exc = sum over unmasked points of
    w e_xc. The mask and clamps are the JAX package's (numint.py:265-273):
    rho_a + rho_b > RHO_THR, rho_s >= RHO_THR/2, sigma_ss >= SIGMA_FLOOR,
    sigma_ab as it is; the five derivatives come from torch.func.grad."""
    gga = aod.dim() == 3
    ao = aod[0] if gga else aod
    rho, grho, sig = _spin_densities(ao, aod[1:] if gga else None, dmao)
    mask, (vra, vrb, vsaa, vsab, vsbb), e = _open_shell_derivs(rho, sig, xc)
    exc = torch.sum(torch.where(mask, weights * e, 0.0))
    vtmp = []
    for vr, vss, s, o in ((vra, vsaa, 0, 1), (vrb, vsbb, 1, 0)):
        wv = torch.where(mask, weights * vr, 0.0)
        v = 0.5 * wv[:, None] * ao
        if gga:
            wvss = torch.where(mask, weights * vss, 0.0)
            wvsx = torch.where(mask, weights * vsab, 0.0)
            v = v + 2.0 * torch.einsum('b,db,dbi->bi', wvss, grho[s], aod[1:]) \
                + torch.einsum('b,db,dbi->bi', wvsx, grho[o], aod[1:])
        vtmp.append(v)
    n = torch.stack([torch.sum(weights * rho[0]), torch.sum(weights * rho[1])])
    return torch.stack(vtmp), n, exc


def xc_rks_grad_plain(aod, dmao, weights, xc):
    """Plain PyTorch twin of the `xc_rks_grad` kernel on one block of B
    points: the XC energy's nuclear gradient on a fixed grid, per AO.

    aod (10, B, nao) [value, x, y, z, xx, xy, xz, yy, yz, zz] for a GGA, or
    (4, B, nao) for an LDA; dmao = aod[:4] @ dm (4, B, nao), or aod[:1] @ dm
    (1, B, nao) for an LDA; weights (B,). Returns (g (3, nao), exc) with
      g[x, mu] = sum_b -2 w [vrho d_x phi_mu (D phi)_mu + 2 vsigma
                 sum_j g_j (d_x phi_mu (D d_j phi)_mu
                            + d_x d_j phi_mu (D phi)_mu)]
    over the unmasked points, g_j = 2 sum (D phi) d_j phi, so that
    dE_xc/dX_A = sum over the AOs mu on atom A of g[:, mu]; exc = sum over
    unmasked points of w e_xc. The mask and clamps are _masked's, and a
    derivative is zero where jax.grad gives zero: vsigma counts above
    SIGMA_FLOOR, half at it, not below."""
    gga = aod.shape[0] == 10
    ao, dm0 = aod[0], dmao[0]
    rho = torch.clamp(torch.einsum('bi,bi->b', dm0, ao), min=0.0)
    if gga:
        grho = 2.0 * torch.einsum('bi,dbi->db', dm0, aod[1:4])
        sigma = torch.einsum('db,db->b', grho, grho)
    else:
        sigma = torch.zeros_like(rho)
    mask, rho_s, sigma_s = _masked(rho, sigma)
    with torch.enable_grad():
        r = rho_s.detach().requires_grad_()
        s = sigma_s.detach().requires_grad_()
        e = edens_closed(xc, r, s)
        vrho, vsigma = [torch.zeros_like(rho) if v is None else v
                        for v in torch.autograd.grad(e.sum(), (r, s),
                                                     allow_unused=True)]
    exc = torch.sum(torch.where(mask, weights * e.detach(), 0.0))
    a = torch.where(mask, -2.0 * weights * vrho, 0.0)
    bj = None
    if gga:
        vs = vsigma * clamp_slope(sigma, SIGMA_FLOOR)
        bj = torch.where(mask, -4.0 * weights * vs, 0.0) * grho     # (3, B)
    return _grad_rows(aod, dmao, a, bj), exc


def clamp_slope(x, lo):
    """d max(x, lo)/dx as jax.grad takes it: 1 above lo, 1/2 at a tie, 0
    below."""
    return (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)


def _pair_table(aod):
    """{(i, j): d_i d_j phi} of the second-derivative rows aod[4:10]."""
    t = {}
    for k, (i, j) in enumerate(SECOND_DERIVS):
        t[i, j] = t[j, i] = aod[4 + k]
    return t


def _grad_rows(aod, dm_rows, a, bj):
    """g (3, nao) of one density's coefficients per point, a (B,) and, for
    a GGA, bj (3, B): sum_b a d_x phi (D phi) + sum_j bj (d_x phi (D d_j
    phi) + d_x d_j phi (D phi)); dm_rows = aod[:4] @ D (or aod[:1] @ D)."""
    dm0 = dm_rows[0]
    g = torch.einsum('b,xbi,bi->xi', a, aod[1:4], dm0)
    if bj is None:
        return g
    second = _pair_table(aod)
    return g + torch.stack([
        sum(torch.einsum('b,bi->i', bj[j], aod[1 + x] * dm_rows[1 + j]
                         + second[x, j] * dm0) for j in range(3))
        for x in range(3)])


def xc_uks_grad_plain(aod, dmao, weights, xc):
    """Plain PyTorch twin of the `xc_uks_grad` kernel on one block of B
    points: the spin-polarized XC energy's nuclear gradient on a fixed
    grid, per AO.

    aod as xc_rks_grad_plain's; dmao = aod[:4] @ dm_s stacked (2, 4, B,
    nao), or aod[:1] @ dm_s (2, 1, B, nao) for an LDA; weights (B,).
    Returns (g (3, nao), exc) with
      g[x, mu] = sum_s sum_b [a_s d_x phi_mu (D_s phi)_mu + sum_j b_sj
                 (d_x phi_mu (D_s d_j phi)_mu + d_x d_j phi_mu (D_s phi)_mu)]
      a_s = -2 w vrho_s,  b_sj = -2 w (2 vsigma_ss g_sj + vsigma_ab g_s'j)
    over the unmasked points. The mask and clamps are xc_uks_plain's, and a
    derivative through a clamp is zero where jax.grad gives zero: vrho_s
    counts above RHO_THR/2, vsigma_ss above SIGMA_FLOOR, half at a tie, not
    below (pyscf_tpu/grad/autodiff.py:228-245)."""
    gga = aod.shape[0] == 10
    rho, grho, sig = _spin_densities(aod[0], aod[1:4] if gga else None,
                                     dmao[:, 0])
    mask, (vra, vrb, vsaa, vsab, vsbb), e = _open_shell_derivs(rho, sig, xc)
    exc = torch.sum(torch.where(mask, weights * e, 0.0))
    m2w = torch.where(mask, -2.0 * weights, 0.0)
    g = 0.0
    for s, o, vr, vss, sss in ((0, 1, vra, vsaa, sig[0]),
                               (1, 0, vrb, vsbb, sig[2])):
        a = m2w * (vr * clamp_slope(rho[s], 0.5 * RHO_THR))
        bj = None
        if gga:
            vs = 2.0 * (vss * clamp_slope(sss, SIGMA_FLOOR))
            bj = m2w * (vs * grho[s] + vsab * grho[o])
        g = g + _grad_rows(aod, dmao[s], a, bj)
    return g, exc


# ---- the XC response (TDA/TDDFT) -------------------------------------------

# the rows of (rho, grad rho) of spin a and of spin b in u = (rho_a, rho_b,
# grad rho_a, grad rho_b)
_SPIN_ROWS = ([0, 2, 3, 4], [1, 5, 6, 7])


def xc_fxc_plain(aod, dmao, weights, xc, singlet=True):
    """Plain PyTorch twin of the `xc_fxc` kernel on one block of B points:
    the weighted, masked XC response kernel per point in 4x4 blocks over
    (rho, grad rho).

    aod (4, B, nao); dmao = ao @ dm (1, B, nao) of a closed-shell total
    density, or ao @ dm_s (2, B, nao) of each spin; weights (B,). H is the
    Hessian by torch.func.hessian (vmapped over the points) of e_xc over
    u = (rho_a, rho_b, grad rho_a, grad rho_b) with the features of the JAX
    package's _fxc_ov (pyscf_tpu/tdscf/rhf.py:87-131) and _fxc_ov_uks
    (tdscf/uhf.py:89-121): no clamps; u = (rho/2, rho/2, g/2, g/2) of the
    total density, or the spin densities, at points above RHO_THR and
    (1/2, 1/2, 0, 0) elsewhere, where H is then zero. Returns (B, 1, 4, 4)
    of w (H_aa + H_ab) for the closed shell (w (H_aa - H_ab) unless
    singlet), (B, 4, 4, 4) of w [H_aa, H_ab, H_ba, H_bb] for two spins."""
    nspin = dmao.shape[0]
    rho = torch.clamp(torch.einsum('sbi,bi->sb', dmao, aod[0]), min=0.0)
    grho = 2.0 * torch.einsum('sbi,dbi->sdb', dmao, aod[1:])
    if nspin == 1:
        mask = rho[0] > RHO_THR
        half = torch.where(mask, 0.5 * rho[0], 0.5)
        g = torch.where(mask, 0.5 * grho[0], 0.0)
        u = [half, half, *g, *g]
    else:
        mask = (rho[0] + rho[1]) > RHO_THR
        u = ([torch.where(mask, rho[s], 0.5) for s in (0, 1)]
             + [torch.where(mask, grho[s, d], 0.0) for s in (0, 1)
                for d in range(3)])

    def e_of_u8(x):
        ga, gb = x[2:5], x[5:8]
        return xc.exc_density(x[0], x[1], ga @ ga, ga @ gb, gb @ gb)

    H8 = torch.func.vmap(torch.func.hessian(e_of_u8))(torch.stack(u, dim=1))
    H8 = torch.where(mask[:, None, None], H8, 0.0)

    def blk(s, t):
        return H8[:, _SPIN_ROWS[s]][:, :, _SPIN_ROWS[t]]

    if nspin == 1:
        H = (blk(0, 0) + (1.0 if singlet else -1.0) * blk(0, 1))[:, None]
    else:
        H = torch.stack([blk(0, 0), blk(0, 1), blk(1, 0), blk(1, 1)], dim=1)
    return weights[:, None, None, None] * H


def xc_fxc_pairs_plain(oo, ov, H, blocks):
    """Plain PyTorch twin of the `xc_fxc_pairs` kernel: (P (4, B, nov),
    HP (nh, 4, B, nov)) with P = [phi_i phi_a, grad(phi_i phi_a)] over the
    pairs (i, a), i major, and HP[h] = H[:, blocks[h]] P per point, as the
    JAX package's _fxc_ov forms them (pyscf_tpu/tdscf/rhf.py:130-139).

    oo (4, B, nocc), ov (4, B, nvir): orbital values and gradients; H
    (B, nblk, 4, 4) from xc_fxc."""
    B = oo.shape[1]
    P0 = torch.einsum('bi,ba->bia', oo[0], ov[0])
    Pd = (torch.einsum('dbi,ba->dbia', oo[1:], ov[0])
          + torch.einsum('bi,dba->dbia', oo[0], ov[1:]))
    P = torch.cat([P0[None], Pd]).reshape(4, B, -1)
    HP = torch.stack([torch.einsum('buv,vbx->ubx', H[:, h], P)
                      for h in blocks])
    return P, HP


def xc_rks_fxc_plain(aod, dmao, dmao1, weights, xc):
    """Plain PyTorch twin of the `xc_rks_fxc` kernel: (nvec, B, nao), the
    tangent of xc_rks_plain's vtmp at dmao along each dmao1[v] by
    torch.func.jvp (vmapped over the vectors), through the same clamps, as
    jax.jvp of the JAX package's _get_rks_core_aod (pyscf_tpu/tdscf/
    rhf.py:218)."""
    def vtmp(d):
        return xc_rks_plain(aod, d, weights, xc)[0]

    return torch.func.vmap(
        lambda t: torch.func.jvp(vtmp, (dmao,), (t,))[1])(dmao1)


def xc_uks_fxc_plain(aod, dmao, dmao1, weights, xc):
    """Plain PyTorch twin of the `xc_uks_fxc` kernel: (nvec, 2, B, nao), the
    tangent of xc_uks_plain's vtmp at dmao (2, B, nao) along each dmao1[v]
    (2, B, nao) by torch.func.jvp (vmapped over the vectors), as jax.jvp of
    the JAX package's _get_uks_core_aod (pyscf_tpu/tdscf/rhf.py:237)."""
    def vtmp(d):
        return xc_uks_plain(aod, d, weights, xc)[0]

    return torch.func.vmap(
        lambda t: torch.func.jvp(vtmp, (dmao,), (t,))[1])(dmao1)


# ---- the DF-RKS Hessian's XC terms -----------------------------------------

def _closed_second(xc, rho_s, sigma_s):
    """(e_r, e_s, e_rr, e_rs, e_ss) per point of the closed-shell energy
    density at the clamped inputs, by torch.func.grad and torch.func.hessian
    (vmapped over the points)."""
    def f(x):
        return edens_closed(xc, x[0], x[1])

    x = torch.stack([rho_s, sigma_s], dim=1)
    g = torch.func.vmap(torch.func.grad(f))(x)
    h = torch.func.vmap(torch.func.hessian(f))(x)
    return g[:, 0], g[:, 1], h[:, 0, 0], h[:, 0, 1], h[:, 1, 1]


def xc_rks_hess_plain(aod, dmao, weights, xc, atom_off):
    """Plain PyTorch twin of the `xc_rks_hess` kernel on one block of B
    points: (wv (B, 4), ut (3 natm, B, 4), ht (3 natm, B, 4), same (B,
    natm, 6), xr (4, B, nao)) as kernels.xc_rks_hess documents them.

    aod (20, B, nao) and dmao = aod[:4] @ D (4, B, nao) for a GGA, (10, B,
    nao) and (1, B, nao) for an LDA; weights (B,); atom_off (natm + 1,).
    v and H are the derivatives of e(rho_s, sigma_s) by torch.func through
    _masked's clamps, the sigma clamp's slope taken as jax.grad takes it:
      v_0 = e_r, v_j = 2 e_s s' g_j, H_00 = e_rr, H_0j = 2 e_rs s' g_j,
      H_jk = 4 e_ss s'^2 g_j g_k + 2 e_s s' delta_jk
    and zero at masked points; u_t of t = 3 A + x is -2 sum over the AOs
    mu on A of [d_x phi_mu (D phi)_mu, d_x d_j phi_mu (D phi)_mu + d_x
    phi_mu (D d_j phi)_mu]."""
    gga = aod.shape[0] == 20
    B = aod.shape[1]
    ao, d0 = aod[0], dmao[0]
    rho = torch.clamp(torch.einsum('bi,bi->b', d0, ao), min=0.0)
    if gga:
        g = 2.0 * torch.einsum('bi,jbi->jb', d0, aod[1:4])
        sigma = torch.einsum('jb,jb->b', g, g)
    else:
        g = ao.new_zeros((3, B))
        sigma = torch.zeros_like(rho)
    mask, rho_s, sigma_s = _masked(rho, sigma)
    er, es, err, ers, ess = _closed_second(xc, rho_s, sigma_s)
    v = ao.new_zeros((4, B))
    H = ao.new_zeros((4, 4, B))
    v[0] = er
    H[0, 0] = err
    if gga:
        sl = clamp_slope(sigma, SIGMA_FLOOR)
        v[1:] = 2.0 * es * sl * g
        H[0, 1:] = H[1:, 0] = 2.0 * ers * sl * g
        eye = torch.eye(3, dtype=g.dtype, device=g.device)
        H[1:, 1:] = (4.0 * ess * sl * sl * g[:, None] * g[None, :]
                     + 2.0 * es * sl * eye[:, :, None])
    v = torch.where(mask, v, 0.0)
    H = torch.where(mask, H, 0.0)
    wv = weights * v                                    # (4, B)
    onehot, sec, third = _atom_tables(aod, atom_off)
    u, same, xr = _hess_rows(aod, dmao, v, weights, onehot, sec, third)
    u = torch.where(mask, u, 0.0)
    ht = weights * torch.einsum('cqb,tqb->tcb', H, u)
    return (wv.T.contiguous(), u.permute(0, 2, 1).contiguous(),
            ht.permute(0, 2, 1).contiguous(), same, xr)


def _atom_tables(aod, atom_off):
    """(onehot (natm, nao) of each AO's atom, {(i, j): d_i d_j phi},
    {sorted (i, j, k): d_i d_j d_k phi} or None for an LDA's (10, B, nao))
    of the XC Hessian twins."""
    natm = atom_off.shape[0] - 1
    atoms = torch.arange(natm, device=aod.device)
    ao_atom = torch.repeat_interleave(atoms,
                                      (atom_off[1:] - atom_off[:-1]).long())
    onehot = (ao_atom[None, :] == atoms[:, None]).to(aod.dtype)
    third = None
    if aod.shape[0] == 20:
        third = {tuple(sorted(ijk)): aod[10 + k]
                 for k, ijk in enumerate(THIRD_DERIVS)}
    return onehot, _pair_table(aod), third


def _hess_rows(aod, dmao, v, weights, onehot, sec, third):
    """The rows of one density D of the XC Hessian twins, with v (4, B)
    the coefficients of its features (rho, grad rho) and dmao
    = aod[:4] @ D (aod[:1] @ D for an LDA, third None): (u (3 natm, 4, B),
    the features' derivative along t = 3 A + x, -2 sum over the AOs mu on
    A of [d_x phi_mu (D phi)_mu, d_x d_j phi_mu (D phi)_mu + d_x phi_mu (D
    d_j phi)_mu]; same (B, natm, 6), the same-atom blocks of w v .
    d2u/dA_x dA_y; xr (4, B, nao), vtmp0 = 1/2 w v_0 phi + sum_j w v_j d_j
    phi and G_x = sum_j w v_j d_x d_j phi)."""
    gga = third is not None
    natm, B = onehot.shape[0], aod.shape[1]
    ao, d0 = aod[0], dmao[0]
    p = [torch.einsum('xbi,bi,ai->axb', aod[1:4], d0, onehot)]
    for j in range(3):
        pj = torch.stack([sec[x, j] for x in range(3)]) * d0
        if gga:
            pj = pj + aod[1:4] * dmao[1 + j]
            p.append(torch.einsum('xbi,ai->axb', pj, onehot))
        else:
            p.append(torch.zeros_like(p[0]))
    u = -2.0 * torch.stack(p, dim=2).reshape(3 * natm, 4, B)
    same = []
    for x, y in SECOND_DERIVS:
        t = v[0, :, None] * sec[x, y] * d0
        if gga:
            for j in range(3):
                t = t + v[1 + j, :, None] * (
                    third[tuple(sorted((x, y, j)))] * d0
                    + sec[x, y] * dmao[1 + j])
        same.append(2.0 * weights[:, None] * (t @ onehot.T))
    same = torch.stack(same, dim=-1)                    # (B, natm, 6)
    wv = weights * v
    vtmp0 = 0.5 * wv[0, :, None] * ao
    G = ao.new_zeros((3, B, ao.shape[1]))
    if gga:
        vtmp0 = vtmp0 + torch.einsum('jb,jbi->bi', wv[1:], aod[1:4])
        G = torch.stack([sum(wv[1 + j, :, None] * sec[x, j] for j in range(3))
                         for x in range(3)])
    return u, same, torch.cat([vtmp0[None], G])


def xc_rks_deriv1_plain(aod, wv, ht, xr, ao_atom, t0, nt):
    """Plain PyTorch twin of the `xc_rks_deriv1` kernel: (B, nt, nao) of
      vt'_t = 1/2 ht_0 phi + sum_j ht_j d_j phi
              - 1/2 [nu on A] (w v_0 d_x phi + 2 G_x)
    for t = 3 A + x in t0 .. t0 + nt - 1; the inputs as the kernel's."""
    ts = torch.arange(t0, t0 + nt, device=aod.device)
    h = ht[ts]                                          # (nt, B, 4)
    val = 0.5 * h[..., 0, None] * aod[0] + torch.einsum(
        'tbj,jbi->tbi', h[..., 1:], aod[1:4])
    x = ts % 3
    on_a = (ao_atom.long()[None, :] == (ts // 3)[:, None]).to(aod.dtype)
    e = wv[:, 0, None] * aod[1 + x] + 2.0 * xr[1 + x]  # (nt, B, nao)
    val = val - 0.5 * on_a[:, None, :] * e
    return val.permute(1, 0, 2).contiguous()


def _open_second(xc, x5):
    """(e_x (5, B), e_xx (5, 5, B)) of the open-shell energy density at the
    clamped inputs x5 = (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb) (5,
    B), by torch.func.grad and torch.func.hessian (vmapped over the
    points)."""
    def f(x):
        return xc.exc_density(*x)

    X = x5.T
    g = torch.func.vmap(torch.func.grad(f))(X)
    h = torch.func.vmap(torch.func.hessian(f))(X)
    return g.T, h.permute(1, 2, 0)


def xc_uks_hess_plain(aod, dmao, weights, xc, atom_off):
    """Plain PyTorch twin of the `xc_uks_hess` kernel on one block of B
    points: (wv (B, 8), ut (3 natm, B, 8), ht (3 natm, B, 8), same (B,
    natm, 6), xr (2, 4, B, nao)) as kernels.xc_uks_hess documents them.

    aod (20, B, nao) and dmao = aod[:4] @ D_s stacked (2, 4, B, nao) for a
    GGA, (10, B, nao) and (2, 1, B, nao) for an LDA; weights (B,);
    atom_off (natm + 1,). The features are u = (rho_a, grad rho_a, rho_b,
    grad rho_b); x = (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb) is
    clamped as xc_uks_plain clamps it (rho_s >= RHO_THR/2, sigma_ss >=
    SIGMA_FLOOR, sigma_ab as it is, zero where rho_a + rho_b <= RHO_THR),
    and with J = dx/du (the clamps' slopes as jax.grad takes them)
      v = J^T e_x,  H = J^T e_xx J + sum_k e_k d2x_k/du2,
    d2sigma_ss/dg_s dg_s = 2 s'_ss 1, d2sigma_ab/dg_a dg_b = 1; u_t, same
    and xr per spin as xc_rks_hess_plain's, same summed over the spins."""
    gga = aod.shape[0] == 20
    B = aod.shape[1]
    ao = aod[0]
    rho = torch.clamp(torch.einsum('sbi,bi->sb', dmao[:, 0], ao), min=0.0)
    if gga:
        g = 2.0 * torch.einsum('sbi,jbi->sjb', dmao[:, 0], aod[1:4])
    else:
        g = ao.new_zeros((2, 3, B))
    saa, sab, sbb = [torch.einsum('jb,jb->b', g[i], g[j])
                     for i, j in ((0, 0), (0, 1), (1, 1))]
    mask = (rho[0] + rho[1]) > RHO_THR
    lo = 0.5 * RHO_THR

    def sf(x, floor):
        return torch.where(mask, x if floor is None else _max(x, floor), 1.0)

    ex, exx = _open_second(xc, torch.stack([
        sf(rho[0], lo), sf(rho[1], lo), sf(saa, SIGMA_FLOOR), sf(sab, None),
        sf(sbb, SIGMA_FLOOR)]))
    J = ao.new_zeros((5, 8, B))
    J[0, 0] = clamp_slope(rho[0], lo)
    J[1, 4] = clamp_slope(rho[1], lo)
    sl_aa = clamp_slope(saa, SIGMA_FLOOR)
    sl_bb = clamp_slope(sbb, SIGMA_FLOOR)
    if gga:
        J[2, 1:4] = 2.0 * sl_aa * g[0]
        J[3, 1:4] = g[1]
        J[3, 5:8] = g[0]
        J[4, 5:8] = 2.0 * sl_bb * g[1]
    v = torch.einsum('kb,kub->ub', ex, J)
    H = torch.einsum('kub,klb,lvb->uvb', J, exx, J)
    if gga:
        eye = torch.eye(3, dtype=ao.dtype, device=ao.device)[:, :, None]
        H[1:4, 1:4] += 2.0 * ex[2] * sl_aa * eye
        H[5:8, 5:8] += 2.0 * ex[4] * sl_bb * eye
        H[1:4, 5:8] += ex[3] * eye
        H[5:8, 1:4] += ex[3] * eye
    v = torch.where(mask, v, 0.0)
    H = torch.where(mask, H, 0.0)
    onehot, sec, third = _atom_tables(aod, atom_off)
    rows = [_hess_rows(aod, dmao[s], v[4 * s:4 * s + 4], weights, onehot,
                       sec, third) for s in (0, 1)]
    u = torch.where(mask, torch.cat([r[0] for r in rows], dim=1), 0.0)
    ht = weights * torch.einsum('cqb,tqb->tcb', H, u)
    return ((weights * v).T.contiguous(), u.permute(0, 2, 1).contiguous(),
            ht.permute(0, 2, 1).contiguous(), rows[0][1] + rows[1][1],
            torch.stack([rows[0][2], rows[1][2]]))


def xc_uks_deriv1_plain(aod, wv, ht, xr, ao_atom, t0, nt):
    """Plain PyTorch twin of the `xc_uks_deriv1` kernel: (2, B, nt, nao),
    for each spin s xc_rks_deriv1_plain's rows on that spin's four
    features: wv[:, 4 s:4 s + 4], ht[..., 4 s:4 s + 4] and xr[s] from
    xc_uks_hess."""
    return torch.stack([xc_rks_deriv1_plain(
        aod, wv[:, 4 * s:4 * s + 4], ht[..., 4 * s:4 * s + 4], xr[s], ao_atom,
        t0, nt) for s in (0, 1)])


def atom_ranges(mol):
    """(atom_off (natm + 1,) int32, ao_atom (nao,) int32) on mol.device: the
    first AO of each atom and the atom of each AO; ValueError unless every
    atom's AOs are consecutive, as the XC Hessian kernels take them."""
    import numpy as np
    from ..grad.rhf import _ao2atom_map
    ao_atom = _ao2atom_map(mol)
    if np.any(np.diff(ao_atom) < 0):
        raise ValueError('the AOs of an atom are not consecutive')
    off = np.searchsorted(ao_atom, np.arange(mol.natm + 1))
    i32 = dict(dtype=torch.int32, device=mol.device)
    return torch.as_tensor(off, **i32), torch.as_tensor(ao_atom, **i32)


def _budget(device, share):
    """Bytes a block of temporaries may take: share of the free memory on
    the card, CPU_BLOCK_BYTES on the CPU."""
    if device.type == 'cuda':
        return torch.cuda.mem_get_info(device)[0] // share
    return CPU_BLOCK_BYTES


def _block_size(npts, nao, ncomp, device):
    """Points per block when each point holds ncomp rows of nao doubles."""
    return max(1, min(npts, _budget(device, 2) // (ncomp * nao * 8)))


class NumInt:
    """Restricted and unrestricted numerical integrator."""

    def rsh_and_hybrid_coeff(self, xc_code):
        """(omega, alpha, hyb): K = hyb K + (alpha - hyb) K_LR; hyb is the
        hybrid fraction when omega is 0 (pyscf_tpu/dft/numint.py:398-402)."""
        omega, alpha, hyb = xc_mod.rsh_coeff(xc_code)
        if omega == 0:
            hyb = xc_mod.hybrid_coeff(xc_code)
        return omega, alpha, hyb

    def grid_ao(self, mol, grids, deriv, spins=1):
        """([aod], [weights]) per block of grid points: aod is (B, nao) for
        deriv 0 or (4, B, nao) for deriv 1 (kernel `eval_ao`); blocks leave
        room for the per-cycle temporaries of `spins` densities."""
        n = grids.size
        blk = _block_size(n, mol.nao, (4 if deriv else 1) + 2 * spins,
                          mol.device)
        aod = [eval_ao(mol, grids.coords[i:i + blk], deriv)
               for i in range(0, n, blk)]
        return aod, [grids.weights[i:i + blk] for i in range(0, n, blk)]

    def _get_rks_core_aod(self, xc_code):
        """(aod blocks, weight blocks, dm) -> (n, exc, vmat) as tensors."""
        from ..ops import kernels
        xc = xc_mod.parse_xc(xc_code)

        def run(aod_blocks, weights, dm):
            n = e = 0.0
            v = torch.zeros_like(dm)
            for aod, w in zip(aod_blocks, weights):
                ao = aod[0] if aod.dim() == 3 else aod
                dmao = ao @ dm
                vtmp, n_blk, e_blk = kernels.xc_rks(aod, dmao, w, xc)
                n = n + n_blk
                e = e + e_blk
                v = v + ao.T @ vtmp
            return n, e, v + v.T

        return run

    def _get_uks_core_aod(self, xc_code):
        """(aod blocks, weight blocks, dm (2, nao, nao)) -> (n (2,), exc,
        vmat (2, nao, nao)) as tensors."""
        from ..ops import kernels
        xc = xc_mod.parse_xc(xc_code)

        def run(aod_blocks, weights, dm):
            n = e = 0.0
            v = torch.zeros_like(dm)
            for aod, w in zip(aod_blocks, weights):
                ao = aod[0] if aod.dim() == 3 else aod
                vtmp, n_blk, e_blk = kernels.xc_uks(aod, ao @ dm, w, xc)
                n = n + n_blk
                e = e + e_blk
                v = v + ao.T @ vtmp
            return n, e, v + v.transpose(1, 2)

        return run

    def _response(self, kernel, nspin, xc_code, aod_blocks, weights, dm0,
                  sym=True):
        """ddm (nvec, [2,] nao, nao) -> the tangent of the core's V_xc at
        dm0 along each ddm, block by block: dmao1 = ao @ ddm (GEMM), the
        kernel, dV += ao^T @ dvtmp (GEMM), in groups of vectors that fit
        half the free memory; then dV + dV^T, as the core's V + V^T (2 dV
        unless sym: the JAX package's unsymmetrised jax.grad in D)."""
        xc = xc_mod.parse_xc(xc_code)
        aos = [aod[0] if aod.dim() == 3 else aod for aod in aod_blocks]
        dmao0 = [torch.matmul(ao, dm0) for ao in aos]

        def run(ddm):
            v = torch.zeros_like(ddm)
            for aod, ao, w, d0 in zip(aod_blocks, aos, weights, dmao0):
                step = max(1, _budget(ao.device, 2) // (2 * nspin * ao.numel()
                                                        * 8))
                for i in range(0, ddm.shape[0], step):
                    dmao1 = torch.matmul(ao, ddm[i:i + step])
                    dv = kernel(aod, d0, dmao1, w, xc)
                    v[i:i + step] += torch.matmul(ao.T, dv)
            return v + v.transpose(-1, -2) if sym else 2.0 * v

        return run

    def rks_response(self, xc_code, aod_blocks, weights, dm0, sym=True):
        """The closed-shell V_xc response at the density dm0: a map ddm
        (nvec, nao, nao) -> (nvec, nao, nao), jax.jvp of _get_rks_core_aod's
        V_xc at dm0 as pyscf_tpu/tdscf/rhf.py:210-219 takes it (kernel
        `xc_rks_fxc`), over the AO blocks of grid_ao; unless sym, of the
        JAX package's unsymmetrised dE_xc/dD (pyscf_tpu/hessian/rhf.py:
        287-288 lin_g)."""
        from ..ops import kernels
        return self._response(kernels.xc_rks_fxc, 1, xc_code, aod_blocks,
                              weights, dm0, sym)

    def uks_response(self, xc_code, aod_blocks, weights, dm0, sym=True):
        """The spin-polarized V_xc response at the spin density dm0 (2, nao,
        nao): a map ddm (nvec, 2, nao, nao) -> (nvec, 2, nao, nao), jax.jvp of
        _get_uks_core_aod's V_xc as pyscf_tpu/tdscf/rhf.py:221-238 takes it
        (kernel `xc_uks_fxc`); unless sym, of the JAX package's
        unsymmetrised dE_xc/dD_s (pyscf_tpu/hessian/uhf.py:196-197
        lin_g)."""
        from ..ops import kernels
        return self._response(kernels.xc_uks_fxc, 2, xc_code, aod_blocks,
                              weights, dm0, sym)

    def rks_grad(self, mol, grids, xc_code, dm, timings=None):
        """(exc, g (nao, 3)) of a closed-shell density dm on the fixed grid:
        dE_xc/dX_A is the sum of g over the AOs on atom A (no grid
        response, as in the JAX package). Per block, the AO values with
        their second derivatives (kernel `eval_ao` deriv 2; first for an
        LDA), dmao = aod[:4] @ dm as one GEMM, and kernel `xc_rks_grad`.
        timings, if given, receives the seconds of the AO values ('ao2')
        and of the rest ('xc_grad')."""
        from ..ops import kernels
        xc = xc_mod.parse_xc(xc_code)
        gga = xc.is_gga
        nd = 4 if gga else 1
        n, nao = grids.size, mol.nao
        blk = _block_size(n, nao, (10 if gga else 4) + nd, mol.device)
        e = 0.0
        g = torch.zeros((3, nao), dtype=dm.dtype, device=dm.device)
        t_ao = t_xc = 0.0
        for i in range(0, n, blk):
            t0 = time.perf_counter()
            aod = eval_ao(mol, grids.coords[i:i + blk], 2 if gga else 1)
            sync(mol.device)
            t1 = time.perf_counter()
            dmao = (aod[:nd].reshape(-1, nao) @ dm).reshape(nd, -1, nao)
            g_blk, e_blk = kernels.xc_rks_grad(aod, dmao,
                                               grids.weights[i:i + blk], xc)
            g += g_blk
            e = e + e_blk
            del aod, dmao
            sync(mol.device)
            t_ao += t1 - t0
            t_xc += time.perf_counter() - t1
        if timings is not None:
            timings.update(ao2=t_ao, xc_grad=t_xc)
        return e, g.T

    def uks_grad(self, mol, grids, xc_code, dm, timings=None):
        """(exc, g (nao, 3)) of a spin density dm (2, nao, nao) on the fixed
        grid, as rks_grad's: per block the AO values with their second
        derivatives (kernel `eval_ao` deriv 2; first for an LDA), dmao_s =
        aod[:4] @ dm_s for both spins as one batched GEMM, and kernel
        `xc_uks_grad`. timings as rks_grad's ('ao2', 'xc_grad')."""
        from ..ops import kernels
        xc = xc_mod.parse_xc(xc_code)
        gga = xc.is_gga
        nd = 4 if gga else 1
        n, nao = grids.size, mol.nao
        blk = _block_size(n, nao, (10 if gga else 4) + 2 * nd, mol.device)
        e = 0.0
        g = torch.zeros((3, nao), dtype=dm.dtype, device=dm.device)
        t_ao = t_xc = 0.0
        for i in range(0, n, blk):
            t0 = time.perf_counter()
            aod = eval_ao(mol, grids.coords[i:i + blk], 2 if gga else 1)
            sync(mol.device)
            t1 = time.perf_counter()
            dmao = (aod[:nd].reshape(-1, nao) @ dm).reshape(2, nd, -1, nao)
            g_blk, e_blk = kernels.xc_uks_grad(aod, dmao,
                                               grids.weights[i:i + blk], xc)
            g += g_blk
            e = e + e_blk
            del aod, dmao
            sync(mol.device)
            t_ao += t1 - t0
            t_xc += time.perf_counter() - t1
        if timings is not None:
            timings.update(ao2=t_ao, xc_grad=t_xc)
        return e, g.T

    def rks_xc_hessian(self, mol, grids, xc_code, dm, tangent_chunk=12,
                       timings=None):
        """The KS terms of the analytic Hessian of a closed-shell density dm
        on the fixed grid: (F (3 natm, nao, nao), hxx (3 natm, 3 natm)),
        tangents t = 3 A + x.

        hxx is E_xc's second derivative in the nuclear coordinates at fixed
        dm (jax.hessian of the JAX package's _exc_quadrature in X):
          sum_b u_s . w H u_t                  (GEMM of xc_rks_hess's u_t
                                                and w H u_t)
          + the same-atom blocks               (xc_rks_hess)
          + 2 sum_{mu on A, nu on B} D_munu Z^xy_munu, Z^xy = (d_x phi)^T
            (w v_0 d_y phi + G_y) + G_x^T d_y phi   (one GEMM)
        F the half-product of dV_xc/dX_t at fixed dm: V'_t = F_t + F_t^T
        (2 F_t is the JAX package's unsymmetrised jax.jacfwd in X of its
        jax.grad in D), F_t = phi^T vt'_t (xc_rks_deriv1, one GEMM per
        chunk of tangent_chunk tangents) - [rows on A] (d_x phi)^T vtmp0.
        Per block of grid points: the AO values to the third derivative
        (kernel `eval_ao` deriv 3; second for an LDA), dmao = aod[:4] @ dm
        as one GEMM, then the kernels. timings, if given, receives the
        seconds of the AO values, xc_rks_hess and its GEMMs ('xc_rows') and
        of xc_rks_deriv1 and its GEMMs ('xc_F1')."""
        F, hxx = self._xc_hessian(mol, grids, xc_code, dm[None],
                                  tangent_chunk, timings)
        return F[0], hxx

    def uks_xc_hessian(self, mol, grids, xc_code, dm, tangent_chunk=12,
                       timings=None):
        """The KS terms of the analytic Hessian of a spin density dm (2, nao,
        nao) on the fixed grid: (F (2, 3 natm, nao, nao), hxx (3 natm, 3
        natm)), as rks_xc_hessian's with the features of both spins (u =
        (rho_a, grad rho_a, rho_b, grad rho_b), what jax.hessian makes of
        _exc_quadrature's unrestricted branch): hxx sums the spins' same-atom
        blocks and explicit cross terms (Z_s with D_s), F_s is the
        half-product of dV_xc,s/dX at fixed dm. The kernels are `eval_ao`
        deriv 3 (second for an LDA), `xc_uks_hess` and `xc_uks_deriv1`, both
        spins on one set of AO values; timings as rks_xc_hessian's."""
        return self._xc_hessian(mol, grids, xc_code, dm, tangent_chunk,
                                timings)

    def _xc_hessian(self, mol, grids, xc_code, dm, tangent_chunk, timings):
        """rks_xc_hessian (dm (1, nao, nao)) and uks_xc_hessian (dm (2, nao,
        nao)): F (nspin, 3 natm, nao, nao), hxx."""
        from ..ops import kernels
        xc = xc_mod.parse_xc(xc_code)
        gga = xc.is_gga
        deriv, nd = (3, 4) if gga else (2, 1)
        nspin = dm.shape[0]
        hess, deriv1 = ((kernels.xc_rks_hess, kernels.xc_rks_deriv1)
                        if nspin == 1 else
                        (kernels.xc_uks_hess, kernels.xc_uks_deriv1))
        natm, nao = mol.natm, mol.nao
        nt = 3 * natm
        atom_off, ao_atom = atom_ranges(mol)
        dev = dm.device
        f64 = dict(dtype=dm.dtype, device=dev)
        n = grids.size
        tc = max(1, min(tangent_chunk, nt))
        blk = _block_size(n, nao, NCOMP[deriv] + nspin * (nd + 4 + tc) + 12,
                          dev)
        F = torch.zeros((nspin, nt, nao, nao), **f64)
        hxx = torch.zeros((nt, nt), **f64)
        Z = torch.zeros((nspin, 3 * nao, 3 * nao), **f64)
        Q = torch.zeros((nspin, 3, nao, nao), **f64)
        same = torch.zeros((natm, 6), **f64)
        t_rows = t_f1 = 0.0
        for i in range(0, n, blk):
            t0 = time.perf_counter()
            w = grids.weights[i:i + blk]
            B = w.shape[0]
            aod = eval_ao(mol, grids.coords[i:i + blk], deriv)
            dmao = torch.matmul(aod[:nd].reshape(-1, nao), dm).reshape(
                nspin, nd, B, nao)
            wv, ut, ht, sm, xr = hess(aod, dmao[0] if nspin == 1 else dmao,
                                      w, xc, atom_off)
            del dmao
            if nspin == 1:
                xr = xr[None]
            hxx += ut.reshape(nt, -1) @ ht.reshape(nt, -1).T
            same += sm.sum(dim=0)
            d1 = aod[1:4]
            for s in range(nspin):
                L = torch.cat([d1, xr[s, 1:]], dim=1).permute(1, 0, 2)
                R = torch.cat([wv[:, 4 * s, None] * d1 + xr[s, 1:], d1],
                              dim=1).permute(1, 0, 2)
                Z[s] += L.reshape(2 * B, -1).T @ R.reshape(2 * B, -1)
                Q[s] += d1.transpose(1, 2) @ xr[s, 0]
            del L, R, ut, sm
            sync(dev)
            t1 = time.perf_counter()
            ao_t = aod[0].T
            for a in range(0, nt, tc):
                m = min(tc, nt - a)
                vt = deriv1(aod, wv, ht, xr[0] if nspin == 1 else xr,
                            ao_atom, a, m).reshape(nspin, B, m * nao)
                F[:, a:a + m] += (ao_t @ vt).reshape(
                    nspin, nao, m, nao).transpose(1, 2)
                del vt
            del aod, wv, ht, xr
            sync(dev)
            t_rows += t1 - t0
            t_f1 += time.perf_counter() - t1
        t0 = time.perf_counter()
        onehot = (ao_atom.long()[None, :] == torch.arange(
            natm, device=dev)[:, None]).to(dm.dtype)
        rows = onehot.repeat_interleave(3, dim=0)       # (nt, nao)
        for s in range(nspin):
            F[s] -= rows[:, :, None] * Q[s].repeat(natm, 1, 1)
        sync(dev)
        t_f1 += time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in range(nspin):
            Zs = Z[s].reshape(3, nao, 3, nao).permute(0, 2, 1, 3) * dm[s]
            hxx += 2.0 * torch.einsum('am,xymn,bn->axby', onehot, Zs,
                                      onehot).reshape(nt, nt)
        iu = [(x, y) for x in range(3) for y in range(x, 3)]
        for k, (x, y) in enumerate(iu):
            idx = torch.arange(natm, device=dev) * 3
            hxx[idx + x, idx + y] += same[:, k]
            if x != y:
                hxx[idx + y, idx + x] += same[:, k]
        sync(dev)
        t_rows += time.perf_counter() - t0
        if timings is not None:
            timings.update(xc_rows=t_rows, xc_F1=t_f1)
        return F, hxx

    def nr_rks(self, mol, grids, xc_code, dm):
        """(nelec, exc, vxc matrix) of a closed-shell density dm."""
        deriv = 1 if xc_mod.parse_xc(xc_code).is_gga else 0
        aod, weights = self.grid_ao(mol, grids, deriv)
        n, exc, vmat = self._get_rks_core_aod(xc_code)(aod, weights, dm)
        return float(n), float(exc), vmat

    def nr_uks(self, mol, grids, xc_code, dm):
        """(nelec (2,), exc, vxc (2, nao, nao)) of a spin density dm
        (2, nao, nao)."""
        deriv = 1 if xc_mod.parse_xc(xc_code).is_gga else 0
        aod, weights = self.grid_ao(mol, grids, deriv, spins=2)
        n, exc, vmat = self._get_uks_core_aod(xc_code)(aod, weights, dm)
        return n, float(exc), vmat
