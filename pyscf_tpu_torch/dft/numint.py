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

The grid is not padded, and blocks are sized by
memory, not by the TPU's budget: on the card one block usually holds the
whole grid. The AO values are evaluated once per SCF (grid_ao) and reused
every cycle.
"""
import time

import torch

from ..ops.eval_gto import SECOND_DERIVS, eval_ao
from ..ops.integrals.j3c import sync
from . import xc as xc_mod

# The JAX package's thresholds, kept so both give the same energies.
RHO_THR = 1e-10
SIGMA_FLOOR = 1e-20
# bytes a block of grid points may take in AO values and per-cycle
# temporaries: half the free memory on the card, this much on the CPU
CPU_BLOCK_BYTES = 1 << 28


def _masked(rho, sigma):
    mask = rho > RHO_THR
    rho_s = torch.where(mask, torch.clamp(rho, min=RHO_THR), 1.0)
    sigma_s = torch.where(mask, torch.clamp(sigma, min=SIGMA_FLOOR), 1.0)
    return mask, rho_s, sigma_s


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
    vsigma come from torch.autograd through the functional's clamps."""
    gga = aod.dim() == 3
    ao = aod[0] if gga else aod
    rho = torch.clamp(torch.einsum('bi,bi->b', dmao, ao), min=0.0)
    if gga:
        grho = 2.0 * torch.einsum('bi,dbi->db', dmao, aod[1:])
        sigma = torch.einsum('db,db->b', grho, grho)
    else:
        sigma = torch.zeros_like(rho)
    mask, rho_s, sigma_s = _masked(rho, sigma)
    with torch.enable_grad():
        r = rho_s.detach().requires_grad_()
        s = sigma_s.detach().requires_grad_()
        e = edens_closed(xc, r, s)
        vrho, vsigma = torch.autograd.grad(e.sum(), (r, s), allow_unused=True)
    exc = torch.sum(torch.where(mask, weights * e.detach(), 0.0))
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
    sigma_ab as it is; the derivatives by torch.autograd at the clamped
    values."""
    mask = (rho[0] + rho[1]) > RHO_THR

    def sf(x, lo):
        return torch.where(mask, x if lo is None else torch.clamp(x, min=lo),
                           1.0)

    args = [sf(rho[0], 0.5 * RHO_THR), sf(rho[1], 0.5 * RHO_THR),
            sf(sig[0], SIGMA_FLOOR), sf(sig[1], None), sf(sig[2], SIGMA_FLOOR)]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in args]
        e = xc.exc_density(*leaves)
        grads = torch.autograd.grad(e.sum(), leaves, allow_unused=True)
    return mask, [torch.zeros_like(rho[0]) if g is None else g
                  for g in grads], e.detach()


def xc_uks_plain(aod, dmao, weights, xc):
    """Plain PyTorch twin of the `xc_uks` kernel on one block of B points.

    aod (B, nao) for an LDA or (4, B, nao) for a GGA, dmao = ao @ dm_s
    stacked (2, B, nao), weights (B,). Returns (vtmp (2, B, nao), n (2,),
    exc) with n_s = sum w rho_s and exc = sum over unmasked points of
    w e_xc. The mask and clamps are the JAX package's (numint.py:265-273):
    rho_a + rho_b > RHO_THR, rho_s >= RHO_THR/2, sigma_ss >= SIGMA_FLOOR,
    sigma_ab as it is; the five derivatives come from torch.autograd."""
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


def _grad_rows(aod, dm_rows, a, bj):
    """g (3, nao) of one density's coefficients per point, a (B,) and, for
    a GGA, bj (3, B): sum_b a d_x phi (D phi) + sum_j bj (d_x phi (D d_j
    phi) + d_x d_j phi (D phi)); dm_rows = aod[:4] @ D (or aod[:1] @ D)."""
    dm0 = dm_rows[0]
    g = torch.einsum('b,xbi,bi->xi', a, aod[1:4], dm0)
    if bj is None:
        return g
    second = {}
    for k, (i, j) in enumerate(SECOND_DERIVS):
        second[i, j] = second[j, i] = aod[4 + k]
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


def _block_size(npts, nao, ncomp, device):
    """Points per block when each point holds ncomp rows of nao doubles."""
    per_point = ncomp * nao * 8
    if device.type == 'cuda':
        budget = torch.cuda.mem_get_info(device)[0] // 2
    else:
        budget = CPU_BLOCK_BYTES
    return max(1, min(npts, budget // per_point))


class NumInt:
    """Restricted and unrestricted numerical integrator."""

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
