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

The grid is not padded, and blocks are sized by
memory, not by the TPU's budget: on the card one block usually holds the
whole grid. The AO values are evaluated once per SCF (grid_ao) and reused
every cycle.
"""
import torch

from ..ops.eval_gto import eval_ao
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
    rho = torch.clamp(torch.einsum('sbi,bi->sb', dmao, ao), min=0.0)
    if gga:
        grho = 2.0 * torch.einsum('sbi,dbi->sdb', dmao, aod[1:])
        sig = [torch.einsum('db,db->b', grho[i], grho[j])
               for i, j in ((0, 0), (0, 1), (1, 1))]
    else:
        sig = [torch.zeros_like(rho[0])] * 3
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
    vra, vrb, vsaa, vsab, vsbb = [torch.zeros_like(rho[0]) if g is None
                                  else g for g in grads]
    exc = torch.sum(torch.where(mask, weights * e.detach(), 0.0))
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


def _block_size(npts, nao, deriv, device, spins=1):
    per_point = ((4 if deriv else 1) + 2 * spins) * nao * 8
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
        blk = _block_size(n, mol.nao, deriv, mol.device, spins)
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
