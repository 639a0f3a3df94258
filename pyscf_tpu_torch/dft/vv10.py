"""VV10 non-local correlation (Vydrov & Van Voorhis, JCP 133, 244103
(2010)).

Counterpart of pyscf_tpu/dft/vv10.py. The double sum over grid points

  E = sum_i w_i rho_i [ beta + 1/2 sum_j w_j rho_j Phi_ij ],
  Phi_ij = -3/2 / (g_i g_j (g_i + g_j)),  g_i = omega0_i R_ij^2 + kappa_i,
  omega0 = sqrt(C (s^2)^2 + (4 pi/3) rho),  s^2 = |grad rho|^2 / rho^2,
  kappa = b (3 pi/2) (rho/(9 pi))^(1/6),  beta = (1/32) (3/b^2)^(3/4),

over the points with rho > RHO_CUT, with its derivatives in rho and
|grad rho|^2 per point (what jax.value_and_grad takes of the JAX package's
_vv10_energy_features), is the CUDA kernel `vv10` (csrc/vv10.cu), an
N-body pair sum, with the plain twin vv10_plain here: the closed-form sums
of PySCF's _vv10nlc, evaluated block by block so that no (ng, ng) array is
ever held. nr_vv10 forms rho and |grad rho|^2 from the SCF's own AO blocks
and assembles V from the derivatives with one GEMM per block.

As in the JAX package, VV10 runs on the SCF's grid (PySCF uses a coarser
nlcgrids).
"""
import math

import torch

RHO_CUT = 1e-8
# doubles per temporary of the plain twin's (rows, ng) pair block: within
# the L2 cache on the CPU (256 KB; 2.4x faster on one core than 2 MB
# blocks), large on the card
PLAIN_BLOCK_ELEMS = {'cpu': 1 << 15, 'cuda': 1 << 24}


def vv10_features(rho, g2, weights, b, C):
    """(mask, omega0, kappa, wr, beta) per point, the JAX package's masking:
    a point with rho <= RHO_CUT gets rho 1, g2 0 and weight 0."""
    mask = rho > RHO_CUT
    rho_s = torch.where(mask, rho, 1.0)
    g2_s = torch.where(mask, g2, 0.0)
    w = torch.where(mask, weights, 0.0)
    beta = 0.03125 * (3.0 / (b * b)) ** 0.75
    s2 = g2_s / (rho_s * rho_s)
    omega0 = torch.sqrt(C * s2 * s2 + (4.0 * math.pi / 3.0) * rho_s)
    kappa = b * (1.5 * math.pi) * (rho_s / (9.0 * math.pi)) ** (1.0 / 6.0)
    return mask, omega0, kappa, w * rho_s, beta


def vv10_plain(rho, g2, coords, weights, b, C):
    """Plain PyTorch twin of the `vv10` kernel: (E (0-d), dE/drho (ng,),
    dE/dg2 (ng,)) of the densities rho, g2 = |grad rho|^2 and weights (ng,)
    on the points coords (ng, 3).

    Per block of points i, against every j (each pair once: Phi is
    symmetric):
      U_i = sum_j wr_j Phi_ij,  W_i = sum_j wr_j dPhi_ij/dg_i,
      V_i = sum_j wr_j dPhi_ij/dg_i R_ij^2,
    with t = 1/(g_i g_j (g_i + g_j)), Phi = -3/2 t and dPhi/dg_i =
    3/2 t^2 g_j (g_i + g_j + g_i); then
      dE/drho_i = w_i (beta + U_i)
                  + wr_i (W_i kappa'_i + V_i d omega0_i/drho_i)
      dE/dg2_i  = wr_i V_i d omega0_i/dg2_i
    on the unmasked points (zero on the rest; the sums run over the
    unmasked points only, where wr is not zero)."""
    mask, omega0, kappa, wr, beta = vv10_features(rho, g2, weights, b, C)
    # a masked point has wr = 0, so it adds nothing to any U, W or V, and
    # its own outputs are zeroed below: the sums run over the kept points
    keep = torch.nonzero(mask).squeeze(1)
    om, ka, wk = omega0[keep], kappa[keep], wr[keep]
    nk = keep.shape[0]
    step = max(1, PLAIN_BLOCK_ELEMS[rho.device.type] // max(nk, 1))
    Uk, Wk, Vk = (om.new_zeros(nk) for _ in range(3))
    x, y, z = coords[keep].T
    # Phi_ij is symmetric: the row block [i, i + step) meets the columns
    # from i on; the rows' sums take every column, the columns' sums past
    # the block take the rows (the columns before i met these rows as rows)
    for i in range(0, nk, step):
        s, c = slice(i, i + step), slice(i, nk)
        e = min(i + step, nk) - i
        dx = x[s, None] - x[c]
        dy = y[s, None] - y[c]
        dz = z[s, None] - z[c]
        r2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        gi = om[s, None] * r2 + ka[s, None]
        gj = om[c] * r2 + ka[c]
        gs = gi + gj
        t = 1.0 / (gi * gj * gs)
        t2 = t * t
        di = t2 * gj * (gs + gi)          # dPhi_ij/dg_i up to 3/2
        dj = (t2 * gi * (gs + gj))[:, e:]  # dPhi_ji/dg_j, past the block
        Uk[s] += t @ wk[c]
        Wk[s] += di @ wk[c]
        Vk[s] += (di * r2) @ wk[c]
        Uk[i + e:] += wk[s] @ t[:, e:]
        Wk[i + e:] += wk[s] @ dj
        Vk[i + e:] += wk[s] @ (dj * r2[:, e:])
    U, W, V = (torch.zeros_like(rho).index_copy_(0, keep, v)
               for v in (Uk, Wk, Vk))
    U, W, V = -1.5 * U, 1.5 * W, 1.5 * V
    r = torch.where(mask, rho, 1.0)
    s2 = torch.where(mask, g2, 0.0) / (r * r)
    dodr = (4.0 * math.pi / 3.0 - 4.0 * C * s2 * s2 / r) / (2.0 * omega0)
    dodg = C * s2 / (r * r * omega0)
    dkdr = kappa / (6.0 * r)
    e = torch.sum(wr * (beta + 0.5 * U))
    w = torch.where(mask, weights, 0.0)
    de_drho = torch.where(mask, w * (beta + U) + wr * (W * dkdr + V * dodr),
                          0.0)
    de_dg2 = torch.where(mask, wr * V * dodg, 0.0)
    return e, de_drho, de_dg2


def density_features(aods, dm):
    """(rho (ng,), |grad rho|^2 (ng,), [grad rho (3, B) per block]) of a
    closed-shell density dm on AO blocks (4, B, nao), as the JAX package's
    nr_vv10 forms them: rho = max(sum (ao dm) ao, 0), grad rho =
    2 sum (ao dm) grad ao."""
    rho, grho = [], []
    for aod in aods:
        dmao = aod[0] @ dm
        rho.append(torch.clamp(torch.einsum('bi,bi->b', dmao, aod[0]),
                               min=0.0))
        grho.append(2.0 * torch.einsum('bi,dbi->db', dmao, aod[1:]))
    g2 = [torch.einsum('db,db->b', g, g) for g in grho]
    return torch.cat(rho), torch.cat(g2), grho


def nr_vv10(mol, grids, dm, b=5.9, C=0.0093, ao_eval=None, events=None):
    """(E_nlc (0-d), V (nao, nao)) of a closed-shell density dm on the grid.

    ao_eval: (AO value blocks, weight blocks) of the grid as NumInt.grid_ao
    gives them, (4, B, nao) each, in the grid's order (the SCF's own
    blocks); evaluated here when None. density_features per block, then one
    `vv10` launch on the whole grid, then per block V += ao^T (1/2 dE/drho
    ao + 2 dE/dg2 grad rho . grad ao), V + V^T. events, a list, receives a
    (start, end) pair of CUDA events around the launch (on the card
    only)."""
    from ..ops import kernels
    from .numint import NumInt
    if ao_eval is None:
        ao_eval = NumInt().grid_ao(mol, grids, 1)
    aods, wblocks = ao_eval
    rho, g2, grho = density_features(aods, dm)
    args = (rho, g2, grids.coords, torch.cat(wblocks), float(b), float(C))
    if events is None:
        e, de_drho, de_dg2 = kernels.vv10(*args)
    else:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        e, de_drho, de_dg2 = kernels.vv10(*args)
        end.record()
        events.append((start, end))
    v = torch.zeros_like(dm)
    off = 0
    for aod, g in zip(aods, grho):
        s = slice(off, off + aod.shape[1])
        vtmp = 0.5 * de_drho[s, None] * aod[0] + torch.einsum(
            'db,dbi->bi', 2.0 * de_dg2[s] * g, aod[1:])
        v = v + aod[0].T @ vtmp
        off += aod.shape[1]
    return e, v + v.T
