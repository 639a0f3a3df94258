"""Nuclear derivatives of the DF integrals (ij|P) and (P|Q), contracted with
the fitted densities as they are made.

Counterpart of what jax.grad makes of pyscf_tpu/grad/autodiff.py
_df_intermediates (:148) and _j2c (:131), through the integral programs
_eri_core, _paired_data_kernel and _aux_data_kernel
(pyscf_tpu/ops/integrals/int2e.py:127,310,235). A hand-written kernel has
no backward, so the derivatives are explicit kernels with plain PyTorch
twins here:

  int3c2e_ip   (csrc/int3c2e_ip.cu) d(ij|P)/dA and d(ij|P)/dB of the
               screened shell pairs of one bra class against every aux
               shell, contracted with Gamma^P_ij; twin int3c2e_ip_plain.
  int2c2e_ip1  (csrc/int2c2e_ip1.cu) d(P|Q)/dP of every ordered aux shell
               pair, contracted with W_PQ; twin int2c2e_ip1_plain.

The remaining centre follows from translational invariance: d/dC =
-(d/dA + d/dB) for the aux centre of (ij|P), d/dQ = -d/dP. No
(3, naux, nao, nao) tensor is built. The bra pairs are the energy's
screened pairs (j3c._BraClass, la <= lb, the upper triangle on the
diagonal), which are the reference's _GradPairs; the factor 2 of the pairs
that stand for (ij) and (ji) is folded into the Gamma rows.
"""
import numpy as np
import torch

from .hermite import e3d, n_tuv
from .int1e import sph
from .int1e_deriv import _raised_lowered
from .int2e import _deriv_pair_sph_tables
from .j3c import (_PLAIN_BUDGET, _bra_classes, _coulomb, _aux_prep,
                  _grouped_order, _pair_sph_tables, _row_maps, aux_tables,
                  screened_pairs)


def _aux_ip_prep(l, e, c, r):
    """Sph-folded derivative tables d/dC of every primitive of one aux
    class, 2c E^{l+1} - k E^{l-1} per direction: (m, 3*(2l+1), ntuv(l+1)),
    direction major."""
    K = e.shape[1]
    ef = e.reshape(-1)
    rf = r.repeat_interleave(K, dim=0)
    zero = torch.zeros_like(ef)
    Ep = e3d(l + 1, 0, ef, zero, rf, rf)[:, :, 0, :]
    Em = None
    if l >= 1:
        Em = e3d(l - 1, 0, ef, zero, rf, rf)[:, :, 0, :]
        Em = torch.nn.functional.pad(Em, (0, Ep.shape[-1] - Em.shape[-1]))
    E = _raised_lowered(l, ef, Ep, Em) * c.reshape(-1)[:, None, None]
    E = torch.einsum('xmpt,ap->mxat', E, sph(l, e.device))
    return E.reshape(E.shape[0], -1, E.shape[-1])


def _nshells(aux):
    return sum(e.shape[0] for _, e, _, _ in aux)


def int3c2e_ip_plain(la, lb, ea, ca, ra, eb, cb, rb, aux, G):
    """Plain PyTorch twin of the `int3c2e_ip` kernel.

    G (n*(2la+1)(2lb+1), naux): rows of Gamma in the layout of int3c2e's
    output (grouped aux order). Returns (n, nshells of aux, 6): per shell
    pair and aux shell, sum over the block's rows and columns of G times
    d(ij|P)/dA_x (x, y, z), then d(ij|P)/dB_x. d/dA comes from the bra's
    power-shift tables, d/dC from the aux shell's, and d/dB = -(d/dA +
    d/dC)."""
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    L1 = la + lb
    ns1 = (2 * la + 1) * (2 * lb + 1)
    out = ea.new_zeros((n, _nshells(aux), 6))
    sh = col = 0
    for l2, e2, c2, r2 in aux:
        nsx, K2 = e2.shape
        ns2 = 2 * l2 + 1
        p2, P2, E2 = _aux_prep(l2, e2, c2, r2)
        E2d = _aux_ip_prep(l2, e2, c2, r2)
        per_pair = KK * nsx * K2 * max(n_tuv(L1 + l2 + 1),
                                       3 * ns2 * n_tuv(L1 + 1))
        step = max(1, _PLAIN_BUDGET // per_pair)
        for i in range(0, n, step):
            s = slice(i, i + step)
            m = ea[s].shape[0]
            g = G[i * ns1:(i + m) * ns1, col:col + nsx * ns2]
            g = g.reshape(m, ns1, nsx, ns2)
            p1, P1, E1d = _deriv_pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                                 eb[s], cb[s], rb[s])
            va = _coulomb(L1 + 1, p1, P1, E1d, l2, p2, P2, E2)
            va = va.reshape(m, KK, 3, ns1, nsx, K2, ns2).sum(dim=(1, 5))
            p1, P1, E1 = _pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                          eb[s], cb[s], rb[s])
            vc = _coulomb(L1, p1, P1, E1, l2 + 1, p2, P2, E2d)
            vc = vc.reshape(m, KK, ns1, nsx, K2, 3, ns2).sum(dim=(1, 4))
            da = torch.einsum('mxaPq,maPq->mPx', va, g)
            dc = torch.einsum('maPxq,maPq->mPx', vc, g)
            out[s, sh:sh + nsx, :3] = da
            out[s, sh:sh + nsx, 3:] = -(da + dc)
        sh += nsx
        col += nsx * ns2
    return out


def int2c2e_ip1_plain(aux, W):
    """Plain PyTorch twin of the `int2c2e_ip1` kernel.

    W (naux, naux) in grouped aux order. Returns (nshells, nshells, 3): per
    ordered aux shell pair (P, Q), sum over the block of W times
    d(P|Q)/dR_P, from P's power-shift tables."""
    preps = [(l, e.shape) + _aux_prep(l, e, c, r) + (_aux_ip_prep(l, e, c, r),)
             for l, e, c, r in aux]
    nsh = _nshells(aux)
    out = W.new_zeros((nsh, nsh, 3))
    shx = offx = 0
    for lx, (nsx, Kx), px, Px, _, Exd in preps:
        dx = 2 * lx + 1
        shy = offy = 0
        for ly, (nsy, Ky), py, Py, Ey, _ in preps:
            dy = 2 * ly + 1
            v = _coulomb(lx + 1, px, Px, Exd, ly, py, Py, Ey)
            v = v.reshape(nsx, Kx, 3, dx, nsy, Ky, dy).sum(dim=(1, 5))
            w = W[offx:offx + nsx * dx, offy:offy + nsy * dy]
            out[shx:shx + nsx, shy:shy + nsy] = torch.einsum(
                'PxaQb,PaQb->PQx', v, w.reshape(nsx, dx, nsy, dy))
            shy += nsy
            offy += nsy * dy
        shx += nsx
        offx += nsx * dx
    return out


# ---------------------------------------------------------------------------
# the contracted derivatives summed by atom
# ---------------------------------------------------------------------------

def _aux_atoms(auxmol, dev):
    """Atom of every aux shell, in the shell order of aux_tables."""
    ids = [auxmol.shell_groups[l].atom_ids
           for l in sorted(auxmol.shell_groups.keys())]
    return torch.as_tensor(np.concatenate(ids), dtype=torch.int64, device=dev)


def _gamma_rows(mol, bc, gamma_flat):
    """Rows of Gamma (grouped aux order, flattened (ij)) in int3c2e's row
    layout for one bra class, with the factor 2 of the off-diagonal
    pairs."""
    rows_ij, _, _ = _row_maps(mol, bc)
    fac = np.where((bc.la == bc.lb) & (bc.sel_a == bc.sel_b), 1.0, 2.0)
    fac = torch.as_tensor(np.repeat(fac, bc.ns1), device=gamma_flat.device)
    idx = torch.as_tensor(rows_ij, device=gamma_flat.device)
    return (gamma_flat.index_select(1, idx).T * fac[:, None]).contiguous()


def grad_3c(mol, auxmol, gamma):
    """sum_P sum_ij Gamma^P_ij d(ij|P)/dX as (natm, 3) on mol.device.

    gamma (naux, nao, nao): symmetric in (i, j), aux in AO order. One
    `int3c2e_ip` launch per (bra class, aux class)."""
    from .. import kernels
    dev = mol.device
    naux, nao = auxmol.nao, mol.nao
    order = torch.as_tensor(_grouped_order(auxmol), device=dev)
    gflat = gamma.reshape(naux, nao * nao).index_select(0, order)
    aux = aux_tables(auxmol)
    bra = _bra_classes(mol)
    de = torch.zeros((mol.natm, 3), dtype=torch.float64, device=dev)
    daux = torch.zeros((_nshells(aux), 3), dtype=torch.float64, device=dev)
    for cls, (bc, pairs) in screened_pairs(mol).items():
        out = kernels.int3c2e_ip(*cls, *pairs, aux,
                                 _gamma_rows(mol, bra[cls], gflat))
        da, db = out[..., :3].sum(dim=1), out[..., 3:].sum(dim=1)
        de.index_add_(0, torch.as_tensor(bc.ga.atom_ids[bc.sel_a],
                                         dtype=torch.int64, device=dev), da)
        de.index_add_(0, torch.as_tensor(bc.gb.atom_ids[bc.sel_b],
                                         dtype=torch.int64, device=dev), db)
        daux -= out[..., :3].sum(dim=0) + out[..., 3:].sum(dim=0)
    de.index_add_(0, _aux_atoms(auxmol, dev), daux)
    return de


def grad_2c(auxmol, W):
    """sum_PQ W_PQ d(P|Q)/dX as (natm, 3) on auxmol.device.

    W (naux, naux): symmetric, aux in AO order. One `int2c2e_ip1` launch per
    ordered aux class pair."""
    from .. import kernels
    dev = auxmol.device
    order = torch.as_tensor(_grouped_order(auxmol), device=dev)
    Wg = W.index_select(0, order).index_select(1, order).contiguous()
    g = kernels.int2c2e_ip1(aux_tables(auxmol), Wg)
    atoms = _aux_atoms(auxmol, dev)
    de = torch.zeros((auxmol.natm, 3), dtype=torch.float64, device=dev)
    de.index_add_(0, atoms, g.sum(dim=1))
    de.index_add_(0, atoms, -g.sum(dim=0))
    return de
