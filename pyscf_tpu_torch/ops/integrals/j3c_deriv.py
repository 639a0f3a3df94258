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
from .int1e_deriv import _raised_lowered, _second_shift
from .int2e import _deriv_pair_sph_tables
from .j3c import (_plain_budget, _bra_classes, _coulomb, _aux_prep,
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


def _shift2_tables(la, lb, a, b, A, B, w):
    """Cartesian Hermite tables of d2/dA_x dA_y of the bra shell la against
    lb: (3, 3, m, ncart_a, ncart_b, ntuv(la+lb+2)), weights w folded in."""
    nt = n_tuv(la + lb + 2)
    blocks = {}
    for l in (la + 2, la, la - 2):
        if l >= 0:
            E = e3d(l, lb, a, b, A, B)
            blocks[l] = torch.nn.functional.pad(E, (0, nt - E.shape[-1]))
    return _second_shift(la, a, blocks) * w[:, None, None, None]


def _deriv2_pair_sph_tables(la, lb, ea, ca, ra, eb, cb, rb):
    """Sph-folded second-derivative bra tables of the primitive pairs of n
    shell pairs: p (m,), P (m, 3), E (m, 9*da*db, ntuv(la+lb+2)), the
    direction pair (x, y) major."""
    from .int1e import flat_prims
    a, b, A, B, w = flat_prims(ea, ca, ra, eb, cb, rb)
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    E = torch.einsum('xympqt,ap,bq->mxyabt',
                     _shift2_tables(la, lb, a, b, A, B, w),
                     sph(la, ea.device), sph(lb, ea.device))
    return p, P, E.reshape(E.shape[0], -1, E.shape[-1])


def _aux_ip2_prep(l, e, c, r):
    """Sph-folded second-derivative tables d2/dC_x dC_y of every primitive
    of one aux class: (m, 9*(2l+1), ntuv(l+2)), the direction pair major."""
    K = e.shape[1]
    ef = e.reshape(-1)
    rf = r.repeat_interleave(K, dim=0)
    E = _shift2_tables(l, 0, ef, torch.zeros_like(ef), rf, rf,
                       c.reshape(-1))[:, :, :, :, 0, :]
    E = torch.einsum('xympt,ap->mxyat', E, sph(l, e.device))
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
        per_pair = KK * nsx * K2 * max(n_tuv(L1 + 1) * n_tuv(l2 + 1),
                                       3 * ns2 * n_tuv(L1 + 1))
        step = max(1, _plain_budget(ea) // per_pair)
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


def int3c2e_ip1_rows(la, lb, ea, ca, ra, eb, cb, rb, aux):
    """d(ij|P)/dA_i of n ordered shell pairs of class (la, lb) against
    every aux shell, (3, n*(2la+1)(2lb+1), naux) in int3c2e's row layout
    and grouped aux order, from the bra's power-shift tables."""
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    L1 = la + lb
    ns1 = (2 * la + 1) * (2 * lb + 1)
    cols = []
    for l2, e2, c2, r2 in aux:
        nsx, K2 = e2.shape
        ns2 = 2 * l2 + 1
        p2, P2, E2 = _aux_prep(l2, e2, c2, r2)
        per_pair = KK * nsx * K2 * max(n_tuv(L1 + 1) * n_tuv(l2 + 1),
                                       3 * ns2 * n_tuv(L1 + 1))
        step = max(1, _plain_budget(ea) // per_pair)
        blocks = []
        for i in range(0, n, step):
            s = slice(i, i + step)
            p1, P1, E1d = _deriv_pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                                 eb[s], cb[s], rb[s])
            v = _coulomb(L1 + 1, p1, P1, E1d, l2, p2, P2, E2)
            v = v.reshape(-1, KK, 3, ns1, nsx, K2, ns2).sum(dim=(1, 5))
            blocks.append(v.permute(1, 0, 2, 3, 4).reshape(3, -1, nsx * ns2))
        cols.append(torch.cat(blocks, dim=1) if blocks
                    else ea.new_zeros((3, 0, nsx * ns2)))
    return torch.cat(cols, dim=2)


def int3c2e_ip1_plain(la, lb, ea, ca, ra, eb, cb, rb, aux, ia, jb, out):
    """Plain PyTorch twin of the `int3c2e_ip1` kernel: int3c2e_ip1_rows
    written into out (3, nao, nao, naux) at rows ia[k] + sa, columns
    jb[k] + sb of pair k, as the kernel writes them. Returns out."""
    n, da, db = ea.shape[0], 2 * la + 1, 2 * lb + 1
    if n == 0:
        return out
    rows = int3c2e_ip1_rows(la, lb, ea, ca, ra, eb, cb, rb, aux)
    i = ia.long()[:, None] + torch.arange(da, device=out.device)
    j = jb.long()[:, None] + torch.arange(db, device=out.device)
    out[:, i.reshape(n, da, 1), j.reshape(n, 1, db)] = rows.reshape(
        3, n, da, db, -1)
    return out


def int3c2e_ipip_plain(la, lb, ea, ca, ra, eb, cb, rb, aux, G):
    """Plain PyTorch twin of the `int3c2e_ipip` kernel.

    G as int3c2e_ip_plain's. Returns (n, nshells of aux, 27): per shell pair
    and aux shell, sum over the block of G times d2(ij|P)/dA dA, dA dB and
    dB dB (3 x 3 each, row-major). AA from the bra's tables with the
    power-shift rule applied twice, AC (A and the aux centre C) from the
    bra's and the aux shell's first-derivative tables, CC from the aux
    shell's second-derivative tables; then d/dB = -(d/dA + d/dC)."""
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    L1 = la + lb
    ns1 = (2 * la + 1) * (2 * lb + 1)
    out = ea.new_zeros((n, _nshells(aux), 27))
    sh = col = 0
    for l2, e2, c2, r2 in aux:
        nsx, K2 = e2.shape
        ns2 = 2 * l2 + 1
        p2, P2, E2 = _aux_prep(l2, e2, c2, r2)
        E2d = _aux_ip_prep(l2, e2, c2, r2)
        E2dd = _aux_ip2_prep(l2, e2, c2, r2)
        per_pair = KK * nsx * K2 * 9 * max(n_tuv(L1 + 2) * n_tuv(l2 + 1),
                                           ns2 * n_tuv(L1 + 2))
        step = max(1, _plain_budget(ea) // per_pair)
        for i in range(0, n, step):
            s = slice(i, i + step)
            m = ea[s].shape[0]
            g = G[i * ns1:(i + m) * ns1, col:col + nsx * ns2]
            g = g.reshape(m, ns1, nsx, ns2)
            args = (ea[s], ca[s], ra[s], eb[s], cb[s], rb[s])
            p1, P1, E1dd = _deriv2_pair_sph_tables(la, lb, *args)
            aa = _coulomb(L1 + 2, p1, P1, E1dd, l2, p2, P2, E2)
            aa = aa.reshape(m, KK, 9, ns1, nsx, K2, ns2).sum(dim=(1, 5))
            p1, P1, E1d = _deriv_pair_sph_tables(la, lb, *args)
            ac = _coulomb(L1 + 1, p1, P1, E1d, l2 + 1, p2, P2, E2d)
            ac = ac.reshape(m, KK, 3, ns1, nsx, K2, 3, ns2).sum(dim=(1, 5))
            p1, P1, E1 = _pair_sph_tables(la, lb, *args)
            cc = _coulomb(L1, p1, P1, E1, l2 + 2, p2, P2, E2dd)
            cc = cc.reshape(m, KK, ns1, nsx, K2, 9, ns2).sum(dim=(1, 4))
            aa = torch.einsum('mkaPq,maPq->mPk', aa, g).reshape(m, nsx, 3, 3)
            ac = torch.einsum('mxaPyq,maPq->mPxy', ac, g)
            cc = torch.einsum('maPkq,maPq->mPk', cc, g).reshape(m, nsx, 3, 3)
            ab = -(aa + ac)
            bb = aa + ac + ac.transpose(-1, -2) + cc
            out[s, sh:sh + nsx] = torch.cat(
                [aa.reshape(m, nsx, 9), ab.reshape(m, nsx, 9),
                 bb.reshape(m, nsx, 9)], dim=-1)
        sh += nsx
        col += nsx * ns2
    return out


def int2c2e_ip1_full_plain(aux):
    """Plain PyTorch twin of the `int2c2e_ip1_full` kernel: d(P|Q)/dR_P of
    every aux function pair, (3, naux, naux) in grouped aux order, from P's
    power-shift tables."""
    preps = [(l, e.shape) + _aux_prep(l, e, c, r) + (_aux_ip_prep(l, e, c, r),)
             for l, e, c, r in aux]
    rows = []
    for lx, (nsx, Kx), px, Px, _, Exd in preps:
        dx = 2 * lx + 1
        cols = []
        for ly, (nsy, Ky), py, Py, Ey, _ in preps:
            dy = 2 * ly + 1
            v = _coulomb(lx + 1, px, Px, Exd, ly, py, Py, Ey)
            v = v.reshape(nsx, Kx, 3, dx, nsy, Ky, dy).sum(dim=(1, 5))
            cols.append(v.permute(1, 0, 2, 3, 4).reshape(3, nsx * dx,
                                                        nsy * dy))
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def int2c2e_ipip_plain(aux, W):
    """Plain PyTorch twin of the `int2c2e_ipip` kernel: (nshells, nshells,
    9), entry (P, Q) the sum over the block of W times d2(P|Q)/dR_P dR_P
    (row-major), from P's second-derivative tables. W as int2c2e_ip1's."""
    preps = [(l, e.shape) + _aux_prep(l, e, c, r)
             + (_aux_ip2_prep(l, e, c, r),) for l, e, c, r in aux]
    nsh = _nshells(aux)
    out = W.new_zeros((nsh, nsh, 9))
    shx = offx = 0
    for lx, (nsx, Kx), px, Px, _, Exdd in preps:
        dx = 2 * lx + 1
        shy = offy = 0
        for ly, (nsy, Ky), py, Py, Ey, _ in preps:
            dy = 2 * ly + 1
            v = _coulomb(lx + 2, px, Px, Exdd, ly, py, Py, Ey)
            v = v.reshape(nsx, Kx, 9, dx, nsy, Ky, dy).sum(dim=(1, 5))
            w = W[offx:offx + nsx * dx, offy:offy + nsy * dy]
            out[shx:shx + nsx, shy:shy + nsy] = torch.einsum(
                'PkaQb,PaQb->PQk', v, w.reshape(nsx, dx, nsy, dy))
            shy += nsy
            offy += nsy * dy
        shx += nsx
        offx += nsx * dx
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
