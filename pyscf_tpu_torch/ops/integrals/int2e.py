"""Shell-pair screening and the derivative ERIs (d/dA ab|cd) of the
nuclear gradient.

Counterpart of the pieces of pyscf_tpu/ops/integrals/int2e.py that the
port's paths use: SCREEN_THRESH, pair_screen_bound, and int2e_ip1 with
the derivative bra table of DerivPairClass.
Screening runs in numpy on the host with the JAX package's exact
arithmetic, so both packages keep exactly the same shell pairs.

  int2e_ip1  (csrc/int2e_ip1.cu) replaces _deriv_class_pair_block on the
             DerivPairClass tables: the sph rows d/dA (ab|cd), three
             directions, of every shell pair of one ordered bra class
             against the screened pairs of every ket class; twin
             int2e_ip1_class_plain.

The derivative is not symmetric in a and b and its size is not bounded by
the pair's overlap bound, so the bra side runs every ordered class over
every shell pair, unscreened, as the JAX package does; the ket side keeps
the screened lc <= ld pairs and the (cd) = (dc) fold of the energy's ERIs.
"""
import numpy as np
import torch

from .hermite import e3d, n_tuv

SCREEN_THRESH = 1e-14


def pair_screen_bound(ga, gb):
    """Overlap-based magnitude bound per shell pair, (nsa, nsb) numpy."""
    ea, eb = ga.exps, gb.exps
    ca, cb = np.abs(ga.coeffs), np.abs(gb.coeffs)
    AB2 = ((ga.coords[:, None, :] - gb.coords[None, :, :]) ** 2).sum(-1)
    p = ea[:, None, :, None] + eb[None, :, None, :]
    mu = ea[:, None, :, None] * eb[None, :, None, :] / p
    return (ca[:, None, :, None] * cb[None, :, None, :]
            * np.exp(-mu * AB2[:, :, None, None])
            * (np.pi / p) ** 1.5).sum(axis=(2, 3))


def _deriv_pair_sph_tables(la, lb, ea, ca, ra, eb, cb, rb):
    """Sph-folded derivative bra tables of the primitive pairs of n shell
    pairs, 2a E^{la+1,lb} - i E^{la-1,lb} per direction:
    p (m,), P (m, 3), E (m, 3*da*db, ntuv(la+lb+1)), direction major."""
    from .int1e import flat_prims, sph
    from .int1e_deriv import _raised_lowered
    a, b, A, B, w = flat_prims(ea, ca, ra, eb, cb, rb)
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    Ep = e3d(la + 1, lb, a, b, A, B)
    Em = None
    if la >= 1:
        Em = e3d(la - 1, lb, a, b, A, B)
        Em = torch.nn.functional.pad(Em, (0, Ep.shape[-1] - Em.shape[-1]))
    E = _raised_lowered(la, a, Ep, Em) * w[:, None, None, None]
    E = torch.einsum('xmpqt,ap,bq->mxabt', E, sph(la, ea.device),
                     sph(lb, ea.device))
    return p, P, E.reshape(E.shape[0], -1, E.shape[-1])


def int2e_ip1_class_plain(la, lb, ea, ca, ra, eb, cb, rb, kets):
    """Plain PyTorch twin of the `int2e_ip1` kernel: sph rows d/dA (ab|cd)
    of n bra shell pairs of the ordered class (la, lb) against every ket
    class.

    kets: [(lc, ld, ec, cc, rc, ed, cd, rd)], the screened ket pair tables
    per class. Returns (3, n*(2la+1)(2lb+1), sum nket*(2lc+1)(2ld+1)), the
    ket classes' columns in the order given."""
    from .j3c import _PLAIN_BUDGET, _coulomb, _pair_sph_tables
    n, Ka = ea.shape
    KK1 = Ka * eb.shape[1]
    L1 = la + lb + 1
    ns1 = (2 * la + 1) * (2 * lb + 1)
    cols = []
    for lc, ld, *ket in kets:
        nk = ket[0].shape[0]
        KK2 = ket[0].shape[1] * ket[3].shape[1]
        L2 = lc + ld
        ns2 = (2 * lc + 1) * (2 * ld + 1)
        p2, P2, E2 = _pair_sph_tables(lc, ld, *ket)
        per_pair = KK1 * nk * KK2 * max(n_tuv(L1) * n_tuv(L2),
                                        ns2 * n_tuv(L1), 3 * ns1 * ns2)
        step = max(1, _PLAIN_BUDGET // per_pair)
        blocks = []
        for i in range(0, n, step):
            s = slice(i, i + step)
            p1, P1, E1 = _deriv_pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                                eb[s], cb[s], rb[s])
            v = _coulomb(L1, p1, P1, E1, L2, p2, P2, E2)
            v = v.reshape(-1, KK1, 3, ns1, nk, KK2, ns2).sum(dim=(1, 5))
            blocks.append(v.permute(1, 0, 2, 3, 4).reshape(3, -1, nk * ns2))
        cols.append(torch.cat(blocks, dim=1))
    return torch.cat(cols, dim=2)


def int2e_ip1(mol):
    """(3, nao, nao, nao, nao) on mol.device: d/dA (ab|cd), the derivative
    on the centre of the first bra function.

    One `int2e_ip1` launch per (ordered bra class, ket class). The rows of
    all bra classes are stacked and gathered to the dense tensor, one
    direction at a time: rows through the ordered AO pair map, columns
    through the ket's (cd)/(dc) map, whose extra index reads a zero."""
    from .. import kernels
    from .int1e import cross_pairs
    from .j2e import _index_map, _ket_arrays
    from .j3c import _bra_classes
    nao = mol.nao
    kets = _ket_arrays(mol)
    pieces, row_map, off = [], np.empty(nao * nao, dtype=np.int64), 0
    for la, lb, ga, gb, pairs in cross_pairs(mol, mol):
        pieces.append(kernels.int2e_ip1(la, lb, *pairs, kets))
        ia = (ga.ao_off[:, None] + np.arange(2 * la + 1)).ravel()
        jb = (gb.ao_off[:, None] + np.arange(2 * lb + 1)).ravel()
        ids = ia.reshape(ga.nshl, 1, -1, 1) * nao + jb.reshape(1, gb.nshl,
                                                               1, -1)
        row_map[ids.ravel()] = off + np.arange(ids.size)
        off += ids.size
    V = torch.cat(pieces, dim=1)
    del pieces
    bcs = [bc for bc in _bra_classes(mol).values() if bc.nsel]
    ncol = V.shape[2]
    rows = torch.as_tensor(row_map, device=V.device)
    cols = torch.as_tensor(_index_map(mol, bcs, ncol), device=V.device)
    out = torch.empty((3, nao * nao, nao * nao), dtype=V.dtype,
                      device=V.device)
    for x in range(3):
        Vx = torch.nn.functional.pad(V[x].index_select(0, rows), (0, 1))
        torch.index_select(Vx, 1, cols, out=out[x])
    return out.reshape(3, nao, nao, nao, nao)
