"""The dense in-core ERI tensor (ab|cd), (nao,)^4, on the device.

Counterpart of pyscf_tpu/ops/integrals/j2e.py. The screened bra classes
and their row maps are j3c.py's; the device program becomes one CUDA kernel
with a plain PyTorch twin here:

  int2e  (csrc/int2e.cu) replaces _class_pair_program: the sph rows
         (ab|cd) of every screened shell pair of one bra class against
         every screened shell pair of one ket class, contracted over all
         primitives; twin int2e_class_plain. With omega (the JAX package's
         rs_omega) the rows are of the erf(omega r)/r attenuated operator,
         the long-range tensor of a range-separated functional's in-core K
         (launched and counted as int2e_lr).

Every ordered pair of classes is computed, so (ab|cd) and (cd|ab) come
from two launches; the pieces of all bra classes share one column layout
(every ket class in order), and _assemble_4c gathers them to the dense
tensor through the (ij)/(ji) maps of _row_maps on both axes, which gives
the 8-fold symmetry. Pairs the screening dropped read a zero row/column.
"""
import numpy as np
import torch

from .hermite import n_tuv
from .j3c import (_PLAIN_BUDGET, _bra_classes, _coulomb, _pair_sph_tables,
                  _row_maps, screened_pairs)


def int2e_class_plain(la, lb, ea, ca, ra, eb, cb, rb, kets, omega=None):
    """Plain PyTorch twin of the `int2e` kernel: sph rows (ab|cd) of n bra
    shell pairs of class (la, lb) against every ket class; with omega, of
    the erf(omega r)/r attenuated operator.

    kets: [(lc, ld, ec, cc, rc, ed, cd, rd)], the screened ket pair tables
    per class. Returns (n*(2la+1)(2lb+1), sum nket*(2lc+1)(2ld+1)), the
    ket classes' columns in the order given."""
    n, Ka = ea.shape
    KK1 = Ka * eb.shape[1]
    L1 = la + lb
    ns1 = (2 * la + 1) * (2 * lb + 1)
    cols = []
    for lc, ld, *ket in kets:
        nk = ket[0].shape[0]
        KK2 = ket[0].shape[1] * ket[3].shape[1]
        L2 = lc + ld
        ns2 = (2 * lc + 1) * (2 * ld + 1)
        p2, P2, E2 = _pair_sph_tables(lc, ld, *ket)
        per_pair = KK1 * nk * KK2 * max(n_tuv(L1) * n_tuv(L2),
                                        ns2 * n_tuv(L1), ns1 * ns2)
        step = max(1, _PLAIN_BUDGET // per_pair)
        blocks = []
        for i in range(0, n, step):
            s = slice(i, i + step)
            p1, P1, E1 = _pair_sph_tables(la, lb, ea[s], ca[s], ra[s],
                                          eb[s], cb[s], rb[s])
            v = _coulomb(L1, p1, P1, E1, L2, p2, P2, E2, omega)
            v = v.reshape(-1, KK1, ns1, nk, KK2, ns2).sum(dim=(1, 4))
            blocks.append(v.reshape(-1, nk * ns2))
        cols.append(torch.cat(blocks))
    return torch.cat(cols, dim=1)


def _ket_arrays(mol):
    """[(lc, ld, ec, cc, rc, ed, cd, rd)] of every screened class: the ket
    side of each launch (the JAX package pads these to its tile size; the
    kernel takes them as they are)."""
    return [(lc, ld, *pairs)
            for (lc, ld), (_, pairs) in screened_pairs(mol).items()]


def _assemble_4c(pieces, index, nao):
    """Stack the bra-class pieces, which share one column layout, and
    gather rows and columns to the dense (nao, nao, nao, nao) through the
    same AO pair map (nao*nao,), whose extra index reads a zero."""
    V = torch.cat(list(pieces))
    V = torch.nn.functional.pad(V, (0, 1, 0, 1))
    index = torch.as_tensor(index, device=V.device)
    V = V.index_select(0, index).index_select(1, index)
    return V.reshape(nao, nao, nao, nao)


def _index_map(mol, classes, n_total):
    """Flat AO pair id -> position in the stacked class rows (n_total where
    the screening dropped the pair)."""
    out = np.full(mol.nao * mol.nao, n_total, dtype=np.int64)
    off = 0
    for bc in classes:
        ij, ji, pos = _row_maps(mol, bc)
        out[ij] = off + pos
        out[ji] = off + pos
        off += bc.nsel * bc.ns1
    return out


def int2e_dense(mol, omega=None):
    """Full (nao,)^4 chemists' ERI tensor (ab|cd) on mol.device; with omega,
    of the erf(omega r)/r attenuated operator, on the shell pairs screened
    for the full operator, as in the JAX package."""
    from .. import kernels
    kets = _ket_arrays(mol)
    pieces = [kernels.int2e(la, lb, *pairs, kets, omega)
              for la, lb, *pairs in kets]
    bcs = [bc for bc in _bra_classes(mol).values() if bc.nsel]
    n = sum(p.shape[0] for p in pieces)
    return _assemble_4c(pieces, _index_map(mol, bcs, n), mol.nao)
