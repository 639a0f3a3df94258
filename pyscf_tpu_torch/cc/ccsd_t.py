"""CCSD(T) perturbative triples, closed shell.

Counterpart of pyscf_tpu/cc/ccsd_t.py (kernel, _et_all, _et_batch, _r3):
Raghavachari et al., CPL 157, 479 (1989), with the restricted sum over
virtual triples a >= b >= c weighted by their multiplicity (JCP 94, 442
(1991)). The sum over the triples is the hand-written kernel `ccsd_t`
(csrc/ccsd_t.cu) on the card; `et_plain` is its plain twin, the JAX
package's batched per-triple tensor algebra, over the list of triples
without padding blocks. The sharded sum over a device mesh (`_et_sharded`)
is not ported (ROADMAP, multi-GPU).
"""
import numpy as np
import torch

TRIPLE_BLK = 256    # triples per batch of the plain twin

_P = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
_TRANS = ('ijk', 'ikj', 'jik', 'jki', 'kij', 'kji')


def _r3(w):
    """ccsd_t.py:_r3 on a batch (B, o, o, o)."""
    return (4.0 * w + w.permute(0, 2, 3, 1) + w.permute(0, 3, 1, 2)
            - 2.0 * w.permute(0, 3, 2, 1) - 2.0 * w.permute(0, 1, 3, 2)
            - 2.0 * w.permute(0, 2, 1, 3))


def triples(nvir):
    """(abc (n, 3) int32, mult (n,) float64) numpy: every a >= b >= c with
    its multiplicity, 6 for a = b = c, 2 for one pair equal, else 1."""
    a, b, c = np.array([(a, b, c) for a in range(nvir) for b in range(a + 1)
                        for c in range(b + 1)], dtype=np.int32).reshape(-1, 3).T
    mult = np.where(a == c, 6.0, np.where((a == b) | (b == c), 2.0, 1.0))
    return np.stack([a, b, c], axis=1), mult


def et_plain(abc, mult, vvov, vooo, ovov, t2, t1, e_occ, e_vir):
    """The plain twin of kernel `ccsd_t`: sum over the triples abc (n, 3)
    of their (T) contributions (0-d; the energy is twice it).

    vvov (v, v, o, v), vooo (v, o, o, o), ovov (o, v, o, v), t2 (o, o, v,
    v), t1 (o, v), e_occ (o,), e_vir (v,); the JAX package's _et_batch
    (ccsd_t.py:24) in batches of TRIPLE_BLK triples."""
    vvoo = ovov.permute(1, 3, 0, 2)
    t2T = t2.permute(2, 3, 0, 1)
    t1T = t1.T
    eijk = (e_occ[:, None, None] + e_occ[None, :, None]
            + e_occ[None, None, :])
    abc = abc.long()
    et = torch.zeros((), dtype=t2.dtype, device=t2.device)
    for i0 in range(0, abc.shape[0], TRIPLE_BLK):
        blk = abc[i0:i0 + TRIPLE_BLK]
        m = mult[i0:i0 + TRIPLE_BLK]
        et = et + _et_batch(blk, m, vvov, vooo, vvoo, t2T, t1T, eijk, e_vir)
    return et


def _et_batch(abc, mult, vvov, vooo, vvoo, t2T, t1T, eijk, e_vir):
    """ccsd_t.py:_et_batch on a batch of B triples, the vmap written out."""
    def w(x, y, z):
        return (torch.einsum('bif,bfkj->bijk', vvov[x, y], t2T[z])
                - torch.einsum('bijm,bmk->bijk', vooo[x], t2T[y, z]))

    def v(x, y, z):
        return vvoo[x, y][:, :, :, None] * t1T[z][:, None, None, :]

    cols = (abc[:, 0], abc[:, 1], abc[:, 2])
    ws = [w(*[cols[k] for k in p]) for p in _P]
    vs = [v(*[cols[k] for k in p]) for p in _P]
    d3 = ((eijk[None] - e_vir[cols[0], None, None, None]
           - e_vir[cols[1], None, None, None]
           - e_vir[cols[2], None, None, None])
          * torch.clamp(mult, min=0.5)[:, None, None, None])
    zs = [_r3(wi + 0.5 * vi) / d3 for wi, vi in zip(ws, vs)]
    wsid = {p: i for i, p in enumerate(_P)}
    perms = dict(zip(_TRANS, _P))
    et = torch.zeros(abc.shape[0], dtype=d3.dtype, device=d3.device)
    for qi, q in enumerate(_P):
        for tr in _TRANS:
            perm = perms[tr]
            widx = wsid[tuple(q[p] for p in perm)]
            et = et + torch.einsum(f'b{tr},bijk->b', ws[widx], zs[qi])
    return torch.sum(et * (mult > 0))


def kernel_args(eris, t1, t2):
    """The arguments of kernels.ccsd_t (and et_plain) over every a >= b >=
    c, from the CCSD integrals eris (ovvv, ooov, ovov, mo_energy) and the
    amplitudes t1, t2, on t2's device."""
    if eris.ovvv is None:
        raise NotImplementedError(
            '(T) on the ovvv-free DF path (nocc nvir^3 > OVVV_MAX_ELEMS): the '
            'triples read the (ov|vv) block, which that path never builds '
            '(the JAX package reads eris.ovvv there and fails, '
            'pyscf_tpu/cc/ccsd_t.py:138)')
    nocc, nvir = t1.shape
    mo_e = eris.mo_energy
    vvov = eris.ovvv.permute(1, 3, 0, 2).contiguous()
    # (ov|oo) = (oo|ov) transposed, then vooo[a,i,j,m] = (ia|jm)
    vooo = eris.ooov.permute(3, 2, 0, 1).contiguous()
    abc, mult = triples(nvir)
    dev = t2.device
    return (torch.as_tensor(abc, device=dev),
            torch.as_tensor(mult, device=dev), vvov, vooo,
            eris.ovov.contiguous(), t2.contiguous(), t1.contiguous(),
            mo_e[:nocc].contiguous(), mo_e[nocc:].contiguous())


def kernel(mycc, eris, t1=None, t2=None):
    """E_(T) of the converged closed-shell CCSD mycc (a float)."""
    from ..ops import kernels
    t1 = t1 if t1 is not None else mycc.t1
    t2 = t2 if t2 is not None else mycc.t2
    return 2.0 * float(kernels.ccsd_t(*kernel_args(eris, t1, t2)))
