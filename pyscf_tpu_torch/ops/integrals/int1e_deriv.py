"""Derivative one-electron integrals for analytic nuclear gradients.

Counterpart of pyscf_tpu/ops/integrals/int1e_deriv.py: ipovlp_chunk,
ipkin_chunk, ipnuc_chunk and iprinv_chunk are the plain PyTorch versions
over a flat batch of primitive pairs. The first three differentiate the
*bra* centre A through the power-shift rule
  d/dA_x [x_A^i e^{-a x_A^2}] = 2a x_A^{i+1} - i x_A^{i-1};
iprinv differentiates the operator centre C through dR_tuv/dC_x =
-R_{t+1,u,v}. class_ip and class_iprinv fold the primitives and apply
cart->sph per shell pair; they are the plain twins of the CUDA kernels
int1e_ip (csrc/int1e_ip.cu) and int1e_iprinv (csrc/int1e_iprinv.cu).

<d a|b> is not symmetric in a and b, so the callers run every ordered class
(la, lb) over every shell pair, unscreened, as the JAX package does.
"""
import math

import numpy as np
import torch

from .hermite import (cart_components, e1d_dense, e3d, hermite_R,
                      tuv_components, tuv_index)
from .int1e import (_cart_idx, cross_pairs, flat_prims, kin_chunk,
                    nuc_chunk, ovlp_chunk, sph)


def _s1_tables(la_e, lb_e, a, b, A, B):
    sq = torch.sqrt(math.pi / (a + b))
    E = [e1d_dense(la_e, lb_e, a, b, A[..., d] - B[..., d]) for d in range(3)]
    return [E[d][..., 0] * sq[..., None, None] for d in range(3)]


def _shifted(la, lb, a):
    """sel(M, d, di) and dshift(M, d) on 1D tables M (m, la+2, >= lb+1):
    the entries of the cartesian pairs of (la, lb) in direction d with the
    bra power moved by di, and the power-shift rule applied in d."""
    ia, jb = _cart_idx(la, lb)

    def sel(M, d, di=0):
        return M[..., np.maximum(ia[:, None, d] + di, 0), jb[None, :, d]]

    def dshift(M, d):
        pw = torch.as_tensor(ia[:, None, d], dtype=a.dtype, device=a.device)
        return 2.0 * a[:, None, None] * sel(M, d, 1) - pw * sel(M, d, -1)

    return sel, dshift


def ipovlp_chunk(la, lb, a, b, A, B, w):
    """(d/dA <a| ) |b> overlap: (3, m, ncart_a, ncart_b)."""
    S1 = _s1_tables(la + 1, lb, a, b, A, B)
    sel, dshift = _shifted(la, lb, a)
    out = []
    for d in range(3):
        v = dshift(S1[d], d)
        for dd in range(3):
            if dd != d:
                v = v * sel(S1[dd], dd)
        out.append(w[:, None, None] * v)
    return torch.stack(out)


def ipkin_chunk(la, lb, a, b, A, B, w):
    """d/dA of the kinetic-energy block: (3, m, ncart_a, ncart_b)."""
    S1 = _s1_tables(la + 1, lb + 2, a, b, A, B)
    jvals = torch.arange(lb + 3, dtype=a.dtype, device=a.device)
    T1 = []
    for d in range(3):
        s = S1[d]
        t = (-2.0 * (b * b)[..., None, None] * s[..., 2:]
             + b[..., None, None] * (2 * jvals[:lb + 1] + 1) * s[..., :lb + 1])
        if lb >= 2:
            corr = 0.5 * (jvals[2:lb + 1] * (jvals[2:lb + 1] - 1)) \
                * s[..., :lb - 1]
            t = torch.cat([t[..., :2], t[..., 2:] - corr], dim=-1)
        T1.append(t)
    sel, dshift = _shifted(la, lb, a)
    out = []
    for d in range(3):
        total = None
        for dt in range(3):     # which dim carries the T factor
            v = None
            for dd in range(3):
                fac = T1[dd] if dd == dt else S1[dd]
                cur = dshift(fac, dd) if dd == d else sel(fac, dd)
                v = cur if v is None else v * cur
            total = v if total is None else total + v
        out.append(w[:, None, None] * total)
    return torch.stack(out)


def _raised_lowered(la, a, Vp, Vm):
    """Power-shift rule on cartesian blocks: Vp (m, ncart(la+1), ...) of
    the raised shell and Vm (m, ncart(la-1), ...) of the lowered one (None
    for la = 0) -> (3, m, ncart(la), ...)."""
    idxp = {c: i for i, c in enumerate(cart_components(la + 1))}
    idxm = {c: i for i, c in enumerate(cart_components(la - 1))} if la else {}
    a2 = 2.0 * a.reshape((-1,) + (1,) * (Vp.dim() - 2))
    out = []
    for d in range(3):
        cols = []
        for c in cart_components(la):
            up = list(c)
            up[d] += 1
            v = a2 * Vp[:, idxp[tuple(up)]]
            if c[d] >= 1:
                dn = list(c)
                dn[d] -= 1
                v = v - c[d] * Vm[:, idxm[tuple(dn)]]
            cols.append(v)
        out.append(torch.stack(cols, dim=1))
    return torch.stack(out)


def ipnuc_chunk(la, lb, a, b, A, B, w, atom_coords, atom_charges):
    """d/dA of the nuclear-attraction block: (3, m, ncart_a, ncart_b)."""
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    PC = P[:, None, :] - atom_coords
    R = hermite_R(la + 1 + lb, p[:, None].expand(PC.shape[:2]), PC)
    RZ = torch.einsum('mct,c->mt', R, atom_charges)
    pref = w * (2.0 * math.pi / p)
    Vp = -torch.einsum('m,mpqt,mt->mpq', pref,
                       e3d(la + 1, lb, a, b, A, B), RZ)
    Vm = None
    if la >= 1:
        E3m = e3d(la - 1, lb, a, b, A, B)
        Vm = -torch.einsum('m,mpqt,mt->mpq', pref, E3m,
                           RZ[:, :E3m.shape[-1]])
    return _raised_lowered(la, a, Vp, Vm)


def iprinv_chunk(la, lb, a, b, A, B, w, center):
    """d/dC of <a| 1/|r-C| |b> for one operator centre C:
    (3, m, ncart_a, ncart_b)."""
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    L = la + lb
    E3 = e3d(la, lb, a, b, A, B)
    R = hermite_R(L + 1, p, P - center)        # includes the t+1 entries
    idx_hi = tuv_index(L + 1)
    pref = w * (2.0 * math.pi / p)
    out = []
    for d in range(3):
        sel = [idx_hi[tuple(c[i] + (1 if i == d else 0) for i in range(3))]
               for c in tuv_components(L)]
        out.append(torch.einsum('m,mpqt,mt->mpq', pref, E3, R[..., sel]))
    return torch.stack(out)


def _second_shift(la, a, blocks):
    """The power-shift rule applied twice on cartesian blocks: blocks {l:
    (m, ncart(l), ...)} of the bra shells la + 2, la and la - 2 (the last
    absent for la < 2) -> (3, 3, m, ncart(la), ...), entry [x, y] the
    blocks of d2/dA_x dA_y."""
    idx = {l: {c: i for i, c in enumerate(cart_components(l))}
           for l in blocks}
    first = blocks[la + 2]
    a2 = 2.0 * a.reshape((-1,) + (1,) * (first.dim() - 2))
    out = [[None] * 3 for _ in range(3)]
    for x in range(3):
        for y in range(3):
            cols = []
            for c in cart_components(la):
                v = 0.0
                for sy in (1, -1):
                    for sx in (1, -1):
                        k = list(c)
                        if sy < 0 and k[y] == 0:
                            continue
                        f = a2 if sy > 0 else -k[y]
                        k[y] += sy
                        if sx < 0 and k[x] == 0:
                            continue
                        f = f * (a2 if sx > 0 else -k[x])
                        k[x] += sx
                        v = v + f * blocks[sum(k)][:, idx[sum(k)][tuple(k)]]
                cols.append(v)
            out[x][y] = torch.stack(cols, dim=1)
    return torch.stack([torch.stack(r) for r in out])


def _shifted_rinv(la, lb, a, b, A, B, w, center, shifts):
    """sum E_tuv R_{tuv + s}(P - C) (2 pi / p) w for every shift s of
    shifts: (len(shifts), m, ncart_a, ncart_b)."""
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    L = la + lb
    E3 = e3d(la, lb, a, b, A, B)
    top = max(sum(s) for s in shifts)
    R = hermite_R(L + top, p, P - center)
    idx_hi = tuv_index(L + top)
    pref = w * (2.0 * math.pi / p)
    out = []
    for s in shifts:
        sel = [idx_hi[tuple(c[i] + s[i] for i in range(3))]
               for c in tuv_components(L)]
        out.append(torch.einsum('m,mpqt,mt->mpq', pref, E3, R[..., sel]))
    return torch.stack(out)


def ipip_chunk(la, lb, a, b, A, B, w, atom_coords, atom_charges, dm, wm):
    """Second derivatives of one class's primitive blocks contracted with
    the cartesian density blocks dm and wm (m, ncart_a, ncart_b): (m,
    natm + 1, 27). Slot c < natm: AA, AC and CC of dm . V_c, V_c = -Z_c
    <a|1/|r-C_c||b>; slot natm: AA of dm . T - wm . S (as int1e_ipip)."""
    m = a.shape[0]
    natm = atom_coords.shape[0]
    out = a.new_zeros((m, natm + 1, 27))
    shells = [l for l in (la + 2, la, la - 2) if l >= 0]

    def aa(fn):
        return _second_shift(la, a, {l: fn(l) for l in shells})

    st = (torch.einsum('xympq,mpq->mxy', aa(
        lambda l: kin_chunk(l, lb, a, b, A, B, w)), dm)
        - torch.einsum('xympq,mpq->mxy', aa(
            lambda l: ovlp_chunk(l, lb, a, b, A, B, w)), wm))
    out[:, natm, :9] = st.reshape(m, 9)
    eye = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    for c in range(natm):
        z = atom_charges[c]
        cen, q = atom_coords[c:c + 1], atom_charges[c:c + 1]
        vaa = aa(lambda l: nuc_chunk(l, lb, a, b, A, B, w, cen, q))
        # d/dC_y V_c = -Z_c d/dC_y <1/r_C> = Z_c (2 pi/p) sum E R_{tuv+e_y}
        up = z * _shifted_rinv(la + 1, lb, a, b, A, B, w, cen[0], eye)
        dn = None
        if la:
            dn = z * _shifted_rinv(la - 1, lb, a, b, A, B, w, cen[0],
                                   eye).permute(1, 2, 0, 3)
        # -> [x (bra), m, ncart_a, y (centre), ncart_b] -> [x, y, m, ...]
        vac = _raised_lowered(la, a, up.permute(1, 2, 0, 3),
                              dn).permute(0, 3, 1, 2, 4)
        # d2/dC_x dC_y V_c = -Z_c (2 pi/p) sum E R_{tuv + e_x + e_y}
        vcc = -z * _shifted_rinv(la, lb, a, b, A, B, w, cen[0],
                                 [tuple(eye[x][i] + eye[y][i]
                                        for i in range(3))
                                  for x in range(3) for y in range(3)])
        vcc = vcc.reshape((3, 3) + vcc.shape[1:])
        for k, blk in enumerate((vaa, vac, vcc)):
            out[:, c, 9 * k:9 * k + 9] = torch.einsum(
                'xympq,mpq->mxy', blk, dm).reshape(m, 9)
    return out


def class_ipip(la, lb, ea, ca, ra, eb, cb, rb, atom_coords, atom_charges,
               D, W):
    """Plain PyTorch twin of the `int1e_ipip` kernel: (n, natm + 1, 27) of
    n ordered shell pairs with the sph density blocks D and W (n,
    (2la+1)(2lb+1)). The blocks go to the cartesian basis and to every
    primitive pair of their shell pair."""
    n, Ka = ea.shape
    KK = Ka * eb.shape[1]
    dev = ea.device
    da, db = 2 * la + 1, 2 * lb + 1

    def cart(M):
        M = torch.einsum('nab,ap,bq->npq', M.reshape(n, da, db),
                         sph(la, dev), sph(lb, dev))
        return M.repeat_interleave(KK, dim=0)

    prims = flat_prims(ea, ca, ra, eb, cb, rb)
    x = ipip_chunk(la, lb, *prims, atom_coords, atom_charges, cart(D),
                   cart(W))
    return x.reshape(n, KK, *x.shape[1:]).sum(dim=1)


def _fold(x, n, la, lb, dev):
    """(..., n*KK, nca, ncb) cartesian primitive blocks -> (..., n, da*db)
    contracted sph rows."""
    x = x.reshape(x.shape[:-3] + (n, -1) + x.shape[-2:]).sum(dim=-3)
    x = torch.einsum('...pq,ap,bq->...ab', x, sph(la, dev), sph(lb, dev))
    return x.reshape(x.shape[:-2] + (-1,))


def class_ip(la, lb, ea, ca, ra, eb, cb, rb, atom_coords, atom_charges):
    """Plain PyTorch twin of the `int1e_ip` kernel: the sph rows of
    [ipovlp, ipkin, ipnuc] x [x, y, z] of n ordered shell pairs,
    (n, da*db, 9) with the operator major."""
    prims = flat_prims(ea, ca, ra, eb, cb, rb)
    x = torch.cat([ipovlp_chunk(la, lb, *prims), ipkin_chunk(la, lb, *prims),
                   ipnuc_chunk(la, lb, *prims, atom_coords, atom_charges)])
    x = _fold(x, ea.shape[0], la, lb, ea.device)
    return x.permute(1, 2, 0).contiguous()


def class_iprinv(la, lb, ea, ca, ra, eb, cb, rb, centers):
    """Plain PyTorch twin of the `int1e_iprinv` kernel: the sph rows of
    d/dC <a|1/|r-C||b> of n ordered shell pairs for each centre of
    centers (nc, 3): (nc, 3, n, da*db)."""
    prims = flat_prims(ea, ca, ra, eb, cb, rb)
    x = torch.stack([iprinv_chunk(la, lb, *prims, c) for c in centers])
    return _fold(x, ea.shape[0], la, lb, ea.device)


def _assemble(mol, blocks):
    """(ncomp, nao, nao) from {class: (ncomp, nsa*nsb, da*db)} of
    cross_pairs(mol, mol), pairs bra-shell-major."""
    dev = mol.device
    first = next(iter(blocks.values()))
    out = torch.zeros((first.shape[0], mol.nao, mol.nao), dtype=torch.float64,
                      device=dev)
    for (la, lb), blk in blocks.items():
        ga, gb = mol.shell_groups[la], mol.shell_groups[lb]
        da, db = 2 * la + 1, 2 * lb + 1
        ia = (ga.ao_off[:, None] + np.arange(da)).ravel()
        jb = (gb.ao_off[:, None] + np.arange(db)).ravel()
        blk = blk.reshape(-1, ga.nshl, gb.nshl, da, db).permute(0, 1, 3, 2, 4)
        out[:, torch.as_tensor(ia, device=dev)[:, None],
            torch.as_tensor(jb, device=dev)[None, :]] = \
            blk.reshape(-1, ia.size, jb.size)
    return out


def ip_parts(mol):
    """[ipovlp, ipkin, ipnuc] as one (3, 3, nao, nao) tensor on mol.device
    (operator, direction), cached: one `int1e_ip` launch per ordered class."""
    from .. import kernels
    cache = mol._j3c_cache
    if 'ip1e' not in cache:
        dev = mol.device
        zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
        zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
        blocks = {(la, lb): kernels.int1e_ip(la, lb, *pairs, zr, zq)
                  .permute(2, 0, 1)
                  for la, lb, _, _, pairs in cross_pairs(mol, mol)}
        nao = mol.nao
        cache['ip1e'] = _assemble(mol, blocks).reshape(3, 3, nao, nao)
    return cache['ip1e']


def int1e_ipovlp(mol):
    """<d/dA a|b>: (3, nao, nao)."""
    return ip_parts(mol)[0]


def int1e_ipkin(mol):
    """<d/dA a|-del^2/2|b>: (3, nao, nao)."""
    return ip_parts(mol)[1]


def int1e_ipnuc(mol):
    """<d/dA a|V_nuc|b>: (3, nao, nao)."""
    return ip_parts(mol)[2]


def int1e_iprinv(mol, center):
    """d/dC <a|1/|r-C||b>: (3, nao, nao) for one centre (3,), or
    (nc, 3, nao, nao) for centres (nc, 3) in one `int1e_iprinv` launch per
    ordered class."""
    from .. import kernels
    dev = mol.device
    c = torch.as_tensor(np.asarray(center, dtype=np.float64), device=dev)
    centers = c.reshape(-1, 3).contiguous()
    nc, nao = centers.shape[0], mol.nao
    blocks = {(la, lb): kernels.int1e_iprinv(la, lb, *pairs, centers)
              .reshape((nc * 3,) + (pairs[0].shape[0], -1))
              for la, lb, _, _, pairs in cross_pairs(mol, mol)}
    out = _assemble(mol, blocks).reshape(nc, 3, nao, nao)
    return out[0] if c.dim() == 1 else out
