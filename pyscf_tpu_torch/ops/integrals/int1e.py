"""One-electron integrals: overlap, kinetic, nuclear attraction and dipole.

Counterpart of pyscf_tpu/ops/integrals/int1e.py: ovlp_chunk, kin_chunk,
nuc_chunk and r_chunk are the plain PyTorch versions over a flat batch of
primitive pairs; class_stv folds the first three into the per-shell-pair
sph rows that the JAX package's j1e._class_stv returns, and is the plain
twin of the CUDA kernel int1e_stv (csrc/int1e_stv.cu). int1e_ovlp_cross is
the (mol x minao) overlap of the minao guess, on the same kernel in S-only
mode over every shell pair. class_r folds r_chunk the same way and is the
plain twin of the kernel int1e_r (csrc/int1e_r.cu), which int1e_r runs
over every ordered shell pair, as the JAX int1e_r (int1e.py:233) does.
"""
import math
from functools import lru_cache

import numpy as np
import torch

from .cart2sph import cart2sph
from .hermite import e1d_dense, e3d, cart_components, hermite_R


@lru_cache(maxsize=None)
def _cart_idx(la, lb):
    ca = np.array(cart_components(la), dtype=np.int64)
    cb = np.array(cart_components(lb), dtype=np.int64)
    return ca, cb


def _dense_e(la, lb, a, b, A, B):
    return [e1d_dense(la, lb, a, b, A[..., d] - B[..., d]) for d in range(3)]


def ovlp_chunk(la, lb, a, b, A, B, w):
    """Overlap for a batch of primitive pairs: (m, ncart_a, ncart_b)."""
    p = a + b
    E = _dense_e(la, lb, a, b, A, B)
    q = math.pi / p
    ww = w * q * torch.sqrt(q)
    ia, jb = _cart_idx(la, lb)
    v = (E[0][..., ia[:, None, 0], jb[None, :, 0], 0]
         * E[1][..., ia[:, None, 1], jb[None, :, 1], 0]
         * E[2][..., ia[:, None, 2], jb[None, :, 2], 0])
    return ww[:, None, None] * v


def kin_chunk(la, lb, a, b, A, B, w):
    """Kinetic energy -1/2 <a|del^2|b> for a batch of primitive pairs."""
    p = a + b
    E = _dense_e(la, lb + 2, a, b, A, B)
    sq = torch.sqrt(math.pi / p)
    ia, jb = _cart_idx(la, lb)
    S1 = [E[d][..., 0] * sq[..., None, None] for d in range(3)]
    jvals = torch.arange(lb + 3, dtype=a.dtype, device=a.device)
    T1 = []
    for d in range(3):
        s = S1[d]                        # (m, la+1, lb+3)
        t = (-2.0 * (b * b)[..., None, None] * s[..., 2:]
             + b[..., None, None] * (2 * jvals[:lb + 1] + 1) * s[..., :lb + 1])
        if lb >= 2:
            corr = 0.5 * (jvals[2:lb + 1] * (jvals[2:lb + 1] - 1)) \
                * s[..., :lb - 1]
            t = torch.cat([t[..., :2], t[..., 2:] - corr], dim=-1)
        T1.append(t)

    def gsel(M, d):
        return M[..., ia[:, None, d], jb[None, :, d]]

    v = (gsel(T1[0], 0) * gsel(S1[1], 1) * gsel(S1[2], 2)
         + gsel(S1[0], 0) * gsel(T1[1], 1) * gsel(S1[2], 2)
         + gsel(S1[0], 0) * gsel(S1[1], 1) * gsel(T1[2], 2))
    return w[:, None, None] * v


def nuc_chunk(la, lb, a, b, A, B, w, atom_coords, atom_charges):
    """Nuclear attraction -sum_C Z_C <a|1/|r-C||b> for a batch of prim pairs."""
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    E3 = e3d(la, lb, a, b, A, B)              # (m, nca, ncb, ntuv)
    PC = P[:, None, :] - atom_coords          # (m, natm, 3)
    R = hermite_R(la + lb, p[:, None].expand(PC.shape[:2]), PC)
    RZ = torch.einsum('mct,c->mt', R, atom_charges)
    return -torch.einsum('m,mpqt,mt->mpq', w * (2.0 * math.pi / p), E3, RZ)


def r_chunk(la, lb, a, b, A, B, w):
    """Dipole <a|r_d|b>, origin at the coordinate origin, for a batch of
    primitive pairs: (3, m, ncart_a, ncart_b)."""
    p = a + b
    E = _dense_e(la, lb + 1, a, b, A, B)
    sq = torch.sqrt(math.pi / p)
    ia, jb = _cart_idx(la, lb)
    S1 = [E[d][..., 0] * sq[..., None, None] for d in range(3)]

    def gsel(M, d):
        return M[..., ia[:, None, d], jb[None, :, d]]

    def gsel_jp1(M, d):
        return M[..., ia[:, None, d], jb[None, :, d] + 1]

    out = []
    for d in range(3):
        v = gsel_jp1(S1[d], d) + B[:, d, None, None] * gsel(S1[d], d)
        for dd in range(3):
            if dd != d:
                v = v * gsel(S1[dd], dd)
        out.append(w[:, None, None] * v)
    return torch.stack(out)


@lru_cache(maxsize=None)
def sph(l, device):
    """Row-major (2l+1, ncart) cart->sph matrix on `device` (contiguous: the
    kernels index it as raw memory)."""
    return torch.as_tensor(cart2sph(l), dtype=torch.float64,
                           device=device).contiguous()


def flat_prims(ea, ca, ra, eb, cb, rb):
    """(a, b, A, B, w) of every primitive pair of n shell pairs, flat
    (n*Ka*Kb,): exponents, centres and the product of the coefficients."""
    n, Ka = ea.shape
    Kb = eb.shape[1]
    m = n * Ka * Kb
    a = ea[:, :, None].expand(n, Ka, Kb).reshape(m)
    b = eb[:, None, :].expand(n, Ka, Kb).reshape(m)
    A = ra[:, None, None, :].expand(n, Ka, Kb, 3).reshape(m, 3)
    B = rb[:, None, None, :].expand(n, Ka, Kb, 3).reshape(m, 3)
    w = (ca[:, :, None] * cb[:, None, :]).reshape(m)
    return a, b, A, B, w


def class_stv(la, lb, ea, ca, ra, eb, cb, rb, atom_coords=None,
              atom_charges=None, with_tv=True, sb=None):
    """Sph-folded rows of one shell-pair class, plain PyTorch.

    ea/ca (n, Ka), eb/cb (n, Kb), ra/rb (n, 3): the n shell pairs. Returns
    (n, da*db, 3) rows of [S, T, V], or (n, da*db) of S alone when
    with_tv is False. sb, a (2lb+1, ncart(lb)) matrix, takes the place of
    the ket's cart->sph transform (the GTH projectors' monomial
    combinations, pbc/df/fft.py)."""
    n, Ka = ea.shape
    Kb = eb.shape[1]
    a, b, A, B, w = flat_prims(ea, ca, ra, eb, cb, rb)
    parts = [ovlp_chunk(la, lb, a, b, A, B, w)]
    if with_tv:
        parts.append(kin_chunk(la, lb, a, b, A, B, w))
        parts.append(nuc_chunk(la, lb, a, b, A, B, w, atom_coords,
                               atom_charges))
    x = torch.stack(parts, dim=-1)
    x = x.reshape((n, Ka * Kb) + x.shape[1:]).sum(dim=1)
    Sa = sph(la, ea.device)
    Sb = sph(lb, ea.device) if sb is None else sb
    x = torch.einsum('mpqx,ap,bq->mabx', x, Sa, Sb)
    x = x.reshape(n, Sa.shape[0] * Sb.shape[0], len(parts))
    return x if with_tv else x[..., 0]


def class_r(la, lb, ea, ca, ra, eb, cb, rb):
    """Sph-folded dipole rows of one shell-pair class, plain PyTorch: (n,
    (2la+1)(2lb+1), 3) rows of [x, y, z]; the plain twin of the CUDA kernel
    int1e_r (csrc/int1e_r.cu). Arguments as class_stv's."""
    n, Ka = ea.shape
    Kb = eb.shape[1]
    x = r_chunk(la, lb, *flat_prims(ea, ca, ra, eb, cb, rb))
    x = x.reshape((3, n, Ka * Kb) + x.shape[2:]).sum(dim=2)
    Sa, Sb = sph(la, ea.device), sph(lb, ea.device)
    x = torch.einsum('xmpq,ap,bq->mabx', x, Sa, Sb)
    return x.reshape(n, Sa.shape[0] * Sb.shape[0], 3)


def _place(out, la, lb, ga, gb, blk):
    """Write the rows blk (nsa*nsb, (2la+1)(2lb+1), ...) of every (ga, gb)
    shell pair, ga-shell-major, into out[..., mol1 AOs, mol2 AOs]."""
    dev = out.device
    ia = (ga.ao_off[:, None] + np.arange(2 * la + 1)).ravel()
    jb = (gb.ao_off[:, None] + np.arange(2 * lb + 1)).ravel()
    blk = blk.reshape((ga.nshl, gb.nshl, 2 * la + 1, 2 * lb + 1, -1))
    blk = blk.permute(4, 0, 2, 1, 3).reshape(-1, ia.size, jb.size)
    out[..., torch.as_tensor(ia, device=dev)[:, None],
        torch.as_tensor(jb, device=dev)[None, :]] = blk.squeeze(0)


def int1e_r(mol):
    """Dipole integrals <mu|r|nu>, origin at the coordinate origin: (3, nao,
    nao) on mol.device, one `int1e_r` launch per ordered class pair over
    every shell pair (unscreened, as the JAX package's _assemble)."""
    from .. import kernels
    out = torch.zeros((3, mol.nao, mol.nao), dtype=torch.float64,
                      device=mol.device)
    for la, lb, ga, gb, pairs in cross_pairs(mol, mol):
        _place(out, la, lb, ga, gb, kernels.int1e_r(la, lb, *pairs))
    return out


def cross_pairs(mol1, mol2):
    """[(la, lb, ga, gb, pair tables)] of every (mol1, mol2) shell pair,
    one entry per class, pairs ordered mol1-shell-major."""
    out = []
    for la, ga in mol1.shell_groups.items():
        for lb, gb in mol2.shell_groups.items():
            sel_a = np.repeat(np.arange(ga.nshl), gb.nshl)
            sel_b = np.tile(np.arange(gb.nshl), ga.nshl)
            out.append((la, lb, ga, gb, pair_tables(ga, gb, sel_a, sel_b)))
    return out


def int1e_ovlp_cross(mol1, mol2):
    """Overlap between the AO bases of two molecules: (nao1, nao2)."""
    from .. import kernels
    out = torch.zeros((mol1.nao, mol2.nao), dtype=torch.float64,
                      device=mol1.device)
    for la, lb, ga, gb, pairs in cross_pairs(mol1, mol2):
        _place(out, la, lb, ga, gb,
               kernels.int1e_stv(la, lb, *pairs, with_tv=False))
    return out


def pair_tables(ga, gb, sel_a, sel_b):
    """(ea, ca, ra, eb, cb, rb) tensors of the shell pairs (sel_a, sel_b)."""
    arrays = (ga.exps[sel_a], ga.coeffs[sel_a], ga.coords[sel_a],
              gb.exps[sel_b], gb.coeffs[sel_b], gb.coords[sel_b])
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                                 device=ga.device) for x in arrays)
