"""AO values (and gradients) on grid points.

Counterpart of pyscf_tpu/ops/eval_gto.py (eval_ao, _class_ao). The values
come from the CUDA kernel `eval_ao` (csrc/eval_ao.cu), which writes every
shell's columns straight to their AO positions, so the JAX package's
concatenate-then-argsort of the class blocks has no counterpart. The
plain PyTorch twin is `eval_ao_plain`: `_class_ao` per l-class, scattered
to the same columns.
"""
import torch

from .integrals.hermite import cart_components
from .integrals.int1e import sph


def _ipow(x, n):
    """x**n for an integer n >= 1 by repeated squaring, the product order
    of XLA's integer_pow (x**3 = x*(x*x), x**4 = (x*x)*(x*x))."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _class_ao(l, pts, exps, coeffs, centers, deriv):
    """AO values for all shells of one l-class.

    pts (C,3); exps/coeffs (ns,K); centers (ns,3).
    Returns (ncomp, C, ns*(2l+1)) with ncomp = 1 (values) or 4 (+d/dx,y,z).
    """
    diff = pts[:, None, :] - centers[None, :, :]          # (C, ns, 3)
    r2 = torch.sum(diff * diff, dim=-1)                   # (C, ns)
    expo = torch.exp(-exps[None, :, :] * r2[:, :, None])  # (C, ns, K)
    rad = torch.sum(coeffs[None] * expo, dim=-1)          # (C, ns)
    carts = cart_components(l)
    xyz = (diff[..., 0], diff[..., 1], diff[..., 2])

    def mono(*powers):
        m = torch.ones_like(r2)
        for q, pw in zip(xyz, powers):
            if pw:
                m = m * _ipow(q, pw)
        return m

    vals_cart = torch.stack([mono(*c) * rad for c in carts], dim=-1)
    S = sph(l, pts.device)                                # (2l+1, ncart)
    out = [torch.einsum('cnp,mp->cnm', vals_cart, S)]
    if deriv >= 1:
        drad = torch.sum(-2.0 * exps[None] * coeffs[None] * expo, dim=-1)
        for d in range(3):
            comp = []
            for c in carts:
                pw = c[d]
                dm = pw * mono(*(p - (1 if i == d else 0)
                                 for i, p in enumerate(c))) \
                    if pw else torch.zeros_like(r2)
                comp.append(dm * rad + mono(*c) * xyz[d] * drad)
            comp = torch.stack(comp, dim=-1)
            out.append(torch.einsum('cnp,mp->cnm', comp, S))
    out = torch.stack(out)                          # (ncomp, C, ns, 2l+1)
    ncomp, C, ns = out.shape[0], out.shape[1], out.shape[2]
    return out.reshape(ncomp, C, ns * (2 * l + 1))


def ao_tables(mol):
    """[(l, exps, coeffs, centers, ao_off int32)] per l-class on mol.device."""
    return [(l,) + g.tensors()
            + (torch.as_tensor(g.ao_off, dtype=torch.int32, device=g.device),)
            for l, g in sorted(mol.shell_groups.items())]


def eval_ao_plain(tables, coords, nao, deriv=0):
    """Plain PyTorch twin of the `eval_ao` kernel: (n, nao) for deriv 0,
    (4, n, nao) [value, d/dx, d/dy, d/dz] for deriv 1."""
    ncomp = 4 if deriv else 1
    out = coords.new_empty((ncomp, coords.shape[0], nao))
    for l, e, c, r, off in tables:
        cols = (off[:, None].long()
                + torch.arange(2 * l + 1, device=off.device)).reshape(-1)
        out[..., cols] = _class_ao(l, coords, e, c, r, deriv)
    return out if deriv else out[0]


def eval_ao(mol, coords, deriv=0):
    """AO values on coords (n, 3) on mol.device: (n, nao) for deriv 0,
    (4, n, nao) [value, d/dx, d/dy, d/dz] for deriv 1."""
    from . import kernels
    if deriv not in (0, 1):
        raise NotImplementedError(f'eval_ao deriv={deriv}: only 0 and 1')
    return kernels.eval_ao(ao_tables(mol), coords, mol.nao, deriv)
