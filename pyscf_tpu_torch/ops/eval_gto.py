"""AO values and their first, second and third derivatives on grid
points.

Counterpart of pyscf_tpu/ops/eval_gto.py (eval_ao, _class_ao). The values
come from the CUDA kernel `eval_ao` (csrc/eval_ao.cu), which writes every
shell's columns straight to their AO positions, so the JAX package's
concatenate-then-argsort of the class blocks has no counterpart. The
plain PyTorch twin is `eval_ao_plain`: `_class_ao` per l-class, scattered
to the same columns.

deriv 2 adds the six second derivatives xx, xy, xz, yy, yz, zz and deriv 3
the ten third derivatives xxx, xxy, xxz, xyy, xyz, xzz, yyy, yyz, yzz, zzz
(PySCF's order). The JAX package has neither: the XC gradient there is
jax.grad through eval_ao(..., deriv=1, atom_coords=X) (pyscf_tpu/grad/
autodiff.py:207-210), whose derivative with respect to the centre of AO mu
is -d_i d_j phi_mu, and the XC Hessian takes its second derivative there
(pyscf_tpu/hessian/rhf.py:327), d_i d_j d_k phi_mu.
"""
import torch

from .integrals.hermite import cart_components
from .integrals.int1e import sph

# (i, j) of the second derivatives in the order of components 4..9
SECOND_DERIVS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
# (i, j, k) of the third derivatives in the order of components 10..19
THIRD_DERIVS = ((0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 1), (0, 1, 2),
                (0, 2, 2), (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2))
NCOMP = {0: 1, 1: 4, 2: 10, 3: 20}


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
    Returns (ncomp, C, ns*(2l+1)) with ncomp = 1 (values), 4 (+d/dx,y,z),
    10 (+ d2/dxx, dxy, dxz, dyy, dyz, dzz) or 20 (+ the ten third
    derivatives of THIRD_DERIVS).
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
    if deriv >= 2:
        d2rad = torch.sum(4.0 * exps[None] * exps[None] * coeffs[None] * expo,
                          dim=-1)
        zero = torch.zeros_like(r2)

        def lowered(c, *dirs):
            """c[d] * (c[d] - 1 if twice) ... * the monomial with the powers
            of dirs taken down by one each, 0 where a power runs out."""
            pw = list(c)
            fac = 1
            for d in dirs:
                if pw[d] == 0:
                    return zero
                fac *= pw[d]
                pw[d] -= 1
            return fac * mono(*pw)

        for i, j in SECOND_DERIVS:
            comp = []
            for c in carts:
                v = (lowered(c, i, j) * rad
                     + (lowered(c, i) * xyz[j] + lowered(c, j) * xyz[i])
                     * drad)
                dd = xyz[i] * xyz[j] * d2rad
                if i == j:
                    dd = dd + drad
                comp.append(v + mono(*c) * dd)
            comp = torch.stack(comp, dim=-1)
            out.append(torch.einsum('cnp,mp->cnm', comp, S))
    if deriv >= 3:
        d3rad = torch.sum(-8.0 * exps[None] ** 3 * coeffs[None] * expo,
                          dim=-1)

        def rad1(i):
            return xyz[i] * drad

        def rad2(i, j):
            dd = xyz[i] * xyz[j] * d2rad
            return dd + drad if i == j else dd

        def rad3(i, j, k):
            t = xyz[i] * xyz[j] * xyz[k] * d3rad
            for a, b, c_ in ((i, j, k), (i, k, j), (j, k, i)):
                if a == b:
                    t = t + xyz[c_] * d2rad
            return t

        for i, j, k in THIRD_DERIVS:
            comp = []
            for c in carts:
                # d_ijk (m R) = m_ijk R + sum over the three splits (ab, c)
                # of (m_ab R_c + m_c R_ab) + m R_ijk
                v = lowered(c, i, j, k) * rad + mono(*c) * rad3(i, j, k)
                for a, b, c_ in ((i, j, k), (i, k, j), (j, k, i)):
                    v = v + lowered(c, a, b) * rad1(c_) \
                        + lowered(c, c_) * rad2(a, b)
                comp.append(v)
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
    (4, n, nao) [value, d/dx, d/dy, d/dz] for deriv 1, (10, n, nao) with
    [xx, xy, xz, yy, yz, zz] after those for deriv 2, (20, n, nao) with the
    third derivatives of THIRD_DERIVS after those for deriv 3."""
    out = coords.new_empty((NCOMP[deriv], coords.shape[0], nao))
    for l, e, c, r, off in tables:
        cols = (off[:, None].long()
                + torch.arange(2 * l + 1, device=off.device)).reshape(-1)
        out[..., cols] = _class_ao(l, coords, e, c, r, deriv)
    return out if deriv else out[0]


def _image_values(l, coords, e, c, centers, deriv, lcut):
    """The real cartesian values (ncomp, P, n, ncart) of P (shell, image)
    pairs, exponents and coefficients e, c (P, K) and centres (P, 3), on
    coords (n, 3), with the eval_ao_pbc kernel's primitive cut: a primitive
    whose exponent a makes a r^2 > lcut adds nothing (the argument of exp
    is kept above -lcut, where the CPU's exp takes its fast path)."""
    carts = cart_components(l)
    xyz = [coords[None, :, q] - centers[:, q, None] for q in range(3)]
    r2 = xyz[0] * xyz[0] + xyz[1] * xyz[1] + xyz[2] * xyz[2]   # (P, n)
    rad = torch.zeros_like(r2)
    drad = torch.zeros_like(r2) if deriv else None
    for k in range(e.shape[1]):
        ar2 = e[:, k, None] * r2
        ex = torch.where(ar2 <= lcut, c[:, k, None] * torch.exp(
            -torch.clamp(ar2, max=lcut)), 0.0)
        rad += ex
        if deriv:
            drad += -2.0 * e[:, k, None] * ex
    pw = [[None, q] + [None] * (l - 1) for q in xyz]
    for q in range(3):
        for k in range(2, l + 1):
            pw[q][k] = _ipow(xyz[q], k)

    def mono(powers):
        m = None
        for q, k in enumerate(powers):
            if k:
                m = pw[q][k] if m is None else m * pw[q][k]
        return torch.ones_like(rad) if m is None else m

    vals = coords.new_empty((NCOMP[deriv],) + rad.shape + (len(carts),))
    for jc, cart in enumerate(carts):
        m = mono(cart)
        vals[0, ..., jc] = m * rad
        for q in range(3 if deriv else 0):
            v = m * xyz[q] * drad
            if cart[q]:
                low = list(cart)
                low[q] -= 1
                v = v + cart[q] * mono(low) * rad
            vals[1 + q, ..., jc] = v
    return vals


def _pairs_in_range(e, c, r, Ls, coords, lcut):
    """(shell, image) index pairs of one class whose most diffuse primitive
    comes within range (a_min d^2 <= lcut) of the points' bounding
    sphere, shell-major."""
    mid = 0.5 * (coords.max(0).values + coords.min(0).values)
    radius = torch.linalg.norm(coords - mid, dim=1).max()
    amin = torch.where(c != 0, e, torch.full_like(e, float('inf'))).min(
        1).values
    gap = torch.clamp(torch.linalg.norm(
        r[:, None, :] + Ls[None] - mid, dim=-1) - radius, min=0.0)
    return torch.nonzero(amin[:, None] * gap * gap <= lcut, as_tuple=True)


def _columns(l, off):
    return (off[:, None].long()
            + torch.arange(2 * l + 1, device=off.device)).reshape(-1)


def eval_ao_pbc_plain(tables, coords, Ls, nao, deriv, lcut, chunk=1 << 21):
    """Plain PyTorch twin of the `eval_ao_pbc` kernel: the AO values of
    eval_ao_plain summed over the lattice translations Ls (nimg, 3),
    sum_L phi(r - L); (n, nao) for deriv 0, (4, n, nao) for deriv 1. As
    in the kernel, a primitive whose exponent a makes a r^2 > lcut adds
    nothing, and the cartesian values are summed over the images before
    cart->sph. Only the (shell, image) pairs that come within range of the
    points' bounding sphere are evaluated, about `chunk` (pair, point)
    entries at a time."""
    n = coords.shape[0]
    ncomp = NCOMP[deriv]
    out = coords.new_zeros((ncomp, n, nao))
    if n == 0:
        return out if deriv else out[0]
    for l, e, c, r, off in tables:
        s_idx, l_idx = _pairs_in_range(e, c, r, Ls, coords, lcut)
        centers = r[s_idx] + Ls[l_idx]
        acc = coords.new_zeros((ncomp, e.shape[0], n, len(cart_components(l))))
        step = max(1, chunk // n)
        for i in range(0, s_idx.shape[0], step):
            si = s_idx[i:i + step]
            acc.index_add_(1, si, _image_values(
                l, coords, e[si], c[si], centers[i:i + step], deriv, lcut))
        out[..., _columns(l, off)] = torch.einsum(
            'xsnp,mp->xnsm', acc, sph(l, coords.device)).reshape(ncomp, n, -1)
    return out if deriv else out[0]


def eval_ao_kpts_plain(tables, coords, Ls, phases, nao, deriv, lcut,
                       chunk=1 << 22):
    """Plain PyTorch twin of the `eval_ao_kpts` kernel: the Bloch sums
    sum_L e^{ik.L} phi(r - L) over the lattice translations Ls (nimg, 3)
    with phases (nk, nimg) complex128 e^{ik.L}; (nk, n, nao) for deriv 0,
    (nk, 4, n, nao) for deriv 1, complex128. The per-image real cartesian
    values of the (shell, image) pairs in range of a chunk of points
    (eval_ao_pbc_plain's, with its primitive cut) are summed against the
    phases by two real GEMMs per chunk, then cart->sph; about `chunk`
    entries of values or sums at a time."""
    n = coords.shape[0]
    nk = phases.shape[0]
    ncomp = NCOMP[deriv]
    out = torch.zeros((nk, ncomp, n, nao), dtype=torch.complex128,
                      device=coords.device)
    for l, e, c, r, off in tables:
        ns, nc = e.shape[0], len(cart_components(l))
        cols = _columns(l, off)
        S = sph(l, coords.device)
        pstep = max(1, chunk // (nk * ncomp * ns * nc * 2))
        for p0 in range(0, n, pstep):
            pts = coords[p0:p0 + pstep]
            m = pts.shape[0]
            s_idx, l_idx = _pairs_in_range(e, c, r, Ls, pts, lcut)
            centers = r[s_idx] + Ls[l_idx]
            acc = coords.new_zeros((2, nk * ns, ncomp * m * nc))
            step = max(1, chunk // (ncomp * m * nc))
            for i in range(0, s_idx.shape[0], step):
                si = s_idx[i:i + step]
                vals = _image_values(l, pts, e[si], c[si],
                                     centers[i:i + step], deriv, lcut)
                # (nk, ns, pairs): each pair's phase in its shell's row
                ph = phases[:, l_idx[i:i + step]]
                sel = torch.zeros((nk, ns, si.shape[0]),
                                  dtype=phases.dtype, device=pts.device)
                sel[:, si, torch.arange(si.shape[0],
                                        device=pts.device)] = ph
                sel = sel.reshape(nk * ns, -1)
                v = vals.transpose(0, 1).reshape(si.shape[0], -1)
                acc[0] += sel.real @ v
                acc[1] += sel.imag @ v
            acc = torch.einsum('zksxnp,mp->zkxnsm', acc.reshape(
                2, nk, ns, ncomp, m, nc), S).reshape(2, nk, ncomp, m, -1)
            out[:, :, p0:p0 + m, cols] = torch.complex(acc[0], acc[1])
    return out if deriv else out[:, 0]


def eval_ao(mol, coords, deriv=0):
    """AO values on coords (n, 3) on mol.device: (n, nao) for deriv 0,
    (4, n, nao) [value, d/dx, d/dy, d/dz] for deriv 1, (10, n, nao) with
    the second derivatives [xx, xy, xz, yy, yz, zz] for deriv 2, (20, n,
    nao) with the third derivatives [xxx, xxy, xxz, xyy, xyz, xzz, yyy,
    yyz, yzz, zzz] for deriv 3."""
    from . import kernels
    if deriv not in NCOMP:
        raise NotImplementedError(f'eval_ao deriv={deriv}: only 0 to 3')
    return kernels.eval_ao(ao_tables(mol), coords, mol.nao, deriv)
