"""Plane-wave density fitting on the cell's FFT mesh, at the Γ point and
over a k-point mesh.

Counterpart of pyscf_tpu/pbc/df/fft.py: eval_ao_periodic, eval_ao_kpts,
_gth_vlocG, _gth_proj_combination, the projector overlaps of
_proj_ovlp_images, FFTDF with _ao_on_grid, weight, get_ovlp, get_kin,
get_pp, get_pp_nl, get_hcore and get_jk, and KFFTDF with
_ao_on_grid_kpts, get_ovlp_kpts, get_kin_kpts, get_pp_kpts,
get_pp_nl_kpts, get_hcore_kpts, get_jk_kpts and get_jk_bands. Where the
JAX package loops over the lattice images on the host (eval_ao per image,
one cross-integral call per image), the port puts every image into one
launch:

    AO values summed over the images       CUDA kernel `eval_ao_pbc`
                                            (csrc/eval_ao_pbc.cu), the
                                            image loop inside the kernel
    Bloch sums sum_L e^{ik.L} phi(r - L)   CUDA kernel `eval_ao_kpts`
    for every k at once                     (csrc/eval_ao_kpts.cu)
    S and T summed over the images         CUDA kernel `int1e_stv`, one
                                            launch per class pair over
                                            every (shell, shell + L) pair;
                                            at k-points the image axis is
                                            phased by a GEMM with e^{ik.L}
    <AO | GTH projector at R + L>          `int1e_stv` in S-only mode, the
                                            projector's monomial
                                            combination as the ket's
                                            transform, every image at once
    V_loc(r), J, K on the mesh             torch.fft, GEMMs (cuBLAS)

K batches the occupied orbitals' pair densities through one FFT per batch
in place of the JAX package's loop over orbitals; at k-points it batches
the (k, orbital) pairs of each k2 the same way, where the JAX package
loops over k2, k and the orbitals. Everything runs on cell.device.
"""
import math
import time

import numpy as np
import torch

from ...ops.eval_gto import ao_tables
from ...ops.integrals.cart2sph import cart2sph
from ...ops.integrals.hermite import cart_components
from ...ops.integrals.j3c import sync


def _f64(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                           device=dev)


def lattice_cut(cell):
    """lcut = min_exp rcut^2: exp(-a r^2) of a primitive with a r^2 > lcut
    is below what the cell's rcut keeps of its most diffuse primitive."""
    return cell.min_exp * cell.rcut ** 2


def eval_ao_periodic(cell, coords, deriv=0, rcut=None):
    """AO values summed over the lattice images within rcut (default the
    cell's) on coords (n, 3): (n, nao), or (4, n, nao) for deriv 1; kernel
    `eval_ao_pbc`, one launch per l-class."""
    from ...ops import kernels
    dev = cell.device
    Ls = _f64(cell.get_lattice_Ls(rcut), dev)
    return kernels.eval_ao_pbc(ao_tables(cell), _f64(coords, dev), Ls,
                               cell.nao, deriv, lattice_cut(cell))


def kpts_phases(kpts, Ls, dev):
    """e^{ik.L} (nk, nimg) complex128 on dev."""
    kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)
    return torch.as_tensor(np.exp(1j * (kpts @ np.asarray(Ls).T)),
                           dtype=torch.complex128, device=dev)


def eval_ao_kpts(cell, coords, kpts, deriv=0, rcut=None):
    """Bloch AO values sum_L e^{ik.L} phi(r - L) over the lattice images
    within rcut (default the cell's) on coords (n, 3) for kpts (nk, 3):
    (nk, n, nao), or (nk, 4, n, nao) for deriv 1, complex128; kernel
    `eval_ao_kpts`, one launch per l-class for every k."""
    from ...ops import kernels
    dev = cell.device
    Ls = cell.get_lattice_Ls(rcut)
    return kernels.eval_ao_kpts(ao_tables(cell), _f64(coords, dev),
                                _f64(Ls, dev), kpts_phases(kpts, Ls, dev),
                                cell.nao, deriv, lattice_cut(cell))


def _image_sum(blk, phases, axis):
    """blk summed over its image axis, or phased into a leading k axis:
    sum_L e^{ik.L} blk[..., L, ...] (complex128) for phases (nk, nL)."""
    if phases is None:
        return blk.sum(axis)
    blk = blk.movedim(axis, 0)
    shape = blk.shape[1:]
    flat = blk.reshape(blk.shape[0], -1)
    return torch.complex(phases.real @ flat, phases.imag @ flat).reshape(
        phases.shape[0], *shape)


def coul_q(Gv, q):
    """4 pi / |G + q|^2 (nq, ngrid) on the G vectors Gv (ngrid, 3) for each
    q (nq, 3), 0 where G + q = 0."""
    Gq = Gv[None] + q[:, None]
    G2 = torch.einsum('qix,qix->qi', Gq, Gq)
    return torch.where(G2 > 1e-12, 4.0 * math.pi / torch.where(
        G2 > 1e-12, G2, torch.ones_like(G2)), torch.zeros_like(G2))


def coulG(cell, mesh, k=None):
    """4 pi / |G + k|^2 on the mesh's G vectors (ngrid,), 0 where G + k =
    0 (k = 0 unless given)."""
    dev = cell.device
    return coul_q(_f64(cell.get_Gv(mesh), dev),
                  _f64(np.zeros(3) if k is None else k, dev)[None])[0]


def _gth_vlocG(cell, G2):
    """Local GTH pseudopotential in G space per element, {symb: (ngrid,)},
    attractive; the G = 0 entry holds the regularized limit (an atom
    without a pseudopotential: -4 pi Z / G^2 with G = 0 dropped)."""
    out = {}
    small = G2 < 1e-12
    G2s = torch.where(small, torch.ones_like(G2), G2)
    charges = {s: float(z) for s, z in zip(cell.elements_, cell.charges)}
    for symb in set(cell.elements_):
        pp = cell._pseudo.get(symb)
        if pp is None:
            out[symb] = torch.where(small, torch.zeros_like(G2),
                                    -4.0 * math.pi * charges[symb] / G2s)
            continue
        zion = float(sum(pp['nelec']))
        rloc = pp['rloc']
        c = list(pp['cloc']) + [0.0] * (4 - len(pp['cloc']))
        g2r = G2 * rloc ** 2
        expf = torch.exp(-0.5 * g2r)
        vl = -4.0 * math.pi * zion / G2s * expf
        cfacs = (c[0] + c[1] * (3.0 - g2r)
                 + c[2] * (15.0 - 10.0 * g2r + g2r ** 2)
                 + c[3] * (105.0 - 105.0 * g2r + 21.0 * g2r ** 2 - g2r ** 3))
        vl = vl + (2.0 * math.pi) ** 1.5 * rloc ** 3 * expf * cfacs
        g0 = 2.0 * math.pi * zion * rloc ** 2 \
            + (2.0 * math.pi) ** 1.5 * rloc ** 3 * c[0] \
            + (2.0 * math.pi) ** 1.5 * rloc ** 3 * (3.0 * c[1] + 15.0 * c[2]
                                                    + 105.0 * c[3])
        out[symb] = torch.where(small, torch.full_like(G2, g0), vl)
    return out


def _gth_proj_combination(l, i):
    """r^(2(i-1)) Y_lm as cartesian monomials of degree l + 2(i-1): the
    (ncart, 2l+1) matrix W with r^(2k) Y_lm = sum_c W[c, m] x^c."""
    S = np.asarray(cart2sph(l))           # (2l+1, nc_l)
    k = i - 1
    hi = {c: idx for idx, c in enumerate(cart_components(l + 2 * k))}
    W = np.zeros((len(hi), 2 * l + 1))
    for kx in range(k + 1):
        for ky in range(k - kx + 1):
            kz = k - kx - ky
            mult = math.factorial(k) // (math.factorial(kx)
                                         * math.factorial(ky)
                                         * math.factorial(kz))
            for ci, c in enumerate(cart_components(l)):
                W[hi[(c[0] + 2 * kx, c[1] + 2 * ky, c[2] + 2 * kz)], :] += \
                    mult * S[:, ci]
    return W


def _gth_norm(l, i, rl):
    """The norm of the GTH projector p_i^l with radius rl."""
    q = l + (4.0 * i - 1.0) / 2.0
    return math.sqrt(2.0) / (rl ** q * math.sqrt(math.gamma(q)))


def _image_pairs(ga, gb, centers_b, dev):
    """Pair tables (ea, ca, ra, eb, cb, rb) of every (shell of ga, ket of
    centers_b) pair, ga-shell-major: centers_b (nb, nL, 3) are the kets'
    centres at each image, gb gives their (nb, K) exponents and
    coefficients."""
    nsa = ga.nshl
    nb, nL = centers_b.shape[:2]
    sel_a = np.repeat(np.arange(nsa), nb * nL)
    sel_b = np.tile(np.repeat(np.arange(nb), nL), nsa)
    rb = np.broadcast_to(centers_b[None], (nsa, nb, nL, 3)).reshape(-1, 3)
    arrays = (ga.exps[sel_a], ga.coeffs[sel_a], ga.coords[sel_a],
              gb[0][sel_b], gb[1][sel_b], rb)
    return tuple(_f64(x, dev) for x in arrays)


class FFTDF:
    """J, K, hcore and AO values of a cell on its uniform FFT mesh.

    The AO values on the grid, S and T, the pseudopotential and coulG are
    built once per cell and mesh and kept in the cell's `_pbc_cache`, so
    mean fields of one cell share them (FFTDF and GDF, LDA and HF); the
    seconds of each build are in `timings` ('ao', 'st', 'pp') of the
    object that built it."""

    # the order at which the grid AO values are built: a GGA mean field
    # sets 1 before its hcore, so that the deriv-0 users (the local
    # pseudopotential, J, K) read the first component of the one array
    ao_deriv = 0

    def __init__(self, cell):
        self.cell = cell
        self.mesh = cell.mesh
        self.timings = {}

    def _cached(self, key, build, timing=None):
        cache = self.cell._pbc_cache
        key = key + (tuple(self.mesh),)
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = build()
            sync(self.cell.device)
            if timing:
                self.timings[timing] = time.perf_counter() - t0
        return cache[key]

    @property
    def grids_coords(self):
        return self.cell.get_uniform_grids(self.mesh)

    @property
    def weight(self):
        return self.cell.vol / np.prod(self.mesh)

    @property
    def ngrid(self):
        return int(np.prod(self.mesh))

    def _ao_on_grid(self, deriv=0):
        """AO values (ngrid, nao), or with gradients (4, ngrid, nao), on the
        uniform grid (kernel `eval_ao_pbc`); deriv 0 is the first component
        of deriv 1's where those exist or ao_deriv asks for them."""
        if deriv == 0 and (self.ao_deriv or ('ao', 1, tuple(self.mesh))
                           in self.cell._pbc_cache):
            return self._ao_on_grid(1)[0]
        return self._cached(('ao', deriv), lambda: eval_ao_periodic(
            self.cell, self.grids_coords, deriv), 'ao')

    def _coul(self):
        return self._cached(('coulG',), lambda: coulG(self.cell, self.mesh))

    def _lattice_st(self):
        return self._cached(('st',), self._build_st, 'st')

    def _build_st(self, kpts=None):
        """(S, T) summed over the lattice images: one `int1e_stv` launch per
        class pair la <= lb over every (shell, shell + L) pair; the la > lb
        blocks are the transposes (each sum is symmetric). With kpts (nk,
        3) the image axis is phased, M_k = sum_L e^{ik.L} <a | b + L>
        (nk, nao, nao) complex, and the la > lb blocks are the conjugate
        transposes."""
        from ...ops import kernels
        cell = self.cell
        dev = cell.device
        Ls = cell.get_lattice_Ls()
        nL = len(Ls)
        ph = None if kpts is None else kpts_phases(kpts, Ls, dev)
        lead = (2,) if ph is None else (2, ph.shape[0])
        out = torch.zeros(lead + (cell.nao, cell.nao), device=dev,
                          dtype=torch.float64 if ph is None
                          else torch.complex128)
        no_atoms = (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                    torch.zeros(0, dtype=torch.float64, device=dev))
        for la, ga in cell.shell_groups.items():
            for lb, gb in cell.shell_groups.items():
                if la > lb:
                    continue
                kets = gb.coords[:, None, :] + Ls[None, :, :]
                pairs = _image_pairs(ga, (gb.exps, gb.coeffs), kets, dev)
                da, db = 2 * la + 1, 2 * lb + 1
                rows = kernels.int1e_stv(la, lb, *pairs, *no_atoms)
                blk = rows.reshape(ga.nshl, gb.nshl, nL, da, db, 3)[..., :2]
                blk = _image_sum(blk, ph, 2).movedim(-1, 0)
                blk = blk.transpose(-3, -2).reshape(
                    lead + (ga.nshl * da, gb.nshl * db))
                ia = torch.as_tensor((ga.ao_off[:, None]
                                      + np.arange(da)).ravel(), device=dev)
                jb = torch.as_tensor((gb.ao_off[:, None]
                                      + np.arange(db)).ravel(), device=dev)
                out[..., ia[:, None], jb[None, :]] = blk
                if la != lb:
                    out[..., jb[:, None], ia[None, :]] = \
                        blk.transpose(-1, -2).conj()
        return out[0], out[1]

    def get_ovlp(self):
        """Lattice-summed overlap (nao, nao)."""
        return self._lattice_st()[0]

    def get_kin(self):
        """Lattice-summed kinetic energy (nao, nao)."""
        return self._lattice_st()[1]

    def get_pp(self):
        """GTH pseudopotential matrix, local + non-local."""
        return self._cached(('pp',), lambda: self.get_pp_loc()
                            + self.get_pp_nl(), 'pp')

    def _vloc(self):
        """V_loc(r) = (N / vol) IFFT[sum_A e^{-iG.R_A} V_A(G)] on the mesh
        (ngrid,)."""
        cell = self.cell
        dev = cell.device
        mesh = self.mesh
        Gv = _f64(cell.get_Gv(mesh), dev)
        vlocG = _gth_vlocG(cell, torch.einsum('ix,ix->i', Gv, Gv))
        SIv = torch.zeros(self.ngrid, dtype=torch.complex128, device=dev)
        for ia, symb in enumerate(cell.elements_):
            SIv += torch.exp(-1j * (Gv @ _f64(cell.coords[ia], dev))) \
                * vlocG[symb]
        return torch.fft.ifftn(SIv.reshape(mesh)).real.reshape(-1) \
            * (self.ngrid / cell.vol)

    def get_pp_loc(self):
        """Local part: w ao^T V_loc ao."""
        ao = self._ao_on_grid(0)
        return self.weight * (ao.T @ (self._vloc()[:, None] * ao))

    def _projector_overlaps(self, kpts=None):
        """{(atom, l, i): P (nao, 2l+1)}, P = sum_L <AO | p_i^l at R_A + L>,
        the GTH projector r^(2(i-1)) Y_lm e^(-r^2 / 2 rl^2) with its norm:
        one S-only `int1e_stv` launch per (AO class, l, i) over every
        (shell, atom, image) triple, the projector's monomial combination W
        as the ket's transform. With kpts (nk, 3): P_k = sum_L e^{ik.L}
        <AO | p_i^l at R_A + L> (nk, nao, 2l+1) complex."""
        from ...ops import kernels
        cell = self.cell
        dev = cell.device
        Ls = cell.get_lattice_Ls()
        nL = len(Ls)
        ph = None if kpts is None else kpts_phases(kpts, Ls, dev)
        lead = () if ph is None else (ph.shape[0],)
        chans = {}              # (l, i) -> [(atom, rl)]
        for ia, symb in enumerate(cell.elements_):
            pp = cell._pseudo.get(symb)
            for l, ch in enumerate(pp['nl'] if pp else []):
                for i in range(1, len(ch['h']) + 1):
                    chans.setdefault((l, i), []).append((ia, ch['rl']))
        out = {}
        for (l, i), atoms in chans.items():
            ldeg = l + 2 * (i - 1)
            W = _gth_proj_combination(l, i)
            sb = np.zeros((2 * ldeg + 1, W.shape[0]))
            sb[:2 * l + 1] = W.T
            sb = _f64(sb, dev)
            ids = [ia for ia, _ in atoms]
            alpha = np.array([[0.5 / rl ** 2] for _, rl in atoms])
            norm = _f64([_gth_norm(l, i, rl) for _, rl in atoms], dev)
            kets = cell.coords[ids][:, None, :] + Ls[None, :, :]
            P = torch.zeros(lead + (len(ids), cell.nao, 2 * l + 1),
                            device=dev, dtype=torch.float64 if ph is None
                            else torch.complex128)
            for la, ga in cell.shell_groups.items():
                pairs = _image_pairs(ga, (alpha, np.ones_like(alpha)), kets,
                                     dev)
                da = 2 * la + 1
                rows = kernels.int1e_stv(la, ldeg, *pairs, with_tv=False,
                                         sb=sb)
                blk = rows.reshape(ga.nshl, len(ids), nL, da, 2 * ldeg + 1)
                blk = _image_sum(blk[..., :2 * l + 1], ph, 2)
                ia = torch.as_tensor((ga.ao_off[:, None]
                                      + np.arange(da)).ravel(), device=dev)
                P[..., ia, :] = blk.transpose(-4, -3).reshape(
                    lead + (len(ids), ga.nshl * da, 2 * l + 1))
            P = P * norm[:, None, None]
            for k, ia in enumerate(ids):
                out[(ia, l, i)] = P[..., k, :, :]
        return out

    def get_pp_nl(self, kpts=None):
        """Non-local part: sum over atoms and channels of h_ij P_i P_j^H
        with the lattice-summed projector overlaps; with kpts, the phased
        ones (nk, nao, nao) complex."""
        cell = self.cell
        vnl = 0.0
        P = self._projector_overlaps(kpts)
        for ia, symb in enumerate(cell.elements_):
            pp = cell._pseudo.get(symb)
            for l, ch in enumerate(pp['nl'] if pp else []):
                h = np.asarray(ch['h'])
                for i in range(h.shape[0]):
                    for j in range(h.shape[0]):
                        if abs(h[i, j]) > 0:
                            vnl = vnl + float(h[i, j]) * (
                                P[(ia, l, i + 1)]
                                @ P[(ia, l, j + 1)].conj().transpose(-1, -2))
        if isinstance(vnl, float):          # no projector in the cell
            shape = (cell.nao,) * 2 if kpts is None else (len(kpts),) \
                + (cell.nao,) * 2
            return torch.zeros(shape, device=cell.device,
                               dtype=torch.float64 if kpts is None
                               else torch.complex128)
        return vnl

    def get_hcore(self):
        return self.get_kin() + self.get_pp()

    def get_j(self, dm):
        """J from the density on the mesh: V(r) = IFFT[coulG FFT[rho]],
        J = w ao^T V ao."""
        ao = self._ao_on_grid(0)
        rho = torch.einsum('gi,gi->g', ao @ dm, ao)
        vr = torch.fft.ifftn(self._coul().reshape(self.mesh)
                             * torch.fft.fftn(rho.reshape(self.mesh)))
        return self.weight * (ao.T @ (vr.real.reshape(-1, 1) * ao))

    def get_k(self, dm, co=None):
        """K from the occupied orbitals co (scaled by the square root of
        their occupation; from dm's eigenvectors above 1e-10 when not
        given): the pair densities ao_i psi_o of a batch of orbitals go
        through one FFT, K_ij = w sum_o <ao_i psi_o | v[ao_j psi_o]>."""
        from ...dft.numint import _budget
        if co is None:
            co = occupied_orbitals(dm)
        ao = self._ao_on_grid(0)
        ng, nao = ao.shape
        aoc = ao @ co
        coul = self._coul().reshape(*self.mesh, 1)
        vk = torch.zeros((nao, nao), dtype=torch.float64, device=ao.device)
        # a batch's pair densities in complex128 and their potential
        step = max(1, _budget(ao.device, 4) // (ng * nao * 16 * 3))
        for o in range(0, aoc.shape[1], step):
            pair = ao[:, :, None] * aoc[:, None, o:o + step]
            nb = pair.shape[2]
            pg = torch.fft.fftn(pair.reshape(*self.mesh, nao * nb),
                                dim=(0, 1, 2))
            vp = torch.fft.ifftn(pg.reshape(*self.mesh, nao, nb)
                                 * coul[..., None], dim=(0, 1, 2))
            vp = vp.real.reshape(ng, nao, nb)
            vk += torch.einsum('gio,gjo->ij', pair, vp)
        return self.weight * vk

    def get_jk(self, dm, with_j=True, with_k=True):
        """(vj, vk) of one density, None for a term not asked for."""
        return (self.get_j(dm) if with_j else None,
                self.get_k(dm) if with_k else None)


def occupied_orbitals(dm, thresh=1e-10):
    """Columns c with dm = c c^H from the eigenvalues of each (Hermitian)
    dm (..., nao, nao) above thresh, scaled by their square roots: (...,
    nao, m), m the largest count kept, the others zero."""
    w, v = torch.linalg.eigh(dm)
    keep = w > thresh
    m = max(int(keep.sum(-1).max()), 1)
    w, v, keep = w[..., -m:], v[..., -m:], keep[..., -m:]
    return v * torch.where(keep, torch.sqrt(torch.clamp(w, min=0.0)),
                           0.0)[..., None, :].to(v.dtype)


class KFFTDF(FFTDF):
    """J, K, hcore and Bloch AO values of a cell on its FFT mesh over the
    k-points kpts (nk, 3). The Bloch AO values (kernel `eval_ao_kpts`), S_k,
    T_k and the pseudopotential are kept in the cell's `_pbc_cache` per
    k-point set and mesh, as FFTDF keeps the Γ ones."""

    def __init__(self, cell, kpts):
        super().__init__(cell)
        self.kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)

    @property
    def nkpts(self):
        return len(self.kpts)

    def _kcached(self, key, build, timing=None):
        return self._cached(key + (self.kpts.tobytes(),), build, timing)

    def _ao_on_grid_kpts(self, deriv=0):
        """Bloch AO values (nk, ngrid, nao), or with gradients (nk, 4,
        ngrid, nao), complex128, on the uniform grid (kernel
        `eval_ao_kpts`); deriv 0 is the first component of deriv 1's
        where those exist or ao_deriv asks for them."""
        if deriv == 0 and (self.ao_deriv or ('ao_k', 1, self.kpts.tobytes(),
                                             tuple(self.mesh))
                           in self.cell._pbc_cache):
            return self._ao_on_grid_kpts(1)[:, 0]
        return self._kcached(('ao_k', deriv), lambda: eval_ao_kpts(
            self.cell, self.grids_coords, self.kpts, deriv), 'ao')

    def _lattice_st_kpts(self):
        return self._kcached(('st_k',), lambda: self._build_st(self.kpts),
                             'st')

    def get_ovlp_kpts(self):
        """S_k = sum_L e^{ik.L} <a | b + L> (nk, nao, nao)."""
        return self._lattice_st_kpts()[0]

    def get_kin_kpts(self):
        """T_k (nk, nao, nao)."""
        return self._lattice_st_kpts()[1]

    def get_pp_kpts(self):
        """GTH pseudopotential per k, local + non-local (nk, nao, nao)."""
        return self._kcached(('pp_k',), lambda: self.get_pp_loc_kpts()
                             + self.get_pp_nl(self.kpts), 'pp')

    def get_pp_loc_kpts(self):
        """Local part per k: w phi_k^H V_loc phi_k."""
        ao = self._ao_on_grid_kpts(0)
        vloc = self._vloc().to(torch.complex128)
        return self.weight * (ao.conj().transpose(1, 2)
                              @ (vloc[:, None] * ao))

    def get_pp_nl_kpts(self):
        return self.get_pp_nl(self.kpts)

    def get_hcore_kpts(self):
        return self.get_kin_kpts() + self.get_pp_kpts()

    def get_rho(self, dm):
        """The k-averaged density (ngrid,) of dm (nk, nao, nao):
        (1/nk) sum_k Re sum_ij phi_k,i D_k,ij conj(phi_k,j)."""
        ao = self._ao_on_grid_kpts(0)
        return torch.sum((ao @ dm) * ao.conj(), dim=(0, 2)).real \
            / self.nkpts

    def get_j_kpts(self, dm, band=None):
        """J per k of dm (nk, nao, nao): V(r) = IFFT[coulG FFT[rho]] of
        the k-averaged density, J_k = w phi_k^H V phi_k, at this object's
        k-points or at those of the KFFTDF `band`."""
        ao = (band or self)._ao_on_grid_kpts(0)
        vr = torch.fft.ifftn(self._coul().reshape(self.mesh) * torch.fft.fftn(
            self.get_rho(dm).reshape(self.mesh))).real.reshape(-1, 1)
        return self.weight * (ao.conj().transpose(1, 2) @ (vr * ao))

    def get_k_kpts(self, dm, band=None):
        """K per k of dm (nk, nao, nao), without the G + q = 0 term: with
        the occupied orbitals psi_k2,o of each dm_k2 (eigenvalues above
        1e-10, scaled by their square roots) and q = k2 - k, the pair
        functions u = conj(phi_k) psi_k2,o e^{-iq.r} of a batch of
        (k, orbital) pairs go through one FFT, v[u] = IFFT[4 pi / |G +
        q|^2 FFT[u]], and K_k = (w / nk) sum_k2,o u^T conj(v[u]); at this
        object's k-points or at those of the KFFTDF `band`."""
        from ...dft.numint import _budget
        band = band or self
        cell = self.cell
        dev = cell.device
        ao = self._ao_on_grid_kpts(0)
        ao_b = band._ao_on_grid_kpts(0).conj()
        nb, ng, nao = ao_b.shape
        psi = ao @ occupied_orbitals(dm)             # (nk, ng, nocc)
        nocc = psi.shape[2]
        Gv = _f64(cell.get_Gv(self.mesh), dev)
        coords = _f64(self.grids_coords, dev)
        kb = _f64(band.kpts, dev)
        vk = torch.zeros((nb, nao, nao), dtype=torch.complex128, device=dev)
        # (k, orbital) pairs a batch: its pair functions, their FFT and
        # potential in complex128
        cap = max(1, _budget(dev, 4) // (ng * nao * 16 * 3))
        ostep = min(nocc, cap)
        bstep = max(1, cap // ostep)
        for k2 in range(self.nkpts):
            for b0 in range(0, nb, bstep):
                q = _f64(self.kpts[k2], dev) - kb[b0:b0 + bstep]  # (nbc, 3)
                coul = coul_q(Gv, q).reshape(-1, *self.mesh, 1)
                phase = torch.exp(-1j * (q @ coords.T))       # (nbc, ng)
                for o0 in range(0, nocc, ostep):
                    po = psi[k2, None, :, o0:o0 + ostep] * phase[..., None]
                    u = ao_b[b0:b0 + bstep, :, None, :] * po[..., None]
                    nbc, _, no, _ = u.shape
                    vu = torch.fft.ifftn(torch.fft.fftn(u.reshape(
                        nbc, *self.mesh, no * nao), dim=(1, 2, 3)) * coul,
                        dim=(1, 2, 3)).reshape(nbc, ng * no, nao)
                    vk[b0:b0 + bstep] += u.reshape(nbc, ng * no, nao
                                                   ).transpose(1, 2) \
                        @ vu.conj()
        return vk * (self.weight / self.nkpts)

    def get_jk_kpts(self, dm, with_j=True, with_k=True):
        """(vj, vk) per k of dm (nk, nao, nao), None for a term not asked
        for; K without the exxdiv term."""
        return (self.get_j_kpts(dm) if with_j else None,
                self.get_k_kpts(dm) if with_k else None)

    def get_jk_bands(self, dm, band):
        """(vj, vk) at the k-points of the KFFTDF `band` from the density dm
        (nk, nao, nao) of this object's k-points; K without the exxdiv
        term (the caller adds it where a band point is an SCF point)."""
        return self.get_j_kpts(dm, band), self.get_k_kpts(dm, band)
