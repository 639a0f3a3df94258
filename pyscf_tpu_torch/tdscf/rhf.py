"""TDA and TDHF (RPA) excited states of closed-shell references.

Counterpart of pyscf_tpu/tdscf/rhf.py (get_ab, _fxc_ov, gen_tda_operation,
TDA, TDHF, TDDFT), on the device of the mean field:

  get_ab     the dense A and B matrices in the occupied-virtual space:
             (ia|jb) and (ij|ab) from the DF factor's MO blocks (df_jk._bmo,
             GEMMs) or ao2mo of the in-core ERI tensor; for a KS mean field
             the XC kernel of _fxc_ov per block of grid points:
               dmao = ao @ dm                    torch.matmul (cuBLAS)
               w f_xc per point (4x4 blocks)     CUDA kernel `xc_fxc`
               orbital values aod @ C            torch.matmul (cuBLAS)
               P, H P per point and pair         CUDA kernel `xc_fxc_pairs`
               A_xc += P^T (H P)                 torch.matmul (cuBLAS)
             in chunks of points whose P and HP take PAIR_BYTES.
  gen_tda_operation
             the matrix-free A z of the Davidson solver, for a batch of
             vectors: DF or in-core J/K as GEMMs, and for a KS mean field
             the tangent of V_xc along the transition densities (NumInt
             rks_response, kernel `xc_rks_fxc`, for a singlet; uks_response,
             kernel `xc_uks_fxc`, for a triplet).
  TDA        dense eigh of A up to dense_cutoff occupied-virtual pairs,
             else Davidson (lib/linalg.py) from the argsort of the diagonal.
  TDHF       Casida's dense (A-B)^1/2 (A+B) (A-B)^1/2; TDDFT is TDHF.

The Hessian route (get_ab) and the jvp route (the Davidson matvec) are
ported as they are: the first has no clamps, the second carries the SCF's,
so the two differ slightly at low-density points, as in the JAX package.
A range-separated functional's long-range exchange and VV10's kernel are
not in the reference's A and B (it reads the hybrid fraction alone), so
those mean fields raise NotImplementedError here. Energies, transition
dipoles and oscillator strengths are numpy arrays; amplitudes and NTO
coefficients stay tensors on the device.
"""
import time

import numpy as np
import torch

from .. import ao2mo
from ..dft import numint
from ..ops import kernels
from ..ops.integrals.j3c import sync

# bytes the pair features P and HP of a chunk of grid points may take on the
# card (the whole grid's are 9 GB each at benzene/def2-SVP)
PAIR_BYTES = 1 << 31


def _orbitals(mf):
    """(C_occ, C_vir, e_occ, e_vir) of a restricted mean field."""
    occ = mf.mo_occ > 0
    return (mf.mo_coeff[:, occ], mf.mo_coeff[:, ~occ], mf.mo_energy[occ],
            mf.mo_energy[~occ])


def hybrid_fraction(mf):
    """The exact-exchange fraction of the response: 1 for HF, the hybrid
    coefficient of a KS functional; NotImplementedError for range
    separation or VV10, which the reference's A and B leave out."""
    if not hasattr(mf, 'xc'):
        return 1.0
    omega, _, hyb = mf._numint.rsh_and_hybrid_coeff(mf.xc)
    if omega or mf.nlc:
        raise NotImplementedError(
            f'TDA/TDDFT of {mf.xc!r}: the reference builds A and B with the '
            'hybrid fraction alone, without the long-range exchange and the '
            'VV10 kernel (ROADMAP section 3)')
    return float(hyb)


def pair_step(npts, ncol, device):
    """Points per chunk when each point holds ncol doubles of P and HP."""
    budget = PAIR_BYTES if device.type == 'cuda' else numint.CPU_BLOCK_BYTES
    return max(1, min(npts, budget // (8 * ncol)))


def get_ab(mf, singlet=True):
    """Full A and B (nocc, nvir, nocc, nvir):
      singlet: A = e_a - e_i + 2 (ia|jb) - hyb (ij|ab) + f_xc(aa + ab)
      triplet: A = e_a - e_i            - hyb (ij|ab) + f_xc(aa - ab)
    and B the same with (ib|ja) for (ij|ab) and no orbital energies."""
    co, cv, eo, ev = _orbitals(mf)
    nocc, nvir = co.shape[1], cv.shape[1]
    nov = nocc * nvir
    hyb = hybrid_fraction(mf)
    if mf.with_df is not None:
        from ..df.df_jk import _bmo
        B = mf.with_df.cderi
        naux = B.shape[0]
        bov = _bmo(B, co, cv).reshape(naux, nov)
        ovov = (bov.T @ bov).reshape(nocc, nvir, nocc, nvir)
        oovv = (_bmo(B, co, co).reshape(naux, -1).T
                @ _bmo(B, cv, cv).reshape(naux, -1)).reshape(
                    nocc, nocc, nvir, nvir)
    else:
        eri = mf._get_eri()
        ovov = ao2mo.general(eri, (co, cv, co, cv))
        oovv = ao2mo.general(eri, (co, co, cv, cv))
    diag = (ev[None, :] - eo[:, None]).reshape(-1)
    a = torch.diag(diag).reshape(nocc, nvir, nocc, nvir)
    a = a - hyb * oovv.permute(0, 2, 1, 3)
    b = -hyb * ovov.permute(0, 3, 2, 1)
    if singlet:
        a = a + 2.0 * ovov
        b = b + 2.0 * ovov
    if hasattr(mf, 'xc'):
        if mf.grids.coords is None:
            mf.grids.build()
        aod, weights = mf._numint.grid_ao(mf.mol, mf.grids, 1)
        a_xc = _fxc_ov(mf, co, cv, aod, weights, singlet)
        a = a + a_xc
        b = b + a_xc
    return a, b


def _fxc_ov(mf, co, cv, aod_blocks, weights, singlet=True):
    """The XC coupling (nocc, nvir, nocc, nvir): sum over the grid of
    P^T w (f_aa +/- f_ab) P, the spin-adapted kernel of the closed shell
    (xc_fxc), with P the pair features (xc_fxc_pairs), on the caller's
    deriv-1 AO blocks of grid_ao and their weights."""
    dm = mf.make_rdm1()
    xc = mf.xc_obj
    nocc, nvir = co.shape[1], cv.shape[1]
    nov = nocc * nvir
    a_xc = torch.zeros((nov, nov), dtype=dm.dtype, device=dm.device)
    for aod, w in zip(aod_blocks, weights):
        H = kernels.xc_fxc(aod, (aod[0] @ dm)[None], w, xc, singlet)
        step = pair_step(w.shape[0], 8 * nov, w.device)
        for i in range(0, w.shape[0], step):
            blk = aod[:, i:i + step]
            P, HP = kernels.xc_fxc_pairs(torch.matmul(blk, co),
                                         torch.matmul(blk, cv),
                                         H[i:i + step], (0,))
            a_xc += P.reshape(-1, nov).T @ HP[0].reshape(-1, nov)
            del P, HP
    return a_xc.reshape(nocc, nvir, nocc, nvir)


def gen_tda_operation(mf, singlet=True):
    """(matvec, hdiag): matvec maps a batch of vectors z (k, nocc*nvir) to
    A z (k, nocc*nvir) without forming A; hdiag (nocc*nvir,) numpy is the
    diagonal of the orbital-energy part."""
    co, cv, eo, ev = _orbitals(mf)
    nocc, nvir = co.shape[1], cv.shape[1]
    hyb = hybrid_fraction(mf)

    if mf.with_df is not None:
        from ..df.df_jk import _bmo
        B = mf.with_df.cderi
        naux = B.shape[0]
        bov = _bmo(B, co, cv).reshape(naux, -1)
        boo = _bmo(B, co, co)
        bvv = _bmo(B, cv, cv)

        def jk_part(z):
            az = torch.zeros_like(z)
            if singlet:
                rho = z.reshape(z.shape[0], -1) @ bov.T          # (k, naux)
                az = az + 2.0 * (rho @ bov).reshape(z.shape)
            if hyb != 0.0:
                t = torch.matmul(boo[None], z[:, None])          # (k, P, i, b)
                az = az - hyb * torch.einsum('kxib,xab->kia', t, bvv)
            return az
    else:
        get_j, get_k = mf._jk_fns()

        def jk_part(z):
            az = torch.zeros_like(z)
            for k, dmz in enumerate(co @ z @ cv.T):
                if singlet:
                    az[k] += co.T @ get_j(dmz + dmz.T) @ cv
                if hyb != 0.0:
                    az[k] -= hyb * (co.T @ get_k(dmz) @ cv)
            return az

    fxc_part = None
    if hasattr(mf, 'xc'):
        if mf.grids.coords is None:
            mf.grids.build()
        deriv = 1 if mf.xc_obj.is_gga else 0
        dm0 = mf.make_rdm1()
        if singlet:
            aod, weights = mf._numint.grid_ao(mf.mol, mf.grids, deriv)
            resp = mf._numint.rks_response(mf.xc, aod, weights, dm0)

            def fxc_part(z):
                # the V_xc response to the symmetrised transition density
                ddm = co @ z @ cv.T
                return co.T @ resp(ddm + ddm.transpose(1, 2)) @ cv
        else:
            aod, weights = mf._numint.grid_ao(mf.mol, mf.grids, deriv, 2)
            resp = mf._numint.uks_response(
                mf.xc, aod, weights, torch.stack([0.5 * dm0, 0.5 * dm0]))

            def fxc_part(z):
                # the alpha V_xc response to the antisymmetric spin
                # perturbation (ddm/2, -ddm/2) of the half densities
                ddm = co @ z @ cv.T
                ddm = 0.5 * (ddm + ddm.transpose(1, 2))
                dva = resp(torch.stack([ddm, -ddm], dim=1))[:, 0]
                return co.T @ dva @ cv

    ediag = ev[None, :] - eo[:, None]

    def matvec(z):
        z = z.reshape(-1, nocc, nvir)
        az = ediag * z + jk_part(z)
        if fxc_part is not None:
            az = az + fxc_part(z)
        return az.reshape(z.shape[0], -1)

    return matvec, ediag.reshape(-1).cpu().numpy()


class TDA:
    nstates = 3
    singlet = True
    conv_tol = 1e-8
    # use the iterative Davidson solver above this ov-space size
    dense_cutoff = 1500

    def __init__(self, mf):
        self._scf = mf
        self.mol = mf.mol
        self.e = None
        self.xy = None
        # the Davidson path's convergence, matvec calls and vectors, and
        # the seconds of the last kernel(): 'get_ab' and 'eigh', or
        # 'davidson'
        self.converged = None
        self.cycles = self.nmatvec = 0
        self.timings = {}

    def kernel(self, nstates=None):
        """The nstates lowest excitation energies (numpy, Hartree)."""
        from ..lib.linalg import davidson
        n = nstates or self.nstates
        mf = self._scf
        co, cv, _, _ = _orbitals(mf)
        nocc, nvir = co.shape[1], cv.shape[1]
        nov = nocc * nvir
        dev = co.device
        t0 = time.perf_counter()
        if nov <= self.dense_cutoff:
            a, _ = get_ab(mf, singlet=self.singlet)
            sync(dev)
            t1 = time.perf_counter()
            w, v = torch.linalg.eigh(a.reshape(nov, nov))
            self.e = w[:n].cpu().numpy()
            self.xy = [(v[:, i].reshape(nocc, nvir) * np.sqrt(0.5), 0)
                       for i in range(n)]
            self.converged = True
            self.timings = {'get_ab': t1 - t0,
                            'eigh': time.perf_counter() - t1}
            return self.e
        matvec, hdiag = gen_tda_operation(mf, singlet=self.singlet)
        self.cycles = self.nmatvec = 0

        def counted(z):
            self.cycles += 1
            self.nmatvec += z.shape[0]
            return matvec(z)

        x0 = torch.zeros((n, nov), dtype=co.dtype, device=dev)
        order = np.argsort(hdiag)
        for i in range(n):
            x0[i, order[i]] = 1.0
        w, v, self.converged = davidson(counted, x0, neig=n,
                                        tol=self.conv_tol, hdiag=hdiag)
        self.e = np.asarray(w)[:n]
        self.xy = [(v[i].reshape(nocc, nvir) * np.sqrt(0.5), 0)
                   for i in range(n)]
        sync(dev)
        self.timings = {'davidson': time.perf_counter() - t0}
        return self.e

    run = kernel

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e

    def _r_ov(self):
        """MO ov blocks of the position operator <i|r|a>, (3, nocc, nvir),
        from mol.intor('int1e_r') (kernel `int1e_r`)."""
        co, cv, _, _ = _orbitals(self._scf)
        r = self.mol.intor('int1e_r')
        return torch.einsum('ui,xuv,va->xia', co, r, cv)

    def transition_dipole(self):
        """<0|r|n> per state, (nstates, 3) numpy; zero for triplets."""
        n = len(self.xy)
        if not self.singlet:
            return np.zeros((n, 3))
        r_ov = self._r_ov()
        # |x+y| normalised with (x+y).(x-y) = 1/2, so a factor 2
        return np.stack([
            2.0 * torch.einsum('xia,ia->x', r_ov, x + y).cpu().numpy()
            for x, y in self.xy])

    def oscillator_strength(self):
        dip = self.transition_dipole()
        return (2.0 / 3.0) * np.asarray(self.e) * np.sum(dip * dip, axis=1)

    def get_nto(self, state=0):
        """Natural transition orbitals of one excited state: (weights
        numpy, coefficients (nao, 2k) tensor), hole orbitals first in
        descending weight, then the particle orbitals."""
        co, cv, _, _ = _orbitals(self._scf)
        u, s, vt = torch.linalg.svd(self.xy[state][0], full_matrices=False)
        w = (s * s / torch.sum(s * s)).cpu().numpy()
        return w, torch.cat([co @ u, cv @ vt.T], dim=1)

    def nuc_grad_method(self, state=1):
        raise NotImplementedError(
            'analytic excited-state gradients (pyscf_tpu/grad/tdrhf.py) are '
            'not ported yet')

    Gradients = nuc_grad_method


class TDHF(TDA):
    def kernel(self, nstates=None):
        """Casida's equation on the dense A and B: the nstates lowest
        excitation energies (numpy, Hartree) and (X, Y) with (X+Y).(X-Y) =
        1/2."""
        n = nstates or self.nstates
        t0 = time.perf_counter()
        a, b = get_ab(self._scf, singlet=self.singlet)
        nocc, nvir = a.shape[0], a.shape[1]
        nov = nocc * nvir
        sync(a.device)
        t1 = time.perf_counter()
        amat = a.reshape(nov, nov)
        bmat = b.reshape(nov, nov)
        apb = amat + bmat
        amb = amat - bmat
        w2_amb, v_amb = torch.linalg.eigh(amb)
        w2_amb = torch.clamp(w2_amb, min=1e-14)
        sqrt_amb = (v_amb * torch.sqrt(w2_amb)) @ v_amb.T
        isqrt_amb = (v_amb / torch.sqrt(w2_amb)) @ v_amb.T
        w2, z = torch.linalg.eigh(sqrt_amb @ apb @ sqrt_amb)
        w = torch.sqrt(torch.clamp(w2, min=1e-14))
        self.e = w[:n].cpu().numpy()
        self.xy = []
        for i in range(n):
            zi = z[:, i] / np.sqrt(2.0)
            xpy = sqrt_amb @ zi / torch.sqrt(w[i])
            xmy = isqrt_amb @ zi * torch.sqrt(w[i])
            self.xy.append((0.5 * (xpy + xmy).reshape(nocc, nvir),
                            0.5 * (xpy - xmy).reshape(nocc, nvir)))
        self.converged = True
        sync(a.device)
        self.timings = {'get_ab': t1 - t0, 'eigh': time.perf_counter() - t1}
        return self.e


TDDFT = TDHF
