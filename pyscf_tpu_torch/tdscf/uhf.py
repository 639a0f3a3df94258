"""TDA for unrestricted references (UHF/UKS).

Counterpart of pyscf_tpu/tdscf/uhf.py (get_ab_uhf, _fxc_ov_uks, TDAUHF,
TDAUKS). The particle-hole space is the direct sum of the alpha and beta
blocks:

  A[ia s, jb t] = d_st d_ij d_ab (e_a - e_i)_s + (ia_s|jb_t)
                  - d_st hyb (ij|ab)_s + f_xc[st]

with (ia|jb) and (ij|ab) from the in-core ERI tensor even for a
density-fitted mean field, as in the reference (built once by
mol.intor('int2e'), kernel `int2e`, and kept as the mean field's _eri),
and the spin-resolved f_xc per block of grid points:

  dmao_s = ao @ dm_s                      torch.matmul (cuBLAS)
  w f_xc per point, [aa, ab, ba, bb]      CUDA kernel `xc_fxc`
  orbital values aod @ C_s                torch.matmul (cuBLAS)
  P_t, H_st P_t per point and pair        CUDA kernel `xc_fxc_pairs`
  A[s, t] += P_s^T (H_st P_t)             torch.matmul (cuBLAS)

For a closed-shell reference the spectrum is the union of the restricted
singlet and triplet TDA spectra.
"""
import torch

from .. import ao2mo
from ..ops import kernels
from .rhf import hybrid_fraction, pair_step


def _spin_orbitals(mf):
    """([C_occ_s], [C_vir_s], [e_occ_s], [e_vir_s]) of both spins of an
    unrestricted mean field, or of a restricted one split into spins."""
    mo_c, mo_e, mo_o = mf.mo_coeff, mf.mo_energy, mf.mo_occ
    if mo_c.dim() == 2:
        mo_c = torch.stack([mo_c, mo_c])
        mo_e = torch.stack([mo_e, mo_e])
        mo_o = torch.stack([(mo_o > 0).to(mo_e.dtype),
                            (mo_o == 2).to(mo_e.dtype)])
    occs = [mo_o[s] > 0 for s in (0, 1)]
    return ([mo_c[s][:, o] for s, o in enumerate(occs)],
            [mo_c[s][:, ~o] for s, o in enumerate(occs)],
            [mo_e[s][o] for s, o in enumerate(occs)],
            [mo_e[s][~o] for s, o in enumerate(occs)])


def get_ab_uhf(mf):
    """(A (ntot, ntot), dims): the symmetrised A over the stacked (alpha
    ph, beta ph) space, dims its two block sizes."""
    cos, cvs, eos, evs = _spin_orbitals(mf)
    dims = [cos[s].shape[1] * cvs[s].shape[1] for s in (0, 1)]
    ntot = dims[0] + dims[1]
    hyb = hybrid_fraction(mf)
    eri = mf._get_eri()
    a = torch.zeros((ntot, ntot), dtype=eri.dtype, device=eri.device)
    offs = [0, dims[0]]
    for s in (0, 1):
        no, nv = cos[s].shape[1], cvs[s].shape[1]
        sl = slice(offs[s], offs[s] + dims[s])
        diag = (evs[s][None, :] - eos[s][:, None]).reshape(-1)
        oovv = ao2mo.general(eri, (cos[s], cos[s], cvs[s], cvs[s]))
        a[sl, sl] += torch.diag(diag) - hyb * oovv.permute(0, 2, 1, 3).reshape(
            dims[s], dims[s])
        for t in (0, 1):
            ovov = ao2mo.general(eri, (cos[s], cvs[s], cos[t], cvs[t]))
            a[sl, offs[t]:offs[t] + dims[t]] += ovov.reshape(dims[s], dims[t])
        del oovv, ovov
    if hasattr(mf, 'xc'):
        a += _fxc_ov_uks(mf, cos, cvs, dims)
    return 0.5 * (a + a.T), dims


def _fxc_ov_uks(mf, cos, cvs, dims):
    """The spin-blocked f_xc coupling over the stacked ph space (ntot,
    ntot), at the mean field's spin densities."""
    if mf.grids.coords is None:
        mf.grids.build()
    aod_blocks, weights = mf._numint.grid_ao(mf.mol, mf.grids, 1, 2)
    dm = mf.make_rdm1()
    if dm.dim() == 2:
        dm = torch.stack([0.5 * dm, 0.5 * dm])
    xc = mf.xc_obj
    ntot = dims[0] + dims[1]
    offs = [0, dims[0]]
    out = torch.zeros((ntot, ntot), dtype=dm.dtype, device=dm.device)
    for aod, w in zip(aod_blocks, weights):
        H = kernels.xc_fxc(aod, torch.matmul(aod[0], dm), w, xc)
        step = pair_step(w.shape[0], 12 * ntot, w.device)
        for i in range(0, w.shape[0], step):
            blk = aod[:, i:i + step]
            ps, hps = [], []
            for t in (0, 1):
                # H_at P_t and H_bt P_t: blocks t and 2 + t of [aa, ab, ba,
                # bb]
                P, HP = kernels.xc_fxc_pairs(torch.matmul(blk, cos[t]),
                                             torch.matmul(blk, cvs[t]),
                                             H[i:i + step], (t, 2 + t))
                ps.append(P.reshape(-1, dims[t]))
                hps.append(HP.reshape(2, -1, dims[t]))
            for s in (0, 1):
                for t in (0, 1):
                    out[offs[s]:offs[s] + dims[s],
                        offs[t]:offs[t] + dims[t]] += ps[s].T @ hps[t][s]
            del ps, hps, P, HP
    return out


class TDAUHF:
    """Dense TDA of UHF/UKS references."""

    nstates = 3
    conv_tol = 1e-8

    def __init__(self, mf):
        self._scf = mf
        self.mol = mf.mol
        self.e = None
        self.xy = None

    def kernel(self, nstates=None):
        """The nstates lowest excitation energies (numpy, Hartree); xy holds
        each state's (alpha, beta) amplitude vectors."""
        n = nstates or self.nstates
        a, dims = get_ab_uhf(self._scf)
        w, v = torch.linalg.eigh(a)
        self.e = w[:n].cpu().numpy()
        self.xy = [(v[:dims[0], i], v[dims[0]:, i]) for i in range(n)]
        return self.e

    run = kernel


TDAUKS = TDAUHF
