"""Restricted MP2.

Counterpart of pyscf_tpu/mp/mp2.py (MP2/RMP2: kernel, energy_scs,
make_rdm1, make_fno, get_ovov): (ia|jb) from the in-core ERI tensor
through ao2mo.general, or from the mean field's DF factor B as
sum_P B[P,ia] B[P,jb] (one GEMM); the amplitudes and the pair-energy sums
are one pass of the kernel `mp2_energy` (csrc/mp2_energy.cu), whose plain
twin is `mp2_energy_plain`. `frozen` is the number of lowest occupied
orbitals left out, an integer as in the JAX package. The gradients are not
ported.
"""
import numpy as np
import torch


def mp2_energy_plain(ovov, eia1, eia2, tau=None, exchange=True,
                     with_t2=True):
    """The plain twin of kernel `mp2_energy` (ops/kernels.py): (t2 or None,
    direct, exchange or None), as in pyscf_tpu/mp/mp2.py:_emp2_from_ovov."""
    t2 = None
    if tau is None:
        t2 = ovov / (eia1[:, :, None, None] + eia2[None, None, :, :])
        x = t2
    else:
        x = tau.permute(0, 2, 1, 3)
    direct = torch.einsum('iajb,iajb->', ovov, x)
    exch = torch.einsum('iajb,ibja->', ovov, x) if exchange else None
    return (t2 if with_t2 else None), direct, exch


def _bmo(B, ca, cb):
    """(P|ab) = C_a^T B[P] C_b for every aux function P."""
    return torch.matmul(torch.matmul(ca.T, B), cb)


class MP2:
    def __init__(self, mf, frozen=0, mo_coeff=None, mo_occ=None):
        self._scf = mf
        self.mol = mf.mol
        self.frozen = frozen or 0
        self.mo_coeff = mo_coeff if mo_coeff is not None else mf.mo_coeff
        self.mo_occ = mo_occ if mo_occ is not None else mf.mo_occ
        self.mo_energy = mf.mo_energy
        self.e_corr = None
        self.t2 = None
        self.with_df = getattr(mf, 'with_df', None)

    @property
    def nocc(self):
        return int((self.mo_occ > 0).sum()) - self.frozen

    @property
    def e_tot(self):
        return float(self.e_corr) + float(self._scf.e_tot)

    def _orbitals(self):
        """(occupied coefficients less the frozen, virtual coefficients,
        eia = e_i - e_a)."""
        occ = self.mo_occ > 0
        co = self.mo_coeff[:, occ][:, self.frozen:]
        cv = self.mo_coeff[:, ~occ]
        e = self.mo_energy
        eia = e[occ][self.frozen:, None] - e[~occ][None, :]
        return co, cv, eia

    def get_ovov(self):
        """(ia|jb) (nocc, nvir, nocc, nvir)."""
        co, cv, _ = self._orbitals()
        if self.with_df is not None:
            Bov = _bmo(self.with_df.cderi, co, cv)
            naux, no, nv = Bov.shape
            Bf = Bov.reshape(naux, no * nv)
            return (Bf.T @ Bf).reshape(no, nv, no, nv)
        from .. import ao2mo
        return ao2mo.general(self._scf._get_eri(), (co, cv, co, cv))

    def kernel(self):
        """(E_corr, t2 (nocc, nvir, nocc, nvir))."""
        from ..ops import kernels
        _, _, eia = self._orbitals()
        t2, direct, exch = kernels.mp2_energy(self.get_ovov(), eia, eia)
        self.e_corr = float(2.0 * direct - exch)
        self.t2 = t2
        return self.e_corr, t2

    run = kernel

    def make_rdm1(self, t2=None):
        """MP2 1-RDM without orbital relaxation, in the MO basis."""
        t2 = t2 if t2 is not None else self.t2
        dvv = (2 * torch.einsum('iajb,icjb->ac', t2, t2)
               - torch.einsum('iajb,ibjc->ac', t2, t2))
        doo = -(2 * torch.einsum('iajb,kajb->ik', t2, t2)
                - torch.einsum('iajb,kbja->ik', t2, t2))
        nocc, nvir = t2.shape[0], t2.shape[1]
        dm = torch.zeros((nocc + nvir, nocc + nvir), dtype=t2.dtype,
                         device=t2.device)
        dm[:nocc, :nocc] = doo + 2 * torch.eye(nocc, dtype=t2.dtype,
                                               device=t2.device)
        dm[nocc:, nocc:] = dvv
        return dm

    def energy_scs(self, p_os=1.2, p_ss=1.0 / 3.0):
        """Spin-component-scaled MP2 (Grimme 2003: 1.2 os + 1/3 ss);
        SOS-MP2 with (1.3, 0.0); (1, 1) is plain MP2."""
        from ..ops import kernels
        _, _, eia = self._orbitals()
        _, direct, exch = kernels.mp2_energy(self.get_ovov(), eia, eia,
                                             with_t2=False)
        return float(p_os * direct + p_ss * (direct - exch))

    def make_fno(self, thresh=1e-6, nvir_act=None):
        """Frozen natural orbitals of the virtual space: (nvir kept, the
        (nao, nmo) coefficients with the virtual block rotated to the
        natural orbitals of the MP2 virtual density, largest occupation
        first), as numpy."""
        if self.t2 is None:
            self.kernel()
        t2 = self.t2
        dvv = (2 * torch.einsum('iajb,icjb->ac', t2, t2)
               - torch.einsum('iajb,ibjc->ac', t2, t2)).cpu().numpy() * 2.0
        w, v = np.linalg.eigh(0.5 * (dvv + dvv.T))
        w, v = w[::-1], v[:, ::-1]
        if nvir_act is None:
            nvir_act = max(1, int(np.sum(w > thresh)))
        occ = (self.mo_occ > 0).cpu().numpy()
        c = self.mo_coeff.cpu().numpy()
        return nvir_act, np.hstack([c[:, occ], c[:, ~occ] @ v])


RMP2 = MP2
