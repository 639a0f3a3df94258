"""Closed-shell CCSD.

Counterpart of pyscf_tpu/cc/ccsd.py (_make_eris, energy, _vvvv_tau_df,
_vvvv_tau_df_dressed, update_amps, update_amps_dfb, CCSD): the
spin-adapted closed-shell amplitude equations of Hirata et al., JCP 120,
2581 (2004), Eqs. (35)-(45), term by term as in the JAX package, each
contraction a cuBLAS GEMM through torch.einsum or torch.matmul; only the
final divide by the denominators is elementwise. The energy of every
cycle is one pass of the kernel `mp2_energy` over (ia|jb) with x = tau.

The MO blocks come from the in-core ERI tensor (ao2mo.full), or with a
density-fitted mean field from the factor B: then (vv|vv) is never formed
and the ladder sum_cd (ac|bd) tau_ijcd is accumulated over aux chunks of
VVVV_AUX_CHUNK from B_vv, two GEMMs per chunk; above OVVV_MAX_ELEMS the
o v^3 block is not built either and every (ov|vv) term is contracted from
B_ov and B_vv (update_amps_dfb). The in-core (vv|vv) is permuted once into
the ladder's GEMM operand, so the ladder is one GEMM per cycle.

DIIS extrapolates the amplitudes on the device (lib/diis.py). Left out:
EOM, the chkfile dump and restore, and the gradients (ROADMAP).
"""
import time
from types import SimpleNamespace

import torch

from ..lib.diis import DIIS
from ..ops.integrals.j3c import sync

VVVV_AUX_CHUNK = 32     # aux functions per ladder GEMM pair
OVVV_MAX_ELEMS = 2.0e8  # DF runs ovvv-free above this nocc*nvir^3


def ladder_operand(vvvv):
    """(vv|vv) (v, v, v, v) as the (v^2, v^2) operand M[cd, ab] =
    (ac|bd) of the ladder GEMM tau[ij, cd] @ M; made once per CCSD."""
    v = vvvv.shape[0]
    return vvvv.permute(1, 3, 0, 2).reshape(v * v, v * v).contiguous()


def _make_eris(mycc):
    """The MO blocks in chemists' notation, (ij|kl) = oooo[i,j,k,l], from
    the mean field: in-core with `vvvv` the ladder operand, or from its DF
    factor with B_ov and B_vv in place of (vv|vv)."""
    mf = mycc._scf
    occ = mycc.mo_occ > 0
    frozen = mycc.frozen
    co = mycc.mo_coeff[:, occ][:, frozen:]
    cv = mycc.mo_coeff[:, ~occ]
    nocc, nvir = co.shape[1], cv.shape[1]
    e_mo = mf.mo_energy
    mo_energy = torch.cat([e_mo[occ][frozen:], e_mo[~occ]])
    common = dict(mo_energy=mo_energy, nocc=nocc)
    if getattr(mf, 'with_df', None) is not None:
        B = mf.with_df.cderi
        naux = B.shape[0]
        Bo = torch.matmul(co.T, B)                       # (naux, o, nao)
        Boo = torch.matmul(Bo, co)
        Bov = torch.matmul(Bo, cv)
        Bvv = torch.matmul(torch.matmul(cv.T, B), cv)
        del Bo
        Boo_f = Boo.reshape(naux, nocc * nocc)
        Bov_f = Bov.reshape(naux, nocc * nvir)
        ovov = (Bov_f.T @ Bov_f).reshape(nocc, nvir, nocc, nvir)
        ovvv = None
        if nocc * nvir ** 3 <= OVVV_MAX_ELEMS:
            ovvv = (Bov_f.T @ Bvv.reshape(naux, nvir * nvir)).reshape(
                nocc, nvir, nvir, nvir)
        return SimpleNamespace(
            oooo=(Boo_f.T @ Boo_f).reshape(nocc, nocc, nocc, nocc),
            ooov=(Boo_f.T @ Bov_f).reshape(nocc, nocc, nocc, nvir),
            oovv=(Boo_f.T @ Bvv.reshape(naux, nvir * nvir)).reshape(
                nocc, nocc, nvir, nvir),
            ovov=ovov, ovvo=ovov.permute(0, 1, 3, 2).contiguous(),
            ovvv=ovvv, vvvv=None, Bov=Bov, Bvv=Bvv, **common)
    from .. import ao2mo
    eri = ao2mo.full(mf._get_eri(), torch.cat([co, cv], dim=1))
    o, v = slice(0, nocc), slice(nocc, None)
    eris = SimpleNamespace(
        oooo=eri[o, o, o, o].contiguous(), ooov=eri[o, o, o, v].contiguous(),
        oovv=eri[o, o, v, v].contiguous(), ovov=eri[o, v, o, v].contiguous(),
        ovvo=eri[o, v, v, o].contiguous(), ovvv=eri[o, v, v, v].contiguous(),
        Bov=None, Bvv=None, **common)
    vvvv = eri[v, v, v, v]
    del eri
    eris.vvvv = ladder_operand(vvvv)
    return eris


def energy(t1, t2, ovov):
    """RCCSD correlation energy (canonical orbitals: fov = 0): 2 (ia|jb)
    tau_ijab - (ib|ja) tau_ijab, by the kernel `mp2_energy`."""
    from ..ops import kernels
    tau = (t2 + torch.einsum('ia,jb->ijab', t1, t1)).contiguous()
    _, direct, exch = kernels.mp2_energy(ovov, tau=tau)
    return 2.0 * direct - exch


def _chunks(naux):
    return [slice(p0, min(p0 + VVVV_AUX_CHUNK, naux))
            for p0 in range(0, naux, VVVV_AUX_CHUNK)]


def _ladder_tmp(Bx, tau3):
    """tmp[ij, a, (x, d)] = sum_c B[x,a,c] tau[i,j,c,d] for one aux chunk
    Bx (X, v, v); tau3 = tau (o^2, v, v). One batched GEMM."""
    X, v, _ = Bx.shape
    tmp = torch.matmul(Bx.permute(1, 0, 2).reshape(v * X, v), tau3)
    return tmp.reshape(tau3.shape[0] * v, X * v)


def _vvvv_tau_df(Bvv, tau):
    """sum_cd (ac|bd) tau_ijcd from B_vv (naux, v, v), no (vv|vv) formed:
    per aux chunk of VVVV_AUX_CHUNK a (o^2 v, X v) intermediate and two
    GEMMs."""
    no, _, v, _ = tau.shape
    tau3 = tau.reshape(no * no, v, v)
    out = torch.zeros((no * no * v, v), dtype=tau.dtype, device=tau.device)
    for c in _chunks(Bvv.shape[0]):
        Bx = Bvv[c]
        tmp = _ladder_tmp(Bx, tau3)
        out += tmp @ Bx.permute(0, 2, 1).reshape(-1, v)
    return out.reshape(no, no, v, v)


def _vvvv_tau_df_dressed(Bvv, G, tau):
    """The ladder with the two tau.(ov|vv).t1 ring terms from the same
    chunk intermediates tmp[x,i,j,a,d] = sum_c B[x,a,c] tau[i,j,c,d]:
      + sum_xd (B - G)[x,b,d] tmp[x,i,j,a,d]
      - sum_xc G[x,a,c] tmp[x,j,i,b,c]
    with G[x,b,d] = sum_k t1[k,b] B_ov[x,k,d]; no o v^3 tensor is formed."""
    no, _, v, _ = tau.shape
    tau3 = tau.reshape(no * no, v, v)
    out = torch.zeros((no * no * v, v), dtype=tau.dtype, device=tau.device)
    out2 = torch.zeros_like(out)        # [j, i, b, a]
    for c in _chunks(Bvv.shape[0]):
        Bx, Gx = Bvv[c], G[c]
        tmp = _ladder_tmp(Bx, tau3)
        out += tmp @ (Bx - Gx).permute(0, 2, 1).reshape(-1, v)
        out2 += tmp @ Gx.permute(0, 2, 1).reshape(-1, v)
    return (out.reshape(no, no, v, v)
            - out2.reshape(no, no, v, v).permute(1, 0, 3, 2))


def _kappa(t1, t2, ovov):
    """Foo, Fvv, Fov (Eqs. 37-39)."""
    Foo = (2.0 * torch.einsum('kcld,ilcd->ki', ovov, t2)
           - torch.einsum('kdlc,ilcd->ki', ovov, t2)
           + 2.0 * torch.einsum('kcld,ic,ld->ki', ovov, t1, t1)
           - torch.einsum('kdlc,ic,ld->ki', ovov, t1, t1))
    Fvv = (-2.0 * torch.einsum('kcld,klad->ac', ovov, t2)
           + torch.einsum('kdlc,klad->ac', ovov, t2)
           - 2.0 * torch.einsum('kcld,ka,ld->ac', ovov, t1, t1)
           + torch.einsum('kdlc,ka,ld->ac', ovov, t1, t1))
    Fov = (2.0 * torch.einsum('kcld,ld->kc', ovov, t1)
           - torch.einsum('kdlc,ld->kc', ovov, t1))
    return Foo, Fvv, Fov


def _divide(t1new, t2new, mo_energy, nocc):
    eia = mo_energy[:nocc, None] - mo_energy[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    return t1new / eia, t2new / eijab


def update_amps(t1, t2, eris):
    """One CCSD iteration, Hirata Eqs. (35)-(45), closed shell; the ladder
    from eris.vvvv (the ladder operand) or, when that is None, from the
    aux chunks of eris.Bvv."""
    oooo, ooov, oovv = eris.oooo, eris.ooov, eris.oovv
    ovov, ovvo, ovvv = eris.ovov, eris.ovvo, eris.ovvv
    nocc, nvir = t1.shape

    Foo, Fvv, Fov = _kappa(t1, t2, ovov)

    # lambda intermediates (Eqs. 40-41); ovoo = (ov|oo) from (oo|ov)
    ovoo = ooov.permute(2, 3, 0, 1)
    Loo = Foo + (2.0 * torch.einsum('lcki,lc->ki', ovoo, t1)
                 - torch.einsum('kcli,lc->ki', ovoo, t1))
    Lvv = Fvv + (2.0 * torch.einsum('kdac,kd->ac', ovvv, t1)
                 - torch.einsum('kcad,kd->ac', ovvv, t1))

    # chi intermediates (Eqs. 42-45)
    Woooo = (torch.einsum('lcki,jc->klij', ovoo, t1)
             + torch.einsum('kclj,ic->klij', ovoo, t1)
             + torch.einsum('kcld,ijcd->klij', ovov, t2)
             + torch.einsum('kcld,ic,jd->klij', ovov, t1, t1)
             + oooo.permute(0, 2, 1, 3))
    Wvoov = (torch.einsum('kcad,id->akic', ovvv, t1)
             - torch.einsum('kcli,la->akic', ovoo, t1)
             + ovvo.permute(2, 0, 3, 1)
             - 0.5 * torch.einsum('ldkc,ilda->akic', ovov, t2)
             - 0.5 * torch.einsum('lckd,ilad->akic', ovov, t2)
             - torch.einsum('ldkc,id,la->akic', ovov, t1, t1)
             + torch.einsum('ldkc,ilad->akic', ovov, t2))
    Wvovo = (torch.einsum('kdac,id->akci', ovvv, t1)
             - torch.einsum('lcki,la->akci', ovoo, t1)
             + oovv.permute(2, 0, 3, 1)
             - 0.5 * torch.einsum('lckd,ilda->akci', ovov, t2)
             - torch.einsum('lckd,id,la->akci', ovov, t1, t1))

    # T1 (Eq. 35), canonical orbitals: fov = 0
    t1new = (torch.einsum('ac,ic->ia', Fvv, t1)
             - torch.einsum('ki,ka->ia', Foo, t1)
             + 2.0 * torch.einsum('kc,kica->ia', Fov, t2)
             - torch.einsum('kc,ikca->ia', Fov, t2)
             + torch.einsum('kc,ic,ka->ia', Fov, t1, t1)
             + 2.0 * torch.einsum('kcai,kc->ia', ovvo, t1)
             - torch.einsum('kiac,kc->ia', oovv, t1)
             + 2.0 * torch.einsum('kdac,ikcd->ia', ovvv, t2)
             - torch.einsum('kcad,ikcd->ia', ovvv, t2)
             + 2.0 * torch.einsum('kdac,kd,ic->ia', ovvv, t1, t1)
             - torch.einsum('kcad,kd,ic->ia', ovvv, t1, t1)
             - 2.0 * torch.einsum('kilc,klac->ia', ooov, t2)
             + torch.einsum('likc,klac->ia', ooov, t2)
             - 2.0 * torch.einsum('kilc,lc,ka->ia', ooov, t1, t1)
             + torch.einsum('likc,lc,ka->ia', ooov, t1, t1))

    # T2 (Eq. 36)
    tau = t2 + torch.einsum('ia,jb->ijab', t1, t1)
    t2new = ovov.permute(0, 2, 1, 3)
    t2new = t2new + torch.einsum('klij,klab->ijab', Woooo, tau)
    # the ladder Wvvvv.tau: the t1 corrections to Wvvvv are contracted
    # against tau directly, so only the bare (ac|bd).tau needs vvvv or B
    tmp = torch.einsum('kdac,ijcd->kaij', ovvv, tau)
    t2new = t2new - torch.einsum('kaij,kb->ijab', tmp, t1)
    tmp = torch.einsum('kcbd,ijcd->kbij', ovvv, tau)
    t2new = t2new - torch.einsum('kbij,ka->ijab', tmp, t1)
    if eris.vvvv is None:
        t2new = t2new + _vvvv_tau_df(eris.Bvv, tau)
    else:
        t2new = t2new + (tau.reshape(nocc * nocc, nvir * nvir)
                         @ eris.vvvv).reshape(nocc, nocc, nvir, nvir)
    t2new = t2new + _t2_rings(t1, t2, Lvv, Loo, Wvoov, Wvovo)
    tmp2 = (ovvv.permute(1, 3, 0, 2)
            - torch.einsum('kibc,ka->abic', oovv, t1))
    tmp = torch.einsum('abic,jc->ijab', tmp2, t1)
    t2new = t2new + tmp + tmp.permute(1, 0, 3, 2)
    t2new = t2new - _t2_ooov_t1(t1, ooov, ovvo)
    return _divide(t1new, t2new, eris.mo_energy, nocc)


def _t2_rings(t1, t2, Lvv, Loo, Wvoov, Wvovo):
    """The Lvv, Loo and W.t2 ring terms of Eq. 36, each with its (ij)(ab)
    transpose."""
    tmp = torch.einsum('ac,ijcb->ijab', Lvv, t2)
    out = tmp + tmp.permute(1, 0, 3, 2)
    tmp = torch.einsum('ki,kjab->ijab', Loo, t2)
    out = out - tmp - tmp.permute(1, 0, 3, 2)
    tmp = (2.0 * torch.einsum('akic,kjcb->ijab', Wvoov, t2)
           - torch.einsum('akci,kjcb->ijab', Wvovo, t2))
    out = out + tmp + tmp.permute(1, 0, 3, 2)
    tmp = torch.einsum('akic,kjbc->ijab', Wvoov, t2)
    out = out - tmp - tmp.permute(1, 0, 3, 2)
    tmp = torch.einsum('bkci,kjac->ijab', Wvovo, t2)
    return out - tmp - tmp.permute(1, 0, 3, 2)


def _t2_ooov_t1(t1, ooov, ovvo):
    """The (ooov + ovvo.t1).t1 term of Eq. 36 with its transpose."""
    tmp2 = (ooov.permute(3, 1, 2, 0)
            + torch.einsum('kcai,jc->akij', ovvo, t1))
    tmp = torch.einsum('akij,kb->ijab', tmp2, t1)
    return tmp + tmp.permute(1, 0, 3, 2)


def update_amps_dfb(t1, t2, eris):
    """One CCSD iteration with every (ov|vv) contraction factorised through
    B_ov (naux, o, v) and B_vv (naux, v, v): no o v^3 tensor is formed.
    The same equations as update_amps; (kd|ac) = sum_x B_ov[x,k,d]
    B_vv[x,a,c] reassociates each term."""
    oooo, ooov, oovv = eris.oooo, eris.ooov, eris.oovv
    ovov, ovvo = eris.ovov, eris.ovvo
    Bov, Bvv = eris.Bov, eris.Bvv

    Foo, Fvv, Fov = _kappa(t1, t2, ovov)

    ovoo = ooov.permute(2, 3, 0, 1)
    Loo = Foo + (2.0 * torch.einsum('lcki,lc->ki', ovoo, t1)
                 - torch.einsum('kcli,lc->ki', ovoo, t1))
    # Lvv's (ov|vv) part: 2 (kd|ac) t1_kd - (kc|ad) t1_kd
    s_aux = torch.einsum('xkd,kd->x', Bov, t1)
    lvv1 = torch.einsum('x,xac->ac', s_aux, Bvv)
    w_ak = torch.einsum('xad,kd->xak', Bvv, t1)
    lvv2 = torch.einsum('xak,xkc->ac', w_ak, Bov)
    lvv_t1 = 2.0 * lvv1 - lvv2
    Lvv = Fvv + lvv_t1

    Woooo = (torch.einsum('lcki,jc->klij', ovoo, t1)
             + torch.einsum('kclj,ic->klij', ovoo, t1)
             + torch.einsum('kcld,ijcd->klij', ovov, t2)
             + torch.einsum('kcld,ic,jd->klij', ovov, t1, t1)
             + oooo.permute(0, 2, 1, 3))
    # (kc|ad) t1_id -> akic
    Bvt = torch.einsum('xad,id->xai', Bvv, t1)
    wvoov1 = torch.einsum('xai,xkc->akic', Bvt, Bov)
    Wvoov = (wvoov1
             - torch.einsum('kcli,la->akic', ovoo, t1)
             + ovvo.permute(2, 0, 3, 1)
             - 0.5 * torch.einsum('ldkc,ilda->akic', ovov, t2)
             - 0.5 * torch.einsum('lckd,ilad->akic', ovov, t2)
             - torch.einsum('ldkc,id,la->akic', ovov, t1, t1)
             + torch.einsum('ldkc,ilad->akic', ovov, t2))
    # (kd|ac) t1_id -> akci
    Bot = torch.einsum('xkd,id->xki', Bov, t1)
    wvovo1 = torch.einsum('xki,xac->akci', Bot, Bvv)
    Wvovo = (wvovo1
             - torch.einsum('lcki,la->akci', ovoo, t1)
             + oovv.permute(2, 0, 3, 1)
             - 0.5 * torch.einsum('lckd,ilda->akci', ovov, t2)
             - torch.einsum('lckd,id,la->akci', ovov, t1, t1))

    # T1: the (ov|vv).t2 terms via the factors
    u1 = torch.einsum('xkd,ikcd->xic', Bov, t2)
    t1_o1 = torch.einsum('xic,xac->ia', u1, Bvv)      # (kd|ac) t2_ikcd
    u2 = torch.einsum('xkc,ikcd->xid', Bov, t2)
    t1_o2 = torch.einsum('xid,xad->ia', u2, Bvv)      # (kc|ad) t2_ikcd
    t1new = (torch.einsum('ac,ic->ia', Fvv, t1)
             - torch.einsum('ki,ka->ia', Foo, t1)
             + 2.0 * torch.einsum('kc,kica->ia', Fov, t2)
             - torch.einsum('kc,ikca->ia', Fov, t2)
             + torch.einsum('kc,ic,ka->ia', Fov, t1, t1)
             + 2.0 * torch.einsum('kcai,kc->ia', ovvo, t1)
             - torch.einsum('kiac,kc->ia', oovv, t1)
             + 2.0 * t1_o1 - t1_o2
             + torch.einsum('ac,ic->ia', lvv_t1, t1)
             - 2.0 * torch.einsum('kilc,klac->ia', ooov, t2)
             + torch.einsum('likc,klac->ia', ooov, t2)
             - 2.0 * torch.einsum('kilc,lc,ka->ia', ooov, t1, t1)
             + torch.einsum('likc,lc,ka->ia', ooov, t1, t1))

    # T2
    tau = t2 + torch.einsum('ia,jb->ijab', t1, t1)
    t2new = ovov.permute(0, 2, 1, 3)
    t2new = t2new + torch.einsum('klij,klab->ijab', Woooo, tau)
    # the ladder and the two tau.(ov|vv).t1 terms in one dressed aux loop
    G = torch.einsum('xkd,kb->xbd', Bov, t1)
    t2new = t2new + _vvvv_tau_df_dressed(Bvv, G, tau)
    t2new = t2new + _t2_rings(t1, t2, Lvv, Loo, Wvoov, Wvovo)
    # (ia|cb) t1_jc via the factors
    w_jb = torch.einsum('xcb,jc->xjb', Bvv, t1)
    tmp = torch.einsum('xia,xjb->ijab', Bov, w_jb)
    tmp = tmp - torch.einsum('kibc,ka,jc->abij', oovv, t1,
                             t1).permute(2, 3, 0, 1)
    t2new = t2new + tmp + tmp.permute(1, 0, 3, 2)
    t2new = t2new - _t2_ooov_t1(t1, ooov, ovvo)
    return _divide(t1new, t2new, eris.mo_energy, t1.shape[0])


class CCSD:
    conv_tol = 1e-7
    conv_tol_normt = 1e-6
    max_cycle = 50
    diis_space = 6

    def __init__(self, mf, frozen=0, mo_coeff=None, mo_occ=None):
        self._scf = mf
        self.mol = mf.mol
        self.verbose = mf.mol.verbose
        self.frozen = frozen or 0
        self.mo_coeff = mo_coeff if mo_coeff is not None else mf.mo_coeff
        self.mo_occ = mo_occ if mo_occ is not None else mf.mo_occ
        self.converged = False
        self.e_corr = None
        self.t1 = None
        self.t2 = None
        self.cycles = 0
        self._eris = None
        # seconds of the last kernel(): 'eris', 'init', and 'cycles', one
        # entry per cycle, each ended by a device synchronize
        self.timings = {}

    @property
    def nocc(self):
        return int((self.mo_occ > 0).sum()) - self.frozen

    @property
    def e_tot(self):
        return float(self.e_corr) + float(self._scf.e_tot)

    def ao2mo(self):
        return _make_eris(self)

    def init_amps(self, eris):
        """(E_MP2, t1 = 0, t2 the MP2 amplitudes (o, o, v, v)), the
        amplitudes and the energy from one `mp2_energy` pass."""
        from ..ops import kernels
        nocc = eris.nocc
        mo_e = eris.mo_energy
        eia = mo_e[:nocc, None] - mo_e[None, nocc:]
        t2, direct, exch = kernels.mp2_energy(eris.ovov, eia, eia)
        t1 = torch.zeros_like(eia)
        return float(2.0 * direct - exch), t1, t2.permute(0, 2, 1, 3)\
            .contiguous()

    def kernel(self, t1=None, t2=None):
        """(E_corr, t1, t2): DIIS-accelerated cycles until |dE| <
        conv_tol and |t1new - t1| + |t2new - t2| < conv_tol_normt, or
        max_cycle; `converged` says which."""
        dev = self.mol.device
        t0 = time.perf_counter()
        eris = self._eris = self.ao2mo()
        sync(dev)
        t1_ = time.perf_counter()
        emp2, t1_mp2, t2_mp2 = self.init_amps(eris)
        if t1 is None or t2 is None:
            t1, t2 = t1_mp2, t2_mp2
        sync(dev)
        timings = {'eris': t1_ - t0, 'init': time.perf_counter() - t1_,
                   'cycles': []}
        if self.verbose >= 4:
            print(f'MP2 initial guess E_corr = {emp2:.12f}')
        step = update_amps_dfb if eris.ovvv is None else update_amps
        diis = DIIS(self.diis_space)
        e_last = emp2
        e_corr = emp2
        conv = False
        ncyc = 0
        for it in range(self.max_cycle):
            tc = time.perf_counter()
            t1new, t2new = step(t1, t2, eris)
            normt = torch.linalg.norm(t1new - t1) + torch.linalg.norm(
                t2new - t2)
            t1, t2 = diis.update((t1new, t2new), (t1new - t1, t2new - t2))
            e_corr, normt = torch.stack([energy(t1, t2, eris.ovov),
                                         normt]).tolist()
            timings['cycles'].append(time.perf_counter() - tc)
            de = e_corr - e_last
            e_last = e_corr
            ncyc = it + 1
            if self.verbose >= 4:
                print(f'cycle = {ncyc}  E_corr(CCSD) = {e_corr:.12f}  '
                      f'dE = {de:.3g}  norm(t1,t2) = {normt:.3g}')
            if abs(de) < self.conv_tol and normt < self.conv_tol_normt:
                conv = True
                break
        self.converged = conv
        self.cycles = ncyc
        self.e_corr = e_corr
        self.t1, self.t2 = t1, t2
        self.timings = timings
        return self.e_corr, t1, t2

    run = kernel

    def ccsd(self, t1=None, t2=None):
        return self.kernel(t1, t2)

    def ccsd_t(self, t1=None, t2=None):
        """E_(T) of the converged amplitudes (or of t1, t2 when given)."""
        from .ccsd_t import kernel as t_kernel
        return t_kernel(self, self._eris,
                        self.t1 if t1 is None else t1,
                        self.t2 if t2 is None else t2)


RCCSD = CCSD
