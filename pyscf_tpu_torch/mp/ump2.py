"""Unrestricted MP2.

Counterpart of pyscf_tpu/mp/ump2.py (UMP2: kernel, e_corr_os, e_corr_ss,
energy_scs) on the in-core ERI tensor: the (ia|jb) blocks of the alpha,
beta and mixed spins through ao2mo.general, and each block's sums through
one pass of the kernel `mp2_energy`, the same-spin blocks with their
exchange term and a factor 1/2, the opposite-spin block without exchange.
Like the JAX package, a density-fitted mean field's UMP2 uses the in-core
tensor too.
"""


class UMP2:
    def __init__(self, mf, frozen=0):
        self._scf = mf
        self.mol = mf.mol
        self.frozen = frozen or 0
        self.e_corr = None

    @property
    def e_tot(self):
        return float(self.e_corr) + float(self._scf.e_tot)

    def kernel(self):
        """(E_corr, None)."""
        from .. import ao2mo
        from ..ops import kernels
        mf = self._scf
        eri = mf._get_eri()
        occ = mf.mo_occ > 0
        eia, cos, cvs = [], [], []
        for s in range(2):
            c, e = mf.mo_coeff[s], mf.mo_energy[s]
            cos.append(c[:, occ[s]][:, self.frozen:])
            cvs.append(c[:, ~occ[s]])
            eia.append(e[occ[s]][self.frozen:, None] - e[~occ[s]][None, :])
        e_ss = 0.0
        for s in range(2):
            ovov = ao2mo.general(eri, (cos[s], cvs[s], cos[s], cvs[s]))
            _, direct, exch = kernels.mp2_energy(ovov, eia[s], eia[s],
                                                 with_t2=False)
            e_ss = e_ss + 0.5 * (direct - exch)
        ovov = ao2mo.general(eri, (cos[0], cvs[0], cos[1], cvs[1]))
        _, e_os, _ = kernels.mp2_energy(ovov, eia[0], eia[1], exchange=False,
                                        with_t2=False)
        self.e_corr = float(e_ss + e_os)
        self.e_corr_os = float(e_os)    # alpha-beta (opposite spin)
        self.e_corr_ss = float(e_ss)    # aa + bb (same spin)
        return self.e_corr, None

    def energy_scs(self, p_os=1.2, p_ss=1.0 / 3.0):
        """SCS-MP2 energy from the os/ss split (Grimme 2003); SOS with
        (1.3, 0); (1, 1) is plain UMP2."""
        if self.e_corr is None:
            self.kernel()
        return p_os * self.e_corr_os + p_ss * self.e_corr_ss

    run = kernel
