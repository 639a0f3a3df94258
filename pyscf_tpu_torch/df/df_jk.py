"""Density-fitted J/K builds as GEMMs on the DF factor B (naux, nao, nao).

Counterpart of pyscf_tpu/df/df_jk.py (get_jk, density_fit) and of the DF
branch of RHF._fused_veff (pyscf_tpu/scf/hf.py:677-695):
    J_ij = B[P,ij] (B[P,kl] dm_lk)
    K_ij = B[P,il] dm_lk B[P,kj]      or  sum_P (B C_occ)(B C_occ)^T
The contractions are library matmuls (cuBLAS on the card). _bmo gives the
MO blocks of B for the TDA/TDDFT response (pyscf_tpu/df/df_jk.py _bmo).
"""
import torch



def _bmo(B, ca, cb):
    """MO blocks of the whitened factor, (naux, ka, kb) = B[P] in the
    orbitals ca (nao, ka) and cb (nao, kb), in B's own aux order (as the
    DF cache keeps it); two GEMMs."""
    naux, nao, _ = B.shape
    Bb = (B.reshape(naux * nao, nao) @ cb).reshape(naux, nao, -1)
    return torch.matmul(ca.T, Bb)


def j_from_dm(B, dm):
    naux, nao, _ = B.shape
    Bf = B.reshape(naux, nao * nao)
    rho = Bf @ dm.T.reshape(-1)
    return (rho @ Bf).reshape(nao, nao)


def k_from_dm(B, dm):
    naux, nao, _ = B.shape
    Bd = B @ dm                                       # (P, i, k)
    return Bd.permute(1, 0, 2).reshape(nao, naux * nao) \
        @ B.reshape(naux * nao, nao)


def k_from_mo(B, co):
    """K from occupied orbitals co (already scaled by sqrt(occupation))."""
    naux, nao, _ = B.shape
    Bo = (B.reshape(naux * nao, nao) @ co).reshape(naux, nao, -1)
    X = Bo.permute(1, 0, 2).reshape(nao, -1)
    return X @ X.T


def get_jk(dfobj, dm, with_j=True, with_k=True, mo_coeff_occ=None):
    """(vj, vk) of one density; with mo_coeff_occ, K takes the occupied
    orbital path. A flag set to False gives None in its place."""
    B = dfobj.cderi
    vj = j_from_dm(B, dm) if with_j else None
    vk = None
    if with_k:
        vk = (k_from_dm(B, dm) if mo_coeff_occ is None
              else k_from_mo(B, mo_coeff_occ))
    return vj, vk


def density_fit(mf, auxbasis=None):
    """Attach a DF engine to a mean-field object."""
    from .df import DF
    mf.with_df = DF(mf.mol, auxbasis)
    return mf
