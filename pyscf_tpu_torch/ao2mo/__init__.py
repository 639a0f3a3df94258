"""AO -> MO integral transforms of the dense in-core ERI tensor.

Counterpart of pyscf_tpu/ao2mo/__init__.py (full, general, kernel,
restore): four chained contractions, one index at a time, each a cuBLAS
GEMM through torch.matmul on the tensor's own layout, so no permuted copy
of the (nao)^4 tensor is made. Each step's result replaces the last, so the
peak is the input and two intermediates (3 x 1.35 GB at benzene/def2-SVP
for `full`). Only the s1 (unpacked) layout exists.
"""
import torch


def _general(eri, c0, c1, c2, c3):
    n0, n1, n2, n3 = eri.shape
    k0, k1, k2, k3 = c0.shape[1], c1.shape[1], c2.shape[1], c3.shape[1]
    out = c0.T @ eri.reshape(n0, n1 * n2 * n3)                  # i q r s
    out = torch.matmul(c1.T, out.reshape(k0, n1, n2 * n3))       # i j r s
    out = torch.matmul(c2.T, out.reshape(k0 * k1, n2, n3))       # ij k s
    return (out @ c3).reshape(k0, k1, k2, k3)                    # ij k l


def _resolve_eri(eri_or_mol):
    if hasattr(eri_or_mol, 'intor'):
        return eri_or_mol.intor('int2e')
    return eri_or_mol


def full(eri_or_mol, mo_coeff, *args, **kwargs):
    """(ij|kl) in the MO basis mo_coeff (nao, nmo); takes an ERI tensor
    (nao, nao, nao, nao) or a Mole."""
    c = mo_coeff
    return _general(_resolve_eri(eri_or_mol), c, c, c, c)


def general(eri_or_mol, mo_coeffs, *args, **kwargs):
    """(ij|kl) with each index in its own orbital set, mo_coeffs four
    (nao, k) matrices."""
    return _general(_resolve_eri(eri_or_mol), *mo_coeffs)


def kernel(eri_or_mol, mo_coeffs, *args, **kwargs):
    if isinstance(mo_coeffs, (tuple, list)):
        return general(eri_or_mol, mo_coeffs)
    return full(eri_or_mol, mo_coeffs)


def restore(symmetry, eri, nao):
    """Symmetry-pack conversion: only s1 (the full tensor)."""
    if symmetry in (1, '1', 's1'):
        return eri.reshape(nao, nao, nao, nao)
    raise NotImplementedError('only s1 supported')
