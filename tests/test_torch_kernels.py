"""The CUDA kernels against their plain PyTorch twins on the card.

Marked `gpu`: a CUDA kernel has no interpret mode, so these tests skip
where torch finds no CUDA device, and run on a machine with an NVIDIA GPU
and nvcc (python -m pytest tests/test_torch_kernels.py -m gpu)."""
import pytest
import torch

import pyscf_tpu_torch as tpt
from pyscf_tpu_torch import refs
from pyscf_tpu_torch.df.addons import make_auxmol
from pyscf_tpu_torch.ops import kernels
from pyscf_tpu_torch.ops.integrals import int1e, j3c

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def water():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    mol = tpt.M(atom=refs.WATER, basis='def2-svp', device='cuda')
    return mol, make_auxmol(mol)


def test_int1e_stv(water):
    mol, _ = water
    zr = torch.as_tensor(mol.coords, device='cuda')
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device='cuda')
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int1e_stv(la, lb, *p, zr, zq)
        ref = int1e.class_stv(la, lb, *p, zr, zq)
        assert torch.max(torch.abs(got - ref)) < 1e-12


def test_int3c2e(water):
    mol, auxmol = water
    aux = j3c.aux_tables(auxmol)
    for (la, lb), (_, p) in j3c.screened_pairs(mol).items():
        got = kernels.int3c2e(la, lb, *p, aux)
        ref = j3c.int3c2e_plain(la, lb, *p, aux)
        assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_int2c2e(water):
    _, auxmol = water
    aux = j3c.aux_tables(auxmol)
    got, ref = kernels.int2c2e(aux), j3c.int2c2e_plain(aux)
    assert torch.max(torch.abs(got - ref)) <= 1e-12 * ref.abs().max()


def test_df_rhf_on_card_launches_every_kernel(water):
    kernels.reset_launches()
    mol = tpt.M(atom=refs.WATER, basis='cc-pvdz', device='cuda')
    mf = mol.RHF().density_fit()
    mf.conv_tol = 1e-10
    e = mf.kernel()
    assert mf.converged
    assert abs(e - refs.E_WATER_DF_RHF_CCPVDZ) < 1e-8
    assert all(n > 0 for n in kernels.launches().values())
