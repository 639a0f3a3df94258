"""Coupled-perturbed HF/KS linear-response solver.

Counterpart of pyscf_tpu/scf/cphf.py solve: a preconditioned conjugate
gradient on the symmetric (A+B) operator, one right-hand side after another,
on the host's loop; the batched solver of the nuclear Hessian is
hessian/rhf.py cphf_pcg."""
import torch


def solve(apb_matvec, hdiag, rhs, max_cycle=50, tol=1e-9):
    """Solve (A+B) z = rhs for each row of rhs (nrhs, n) by preconditioned
    CG: apb_matvec(z) applies the response matrix, hdiag (n,) is its
    diagonal (orbital-energy differences), the preconditioner. Returns the
    solutions stacked, (nrhs, n)."""
    rhs = torch.atleast_2d(torch.as_tensor(rhs))
    hdiag = torch.as_tensor(hdiag, device=rhs.device)
    out = []
    for b in rhs:
        z = b / hdiag
        r = b - torch.as_tensor(apb_matvec(z), device=rhs.device)
        p = r / hdiag
        rz = float(r @ (r / hdiag))
        for _ in range(max_cycle):
            if float(torch.linalg.norm(r)) < tol:
                break
            Ap = torch.as_tensor(apb_matvec(p), device=rhs.device)
            alpha = rz / float(p @ Ap)
            z = z + alpha * p
            r = r - alpha * Ap
            rz_new = float(r @ (r / hdiag))
            p = r / hdiag + (rz_new / rz) * p
            rz = rz_new
        out.append(z)
    return torch.stack(out)
