"""Geometry optimisation in redundant internal coordinates.

Counterpart of pyscf_tpu/geomopt/internal.py:18-167: bonds, angles and
dihedrals detected from the Bragg radii, the Wilson B matrix as the
Jacobian of the coordinate functions (torch.func.jacrev here, jax.jacobian
there), and a BFGS quasi-Newton in the redundant q space with iterative
back-transformation of each step. This is host bookkeeping on an (nq, 3N)
matrix of about a hundred rows: q_func and its Jacobian run on the CPU in
float64, and the linear algebra is numpy's, as in the JAX package; only
mf_factory's mean field and gradient run on the card.
"""
import numpy as np
import torch

from ..data.elements import BRAGG_RADII
from ..lib.parameters import BOHR


def detect_internals(mol, bond_scale=1.35):
    """(bonds, angles, dihedrals) index tuples from covalent distances."""
    r = np.asarray(mol.coords)
    z = np.asarray(mol.charges, dtype=int)
    natm = mol.natm
    rad = np.array([BRAGG_RADII[int(zi)] / BOHR for zi in z])
    bonds = []
    for i in range(natm):
        for j in range(i + 1, natm):
            if np.linalg.norm(r[i] - r[j]) < bond_scale * (rad[i] + rad[j]):
                bonds.append((i, j))
    # connect disconnected fragments through the closest atom pair
    adj = {i: set() for i in range(natm)}
    for i, j in bonds:
        adj[i].add(j)
        adj[j].add(i)

    def component(seed):
        seen, todo = {seed}, [seed]
        while todo:
            k = todo.pop()
            for n in adj[k]:
                if n not in seen:
                    seen.add(n)
                    todo.append(n)
        return seen

    while True:
        comp = component(0)
        if len(comp) == natm:
            break
        rest = [i for i in range(natm) if i not in comp]
        best = min(((i, j) for i in comp for j in rest),
                   key=lambda t: np.linalg.norm(r[t[0]] - r[t[1]]))
        bonds.append(tuple(sorted(best)))
        adj[best[0]].add(best[1])
        adj[best[1]].add(best[0])

    angles = []
    for j in range(natm):
        nb = sorted(adj[j])
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                angles.append((nb[x], j, nb[y]))
    dihedrals = []
    for (j, k) in bonds:
        for i in sorted(adj[j] - {k}):
            for l in sorted(adj[k] - {j}):
                if i != l:
                    dihedrals.append((i, j, k, l))
    return bonds, angles, dihedrals


def q_func(bonds, angles, dihedrals):
    """x (natm, 3) float64 tensor -> q (nq,): the bond lengths, the angles
    and the dihedrals, in that order, each kind evaluated for all its
    index tuples at once."""
    b = torch.as_tensor(np.asarray(bonds, dtype=np.int64).reshape(-1, 2))
    a = torch.as_tensor(np.asarray(angles, dtype=np.int64).reshape(-1, 3))
    d = torch.as_tensor(np.asarray(dihedrals, dtype=np.int64).reshape(-1, 4))

    def q(x):
        r = torch.linalg.norm(x[b[:, 0]] - x[b[:, 1]], dim=-1)
        u = x[a[:, 0]] - x[a[:, 1]]
        v = x[a[:, 2]] - x[a[:, 1]]
        cos = (u * v).sum(-1) / (torch.linalg.norm(u, dim=-1)
                                 * torch.linalg.norm(v, dim=-1))
        ang = torch.arccos(torch.clamp(cos, -1 + 1e-10, 1 - 1e-10))
        b1 = x[d[:, 1]] - x[d[:, 0]]
        b2 = x[d[:, 2]] - x[d[:, 1]]
        b3 = x[d[:, 3]] - x[d[:, 2]]
        n1 = torch.linalg.cross(b1, b2)
        n2 = torch.linalg.cross(b2, b3)
        m = torch.linalg.cross(n1, b2 / torch.linalg.norm(b2, dim=-1,
                                                          keepdim=True))
        dih = torch.atan2((m * n2).sum(-1), (n1 * n2).sum(-1))
        return torch.cat([r, ang, dih])

    return q


def optimize(mf_factory, mol, maxsteps=50, gtol=3e-4, trust=0.3):
    """Quasi-Newton minimisation in redundant internal coordinates.

    Same contract as geomopt.optimize, but mf_factory(mol) must return a
    mean field with .e_tot and .Gradients(); returns (the optimised copy
    of mol, the energy of every step)."""
    mol = mol.copy()
    bonds, angles, dihedrals = detect_internals(mol)
    q = q_func(bonds, angles, dihedrals)
    jacobian = torch.func.jacrev(q)

    def jac(x):
        return jacobian(torch.as_tensor(x)).numpy()

    def q_j(x):
        return q(torch.as_tensor(x)).numpy()

    x = np.asarray(mol.coords).copy()
    nq = len(bonds) + len(angles) + len(dihedrals)
    nd = len(dihedrals)
    # diagonal initial Hessian: 0.5 (bonds), 0.2 (angles), 0.1 (dihedrals)
    h = np.diag(np.concatenate([np.full(len(bonds), 0.5),
                                np.full(len(angles), 0.2),
                                np.full(nd, 0.1)]))
    energies = []
    gq_prev = dq_prev = None

    def wrap(dq):
        """Dihedral differences into (-pi, pi], in place."""
        if nd:
            dq[-nd:] = (dq[-nd:] + np.pi) % (2 * np.pi) - np.pi
        return dq

    for _ in range(maxsteps):
        m = mol.copy()
        m.set_geom_(x)
        mf = mf_factory(m)
        energies.append(float(mf.e_tot))
        gx = np.asarray(mf.Gradients().kernel())
        B = jac(x).reshape(nq, -1)                            # (nq, 3N)
        gq = np.linalg.pinv(B.T, rcond=1e-7) @ gx.ravel()
        if np.abs(gx).max() < gtol:
            break
        if gq_prev is not None:
            y = gq - gq_prev
            sden = float(dq_prev @ y)
            if sden > 1e-10:                                  # BFGS update
                hs = h @ dq_prev
                h = (h + np.outer(y, y) / sden
                     - np.outer(hs, hs) / float(dq_prev @ hs))
        dq = -np.linalg.solve(h + 1e-8 * np.eye(nq), gq)
        norm = np.linalg.norm(dq)
        if norm > trust:
            dq *= trust / norm
        # iterative back-transformation q + dq -> x
        q0 = q_j(x)
        target = q0 + dq
        xn = x.copy()
        for _ in range(25):
            dq_c = wrap(target - q_j(xn))
            if np.abs(dq_c).max() < 1e-10:
                break
            Bc = jac(xn).reshape(nq, -1)
            xn = xn + (np.linalg.pinv(Bc, rcond=1e-7) @ dq_c).reshape(-1, 3)
        gq_prev, dq_prev = gq, wrap(q_j(xn) - q0)
        x = xn
    mol.set_geom_(x)
    return mol, energies
