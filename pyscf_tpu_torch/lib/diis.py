"""DIIS (Pulay mixing) of tensors that stay on their device.

Counterpart of pyscf_tpu/lib/diis.py (DIIS): the same bordered Pulay
system [[B, -1], [-1, 0]] c = [0, -1] with B_ij = <e_i, e_j>, solved over
the eigenvalues of the bordered matrix above 1e-14 of the largest, and the
same subspace of `space` vectors with the oldest dropped first. Unlike the
JAX package, which flattens every vector to host numpy each cycle, the
subspace vectors stay on the device as flat tensors (a CCSD t2 at benzene
is 30 MB); only the new row of B and the (n+1)^2 system go to the host.
"""
import numpy as np
import torch


class DIIS:
    def __init__(self, space=8, min_space=1):
        self.space = space
        self.min_space = min_space
        self._x = []        # flat solution vectors, on their device
        self._err = []      # flat error vectors
        self._B = np.zeros((0, 0))

    @staticmethod
    def _flatten(x):
        if isinstance(x, (list, tuple)):
            return torch.cat([t.reshape(-1) for t in x])
        return x.reshape(-1).clone()

    @staticmethod
    def _unflatten(vec, template):
        if isinstance(template, (list, tuple)):
            out, off = [], 0
            for t in template:
                out.append(vec[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
            return type(template)(out)
        return vec.reshape(template.shape)

    def update(self, x, err):
        """Push (x, err) and return the DIIS-extrapolated x: a tensor, or a
        list or tuple of tensors shaped as x."""
        xv = self._flatten(x)
        ev = self._flatten(err)
        row = torch.stack([torch.dot(e, ev) for e in self._err] +
                          [torch.dot(ev, ev)]).tolist()
        self._x.append(xv)
        self._err.append(ev)
        n = len(self._x)
        B = np.empty((n, n))
        B[:n - 1, :n - 1] = self._B
        B[n - 1, :] = B[:, n - 1] = row
        if n > self.space:
            self._x.pop(0)
            self._err.pop(0)
            B = B[1:, 1:]
            n -= 1
        self._B = B
        if n < self.min_space + 1:
            return x
        H = np.empty((n + 1, n + 1))
        H[:n, :n] = B
        H[n, :n] = H[:n, n] = -1.0
        H[n, n] = 0.0
        g = np.zeros(n + 1)
        g[n] = -1.0
        try:
            w, v = np.linalg.eigh(H)
        except np.linalg.LinAlgError:
            return x
        keep = np.abs(w) > 1e-14 * np.abs(w).max()
        c = (v[:, keep] * (1.0 / w[keep])) @ (v[:, keep].T @ g)
        xnew = torch.zeros_like(xv)
        for ci, xi in zip(c[:n].tolist(), self._x):
            xnew.add_(xi, alpha=ci)
        return self._unflatten(xnew, x)
