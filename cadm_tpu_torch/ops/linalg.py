"""Small-matrix batched SPD inverse (counterpart of cadm_tpu/ops/linalg.py).

An unrolled Cholesky–Crout over a static n, then forward and back
substitution against the identity, in float32 over any leading batch axes.
This is the plain version inside kernel K2 (ops/fk_kernel.py), and it keeps
the reference's clamp of the pivot at 1e-12: ``torch.linalg.cholesky``
raises on a non-positive pivot where the reference (and the CUDA kernel)
clamp and carry on.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def cholesky_unrolled(M: Tensor) -> Tensor:
    """Lower-triangular Cholesky factor of (..., n, n) SPD M."""
    n = M.shape[-1]
    cols = []  # L columns, each (..., n)
    upper = torch.arange(n, device=M.device)
    for j in range(n):
        s = M[..., :, j]
        for k in range(j):
            s = s - cols[k] * cols[k][..., j: j + 1]
        d = torch.sqrt(torch.clamp(s[..., j], min=1e-12))
        # zero the strictly-upper part of this column
        cols.append(s / d[..., None] * (upper >= j))
    return torch.stack(cols, dim=-1)


def spd_inverse(M: Tensor) -> Tensor:
    """Explicit inverse of a small SPD matrix (..., n, n) via Cholesky."""
    n = M.shape[-1]
    L = cholesky_unrolled(M)
    inv_diag = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    # forward substitution: L Y = I, row by row (rows are (..., n) over RHS)
    y_rows = []
    for i in range(n):
        r = eye[i].expand(M.shape[:-1])
        for k in range(i):
            r = r - L[..., i, k: k + 1] * y_rows[k]
        y_rows.append(r * inv_diag[..., i: i + 1])
    # back substitution: Lᵀ X = Y
    x_rows: list = [None] * n
    for i in reversed(range(n)):
        r = y_rows[i]
        for k in range(i + 1, n):
            r = r - L[..., k, i: i + 1] * x_rows[k]
        x_rows[i] = r * inv_diag[..., i: i + 1]
    X = torch.stack(x_rows, dim=-2)
    # symmetrize (inverse of SPD is SPD; cheap insurance against drift)
    return 0.5 * (X + X.transpose(-1, -2))
