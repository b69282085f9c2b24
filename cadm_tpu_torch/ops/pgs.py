"""Batched projected Gauss–Seidel contact solve: kernel K1 and its plain version.

Replaces the Pallas TPU kernel ``cadm_tpu/ops/pgs.py::pgs_solve`` (body
``_pgs_kernel``). ``pgs_solve`` launches the CUDA kernel of
``csrc/pgs.cu`` for a CUDA tensor and runs ``pgs_solve_plain`` (a batched
port of the reference's per-env ``solve_xla``,
``cadm_tpu/physics/rigid/dynamics.py:304-325``) for a CPU tensor.

What bounds the kernel on the card is the sequential chain of row updates
(a dot product, a divide and a shuffle reduction each), not bytes. It sweeps
only the active contacts (μ > 0) of each env, over rows of 3·na instead of
3·nc: an inactive contact's updates write zeros and its zero λ adds nothing
to any other row. Where an inactive contact starts with a nonzero λ0, the
first sweep runs over all contacts, which zeroes it. Each env is a group of
16 or 32 lanes, so a row dot has short reductions and envs share a warp,
and a shared-memory pool per block keeps many envs in flight. The details
are in ``csrc/pgs.cu``; ``tests/test_torch_pgs_active_set.py`` checks the
compaction's premise on the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from cadm_tpu_torch.ops import _build

Tensor = torch.Tensor

# Launches of the CUDA kernel in this process, replays of CUDA graphs that
# hold it included (read and reset by chip_smoke.py to show that the main
# path went through the kernel).
launches = 0


def pgs_solve_plain(
    A: Tensor, b: Tensor, vstar: Tensor, actmu: Tensor, lam0: Tensor,
    iters: int,
) -> Tensor:
    """The solve as plain batched tensor ops (same shapes as ``pgs_solve``)."""
    nc = vstar.shape[-1]
    Adiag = torch.diagonal(A, dim1=-2, dim2=-1)
    active = (actmu > 0.0).to(A.dtype)
    lam = lam0.clone()
    for _ in range(iters):
        for i in range(nc):
            iz, ix, iy = 3 * i + 2, 3 * i, 3 * i + 1
            r = (A[:, iz] * lam).sum(-1) + b[:, iz] - vstar[:, i]
            ln = torch.clamp(lam[:, iz] - r / Adiag[:, iz], min=0.0) * active[:, i]
            lam[:, iz] = ln
            rx = (A[:, ix] * lam).sum(-1) + b[:, ix]
            lx = lam[:, ix] - rx / Adiag[:, ix]
            ry = (A[:, iy] * lam).sum(-1) + b[:, iy]
            ly = lam[:, iy] - ry / Adiag[:, iy]
            t_norm = torch.sqrt(lx * lx + ly * ly) + 1e-9
            scale = torch.clamp(actmu[:, i] * ln / t_norm, max=1.0)
            lam[:, ix] = lx * scale
            lam[:, iy] = ly * scale
    return lam


def pgs_solve(
    A: Tensor, b: Tensor, vstar: Tensor, actmu: Tensor,
    lam0: Optional[Tensor] = None, *, iters: int,
) -> Tensor:
    """Batched PGS: A (E,3nc,3nc), b (E,3nc), vstar/actmu (E,nc) → λ (E,3nc).

    ``lam0`` (E,3nc) warm-starts the sweeps (None = cold, zeros). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    global launches
    e, nc = vstar.shape
    if iters <= 0 or nc <= 0:
        raise ValueError(f"pgs_solve needs nc > 0 and iters > 0 ({nc}, {iters})")
    if A.shape != (e, 3 * nc, 3 * nc) or b.shape != (e, 3 * nc) \
            or actmu.shape != (e, nc):
        raise ValueError(f"pgs_solve shapes: A {tuple(A.shape)}, b "
                         f"{tuple(b.shape)}, actmu {tuple(actmu.shape)}")
    if lam0 is None:
        lam0 = torch.zeros_like(b)
    if A.device.type == "cpu":
        return pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
    if A.device.type != "cuda":
        raise ValueError(f"pgs_solve: unsupported device {A.device}")
    A, b, vstar, actmu, lam0 = (
        x.contiguous() for x in (A, b, vstar, actmu, lam0)
    )
    _build.require_cuda_f32("pgs_solve", A, b, vstar, actmu, lam0)
    lam = torch.empty_like(b)
    code = _build.lib().cadm_pgs(
        A.data_ptr(), b.data_ptr(), vstar.data_ptr(), actmu.data_ptr(),
        lam0.data_ptr(), lam.data_ptr(), e, nc, iters, _build.stream_handle(A),
    )
    _build.check(code, "pgs_solve")
    launches += _build.eager_launch("pgs")
    return lam
