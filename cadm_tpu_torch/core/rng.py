"""Random draws that a run on a (dp, model) mesh makes alike on every rank.

The reference's mesh (cadm_tpu/parallel/mesh.py) partitions one global
program whose random draws are global arrays, so a run computes the same
numbers on any layout. The port keeps that rule: every draw whose shape
depends on the env count is made at the shape of all envs, from the same
generator on every rank, and the rank keeps its block. The generators then
stay in step on every rank, with the values of a run without a mesh.

Code that draws per env takes a ``torch.Generator`` or an ``EnvRows`` and
draws through ``rand``/``randn``/``randint``/``trunc_normal`` here. Nothing
here touches ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EnvRows:
    """A generator whose env-sized draws are made for the envs of all
    ``blocks`` dp ranks; the rank keeps block ``index`` of each. Passed
    where a ``torch.Generator`` goes on the env, planner and collect
    paths."""

    gen: torch.Generator
    index: int
    blocks: int

    @property
    def device(self) -> torch.device:
        return self.gen.device


def env_rows(mesh, gen: torch.Generator, n: int):
    """(the generator for a batch of ``n`` envs, this rank's env count):
    an ``EnvRows`` and n/dp where the n envs split over the dp axis of
    ``mesh`` (a ``parallel.mesh.Mesh``); ``gen`` and n (every rank runs all
    of them) with no mesh or where they do not split."""
    if mesh is None or n % mesh.dp:
        return gen, n
    return EnvRows(gen, mesh.index("dp"), mesh.dp), n // mesh.dp


def _draw(gen, fn: Callable, shape: Sequence[int], dim: int) -> Tensor:
    """``fn(shape, generator)``; from an ``EnvRows`` the draw is made with
    ``shape[dim]`` × blocks and this rank's block of ``dim`` kept."""
    shape = tuple(shape)
    if not isinstance(gen, EnvRows):
        return fn(shape, gen)
    n = shape[dim]
    full = shape[:dim] + (n * gen.blocks,) + shape[dim + 1:]
    return fn(full, gen.gen).narrow(dim, gen.index * n, n)


def rand(gen, *shape: int, dim: int = 0) -> Tensor:
    """U[0, 1) draws; ``dim`` is the env axis (see ``EnvRows``)."""
    return _draw(gen, lambda s, g: torch.rand(s, generator=g, device=g.device),
                 shape, dim)


def randn(gen, *shape: int, dim: int = 0) -> Tensor:
    """Standard normal draws; ``dim`` is the env axis."""
    return _draw(gen, lambda s, g: torch.randn(s, generator=g,
                                               device=g.device), shape, dim)


def randint(gen, high: int, *shape: int, dim: int = 0) -> Tensor:
    """Integers uniform in [0, high); ``dim`` is the env axis."""
    return _draw(gen, lambda s, g: torch.randint(0, high, s, generator=g,
                                                 device=g.device), shape, dim)


# Φ(±2) of the standard normal, mapped onto erfinv's domain [-1, 1]
_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def trunc_normal(gen, *shape: int, dim: int = 0) -> Tensor:
    """Standard normal draws truncated to [-2, 2]; ``dim`` is the env axis.

    By the inverse CDF: one uniform draw per value whatever the values, so
    a CUDA graph can hold it, and the same numbers under every PyTorch
    version (``torch.nn.init.trunc_normal_`` rejects and redraws in some,
    reading on the host whether any draw fell outside)."""
    def fn(s, g):
        u = torch.empty(s, device=g.device).uniform_(_TRUNC_LO, _TRUNC_HI,
                                                    generator=g)
        return torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)

    return _draw(gen, fn, shape, dim)
