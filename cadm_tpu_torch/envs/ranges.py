"""Dynamics-randomization specs (counterpart of cadm_tpu/envs/ranges.py).

Per-episode hidden physics parameters are drawn from the CaDM paper's
discrete scale sets (arXiv:2005.06800 §5.1): an interpolation set for
training and two sets outside its hull for the moderate and extreme test
modes. ``ScaleRange`` keeps the continuous-band variant. Sampling draws one
value per env from an explicit ``torch.Generator``; it cannot reproduce the
reference's ``jax.random`` stream, only its distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScaleSet:
    """Per-mode discrete value sets; ``sample`` draws uniformly from the
    set of ``mode`` (0 = train, 1 = moderate, 2 = extreme)."""

    train: Tuple[float, ...]
    moderate: Tuple[float, ...]
    extreme: Tuple[float, ...]

    def sample(self, gen: torch.Generator, mode: int, n: int) -> Tensor:
        vals = torch.tensor((self.train, self.moderate, self.extreme)[mode],
                            device=gen.device)
        idx = torch.randint(0, len(vals), (n,), generator=gen,
                            device=gen.device)
        return vals[idx]


@dataclasses.dataclass(frozen=True)
class ScaleRange:
    """Train interval plus two-sided extrapolation bands (continuous option).

    train:    (lo, hi) — per-episode uniform draw during training.
    moderate: (outer_lo, inner_lo, inner_hi, outer_hi) — uniform over
              [outer_lo, inner_lo] ∪ [inner_hi, outer_hi], a side first.
    extreme:  same structure, further out.
    """

    train: Tuple[float, float]
    moderate: Tuple[float, float, float, float]
    extreme: Tuple[float, float, float, float]

    def sample(self, gen: torch.Generator, mode: int, n: int) -> Tensor:
        u = torch.rand(n, generator=gen, device=gen.device)
        if mode == 0:
            lo, hi = self.train
            return u * (hi - lo) + lo
        band = self.moderate if mode == 1 else self.extreme
        left = torch.rand(n, generator=gen, device=gen.device) < 0.5
        lo = torch.where(left, band[0], band[2])
        hi = torch.where(left, band[1], band[3])
        return u * (hi - lo) + lo


# The paper's canonical multiplicative scheme; both share the train hull.
CANONICAL_SET = ScaleSet(
    train=(0.75, 0.85, 1.00, 1.15, 1.25),
    moderate=(0.40, 0.50, 1.50, 1.60),
    extreme=(0.20, 0.30, 1.70, 1.80),
)
CANONICAL_RANGE = ScaleRange(
    train=(0.75, 1.25),
    moderate=(0.40, 0.75, 1.25, 1.60),
    extreme=(0.20, 0.40, 1.60, 1.80),
)


def canonical(randomization: str) -> "ScaleSet | ScaleRange":
    """Pick the canonical sampler for a randomization scheme name."""
    if randomization == "discrete":
        return CANONICAL_SET
    if randomization == "continuous":
        return CANONICAL_RANGE
    raise ValueError(f"unknown randomization scheme: {randomization!r}")
