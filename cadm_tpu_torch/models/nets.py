"""Minimal MLP building blocks (counterpart of cadm_tpu/models/nets.py).

Parameters are plain lists of ``{"w": (in, out), "b": (out,)}`` tensors in
the reference's layout (weights are (in, out), not ``nn.Linear``'s
(out, in)), so JAX parameters load without transposes. Ensemble members are
a leading axis, ``{"w": (n, in, out), "b": (n, out)}``; ``member`` slices
one out for ``mlp_apply``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
MLP = List[dict]


def swish(x: Tensor) -> Tensor:
    return F.silu(x)


def mlp_init(
    gen: torch.Generator, sizes: Sequence[int], n_members: Optional[int] = None,
) -> MLP:
    """Init an MLP with layer widths ``sizes`` = [in, h1, ..., out].

    Truncated-normal (±2σ) weights with std 1/(2·sqrt(fan_in)) — the
    PETS/CaDM convention — and zero biases; ``n_members`` adds a leading
    member axis.
    """
    lead = () if n_members is None else (n_members,)
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.empty(*lead, n_in, n_out, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        params.append({
            "w": w / (2.0 * math.sqrt(n_in)),
            "b": torch.zeros(*lead, n_out, device=gen.device),
        })
    return params


def mlp_apply(params: MLP, x: Tensor, activation=swish) -> Tensor:
    """Apply the MLP; activation on all but the final layer.

    Takes one member's weights (see ``member``) and x (..., in); each
    layer is one ``addmm`` over the flattened rows.
    """
    n = len(params)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    for i, layer in enumerate(params):
        x = torch.addmm(layer["b"], x, layer["w"])
        if i < n - 1:
            x = activation(x)
    return x.reshape(*lead, -1)


def member(params: MLP, m: int) -> MLP:
    """One member's slice of a member-stacked MLP."""
    return [{"w": layer["w"][m], "b": layer["b"][m]} for layer in params]
