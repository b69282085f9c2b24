"""Minimal MLP and GRU building blocks (counterpart of
cadm_tpu/models/nets.py).

Parameters are plain lists of ``{"w": (in, out), "b": (out,)}`` tensors in
the reference's layout (weights are (in, out), not ``nn.Linear``'s
(out, in)), so JAX parameters load without transposes. Ensemble members are
a leading axis, ``{"w": (n, in, out), "b": (n, out)}``: ``mlp_apply`` runs
all members as one batched product over that axis, and ``member`` slices
one out.
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


def gru_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    """GRU cell parameters in the reference's layout: gates ``z`` (update),
    ``r`` (reset) and ``h`` (candidate), each ``{"wx": (in, H), "wh": (H,
    H), "b": (H,)}``; truncated-normal (±2σ) weights with std
    1/(2·sqrt(fan_in)), zero biases."""

    def mat(n_in):
        w = torch.empty(n_in, hidden, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w / (2.0 * math.sqrt(n_in))

    return {g: {"wx": mat(in_dim), "wh": mat(hidden),
                "b": torch.zeros(hidden, device=gen.device)}
            for g in ("z", "r", "h")}


def gru_apply(params: dict, h: Tensor, x: Tensor) -> Tensor:
    """One GRU step on rows (..., H) and (..., in):
    h' = (1−z)·h + z·tanh(x·Wx_h + (r·h)·Wh_h + b_h)."""

    def gate(g, a, b):
        p = params[g]
        return linear({"w": p["wx"], "b": p["b"]}, a) + b @ p["wh"]

    z = torch.sigmoid(gate("z", x, h))
    r = torch.sigmoid(gate("r", x, h))
    cand = torch.tanh(gate("h", x, r * h))
    return (1.0 - z) * h + z * cand


def linear(layer: dict, x: Tensor) -> Tensor:
    """``x @ w + b`` of one layer. One member's weights (in, out) take x
    (..., in) as one ``addmm`` over the flattened rows; member-stacked
    weights (n, in, out) take x (n, ..., in) as one ``baddbmm`` over the
    member axis."""
    w, b = layer["w"], layer["b"]
    lead = x.shape[:-1]
    if w.ndim == 3:
        y = torch.baddbmm(b[:, None], x.reshape(x.shape[0], -1, x.shape[-1]),
                          w)
    else:
        y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, -1)


def mlp_apply(params: MLP, x: Tensor, activation=swish) -> Tensor:
    """Apply the MLP (one member's or member-stacked weights, see
    ``linear``); activation on all but the final layer."""
    n = len(params)
    for i, layer in enumerate(params):
        x = linear(layer, x)
        if i < n - 1:
            x = activation(x)
    return x


def member(params: MLP, m: int) -> MLP:
    """One member's slice of a member-stacked MLP."""
    return [{"w": layer["w"][m], "b": layer["b"][m]} for layer in params]
