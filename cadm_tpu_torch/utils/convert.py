"""Load parameters and optimizer state of the JAX package into the port.

Both packages keep an MLP layer as ``{"w": (in, out), "b": (out,)}`` and the
member-stacked heads as ``params["fwd"]``/``params["bwd"]`` lists of
``{"w": (n_members, in, out), "b": (n_members, out)}`` (a probabilistic
ensemble adds the ``max_logvar``/``min_logvar`` vectors), so conversion is a
dtype/device copy of every leaf, no transposes. Nested dicts come across as
they are: ReBAL's encoder ``{"gru": {"z"|"r"|"h": {"wx", "wh", "b"}},
"proj": [...]}`` and GrBAL's ``{"net": [...]}``. The Adam moments of optax's
``ScaleByAdamState`` are trees of the same shape. The PPO
trainer's state carries across the same way (``ppo_state_from_jax``). Pass
numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``); this module does
not import jax. ``params_to_numpy`` is the way back: the port's params and
norm statistics as the same tree of float32 numpy arrays, which the JAX
package takes as they are; ``ppo_state_to_numpy`` the PPO state's, laid
out as the JAX ``PPOState`` is.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.models.dynamics import AdamState, NormStats
from cadm_tpu_torch.train.ppo import PPOState

NORM_FIELDS = ("obs_mean", "obs_std", "act_mean", "act_std", "dobs_mean",
               "dobs_std")


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_from_jax(params_np: Mapping, norm_np: Any, device="cuda"
                    ) -> Tuple[dict, NormStats]:
    """(params, NormStats) of the port from the JAX ``params`` dict and
    ``NormStats`` (leaves as numpy arrays)."""
    device = resolve_device(device)
    norm = NormStats(*(
        torch.tensor(np.asarray(getattr(norm_np, f), np.float32), device=device)
        for f in NORM_FIELDS
    ))
    return _to_torch(params_np, device), norm


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()


def params_to_numpy(params: Mapping, norm: NormStats
                    ) -> Tuple[dict, dict]:
    """The inverse of ``params_from_jax``: (params, norm) of the port as
    (the same tree with float32 numpy leaves, ``{field: array}`` over
    ``NORM_FIELDS``); ``NormStats(**norm)`` of either package takes the
    second."""
    return _to_numpy(params), {f: _to_numpy(getattr(norm, f))
                               for f in NORM_FIELDS}


def adam_state_from_jax(adam_np: Any, device="cuda") -> AdamState:
    """The port's ``AdamState`` from optax's ``ScaleByAdamState`` (``count``,
    ``mu``, ``nu`` as numpy; for the model's ``optax.chain(clip, adam)``
    state it is ``opt_state[1][0]``); the count an int32 scalar on
    ``device``, as optax's."""
    device = resolve_device(device)
    count = torch.tensor(int(np.asarray(adam_np.count)), dtype=torch.int32,
                         device=device)
    return AdamState(count, _to_torch(adam_np.mu, device),
                     _to_torch(adam_np.nu, device))


def ppo_state_from_jax(ppo_np: Any, device="cuda") -> PPOState:
    """The port's ``PPOState`` from the JAX one (leaves as numpy): its
    ``params`` ``{"policy": [...], "log_std", "value": [...]}``, the Adam
    state of its ``chain(clip, adam)`` at ``opt_state[1][0]``, ``updates``."""
    device = resolve_device(device)
    return PPOState(_to_torch(ppo_np.params, device),
                    adam_state_from_jax(ppo_np.opt_state[1][0], device),
                    int(np.asarray(ppo_np.updates)))


class AdamNumpy(NamedTuple):
    """optax's ``ScaleByAdamState`` fields, as numpy."""
    count: np.ndarray   # int32 scalar
    mu: Any
    nu: Any


class PPOStateNumpy(NamedTuple):
    """The JAX ``PPOState``'s fields as numpy: ``opt_state`` is laid out as
    its ``chain(clip_by_global_norm, adam)`` state, ``((), (adam, ()))``."""
    params: dict
    opt_state: tuple
    updates: np.ndarray  # int32 scalar


def ppo_state_to_numpy(state: PPOState) -> PPOStateNumpy:
    """The inverse of ``ppo_state_from_jax``: the port's ``PPOState`` as
    float32 numpy trees and int32 counts, where the JAX package keeps them
    (the Adam state at ``opt_state[1][0]``)."""
    adam = state.opt_state
    count = np.asarray(int(adam.count), np.int32)
    return PPOStateNumpy(
        _to_numpy(state.params),
        ((), (AdamNumpy(count, _to_numpy(adam.mu), _to_numpy(adam.nu)), ())),
        np.asarray(int(state.updates), np.int32))
