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
out as the JAX ``PPOState`` is. The rest of a trainer's state crosses
too: the env states, context histories, replay ring and model state
(``env_state_from_jax``, ``history_from_jax``, ``buffer_from_jax``,
``dynamics_state_from_jax``; a source is the JAX object with numpy leaves
or a dict of its fields), and back as dicts of the JAX field names
(``state_to_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from cadm_tpu_torch.core.types import EnvState, History, resolve_device
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from cadm_tpu_torch.models.dynamics import AdamState, DynamicsState, NormStats
from cadm_tpu_torch.train.buffer import ReplayBuffer
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
        torch.tensor(np.asarray(_field(norm_np, f), np.float32), device=device)
        for f in NORM_FIELDS
    ))
    return _to_torch(params_np, device), norm


def policy_params_from_jax(params_np: Mapping, device="cuda") -> dict:
    """The PPO trainer's params ``{"policy", "log_std", "value"}`` of the
    JAX package's (leaves as numpy)."""
    return _to_torch(params_np, resolve_device(device))


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
    count = torch.tensor(int(np.asarray(_field(adam_np, "count"))),
                         dtype=torch.int32, device=device)
    return AdamState(count, _to_torch(_field(adam_np, "mu"), device),
                     _to_torch(_field(adam_np, "nu"), device))


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


def _field(src: Any, name: str) -> Any:
    """Field ``name`` of a JAX object (an attribute) or of a dict."""
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(x: Any, device) -> torch.Tensor:
    """A copy of the numpy array ``x`` on ``device``, its dtype kept."""
    return torch.from_numpy(np.array(x)).to(device)


def _fields_from(cls, src: Any, device):
    """The dataclass ``cls`` with each field's tensor from ``src``."""
    return cls(*(_tensor(_field(src, f.name), device)
                 for f in dataclasses.fields(cls)))


def env_state_from_jax(js: Any, device="cuda", phys=RigidPhys,
                       params=MassDampingParams) -> EnvState:
    """The port's ``EnvState`` of the JAX one (its per-env key is not
    read: the port's envs draw from a generator). ``phys`` and ``params``:
    the family's dataclasses (the rigid families' by default)."""
    device = resolve_device(device)
    return EnvState(_fields_from(phys, _field(js, "phys"), device),
                    _tensor(_field(js, "obs"), device),
                    _fields_from(params, _field(js, "params"), device),
                    _tensor(_field(js, "t"), device),
                    _tensor(_field(js, "done"), device))


def history_from_jax(jh: Any, device="cuda") -> History:
    """The port's context ``History`` of the JAX one."""
    return _fields_from(History, jh, resolve_device(device))


def buffer_from_jax(jb: Any, device="cuda") -> ReplayBuffer:
    """The port's ``ReplayBuffer`` of the JAX one, ``ptr``/``size`` as host
    integers."""
    device = resolve_device(device)
    ptr, size = (int(np.asarray(_field(jb, f))) for f in ("ptr", "size"))
    return ReplayBuffer(*(_tensor(_field(jb, f), device) for f in (
        "obs", "act", "next_obs", "done", "ep_step", "bad")), ptr, size)


def dynamics_state_from_jax(jd: Any, device="cuda") -> DynamicsState:
    """The port's ``DynamicsState`` of the JAX one: params, norm, the Adam
    state of its ``chain(clip, adam)`` at ``opt_state[1][0]`` (or a dict
    ``opt_state`` that is the Adam state, as ``state_to_numpy`` gives it),
    updates."""
    params, norm = params_from_jax(_field(jd, "params"), _field(jd, "norm"),
                                   device)
    opt = _field(jd, "opt_state")
    return DynamicsState(params, norm, adam_state_from_jax(
        opt if isinstance(opt, Mapping) else opt[1][0], device),
        int(np.asarray(_field(jd, "updates"))))


def state_to_numpy(x: Any) -> Any:
    """The inverse of the ``*_from_jax`` converters: a port state (env
    states, ``History``, ``ReplayBuffer``, ``DynamicsState``, ...) as nested
    dicts under the JAX package's field names, tensors as numpy arrays
    and host integers as int32 scalars. ``DynamicsState.opt_state`` comes as
    ``{"count", "mu", "nu"}``, the JAX state's ``opt_state[1][0]``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bool, int)):
        return np.asarray(x, np.int32)
    if isinstance(x, Mapping):
        return {k: state_to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [state_to_numpy(v) for v in x]
    if dataclasses.is_dataclass(x):
        return {f.name: state_to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
