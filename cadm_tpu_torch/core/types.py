"""Core state types shared across the port (counterpart of cadm_tpu/core/types.py).

Dataclasses of tensors with a leading env axis take the place of the
reference's vmapped flax pytrees. ``tree_map``/``tree_where`` walk nested
dataclasses, tuples, lists and dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor
PyTree = Any


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over structurally identical trees."""
    t0 = trees[0]
    if isinstance(t0, Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    raise TypeError(f"tree_map: unsupported node {type(t0).__name__}")


def tree_where(pred: Tensor, on_true: PyTree, on_false: PyTree) -> PyTree:
    """Per-env ``torch.where`` over matching trees; ``pred`` is (E,) bool."""

    def pick(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)

    return tree_map(pick, on_true, on_false)


@dataclasses.dataclass
class EnvState:
    """Per-env state threaded through the control loop, one row per env.

    phys:   env-family physical state (e.g. qpos/qvel).
    obs:    current observation (E, obs_dim).
    params: hidden per-episode dynamics parameters, re-sampled on reset.
    t:      step index within the current episode (E,) int32.
    done:   whether the previous step ended the episode (E,) bool.

    The reference's per-env PRNG key has no field here: the caller passes
    a ``torch.Generator`` to ``Env.reset``/``Env.step`` instead.
    """

    phys: PyTree
    obs: Tensor
    params: PyTree
    t: Tensor
    done: Tensor


@dataclasses.dataclass
class History:
    """Shift-register of the K most recent transitions for CaDM context.

    obs/dobs (E, K, obs_dim), act (E, K, act_dim), oldest first; valid
    (E, K) is 1.0 where the slot holds a real transition. (The reference's
    recurrent-encoder slot ``rnn_h`` comes with the ReBAL port.)
    """

    obs: Tensor
    dobs: Tensor
    act: Tensor
    valid: Tensor

    @staticmethod
    def zeros(n: int, k: int, obs_dim: int, act_dim: int,
              device=None) -> "History":
        z = lambda *s: torch.zeros(n, *s, device=device)  # noqa: E731
        return History(obs=z(k, obs_dim), dobs=z(k, obs_dim), act=z(k, act_dim),
                       valid=z(k))

    def push(self, obs: Tensor, dobs: Tensor, act: Tensor) -> "History":
        """Push one transition per env, dropping the oldest."""

        def shift(ring, new):
            return torch.cat([ring[:, 1:], new[:, None]], dim=1)

        return History(
            obs=shift(self.obs, obs),
            dobs=shift(self.dobs, dobs),
            act=shift(self.act, act),
            valid=shift(self.valid, torch.ones_like(self.valid[:, 0])),
        )


def batched_history(model_cfg, n_envs: int, device=None) -> History:
    """A zero History for ``n_envs`` envs sized for a model's config."""
    return History.zeros(n_envs, model_cfg.history_k, model_cfg.obs_dim,
                         model_cfg.act_dim, device=device)
