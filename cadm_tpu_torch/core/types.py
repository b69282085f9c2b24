"""Core state types shared across the port (counterpart of cadm_tpu/core/types.py).

Dataclasses of tensors with a leading env axis take the place of the
reference's vmapped flax pytrees. ``tree_map``/``tree_where`` walk nested
dataclasses, tuples, lists and dicts.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Callable

import numpy as np
import torch

Tensor = torch.Tensor
PyTree = Any


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine without one (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def constant(values, device, dtype=torch.float32) -> Tensor:
    """Host ``values`` (a number sequence or numpy array) as a tensor on
    ``device``, made at the first call per (values, device, dtype) and
    shared after: callers read it and never write it. Code on the control
    step uses it for its host constants, since a copy from host memory
    inside a CUDA-graph capture is refused."""
    a = np.asarray(values)
    return _constant(tuple(a.ravel().tolist()), a.shape, dtype,
                     torch.device(device))


@lru_cache(maxsize=None)
def _constant(flat: tuple, shape: tuple, dtype, device) -> Tensor:
    return torch.tensor(flat, dtype=dtype, device=device).reshape(shape)


def tree_leaves(tree: PyTree) -> list:
    """The tensors of a tree of dicts/lists/tuples; dicts in sorted key
    order (as ``jax.tree.leaves``), so trees built in another key order
    still flatten alike."""
    if isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    raise TypeError(f"tree_leaves: unsupported node {type(tree).__name__}")


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """A tree shaped as ``like`` holding ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return type(t)(build(x) for x in t)

    return build(like)


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over structurally identical trees; ``None`` and
    plain numbers (e.g. a step count) are kept as they are."""
    t0 = trees[0]
    if isinstance(t0, Tensor):
        return fn(*trees)
    if t0 is None or isinstance(t0, (int, float)):
        return t0
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


def leading_dim(tree: PyTree) -> int:
    """The leading (env) axis of the first tensor of a tree of dataclasses,
    dicts, lists and tuples."""
    if isinstance(tree, Tensor):
        return tree.shape[0]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    return leading_dim(tree[0])


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
    (E, K) is 1.0 where the slot holds a real transition. rnn_h (E, H) is
    ReBAL's episode-recurrent encoder state: advanced once per env step by
    ``Dynamics.push_history``, wiped with the rest on reset; H = 0 for every
    other model.
    """

    obs: Tensor
    dobs: Tensor
    act: Tensor
    valid: Tensor
    rnn_h: Tensor

    @staticmethod
    def zeros(n: int, k: int, obs_dim: int, act_dim: int,
              device=None, rnn_hidden: int = 0) -> "History":
        z = lambda *s: torch.zeros(n, *s, device=device)  # noqa: E731
        return History(obs=z(k, obs_dim), dobs=z(k, obs_dim), act=z(k, act_dim),
                       valid=z(k), rnn_h=z(rnn_hidden))

    def push(self, obs: Tensor, dobs: Tensor, act: Tensor) -> "History":
        """Push one transition per env, dropping the oldest; ``rnn_h`` is
        left alone (the model's ``push_history`` advances it)."""

        def shift(ring, new):
            return torch.cat([ring[:, 1:], new[:, None]], dim=1)

        return History(
            obs=shift(self.obs, obs),
            dobs=shift(self.dobs, dobs),
            act=shift(self.act, act),
            valid=shift(self.valid, torch.ones_like(self.valid[:, 0])),
            rnn_h=self.rnn_h,
        )


def batched_history(model_cfg, n_envs: int, device=None) -> History:
    """A zero History for ``n_envs`` envs sized for a model's config: an
    ``rnn_h`` of ``rnn_hidden`` for ``context='rnn'``, zero-width else."""
    rh = model_cfg.rnn_hidden if getattr(model_cfg, "context", "") == "rnn" \
        else 0
    return History.zeros(n_envs, model_cfg.history_k, model_cfg.obs_dim,
                         model_cfg.act_dim, device=device, rnn_hidden=rh)
