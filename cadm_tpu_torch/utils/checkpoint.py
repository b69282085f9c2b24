"""Full-state checkpoints with ``torch.save`` (counterpart of
cadm_tpu/utils/checkpoint.py, which uses Orbax).

A payload is the whole training state (``MBTrainer.checkpoint_payload``):
dynamics state, replay ring, env states, histories, the generator's state
and the iteration, so a resumed run reproduces the metrics of an
uninterrupted one. ``torch.load`` runs with ``weights_only=True``, which
refuses arbitrary classes, so a payload is stored as plain dicts, lists,
tensors and numbers (``to_plain``) and the trainer rebuilds its dataclasses
on restore (``from_plain``). Zero-width tensors (``History.rnn_h`` of a
non-recurrent model) need no placeholder.

A run on a mesh (``parallel.mesh``) saves the gathered state from rank 0,
the same file as without a mesh; ``restore_parts`` places a payload on any
layout.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Optional

import torch

from cadm_tpu_torch.parallel.mesh import (
    gather_dynamics_state,
    shard_dynamics_state,
    shard_leading_axis,
)

_NAME = re.compile(r"^step_(\d+)\.pt$")


def to_plain(tree: Any) -> Any:
    """``tree`` with every dataclass as a dict of its fields and every tuple
    as a list: what ``torch.load(weights_only=True)`` accepts."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def from_plain(template: Any, plain: Any) -> Any:
    """``plain`` (from ``to_plain``) rebuilt in the structure of
    ``template``: its dataclasses, tuples and lists. Raises where a
    tensor's shape or dtype differs from the template's (a checkpoint of
    another configuration); a number where the template holds a 0-d tensor
    becomes such a tensor."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: from_plain(getattr(template, f.name), plain[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        if set(template) != set(plain):
            raise ValueError(f"checkpoint keys {sorted(plain)} != "
                             f"{sorted(template)}")
        return {k: from_plain(template[k], plain[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(template) != len(plain):
            raise ValueError(f"checkpoint list of {len(plain)} != "
                             f"{len(template)}")
        return type(template)(from_plain(t, p) for t, p in zip(template, plain))
    if isinstance(template, torch.Tensor):
        if isinstance(plain, (int, float)) and template.ndim == 0:
            # a scalar saved as a number (``AdamState.count`` was a host
            # int in the checkpoints of earlier versions)
            return torch.tensor(plain, dtype=template.dtype,
                                device=template.device)
        if plain.shape != template.shape or plain.dtype != template.dtype:
            raise ValueError(f"checkpoint tensor {tuple(plain.shape)} "
                             f"{plain.dtype} != {tuple(template.shape)} "
                             f"{template.dtype}")
        return plain.to(template.device)
    return plain


def restore_parts(plain: dict, env_template: tuple, dyn_template, mesh=None,
                  member_keys=()):
    """(the env states, histories and ring, the model state) of a plain
    payload, rebuilt as the templates (a trainer's ``init``); on a mesh
    this rank's block of the envs and its members (the model's
    ``member_keys``), whatever layout saved the payload."""
    env_part = [plain[k] for k in ("env_states", "hists", "buffer")]
    dyn = from_plain(gather_dynamics_state(dyn_template, mesh, member_keys),
                     plain["state"])
    env_part = shard_leading_axis(env_part, mesh)
    return (from_plain(tuple(env_template), env_part),
            shard_dynamics_state(dyn, mesh, member_keys))


class Checkpointer:
    """Saves payloads as ``<directory>/step_<n>.pt`` and keeps the newest
    ``keep``. A save writes a temporary file and renames it, so a step file
    is either whole or absent. With ``writes=False`` (every rank of a mesh
    but one) ``save`` writes nothing and ``restore`` still reads."""

    def __init__(self, directory: str, keep: int = 3, save_buffer: bool = True,
                 map_location=None, writes: bool = True):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.writes = writes
        self.keep = keep
        self.save_buffer = save_buffer
        self.map_location = map_location

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def save(self, step: int, state: Any, buffer: Any = None) -> None:
        """Save a payload. ``state`` is a full training payload dict
        (``MBTrainer.checkpoint_payload``) or a bare model state;
        ``buffer`` is stored beside a bare state when ``save_buffer``."""
        if not self.writes:
            return
        payload = dict(state) if isinstance(state, dict) else {"state": state}
        if buffer is not None and self.save_buffer:
            payload["buffer"] = buffer
        tmp = self.path(step) + ".tmp"
        torch.save(to_plain(payload), tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.keep]:
            os.remove(self.path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        """The plain payload of ``step`` (the latest if None), its tensors
        on ``map_location``; None if there is no checkpoint."""
        step = self.latest_step if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=self.map_location,
                          weights_only=True)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Saves are synchronous: nothing is pending."""
