"""Load a result-matrix cell and its model snapshot for the probes.

``load_cell`` builds a cell as the matrix runner does (``cli/matrix``'s
tables), with the probes' width overrides, and reads the model state the
runner saved (``results/torch/ckpt/<cell>.pt``, plain dicts for
``torch.load(weights_only=True)``), rebuilt against the model's own initial
state, so a snapshot of another configuration is refused.

A snapshot of the reference (``results/ckpt/<cell>.pkl``: its
``DynamicsState`` pickled as a numpy pytree) loads too, without the JAX
package: ``read_jax_snapshot`` unpickles its JAX-side classes as plain
records and ``dyn_state_from_jax`` carries the leaves over.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from cadm_tpu_torch.cli import matrix
from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.models.dynamics import AdamState, DynamicsState
from cadm_tpu_torch.train.ppo import PPOState
from cadm_tpu_torch.utils.checkpoint import from_plain
from cadm_tpu_torch.utils.convert import (
    adam_state_from_jax,
    params_from_jax,
    ppo_state_from_jax,
)

CKPT_DIR = matrix.CKPT_DIR
OUT_ROOT = os.path.join(matrix.ROOT, "results", "torch")


def out_path(*parts: str) -> str:
    """A path under ``results/torch/`` (the reference's records under
    ``results/`` are never overwritten)."""
    return os.path.join(OUT_ROOT, *parts)


def split_cell(cell: str) -> Tuple[str, str, int]:
    """``family__model__s<seed>`` → (family, model, seed)."""
    family, model, seed = cell.split("__")
    return family, model, int(seed[1:])


def cell_config(cell: str, **overrides):
    """The cell's ``ExperimentConfig`` with the non-None ``overrides``
    (the probes' ``--n-envs``, ``--steps`` ...) replacing its fields."""
    cfg = matrix.cell_config(*split_cell(cell))
    return dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if v is not None})


def load_cell(cell: str, path: Optional[str] = None, device="cuda",
              ckpt_dir: Optional[str] = None, **overrides):
    """(cfg, env, dyn, planner, trainer, dyn_state) of ``cell`` on
    ``device``. ``path`` is the snapshot (default
    ``<ckpt_dir>/<cell>.pt``; a ``.pkl`` is read as the reference's);
    ``overrides`` as in ``cell_config``."""
    device = resolve_device(device)
    cfg = cell_config(cell, **overrides)
    env, dyn, planner, trainer = cfg.build(device)
    path = path or os.path.join(ckpt_dir or CKPT_DIR, cell + ".pt")
    return cfg, env, dyn, planner, trainer, read_snapshot(dyn, path, device)


def read_snapshot(dyn, path: str, device) -> DynamicsState:
    """The model state at ``path``: a port snapshot (``.pt``: the matrix
    runner's, or the ``state`` of a ``cli.run --checkpoint`` payload)
    rebuilt against ``dyn.init_state``'s structure (refusing other shapes),
    or a reference one (``.pkl``)."""
    device = resolve_device(device)
    if path.endswith(".pkl"):
        return dyn_state_from_jax(read_jax_snapshot(path), device)
    plain = torch.load(path, map_location=device, weights_only=True)
    if "buffer" in plain:   # a whole training payload
        plain = plain["state"]
    plain.pop("ppo", None)  # a PPO cell's policy state (read_ppo_snapshot)
    template = dyn.init_state(torch.Generator(device=device).manual_seed(0))
    return from_plain(template, plain)


# the optax states a reference snapshot holds, by class name: namedtuples
# pickled by their positional fields
_OPTAX_FIELDS = {"ScaleByAdamState": ("count", "mu", "nu"), "EmptyState": ()}


class _Record:
    """A reference dataclass (``DynamicsState``, ``NormStats``) unpickled
    as its attributes."""


class _SnapshotUnpickler(pickle.Unpickler):
    """Unpickles numpy as numpy and every class of the JAX side as a plain
    record, so no module of it is imported."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("cadm_tpu", "optax", "flax", "jax",
                                    "jaxlib", "chex"):
            if name in _OPTAX_FIELDS:
                return collections.namedtuple(name, _OPTAX_FIELDS[name])
            return type(name, (_Record,), {})
        return super().find_class(module, name)


def read_jax_snapshot(path: str):
    """The reference's pickled ``DynamicsState`` (numpy leaves), its
    classes as plain records."""
    with open(path, "rb") as f:
        return _SnapshotUnpickler(f).load()


def dyn_state_from_jax(snap, device="cuda") -> DynamicsState:
    """The port's ``DynamicsState`` from a reference snapshot (``params``,
    ``norm``, the ``chain(clip, adam)`` state and ``updates``, leaves as
    numpy): the object ``read_jax_snapshot`` returns or
    ``jax.tree.map(np.asarray, state)``."""
    device = resolve_device(device)
    params, norm = params_from_jax(snap.params, snap.norm, device)
    opt = (None if snap.opt_state is None
           else adam_state_from_jax(snap.opt_state[1][0], device))
    return DynamicsState(params, norm, opt, int(np.asarray(snap.updates)))


def read_ppo_snapshot(path: str, device) -> PPOState:
    """The PPO state a PPO cell's snapshot keeps beside its model: the
    port's (``<cell>.pt``, under ``ppo``) or the JAX runner's
    (``<cell>.ppo.pkl``, written by ``scripts/run_jax_cpu_cell.py``)."""
    device = resolve_device(device)
    if path.endswith(".pkl"):
        return ppo_state_from_jax(read_jax_snapshot(path), device)
    plain = torch.load(path, map_location=device, weights_only=True)["ppo"]
    count = plain["opt_state"]["count"]
    return PPOState(plain["params"], AdamState(
        torch.as_tensor(count, dtype=torch.int32, device=device),
        plain["opt_state"]["mu"], plain["opt_state"]["nu"]),
        int(plain["updates"]))


def random_start(trainer, dyn_state: DynamicsState, gen: torch.Generator):
    """(env states, histories) after a random-policy collect of the
    trainer's ``steps_per_itr`` from fresh resets: the scripts' recipe for
    on-distribution start states with warmed context windows."""
    env_states, hists, buffer, _ = trainer.init(gen)
    env_states, hists, _, _ = trainer._collect(gen, env_states, hists, buffer,
                                               dyn_state, random_actions=True)
    return env_states, hists


def add_common_args(parser, ckpt: bool = True) -> None:
    """``--device`` (and ``--ckpt-dir``) of every probe."""
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a "
                             "card)")
    if ckpt:
        parser.add_argument("--ckpt-dir", default=CKPT_DIR,
                            help="directory of the <cell>.pt snapshots")
