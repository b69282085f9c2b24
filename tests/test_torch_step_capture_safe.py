"""What a CUDA-graph capture of the control step would refuse, on the CPU.

A capture (train/step_graph.py) refuses a read of a tensor's value on the
host (a sync) and a tensor made from host memory (a copy that syncs). Once
a step has run (the graph's warm-up fills the caches of host constants),
the step of every preset, model, planner mode and env family must do
neither: a dispatch mode raises on the ops that would, and
``torch.tensor``/``as_tensor``/``from_numpy`` are refused while it runs.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.train.step_graph import STEPS
from tests.test_torch_step_graph import TOY, start


class HostSyncs(TorchDispatchMode):
    """Raise on an op that reads a tensor's values on the host or makes a
    tensor from host data: on the card each is a sync or a copy from host
    memory, which a CUDA-graph capture refuses."""

    aten = torch.ops.aten
    REFUSED = {aten._local_scalar_dense.default, aten.nonzero.default,
               aten.masked_select.default, aten.is_nonzero.default,
               aten.equal.default, aten._unique2.default,
               aten.unique_consecutive.default, aten.unique_dim.default,
               aten.lift_fresh.default, aten.repeat_interleave.Tensor}
    INDEXING = {aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._unsafe_index_put.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.REFUSED:
            raise AssertionError(f"host sync or host data in the step: {func}")
        if func in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise AssertionError(f"boolean-mask indexing in the step: {func}")
        return func(*args, **kwargs)


def refuse(*args, **kwargs):
    raise AssertionError("a tensor made from host memory in the step")


@pytest.mark.parametrize("name,override", [
    ("halfcheetah_cadm_cem", {}),
    ("halfcheetah_cadm_cem", dict(model="stacked")),
    ("halfcheetah_cadm_cem", dict(model="rnn")),
    ("halfcheetah_cadm_cem", dict(model="grbal", hidden=(8, 8, 8))),
    ("halfcheetah_cadm_cem", dict(planner="rs", randomization="continuous")),
    ("cripple_ant_cadm_ensemble_cem", dict(ensemble_eval="ts1")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="assign")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="mean")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="ts1_exact")),
    ("hopper_cadm_cem", dict(normalize_env=True)),
    ("slim_humanoid_cadm_cem", {}),
    ("pendulum_cadm_cem", {}),
    ("cartpole_vanilla_rs", {}),
], ids=lambda x: x if isinstance(x, str) else "-".join(
    f"{k}={v}" for k, v in x.items() if k != "hidden") or "preset")
def test_step_bodies_are_capture_safe(name, override, monkeypatch):
    cfg = dataclasses.replace(PRESETS[name], **{**TOY, **override})
    trainer = cfg.build("cpu")[3]
    for kind, mode in (("collect", 0), ("eval", 2)):
        gen, dyn, carry = start(trainer, kind)
        with torch.no_grad():
            carry, _ = STEPS[kind](trainer, dyn, carry, gen, mode)  # warm-up
            with monkeypatch.context() as m:
                for fn in ("tensor", "as_tensor", "from_numpy"):
                    m.setattr(torch, fn, refuse)
                with HostSyncs():
                    STEPS[kind](trainer, dyn, carry, gen, mode)
