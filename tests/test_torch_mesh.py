"""The port's (dp, model) mesh (``cadm_tpu_torch/parallel``) on gloo ranks
on the CPU: a run on a mesh computes what the same run computes without
one (test_torch_mesh_jax.py holds it against the JAX package's mesh
functions, test_torch_mesh_ppo.py runs PPO on it).

- a (dp=2, model=2) and a (dp=2, model=1) run of a toy 2-member CaDM on
  pendulum (a random collect and an epoch fit, a planned collect, an epoch
  fit and an eval) against the same run without a mesh, rows and weights;
  a planned cheetah collect of 4 envs × 2 steps (K1/K2's plain versions on
  each rank's block) against the same collect; a checkpoint of the sharded
  run resuming without a mesh; the ``ValueError`` of 5 members on model=2;
- ``dryrun_multichip(4)``, the mesh-size errors, the card as the default
  device of ``spawn`` and the dry run, and ``Mesh.gather`` of bool, int32
  and float blocks bit for bit.

Ranks run under ``parallel.mesh.spawn`` (torch.multiprocessing, spawn, a
file store in a temporary directory); their functions are in
``tests/torch_mesh_common.py``.
"""
import math

import numpy as np
import pytest
import torch

from cadm_tpu_torch.parallel.dryrun import dryrun_multichip
from cadm_tpu_torch.parallel.mesh import make_mesh, spawn
from cadm_tpu_torch.utils.checkpoint import Checkpointer
from tests import torch_mesh_common as common
from tests.torch_mesh_common import (
    ATOL,
    LAYOUTS,
    assert_rows_close,
    assert_weights_close,
)


@pytest.fixture(scope="module")
def no_mesh():
    return {"train": common.without_mesh(common.train, common.PENDULUM),
            "collect": common.without_mesh(common.collect, common.CHEETAH)}


@pytest.mark.parametrize("dp,model", LAYOUTS)
def test_mesh_run_matches_the_run_without_one(dp, model, no_mesh, tmp_path):
    outs = spawn(common.layout, dp, model, ["cpu"] * (dp * model),
                 args=(str(tmp_path),))
    ref = no_mesh["train"]
    for out in outs:  # every rank gets the same rows and the whole state
        assert_rows_close(out["train"]["history"], ref["history"])
        assert_weights_close(out["train"]["params"], ref["params"])
        for a, b in zip(out["collect"]["cols"], no_mesh["collect"]["cols"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
        for k, v in no_mesh["collect"]["metrics"].items():
            got = out["collect"]["metrics"][k]
            assert got == v or (math.isnan(got) and math.isnan(v)), k
        if model > 1:
            assert ("5 ensemble members are not divisible by the mesh's "
                    f"model axis of {model}") in out["raises"]
    # the sharded run's checkpoint (rank 0's) resumes without a mesh
    cfg = common.ExperimentConfig(**common.PENDULUM)
    _, _, _, trainer = cfg.build("cpu")
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.steps() == [0, 1]
    _, rows = trainer.train(torch.Generator().manual_seed(cfg.seed),
                            resume=ckpt.restore(0))
    assert_rows_close(rows, outs[0]["train"]["history"][1:])


def test_dryrun_multichip_on_four_ranks():
    assert math.isfinite(dryrun_multichip(4, "cpu"))


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(common.gather_mixed, 2)


def test_gather_is_bit_exact_for_every_dtype():
    outs = spawn(common.gather_mixed, 2, 1, ["cpu"] * 2)
    want = common.gather_mixed(None)
    for out in outs:
        for a, b in zip(out, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_mesh_size_errors(monkeypatch):
    with pytest.raises(ValueError, match="needs 6 ranks and this run has 2"):
        make_mesh(dp=3, model=2, devices=["cpu", "cpu"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        make_mesh(dp=2)
