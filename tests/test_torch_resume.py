"""Full-state checkpoint and resume in the port (as tests/test_resume.py):
a run resumed at an iteration boundary reproduces the uninterrupted run's
metrics exactly, for CaDM, ReBAL (its recurrent ``rnn_h`` in the payload)
and GrBAL (its own model state). Also the payload round trip, the ``keep``
rotation, the atomic write and the CLI's ``--checkpoint`` then
``--resume``.

Toy width on the cheetah, few control steps: each CPU env step runs the
plain versions of the kernels.
"""
import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from cadm_tpu_torch.cli import run
from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.models.grbal import GrBALState
from cadm_tpu_torch.utils.checkpoint import Checkpointer, from_plain
from cadm_tpu_torch.utils.debug import leaves_with_path

TOY = dict(hidden=(8, 8, 8), n_envs=2, eval_envs=1, eval_modes=(0,),
           n_candidates=4, plan_horizon=2, cem_iters=1, cem_elites=2,
           steps_per_itr=2, env_horizon=2, buffer_capacity=12, batch_size=4,
           max_epochs=1, eval_every=4)


def build(model, n_itr=4):
    cfg = dataclasses.replace(PRESETS["halfcheetah_cadm_cem"], model=model,
                              n_itr=n_itr, **TOY)
    return cfg.build("cpu")[3]


def numeric(row):
    return {k: v for k, v in row.items() if isinstance(v, float)}


@pytest.mark.parametrize("model", ["cadm", "rnn", "grbal"])
def test_resume_reproduces_uninterrupted_metrics(model, tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=5)
    dyn_full, full = build(model).train(torch.Generator().manual_seed(7),
                                        checkpointer=ckpt)
    assert len(full) == 4 and ckpt.steps() == [0, 1, 2, 3]

    # a fresh trainer and generator, from the end of itr 1
    restored = Checkpointer(str(tmp_path / "ck")).restore(step=1)
    assert restored["itr"] == 1
    if model == "rnn":
        assert restored["hists"]["rnn_h"].shape == (2, 64)
    dyn, resumed = build(model).train(torch.Generator().manual_seed(123),
                                      resume=restored)
    assert [m["itr"] for m in resumed] == [2, 3]
    for r, o in zip(resumed, full[2:]):
        r, o = numeric(r), numeric(o)
        assert r.keys() == o.keys()
        for k in r:
            np.testing.assert_allclose(r[k], o[k], rtol=0, atol=0,
                                       err_msg=f"{k} diverged after resume")
    assert type(dyn) is type(dyn_full) and dyn.updates == dyn_full.updates
    for a, b in zip(tree_leaves(dyn.params), tree_leaves(dyn_full.params)):
        assert torch.equal(a, b)


def test_warm_start_from_a_model_state_plans_from_its_first_iteration():
    """The weaker warm start: ``initial_dyn_state`` and ``start_itr`` give
    the model only; the ring is collected anew, and by the planner even at
    itr 0."""
    trainer = build("cadm", n_itr=2)
    gen = torch.Generator().manual_seed(1)
    dyn = trainer.init(gen)[3]
    kinds = []
    collect = trainer._collect

    def spy(*args, **kwargs):
        kinds.append(args[5])  # random_actions
        return collect(*args, **kwargs)

    trainer._collect = spy
    out, history = trainer.train(gen, initial_dyn_state=dyn)
    assert kinds == [False, False] and [r["itr"] for r in history] == [0, 1]
    assert out.updates > dyn.updates
    kinds.clear()
    _, history = trainer.train(gen, start_itr=1, initial_dyn_state=dyn)
    assert kinds == [False] and [r["itr"] for r in history] == [1]


@pytest.mark.parametrize("model", ["rnn", "grbal"])
def test_payload_round_trip(model, tmp_path):
    """Every leaf back bit for bit, the dataclasses rebuilt from the plain
    dicts ``torch.load(weights_only=True)`` accepts; another config's
    checkpoint is refused."""
    trainer = build(model)
    gen = torch.Generator().manual_seed(5)
    init = trainer.init(gen)
    payload = trainer.checkpoint_payload(*init, gen, 0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(0, payload)
    plain = ckpt.restore()
    assert isinstance(plain["state"], dict) and plain["itr"] == 0
    rebuilt = from_plain(init, [plain[k] for k in ("env_states", "hists",
                                                   "buffer", "state")])
    for a, b in zip(init, rebuilt):
        assert type(a) is type(b)
        la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), path
    if model == "grbal":
        assert isinstance(rebuilt[3], GrBALState)
    assert torch.equal(plain["rng"], gen.get_state())
    other = dataclasses.replace(PRESETS["halfcheetah_cadm_cem"], model=model,
                                **dict(TOY, n_envs=3)).build("cpu")[3]
    with pytest.raises(ValueError, match="checkpoint tensor"):
        other.train(torch.Generator(), resume=plain)


def test_keep_rotation_and_atomic_steps(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=3)
    assert ckpt.latest_step is None and ckpt.restore() is None
    for step in range(6):
        ckpt.save(step, {"state": {"w": torch.full((2,), float(step))},
                         "itr": step})
    assert ckpt.steps() == [3, 4, 5] and ckpt.latest_step == 5
    assert sorted(os.listdir(ckpt.dir)) == ["step_3.pt", "step_4.pt",
                                            "step_5.pt"]  # no temporaries
    assert torch.equal(ckpt.restore()["state"]["w"], torch.full((2,), 5.0))
    assert ckpt.restore(step=3)["itr"] == 3


def test_cli_checkpoint_then_resume(tmp_path):
    """``--checkpoint`` for 2 iterations, then ``--resume`` with 3: the
    second process runs itr 2 only, and its progress.csv holds only its own
    row (the reference logger's behaviour)."""
    argv = ["--preset", "halfcheetah_cadm_cem", "--hidden", "8,8",
            "--n-envs", "2", "--eval-envs", "1", "--eval-modes", "0",
            "--n-candidates", "4", "--plan-horizon", "2", "--cem-iters", "1",
            "--cem-elites", "2", "--steps-per-itr", "2", "--env-horizon", "2",
            "--buffer-capacity", "12", "--batch-size", "4", "--max-epochs",
            "1", "--eval-every", "4", "--device", "cpu",
            "--log-dir", str(tmp_path), "--exp-name", "r"]
    first = run.main(argv + ["--n-itr", "2", "--checkpoint"])
    assert [r["itr"] for r in first] == [0, 1]
    assert sorted(os.listdir(tmp_path / "r" / "checkpoints")) == [
        "step_0.pt", "step_1.pt"]
    second = run.main(argv + ["--n-itr", "3", "--resume"])
    assert [r["itr"] for r in second] == [2]
    with open(tmp_path / "r" / "progress.csv") as f:
        assert [row["itr"] for row in csv.DictReader(f)] == ["2"]
    assert "resumed full training state from checkpoint step 1" in (
        tmp_path / "r" / "debug.log").read_text()
