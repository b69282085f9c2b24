"""The port's bench (``cadm_tpu_torch/bench.py``) against the reference's
``bench.py``: the model, planner and replay-ring configurations that the
reference's CEM and training lines build equal the port's field for field
(bar the TPU's ``max_parallel_rollouts``), captured by wrapping the
constructors of both packages while each bench runs at a tiny size; the
three port lines at about 4 envs × 2 steps on the CPU (finite, positive
rates, the reference's counts over the timed seconds); ``main`` at tiny
SMOKE shapes on the CPU (one stdout line of JSON with every key, the
humanoid line not measured); ``main`` without a card raising before any
output.
"""
import dataclasses
import json
import math
import os

import pytest
import torch

os.environ["BENCH_WATCHDOG"] = "0"  # before the import: no watchdog thread
import bench as jax_bench  # noqa: E402
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics  # noqa: E402
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner  # noqa: E402
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer  # noqa: E402
from cadm_tpu_torch import bench  # noqa: E402
from cadm_tpu_torch.models.dynamics import Dynamics  # noqa: E402
from cadm_tpu_torch.planners.mpc import MPCPlanner  # noqa: E402
from cadm_tpu_torch.train.buffer import ReplayBuffer  # noqa: E402

TINY = dict(n_envs=4, t=2, cem_envs=1, candidates=16, horizon=2, batch=4,
            updates=1)
# 16 candidates: the smallest count whose elites (max(10, c // 10)) fit
CEM_ARGS, TRAIN_ARGS = (1, 16, 2), (4, 1)
KEYS = {"metric", "value", "unit", "vs_baseline", "secondary", "device",
        "shapes"}
SECONDARY = {"cem_model_rollouts_per_sec", "dynamics_train_steps_per_sec",
             "slim_humanoid_env_steps_per_sec"}


def capture(monkeypatch, dyn_cls, planner_cls, buffer_cls):
    """Record the configs each constructor is given, into a dict of lists."""
    seen = {"dynamics": [], "planner": [], "buffer": []}
    dyn_init, planner_init = dyn_cls.__init__, planner_cls.__init__
    create = buffer_cls.create

    def dyn(self, config, *args, **kwargs):
        seen["dynamics"].append(dataclasses.asdict(config))
        dyn_init(self, config, *args, **kwargs)

    def planner(self, config, model, reward_fn, act_dim, *args, **kwargs):
        seen["planner"].append((dataclasses.asdict(config), act_dim, args,
                                kwargs))
        planner_init(self, config, model, reward_fn, act_dim, *args, **kwargs)

    def buffer(n_envs, capacity, obs_dim, act_dim, *args, **kwargs):
        seen["buffer"].append((n_envs, capacity, obs_dim, act_dim))
        return create(n_envs, capacity, obs_dim, act_dim, *args, **kwargs)

    monkeypatch.setattr(dyn_cls, "__init__", dyn)
    monkeypatch.setattr(planner_cls, "__init__", planner)
    monkeypatch.setattr(buffer_cls, "create", staticmethod(buffer))
    return seen


def test_configs_match_the_reference(monkeypatch):
    with monkeypatch.context() as m:
        ref = capture(m, JaxDynamics, JaxPlanner, JaxBuffer)
        jax_bench.bench_cem(*CEM_ARGS)
        jax_bench.bench_train_steps(*TRAIN_ARGS)
    ours = capture(monkeypatch, Dynamics, MPCPlanner, ReplayBuffer)
    monkeypatch.setattr(bench, "ITERS", 1)
    bench.bench_cem(*CEM_ARGS, device="cpu")
    bench.bench_train_steps(*TRAIN_ARGS, device="cpu")

    assert len(ref["dynamics"]) == len(ours["dynamics"]) == 2
    assert ours["dynamics"] == ref["dynamics"]
    assert ref["dynamics"][0]["n_members"] == 5
    (jcfg, jact, jargs, jkw), = ref["planner"]
    (cfg, act, args, kw), = ours["planner"]
    jcfg.pop("max_parallel_rollouts")
    assert cfg == jcfg and act == jact == 6
    assert cfg["ensemble_eval"] == "ts1" and cfg["cem_elites"] == 10
    assert args == jargs == () and kw == jkw == {}
    assert ours["buffer"] == ref["buffer"] == [(64, 256, 17, 6)]


def test_lines_run_and_count_as_the_reference(monkeypatch):
    monkeypatch.setattr(bench, "ITERS", 1)
    rates = [bench.bench_env_steps(TINY["n_envs"], TINY["t"], device="cpu"),
             bench.bench_cem(*CEM_ARGS, device="cpu"),
             bench.bench_train_steps(*TRAIN_ARGS, device="cpu")]
    assert all(math.isfinite(r) and r > 0 for r in rates), rates
    # one second a call: each rate is then the count it divides
    calls = []
    monkeypatch.setattr(bench, "_time",
                        lambda fn, device: (calls.append(fn()), 1.0)[1])
    assert bench.bench_env_steps(4, 2, device="cpu") == 4 * 2
    assert bench.bench_cem(*CEM_ARGS, device="cpu") == 1 * 16 * 5 * 5
    assert bench.bench_train_steps(*TRAIN_ARGS, device="cpu") == 1
    assert len(calls) == 3 and torch.isfinite(calls[0])
    assert calls[1].shape == (1, 6) and calls[1].abs().max() <= 1.0


def test_smoke_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SMOKE", TINY)
    result = bench.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line == json.loads(json.dumps(result))
    assert set(line) == KEYS and set(line["secondary"]) == SECONDARY
    assert line["metric"] == "halfcheetah_env_steps_per_sec_per_chip"
    assert line["unit"] == "steps/sec/chip" and line["vs_baseline"] is None
    assert line["secondary"]["slim_humanoid_env_steps_per_sec"] is None
    assert line["device"] == {"type": "cpu", "name": None,
                              "power_limit": None}
    rates = [line["value"], line["secondary"]["cem_model_rollouts_per_sec"],
             line["secondary"]["dynamics_train_steps_per_sec"]]
    assert all(math.isfinite(r) and r > 0 for r in rates), rates
    assert line["shapes"]["env_steps"]["n_envs"] == 4
    assert line["shapes"]["slim_humanoid"] is None


def test_main_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_shapes_are_the_reference_s():
    assert bench.FULL == dict(n_envs=4096, t=100, cem_envs=256,
                              candidates=200, horizon=30, batch=256,
                              updates=50)
    assert bench.SMOKE == dict(n_envs=64, t=20, cem_envs=8, candidates=32,
                               horizon=5, batch=32, updates=5)
    assert bench.ITERS == 3 and bench.CEM_ITERS == 5
