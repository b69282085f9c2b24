"""The port's CLI and entry points: a tiny two-iteration run on the CPU,
the flags the port offers and those it does not, and the card as the
default device."""
import csv
import dataclasses
import json

import pytest
import torch

from cadm_tpu_torch import envs
from cadm_tpu_torch.cli import run
from cadm_tpu_torch.cli.presets import PRESETS, ExperimentConfig
from cadm_tpu_torch.envs.cartpole import CartPoleEnv
from cadm_tpu_torch.envs.wrappers import NormalizedEnv
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.train.ppo import PPOTrainer
from cadm_tpu_torch.utils.convert import params_from_jax

# The reference trainer's row (cadm_tpu/train/mb_trainer.py:556-566): its
# jitted collect and fit return their dicts with sorted keys.
EXPECTED_KEYS = [
    "itr",
    "collect/bad_transition_frac", "collect/episodes",
    "collect/mean_episode_return", "collect/mean_step_reward",
    "fit/epochs_run", "fit/model_loss_first", "fit/model_loss_last",
    "fit/model_loss_mean", "fit/valid_fwd_mse_after", "fit/valid_loss_after",
    "fit/valid_loss_before", "fit/valid_monitored_best",
    "eval/return_mode0", "eval/return_mode0_std",
    "eval/return_mode1", "eval/return_mode1_std",
    "eval/return_mode2", "eval/return_mode2_std",
]
TINY = ["--preset", "halfcheetah_cadm_cem", "--hidden", "16,16",
        "--n-envs", "3", "--eval-envs", "2", "--n-candidates", "8",
        "--plan-horizon", "3", "--cem-iters", "1", "--cem-elites", "2",
        "--n-itr", "2", "--steps-per-itr", "6", "--env-horizon", "3",
        "--buffer-capacity", "30", "--batch-size", "8", "--max-epochs", "3"]


def test_cli_trains_on_the_cpu_and_writes_the_reference_logs(tmp_path):
    history = run.main(TINY + ["--device", "cpu", "--log-dir", str(tmp_path),
                               "--exp-name", "tiny"])
    assert [row["itr"] for row in history] == [0, 1]
    with open(tmp_path / "tiny" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == EXPECTED_KEYS
    for row in rows:
        # 3 envs, 6 steps of 3-step episodes: two episodes each
        assert float(row["collect/episodes"]) == 6.0
        assert 1 <= float(row["fit/epochs_run"]) <= 3
        for key in EXPECTED_KEYS:
            assert row[key] not in ("", "nan"), key
    with open(tmp_path / "tiny" / "params.json") as f:
        params = json.load(f)
    assert sorted(params) == sorted(
        f.name for f in dataclasses.fields(ExperimentConfig))
    assert params["steps_per_itr"] == 6 and params["n_envs"] == 3
    assert params["fit_protocol"] == "epochs" and params["max_epochs"] == 3
    assert (tmp_path / "tiny" / "debug.log").read_text().strip().endswith(
        "done.")


@pytest.mark.parametrize("flag", [["--checkpoint"], ["--resume"],
                                  ["--dump-trajs"], ["--dp", "2"],
                                  ["--model-par", "2"]])
def test_flags_the_port_cannot_honour_are_rejected(flag, monkeypatch):
    """The mesh flags are parsed, and rejected where they cannot be
    honoured: ``--dp`` without a launcher (no silent unsharded run) and
    ``--model-par`` without ``--dp`` (tests/test_torch_mesh*.py run them
    under a launcher); the checkpoint, resume and trajectory flags are
    ported and accepted (tests/test_torch_resume.py and
    test_torch_trajsink.py run them)."""
    argv = ["--preset", "halfcheetah_cadm_cem", *flag]
    if flag[0] in ("--dp", "--model-par"):
        args = run.build_parser().parse_args(argv)
        assert getattr(args, flag[0][2:].replace("-", "_")) == 2
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        err = RuntimeError if flag[0] == "--dp" else ValueError
        with pytest.raises(err, match="torchrun" if flag[0] == "--dp"
                           else "--dp"):
            run.main([*argv, "--device", "cpu"])
        return
    args = run.build_parser().parse_args(argv)
    assert getattr(args, flag[0][2:].replace("-", "_")) is True


def test_preset_carries_the_reference_fit_settings():
    cfg = PRESETS["halfcheetah_cadm_cem"]
    assert (cfg.future_m, cfg.beta_backward, cfg.lr, cfg.eval_every) == (
        10, 0.5, 1e-3, 1)
    assert (cfg.max_epochs, cfg.early_stop_patience, cfg.early_stop_metric,
            cfg.epoch_updates_cap, cfg.fit_protocol) == (8, 2, "loss", 400,
                                                         "epochs")
    _, model, _, trainer = dataclasses.replace(
        cfg, n_envs=2, eval_envs=2, buffer_capacity=10).build("cpu")
    assert (model.cfg.future_m, model.cfg.beta_backward, model.cfg.lr) == (
        10, 0.5, 1e-3)
    assert (trainer.cfg.max_epochs, trainer.cfg.epoch_updates_cap,
            trainer.cfg.batch_size, trainer.cfg.steps_per_itr) == (
        8, 400, 256, 1000)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DynamicsConfig(obs_dim=17, act_dim=6)
    for call in (lambda: ExperimentConfig().build(),
                 lambda: envs.make("half_cheetah"),
                 lambda: Dynamics(cfg),
                 lambda: params_from_jax({}, None),
                 lambda: run.main(TINY + ["--log-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------- the presets ------
TOY = dict(hidden=(8, 8), n_envs=2, eval_envs=2, n_candidates=6,
           plan_horizon=2, cem_iters=1, cem_elites=2, buffer_capacity=10,
           env_horizon=2)
MB_PRESETS = sorted(k for k, v in PRESETS.items() if v.trainer == "mb")
PPO_PRESETS = sorted(k for k, v in PRESETS.items() if v.trainer == "ppo")


def assert_reference_values(name):
    from cadm_tpu.cli.presets import PRESETS as JAX_PRESETS

    cfg, ref = PRESETS[name], JAX_PRESETS[name]
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    return cfg


def test_the_port_has_every_preset_of_the_reference():
    from cadm_tpu.cli.presets import PRESETS as JAX_PRESETS

    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    assert PPO_PRESETS == ["hopper_ppo_cadm", "slim_humanoid_ppo_cadm"]


@pytest.mark.parametrize("name", MB_PRESETS)
def test_every_rigid_preset_builds_on_the_cpu_with_the_reference_values(name):
    """Every model-based preset (the analytic cartpole and pendulum ones
    too) has the reference's values, builds on the CPU and evaluates."""
    cfg = assert_reference_values(name)
    env, model, planner, trainer = dataclasses.replace(cfg, **TOY).build("cpu")
    assert env.horizon == 2 and model.cfg.n_members == cfg.ensemble
    assert model.cfg.probabilistic == (cfg.ensemble > 1)
    assert planner.cfg.ensemble_eval == "ts1"
    gen = torch.Generator().manual_seed(0)
    returns = trainer.evaluate(trainer.init(gen)[3], 1, gen)
    assert returns.shape == (2,) and torch.isfinite(returns).all()


def ppo_evaluates(cfg):
    """Build a PPO config on the CPU and evaluate its initial policy."""
    env, model, planner, trainer = cfg.build("cpu")
    assert planner is None and isinstance(trainer, PPOTrainer)
    gen = torch.Generator().manual_seed(0)
    *_, ppo_state, dyn_state = trainer.init(gen)
    returns = trainer.evaluate(ppo_state, dyn_state, 1, gen)
    assert returns.shape == (2,) and torch.isfinite(returns).all()
    return env, model, trainer


@pytest.mark.parametrize("name", PPO_PRESETS)
def test_every_ppo_preset_builds_on_the_cpu_with_the_reference_values(name):
    """The PPO + CaDM presets: the reference's values, PPO knobs carried
    into PPOConfig, no planner; the toy build evaluates on the CPU."""
    cfg = assert_reference_values(name)
    env, model, trainer = ppo_evaluates(dataclasses.replace(
        cfg, **TOY, policy_hidden=(8, 8)))
    assert model.cfg.context == "encoder" and env.horizon == 2
    full = cfg.build("cpu")[3].cfg
    assert (full.n_envs, full.rollout_len, full.n_itr, full.policy_hidden,
            full.lr, full.ppo_epochs, full.minibatches,
            full.model_updates_per_itr, full.model_batch,
            full.buffer_capacity, full.eval_envs, full.eval_modes) == (
        128, 256, 60, (64, 64), 3e-4, 10, 8, 200, 256, 4096, 16, (0, 1, 2))


def test_cripple_ant_cli_run_writes_the_reference_columns(tmp_path):
    argv = ["--preset", "cripple_ant_cadm_ensemble_cem", "--hidden", "8,8",
            "--n-envs", "2", "--eval-envs", "2", "--n-candidates", "6",
            "--plan-horizon", "2", "--cem-iters", "1", "--cem-elites", "2",
            "--n-itr", "2", "--steps-per-itr", "4", "--env-horizon", "2",
            "--buffer-capacity", "20", "--batch-size", "4",
            "--max-epochs", "2", "--symmetry-aug", "true",
            "--device", "cpu", "--log-dir", str(tmp_path), "--exp-name", "ca"]
    history = run.main(argv)
    assert [row["itr"] for row in history] == [0, 1]
    with open(tmp_path / "ca" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == EXPECTED_KEYS
    for row in rows:
        assert float(row["collect/episodes"]) == 4.0
        for key in EXPECTED_KEYS:
            assert row[key] not in ("", "nan"), key
    with open(tmp_path / "ca" / "params.json") as f:
        params = json.load(f)
    assert params["ensemble"] == 5 and params["symmetry_aug"] is True


@pytest.mark.parametrize("override", [
    dict(trainer="ppo"), dict(model="stacked"), dict(model="rnn"),
    dict(model="grbal"), dict(normalize_env=True), dict(env="cartpole"),
    dict(env="pendulum"), dict(ensemble_eval="assign"),
])
def test_unported_options_raise_and_name_what_is_ported(override):
    """Every option here was once unported and is ported now: each builds
    and evaluates. The baselines (stacked, ReBAL, GrBAL), PPO, the
    NormalizedEnv wrapper, the analytic envs and the winner's-curse
    ``ensemble_eval='assign'`` (on a 2-member ensemble)."""
    if "ensemble_eval" in override:
        override = dict(override, ensemble=2)
    cfg = dataclasses.replace(PRESETS["hopper_cadm_cem"], **TOY, **override)
    if cfg.trainer == "ppo":
        ppo_evaluates(dataclasses.replace(cfg, policy_hidden=(8, 8)))
        return
    env, model, _, trainer = cfg.build("cpu")
    gen = torch.Generator().manual_seed(0)
    returns = trainer.evaluate(trainer.init(gen)[3], 0, gen)
    assert returns.shape == (2,) and torch.isfinite(returns).all()
    assert isinstance(env, NormalizedEnv) == cfg.normalize_env
    assert env.obs_dim == {"cartpole": 5, "pendulum": 3}.get(cfg.env, 11)
    if cfg.model == "grbal":
        assert model.cfg.hidden == (8, 8)
    elif cfg.model != "cadm":
        assert model.cfg.context == cfg.model


def test_the_default_config_is_the_references_cartpole():
    """A bare ExperimentConfig names cartpole, as the reference's, and
    builds a CaDM + CEM cartpole."""
    from cadm_tpu.cli.presets import ExperimentConfig as JaxExperimentConfig

    assert ExperimentConfig().env == JaxExperimentConfig().env == "cartpole"
    env, model, planner, _ = ExperimentConfig().build("cpu")
    assert isinstance(env, CartPoleEnv) and env.obs_dim == 5
    assert model.cfg.context == "encoder" and planner.cfg.kind == "cem"
