"""Experiment config and the flagship preset (counterpart of
cadm_tpu/cli/presets.py).

``ExperimentConfig`` carries the reference's knobs for the model-based
trainer; ``build(device)`` assembles env, model, planner and trainer on one
device (the card unless the caller asks for the CPU). The port builds
``trainer="mb"`` with ``model`` ∈ {cadm, vanilla}, one deterministic member,
on the ported envs (HalfCheetah).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.train.mb_trainer import MBTrainer, TrainerConfig

CONTEXT_OF_MODEL = {"vanilla": "none", "cadm": "encoder"}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    trainer: str = "mb"
    # env
    env: str = "half_cheetah"
    n_envs: int = 16
    randomization: str = "discrete"   # paper scale sets | "continuous" bands
    env_horizon: Optional[int] = None
    # model
    model: str = "cadm"           # vanilla | cadm
    ensemble: int = 1
    hidden: Tuple[int, ...] = (200, 200, 200, 200)
    z_dim: int = 10
    history_k: int = 10
    future_m: int = 10
    beta_backward: float = 0.5
    lr: float = 1e-3
    # planner
    planner: str = "cem"          # rs | cem
    n_candidates: int = 200
    plan_horizon: int = 30
    cem_iters: int = 5
    cem_elites: int = 20
    warm_start: bool = False
    # training loop
    n_itr: int = 20
    steps_per_itr: int = 200
    model_updates_per_itr: int = 500
    batch_size: int = 128
    buffer_capacity: int = 8000
    eval_envs: int = 16
    eval_modes: Tuple[int, ...] = (0, 1, 2)
    eval_every: int = 1
    seed: int = 0
    # fit protocol: "epochs" = epoch passes with early stop on held-out
    # valid loss; "fixed" = a flat run of model_updates_per_itr updates
    fit_protocol: str = "fixed"
    max_epochs: int = 8
    early_stop_patience: int = 2
    early_stop_metric: str = "loss"   # "loss" | "fwd_mse"
    epoch_updates_cap: int = 400

    def build(self, device="cuda"):
        """(env, model, planner, trainer) on ``device``.

        Raises where the port cannot honour the config, including a CUDA
        device on a machine without one (it never falls back to the CPU).
        """
        device = resolve_device(device)
        if self.n_envs < 1 or self.eval_envs < 1:
            raise ValueError(
                f"n_envs/eval_envs must be >= 1, got {self.n_envs}/{self.eval_envs}"
            )
        if self.trainer != "mb" or self.model not in CONTEXT_OF_MODEL \
                or self.ensemble != 1:
            raise NotImplementedError(
                "the port builds trainer='mb' with model 'cadm'/'vanilla' and "
                f"one member; got trainer={self.trainer!r} model="
                f"{self.model!r} ensemble={self.ensemble}"
            )
        env = make(self.env, randomization=self.randomization, device=device,
                   horizon=self.env_horizon)
        model = Dynamics(
            DynamicsConfig(
                obs_dim=env.obs_dim,
                act_dim=env.act_dim,
                hidden=self.hidden,
                context=CONTEXT_OF_MODEL[self.model],
                z_dim=self.z_dim,
                history_k=self.history_k,
                future_m=self.future_m,
                beta_backward=self.beta_backward,
                lr=self.lr,
            ),
            device=device,
        )
        planner = MPCPlanner(
            PlannerConfig(
                kind=self.planner,
                horizon=self.plan_horizon,
                n_candidates=self.n_candidates,
                cem_iters=self.cem_iters,
                cem_elites=self.cem_elites,
                warm_start=self.warm_start,
            ),
            model,
            env.reward,
            env.act_dim,
            # env-defined blowup limits terminate+penalize exploding MODEL
            # rollouts
            bad_transition_fn=env.bad_transition,
            obs_limit=env.bad_obs_limit,
        )
        trainer = MBTrainer(
            env, model, planner,
            TrainerConfig(
                n_envs=self.n_envs,
                steps_per_itr=self.steps_per_itr,
                n_itr=self.n_itr,
                model_updates_per_itr=self.model_updates_per_itr,
                batch_size=self.batch_size,
                buffer_capacity=self.buffer_capacity,
                eval_envs=self.eval_envs,
                eval_modes=self.eval_modes,
                eval_every=self.eval_every,
                fit_protocol=self.fit_protocol,
                max_epochs=self.max_epochs,
                early_stop_patience=self.early_stop_patience,
                early_stop_metric=self.early_stop_metric,
                epoch_updates_cap=self.epoch_updates_cap,
            ),
        )
        return env, model, planner, trainer


PRESETS = {
    # HalfCheetah, randomized mass/damping, CaDM fwd+bwd + CEM @ 2048 envs
    # (the reference's values, cadm_tpu/cli/presets.py)
    "halfcheetah_cadm_cem": ExperimentConfig(
        env="half_cheetah", model="cadm", planner="cem", fit_protocol="epochs",
        n_envs=2048, n_candidates=200, plan_horizon=30,
        steps_per_itr=1000, n_itr=20, buffer_capacity=20000,
        model_updates_per_itr=2000, batch_size=256,
    ),
}
