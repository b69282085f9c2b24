"""Experiment config and every preset of the reference (counterpart of
cadm_tpu/cli/presets.py).

``ExperimentConfig`` carries the reference's knobs; ``build(device)``
assembles (env, model, planner, trainer) on one device (the card unless the
caller asks for the CPU); ``build(mesh=mesh)`` assembles this rank's on the
rank's device, its trainer splitting the envs and members over the mesh.
``trainer="mb"`` takes ``model`` ∈ {vanilla, stacked, cadm, rnn} (one
member or a PE-TS ensemble) or ``grbal`` (its net takes ``hidden[:3]``);
``trainer="ppo"`` is PPO + CaDM with ``model`` ∈ {vanilla, stacked, cadm}
and no planner. Every env family (cartpole, the
default env as in the reference; pendulum, half_cheetah, hopper, ant,
cripple_ant, slim_humanoid), optionally wrapped in ``NormalizedEnv``
(``normalize_env``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.wrappers import NormalizedEnv
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.models.grbal import GrBAL, GrBALConfig
from cadm_tpu_torch.planners.grbal_mpc import GrBALPlanner
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.train.mb_trainer import MBTrainer, TrainerConfig
from cadm_tpu_torch.train.ppo import PPOConfig, PPOTrainer

CONTEXT_OF_MODEL = {"vanilla": "none", "stacked": "stacked",
                    "cadm": "encoder", "rnn": "rnn"}
# the reference's PPO stack knows no recurrent or adapted model
PPO_MODELS = ("vanilla", "stacked", "cadm")
PORTED = ("trainer='mb' with model 'vanilla'/'stacked'/'cadm'/'rnn' (any "
          "ensemble size) or 'grbal'; trainer='ppo' with model "
          "'vanilla'/'stacked'/'cadm'; every env family, normalize_env "
          "either way")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    trainer: str = "mb"
    # env
    env: str = "cartpole"
    n_envs: int = 16
    randomization: str = "discrete"   # paper scale sets | "continuous" bands
    # wrap in NormalizedEnv: actions rescaled from [-1, 1] onto the env's
    # limits (observation whitening is the wrapper's own opt-in)
    normalize_env: bool = False
    # episode protocol overrides (None = the family's default);
    # terminate_unhealthy=False, env_horizon=1000 is the MBBL protocol
    terminate_unhealthy: Optional[bool] = None
    env_horizon: Optional[int] = None
    # model
    model: str = "cadm"           # vanilla | stacked | cadm | rnn | grbal
    ensemble: int = 1             # >1 = PE-TS-style probabilistic ensemble
    # None = probabilistic heads iff ensemble > 1 (the PETS convention)
    probabilistic: Optional[bool] = None
    mean_anchor: float = 1.0      # see DynamicsConfig.mean_anchor
    detach_logvar_trunk: bool = False
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
    ensemble_eval: str = "ts1"    # ts1 | mean | ts1_exact | assign (mpc.py)
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
    # symmetry-group train-batch augmentation (envs with symmetry_maps())
    symmetry_aug: bool = False
    # PPO-only knobs (trainer="ppo")
    rollout_len: int = 256
    ppo_lr: float = 3e-4
    ppo_epochs: int = 10
    ppo_minibatches: int = 8
    policy_hidden: Tuple[int, ...] = (64, 64)

    def build(self, device=None, mesh=None):
        """(env, model, planner, trainer) on ``device`` (default ``cuda``);
        PPO has no planner (None). With a ``parallel.mesh.Mesh`` this rank's,
        on the mesh's device (``device`` must then be None).

        Raises where the port cannot honour the config, including a CUDA
        device on a machine without one (it never falls back to the CPU),
        and (``ValueError``) where the mesh's axes do not divide the envs or
        the ensemble members.
        """
        if mesh is not None and device is not None:
            raise ValueError("build(mesh=...) runs on the mesh's device: "
                             "pass no device")
        device = mesh.device if mesh is not None else resolve_device(
            device or "cuda")
        if self.n_envs < 1 or self.eval_envs < 1:
            raise ValueError(
                f"n_envs/eval_envs must be >= 1, got {self.n_envs}/{self.eval_envs}"
            )
        if self.trainer not in ("mb", "ppo") or (
                self.model not in CONTEXT_OF_MODEL and self.model != "grbal"):
            raise NotImplementedError(
                f"not ported: trainer={self.trainer!r} model={self.model!r} "
                f"(ported: {PORTED})"
            )
        env = make(self.env, randomization=self.randomization, device=device,
                   terminate_unhealthy=self.terminate_unhealthy,
                   horizon=self.env_horizon)
        if self.normalize_env:
            env = NormalizedEnv(env)
        if self.trainer == "ppo":
            return self._build_ppo(env, device, mesh)
        if self.model == "grbal":
            return self._build_grbal(env, device, mesh)
        model = self._dynamics(env, device, mesh)
        planner = MPCPlanner(
            PlannerConfig(
                kind=self.planner,
                horizon=self.plan_horizon,
                n_candidates=self.n_candidates,
                cem_iters=self.cem_iters,
                cem_elites=self.cem_elites,
                warm_start=self.warm_start,
                ensemble_eval=self.ensemble_eval,
            ),
            model,
            env.reward,
            env.act_dim,
            # env-defined blowup limits terminate+penalize exploding MODEL
            # rollouts
            bad_transition_fn=env.bad_transition,
            obs_limit=env.bad_obs_limit,
        )
        trainer = MBTrainer(env, model, planner,
                            self._trainer_config(self.symmetry_aug), mesh)
        return env, model, planner, trainer

    def _dynamics(self, env, device, mesh) -> Dynamics:
        return Dynamics(
            DynamicsConfig(
                obs_dim=env.obs_dim,
                act_dim=env.act_dim,
                hidden=self.hidden,
                n_members=self.ensemble,
                probabilistic=(self.ensemble > 1 if self.probabilistic is None
                               else self.probabilistic),
                context=CONTEXT_OF_MODEL[self.model],
                z_dim=self.z_dim,
                history_k=self.history_k,
                future_m=self.future_m,
                beta_backward=self.beta_backward,
                lr=self.lr,
                mean_anchor=self.mean_anchor,
                detach_logvar_trunk=self.detach_logvar_trunk,
            ),
            device=device,
            mesh=mesh,
        )

    def _build_ppo(self, env, device, mesh):
        """PPO + CaDM as the reference builds it (its context map has no
        'rnn' or 'grbal': those raise ``KeyError``, as there)."""
        if self.model not in PPO_MODELS:
            raise KeyError(f"trainer='ppo' takes model in {PPO_MODELS}, not "
                           f"{self.model!r} (ported: {PORTED})")
        model = self._dynamics(env, device, mesh)
        trainer = PPOTrainer(
            env,
            model,
            PPOConfig(
                n_envs=self.n_envs,
                rollout_len=self.rollout_len,
                n_itr=self.n_itr,
                policy_hidden=self.policy_hidden,
                lr=self.ppo_lr,
                ppo_epochs=self.ppo_epochs,
                minibatches=self.ppo_minibatches,
                model_updates_per_itr=self.model_updates_per_itr,
                model_batch=self.batch_size,
                buffer_capacity=self.buffer_capacity,
                eval_envs=self.eval_envs,
                eval_modes=self.eval_modes,
            ),
            mesh,
        )
        return env, model, None, trainer

    def _trainer_config(self, symmetry_aug: bool) -> TrainerConfig:
        return TrainerConfig(
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
            symmetry_aug=symmetry_aug,
        )

    def _build_grbal(self, env, device, mesh):
        """GrBAL as the reference builds it: a net of ``hidden[:3]``, its
        planner without the ensemble knob, no symmetry augmentation. Its
        one net has no member axis to split (a mesh's model axis > 1
        raises)."""
        model = GrBAL(
            GrBALConfig(
                obs_dim=env.obs_dim,
                act_dim=env.act_dim,
                hidden=self.hidden[:3],
                history_k=self.history_k,
                future_m=self.future_m,
                lr=self.lr,
            ),
            device=device,
        )
        planner = GrBALPlanner(
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
            bad_transition_fn=env.bad_transition,
            obs_limit=env.bad_obs_limit,
        )
        trainer = MBTrainer(env, model, planner, self._trainer_config(False),
                            mesh)
        return env, model, planner, trainer


# The reference's presets with its values (cadm_tpu/cli/presets.py:303-362)
PRESETS = {
    # CartPole, randomized force/length, vanilla DM + RS-MPC
    "cartpole_vanilla_rs": ExperimentConfig(
        env="cartpole", model="vanilla", planner="rs",
        n_envs=8, n_candidates=500, plan_horizon=20, history_k=10, future_m=5,
        steps_per_itr=210, n_itr=15,
    ),
    # Pendulum, randomized mass/length, CaDM encoder + CEM-MPC
    "pendulum_cadm_cem": ExperimentConfig(
        env="pendulum", model="cadm", planner="cem", fit_protocol="epochs",
        n_envs=8, n_candidates=200, plan_horizon=20,
        steps_per_itr=210, n_itr=15,
    ),
    # HalfCheetah, randomized mass/damping, CaDM fwd+bwd + CEM @ 2048 envs
    "halfcheetah_cadm_cem": ExperimentConfig(
        env="half_cheetah", model="cadm", planner="cem", fit_protocol="epochs",
        n_envs=2048, n_candidates=200, plan_horizon=30,
        steps_per_itr=1000, n_itr=20, buffer_capacity=20000,
        model_updates_per_itr=2000, batch_size=256,
    ),
    # Ant + CrippledAnt, CaDM PE-TS ensemble (5 members) + CEM
    "ant_cadm_ensemble_cem": ExperimentConfig(
        env="ant", model="cadm", ensemble=5, planner="cem",
        fit_protocol="epochs",
        n_envs=1024, n_candidates=200, plan_horizon=30,
        steps_per_itr=1000, n_itr=20, buffer_capacity=20000,
        model_updates_per_itr=2000, batch_size=256,
    ),
    "cripple_ant_cadm_ensemble_cem": ExperimentConfig(
        env="cripple_ant", model="cadm", ensemble=5, planner="cem",
        fit_protocol="epochs",
        n_envs=1024, n_candidates=200, plan_horizon=30,
        steps_per_itr=1000, n_itr=20, buffer_capacity=20000,
        model_updates_per_itr=2000, batch_size=256,
    ),
    # SlimHumanoid / Hopper, CaDM + CEM @ 512 envs
    "slim_humanoid_cadm_cem": ExperimentConfig(
        env="slim_humanoid", model="cadm", planner="cem",
        fit_protocol="epochs",
        n_envs=512, n_candidates=200, plan_horizon=30,
        steps_per_itr=500, n_itr=20, buffer_capacity=10000,
        model_updates_per_itr=2000, batch_size=256,
    ),
    "hopper_cadm_cem": ExperimentConfig(
        env="hopper", model="cadm", planner="cem", fit_protocol="epochs",
        n_envs=512, n_candidates=200, plan_horizon=30,
        steps_per_itr=500, n_itr=20, buffer_capacity=10000,
        model_updates_per_itr=2000, batch_size=256,
    ),
    # PPO + CaDM (paper §4.3): policy on concat(obs, z), shifted-range eval
    "hopper_ppo_cadm": ExperimentConfig(
        trainer="ppo", env="hopper", model="cadm",
        n_envs=128, rollout_len=256, n_itr=60,
        model_updates_per_itr=200, batch_size=256, buffer_capacity=4096,
        eval_envs=16,
    ),
    "slim_humanoid_ppo_cadm": ExperimentConfig(
        trainer="ppo", env="slim_humanoid", model="cadm",
        n_envs=128, rollout_len=256, n_itr=60,
        model_updates_per_itr=200, batch_size=256, buffer_capacity=4096,
        eval_envs=16,
    ),
}
