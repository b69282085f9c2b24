"""Model-based trainer (counterpart of cadm_tpu/train/mb_trainer.py).

This slice ports the acting path: ``init`` builds the env batch, the
context histories and the model state, and ``evaluate`` runs one
planner-driven episode per eval env on a dynamics range (plan → env step,
the reference's ``_eval_impl``). The random-action collect, the replay ring
and the model fit come with the training port.
"""
from __future__ import annotations

import dataclasses

import torch

from cadm_tpu_torch.core.types import batched_history
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsState
from cadm_tpu_torch.planners.mpc import MPCPlanner

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The acting path's knobs; the collect/fit knobs come with their port."""

    n_envs: int = 8
    eval_envs: int = 8


class MBTrainer:
    def __init__(self, env: Env, model: Dynamics, planner: MPCPlanner,
                 config: TrainerConfig):
        self.env = env
        self.model = model
        self.planner = planner
        self.cfg = config

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator):
        """(env states, histories, model state) for ``n_envs`` envs."""
        env_states = self.env.reset(gen, self.cfg.n_envs)
        hists = batched_history(self.model.cfg, self.cfg.n_envs,
                                self.env.device)
        return env_states, hists, self.model.init_state(gen)

    # ------------------------------------------------------------- eval --
    @torch.no_grad()
    def evaluate(self, dyn_state: DynamicsState, mode: int,
                 gen: torch.Generator) -> Tensor:
        """One planner-driven episode per eval env → returns (eval_envs,).

        Runs ``env.horizon`` control steps; each env's return stops
        accumulating at its first done (later auto-reset episodes are not
        counted), as in the reference.
        """
        env, model, n = self.env, self.model, self.cfg.eval_envs
        states = env.reset(gen, n, mode)
        hists = batched_history(model.cfg, n, env.device)
        ret = torch.zeros(n, device=env.device)
        alive = torch.ones(n, device=env.device)
        plan_mu = self.planner.init_plan(n, env.device)
        for _ in range(env.horizon):
            z = model.context_from_history(dyn_state.params, dyn_state.norm,
                                           hists)
            actions, plan_mu = self.planner.plan(dyn_state, states.obs, z,
                                                 gen, plan_mu)
            prev_obs = states.obs
            states, obs, reward, done = env.step(states, actions, gen, mode)
            hists = model.push_history(dyn_state.params, dyn_state.norm,
                                       hists, prev_obs, obs - prev_obs,
                                       actions)
            ret = ret + reward * alive
            alive = alive * (1.0 - done.float())
        return ret
