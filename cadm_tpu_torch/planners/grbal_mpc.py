"""MPC planner for GrBAL: rollouts through per-env adapted fast weights
(counterpart of cadm_tpu/planners/grbal_mpc.py).

The planner's context slot carries each env's adapted net, layers
{"w": (E, in, out), "b": (E, out)} from ``GrBAL.context_from_history``.
The candidates of every env, rows (E, C, ·), run through their env's net as
one batched product per layer; the blowup guard and penalty are the MPC
planner's.
"""
from __future__ import annotations

from typing import Optional

import torch

from cadm_tpu_torch.models.dynamics import NormStats
from cadm_tpu_torch.models.nets import MLP
from cadm_tpu_torch.planners.mpc import MPCPlanner

Tensor = torch.Tensor


class GrBALPlanner(MPCPlanner):
    def _evaluate(self, params: dict, norm: NormStats, obs0: Tensor,
                  z: MLP, actions: Tensor,
                  gen: Optional[torch.Generator] = None,
                  members: Optional[Tensor] = None,
                  pred_noise: Optional[Tensor] = None) -> Tensor:
        """Return (E, C) of each env's candidate sequences (E, C, H, act)
        rolled through that env's adapted net ``z``."""
        e, c, h, _ = actions.shape
        obs = obs0[:, None].expand(e, c, obs0.shape[-1])

        def step(t, obs):
            a_t = actions[:, :, t]
            return a_t, self.model.predict(z, norm, obs, a_t)

        return self._rollout(obs, step, h)
