"""Hopper with per-episode randomized mass & damping scales (counterpart of
cadm_tpu/envs/hopper.py).

Observation [qpos[1:], clip(qvel, ±10)] (11,); reward = forward velocity +
healthy-gated alive bonus − 0.001·‖a‖², all from observations (vx at index
5). Healthy termination on height, pitch and observation magnitude, switched
off with ``terminate_unhealthy=False`` (the MBBL fixed-horizon protocol).
"""
from __future__ import annotations

import torch

from cadm_tpu_torch.core.types import PyTree, constant
from cadm_tpu_torch.envs.base import uniform
from cadm_tpu_torch.envs.rigid_base import RigidEnv, RigidPhys

Tensor = torch.Tensor


class HopperEnv(RigidEnv):
    asset = "hopper"
    frame_skip = 4
    horizon = 500
    obs_dim = 11

    alive_bonus = 1.0
    ctrl_cost = 1e-3
    terminate_unhealthy = True
    _vx_index = 5

    def init_phys(self, gen: torch.Generator, params: PyTree) -> RigidPhys:
        n = params.mass_scale.shape[0]
        qpos0 = constant(self.sys.default_qpos(), self.device)
        qpos = qpos0 + uniform(gen, (n, self.sys.nq), -5e-3, 5e-3)
        qvel = uniform(gen, (n, self.sys.nv), -5e-3, 5e-3)
        return RigidPhys(qpos=qpos, qvel=qvel)

    def observe(self, params: PyTree, phys: RigidPhys) -> Tensor:
        return torch.cat([phys.qpos[:, 1:], phys.qvel.clamp(-10.0, 10.0)],
                         dim=-1)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        """vx + alive bonus − ctrl cost. With healthy termination the bonus
        is paid only while the (predicted) state is healthy, so the planner
        prices a predicted fall; without it the bonus is the reference's
        unconditional +1 per step."""
        vx = next_obs[..., self._vx_index]
        if self.terminate_unhealthy:
            z, pitch = next_obs[..., 0], next_obs[..., 1]
            healthy = ((z > 0.7) & (pitch.abs() < 0.2)).to(vx.dtype)
        else:
            healthy = 1.0
        return (vx + self.alive_bonus * healthy
                - self.ctrl_cost * torch.sum(act**2, dim=-1))

    def terminated(self, params: PyTree, phys: RigidPhys, obs: Tensor) -> Tensor:
        if not self.terminate_unhealthy:
            return torch.zeros(obs.shape[0], dtype=torch.bool,
                               device=obs.device)
        z, pitch = phys.qpos[:, 1], phys.qpos[:, 2]
        healthy = ((z > 0.7) & (pitch.abs() < 0.2)
                   & (obs[:, 1:].abs() < 100.0).all(-1))
        return ~healthy
