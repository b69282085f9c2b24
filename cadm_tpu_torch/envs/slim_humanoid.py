"""SlimHumanoid with per-episode randomized mass & damping scales
(counterpart of cadm_tpu/envs/slim_humanoid.py).

The gym humanoid model with the slim observation [qpos[2:], qvel] (45,):
none of gym's cinert/cvel/cfrc blocks. Reward = healthy-gated alive bonus +
1.25·vx − 0.1·‖a‖², from observations (vx at index 22 is the root's world x
velocity). Healthy termination while the torso height leaves (1, 2).
"""
from __future__ import annotations

import torch

from cadm_tpu_torch.core.types import PyTree, constant
from cadm_tpu_torch.envs.base import uniform
from cadm_tpu_torch.envs.rigid_base import (
    RigidEnv,
    RigidPhys,
    normalize_root_quat,
)

Tensor = torch.Tensor


class SlimHumanoidEnv(RigidEnv):
    asset = "slim_humanoid"
    frame_skip = 5
    horizon = 500
    obs_dim = 45

    alive_bonus = 5.0
    vel_weight = 1.25
    ctrl_cost = 0.1
    terminate_unhealthy = True
    _vx_index = 22

    def init_phys(self, gen: torch.Generator, params: PyTree) -> RigidPhys:
        n = params.mass_scale.shape[0]
        qpos0 = constant(self.sys.default_qpos(), self.device)
        qpos = qpos0 + uniform(gen, (n, self.sys.nq), -0.01, 0.01)
        qvel = uniform(gen, (n, self.sys.nv), -0.01, 0.01)
        return RigidPhys(qpos=normalize_root_quat(qpos), qvel=qvel)

    def observe(self, params: PyTree, phys: RigidPhys) -> Tensor:
        return torch.cat([phys.qpos[:, 2:], phys.qvel], dim=-1)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        """Alive bonus + velocity − ctrl cost; with healthy termination the
        bonus is paid only while the torso height (obs[0] = qpos[2]) is in
        the healthy band, as in HopperEnv.reward."""
        vx = next_obs[..., self._vx_index]
        if self.terminate_unhealthy:
            z = next_obs[..., 0]
            healthy = ((z > 1.0) & (z < 2.0)).to(vx.dtype)
        else:
            healthy = 1.0
        return (self.alive_bonus * healthy + self.vel_weight * vx
                - self.ctrl_cost * torch.sum(act**2, dim=-1))

    def terminated(self, params: PyTree, phys: RigidPhys, obs: Tensor) -> Tensor:
        if not self.terminate_unhealthy:
            return torch.zeros(obs.shape[0], dtype=torch.bool,
                               device=obs.device)
        z = phys.qpos[:, 2]
        return (z < 1.0) | (z > 2.0)
