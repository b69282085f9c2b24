"""HalfCheetah with per-episode randomized mass & damping scales
(counterpart of cadm_tpu/envs/half_cheetah.py).

Observation [qpos[1:], qvel] (17,): the root x position is left out and the
root x velocity sits at index 8; reward = forward velocity − 0.05·‖a‖²,
computable from observations alone.
"""
from __future__ import annotations

import torch

from cadm_tpu_torch.core.types import PyTree, constant
from cadm_tpu_torch.envs.rigid_base import RigidEnv, RigidPhys
from cadm_tpu_torch.core.rng import rand, randn

Tensor = torch.Tensor


class HalfCheetahEnv(RigidEnv):
    asset = "half_cheetah"
    frame_skip = 5
    horizon = 1000
    obs_dim = 17

    ctrl_cost = 0.05
    _vx_index = 8  # qvel[0] position within obs

    def init_phys(self, gen: torch.Generator, params: PyTree) -> RigidPhys:
        n = params.mass_scale.shape[0]
        nq, nv = self.sys.nq, self.sys.nv
        qpos0 = constant(self.sys.default_qpos(), self.device)
        noise = rand(gen, n, nq)
        qvel = 0.1 * randn(gen, n, nv)
        return RigidPhys(qpos=qpos0 + (0.2 * noise - 0.1), qvel=qvel)

    def observe(self, params: PyTree, phys: RigidPhys) -> Tensor:
        return torch.cat([phys.qpos[:, 1:], phys.qvel], dim=-1)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        vx = next_obs[..., self._vx_index]
        return vx - self.ctrl_cost * torch.sum(act**2, dim=-1)
