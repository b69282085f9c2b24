"""Pendulum swing-up with a per-episode randomized mass and length
(counterpart of cadm_tpu/envs/pendulum.py).

Pendulum-v0's dynamics with hidden (m, l): θ̈ = 3g/(2l)·sinθ + 3/(m l²)·u,
torque u = 2·a, dt = 0.05, |θ̇| ≤ 8. Mass and length are drawn from the
canonical scale set around the nominal 1.0. Observation [cosθ, sinθ, θ̇];
reward −(θ² + 0.1·θ̇² + 0.001·u²) with θ = atan2(sinθ, cosθ), from
(next_obs, act) only.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cadm_tpu_torch.envs.base import Env, uniform
from cadm_tpu_torch.envs.ranges import canonical

Tensor = torch.Tensor


@dataclasses.dataclass
class PendulumParams:
    mass: Tensor    # (E,)
    length: Tensor  # (E,)


@dataclasses.dataclass
class PendulumPhys:
    theta: Tensor      # (E,)
    theta_dot: Tensor  # (E,)


class PendulumEnv(Env):
    obs_dim = 3
    act_dim = 1
    horizon = 200
    dt = 0.05

    gravity = 10.0
    max_torque = 2.0
    max_speed = 8.0

    def sample_params(self, gen: torch.Generator, mode: int, n: int
                      ) -> PendulumParams:
        scale = canonical(self.randomization)
        return PendulumParams(mass=scale.sample(gen, mode, n),
                              length=scale.sample(gen, mode, n))

    def init_phys(self, gen: torch.Generator, params: PendulumParams
                  ) -> PendulumPhys:
        n = params.mass.shape[0]
        return PendulumPhys(theta=uniform(gen, (n,), -math.pi, math.pi),
                            theta_dot=uniform(gen, (n,), -1.0, 1.0))

    def observe(self, params: PendulumParams, phys: PendulumPhys) -> Tensor:
        return torch.stack([torch.cos(phys.theta), torch.sin(phys.theta),
                            phys.theta_dot], dim=-1)

    def step_phys(self, params: PendulumParams, phys: PendulumPhys,
                  action: Tensor) -> PendulumPhys:
        u = self.max_torque * action[:, 0]
        m, l, g = params.mass, params.length, self.gravity
        theta_acc = (3.0 * g / (2.0 * l) * torch.sin(phys.theta)
                     + 3.0 / (m * l**2) * u)
        theta_dot = torch.clamp(phys.theta_dot + self.dt * theta_acc,
                                -self.max_speed, self.max_speed)
        return PendulumPhys(theta=phys.theta + self.dt * theta_dot,
                            theta_dot=theta_dot)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        theta = torch.atan2(next_obs[..., 1], next_obs[..., 0])
        theta_dot = next_obs[..., 2]
        u = self.max_torque * act[..., 0]
        return -(theta**2 + 0.1 * theta_dot**2 + 0.001 * u**2)
