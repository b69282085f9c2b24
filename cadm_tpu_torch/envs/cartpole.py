"""CartPole with a continuous force action and a per-episode randomized push
force and pole length (counterpart of cadm_tpu/envs/cartpole.py).

The Barto–Sutton–Anderson cart-pole ODE (the equations of gym's CartPole)
under semi-implicit Euler at dt = 0.02; the force magnitude (nominal 10) and
the pole half-length (nominal 0.5) are the hidden parameters, each the
canonical scale set multiplied onto its nominal value. Observation
[x, ẋ, sinθ, cosθ, θ̇]; reward = cosθ − 0.01·x², from ``next_obs`` only.
"""
from __future__ import annotations

import dataclasses

import torch

from cadm_tpu_torch.envs.base import Env, uniform
from cadm_tpu_torch.envs.ranges import canonical

Tensor = torch.Tensor

NOMINAL_FORCE = 10.0
NOMINAL_LENGTH = 0.5  # gym convention: pole half-length


@dataclasses.dataclass
class CartPoleParams:
    force_mag: Tensor  # (E,) hidden per-episode push-force magnitude
    length: Tensor     # (E,) hidden per-episode pole half-length


@dataclasses.dataclass
class CartPolePhys:
    x: Tensor          # each (E,)
    x_dot: Tensor
    theta: Tensor
    theta_dot: Tensor


class CartPoleEnv(Env):
    obs_dim = 5
    act_dim = 1
    horizon = 200
    dt = 0.02

    gravity = 9.8
    mass_cart = 1.0
    mass_pole = 0.1

    def sample_params(self, gen: torch.Generator, mode: int, n: int
                      ) -> CartPoleParams:
        scale = canonical(self.randomization)
        return CartPoleParams(
            force_mag=scale.scaled(NOMINAL_FORCE).sample(gen, mode, n),
            length=scale.scaled(NOMINAL_LENGTH).sample(gen, mode, n),
        )

    def init_phys(self, gen: torch.Generator, params: CartPoleParams
                  ) -> CartPolePhys:
        s = uniform(gen, (params.length.shape[0], 4), -0.05, 0.05)
        return CartPolePhys(*s.unbind(-1))

    def observe(self, params: CartPoleParams, phys: CartPolePhys) -> Tensor:
        return torch.stack([phys.x, phys.x_dot, torch.sin(phys.theta),
                            torch.cos(phys.theta), phys.theta_dot], dim=-1)

    def step_phys(self, params: CartPoleParams, phys: CartPolePhys,
                  action: Tensor) -> CartPolePhys:
        force = params.force_mag * action[:, 0]
        total_mass = self.mass_cart + self.mass_pole
        ml = self.mass_pole * params.length
        cos_t, sin_t = torch.cos(phys.theta), torch.sin(phys.theta)
        temp = (force + ml * phys.theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            params.length * (4.0 / 3.0 - self.mass_pole * cos_t**2 / total_mass)
        )
        x_acc = temp - ml * theta_acc * cos_t / total_mass
        # semi-implicit Euler: velocities first, then positions
        x_dot = phys.x_dot + self.dt * x_acc
        theta_dot = phys.theta_dot + self.dt * theta_acc
        return CartPolePhys(x=phys.x + self.dt * x_dot, x_dot=x_dot,
                            theta=phys.theta + self.dt * theta_dot,
                            theta_dot=theta_dot)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        x, cos_t = next_obs[..., 0], next_obs[..., 3]
        return cos_t - 0.01 * x**2
