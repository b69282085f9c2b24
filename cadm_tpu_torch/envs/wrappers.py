"""Env wrappers (counterpart of cadm_tpu/envs/wrappers.py): the
reference's ``normalize()`` as ``NormalizedEnv``.

``NormalizedEnv`` rescales actions from the canonical [-1, 1] box onto the
wrapped env's limits and can whiten observations with running statistics.
The statistics live in the env state (``NormalizedPhys.stats``), one set per
env and per episode: the auto-reset starts them again at mean 0, var 1,
count 1e-4, as the reference's vmapped per-env state does.

As the reference's wrapper, it passes on only ``bad_transition``,
``reward`` and ``terminated``: it has no ``unstable`` of its own (the base's
all-False applies, so a wrapped rigid env loses its blow-up guard), its
``bad_obs_limit`` is inf and its ``symmetry_maps`` None.
"""
from __future__ import annotations

import dataclasses
import torch

from cadm_tpu_torch.core.types import PyTree, leading_dim
from cadm_tpu_torch.envs.base import Env

Tensor = torch.Tensor


@dataclasses.dataclass
class ObsStats:
    mean: Tensor   # (E, obs_dim)
    var: Tensor    # (E, obs_dim)
    count: Tensor  # (E,)

    @staticmethod
    def init(n: int, obs_dim: int, device=None) -> "ObsStats":
        return ObsStats(mean=torch.zeros(n, obs_dim, device=device),
                        var=torch.ones(n, obs_dim, device=device),
                        count=torch.full((n,), 1e-4, device=device))

    def update(self, obs: Tensor) -> "ObsStats":
        """Welford-style streaming update with one sample per env."""
        count = self.count + 1.0
        delta = obs - self.mean
        mean = self.mean + delta / count[:, None]
        var = self.var + (delta * (obs - mean) - self.var) / count[:, None]
        return ObsStats(mean=mean, var=var, count=count)


@dataclasses.dataclass
class NormalizedPhys:
    inner: PyTree
    stats: ObsStats


class NormalizedEnv(Env):
    """Wraps an Env: a [-1, 1] action box (the base's ``action_limits``)
    and optional per-env running observation whitening, clipped to
    ±``clip_obs``."""

    def __init__(self, env: Env, normalize_obs: bool = False,
                 clip_obs: float = 10.0):
        self.env = env
        self.normalize_obs = normalize_obs
        self.clip_obs = clip_obs
        self.obs_dim = env.obs_dim
        self.act_dim = env.act_dim
        self.horizon = env.horizon
        self.dt = env.dt
        self.randomization = env.randomization
        self.device = env.device

    def sample_params(self, gen, mode, n):
        return self.env.sample_params(gen, mode, n)

    def init_phys(self, gen, params) -> NormalizedPhys:
        inner = self.env.init_phys(gen, params)
        return NormalizedPhys(inner=inner, stats=ObsStats.init(
            leading_dim(inner), self.obs_dim, self.device))

    def observe(self, params, phys: NormalizedPhys) -> Tensor:
        obs = self.env.observe(params, phys.inner)
        if not self.normalize_obs:
            return obs
        white = (obs - phys.stats.mean) / torch.sqrt(phys.stats.var + 1e-8)
        return torch.clamp(white, -self.clip_obs, self.clip_obs)

    def step_phys(self, params, phys: NormalizedPhys, action: Tensor
                  ) -> NormalizedPhys:
        lo, hi = self.env.action_limits()
        native = lo + 0.5 * (action + 1.0) * (hi - lo)
        inner = self.env.step_phys(params, phys.inner, native)
        stats = phys.stats
        if self.normalize_obs:
            stats = stats.update(self.env.observe(params, inner))
        return NormalizedPhys(inner=inner, stats=stats)

    def bad_transition(self, obs: Tensor, next_obs: Tensor) -> Tensor:
        # the wrapped env's magnitude limits (meaningful on raw
        # observations, the mode the trainers use)
        return self.env.bad_transition(obs, next_obs)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        # on raw observations: with normalize_obs the planner's reward
        # invariant holds only if the inner reward is whitening-invariant
        return self.env.reward(obs, act, next_obs)

    def terminated(self, params, phys: NormalizedPhys, obs: Tensor) -> Tensor:
        return self.env.terminated(params, phys.inner, obs)
