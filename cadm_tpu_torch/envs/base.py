"""Environment API (counterpart of cadm_tpu/envs/base.py), batch-first.

- ``reset`` samples fresh hidden parameters per episode and returns a
  batch of initial states.
- ``step`` is a function of (state, action) over all envs at once; the
  auto-reset on done happens inside ``step`` with a fresh parameter draw.
- ``reward(obs, act, next_obs)`` is a batched function of observations only,
  so the planner scores model-predicted states with it.

Randomness comes from the ``torch.Generator`` the caller passes; it must
live on the env's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cadm_tpu_torch.core.types import EnvState, PyTree, tree_where

Tensor = torch.Tensor


class Env:
    """Base class for randomized-dynamics environments."""

    obs_dim: int
    act_dim: int
    horizon: int

    def __init__(self, randomization: str = "discrete",
                 horizon: "int | None" = None, device="cpu"):
        """``randomization``: "discrete" (the paper's per-mode scale sets)
        or "continuous" (uniform bands). ``horizon`` overrides the family's
        episode length. ``device`` holds every tensor the env makes."""
        self.randomization = randomization
        self.device = torch.device(device)
        if horizon is not None:
            self.horizon = horizon

    # --- primitive hooks ----------------------------------------------------
    def sample_params(self, gen: torch.Generator, mode: int, n: int) -> PyTree:
        raise NotImplementedError

    def init_phys(self, gen: torch.Generator, params: PyTree) -> PyTree:
        raise NotImplementedError

    def observe(self, params: PyTree, phys: PyTree) -> Tensor:
        raise NotImplementedError

    def step_phys(self, params: PyTree, phys: PyTree, action: Tensor) -> PyTree:
        raise NotImplementedError

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        raise NotImplementedError

    def terminated(self, params: PyTree, phys: PyTree, obs: Tensor) -> Tensor:
        """Early-termination predicate per env (False for most families)."""
        return torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)

    # Healthy-magnitude bounds for training data (inf = disabled); see the
    # reference for why blown-up transitions are masked out of training.
    bad_obs_limit: float = float("inf")
    bad_dobs_limit: float = float("inf")

    def bad_transition(self, obs: Tensor, next_obs: Tensor) -> Tensor:
        """True for transitions too large to be healthy training data."""
        o = next_obs.abs().amax(dim=-1)
        d = (next_obs - obs).abs().amax(dim=-1)
        return (o > self.bad_obs_limit) | (d > self.bad_dobs_limit)

    def unstable(self, phys: PyTree) -> Tensor:
        """Physics-stability guard per env: True ends the episode."""
        raise NotImplementedError

    def action_limits(self) -> Tuple[Tensor, Tensor]:
        ones = torch.ones(self.act_dim, device=self.device)
        return -ones, ones

    # --- composed API -------------------------------------------------------
    def reset(self, gen: torch.Generator, n: int, mode: int = 0) -> EnvState:
        params = self.sample_params(gen, mode, n)
        phys = self.init_phys(gen, params)
        return EnvState(
            phys=phys,
            obs=self.observe(params, phys),
            params=params,
            t=torch.zeros(n, dtype=torch.int32, device=self.device),
            done=torch.zeros(n, dtype=torch.bool, device=self.device),
        )

    def step(
        self, state: EnvState, action: Tensor, gen: torch.Generator,
        mode: int = 0,
    ) -> Tuple[EnvState, Tensor, Tensor, Tensor]:
        """Batched step with built-in auto-reset.

        Returns (next_state, obs_before_autoreset, reward, done). ``done`` is
        raised at the episode horizon, on early termination or on a physics
        blowup; where it fires, ``next_state`` is already a freshly reset
        episode with NEW hidden params.
        """
        low, high = self.action_limits()
        action = torch.clamp(action, low, high)
        phys = self.step_phys(state.params, state.phys, action)
        obs = self.observe(state.params, phys)
        # sanitize BEFORE reward/storage: the blown-up step still emits one
        # finite (clamped) transition, then `unstable` ends the episode
        obs = torch.clamp(torch.nan_to_num(obs, nan=0.0), -1e4, 1e4)
        reward = torch.nan_to_num(self.reward(state.obs, action, obs), nan=0.0)
        t = state.t + 1
        done = (
            (t >= self.horizon)
            | self.terminated(state.params, phys, obs)
            | self.unstable(phys)
        )
        stepped = dataclasses.replace(state, phys=phys, obs=obs, t=t, done=done)
        fresh = self.reset(gen, obs.shape[0], mode)
        next_state = tree_where(done, fresh, stepped)
        # keep the done flag visible to the caller even after auto-reset
        next_state.done = done
        return next_state, obs, reward, done
