"""MPC planners: random shooting (RS) and the cross-entropy method (CEM).

Counterpart of cadm_tpu/planners/mpc.py. Sample ``n_candidates`` action
sequences per env, roll them ``horizon`` steps through the learned dynamics
model (the CaDM context z frozen for the whole plan), score them with the
env's observation-only reward, and act with the first action of the best
sequence; CEM refits a Gaussian on the top elites each iteration.

All envs plan at once: candidates of every env form one (E·C)-row batch per
model step, so a plan at 2048 envs × 200 candidates is 409,600 rows in one
block (the reference's libtpu row-chunking is not needed on the card). This
slice supports the single deterministic member (n_members = 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsState, NormStats
from cadm_tpu_torch.models.nets import member

Tensor = torch.Tensor
RewardFn = Callable[[Tensor, Tensor, Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    kind: str = "cem"          # 'rs' | 'cem'
    horizon: int = 30
    n_candidates: int = 200
    cem_iters: int = 5
    cem_elites: int = 20
    cem_alpha: float = 0.1     # momentum on (mu, sigma) across CEM iterations
    init_sigma: float = 0.5
    warm_start: bool = False   # receding-horizon: shift last plan's mean
    # One-time return penalty for a candidate whose MODEL rollout blows up
    # (crosses the env's bad_transition limits or goes non-finite); its later
    # rewards are masked and its state clamped (see the reference for why a
    # penalty and not plain masking).
    blowup_penalty: float = 1.0e4


class MPCPlanner:
    def __init__(
        self,
        config: PlannerConfig,
        model: Dynamics,
        reward_fn: RewardFn,
        act_dim: int,
        bad_transition_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        obs_limit: float = float("inf"),
    ):
        if model.cfg.n_members != 1:
            raise NotImplementedError("the port plans with one member")
        self.cfg = config
        self.model = model
        self.reward_fn = reward_fn
        self.act_dim = act_dim
        self.bad_transition_fn = bad_transition_fn
        self.obs_limit = float(obs_limit)
        self._guard_on = bad_transition_fn is not None and math.isfinite(
            self.obs_limit
        )

    def _guard(self, obs: Tensor, next_obs: Tensor, alive: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
        """Clamp a model-rollout step and latch per-row termination.

        Returns (next_obs', alive', blown_now): next_obs' is finite and
        within ±obs_limit; alive' zeroes rows that ever blew; blown_now
        flags rows that blew at THIS step (for the one-time penalty).
        """
        if not self._guard_on:
            return next_obs, alive, torch.zeros_like(alive)
        bad = self.bad_transition_fn(obs, next_obs) | ~torch.isfinite(
            next_obs
        ).all(dim=-1)
        new_alive = alive * (1.0 - bad.to(obs.dtype))
        blown_now = alive - new_alive
        lim = self.obs_limit
        next_obs = torch.clamp(
            torch.nan_to_num(next_obs, nan=0.0, posinf=lim, neginf=-lim),
            -lim, lim,
        )
        return next_obs, new_alive, blown_now

    # ------------------------------------------------------------ rollout --
    def _evaluate(self, params: dict, norm: NormStats, obs0: Tensor,
                  z: Tensor, actions: Tensor) -> Tensor:
        """Return (E, C) of each env's candidate sequences (E, C, H, act)."""
        e, c, h, _ = actions.shape
        fwd = member(params["fwd"], 0)
        obs = obs0[:, None].expand(e, c, obs0.shape[-1]).reshape(e * c, -1)
        zz = z[:, None].expand(e, c, z.shape[-1]).reshape(e * c, -1)
        alive = torch.ones(e * c, device=obs.device)
        total = torch.zeros(e * c, device=obs.device)
        for t in range(h):
            a_t = actions[:, :, t].reshape(e * c, -1)
            next_obs = self.model.predict(params, norm, fwd, obs, a_t, zz)
            next_obs, alive_next, blown = self._guard(obs, next_obs, alive)
            total += (
                self.reward_fn(obs, a_t, next_obs) * alive_next
                - self.cfg.blowup_penalty * blown
            )
            obs, alive = next_obs, alive_next
        return total.reshape(e, c)

    def _refit(self, actions: Tensor, returns: Tensor) -> Tuple[Tensor, Tensor]:
        """CEM refit: (mean, population std) of each env's top elites.

        actions (E, C, H, act), returns (E, C); a NaN return ranks last and
        ties go to the lower index, as under ``jax.lax.top_k`` (a blown-up
        env's candidates all tie at −blowup_penalty).
        """
        returns = torch.where(torch.isnan(returns), -math.inf, returns)
        order = torch.sort(returns, dim=1, descending=True, stable=True).indices
        elite_idx = order[:, : self.cfg.cem_elites]
        rows = torch.arange(actions.shape[0], device=actions.device)[:, None]
        elites = actions[rows, elite_idx]                  # (E, K, H, act)
        return elites.mean(dim=1), elites.std(dim=1, correction=0)

    # ---------------------------------------------------------------- act --
    def _plan(self, params: dict, norm: NormStats, obs: Tensor, z: Tensor,
              prev_mu: Tensor, gen: torch.Generator,
              noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Plan for every env → (first actions (E, act), plan means (E, H, act)).

        The reference's per-env ``_plan_single`` over a leading env axis.
        ``noise`` replaces the sampled randomness (tests feed both packages
        the same numbers): CEM's truncated-normal ε, (cem_iters, E, C, H,
        act); RS's uniform actions, (E, C, H, act).
        """
        cfg = self.cfg
        e = obs.shape[0]
        shape = (e, cfg.n_candidates, cfg.horizon, self.act_dim)
        if cfg.kind == "rs":
            actions = noise if noise is not None else (
                2.0 * torch.rand(shape, generator=gen, device=obs.device) - 1.0
            )
            returns = self._evaluate(params, norm, obs, z, actions)
            # NaN compares False under argmax: make it lose explicitly
            returns = torch.where(torch.isnan(returns), -math.inf, returns)
            best = torch.argmax(returns, dim=1)
            rows = torch.arange(e, device=obs.device)
            return actions[rows, best, 0], actions[rows, best]

        # --- CEM --- (warm start: receding-horizon shift of last mean)
        if cfg.warm_start:
            mu = torch.cat([prev_mu[:, 1:], torch.zeros_like(prev_mu[:, :1])], 1)
        else:
            mu = torch.zeros(shape[0], *shape[2:], device=obs.device)
        sigma = torch.full_like(mu, cfg.init_sigma)
        for i in range(cfg.cem_iters):
            if noise is not None:
                eps = noise[i]
            else:
                eps = torch.empty(shape, device=obs.device)
                torch.nn.init.trunc_normal_(eps, 0.0, 1.0, -2.0, 2.0,
                                            generator=gen)
            actions = torch.clamp(mu[:, None] + sigma[:, None] * eps, -1.0, 1.0)
            returns = self._evaluate(params, norm, obs, z, actions)
            new_mu, new_sigma = self._refit(actions, returns)
            mu = cfg.cem_alpha * mu + (1 - cfg.cem_alpha) * new_mu
            sigma = cfg.cem_alpha * sigma + (1 - cfg.cem_alpha) * new_sigma
        return mu[:, 0], mu

    def init_plan(self, n_envs: int, device=None) -> Tensor:
        """Zero warm-start means, (E, H, act_dim)."""
        return torch.zeros(n_envs, self.cfg.horizon, self.act_dim,
                           device=device)

    def plan(self, state: DynamicsState, obs: Tensor, z: Tensor,
             gen: torch.Generator, prev_mu: Optional[Tensor] = None,
             noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Batched planning → (actions (E, act), plan means (E, H, act))."""
        if prev_mu is None:
            prev_mu = self.init_plan(obs.shape[0], obs.device)
        with torch.no_grad():
            return self._plan(state.params, state.norm, obs, z, prev_mu, gen,
                              noise)
