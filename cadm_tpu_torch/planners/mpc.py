"""MPC planners: random shooting (RS) and the cross-entropy method (CEM).

Counterpart of cadm_tpu/planners/mpc.py. Sample ``n_candidates`` action
sequences per env, roll them ``horizon`` steps through the learned dynamics
model (the CaDM context z frozen for the whole plan), score them with the
env's observation-only reward, and act with the first action of the best
sequence; CEM refits a Gaussian on the top elites each iteration.

All envs plan at once: candidates of every env form one (E·C)-row batch per
model step, so a plan at 2048 envs × 200 candidates is 409,600 rows in one
block (the reference's libtpu row-chunking is not needed on the card).

An ensemble (n_members > 1) propagates as ``PlannerConfig.ensemble_eval``
says, its members run as one batched product over the member axis:

- 'ts1' (default): the reference's block-granular PETS TS1. Each env's
  candidates (padded to a member multiple) form n_members blocks, and every
  model step draws a fresh permutation that says which member integrates
  which block;
- 'mean': every candidate under every member, scored by the member-mean
  return (n_members × the rows);
- 'ts1_exact': every candidate draws an i.i.d. member each step, taken from
  all members' predictions (n_members × the rows);
- 'assign' (TS∞-block): TS1's block layout with the identity block→member
  map, so block m runs under member m for the whole horizon (candidate i
  under member i // cm) and nothing is drawn; the reference keeps it for
  its known winner's curse (the elites exploit the most optimistic member).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsState, NormStats
from cadm_tpu_torch.models.nets import member
from cadm_tpu_torch.core.rng import rand, randint, randn, trunc_normal

Tensor = torch.Tensor
RewardFn = Callable[[Tensor, Tensor, Tensor], Tensor]
ENSEMBLE_EVALS = ("ts1", "mean", "ts1_exact", "assign")


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
    ensemble_eval: str = "ts1"  # one of ENSEMBLE_EVALS (see above)
    # sample from the probabilistic heads during rollouts (stochastic PETS
    # trajectory sampling); False propagates each member's Gaussian mean
    sample_predictions: bool = False
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
        if config.ensemble_eval not in ENSEMBLE_EVALS:
            raise ValueError(
                f"unknown ensemble_eval {config.ensemble_eval!r}")
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
    def member_draws(self, gen: torch.Generator, e: int, c: int) -> Optional[Tensor]:
        """The member draws of one ``_evaluate`` call of ``e`` envs and ``c``
        candidates: 'ts1' block→member permutations (E, H, n_members), a
        uniform permutation per env and step (argsort of uniforms, batched);
        'ts1_exact' i.i.d. members (E, H, C); None otherwise."""
        n, h = self.model.cfg.n_members, self.cfg.horizon
        if n == 1 or self.cfg.ensemble_eval in ("mean", "assign"):
            return None
        if self.cfg.ensemble_eval == "ts1":
            return rand(gen, e, h, n).argsort(-1)
        return randint(gen, n, e, h, c)

    def _evaluate(self, params: dict, norm: NormStats, obs0: Tensor,
                  z: Tensor, actions: Tensor, gen: Optional[torch.Generator] = None,
                  members: Optional[Tensor] = None,
                  pred_noise: Optional[Tensor] = None) -> Tensor:
        """Return (E, C) of each env's candidate sequences (E, C, H, act).

        ``members`` replaces the member draws (see ``member_draws``);
        ``pred_noise`` (H, *prediction shape) replaces the standard normals
        of ``sample_predictions``. Both are drawn from ``gen`` otherwise.
        """
        e, c, h, _ = actions.shape
        n, mode = self.model.cfg.n_members, self.cfg.ensemble_eval
        if members is None and n > 1:
            members = self.member_draws(gen, e, c)
        fwd = params["fwd"] if n > 1 else member(params["fwd"], 0)

        def predict(t, obs, act, zz):
            noise = None
            if self.cfg.sample_predictions:
                # the env axis leads one member's rows, else follows the
                # member axis
                noise = pred_noise[t] if pred_noise is not None else \
                    randn(gen, *obs.shape, dim=0 if n == 1 else 1)
            return self.model.predict(params, norm, fwd, obs, act, zz, noise)

        if n == 1 or mode == "mean":
            # rows (n, E·C), or (E·C) for one member
            lead = (e * c,) if n == 1 else (n, e * c)
            obs = obs0[:, None].expand(e, c, obs0.shape[-1]).reshape(e * c, -1)
            zz = z[:, None].expand(e, c, z.shape[-1]).reshape(e * c, -1)
            obs, zz = obs.expand(*lead, -1), zz.expand(*lead, -1)

            def step(t, obs):
                a_t = actions[:, :, t].reshape(e * c, -1).expand(*lead, -1)
                return a_t, predict(t, obs, a_t, zz)

            return self._rollout(obs, step, h).reshape(-1, e, c).mean(0)

        rows = torch.arange(e, device=obs0.device)[:, None]
        if mode in ("ts1", "assign"):
            # candidate blocks (E, n, cm): block order stays fixed, the
            # block→member map moves every step under 'ts1' and is the
            # identity under 'assign'
            cm = -(-c // n)
            acts = actions[:, torch.arange(cm * n, device=actions.device) % c]
            acts = acts.reshape(e, n, cm, h, -1)
            obs = obs0[:, None, None].expand(e, n, cm, obs0.shape[-1])
            zz = z[None, :, None].expand(n, e, cm, z.shape[-1])

            def step(t, obs):
                a_t = acts[:, :, :, t]
                if mode == "assign":
                    pred = predict(t, obs.transpose(0, 1),
                                   a_t.transpose(0, 1), zz)
                    return a_t, pred.transpose(0, 1)
                perm = members[:, t]                        # block b → member
                inv = perm.argsort(-1)                      # member m → block
                pred = predict(t, obs[rows, inv].transpose(0, 1),
                               a_t[rows, inv].transpose(0, 1), zz)
                return a_t, pred.transpose(0, 1)[rows, perm]

            total = self._rollout(obs, step, h)
            return total.reshape(e, cm * n)[:, :c]

        # ts1_exact: every member predicts every candidate; each candidate
        # takes its drawn member's prediction
        obs = obs0[:, None].expand(e, c, obs0.shape[-1])
        zz = z[None, :, None].expand(n, e, c, z.shape[-1])

        def step(t, obs):
            a_t = actions[:, :, t]
            preds = predict(t, obs.expand(n, e, c, -1),
                            a_t.expand(n, e, c, -1), zz)
            pick = members[:, t][None, ..., None].expand(1, e, c, obs.shape[-1])
            return a_t, preds.gather(0, pick)[0]

        return self._rollout(obs, step, h)

    def _rollout(self, obs: Tensor, step, h: int) -> Tensor:
        """Sum over ``h`` model steps of each row's guarded reward;
        ``step(t, obs)`` → (action, predicted next obs) of the rows."""
        alive = obs.new_ones(obs.shape[:-1])
        total = obs.new_zeros(obs.shape[:-1])
        for t in range(h):
            a_t, next_obs = step(t, obs)
            next_obs, alive_next, blown = self._guard(obs, next_obs, alive)
            total += (
                self.reward_fn(obs, a_t, next_obs) * alive_next
                - self.cfg.blowup_penalty * blown
            )
            obs, alive = next_obs, alive_next
        return total

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
              noise: Optional[Tensor] = None, members: Optional[Tensor] = None,
              pred_noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Plan for every env → (first actions (E, act), plan means (E, H, act)).

        The reference's per-env ``_plan_single`` over a leading env axis.
        ``noise`` replaces the sampled randomness (tests feed both packages
        the same numbers): CEM's truncated-normal ε, (cem_iters, E, C, H,
        act); RS's uniform actions, (E, C, H, act). ``members`` and
        ``pred_noise`` replace ``_evaluate``'s draws, with a leading
        cem_iters axis for CEM.
        """
        cfg = self.cfg
        e = obs.shape[0]
        shape = (e, cfg.n_candidates, cfg.horizon, self.act_dim)
        if cfg.kind == "rs":
            actions = noise if noise is not None else (
                2.0 * rand(gen, *shape) - 1.0
            )
            returns = self._evaluate(params, norm, obs, z, actions, gen,
                                     members, pred_noise)
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
                eps = trunc_normal(gen, *shape)
            actions = torch.clamp(mu[:, None] + sigma[:, None] * eps, -1.0, 1.0)
            returns = self._evaluate(
                params, norm, obs, z, actions, gen,
                None if members is None else members[i],
                None if pred_noise is None else pred_noise[i])
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
             noise: Optional[Tensor] = None, members: Optional[Tensor] = None,
             pred_noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Batched planning → (actions (E, act), plan means (E, H, act));
        ``noise``, ``members`` and ``pred_noise`` as in ``_plan``."""
        if prev_mu is None:
            prev_mu = self.init_plan(obs.shape[0], obs.device)
        with torch.no_grad():
            return self._plan(state.params, state.norm, obs, z, prev_mu, gen,
                              noise, members, pred_noise)
