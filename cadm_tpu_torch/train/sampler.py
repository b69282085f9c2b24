"""The reference's standalone sampling API (counterpart of
cadm_tpu/train/sampler.py): ``Sampler.obtain_samples`` → time-major paths
and ``ModelSampleProcessor.process_samples``.

``MBTrainer`` and ``PPOTrainer`` collect inside their own loops; this is the
reference's ``samplers/sampler.py`` surface for code written against it. The
envs step as one batch on the env's device; the paths come back as numpy.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from cadm_tpu_torch.core.types import History, tree_map, tree_where
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.core.rng import rand

Tensor = torch.Tensor
# policy: (obs (E, obs), histories, generator) -> actions (E, act)
PolicyFn = Callable[[Tensor, History, torch.Generator], Tensor]
PATH_KEYS = ("observations", "actions", "next_observations", "rewards",
             "dones")


class Sampler:
    def __init__(self, env: Env, n_envs: int, history_k: int = 10,
                 mode: int = 0):
        self.env = env
        self.n_envs = n_envs
        self.history_k = history_k
        self.mode = mode

    @torch.no_grad()
    def obtain_samples(self, gen: torch.Generator, n_steps: int,
                       policy: Optional[PolicyFn] = None, random: bool = False,
                       actions: Optional[Tensor] = None
                       ) -> Dict[str, np.ndarray]:
        """Roll ``n_steps`` across ``n_envs`` fresh envs → time-major paths
        (``n_steps``, ``n_envs``, ...).

        ``random=True`` (or no policy) draws uniform actions in [-1, 1], the
        reference's first-iteration bootstrap; ``actions`` (n_steps, n_envs,
        act_dim) replaces every draw (tests feed both packages the same
        numbers). The policy's histories are wiped where an episode ends.
        """
        env, n = self.env, self.n_envs
        states = env.reset(gen, n, self.mode)
        hists = History.zeros(n, self.history_k, env.obs_dim, env.act_dim,
                              env.device)
        paths = {k: [] for k in PATH_KEYS}
        for t in range(n_steps):
            if actions is not None:
                act = actions[t]
            elif random or policy is None:
                act = 2.0 * rand(gen, n, env.act_dim) - 1.0
            else:
                act = policy(states.obs, hists, gen)
            prev_obs = states.obs
            states, obs, reward, done = env.step(states, act, gen, self.mode)
            pushed = hists.push(prev_obs, obs - prev_obs, act)
            hists = tree_where(done, tree_map(torch.zeros_like, pushed),
                               pushed)
            for k, v in zip(PATH_KEYS, (prev_obs, act, obs, reward, done)):
                paths[k].append(v)
        return {k: torch.stack(v).cpu().numpy() for k, v in paths.items()}


class ModelSampleProcessor:
    """Flattens paths into training arrays plus return statistics."""

    def process_samples(self, paths: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in paths.items()}
        rewards, dones = paths["rewards"], paths["dones"]
        # episode returns: accumulated until each done
        returns = []
        acc = np.zeros(rewards.shape[1])
        for t in range(rewards.shape[0]):
            acc += rewards[t]
            for e in np.nonzero(dones[t])[0]:
                returns.append(acc[e])
                acc[e] = 0.0
        flat["episode_returns"] = np.asarray(returns)
        flat["average_return"] = (float(np.mean(returns)) if returns
                                  else float("nan"))
        return flat
