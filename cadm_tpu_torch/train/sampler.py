"""The reference's standalone sampling API (counterpart of
cadm_tpu/train/sampler.py): ``Sampler.obtain_samples`` → time-major paths
and ``ModelSampleProcessor.process_samples``.

``MBTrainer`` and ``PPOTrainer`` collect inside their own loops; this is the
reference's ``samplers/sampler.py`` surface for code written against it. The
envs step as one batch on the env's device; the paths come back as numpy.
The reference jits its rollout (a ``lax.scan``) anew on each call; on a
CUDA device each call here captures its control step (the action, ``Env.step``,
the history push and wipe) as one CUDA graph (``train/step_graph.py``),
replays it once a step and drops it at return, so the policy runs on its
weights as they are at the call. The action is the uniform draw, the call's
injected row (copied into the graph's static input) or the policy's. A
policy that a capture refuses raises: pass ``graph=False`` to run op by op,
as the CPU always does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.core.types import History, tree_map, tree_where
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.train.step_graph import Graph, Graphs

Tensor = torch.Tensor
# policy: (obs (E, obs), histories, generator) -> actions (E, act)
PolicyFn = Callable[[Tensor, History, torch.Generator], Tensor]
PATH_KEYS = ("observations", "actions", "next_observations", "rewards",
             "dones")


def _transition(sampler, carry, act, g):
    """Step the envs under ``act`` → ((states, histories), one step's
    paths); the histories are wiped where an episode ends."""
    states, hists = carry
    prev_obs = states.obs
    states, obs, reward, done = sampler.env.step(states, act, g, sampler.mode)
    pushed = hists.push(prev_obs, obs - prev_obs, act)
    hists = tree_where(done, tree_map(torch.zeros_like, pushed), pushed)
    return (states, hists), (prev_obs, act, obs, reward, done)


def random_step(sampler, carry, g):
    """A step under uniform actions in [-1, 1]."""
    n = carry[0].obs.shape[0]
    return _transition(sampler, carry,
                       2.0 * rand(g, n, sampler.env.act_dim) - 1.0, g)


def injected_step(sampler, carry, g, act):
    """A step under the given actions."""
    return _transition(sampler, carry, act, g)


def policy_step(policy, sampler, carry, g):
    """A step under ``policy``'s actions."""
    return _transition(sampler, carry, policy(carry[0].obs, carry[1], g), g)


class Sampler:
    def __init__(self, env: Env, n_envs: int, history_k: int = 10,
                 mode: int = 0, graph: bool = True):
        """``graph``: on a CUDA device, replay each control step from a
        CUDA graph captured for the call (else, and on the CPU, run it op
        by op)."""
        self.env = env
        self.n_envs = n_envs
        self.history_k = history_k
        self.mode = mode
        self.graph = graph and env.device.type == "cuda"
        # every call's capture runs on this stream, so cuBLAS's workspace
        # for it is made once
        self.stream = (torch.cuda.Stream(device=env.device) if self.graph
                       else None)

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
        carry = (env.reset(gen, n, self.mode),
                 History.zeros(n, self.history_k, env.obs_dim, env.act_dim,
                               env.device))
        if actions is not None:
            fn = injected_step
        elif random or policy is None:
            fn = random_step
        else:
            fn = functools.partial(policy_step, policy)

        def inputs(t):
            return () if actions is None else (actions[t],)

        rows = []
        if not self.graph:
            for t in range(n_steps):
                carry, out = fn(self, carry, gen, *inputs(t))
                rows.append(out)
        else:
            # capture=False (a CPU env told to graph) runs the step on the
            # graph's static buffers without capturing
            graph = Graph(Graphs(env.device, env.device.type == "cuda",
                                 self.stream),
                          lambda c, *x: fn(self, c, gen, *x), carry, gen,
                          env_steps=True)
            try:
                for t in range(n_steps):
                    # the next replay overwrites the static output
                    rows.append(tree_map(torch.clone, graph(*inputs(t))))
            finally:
                graph.reset()
        return {k: torch.stack(v).cpu().numpy()
                for k, v in zip(PATH_KEYS, zip(*rows))}


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
