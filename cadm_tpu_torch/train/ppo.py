"""PPO + CaDM (counterpart of cadm_tpu/train/ppo.py): a model-free policy
conditioned on the learned context (arXiv:2005.06800 §4.3).

A PPO policy/value pair reads concat(obs, z), where z is the CaDM context
encoder's output (zero-width for ``context='none'``). The encoder trains
with the forward/backward dynamics losses on the same rollouts, never on
the PPO loss: z enters the policy under ``no_grad``.

Per iteration: a collect of ``rollout_len`` steps of every env (Gaussian
actions around the tanh-MLP mean, clipped to [-1, 1], into the replay ring
and the trajectory), GAE with advantages normalized by their population
std, ``ppo_epochs`` epochs of clipped-surrogate minibatch steps (optax's
``clip_by_global_norm`` then Adam, ``clip_adam_step``), the dynamics fit on
the ring, and a deterministic-mean evaluation of fresh episodes on each
dynamics range. The reference's jitted programs (cadm_tpu/train/ppo.py:
76-81) are Python loops over batched device work here; on a CUDA device
each is replayed from captured CUDA graphs: each control step of the
collect and of the eval episodes (``train/step_graph.py``; the ring append
and the trajectory's rows are copied out after each replay), GAE, each PPO
minibatch step and each update of the model fit (``train/fit_graph.py``;
not on a mesh). ``graph=False`` and the CPU run them op by op. Its metrics,
keys and their order are kept.

The reference's quirks are kept: each collect starts its return
accumulator at 0, so an episode spanning two collects reports only its
second part; an auto-reset at the horizon counts as terminal in GAE; with
``model='vanilla'`` the fit trains a model that nothing reads.

On a (dp, model) mesh (``parallel.mesh``) each rank collects its block of
the envs (env-sized draws made for all envs, the rank's block kept); the
rollout is then gathered over ``dp`` in time-major order and the PPO update
runs replicated on all of it; the dynamics fit is the MB trainer's (batches
gathered over ``dp``, members split over ``model``). Rank 0 writes the log
and the checkpoints, of the gathered state. The collect and eval steps keep
their graphs on a mesh; the PPO update and the fit run op by op there by
rule (the fit's gathers go through ``torch.distributed``, which a capture
cannot hold).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from cadm_tpu_torch.core.types import (
    batched_history,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_where,
)
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.models.dynamics import (
    AdamState,
    Dynamics,
    DynamicsState,
    clip_adam_step,
)
from cadm_tpu_torch.models.nets import mlp_apply, mlp_init
from cadm_tpu_torch.core.rng import env_rows, randn
from cadm_tpu_torch.parallel.mesh import (
    gather_dynamics_state,
    gather_leading_axis,
    shard_dynamics_state,
)
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.fit_graph import FitGraphs, fitter, ring_key
from cadm_tpu_torch.train.step_graph import Graph, StepGraphs, stepper
from cadm_tpu_torch.utils.checkpoint import (
    from_plain,
    restore_parts,
    to_plain,
)

Tensor = torch.Tensor
LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 32
    rollout_len: int = 128
    n_itr: int = 50
    policy_hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    ppo_epochs: int = 10
    minibatches: int = 4
    max_grad_norm: float = 0.5
    # CaDM side
    model_updates_per_itr: int = 200
    model_batch: int = 128
    buffer_capacity: int = 4096
    # shifted-range evaluation: fresh episodes driven by the deterministic
    # policy mean on each dynamics range
    eval_envs: int = 16
    eval_modes: Tuple[int, ...] = (0, 1, 2)


@dataclasses.dataclass
class PPOState:
    params: dict          # {'policy': MLP, 'log_std': (act,), 'value': MLP}
    opt_state: AdamState
    updates: int = 0      # minibatch steps taken


def collect_step(trainer, weights, carry, g, mode: int = 0, noise=None):
    """One collect step of every env under the Gaussian policy (``noise``:
    its standard normal ε) → ((env states, histories, return accumulator),
    (the trajectory's row, (prev_obs, obs, ep_step, bad) for the ring)).
    ``weights``: (``PPOState`` of the policy's params, the model's
    ``DynamicsState`` of params and norm). On done the env has auto-reset:
    its context window is wiped and its return restarts."""
    ppo, dyn = weights
    env, p = trainer.env, ppo.params
    states, hists, ret_acc = carry
    obs_z = trainer._obs_z(dyn, states.obs, hists)
    mean, log_std = trainer._dist(p, obs_z)
    eps = noise if noise is not None else randn(g, *mean.shape)
    act = torch.clamp(mean + torch.exp(log_std) * eps, -1.0, 1.0)
    prev_obs, ep_step = states.obs, states.t
    states, obs, reward, done = env.step(states, act, g)
    bad = env.bad_transition(prev_obs, obs)
    pushed = trainer.model.push_history(dyn.params, dyn.norm, hists, prev_obs,
                                        obs - prev_obs, act)
    hists = tree_where(done, tree_map(torch.zeros_like, pushed), pushed)
    ret_acc = ret_acc + reward
    row = {"obs_z": obs_z, "act": act,
           "logp": trainer._logp(mean, log_std, act),
           "value": trainer._value(p, obs_z), "reward": reward, "done": done,
           "ep_return": torch.where(done, ret_acc, math.nan)}
    ret_acc = torch.where(done, 0.0, ret_acc)
    return (states, hists, ret_acc), (row, (prev_obs, obs, ep_step, bad))


def eval_step(trainer, weights, carry, g, mode: int = 0, noise=None):
    """One eval step (``PPOTrainer._eval_step``) → ((env states,
    histories), (reward, done))."""
    states, hists, _, _, reward, done = trainer._eval_step(*weights, *carry, g,
                                                           mode)
    return (states, hists), (reward, done)


STEPS = {"collect": collect_step, "eval": eval_step}


class PPOTrainer:
    def __init__(self, env: Env, model: Dynamics, config: PPOConfig,
                 mesh=None, graph: bool = True):
        """``mesh``: a ``parallel.mesh.Mesh`` whose dp axis splits the
        ``n_envs`` envs and whose model axis splits the members (raises
        ``ValueError`` where either does not divide), or None.

        ``graph``: on a CUDA device, replay each collect and eval step from
        captured CUDA graphs, and off a mesh GAE, each PPO minibatch step
        and each model update too; False runs them op by op, as the CPU
        always does."""
        self.env = env
        self.model = model
        self.cfg = config
        self.mesh = mesh
        self.n_local = config.n_envs  # this rank's envs
        if mesh is not None:
            self.n_local = mesh.local_count(config.n_envs, "dp", "envs")
            mesh.local_count(model.cfg.n_members, "model",
                             "ensemble members")
        self.graphs = (StepGraphs(self, steps=STEPS)
                       if graph and env.device.type == "cuda" else None)
        self.fit_graphs = (FitGraphs(self.graphs)
                           if self.graphs is not None and mesh is None
                           else None)
        # GAE and the flattened rollout, as a graph (its output: the
        # minibatch steps' static input)
        self._prep: Optional[Graph] = None

    # ------------------------------------------------------------- init --
    @property
    def _pol_in(self) -> int:
        return self.env.obs_dim + self.model.cfg.context_dim

    def init(self, gen: torch.Generator):
        """(env states, histories, replay ring, PPO state, model state);
        on a mesh this rank's envs and members."""
        env, cfg, dev = self.env, self.cfg, self.env.device
        g, n = env_rows(self.mesh, gen, cfg.n_envs)
        env_states = env.reset(g, n)
        hists = batched_history(self.model.cfg, n, dev)
        params = {
            "policy": mlp_init(gen, [self._pol_in, *cfg.policy_hidden,
                                     env.act_dim]),
            "log_std": torch.full((env.act_dim,), -0.5, device=dev),
            "value": mlp_init(gen, [self._pol_in, *cfg.policy_hidden, 1]),
        }
        ppo_state = PPOState(params, AdamState.zeros_like(params))
        dyn_state = shard_dynamics_state(self.model.init_state(gen), self.mesh,
                                         self.model.member_keys)
        buffer = ReplayBuffer.create(n, cfg.buffer_capacity,
                                     env.obs_dim, env.act_dim, dev)
        return env_states, hists, buffer, ppo_state, dyn_state

    # ----------------------------------------------------------- policy --
    def _dist(self, params: dict, obs_z: Tensor) -> Tuple[Tensor, Tensor]:
        """(mean, log_std) of the diagonal Gaussian policy."""
        return (mlp_apply(params["policy"], obs_z, activation=torch.tanh),
                params["log_std"])

    @staticmethod
    def _logp(mean: Tensor, log_std: Tensor, act: Tensor) -> Tensor:
        var = torch.exp(2 * log_std)
        return torch.sum(-0.5 * ((act - mean) ** 2 / var + 2 * log_std
                                 + LOG_2PI), dim=-1)

    @staticmethod
    def _value(params: dict, obs_z: Tensor) -> Tensor:
        return mlp_apply(params["value"], obs_z, activation=torch.tanh)[..., 0]

    def _obs_z(self, dyn_state: DynamicsState, obs: Tensor, hists) -> Tensor:
        z = self.model.context_from_history(dyn_state.params, dyn_state.norm,
                                            hists)
        return torch.cat([obs, z], dim=-1)

    # ---------------------------------------------------------- collect --
    @torch.no_grad()
    def _collect(self, gen: torch.Generator, env_states, hists,
                 buffer: ReplayBuffer, ppo_state: PPOState,
                 dyn_state: DynamicsState, noise: Optional[Tensor] = None):
        """``rollout_len`` steps of every env → (env states, histories,
        ring, trajectory, bootstrap value).

        The trajectory holds (T, E, ...) ``obs_z``, ``act``, ``logp`` (of the
        clipped action), ``value`` (before the step), ``reward``, ``done``
        and ``ep_return`` (the episode's return where it ended, NaN
        elsewhere). ``noise`` (T, E, act) replaces the policy's standard
        normal draws (tests feed both packages the same numbers). The envs are
        this rank's.
        """
        g, n = env_rows(self.mesh, gen, self.cfg.n_envs)
        weights = (PPOState(ppo_state.params, None),
                   DynamicsState(dyn_state.params, dyn_state.norm))
        step, final = stepper(
            self, STEPS, self.graphs, "collect", 0, weights,
            (env_states, hists, torch.zeros(n, device=self.env.device)), g,
            noise)
        steps, traj = self.cfg.rollout_len, {}
        for t in range(steps):
            row, (prev_obs, obs, ep_step, bad) = step(t)
            buffer.append(prev_obs, row["act"], obs, row["done"], ep_step,
                          bad)
            for k, v in row.items():  # copied out before the next step
                if t == 0:
                    traj[k] = v.new_empty((steps, *v.shape))
                traj[k][t] = v
        env_states, hists, _ = final()
        last_value = self._value(ppo_state.params, self._obs_z(
            dyn_state, env_states.obs, hists))
        return env_states, hists, buffer, traj, last_value

    # -------------------------------------------------------------- gae --
    def _gae(self, traj: dict, last_value: Tensor) -> Tuple[Tensor, Tensor]:
        """(advantages normalized by their population std, returns)."""
        cfg = self.cfg
        adv = torch.empty_like(traj["value"])
        gae, next_value = torch.zeros_like(last_value), last_value
        for t in reversed(range(adv.shape[0])):
            nonterminal = 1.0 - traj["done"][t].float()
            delta = (traj["reward"][t] + cfg.gamma * next_value * nonterminal
                     - traj["value"][t])
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
            adv[t], next_value = gae, traj["value"][t]
        returns = adv + traj["value"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        return adv, returns

    # ------------------------------------------------------------ update --
    def _loss(self, params: dict, batch: dict) -> Tensor:
        """Clipped surrogate + value_coef·MSE − entropy_coef·entropy."""
        cfg = self.cfg
        mean, log_std = self._dist(params, batch["obs_z"])
        ratio = torch.exp(self._logp(mean, log_std, batch["act"])
                          - batch["logp"])
        s1 = ratio * batch["adv"]
        s2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * batch["adv"]
        pg_loss = -torch.mean(torch.minimum(s1, s2))
        v_loss = torch.mean((self._value(params, batch["obs_z"])
                             - batch["ret"]) ** 2)
        entropy = torch.sum(log_std + 0.5 * (LOG_2PI + 1.0))
        return pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy

    def _flatten(self, traj: dict, last_value: Tensor) -> dict:
        """GAE, then the (T, E) block with its advantages and returns
        flattened time-major: the PPO steps' rows."""
        adv, returns = self._gae(traj, last_value)
        return {k: v.reshape((-1,) + v.shape[2:])
                for k, v in {**traj, "adv": adv, "ret": returns}.items()}

    def _minibatch_step(self, ppo_state: PPOState, flat: dict, idx: Tensor):
        """One PPO step on the rows ``idx`` of ``flat`` → (state, loss)."""
        cfg = self.cfg
        batch = {k: v[idx] for k, v in flat.items()}
        params = ppo_state.params
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.enable_grad():
            loss = self._loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        params, opt = clip_adam_step(params, ppo_state.opt_state, list(grads),
                                     cfg.lr, cfg.max_grad_norm)
        return PPOState(params, opt, ppo_state.updates + 1), loss.detach()

    @torch.no_grad()
    def _ppo_update(self, gen: torch.Generator, ppo_state: PPOState,
                    traj: dict, last_value: Tensor,
                    perms: Optional[Tensor] = None):
        """GAE, then ``ppo_epochs`` epochs of ``minibatches`` steps each on
        the (T, E) block flattened time-major; each epoch takes the first
        mb·minibatches entries of a permutation (``perms`` (epochs, T·E)
        replaces the draws). Returns the new state and the mean loss of the
        first and the last epoch. With fit graphs GAE is one replay and
        each step another; the permutations are drawn op by op, one call an
        epoch, and each step's rows copied into its graph's input."""
        cfg = self.cfg
        if self.fit_graphs is None:
            flat = self._flatten(traj, last_value)
        else:
            if self._prep is None:
                self._prep = Graph(self.graphs, lambda carry, *inputs: (
                    carry, self._flatten(*inputs)), (), None)
            flat = self._prep(traj, last_value)
        fit = fitter(self.fit_graphs, "ppo", None, ppo_state, None,
                     lambda st, idx: self._minibatch_step(st, flat, idx))
        n = flat["adv"].shape[0]
        mb = n // cfg.minibatches
        epoch_losses = []
        for epoch in range(cfg.ppo_epochs):
            perm = perms[epoch] if perms is not None else torch.randperm(
                n, generator=gen, device=last_value.device)
            losses = [fit.update(idx) for idx in
                      perm[: mb * cfg.minibatches].reshape(cfg.minibatches,
                                                           mb)]
            epoch_losses.append(torch.stack(losses).mean())
        return fit.final(), {
            "ppo/loss_first": epoch_losses[0],
            "ppo/loss_last": epoch_losses[-1],
        }

    # --------------------------------------------------------- fit model --
    def _draw(self, buffer: ReplayBuffer, gen: torch.Generator, split: str):
        """Segment indices of one (n_members, model_batch) minibatch (over
        every env and member on a mesh)."""
        return buffer.draw_indices(
            gen, (self.model.cfg.n_members, self.cfg.model_batch), split,
            self.mesh)

    def _sample(self, buffer: ReplayBuffer, idx):
        """The segments of ``idx`` for this rank's members."""
        mc = self.model.cfg
        if self.mesh is not None:
            idx = [self.mesh.take(x, "model") for x in idx]
        return buffer.gather(*idx, mc.history_k, mc.future_m, self.mesh)

    @torch.no_grad()
    def _fit_model(self, gen: torch.Generator, buffer: ReplayBuffer,
                   dyn_state: DynamicsState):
        """The norm refreshed from the whole ring, ``model_updates_per_itr``
        updates on train segments, then the loss of one valid batch. With
        fit graphs each update and the valid loss are replays (injected
        draws, a ``_draw`` set on the trainer, are taken op by op only)."""
        if self.fit_graphs is not None and "_draw" in vars(self):
            raise ValueError("injected draws are taken by the op-by-op fit "
                             "only (PPOTrainer(graph=False))")
        fit = fitter(
            self.fit_graphs, "fit", ring_key(buffer),
            dataclasses.replace(dyn_state, norm=buffer.norm_stats(self.mesh)),
            gen,
            lambda st: self.model.update(st, self._sample(
                buffer, self._draw(buffer, gen, "train"))),
            lambda st, idx: self.model.loss(st.params, st.norm,
                                            self._sample(buffer, idx))[0])
        loss = None
        for _ in range(self.cfg.model_updates_per_itr):
            loss = fit.update()["model_loss"]
        val_loss = fit.valid(self._draw(buffer, gen, "valid"))
        return fit.final(), {"fit/model_loss_last": loss,
                             "fit/valid_loss": val_loss}

    # -------------------------------------------------------------- eval --
    @torch.no_grad()
    def _eval_step(self, ppo_state: PPOState, dyn_state: DynamicsState,
                   states, hists, gen: torch.Generator, mode: int):
        """One control step of the deterministic policy mean, clipped to
        [-1, 1] → (states, histories, action, obs, reward, done). The
        history is pushed and not wiped, as in the reference's eval."""
        act, _ = self._dist(ppo_state.params,
                            self._obs_z(dyn_state, states.obs, hists))
        act = torch.clamp(act, -1.0, 1.0)
        prev_obs = states.obs
        states, obs, reward, done = self.env.step(states, act, gen, mode)
        hists = self.model.push_history(dyn_state.params, dyn_state.norm,
                                        hists, prev_obs, obs - prev_obs, act)
        return states, hists, act, obs, reward, done

    @torch.no_grad()
    def evaluate(self, ppo_state: PPOState, dyn_state: DynamicsState,
                 mode: int, gen: torch.Generator, start=None) -> Tensor:
        """Fresh episodes of ``eval_envs`` envs on dynamics range ``mode``
        for exactly ``env.horizon`` steps → returns (eval_envs,); each stops
        accumulating at its env's first done. ``start`` (env states of this
        rank's envs) replaces the reset, as the cross-evaluation's pinned
        hidden scales do. On a mesh the eval envs split over dp where they
        divide it (else every rank runs all of them) and every rank gets
        all the returns."""
        env = self.env
        g, n = env_rows(self.mesh, gen, self.cfg.eval_envs)
        if start is None:
            start = env.reset(g, n, mode)
        weights = (PPOState(ppo_state.params, None),
                   DynamicsState(dyn_state.params, dyn_state.norm))
        step, _ = stepper(self, STEPS, self.graphs, "eval", mode, weights,
                          (start,
                           batched_history(self.model.cfg, n, env.device)), g)
        ret = torch.zeros(n, device=env.device)
        alive = torch.ones(n, device=env.device)
        for t in range(env.horizon):
            reward, done = step(t)
            ret = ret + reward * alive
            alive = alive * (1.0 - done.float())
        return ret if n == self.cfg.eval_envs else gather_leading_axis(
            ret, self.mesh)

    # ------------------------------------------------------- checkpoint --
    @staticmethod
    def checkpoint_payload(env_states, hists, buffer, ppo_state, dyn_state,
                           gen: torch.Generator, itr: int) -> dict:
        """The whole training state at the end of iteration ``itr``: the
        MB trainer's payload plus ``ppo_state``."""
        return {"ppo_state": ppo_state, "state": dyn_state, "buffer": buffer,
                "env_states": env_states, "hists": hists,
                "rng": gen.get_state(), "itr": itr}

    # ------------------------------------------------------------ train --
    def train(self, gen: torch.Generator, logger=None, checkpointer=None,
              resume: Optional[dict] = None):
        """Run the outer loop → (PPO state, model state, metric rows).

        A row holds ``itr``, ``collect/mean_episode_return``,
        ``collect/episodes``, ``collect/rollout_reward_per_env``, the
        ``ppo/`` and ``fit/`` metrics and the mean and population std of
        the eval returns per mode, in the reference's order; every
        iteration evaluates. ``checkpointer`` saves ``checkpoint_payload``
        after every iteration; ``resume`` (such a payload, as saved or
        plain) goes on at its ``itr`` + 1.

        On a mesh every rank calls ``train`` and gets the same rows and the
        whole final state; ``checkpointer`` is given on every rank or on
        none (each rank joins the gathers of what it saves), and the caller
        makes it write on one rank only.
        """
        cfg, mesh = self.cfg, self.mesh
        keys = self.model.member_keys
        env_states, hists, buffer, ppo_state, dyn_state = self.init(gen)
        start_itr = 0
        if resume is not None:
            resume = to_plain(resume)
            (env_states, hists, buffer), dyn_state = restore_parts(
                resume, (env_states, hists, buffer), dyn_state, mesh, keys)
            ppo_state = from_plain(ppo_state, resume["ppo_state"])
            gen.set_state(resume["rng"].cpu())
            start_itr = int(resume["itr"]) + 1
        history = []
        for itr in range(start_itr, cfg.n_itr):
            env_states, hists, buffer, traj, last_value = self._collect(
                gen, env_states, hists, buffer, ppo_state, dyn_state)
            # every env's rollout, time-major: the update is replicated
            traj = gather_leading_axis(traj, mesh, dim=1)
            last_value = gather_leading_axis(last_value, mesh)
            ep_returns = traj.pop("ep_return").cpu().numpy()
            ppo_state, ppo_metrics = self._ppo_update(gen, ppo_state, traj,
                                                      last_value)
            dyn_state, fit_metrics = self._fit_model(gen, buffer, dyn_state)
            finished = np.isfinite(ep_returns)
            metrics = {
                "itr": itr,
                "collect/mean_episode_return": (
                    float(ep_returns[finished].mean()) if finished.any()
                    else math.nan),
                "collect/episodes": int(finished.sum()),
                "collect/rollout_reward_per_env": float(
                    traj["reward"].sum(0).mean()),
                **{k: float(v) for k, v in ppo_metrics.items()},
                **{k: float(v) for k, v in fit_metrics.items()},
            }
            for mode in cfg.eval_modes:
                returns = self.evaluate(ppo_state, dyn_state, mode, gen)
                metrics[f"eval/return_mode{mode}"] = float(returns.mean())
                metrics[f"eval/return_mode{mode}_std"] = float(
                    returns.std(correction=0))
            history.append(metrics)
            if logger is not None:
                for k, v in metrics.items():
                    logger.logkv(k, v)
                logger.dumpkvs()
            if checkpointer is not None:
                rings = gather_leading_axis((env_states, hists, buffer), mesh)
                checkpointer.save(itr, self.checkpoint_payload(
                    *rings, ppo_state,
                    gather_dynamics_state(dyn_state, mesh, keys), gen, itr))
        return ppo_state, gather_dynamics_state(dyn_state, mesh, keys), history
