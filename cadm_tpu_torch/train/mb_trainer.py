"""Model-based trainer (counterpart of cadm_tpu/train/mb_trainer.py).

The reference's master loop: for each outer iteration, collect rollouts
(uniform-random actions on the first iteration to bootstrap the dataset,
MPC through the model after) into the replay ring, fit the dynamics model
(norm statistics from the ring, then Adam updates on sampled segments with
early stop on a held-out valid loss), evaluate on the train/moderate/extreme
dynamics ranges, and log one row.

The reference compiles collect, eval and fit into programs (``lax.scan``
over time / updates, ``lax.cond`` over skipped epochs). Here they are Python
loops over batched device work: on a CUDA device each control step of the
collects (random and planned) and of the eval episodes is a replay of a
captured CUDA graph (``train/step_graph.py``), and so is each update of
the fit and each estimate of its valid loss (``train/fit_graph.py``; not on
a mesh, whose fit gathers over ``torch.distributed``); ``graph=False`` runs
them op by op. The epoch loop stops at the early-stop epoch instead of
running the skipped ones, with one read on the host an epoch. The metrics
and their keys are the reference's.

``train`` can save the whole training state after every iteration
(``checkpoint_payload``) and resume from it at the next iteration with the
same metrics as an uninterrupted run, and can hand each iteration's newly
collected transitions to a ``TrajectorySink``.

On a (dp, model) mesh (``parallel.mesh``) each rank steps, plans for and
stores its block of the envs, drawing every env-sized draw for all envs and
keeping its block; the fit gathers each minibatch over ``dp`` and trains
the rank's members; the planner plans with every member (the heads gathered
over ``model`` after each fit); the row is computed from gathered values.
So the run computes what it computes without a mesh, within float32
reduction order. Rank 0 writes the log, the checkpoints (of the gathered
state, the same file as without a mesh) and the trajectory dump.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from cadm_tpu_torch.core.types import batched_history
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.models.dynamics import (
    Dynamics,
    DynamicsState,
    NormStats,
    SegmentBatch,
)
from cadm_tpu_torch.core.rng import env_rows
from cadm_tpu_torch.parallel.mesh import (
    gather_dynamics_state,
    gather_leading_axis,
    shard_dynamics_state,
)
from cadm_tpu_torch.planners.mpc import MPCPlanner
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.fit_graph import FitGraphs, fitter, ring_key
from cadm_tpu_torch.train.step_graph import STEPS, StepGraphs, stepper
from cadm_tpu_torch.utils.checkpoint import restore_parts, to_plain

Tensor = torch.Tensor
Indices = Tuple[Tensor, Tensor]


def _symmetrize_stats(maps: Tensor, mean: Tensor, std: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Normalization statistics of the group-augmented data: the uniform
    mixture over group elements k of ``maps[k] @ x``. For signed-permutation
    maps the mixture's per-dim moments are exact:
    mean' = (1/G) Σ_k maps[k] @ mean, E[x²]' = (1/G) Σ_k maps[k]² @ (std² +
    mean²) (elementwise square)."""
    g = maps.shape[0]
    mean_aug = torch.einsum("gij,j->i", maps, mean) / g
    m2_aug = torch.einsum("gij,j->i", maps**2, std**2 + mean**2) / g
    var = torch.clamp(m2_aug - mean_aug**2, min=1e-12)
    return mean_aug, torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    n_envs: int = 8
    steps_per_itr: int = 200        # env steps per env per outer iteration
    n_itr: int = 10
    model_updates_per_itr: int = 200
    batch_size: int = 128
    buffer_capacity: int = 4000     # per-env time columns
    random_first_itr: bool = True
    eval_envs: int = 8
    eval_modes: Tuple[int, ...] = (0, 1, 2)
    eval_every: int = 1             # the final iteration always evaluates
    fit_protocol: str = "fixed"     # "fixed" (N updates) | "epochs"
    max_epochs: int = 50            # epoch cap for fit_protocol="epochs"
    early_stop_patience: int = 5    # epochs without valid improvement
    # held-out metric that gates early stopping: "loss" (the model's own
    # objective) or "fwd_mse" (the forward-head mean MSE)
    early_stop_metric: str = "loss"
    min_rel_improve: float = 1e-3   # relative valid-loss improvement bar
    valid_batches: int = 4          # minibatches per valid-loss estimate
    # an epoch is min(one pass over the dataset, this many updates)
    epoch_updates_cap: int = 500
    # symmetry-group augmentation of the TRAIN minibatches: each segment is
    # mapped by a uniformly drawn element of env.symmetry_maps() (CrippleAnt:
    # the 4-fold leg relabeling); valid batches and collect stay raw, and
    # the norm statistics are those of the augmented distribution
    symmetry_aug: bool = False


def epoch_minibatches(n_train_anchors: int, capacity: int, n_envs: int,
                      batch_size: int, epoch_updates_cap: int
                      ) -> Tuple[int, int]:
    """(mb_cap, n_mb): the epoch's update cap and its update count.

    Written as the reference writes them (mb_trainer.py:376-385), quirk
    included: in ``-(-a * b) // c`` the unary minus binds before ``//``, so
    ``n_mb`` is the FLOOR of train anchors × envs / batch, while ``mb_cap``
    (``-(-a * b * 9 // 10 // c)``) is a ceiling division.
    """
    mb_cap = min(
        epoch_updates_cap,
        max(1, -(-capacity * n_envs * 9 // 10 // batch_size)),
    )
    n_mb = min(max(-(-n_train_anchors * n_envs) // batch_size, 1), mb_cap)
    return mb_cap, n_mb


def early_stop_step(best: float, since: int, val: float,
                    min_rel_improve: float, patience: int
                    ) -> Tuple[float, int, bool]:
    """One epoch of the reference's early-stop rule (mb_trainer.py:416-421),
    in float32 as there → (best, epochs since improvement, stop).

    An epoch improves when val < best·(1 − min_rel_improve); ``best`` takes
    the minimum, NaN propagating as under ``jnp.minimum``.
    """
    b, v = np.float32(best), np.float32(val)
    improved = bool(v < b * np.float32(1.0 - min_rel_improve))
    since = 0 if improved else since + 1
    return float(np.minimum(b, v)), since, since >= patience


class MBTrainer:
    def __init__(self, env: Env, model: Dynamics, planner: MPCPlanner,
                 config: TrainerConfig, mesh=None, graph: bool = True):
        """``mesh``: a ``parallel.mesh.Mesh`` whose dp axis splits the
        ``n_envs`` envs and whose model axis splits the members (raises
        ``ValueError`` where either does not divide), or None.

        ``graph``: on a CUDA device, run each control step of the collects
        and of the eval episodes as a replay of a captured CUDA graph
        (``train/step_graph.py``), and off a mesh each update and valid
        estimate of the fit too (``train/fit_graph.py``); False runs them
        op by op. The CPU always runs them op by op. On a mesh the fit
        runs op by op by rule: its gathers and sums over the mesh go
        through ``torch.distributed``, which a capture cannot hold."""
        if config.fit_protocol not in ("fixed", "epochs"):
            raise ValueError(f"unknown fit_protocol {config.fit_protocol!r}")
        if config.early_stop_metric not in ("loss", "fwd_mse"):
            raise ValueError(
                f"unknown early_stop_metric {config.early_stop_metric!r}")
        self.env = env
        self.model = model
        self.planner = planner
        self.cfg = config
        self.mesh = mesh
        self.n_local = config.n_envs  # this rank's envs
        if mesh is not None:
            self.n_local = mesh.local_count(config.n_envs, "dp", "envs")
            mesh.local_count(model.cfg.n_members, "model",
                             "ensemble members")
        self._fit = {"fixed": self._fit_impl,
                     "epochs": self._fit_epochs_impl}[config.fit_protocol]
        self.graphs = (StepGraphs(self) if graph and env.device.type == "cuda"
                       else None)
        self.fit_graphs = (FitGraphs(self.graphs)
                           if self.graphs is not None and mesh is None
                           else None)
        self._sym_maps = None
        if config.symmetry_aug:
            maps = env.symmetry_maps()
            if maps is None:
                raise ValueError(f"symmetry_aug=True but {type(env).__name__} "
                                 "exposes no symmetry_maps()")
            self._sym_maps = {k: torch.as_tensor(maps[k], dtype=torch.float32,
                                                 device=env.device)
                              for k in ("obs", "act")}

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator):
        """(env states, histories, replay ring, model state) for ``n_envs``;
        on a mesh this rank's envs and members."""
        env, cfg = self.env, self.cfg
        g, n = env_rows(self.mesh, gen, cfg.n_envs)
        env_states = env.reset(g, n)
        hists = batched_history(self.model.cfg, n, env.device)
        buffer = ReplayBuffer.create(n, cfg.buffer_capacity,
                                     env.obs_dim, env.act_dim, env.device)
        dyn_state = shard_dynamics_state(self.model.init_state(gen), self.mesh,
                                         self.model.member_keys)
        return env_states, hists, buffer, dyn_state

    def planning_state(self, dyn_state):
        """The model state with every member (gathered over the mesh's
        model axis): what the planner, ``evaluate`` and a checkpoint take."""
        return gather_dynamics_state(dyn_state, self.mesh,
                                     self.model.member_keys)

    # ------------------------------------------------------------ steps --
    def _stepper(self, kind: str, mode: int, dyn_state, carry, g,
                 noise: Optional[Tensor] = None):
        """(``step(t)``, ``final()``): ``step`` runs control step t of
        ``kind`` (``step_graph.STEPS``) from ``carry`` and returns its
        output (valid until the next step), ``final`` gives the carry
        after the steps taken. Every kind replays the trainer's graphs
        where it has them; ``noise`` (step t's actions or ε) is taken by
        the op-by-op step only (raises with graphs)."""
        weights = DynamicsState(dyn_state.params, dyn_state.norm)
        return stepper(self, STEPS, self.graphs, kind, mode, weights, carry,
                       g, noise)

    # ---------------------------------------------------------- collect --
    @torch.no_grad()
    def _collect(self, gen: torch.Generator, env_states, hists, buffer,
                 dyn_state: DynamicsState, random_actions: bool,
                 noise: Optional[Tensor] = None):
        """``steps_per_itr`` control steps of every env into the ring.

        Random actions are uniform in [-1, 1]; planned actions come from
        the MPC planner through the current model and context. On done the
        env has auto-reset, so its context window and warm-start plan are
        wiped. ``noise`` replaces the sampled randomness per step (tests
        feed both packages the same numbers): the actions (steps, E, act)
        for a random collect, the planner's ε (steps, cem_iters, E, C, H,
        act) for a planned one. ``dyn_state`` has every member
        (``planning_state``); the envs are this rank's.
        """
        env, cfg = self.env, self.cfg
        g, n = env_rows(self.mesh, gen, cfg.n_envs)
        plan_mu = self.planner.init_plan(n, env.device)
        step, final = self._stepper(
            "random" if random_actions else "collect", 0, dyn_state,
            (env_states, hists, plan_mu), g, noise)
        ret_acc = torch.zeros(n, device=env.device)
        ep_returns, rewards, bads = [], [], []
        for t in range(cfg.steps_per_itr):
            tr = step(t)
            buffer.append(tr.prev_obs, tr.actions, tr.obs, tr.done,
                          tr.ep_step, tr.bad)
            ret_acc = ret_acc + tr.reward
            ep_returns.append(torch.where(tr.done, ret_acc, math.nan))
            ret_acc = torch.where(tr.done, 0.0, ret_acc)
            rewards.append(tr.reward.clone())  # the next step overwrites it
            bads.append(tr.bad.float())
        env_states, hists, _ = final()
        # (steps, envs) of every env, so the row is the one without a mesh
        ep_returns, rewards, bads = gather_leading_axis(
            [torch.stack(x) for x in (ep_returns, rewards, bads)], self.mesh,
            dim=1)
        finished = torch.isfinite(ep_returns)
        n_done = finished.sum()
        mean_return = torch.where(
            n_done > 0,
            torch.where(finished, ep_returns, 0.0).sum() / n_done.clamp(min=1),
            math.nan,
        )
        metrics = {
            "collect/mean_episode_return": mean_return,
            "collect/mean_step_reward": rewards.mean(),
            "collect/episodes": n_done,
            # real-env blowup rate: transitions masked out of the norm
            # statistics, the fit and the context windows
            "collect/bad_transition_frac": bads.mean(1).mean(),
        }
        return env_states, hists, buffer, metrics

    # -------------------------------------------------------------- fit --
    def _refresh_norm(self, buffer: ReplayBuffer, dyn_state: DynamicsState
                      ) -> DynamicsState:
        n = buffer.norm_stats(self.mesh)
        if self._sym_maps is not None:
            m_o, m_a = self._sym_maps["obs"], self._sym_maps["act"]
            n = NormStats(*_symmetrize_stats(m_o, n.obs_mean, n.obs_std),
                          *_symmetrize_stats(m_a, n.act_mean, n.act_std),
                          *_symmetrize_stats(m_o, n.dobs_mean, n.dobs_std))
        return dataclasses.replace(dyn_state, norm=n)

    def _augment(self, batch: SegmentBatch, group_idx: Tensor) -> SegmentBatch:
        """Map each segment by its group element ``group_idx`` (n_members,
        B): history and future alike, obs-like leaves by the obs map and
        action leaves by the action map."""
        m_o = self._sym_maps["obs"][group_idx]        # (..., d, d)
        m_a = self._sym_maps["act"][group_idx]        # (..., a, a)

        def app(x, m):
            return torch.einsum("...td,...od->...to", x, m)

        return dataclasses.replace(
            batch,
            hist_obs=app(batch.hist_obs, m_o),
            hist_dobs=app(batch.hist_dobs, m_o),
            hist_act=app(batch.hist_act, m_a),
            obs=app(batch.obs, m_o),
            act=app(batch.act, m_a),
            next_obs=app(batch.next_obs, m_o),
        )

    def _draw(self, buffer: ReplayBuffer, gen: torch.Generator,
              split: str) -> Indices:
        """Segment indices of one (n_members, batch_size) minibatch (over
        every env and member on a mesh)."""
        shape = (self.model.cfg.n_members, self.cfg.batch_size)
        return buffer.draw_indices(gen, shape, split, self.mesh)

    def _members(self, x: Tensor) -> Tensor:
        """This rank's members' rows of a member-leading draw."""
        return x if self.mesh is None else self.mesh.take(x, "model")

    def _sample(self, buffer: ReplayBuffer, idx: Indices):
        """The segments of ``idx`` for this rank's members."""
        mc = self.model.cfg
        return buffer.gather(*map(self._members, idx), mc.history_k,
                             mc.future_m, self.mesh)

    def _draw_valid(self, buffer, gen) -> List[Indices]:
        return [self._draw(buffer, gen, "valid")
                for _ in range(self.cfg.valid_batches)]

    def _valid_metrics(self, buffer, valid_idx: List[Indices],
                       dyn_state: DynamicsState) -> Tuple[Tensor, Tensor]:
        """(mean valid loss, mean forward-mean MSE) over the held-out
        minibatches, each weighted by its own Σvalid. GrBAL's loss reports
        no forward MSE: NaN then, as in the reference (so an early stop on
        ``fwd_mse`` never improves for it)."""
        losses, mses = [], []
        for idx in valid_idx:
            loss, m = self.model.loss(dyn_state.params, dyn_state.norm,
                                      self._sample(buffer, idx))
            losses.append(loss)
            mses.append(m.get("fwd_mean_mse", torch.full_like(loss,
                                                              math.nan)))
        return torch.stack(losses).mean(), torch.stack(mses).mean()

    def _train_step(self, buffer, gen, dyn_state):
        """One update: draw → gather → (symmetry augmentation) →
        ``model.update`` → (state, the update's loss)."""
        idx = self._draw(buffer, gen, "train")
        batch = self._sample(buffer, idx)
        if self._sym_maps is not None:
            g = self._sym_maps["obs"].shape[0]
            batch = self._augment(batch, self._members(torch.randint(
                0, g, idx[0].shape, generator=gen, device=idx[0].device)))
        dyn_state, m = self.model.update(dyn_state, batch)
        return dyn_state, m["model_loss"]

    def _fitter(self, gen, buffer: ReplayBuffer, dyn_state: DynamicsState):
        """The fit of ``dyn_state`` on ``buffer``
        (``fit_graph.EagerFit``/``GraphFit``): ``update()`` → the update's
        loss, ``valid(indices)`` → (valid loss, forward MSE) on those
        minibatches, ``final()``. Graph replays where the trainer has fit
        graphs; injected draws (a ``_draw`` set on the trainer) are taken
        by the op-by-op fit only."""
        if self.fit_graphs is not None and "_draw" in vars(self):
            raise ValueError("injected draws are taken by the op-by-op fit "
                             "only (MBTrainer(graph=False))")
        return fitter(
            self.fit_graphs, "fit", ring_key(buffer), dyn_state, gen,
            lambda st: self._train_step(buffer, gen, st),
            lambda st, idx: self._valid_metrics(buffer, idx, st))

    @torch.no_grad()
    def _fit_impl(self, gen, buffer: ReplayBuffer, dyn_state: DynamicsState):
        """Fixed protocol: ``model_updates_per_itr`` updates on the train
        partition, valid loss before and after on the same batches."""
        fit = self._fitter(gen, buffer, self._refresh_norm(buffer, dyn_state))
        valid_idx = self._draw_valid(buffer, gen)
        val_before, _ = fit.valid(valid_idx)
        losses = torch.stack([fit.update()
                              for _ in range(self.cfg.model_updates_per_itr)])
        val_after, fwd_mse_after = fit.valid(valid_idx)
        return fit.final(), {
            "fit/model_loss_first": losses[0],
            "fit/model_loss_last": losses[-1],
            "fit/model_loss_mean": losses.mean(),
            "fit/valid_loss_before": val_before,
            "fit/valid_loss_after": val_after,
            "fit/valid_fwd_mse_after": fwd_mse_after,
        }

    @torch.no_grad()
    def _fit_epochs_impl(self, gen, buffer: ReplayBuffer,
                         dyn_state: DynamicsState):
        """Epoch passes over the ring with early stop on the held-out loss.

        An epoch is ``n_mb`` updates (one pass over today's train anchors,
        capped; see ``epoch_minibatches``), then a fresh valid estimate. The
        loop ends at ``max_epochs`` or once ``early_stop_patience`` epochs
        in a row failed to improve. "After" reuses the valid batches of
        "before".
        """
        cfg = self.cfg
        fit = self._fitter(gen, buffer, self._refresh_norm(buffer, dyn_state))
        _, n_mb = epoch_minibatches(buffer.n_train_anchors(), buffer.capacity,
                                    cfg.n_envs, cfg.batch_size,
                                    cfg.epoch_updates_cap)
        monitored = (lambda loss, mse: mse) if cfg.early_stop_metric == \
            "fwd_mse" else (lambda loss, mse: loss)

        valid0 = self._draw_valid(buffer, gen)
        v0_loss, v0_mse = fit.valid(valid0)
        best, since = float(monitored(v0_loss, v0_mse)), 0
        vals = np.full(cfg.max_epochs, np.nan, np.float32)
        train_losses = np.full(cfg.max_epochs, np.nan, np.float32)
        for epoch in range(cfg.max_epochs):
            losses = torch.stack([fit.update() for _ in range(n_mb)])
            val = monitored(*fit.valid(self._draw_valid(buffer, gen)))
            # the epoch's one read on the host
            vals[epoch], train_losses[epoch] = torch.stack(
                [val, losses.nanmean()]).tolist()
            best, since, stop = early_stop_step(
                best, since, vals[epoch], cfg.min_rel_improve,
                cfg.early_stop_patience)
            if stop:
                break
        ran = int(np.isfinite(vals).sum())
        loss_after, mse_after = fit.valid(valid0)
        return fit.final(), {
            "fit/model_loss_first": train_losses[0],
            "fit/model_loss_last": (train_losses[max(ran - 1, 0)] if ran
                                    else np.nan),
            "fit/model_loss_mean": np.nanmean(train_losses),
            # valid_loss_* report the model's own objective; the monitored
            # early-stop signal is logged apart
            "fit/valid_loss_before": v0_loss,
            "fit/valid_loss_after": loss_after,
            "fit/valid_monitored_best": best,
            "fit/valid_fwd_mse_after": mse_after,
            "fit/epochs_run": ran,
        }

    # ------------------------------------------------------------- eval --
    @torch.no_grad()
    def evaluate(self, dyn_state: DynamicsState, mode: int,
                 gen: torch.Generator,
                 noise: Optional[Tensor] = None) -> Tensor:
        """One planner-driven episode per eval env → returns (eval_envs,).

        Runs ``env.horizon`` control steps; each env's return stops
        accumulating at its first done (later auto-reset episodes are not
        counted), as in the reference. ``dyn_state`` has every member
        (``planning_state``). On a mesh the eval envs split over dp where
        they divide it (else every rank runs all of them) and every rank
        gets all the returns. ``noise`` replaces the planner's ε per step
        (horizon, cem_iters, E, C, H, act), as in ``_collect``; op by op
        only.
        """
        env = self.env
        g, n = env_rows(self.mesh, gen, self.cfg.eval_envs)
        carry = (env.reset(g, n, mode),
                 batched_history(self.model.cfg, n, env.device),
                 self.planner.init_plan(n, env.device))
        step, _ = self._stepper("eval", mode, dyn_state, carry, g, noise)
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
    def checkpoint_payload(env_states, hists, buffer, dyn_state,
                           gen: torch.Generator, itr: int) -> dict:
        """The whole training state at the end of iteration ``itr``:
        resuming from it reproduces the metrics of an uninterrupted run.
        The CEM warm-start plan is made anew by every collect, so it is no
        state across iterations."""
        return {"state": dyn_state, "buffer": buffer, "env_states": env_states,
                "hists": hists, "rng": gen.get_state(), "itr": itr}

    # ------------------------------------------------------------ train --
    def train(self, gen: torch.Generator, logger=None, checkpointer=None,
              traj_sink=None, start_itr: int = 0, initial_dyn_state=None,
              resume: Optional[dict] = None):
        """Run the outer loop → (final model state, list of metric rows).

        Each row holds ``itr``, the collect metrics, the fit metrics and,
        on evaluating iterations, the mean and population std of the eval
        returns per mode, in the reference's key order.

        ``checkpointer`` saves ``checkpoint_payload`` after every
        iteration. ``resume`` is such a payload (as saved, or plain from
        ``Checkpointer.restore``): the run goes on at its ``itr`` + 1 with
        its state and ``gen``'s saved state. ``start_itr`` and
        ``initial_dyn_state`` are the weaker warm start: only the model is
        given, the ring is collected anew, and iteration 0 plans instead of
        acting at random. ``traj_sink`` receives ``itr{n}/obs|act|next_obs``
        of the steps just collected, each (n_envs, steps_per_itr, dim).

        On a mesh every rank calls ``train`` and gets the same rows and the
        whole final state; ``checkpointer`` and ``traj_sink`` are given on
        every rank or on none (each rank joins the gathers of what they
        save), and the caller makes them write on one rank only.
        """
        cfg, mesh = self.cfg, self.mesh
        env_states, hists, buffer, dyn_state = self.init(gen)
        if resume is not None:
            resume = to_plain(resume)
            (env_states, hists, buffer), dyn_state = restore_parts(
                resume, (env_states, hists, buffer), dyn_state, mesh,
                self.model.member_keys)
            gen.set_state(resume["rng"].cpu())
            start_itr = int(resume["itr"]) + 1
        elif initial_dyn_state is not None:
            dyn_state = shard_dynamics_state(initial_dyn_state, mesh,
                                             self.model.member_keys)
        plan_state = self.planning_state(dyn_state)
        history = []
        for itr in range(start_itr, cfg.n_itr):
            use_random = (cfg.random_first_itr and itr == 0
                          and initial_dyn_state is None)
            env_states, hists, buffer, col_metrics = self._collect(
                gen, env_states, hists, buffer, plan_state, use_random)
            dyn_state, fit_metrics = self._fit(gen, buffer, dyn_state)
            plan_state = self.planning_state(dyn_state)
            # the reference's jitted collect/fit return their dicts with
            # sorted keys, which fixes its CSV column order
            metrics = {**dict(sorted(col_metrics.items())),
                       **dict(sorted(fit_metrics.items()))}
            if (itr + 1) % cfg.eval_every == 0 or itr == cfg.n_itr - 1:
                for mode in cfg.eval_modes:
                    returns = self.evaluate(plan_state, mode, gen)
                    metrics[f"eval/return_mode{mode}"] = returns.mean()
                    metrics[f"eval/return_mode{mode}_std"] = returns.std(
                        correction=0)
            metrics = {"itr": itr, **{k: float(v) for k, v in metrics.items()}}
            history.append(metrics)
            if logger is not None:
                for k, v in metrics.items():
                    logger.logkv(k, v)
                logger.dumpkvs()
            if checkpointer is not None:
                rings = gather_leading_axis((env_states, hists, buffer), mesh)
                checkpointer.save(itr, self.checkpoint_payload(
                    *rings, plan_state, gen, itr))
            if traj_sink is not None:
                cols = torch.arange(buffer.ptr - cfg.steps_per_itr, buffer.ptr,
                                    device=buffer.obs.device) % buffer.capacity
                names = ("obs", "act", "next_obs")
                fields = gather_leading_axis(
                    [getattr(buffer, name)[:, cols] for name in names], mesh)
                for name, x in zip(names, fields):
                    traj_sink.append(f"itr{itr}/{name}", x.cpu().numpy())
        return plan_state, history
