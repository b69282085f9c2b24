"""GrBAL, the gradient-based adaptive dynamics model (counterpart of
cadm_tpu/models/grbal.py).

A dynamics MLP whose weights are adapted online by ``inner_steps`` gradient
steps on the most recent K transitions, MAML-style; meta-training optimizes
the post-adaptation prediction of the next M transitions, the meta-gradient
flowing through the inner step.

Batch-first: a batch of S segments (or envs) adapts at once. The shared
weights are expanded to per-segment fast weights (S, in, out), the
per-segment window losses are summed, and ``torch.autograd.grad`` with
respect to the expanded weights gives each segment its own gradient, since
segments share nothing. The fast weights run as batched products
(``nets.linear``'s member path, one "member" per segment).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cadm_tpu_torch.core.types import (
    History,
    resolve_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from cadm_tpu_torch.models.dynamics import (
    AdamState,
    NormStats,
    SegmentBatch,
    clip_adam_step,
)
from cadm_tpu_torch.models.nets import MLP, mlp_apply, mlp_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GrBALConfig:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (200, 200, 200)
    history_k: int = 10
    future_m: int = 10
    inner_lr: float = 0.01
    inner_steps: int = 1
    lr: float = 1e-3
    grad_clip: float = 10.0
    n_members: int = 1  # API parity with DynamicsConfig (always 1)


@dataclasses.dataclass
class GrBALState:
    """Meta-parameters ``{"net": MLP}``, normalization statistics, optimizer
    state and the number of updates taken."""

    params: dict
    norm: NormStats
    opt_state: Optional[AdamState] = None
    updates: int = 0


def _flatten_members(batch: SegmentBatch) -> SegmentBatch:
    """Member-leading trainer batches (N, B, ...) as (N·B, ...): GrBAL has
    a single meta-network."""
    if batch.valid.ndim != 3:
        return batch
    return tree_map(lambda x: x.reshape(-1, *x.shape[2:]), batch)


class GrBAL:
    member_keys = ()  # one net: nothing for a mesh's model axis to split

    def __init__(self, config: GrBALConfig, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)

    def init_state(self, gen: torch.Generator) -> GrBALState:
        c = self.cfg
        params = {"net": mlp_init(gen, [c.obs_dim + c.act_dim, *c.hidden,
                                        c.obs_dim])}
        return GrBALState(params=params,
                          norm=NormStats.identity(c.obs_dim, c.act_dim,
                                                  self.device),
                          opt_state=AdamState.zeros_like(params))

    # ------------------------------------------------------------- core --
    @staticmethod
    def _pred_loss(net: MLP, norm: NormStats, obs: Tensor, act: Tensor,
                   dobs: Tensor, valid: Tensor) -> Tensor:
        """Per-segment valid-weighted squared error of the normalized Δobs,
        (S,) from rows (S, T, ·); ``net`` is shared or per-segment."""
        nx = (obs - norm.obs_mean) / norm.obs_std
        na = (act - norm.act_mean) / norm.act_std
        target = (dobs - norm.dobs_mean) / norm.dobs_std
        pred = mlp_apply(net, torch.cat([nx, na], dim=-1))
        err = ((pred - target) ** 2).sum(-1)
        return (err * valid).sum(-1) / (valid.sum(-1) + 1e-8)

    def adapt(self, params: dict, norm: NormStats, hist_obs: Tensor,
              hist_act: Tensor, hist_dobs: Tensor, hist_valid: Tensor,
              create_graph: bool = False) -> MLP:
        """Per-segment fast weights from ``inner_steps`` gradient steps on
        each window (S, K, ·): layers {"w": (S, in, out), "b": (S, out)}.

        ``params["net"]`` must require grad. With ``create_graph`` the fast
        weights stay differentiable in it (the meta-gradient's second
        order)."""
        s = hist_obs.shape[0]
        net = [{k: v.expand(s, *v.shape) for k, v in layer.items()}
               for layer in params["net"]]
        for _ in range(self.cfg.inner_steps):
            loss = self._pred_loss(net, norm, hist_obs, hist_act, hist_dobs,
                                   hist_valid).sum()
            leaves = tree_leaves(net)
            grads = torch.autograd.grad(loss, leaves,
                                        create_graph=create_graph)
            net = tree_unflatten(net, [p - self.cfg.inner_lr * g
                                       for p, g in zip(leaves, grads)])
        return net

    def predict(self, net: MLP, norm: NormStats, obs: Tensor, act: Tensor
                ) -> Tensor:
        """Next-obs prediction through ``net``: shared weights, or
        per-env fast weights with a leading env axis on obs/act."""
        nx = (obs - norm.obs_mean) / norm.obs_std
        na = (act - norm.act_mean) / norm.act_std
        pred = mlp_apply(net, torch.cat([nx, na], dim=-1))
        return obs + norm.dobs_mean + norm.dobs_std * pred

    # ------------------------------------------------------------- loss --
    def loss(self, params: dict, norm: NormStats, batch: SegmentBatch
             ) -> Tuple[Tensor, dict]:
        """Meta-objective: the mean over segments of the post-adaptation
        error on each segment's future window. It reports no
        ``fwd_mean_mse``, as in the reference."""
        b = _flatten_members(batch)
        # a loss of weights that do not require grad (a valid loss) still
        # needs a graph for its inner step, but not a second-order one
        meta = params["net"][0]["w"].requires_grad
        with torch.enable_grad():
            if not meta:
                params = tree_map(
                    lambda p: p.detach().requires_grad_(True), params)
            net = self.adapt(params, norm, b.hist_obs, b.hist_act,
                             b.hist_dobs, b.hist_valid, create_graph=meta)
            losses = self._pred_loss(net, norm, b.obs, b.act,
                                     b.next_obs - b.obs, b.valid)
        total = losses.mean() if meta else losses.mean().detach()
        return total, {"model_loss": total}

    def push_history(self, params: dict, norm: NormStats, hists: History,
                     obs: Tensor, dobs: Tensor, act: Tensor) -> History:
        """Window-only history advance (GrBAL has no recurrent state)."""
        return hists.push(obs, dobs, act)

    def context_from_history(self, params: dict, norm: NormStats,
                             hists: History) -> MLP:
        """Per-env adapted fast weights (E, in, out) from the history
        window: the planner rolls each env's candidates through its own
        adapted net. Runs its own autograd (callers act under no_grad)."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            net = self.adapt(live, norm, hists.obs, hists.act, hists.dobs,
                             hists.valid)
        return tree_map(torch.Tensor.detach, net)

    def update(self, state: GrBALState, batch: SegmentBatch
               ) -> Tuple[GrBALState, dict]:
        """One ``clip_adam_step`` on the meta-loss of ``batch``."""
        live = [p.detach().requires_grad_(True)
                for p in tree_leaves(state.params)]
        with torch.enable_grad():
            loss, metrics = self.loss(tree_unflatten(state.params, live),
                                      state.norm, batch)
            grads = torch.autograd.grad(loss, live)
        params, opt = clip_adam_step(state.params, state.opt_state,
                                     list(grads), self.cfg.lr,
                                     self.cfg.grad_clip)
        return (GrBALState(params=params, norm=state.norm, opt_state=opt,
                           updates=state.updates + 1),
                {k: v.detach() for k, v in metrics.items()})
