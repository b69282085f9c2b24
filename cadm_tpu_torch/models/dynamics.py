"""Context-aware dynamics model (counterpart of cadm_tpu/models/dynamics.py).

The CaDM context encoder (``context='encoder'``: past-K (Δobs, action)
window → latent z) and the plain model (``context='none'``), each with
member-stacked forward and backward heads predicting normalized Δobs; the
joint loss L_fwd + β·L_bwd over M future steps sharing one z; and the
optimizer step, ``clip_by_global_norm(grad_clip)`` then Adam(lr) exactly as
the reference's optax chain. The port supports one deterministic member.
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
from cadm_tpu_torch.models.nets import MLP, member, mlp_apply, mlp_init

Tensor = torch.Tensor
CONTEXTS = ("none", "encoder")


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (200, 200, 200, 200)
    n_members: int = 1
    probabilistic: bool = False
    context: str = "none"  # 'none' | 'encoder'
    z_dim: int = 10
    history_k: int = 10
    future_m: int = 10
    encoder_hidden: Tuple[int, ...] = (256, 128)
    backward: bool = True          # train the backward head (CaDM only)
    beta_backward: float = 0.5     # β in L_fwd + β·L_bwd
    lr: float = 1e-3
    grad_clip: float = 10.0

    @property
    def hist_dim(self) -> int:
        return self.history_k * (self.obs_dim + self.act_dim)

    @property
    def context_dim(self) -> int:
        return self.z_dim if self.context == "encoder" else 0

    @property
    def head_in_dim(self) -> int:
        return self.obs_dim + self.act_dim + self.context_dim

    @property
    def head_out_dim(self) -> int:
        return self.obs_dim * (2 if self.probabilistic else 1)


@dataclasses.dataclass
class NormStats:
    obs_mean: Tensor
    obs_std: Tensor
    act_mean: Tensor
    act_std: Tensor
    dobs_mean: Tensor
    dobs_std: Tensor

    @staticmethod
    def identity(obs_dim: int, act_dim: int, device=None) -> "NormStats":
        z = lambda n: torch.zeros(n, device=device)  # noqa: E731
        o = lambda n: torch.ones(n, device=device)  # noqa: E731
        return NormStats(z(obs_dim), o(obs_dim), z(act_dim), o(act_dim),
                         z(obs_dim), o(obs_dim))


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the first and second
    moments (trees shaped like the parameters)."""

    count: int
    mu: dict
    nu: dict

    @staticmethod
    def zeros_like(params: dict) -> "AdamState":
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))


@dataclasses.dataclass
class DynamicsState:
    """Parameters (a dict of MLPs), normalization statistics, optimizer
    state and the number of updates taken."""

    params: dict
    norm: NormStats
    opt_state: Optional[AdamState] = None
    updates: int = 0


@dataclasses.dataclass
class SegmentBatch:
    """A training minibatch of trajectory segments.

    The history window (K transitions before t) feeds the context path; the
    M future transitions share that context in the loss. Leaves carry a
    leading member axis: (n_members, B, ...).
    """

    hist_obs: Tensor    # (..., K, obs_dim)
    hist_dobs: Tensor   # (..., K, obs_dim)
    hist_act: Tensor    # (..., K, act_dim)
    hist_valid: Tensor  # (..., K)
    obs: Tensor         # (..., M, obs_dim)
    act: Tensor         # (..., M, act_dim)
    next_obs: Tensor    # (..., M, obs_dim)
    valid: Tensor       # (..., M)


class Dynamics:
    """Functional dynamics-model API shared by planners and trainers."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults

    def __init__(self, config: DynamicsConfig, device="cuda"):
        if config.context not in CONTEXTS or config.n_members != 1 \
                or config.probabilistic:
            raise NotImplementedError(
                "the port supports context 'none'/'encoder' with one "
                f"deterministic member, got {config}"
            )
        self.cfg = config
        self.device = resolve_device(device)

    # ------------------------------------------------------------- init --
    def init_params(self, gen: torch.Generator) -> dict:
        c = self.cfg
        params = {}
        if c.context == "encoder":
            params["encoder"] = mlp_init(
                gen, [c.hist_dim, *c.encoder_hidden, c.z_dim]
            )
        head_sizes = [c.head_in_dim, *c.hidden, c.head_out_dim]
        params["fwd"] = mlp_init(gen, head_sizes, c.n_members)
        if c.context == "encoder" and c.backward:
            params["bwd"] = mlp_init(gen, head_sizes, c.n_members)
        return params

    def init_state(self, gen: torch.Generator) -> DynamicsState:
        params = self.init_params(gen)
        return DynamicsState(
            params=params,
            norm=NormStats.identity(self.cfg.obs_dim, self.cfg.act_dim,
                                    self.device),
            opt_state=AdamState.zeros_like(params),
        )

    # ---------------------------------------------------------- context --
    def context_from_history(self, params: dict, norm: NormStats,
                             hists: History) -> Tensor:
        """Per-env context (E, context_dim) from a batched History."""
        return self.get_context(params, norm, hists.dobs, hists.act,
                                hists.valid)

    def push_history(self, params: dict, norm: NormStats, hists: History,
                     obs: Tensor, dobs: Tensor, act: Tensor) -> History:
        """Advance the batched histories by one transition."""
        return hists.push(obs, dobs, act)

    def get_context(self, params: dict, norm: NormStats, hist_dobs: Tensor,
                    hist_act: Tensor, hist_valid: Tensor) -> Tensor:
        """Latent context from the past-K window, shape (..., context_dim).

        The encoder input is [Δobs·v flattened over K, act·v flattened over
        K] (not interleaved). For ``context='none'`` returns a zero-width
        tensor so downstream concatenation needs no branch.
        """
        nd = (hist_dobs - norm.dobs_mean) / norm.dobs_std
        na = (hist_act - norm.act_mean) / norm.act_std
        v = hist_valid[..., None]
        flat = torch.cat(
            [(nd * v).flatten(-2), (na * v).flatten(-2)], dim=-1
        )
        if self.cfg.context == "encoder":
            return mlp_apply(params["encoder"], flat)
        return flat[..., :0]

    # ---------------------------------------------------------- predict --
    def _head_out(self, head_params: MLP, params: dict, norm: NormStats,
                  x_in: Tensor, act: Tensor, z: Tensor
                  ) -> Tuple[Tensor, Optional[Tensor]]:
        """Normalized-delta prediction (mean, None) from one head."""
        nx = (x_in - norm.obs_mean) / norm.obs_std
        na = (act - norm.act_mean) / norm.act_std
        return mlp_apply(head_params, torch.cat([nx, na, z], dim=-1)), None

    def predict(self, params: dict, norm: NormStats, member_fwd: MLP,
                obs: Tensor, act: Tensor, z: Tensor) -> Tensor:
        """Next-obs prediction through ONE member's forward head."""
        mean, _ = self._head_out(member_fwd, params, norm, obs, act, z)
        return obs + (norm.dobs_mean + norm.dobs_std * mean)

    # ------------------------------------------------------------- loss --
    def loss(self, params: dict, norm: NormStats, batch: SegmentBatch
             ) -> Tuple[Tensor, dict]:
        """Joint CaDM loss over member-indexed segment batches.

        ``batch`` leaves have shape (n_members, B, ...). The context z is
        computed once per segment and shared by all M future steps; the
        backward head predicts the previous observation through the negated
        normalized delta. Each member's steps are weighted by
        valid/(Σvalid + 1e-8); members are averaged.
        """
        c = self.cfg
        losses, mses = [], []
        for m in range(c.n_members):
            mb = tree_map(lambda x: x[m], batch)
            z = self.get_context(params, norm, mb.hist_dobs, mb.hist_act,
                                 mb.hist_valid)                  # (B, ctx)
            z_m = z[:, None, :].expand(*mb.obs.shape[:-1], z.shape[-1])
            target = (mb.next_obs - mb.obs - norm.dobs_mean) / norm.dobs_std
            f_mean, _ = self._head_out(member(params["fwd"], m), params, norm,
                                       mb.obs, mb.act, z_m)
            per_step = ((f_mean - target) ** 2).sum(-1)          # (B, M)
            if "bwd" in params:
                b_mean, _ = self._head_out(member(params["bwd"], m), params,
                                           norm, mb.next_obs, mb.act, z_m)
                per_step = per_step + c.beta_backward * (
                    (b_mean + target) ** 2).sum(-1)
            w = mb.valid / (mb.valid.sum() + 1e-8)
            # forward-mean error, the planner-relevant model quality
            mses.append((((f_mean - target) ** 2).mean(-1) * w).sum())
            losses.append((per_step * w).sum())
        total = torch.stack(losses).mean()
        return total, {"model_loss": total,
                       "fwd_mean_mse": torch.stack(mses).mean()}

    # ----------------------------------------------------------- update --
    def update(self, state: DynamicsState, batch: SegmentBatch
               ) -> Tuple[DynamicsState, dict]:
        """One step of clip_by_global_norm(grad_clip) → Adam(lr), as optax.

        The clip scales every gradient by grad_clip/‖g‖ only when the global
        norm ‖g‖ over all leaves is ≥ grad_clip (no epsilon is added, unlike
        ``torch.nn.utils.clip_grad_norm_``). Adam: μ ← (1−b1)·g + b1·μ,
        ν ← (1−b2)·g² + b2·ν, p ← p − lr·μ̂/(√ν̂ + eps) with the bias
        corrections of step count+1. Returns a new state of new tensors.
        """
        c, opt = self.cfg, state.opt_state
        leaves = tree_leaves(state.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = self.loss(tree_unflatten(state.params, live),
                                      state.norm, batch)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            coef = torch.where(g_norm < c.grad_clip, 1.0, c.grad_clip / g_norm)
            grads = torch._foreach_mul(grads, coef)
            mu = torch._foreach_add(
                torch._foreach_mul(grads, 1 - self.b1),
                torch._foreach_mul(tree_leaves(opt.mu), self.b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(grads, grads),
                                   1 - self.b2),
                torch._foreach_mul(tree_leaves(opt.nu), self.b2))
            count = opt.count + 1
            mu_hat = torch._foreach_div(mu, 1 - self.b1 ** count)
            nu_hat = torch._foreach_div(nu, 1 - self.b2 ** count)
            step = torch._foreach_div(
                mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                           self.eps))
            new = torch._foreach_add(leaves, torch._foreach_mul(step, -c.lr))
        like = state.params
        return (
            DynamicsState(
                params=tree_unflatten(like, new), norm=state.norm,
                opt_state=AdamState(count, tree_unflatten(like, mu),
                                    tree_unflatten(like, nu)),
                updates=state.updates + 1,
            ),
            {k: v.detach() for k, v in metrics.items()},
        )
