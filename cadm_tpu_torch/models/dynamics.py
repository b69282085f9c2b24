"""Context-aware dynamics model (counterpart of cadm_tpu/models/dynamics.py).

The model zoo of one class, by ``context``:

- ``'none'``: the plain model (vanilla, or PE-TS with members);
- ``'stacked'``: the baseline that feeds the normalized, valid-masked flat
  past-K (Δobs, action) window to the heads as their context;
- ``'encoder'``: CaDM, an MLP encoder of that window → latent z;
- ``'rnn'``: ReBAL, a GRU over (Δobs, action) pairs projected to z. Training
  runs it over each sampled K-window from h0 = 0; acting carries the hidden
  state across the whole episode in ``History.rnn_h``.

Member-stacked forward heads predict normalized Δobs (CaDM and ReBAL add a
backward head); the joint loss is L_fwd + β·L_bwd over M future steps
sharing one context; the optimizer step (``clip_adam_step``) is
``clip_by_global_norm(grad_clip)`` then Adam(lr), exactly as the
reference's optax chain.

``n_members > 1`` with ``probabilistic`` is the PE-TS ensemble: mean and
log-variance heads, the log-variance kept inside learned soft bounds
[min_logvar, max_logvar] with a penalty on their width, a Gaussian NLL (by
default the reference's decoupled form: MSE on the means plus the NLL around
the frozen means) and bootstrap minibatches per member. The members run as
one batched product over the member axis, in the loss as in prediction.

On a mesh (``parallel.mesh``) a model rank holds and trains its block of
the members: its loss terms are its members', the loss and its metrics are
taken over every member's (gathered over ``model``), and the gradients of
the shared leaves and the clip's global norm are summed over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from cadm_tpu_torch.core.types import (
    History,
    constant,
    resolve_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
import torch.nn.functional as F

from cadm_tpu_torch.models.nets import (
    MLP,
    gru_apply,
    gru_init,
    linear,
    mlp_apply,
    mlp_init,
    swish,
)

Tensor = torch.Tensor
CONTEXTS = ("none", "stacked", "encoder", "rnn")

# Semantics marker of the probabilistic-member loss (the decoupled form of
# the module docstring), recorded into every result-matrix
# cell (``cli/matrix.py``) so cells of another loss stay distinguishable in
# the rendered table. The reference's own value; bump on any change to
# ``Dynamics._head_nll``'s semantics.
LOSS_VARIANT = "decoupled-sg-v1"


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (200, 200, 200, 200)
    n_members: int = 1
    probabilistic: bool = False
    context: str = "none"  # 'none' | 'stacked' | 'encoder' | 'rnn'
    z_dim: int = 10
    rnn_hidden: int = 64
    history_k: int = 10
    future_m: int = 10
    encoder_hidden: Tuple[int, ...] = (256, 128)
    backward: bool = True          # train the backward head (CaDM only)
    beta_backward: float = 0.5     # β in L_fwd + β·L_bwd
    lr: float = 1e-3
    grad_clip: float = 10.0
    logvar_penalty: float = 0.01   # PETS bound-tightness penalty
    # Probabilistic members: the loss is mean_anchor · Σ (mean − target)²
    # + the Gaussian NLL around the stop-gradient means (the reference's
    # decoupled-sg-v1); 0 restores the joint PETS NLL.
    mean_anchor: float = 1.0
    # Probabilistic members: the log-variance columns of the last layer read
    # the trunk's features through a stop-gradient, so the NLL trains no
    # trunk weight (the reference's opt-in r5 variant).
    detach_logvar_trunk: bool = False

    @property
    def hist_dim(self) -> int:
        return self.history_k * (self.obs_dim + self.act_dim)

    @property
    def context_dim(self) -> int:
        if self.context in ("encoder", "rnn"):
            return self.z_dim
        return self.hist_dim if self.context == "stacked" else 0

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
    """optax's ``ScaleByAdamState``: the step count (an int32 scalar on the
    parameters' device, as optax's, so a captured update reads it instead of
    baking in the bias corrections of the step it captured) and the first
    and second moments (trees shaped like the parameters)."""

    count: Tensor
    mu: dict
    nu: dict

    @staticmethod
    def zeros_like(params: dict) -> "AdamState":
        device = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def member_leaves(params: dict, member_keys: Sequence[str]) -> List[bool]:
    """For each leaf of ``tree_leaves(params)``: is it under one of the
    member-stacked keys?"""
    return [k in member_keys for k in sorted(params)
            for _ in tree_leaves(params[k])]


def clip_adam_step(params, opt: AdamState, grads: list, lr: float,
                   grad_clip: float, mesh=None,
                   member_keys: Sequence[str] = ()):
    """One step of optax's ``chain(clip_by_global_norm(grad_clip),
    adam(lr))`` → (new params, new AdamState); ``grads`` in
    ``tree_leaves(params)`` order.

    The clip scales every gradient by grad_clip/‖g‖ only when the global
    norm ‖g‖ over all leaves is ≥ grad_clip (no epsilon is added, unlike
    ``torch.nn.utils.clip_grad_norm_``). Adam: μ ← (1−b1)·g + b1·μ,
    ν ← (1−b2)·g² + b2·ν, p ← p − lr·μ̂/(√ν̂ + eps) with the bias
    corrections 1 − b^(count+1) of step count+1, computed on the device in
    float64 and rounded to float32. Returns new tensors; reads nothing on
    the host and makes no tensor from host data, so a CUDA graph can hold
    it (the mesh's branch aside, whose sum over ``model`` a graph cannot).

    With a ``mesh`` whose model axis splits the leaves under
    ``member_keys``, the norm counts each rank's member block once (summed
    over ``model``) and each shared leaf once.
    """
    b1, b2 = ADAM_B1, ADAM_B2
    leaves = [p.detach() for p in tree_leaves(params)]
    with torch.no_grad():
        norms = torch.stack(torch._foreach_norm(grads))
        if mesh is None or mesh.model == 1:
            g_norm = torch.linalg.vector_norm(norms)
        else:
            sq = norms.square()
            heads = constant(member_leaves(params, member_keys), sq.device,
                             torch.bool)
            g_norm = torch.sqrt(mesh.sum([sq[heads].sum()], "model")[0]
                                + sq[~heads].sum())
        coef = torch.where(g_norm < grad_clip, 1.0, grad_clip / g_norm)
        grads = torch._foreach_mul(grads, coef)
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(tree_leaves(opt.mu), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(tree_leaves(opt.nu), b2))
        count = opt.count + 1
        c = count.double()
        mu_hat = torch._foreach_div(mu, (1 - torch.pow(b1, c)).float())
        nu_hat = torch._foreach_div(nu, (1 - torch.pow(b2, c)).float())
        step = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
        new = torch._foreach_add(leaves, torch._foreach_mul(step, -lr))
    return (tree_unflatten(params, new),
            AdamState(count, tree_unflatten(params, mu),
                      tree_unflatten(params, nu)))


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

    # the member-stacked params: a mesh's model axis splits these
    member_keys = ("fwd", "bwd")

    def __init__(self, config: DynamicsConfig, device="cuda", mesh=None):
        """``mesh``: the ``parallel.mesh.Mesh`` whose model axis splits
        the members (states from ``shard_dynamics_state``), or None."""
        if config.context not in CONTEXTS or config.n_members < 1:
            raise ValueError(f"context must be one of {CONTEXTS} and "
                             f"n_members >= 1, got {config}")
        if mesh is not None:
            mesh.local_count(config.n_members, "model", "ensemble members")
        self.cfg = config
        self.device = resolve_device(device)
        self.mesh = mesh

    # ------------------------------------------------------------- init --
    def init_params(self, gen: torch.Generator) -> dict:
        c = self.cfg
        params = {}
        if c.context == "encoder":
            params["encoder"] = mlp_init(
                gen, [c.hist_dim, *c.encoder_hidden, c.z_dim]
            )
        elif c.context == "rnn":
            params["encoder"] = {
                "gru": gru_init(gen, c.obs_dim + c.act_dim, c.rnn_hidden),
                "proj": mlp_init(gen, [c.rnn_hidden, c.z_dim]),
            }
        head_sizes = [c.head_in_dim, *c.hidden, c.head_out_dim]
        params["fwd"] = mlp_init(gen, head_sizes, c.n_members)
        if c.context in ("encoder", "rnn") and c.backward:
            params["bwd"] = mlp_init(gen, head_sizes, c.n_members)
        if c.probabilistic:
            params["max_logvar"] = torch.full((c.obs_dim,), 0.5,
                                              device=gen.device)
            params["min_logvar"] = torch.full((c.obs_dim,), -10.0,
                                              device=gen.device)
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
        """Per-env context (E, context_dim) from a batched History; for
        ``context='rnn'`` the projection of the episode-recurrent
        ``hists.rnn_h``, not a re-encoding of the window."""
        if self.cfg.context == "rnn":
            return mlp_apply(params["encoder"]["proj"], hists.rnn_h)
        return self.get_context(params, norm, hists.dobs, hists.act,
                                hists.valid)

    def push_history(self, params: dict, norm: NormStats, hists: History,
                     obs: Tensor, dobs: Tensor, act: Tensor) -> History:
        """Advance the batched histories by one transition; for
        ``context='rnn'`` also one GRU step of ``rnn_h`` on the normalized
        (Δobs, action) with the current norm. Callers wipe it on done."""
        pushed = hists.push(obs, dobs, act)
        if self.cfg.context != "rnn":
            return pushed
        x = torch.cat([(dobs - norm.dobs_mean) / norm.dobs_std,
                       (act - norm.act_mean) / norm.act_std], dim=-1)
        return dataclasses.replace(
            pushed, rnn_h=gru_apply(params["encoder"]["gru"], hists.rnn_h, x))

    def get_context(self, params: dict, norm: NormStats, hist_dobs: Tensor,
                    hist_act: Tensor, hist_valid: Tensor) -> Tensor:
        """Latent context from the past-K window, shape (..., context_dim).

        The encoder and stacked input is [Δobs·v flattened over K, act·v
        flattened over K] (not interleaved). ``context='rnn'`` runs the GRU
        over the window's (Δobs·v, act·v) from h0 = 0, keeping h where
        ``valid`` is 0. For ``context='none'`` returns a zero-width tensor
        so downstream concatenation needs no branch.
        """
        c = self.cfg
        nd = (hist_dobs - norm.dobs_mean) / norm.dobs_std
        na = (hist_act - norm.act_mean) / norm.act_std
        v = hist_valid[..., None]
        if c.context == "rnn":
            x = torch.cat([nd * v, na * v], dim=-1)          # (..., K, d)
            h = x.new_zeros(*x.shape[:-2], c.rnn_hidden)
            for t in range(x.shape[-2]):
                h_new = gru_apply(params["encoder"]["gru"], h, x[..., t, :])
                h = torch.where(v[..., t, :] > 0, h_new, h)
            return mlp_apply(params["encoder"]["proj"], h)
        flat = torch.cat(
            [(nd * v).flatten(-2), (na * v).flatten(-2)], dim=-1
        )
        if c.context == "encoder":
            return mlp_apply(params["encoder"], flat)
        return flat if c.context == "stacked" else flat[..., :0]

    # ---------------------------------------------------------- predict --
    def _head_out(self, head_params: MLP, params: dict, norm: NormStats,
                  x_in: Tensor, act: Tensor, z: Tensor
                  ) -> Tuple[Tensor, Optional[Tensor]]:
        """Normalized-delta prediction (mean, logvar | None) from one head.

        ``head_params`` is one member's MLP, or the member-stacked MLP with
        a leading member axis on the inputs. A probabilistic head's
        log-variance is kept inside [min_logvar, max_logvar] by the PETS
        soft bounds.
        """
        c = self.cfg
        nx = (x_in - norm.obs_mean) / norm.obs_std
        na = (act - norm.act_mean) / norm.act_std
        inp = torch.cat([nx, na, z], dim=-1)
        if c.probabilistic and c.detach_logvar_trunk:
            # the same values as the fused apply; the logvar columns see
            # the trunk's features through a stop-gradient
            feats = (swish(mlp_apply(head_params[:-1], inp))
                     if len(head_params) > 1 else inp)
            last = head_params[-1]
            d = last["w"].shape[-1] // 2
            mean = linear({"w": last["w"][..., :d], "b": last["b"][..., :d]},
                          feats)
            logvar = linear({"w": last["w"][..., d:],
                             "b": last["b"][..., d:]}, feats.detach())
        else:
            out = mlp_apply(head_params, inp)
            if not c.probabilistic:
                return out, None
            mean, logvar = out.chunk(2, dim=-1)
        logvar = params["max_logvar"] - F.softplus(params["max_logvar"] - logvar)
        logvar = params["min_logvar"] + F.softplus(logvar - params["min_logvar"])
        return mean, logvar

    def predict(self, params: dict, norm: NormStats, fwd: MLP, obs: Tensor,
                act: Tensor, z: Tensor, noise: Optional[Tensor] = None
                ) -> Tensor:
        """Next-obs prediction through the forward head ``fwd``: one
        member's MLP, or the member-stacked ``params["fwd"]`` with a leading
        member axis on obs/act/z. With ``noise`` (standard normals shaped
        like obs) a probabilistic model samples from its predicted Gaussian;
        otherwise it returns the mean."""
        mean, logvar = self._head_out(fwd, params, norm, obs, act, z)
        if logvar is not None and noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise
        return obs + (norm.dobs_mean + norm.dobs_std * mean)

    # ------------------------------------------------------------- loss --
    @staticmethod
    def _nll(mean: Tensor, logvar: Optional[Tensor], target: Tensor) -> Tensor:
        if logvar is None:
            return ((mean - target) ** 2).sum(-1)
        return ((mean - target) ** 2 * torch.exp(-logvar) + logvar).sum(-1)

    def _head_nll(self, mean: Tensor, logvar: Optional[Tensor],
                  target: Tensor) -> Tensor:
        """One head's per-step loss: the NLL (squared error for a
        deterministic head), or with ``mean_anchor`` > 0 on a probabilistic
        head the anchored MSE plus the NLL around the frozen means."""
        c = self.cfg
        if not (c.probabilistic and c.mean_anchor > 0.0):
            return self._nll(mean, logvar, target)
        return (c.mean_anchor * ((mean - target) ** 2).sum(-1)
                + self._nll(mean.detach(), logvar, target))

    def _terms(self, params: dict, norm: NormStats, batch: SegmentBatch
               ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """(each member's loss, each member's forward-mean MSE, the
        log-variance bound penalty or None) of the members in ``batch``."""
        c = self.cfg
        z = self.get_context(params, norm, batch.hist_dobs, batch.hist_act,
                             batch.hist_valid)                  # (n, B, ctx)
        z_m = z[..., None, :].expand(*batch.obs.shape[:-1], z.shape[-1])
        target = (batch.next_obs - batch.obs - norm.dobs_mean) / norm.dobs_std
        f_mean, f_logvar = self._head_out(params["fwd"], params, norm,
                                          batch.obs, batch.act, z_m)
        per_step = self._head_nll(f_mean, f_logvar, target)     # (n, B, M)
        if "bwd" in params:
            b_mean, b_logvar = self._head_out(params["bwd"], params, norm,
                                              batch.next_obs, batch.act, z_m)
            per_step = per_step + c.beta_backward * self._head_nll(
                b_mean, b_logvar, -target)
        w = batch.valid / (batch.valid.sum((-2, -1), keepdim=True) + 1e-8)
        # forward-mean error, the planner-relevant model quality
        mses = (((f_mean - target) ** 2).mean(-1) * w).sum((-2, -1))
        losses = (per_step * w).sum((-2, -1))
        pen = None
        if c.probabilistic:
            pen = c.logvar_penalty * (params["max_logvar"].sum()
                                      - params["min_logvar"].sum())
        return losses, mses, pen

    def _metrics(self, losses: Tensor, mses: Tensor, pen: Optional[Tensor]
                 ) -> Tuple[Tensor, dict]:
        """(loss, metrics) from the member terms: means over every member
        (gathered over the mesh's model axis), plus the penalty."""
        if self.mesh is not None:
            losses, mses = self.mesh.gather([losses, mses], "model")
        total = losses.mean()
        metrics = {"model_loss": total, "fwd_mean_mse": mses.mean()}
        if pen is not None:
            total = total + pen
            metrics["logvar_bound_penalty"] = pen
        return total, metrics

    def loss(self, params: dict, norm: NormStats, batch: SegmentBatch
             ) -> Tuple[Tensor, dict]:
        """Joint CaDM loss over member-indexed segment batches.

        ``batch`` leaves have shape (n_members, B, ...); all members run at
        once. The context z is computed once per segment and shared by all
        M future steps; the backward head predicts the previous observation
        through the negated normalized delta. Each member's steps are
        weighted by valid/(Σvalid + 1e-8); members are averaged. A
        probabilistic model adds logvar_penalty·(Σmax_logvar − Σmin_logvar)
        to the returned loss (not to the ``model_loss`` metric). On a mesh
        ``batch`` holds this rank's members and the loss (which then carries
        no gradient) is every member's.
        """
        return self._metrics(*self._terms(params, norm, batch))

    # ----------------------------------------------------------- update --
    def update(self, state: DynamicsState, batch: SegmentBatch
               ) -> Tuple[DynamicsState, dict]:
        """One ``clip_adam_step`` on the loss of ``batch``. Returns a new
        state of new tensors.

        On a mesh whose model axis splits the members, each rank
        differentiates its members' share of the loss (the penalty on the
        first model rank) and the shared leaves' gradients are summed over
        ``model``."""
        mesh = self.mesh
        split = mesh is not None and mesh.model > 1
        live = [p.detach().requires_grad_(True)
                for p in tree_leaves(state.params)]
        with torch.enable_grad():
            losses, mses, pen = self._terms(
                tree_unflatten(state.params, live), state.norm, batch)
            objective = (losses.sum() / self.cfg.n_members if split
                         else losses.mean())
            if pen is not None and not (split and mesh.index("model")):
                objective = objective + pen
            grads = list(torch.autograd.grad(objective, live))
        if split:
            heads = member_leaves(state.params, self.member_keys)
            shared = [i for i, h in enumerate(heads) if not h]
            for i, g in zip(shared, mesh.sum([grads[i] for i in shared],
                                             "model")):
                grads[i] = g
        with torch.no_grad():
            _, metrics = self._metrics(losses.detach(), mses.detach(),
                                       None if pen is None else pen.detach())
        params, opt = clip_adam_step(state.params, state.opt_state,
                                     grads, self.cfg.lr,
                                     self.cfg.grad_clip, mesh,
                                     self.member_keys)
        return (
            DynamicsState(params=params, norm=state.norm, opt_state=opt,
                          updates=state.updates + 1),
            {k: v.detach() for k, v in metrics.items()},
        )
