"""Context-aware dynamics model (counterpart of cadm_tpu/models/dynamics.py).

The acting half of the reference's model family: the CaDM context encoder
(``context='encoder'``: past-K (Δobs, action) window → latent z) and the
plain model (``context='none'``), each with member-stacked forward and
backward heads predicting normalized Δobs. This slice supports one
deterministic member; the loss and the optimizer step come with the
training port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cadm_tpu_torch.core.types import History
from cadm_tpu_torch.models.nets import MLP, mlp_apply, mlp_init

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
    encoder_hidden: Tuple[int, ...] = (256, 128)
    backward: bool = True          # the backward head (CaDM only)

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
class DynamicsState:
    """Model parameters (a dict of MLPs) and normalization statistics."""

    params: dict
    norm: NormStats


class Dynamics:
    """Functional dynamics-model API shared by planners and trainers."""

    def __init__(self, config: DynamicsConfig, device="cpu"):
        if config.context not in CONTEXTS or config.n_members != 1 \
                or config.probabilistic:
            raise NotImplementedError(
                "the port supports context 'none'/'encoder' with one "
                f"deterministic member, got {config}"
            )
        self.cfg = config
        self.device = torch.device(device)

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
        return DynamicsState(
            params=self.init_params(gen),
            norm=NormStats.identity(self.cfg.obs_dim, self.cfg.act_dim,
                                    self.device),
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
