"""On-device replay ring with trajectory-segment sampling (counterpart of
cadm_tpu/train/buffer.py).

A preallocated per-env ring of (obs, act, next_obs, done, ep_step, bad)
columns on the device. The collect loop appends one time-slice over all envs
per control step; the fit gathers (history-K + future-M) windows by index.
Segment validity comes from the stored within-episode step counter
``ep_step`` (a history slot j steps back is real iff the episode is at least
j steps old; the future window is contiguous iff ``ep_step`` advances by one
per step and no earlier step in it ended the episode), so sampling needs no
rejection.

Unlike the reference's immutable pytree, ``append`` writes the ring in place
(at full size it is 2048 envs × 20000 columns, about 6.6 GB) and keeps
``ptr``/``size`` as host integers. The reference's ``sample_segments`` is
split into drawing the indices (``draw_indices``, from a ``torch.Generator``)
and the gather that takes them (``gather``), so a test can hand both packages
the same indices.

On a mesh (``parallel.mesh``) each dp rank's ring holds its block of the
envs: indices are drawn over every env, each rank gathers the segments of
its own rows and one all-reduce over ``dp`` gives every rank the whole
batch, and the norm statistics sum over ``dp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cadm_tpu_torch.core.types import tree_map
from cadm_tpu_torch.models.dynamics import NormStats, SegmentBatch

Tensor = torch.Tensor


@dataclasses.dataclass
class ReplayBuffer:
    obs: Tensor       # (E, S, obs_dim)
    act: Tensor       # (E, S, act_dim)
    next_obs: Tensor  # (E, S, obs_dim)
    done: Tensor      # (E, S) bool
    ep_step: Tensor   # (E, S) int32 — t within episode at this transition
    bad: Tensor       # (E, S) bool — unhealthy magnitude (Env.bad_transition);
                      # masked out of norm stats, loss weights and history
    ptr: int = 0      # next physical write column
    size: int = 0     # valid columns (<= S)

    # Every 10th logical column is reserved for validation: a persistent
    # train/valid partition that survives buffer growth.
    VALID_STRIDE = 10

    @staticmethod
    def create(n_envs: int, capacity: int, obs_dim: int, act_dim: int,
               device=None) -> "ReplayBuffer":
        z = lambda *s, **kw: torch.zeros(n_envs, capacity, *s,  # noqa: E731
                                         device=device, **kw)
        return ReplayBuffer(
            obs=z(obs_dim), act=z(act_dim), next_obs=z(obs_dim),
            done=z(dtype=torch.bool), ep_step=z(dtype=torch.int32),
            bad=z(dtype=torch.bool),
        )

    @property
    def capacity(self) -> int:
        return self.obs.shape[1]

    @property
    def n_envs(self) -> int:
        return self.obs.shape[0]

    # ----------------------------------------------------------- append --
    def append(self, obs: Tensor, act: Tensor, next_obs: Tensor, done: Tensor,
               ep_step: Tensor, bad: Optional[Tensor] = None) -> "ReplayBuffer":
        """Write one time-slice across all envs at ``ptr`` (in place)."""
        p = self.ptr
        self.obs[:, p] = obs
        self.act[:, p] = act
        self.next_obs[:, p] = next_obs
        self.done[:, p] = done
        self.ep_step[:, p] = ep_step
        self.bad[:, p] = False if bad is None else bad
        self.ptr = (p + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        return self

    # ----------------------------------------------------------- sample --
    def n_valid_anchors(self) -> int:
        return self.size // self.VALID_STRIDE

    def n_train_anchors(self) -> int:
        return self.size - self.n_valid_anchors()

    def draw_indices(self, gen: torch.Generator, batch_shape: Tuple[int, ...],
                     split: Optional[str] = None, mesh=None
                     ) -> Tuple[Tensor, Tensor]:
        """(env_idx, t_idx) of ``batch_shape`` random segment anchors.

        ``t_idx`` is the logical column (0 = oldest) of the first future
        step. ``split``: None draws anywhere; "train"/"valid" restrict the
        anchor to its persistent partition (columns ≡ VALID_STRIDE-1 mod
        VALID_STRIDE are validation). Windows may still cross partition
        columns: the holdout is on anchors, as in the reference. On a
        ``mesh`` ``env_idx`` ranges over the envs of every dp rank.
        """
        n_anchors = {None: self.size, "train": self.n_train_anchors(),
                     "valid": self.n_valid_anchors()}
        if split not in n_anchors:
            raise ValueError(f"unknown split: {split!r}")
        dev = self.obs.device
        n_envs = self.n_envs * (1 if mesh is None else mesh.dp)
        env_idx = torch.randint(0, n_envs, batch_shape, generator=gen,
                                device=dev)
        u = torch.randint(0, max(n_anchors[split], 1), batch_shape,
                          generator=gen, device=dev)
        return env_idx, self.anchor_columns(u, split)

    def anchor_columns(self, u: Tensor, split: Optional[str]) -> Tensor:
        """Logical anchor columns of uniform draws ``u`` over the split's
        anchors: every column (None), the train columns (skipping each
        VALID_STRIDE-th) or the valid columns."""
        s = self.VALID_STRIDE
        if split == "train":
            return (u // (s - 1)) * s + (u % (s - 1))
        if split == "valid":
            return u * s + (s - 1)
        return u

    def gather(self, env_idx: Tensor, t_idx: Tensor, k: int, m: int,
               mesh=None) -> SegmentBatch:
        """The K-history + M-future segments anchored at (env_idx, t_idx).

        On a ``mesh`` ``env_idx`` ranges over the envs of every dp rank:
        each rank fills the segments of its own rows and zeroes the rest,
        and a sum over ``dp`` gives every rank the whole batch."""
        dev = self.obs.device
        own = None
        if mesh is not None:
            env_idx = env_idx - mesh.index("dp") * self.n_envs
            own = (env_idx >= 0) & (env_idx < self.n_envs)
            env_idx = env_idx.clamp(0, self.n_envs - 1)
        start = (self.ptr - self.size) % self.capacity  # oldest logical column
        env_idx = env_idx[..., None]

        def take(field, logical_idx):
            return field[env_idx, (start + logical_idx) % self.capacity]

        offs_h = torch.arange(-k, 0, device=dev)
        offs_f = torch.arange(0, m, device=dev)
        h_idx = t_idx[..., None] + offs_h          # (..., K) logical, may be <0
        f_idx = t_idx[..., None] + offs_f          # (..., M) may be >= size
        h_in_range = (h_idx >= 0) & (h_idx < self.size)
        f_in_range = f_idx < self.size
        last = max(self.size - 1, 0)
        h_idx_c = h_idx.clamp(0, last)
        f_idx_c = f_idx.clamp(0, last)

        hist_obs = take(self.obs, h_idx_c)
        hist_next = take(self.next_obs, h_idx_c)
        hist_es = take(self.ep_step, h_idx_c)
        hist_bad = take(self.bad, h_idx_c)
        f_es = take(self.ep_step, f_idx_c)
        f_done = take(self.done, f_idx_c).to(torch.int32)
        f_bad = take(self.bad, f_idx_c)

        # history slot at offset -j is real iff same episode: ep_step == es0-j
        es0 = f_es[..., :1]  # episode step at the anchor
        expect_h = es0 + offs_h
        hist_valid = (h_in_range & (hist_es == expect_h) & (expect_h >= 0)
                      & ~hist_bad).float()
        # future step at offset +j is usable iff contiguous and no earlier
        # step of the window ended the episode
        contig = f_in_range & (f_es == es0 + offs_f)
        prev_done = torch.cumsum(f_done, dim=-1) - f_done
        valid = (contig & (prev_done == 0) & ~f_bad).float()
        batch = SegmentBatch(
            hist_obs=hist_obs,
            hist_dobs=hist_next - hist_obs,
            hist_act=take(self.act, h_idx_c),
            hist_valid=hist_valid,
            obs=take(self.obs, f_idx_c),
            act=take(self.act, f_idx_c),
            next_obs=take(self.next_obs, f_idx_c),
            valid=valid,
        )
        if mesh is None:
            return batch
        batch = tree_map(lambda x: torch.where(
            own.view(own.shape + (1,) * (x.ndim - own.ndim)), x, 0.0), batch)
        return mesh.sum_tree(batch, "dp")

    # ------------------------------------------------------------ stats --
    def norm_inputs(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(obs, act, dobs, mask) flattened over (E, S) for the statistics."""
        cols = torch.arange(self.capacity, device=self.obs.device)
        mask = (cols[None, :] < self.size) & ~self.bad
        d = self.obs.shape[-1]
        return (
            self.obs.reshape(-1, d),
            self.act.reshape(-1, self.act.shape[-1]),
            (self.next_obs - self.obs).reshape(-1, d),
            mask.reshape(-1),
        )

    def norm_stats(self, mesh=None) -> NormStats:
        """The model's normalization statistics (mean and population std of
        obs, act and Δobs) over the ring's filled, healthy columns; on a
        ``mesh`` over the rings of every dp rank."""
        obs, act, dobs, mask = self.norm_inputs()
        return NormStats(*masked_mean_std(obs, mask, mesh=mesh),
                         *masked_mean_std(act, mask, mesh=mesh),
                         *masked_mean_std(dobs, mask, mesh=mesh))


def masked_mean_std(x: Tensor, mask: Tensor, eps: float = 1e-6, mesh=None
                    ) -> Tuple[Tensor, Tensor]:
    """Mean and population std (``sqrt(var + eps) + eps``) over the rows
    where ``mask`` is true; on a ``mesh`` over the rows of every dp rank,
    with the same two passes (the masked sums and the count, then
    Σw·(x − mean)², each summed over ``dp``)."""
    def total(*xs):
        return xs if mesh is None else mesh.sum(xs, "dp")

    w = mask.to(x.dtype)[:, None]
    s, cnt = total((x * w).sum(0), w.sum())
    n = torch.clamp(cnt, min=1.0)
    mean = s / n
    (sq,) = total(((x - mean) ** 2 * w).sum(0))
    return mean, torch.sqrt(sq / n + eps) + eps
