"""Shared base for the rigid-body env families (counterpart of
cadm_tpu/envs/rigid_base.py).

Per-episode hidden mass/damping scale draws, batched observation-only
rewards, and stepping through the port's rigid engine
(``cadm_tpu_torch.physics.rigid``). The Systems are read from the npz files
under ``envs/assets/`` that ``scripts/make_torch_systems.py`` writes from the
MJCF assets, so the port needs no MJCF parser.
"""
from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import numpy as np
import torch

from cadm_tpu_torch.core.types import PyTree
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.envs.ranges import canonical
from cadm_tpu_torch.physics.rigid import dynamics as rdyn
from cadm_tpu_torch.physics.rigid.system import System

Tensor = torch.Tensor

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
ASSETS = ("half_cheetah", "hopper", "ant", "slim_humanoid")


@lru_cache(maxsize=None)
def load_system(asset: str) -> System:
    """The System of an asset (e.g. "half_cheetah") from its npz file."""
    name = asset[:-4] if asset.endswith(".xml") else asset
    with np.load(os.path.join(ASSET_DIR, name + ".npz")) as z:
        data = {k: z[k] for k in z.files}
    kwargs = {}
    for f in dataclasses.fields(System):
        v = data[f.name]
        kwargs[f.name] = v.item() if v.ndim == 0 else v
    return System(**kwargs)


@dataclasses.dataclass
class RigidPhys:
    qpos: Tensor  # (E, nq)
    qvel: Tensor  # (E, nv)


@dataclasses.dataclass
class MassDampingParams:
    """Hidden per-episode scales (paper §5.1 mass/damping randomization)."""

    mass_scale: Tensor     # (E,)
    damping_scale: Tensor  # (E,)


class RigidEnv(Env):
    asset: str
    frame_skip: int

    def __init__(self, randomization: str = "discrete", **overrides):
        super().__init__(randomization, **overrides)
        self.sys = load_system(self.asset)
        self._scale = canonical(randomization)

    def sample_params(self, gen: torch.Generator, mode: int, n: int) -> PyTree:
        return MassDampingParams(
            mass_scale=self._scale.sample(gen, mode, n),
            damping_scale=self._scale.sample(gen, mode, n),
        )

    def rigid_params(self, params: PyTree) -> rdyn.RigidParams:
        n = params.mass_scale.shape[0]
        return rdyn.RigidParams(
            mass_scale=params.mass_scale,
            damping_scale=params.damping_scale,
            act_mask=torch.ones(n, self.sys.nu, device=params.mass_scale.device),
        )

    # healthy locomotion speeds are O(10); contact-solver blowups shoot past
    # 1e3 within a frame. Episodes whose state crosses this end early.
    QVEL_BLOWUP = 1e3

    # healthy rigid-body obs magnitudes are O(10); 10x that is junk
    bad_obs_limit = 150.0
    bad_dobs_limit = 100.0

    def unstable(self, phys: RigidPhys) -> Tensor:
        finite = torch.isfinite(phys.qpos).all(-1) & torch.isfinite(phys.qvel).all(-1)
        return (~finite) | (phys.qvel.abs().amax(-1) > self.QVEL_BLOWUP)

    def step_phys(self, params: PyTree, phys: RigidPhys, action: Tensor) -> RigidPhys:
        qpos, qvel = rdyn.step_n(
            self.sys, self.rigid_params(params), phys.qpos, phys.qvel, action,
            self.frame_skip,
        )
        return RigidPhys(qpos=qpos, qvel=qvel)

    @property
    def act_dim(self) -> int:  # type: ignore[override]
        return self.sys.nu
