"""Env registry of the port (counterpart of cadm_tpu/envs/__init__.py).

Only HalfCheetah is ported so far; the other families' Systems already ship
under ``assets/`` and load with ``rigid_base.load_system``.
"""
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv

ENVS = {
    "half_cheetah": HalfCheetahEnv,
}


def make(name: str, randomization: str = "discrete", device="cpu",
         **overrides) -> Env:
    """Construct an env family on ``device``; ``horizon`` in
    ``overrides`` replaces the family's episode length."""
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} is not ported yet (ported: {sorted(ENVS)})"
        )
    return ENVS[name](randomization, device=device, **overrides)
