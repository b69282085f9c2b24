"""Env registry of the port (counterpart of cadm_tpu/envs/__init__.py).

The five rigid-body families are ported; the analytic ones (cartpole,
pendulum) are not, and ``make`` raises ``NotImplementedError`` for them.
"""
from cadm_tpu_torch.envs.ant import AntEnv, CrippleAntEnv
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.envs.hopper import HopperEnv
from cadm_tpu_torch.envs.slim_humanoid import SlimHumanoidEnv

ENVS = {
    "half_cheetah": HalfCheetahEnv,
    "hopper": HopperEnv,
    "ant": AntEnv,
    "cripple_ant": CrippleAntEnv,
    "slim_humanoid": SlimHumanoidEnv,
}


def make(name: str, randomization: str = "discrete", device="cuda",
         **overrides) -> Env:
    """Construct an env family on ``device``; ``terminate_unhealthy`` and
    ``horizon`` in ``overrides`` replace the family's defaults (see
    ``Env.__init__``). Without a card the default device raises; tests pass
    ``device="cpu"``."""
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} is not ported yet (ported: {sorted(ENVS)})"
        )
    return ENVS[name](randomization, device=device, **overrides)
