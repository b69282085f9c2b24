"""Env registry of the port (counterpart of cadm_tpu/envs/__init__.py): the
two analytic families (cartpole, pendulum) and the five rigid-body ones."""
from cadm_tpu_torch.envs.ant import AntEnv, CrippleAntEnv
from cadm_tpu_torch.envs.base import Env
from cadm_tpu_torch.envs.cartpole import CartPoleEnv
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.envs.hopper import HopperEnv
from cadm_tpu_torch.envs.pendulum import PendulumEnv
from cadm_tpu_torch.envs.slim_humanoid import SlimHumanoidEnv

ENVS = {
    "cartpole": CartPoleEnv,
    "pendulum": PendulumEnv,
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
    ``device="cpu"``. An unknown name is a ``KeyError``, as in the
    reference."""
    return ENVS[name](randomization, device=device, **overrides)
