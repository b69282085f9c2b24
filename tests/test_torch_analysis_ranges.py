"""The port's range-potency probe (``cadm_tpu_torch/analysis/
probe_ranges.py``) against scripts/probe_ranges.py: ``make_rollout`` under
the random policy on a cartpole whose obs index 1 (ẋ) stands for the
forward velocity and whose episodes last 40 steps (the same subclass on
both sides), at pinned scales 0.2 and 1.8, with the script's reset states
and actions rebuilt from its per-scale key: returns and velocity returns
within 1e-4 relative. Also that the pin replaces every params leaf
(CrippleAnt's actuator mask included, as the script's ``full_like``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import env_states_to_torch, jax_reset
import scripts.probe_ranges as jax_probe
from cadm_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from cadm_tpu_torch.analysis import probe_ranges
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.cartpole import CartPoleEnv

N, HORIZON = 6, 40
RTOL = 1e-4


class VxJaxCartPole(JaxCartPole):
    horizon = HORIZON
    _vx_index = 1


class VxCartPole(CartPoleEnv):
    horizon = HORIZON
    _vx_index = 1


@pytest.mark.parametrize("scale", [0.2, 1.8])
def test_random_policy_rollout_matches_the_script(scale):
    env_j = VxJaxCartPole()
    run_j = jax.jit(jax_probe.make_rollout(env_j, N,
                                           jax_probe.random_policy(env_j)))
    key = jax.random.key(probe_ranges.scale_seed(scale))
    ref_ret, ref_vel = map(np.asarray, run_j(jnp.asarray(scale), key))

    r_reset, r_run = jax.random.split(key)
    env = VxCartPole(device="cpu")
    start = env_states_to_torch(env, jax_reset(env_j, jax.random.split(
        r_reset, N)))
    actions = torch.from_numpy(np.array(jnp.stack([
        jax.random.uniform(k, (N, env.act_dim), minval=-1.0, maxval=1.0)
        for k in jax.random.split(r_run, HORIZON)])))
    run = probe_ranges.make_rollout(
        env, N, probe_ranges.random_policy(env, actions))
    ret, vel = run(scale, torch.Generator().manual_seed(0), start)
    assert np.abs(ref_vel).min() > 0
    np.testing.assert_allclose(ret.numpy(), ref_ret, rtol=RTOL)
    np.testing.assert_allclose(vel.numpy(), ref_vel, rtol=RTOL)


def test_the_pin_replaces_every_params_leaf():
    """CrippleAnt's act_mask becomes all ``scale``, as under the script's
    ``tree_map(full_like)``; one control step at 2 envs."""
    env = make("cripple_ant", device="cpu")
    seen = []

    def act(states, aux, gen, t):
        seen.append(states.params.act_mask.clone())
        return torch.zeros(2, env.act_dim), aux

    policy = {"init": lambda n: None, "act": act,
              "post": lambda aux, prev, obs, a: aux}
    ret, vel = probe_ranges.make_rollout(env, 2, policy, horizon=1)(
        0.5, torch.Generator().manual_seed(0))
    assert torch.equal(seen[0], torch.full((2, env.act_dim), 0.5))
    assert torch.isfinite(ret).all() and torch.isfinite(vel).all()
