"""The port's hopper, ant, cripple_ant and slim_humanoid envs against the
JAX package's, on the same numpy-drawn states (tests/torch_families_common.py).

Covered here: observation layout, reward and ``terminated`` on the same
states (healthy and unhealthy ones), three control steps of ``step_phys`` at
train scales and one and three at moderate and extreme ones
(slim_humanoid's in test_torch_env_humanoid.py, its JAX reference alone
costs ~20 s of compile), the ``terminate_unhealthy``/``horizon`` overrides,
CrippleAnt's per-mode masks and its zero actuation on the crippled leg, the
resets' draws, and the leg symmetry maps bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs import make as jax_make
from cadm_tpu.envs.ant import leg_symmetry_maps as jax_leg_symmetry_maps
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.ant import LEG_ACTUATORS, leg_symmetry_maps
from cadm_tpu_torch.envs.rigid_base import RigidPhys
from cadm_tpu_torch.physics.rigid import dynamics as tdyn
from tests.torch_families_common import (
    FAMILIES,
    REW_ATOL,
    family_batch,
    jax_params,
    jax_phys,
    port_params,
    step_matches_jax,
)

OBS_DIMS = {"hopper": 11, "ant": 27, "cripple_ant": 27, "slim_humanoid": 45}


def unhealthy_batch(name):
    """``family_batch`` with some envs made unhealthy for the family's
    termination: hopper env 1 fallen (z < 0.7), env 2 pitched, env 3 with a
    joint angle past 100; slim_humanoid env 1 below z 1, env 2 above 2."""
    qpos, qvel, ctrl, params = family_batch(name)
    if name == "hopper":
        qpos[1, 1], qpos[2, 2], qpos[3, 4] = 0.5, 0.3, 150.0
    if name == "slim_humanoid":
        qpos[1, 2], qpos[2, 2] = 0.8, 2.5
    return qpos, qvel, ctrl, params


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("terminate", [True, False])
def test_observation_reward_and_termination_match_jax(name, terminate):
    qpos, qvel, ctrl, params = unhealthy_batch(name)
    jenv = jax_make(name, terminate_unhealthy=terminate)
    env = make(name, device="cpu", terminate_unhealthy=terminate)
    jp, jph = jax_params(name, params), jax_phys(qpos, qvel)
    tp, tph = port_params(name, params), RigidPhys(torch.from_numpy(qpos),
                                                   torch.from_numpy(qvel))
    jobs = np.asarray(jax.vmap(jenv.observe)(jp, jph))
    obs = env.observe(tp, tph)
    assert obs.shape == (qpos.shape[0], OBS_DIMS[name]) == (
        qpos.shape[0], env.obs_dim)
    np.testing.assert_array_equal(obs.numpy(), jobs)
    # reward of a transition from the first half's obs to the second's
    nxt = np.roll(jobs, 1, axis=0)
    rew = env.reward(obs, torch.from_numpy(ctrl), torch.from_numpy(nxt))
    jrew = jenv.reward(jnp.asarray(jobs), jnp.asarray(ctrl), jnp.asarray(nxt))
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=REW_ATOL)
    done = env.terminated(tp, tph, obs)
    jdone = jax.vmap(jenv.terminated, in_axes=(0, 0, 0))(
        jp, jph, jnp.asarray(jobs))
    np.testing.assert_array_equal(
        done.numpy(), np.broadcast_to(np.asarray(jdone), done.shape))
    if name in ("hopper", "slim_humanoid"):
        assert done[1:3].all() == terminate and not done[0]
    else:
        assert not done.any()


@pytest.mark.parametrize("name", ["hopper", "ant", "cripple_ant"])
def test_step_phys_matches_jax(name):
    active = step_matches_jax(name)
    assert active.max() >= 2  # the contact solve does real work


@pytest.mark.parametrize("control_steps", [1, 3])
@pytest.mark.parametrize("name", ["hopper", "ant"])
def test_step_phys_matches_jax_at_eval_scales(name, control_steps):
    """Mass and damping scales from the moderate and extreme sets, the
    extreme corners included (M⁻¹ grows ×5 at mass 0.2)."""
    active = step_matches_jax(name, control_steps, eval_range=True)
    assert active.max() >= 2 and active[-4:].sum() > 0  # corners in contact


@pytest.mark.parametrize("name", ["hopper", "slim_humanoid"])
def test_overrides_drop_termination_and_set_the_horizon(name):
    """``terminate_unhealthy=False`` pays the alive bonus unconditionally
    and ends episodes only at ``horizon`` (or on a physics blowup)."""
    env = make(name, device="cpu", terminate_unhealthy=False, horizon=2)
    assert env.horizon == 2 and not env.terminate_unhealthy
    assert make(name, device="cpu").terminate_unhealthy
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 4)
    state.phys.qpos[:, 1 if name == "hopper" else 2] = 0.3  # fallen
    state.obs = env.observe(state.params, state.phys)
    zeros = torch.zeros(4, env.act_dim)
    state, _, _, done = env.step(state, zeros, gen)
    assert not done.any()
    # the bonus is unconditional, in both packages
    zero_obs = torch.zeros(1, env.obs_dim)
    jenv = jax_make(name, terminate_unhealthy=False)
    assert env.reward(zero_obs, torch.zeros(1, env.act_dim), zero_obs) == \
        env.alive_bonus == float(jenv.reward(
            jnp.zeros((1, env.obs_dim)), jnp.zeros((1, env.act_dim)),
            jnp.zeros((1, env.obs_dim)))[0])
    _, _, _, done = env.step(state, zeros, gen)
    assert done.all()


def test_cripple_masks_per_mode():
    env = make("cripple_ant", device="cpu")
    gen = torch.Generator().manual_seed(0)
    legs_of = {tuple(np.sort(a)): leg for leg, a in enumerate(LEG_ACTUATORS)}
    for mode in (0, 1, 2):
        mask = env.reset(gen, 4096, mode).params.act_mask
        assert mask.shape == (4096, 8)
        assert set(torch.unique(mask).tolist()) == {0.0, 1.0}
        assert (mask.sum(1) == 6).all()
        legs = {legs_of[tuple(np.flatnonzero(row == 0).tolist())]
                for row in mask.numpy()}
        assert legs == ({0, 1, 2} if mode == 0 else {3}), (mode, legs)


def test_crippled_leg_gives_exactly_zero_generalized_force():
    env = make("cripple_ant", device="cpu")
    sys_ = env.sys
    ctrl = torch.rand(4, sys_.nu, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(4, sys_.nu)
    for e in range(4):
        mask[e, torch.as_tensor(LEG_ACTUATORS[e])] = 0.0
    tau = tdyn.actuation(sys_, 2 * ctrl - 1, mask)
    act_dofs = [int(sys_.jnt_dofadr[int(sys_.act_joint[a])])
                for a in range(sys_.nu)]
    for e in range(4):
        for a in LEG_ACTUATORS[e]:
            assert tau[e, act_dofs[a]] == 0.0
    assert (tau != 0).sum(1).tolist() == [6, 6, 6, 6]


@pytest.mark.parametrize("name", FAMILIES)
def test_reset_draws_their_init_bands(name):
    env = make(name, device="cpu")
    state = env.reset(torch.Generator().manual_seed(0), 2048)
    qpos, qvel = state.phys.qpos, state.phys.qvel
    assert state.obs.shape == (2048, env.obs_dim) and torch.isfinite(
        state.obs).all()
    if name != "hopper":   # a free root: unit quaternion
        torch.testing.assert_close(torch.linalg.vector_norm(qpos[:, 3:7], dim=1),
                                   torch.ones(2048))
    band = {"hopper": 5e-3, "slim_humanoid": 0.01}.get(name)
    if band is not None:
        assert qvel.abs().max() <= band
        base = torch.as_tensor(env.sys.default_qpos(), dtype=torch.float32)
        off = (qpos - base)[:, 7:] if name == "slim_humanoid" else qpos - base
        assert off.abs().max() <= band + 1e-6
    else:
        assert (qvel.std() - 0.1).abs() < 0.01
    assert env.dt == env.sys.dt * env.frame_skip


def test_leg_symmetry_maps_equal_the_jax_package_bit_for_bit():
    ours, ref = leg_symmetry_maps(), jax_leg_symmetry_maps()
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    maps = make("cripple_ant", device="cpu").symmetry_maps()
    assert maps["obs"].shape == (4, 27, 27) and maps["act"].shape == (4, 8, 8)
    assert make("ant", device="cpu").symmetry_maps() is None
