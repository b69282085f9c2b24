"""The port's analytic envs (CartPole, Pendulum) against the JAX package, as
tests/test_envs_analytic.py checks the reference: shapes, per-episode
parameter draws, the mode bands, the auto-reset at the horizon, per-env
parameters in one batch, the exact CartPole ODE and the pendulum reward;
and ``step_phys``/``observe``/``reward`` of both against the JAX functions
on the same states and parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from cadm_tpu.envs.cartpole import CartPoleParams as JaxCartPoleParams
from cadm_tpu.envs.cartpole import CartPolePhys as JaxCartPolePhys
from cadm_tpu.envs.pendulum import PendulumEnv as JaxPendulum
from cadm_tpu.envs.pendulum import PendulumParams as JaxPendulumParams
from cadm_tpu.envs.pendulum import PendulumPhys as JaxPendulumPhys
from cadm_tpu.envs.ranges import canonical as jax_canonical
from cadm_tpu_torch import envs
from cadm_tpu_torch.envs.cartpole import CartPoleEnv, CartPoleParams, CartPolePhys
from cadm_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams, PendulumPhys
from cadm_tpu_torch.envs.ranges import canonical

# float32 closed-form updates of one control step: a few ulps of O(1) values
ATOL = 1e-6
FAMILIES = {
    "cartpole": (CartPoleEnv, CartPoleParams, CartPolePhys, JaxCartPole,
                 JaxCartPoleParams, JaxCartPolePhys),
    "pendulum": (PendulumEnv, PendulumParams, PendulumPhys, JaxPendulum,
                 JaxPendulumParams, JaxPendulumPhys),
}


@pytest.fixture(params=sorted(FAMILIES))
def env(request):
    return envs.make(request.param, device="cpu")


def leaves(dc):
    return [getattr(dc, f.name) for f in dataclasses.fields(dc)]


def test_reset_step_shapes(env):
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 3)
    assert state.obs.shape == (3, env.obs_dim)
    next_state, obs, reward, done = env.step(
        state, torch.zeros(3, env.act_dim), gen)
    assert obs.shape == (3, env.obs_dim) and reward.shape == (3,)
    assert done.shape == (3,) and not done.any()
    assert next_state.t.tolist() == [1, 1, 1]
    # the base's stability guard: all False, one per env
    assert env.unstable(state.phys).tolist() == [False] * 3


def test_params_resampled_per_episode(env):
    """Hidden parameters change across episodes (the CaDM premise)."""
    gen = torch.Generator().manual_seed(0)
    p0, p1 = env.reset(gen, 8).params, env.reset(gen, 8).params
    assert any(not torch.equal(a, b) for a, b in zip(leaves(p0), leaves(p1)))


def test_mode_bands_exclude_train_range(env):
    """Moderate/extreme draws land outside the training interval, on the
    reference's scale sets (CartPole's multiplied onto its nominal force
    and half-length)."""
    gen = torch.Generator().manual_seed(0)
    train = env.sample_params(gen, 0, 200)
    extreme = env.sample_params(gen, 2, 200)
    for leaf_t, leaf_e in zip(leaves(train), leaves(extreme)):
        lo, hi = leaf_t.min().item(), leaf_t.max().item()
        assert not ((leaf_e >= lo) & (leaf_e <= hi)).any()

    def sets(s):
        return s.train, s.moderate, s.extreme

    for scheme in ("discrete", "continuous"):
        for nominal in (10.0, 0.5, 1.0):
            assert sets(canonical(scheme).scaled(nominal)) == sets(
                jax_canonical(scheme).scaled(nominal))
    scaled = canonical("discrete").scaled(10.0)
    for mode, want in enumerate(sets(scaled)):
        vals = set(scaled.sample(gen, mode, 300).tolist())
        assert vals == {float(np.float32(v)) for v in want}
    ext = canonical("continuous").scaled(10.0).sample(gen, 2, 500)
    assert (((ext >= 2.0) & (ext <= 4.0)) | ((ext >= 16.0) & (ext <= 18.0))).all()


def test_autoreset_at_horizon(env):
    """Stepping past the horizon auto-resets each env once, with fresh
    hidden parameters."""
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 4)
    old = leaves(state.params)
    dones = []
    for _ in range(env.horizon + 5):
        state, _, _, done = env.step(state, torch.zeros(4, env.act_dim), gen)
        dones.append(done)
    dones = torch.stack(dones)
    assert dones[env.horizon - 1].all() and dones.sum().item() == 4
    assert state.t.tolist() == [5] * 4
    assert any(not torch.equal(a, b) for a, b in zip(old, leaves(state.params)))


def test_heterogeneous_params_per_env(env):
    """One batch of envs, each with its own hidden parameters: the same
    action gives different next observations."""
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 32)
    state = dataclasses.replace(state, phys=type(state.phys)(
        *(torch.zeros_like(x) + 0.3 for x in leaves(state.phys))))
    _, obs, rewards, _ = env.step(state, torch.ones(32, env.act_dim), gen)
    assert obs.shape == (32, env.obs_dim) and rewards.shape == (32,)
    assert torch.unique(obs, dim=0).shape[0] > 1


def test_cartpole_ode_exact():
    """The cart-pole ODE against a hand-computed semi-implicit Euler step."""
    env = CartPoleEnv(device="cpu")
    state = env.reset(torch.Generator().manual_seed(0), 1)
    p, ph = state.params, state.phys
    nxt = env.step_phys(p, ph, torch.tensor([[0.3]]))
    F = p.force_mag.item() * 0.3
    mc, mp, g, l = env.mass_cart, env.mass_pole, env.gravity, p.length.item()
    th, thd = ph.theta.item(), ph.theta_dot.item()
    temp = (F + mp * l * thd**2 * np.sin(th)) / (mc + mp)
    thacc = (g * np.sin(th) - np.cos(th) * temp) / (
        l * (4 / 3 - mp * np.cos(th) ** 2 / (mc + mp)))
    xacc = temp - mp * l * thacc * np.cos(th) / (mc + mp)
    xd = ph.x_dot.item() + env.dt * xacc
    thd_new = thd + env.dt * thacc
    np.testing.assert_allclose(nxt.x_dot.item(), xd, rtol=1e-5)
    np.testing.assert_allclose(nxt.x.item(), ph.x.item() + env.dt * xd,
                               rtol=1e-5)
    np.testing.assert_allclose(nxt.theta_dot.item(), thd_new, rtol=1e-5)
    np.testing.assert_allclose(nxt.theta.item(), th + env.dt * thd_new,
                               rtol=1e-5)


def test_pendulum_reward_matches_gym_form():
    env = PendulumEnv(device="cpu")
    theta, theta_dot, a = 0.7, -1.2, 0.5
    obs = torch.tensor([[np.cos(theta), np.sin(theta), theta_dot]])
    r = env.reward(torch.zeros(1, 3), torch.tensor([[a]]), obs).item()
    expected = -(theta**2 + 0.1 * theta_dot**2 + 0.001 * (2.0 * a) ** 2)
    np.testing.assert_allclose(r, expected, rtol=1e-5)


def random_inputs(name, n, seed):
    """Parameters, states and actions of ``n`` envs as float32 numpy:
    parameters off the scale sets, states well outside the reset band (the
    pendulum's θ̇ past its clip)."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    if name == "cartpole":
        params = (f(2.0, 18.0), f(0.1, 0.9))
        phys = (f(-2, 2), f(-3, 3), f(-np.pi, np.pi), f(-6, 6))
    else:
        params = (f(0.2, 1.8), f(0.2, 1.8))
        phys = (f(-np.pi, np.pi), f(-9, 9))
    return params, phys, rng.uniform(-1, 1, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_step_phys_observe_reward_match_jax(name):
    env_cls, par_cls, phys_cls, jenv_cls, jpar_cls, jphys_cls = FAMILIES[name]
    env, jenv = env_cls(device="cpu"), jenv_cls()
    params, phys, act = random_inputs(name, 64, seed=1)
    jpar = jpar_cls(*map(jnp.asarray, params))
    jphys = jphys_cls(*map(jnp.asarray, phys))
    par = par_cls(*map(torch.from_numpy, params))
    ph = phys_cls(*map(torch.from_numpy, phys))

    jnext = jax.jit(jax.vmap(jenv.step_phys))(jpar, jphys, jnp.asarray(act))
    nxt = env.step_phys(par, ph, torch.from_numpy(act))
    for a, b in zip(leaves(nxt), leaves(jnext)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)
    jobs0, jobs1 = (jax.vmap(jenv.observe)(jpar, p) for p in (jphys, jnext))
    obs0, obs1 = env.observe(par, ph), env.observe(par, nxt)
    np.testing.assert_allclose(obs1.numpy(), np.asarray(jobs1), atol=ATOL)
    r = env.reward(obs0, torch.from_numpy(act), obs1)
    jr = jenv.reward(jobs0, jnp.asarray(act), jobs1)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL, rtol=ATOL)
