"""The port's ``NormalizedEnv``, ``Sampler`` and ``ModelSampleProcessor``
against the JAX package, as tests/test_wrappers_sampler.py checks the
reference: the action rescale, per-env observation whitening (against
``jax.vmap`` of the reference's per-env state, across a reset), what the
wrapper passes on and what it does not (``bad_transition`` yes,
``unstable`` no), the Sampler's paths with the same actions, the processor
on the same paths, and ``normalize_env`` wired into ``build``.

Envs whose reset is deterministic (fixed hidden parameters and start state)
let episodes that end inside a run restart identically on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.core.types import EnvState as JaxEnvState
from cadm_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from cadm_tpu.envs.cartpole import CartPoleParams as JaxCartPoleParams
from cadm_tpu.envs.cartpole import CartPolePhys as JaxCartPolePhys
from cadm_tpu.envs.hopper import HopperEnv as JaxHopper
from cadm_tpu.envs.pendulum import PendulumEnv as JaxPendulum
from cadm_tpu.envs.pendulum import PendulumParams as JaxPendulumParams
from cadm_tpu.envs.pendulum import PendulumPhys as JaxPendulumPhys
from cadm_tpu.envs.rigid_base import RigidPhys as JaxRigidPhys
from cadm_tpu.envs.wrappers import NormalizedEnv as JaxNormalizedEnv
from cadm_tpu.envs.wrappers import NormalizedPhys as JaxNormalizedPhys
from cadm_tpu.envs.wrappers import ObsStats as JaxObsStats
from cadm_tpu.train.sampler import ModelSampleProcessor as JaxProcessor
from cadm_tpu.train.sampler import Sampler as JaxSampler
from cadm_tpu_torch.cli.presets import ExperimentConfig
from cadm_tpu_torch.core.types import EnvState
from cadm_tpu_torch.envs.cartpole import CartPoleEnv, CartPoleParams, CartPolePhys
from cadm_tpu_torch.envs.hopper import HopperEnv
from cadm_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams, PendulumPhys
from cadm_tpu_torch.envs.rigid_base import RigidPhys
from cadm_tpu_torch.envs.wrappers import NormalizedEnv, NormalizedPhys, ObsStats
from cadm_tpu_torch.train.sampler import ModelSampleProcessor, Sampler

# float32 closed-form steps and Welford updates over a handful of steps
ATOL = 1e-5
E = 4


class DetJaxCartPole(JaxCartPole):
    horizon = 4

    def sample_params(self, rng, mode):
        return JaxCartPoleParams(jnp.float32(11.5), jnp.float32(0.425))

    def init_phys(self, rng, params):
        return JaxCartPolePhys(*(jnp.float32(v) for v in (0.01, -0.02, 0.03,
                                                          0.04)))


class DetCartPole(CartPoleEnv):
    horizon = 4

    def sample_params(self, gen, mode, n):
        return CartPoleParams(torch.full((n,), 11.5), torch.full((n,), 0.425))

    def init_phys(self, gen, params):
        n = params.length.shape[0]
        return CartPolePhys(*(torch.full((n,), v) for v in (0.01, -0.02, 0.03,
                                                            0.04)))


class WideJaxPendulum(JaxPendulum):
    horizon = 5

    def action_limits(self):
        return jnp.array([-2.0]), jnp.array([3.0])

    def sample_params(self, rng, mode):
        return JaxPendulumParams(jnp.float32(1.15), jnp.float32(0.85))

    def init_phys(self, rng, params):
        return JaxPendulumPhys(jnp.float32(0.5), jnp.float32(-0.3))


class WidePendulum(PendulumEnv):
    horizon = 5

    def action_limits(self):
        return torch.tensor([-2.0]), torch.tensor([3.0])

    def sample_params(self, gen, mode, n):
        return PendulumParams(torch.full((n,), 1.15), torch.full((n,), 0.85))

    def init_phys(self, gen, params):
        n = params.mass.shape[0]
        return PendulumPhys(torch.full((n,), 0.5), torch.full((n,), -0.3))


def f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_action_rescale_onto_the_wrapped_limits():
    """[-1, 1] maps onto the inner env's [lo, hi] as lo + ½(a+1)(hi−lo):
    the wrapped step equals the inner step at the native action, and both
    packages agree."""
    env, jenv = NormalizedEnv(WidePendulum(device="cpu")), JaxNormalizedEnv(
        WideJaxPendulum())
    lo, hi = env.action_limits()
    assert lo.tolist() == [-1.0] and hi.tolist() == [1.0]
    rng = np.random.RandomState(0)
    par = PendulumParams(*(torch.from_numpy(f32(rng, E, lo=0.5, hi=1.5))
                           for _ in range(2)))
    inner = PendulumPhys(*(torch.from_numpy(f32(rng, E)) for _ in range(2)))
    act = f32(rng, E, 1)
    phys = NormalizedPhys(inner, ObsStats.init(E, 3))
    out = env.step_phys(par, phys, torch.from_numpy(act))
    native = -2.0 + 0.5 * (act + 1.0) * 5.0
    ref = env.env.step_phys(par, inner, torch.from_numpy(native))
    for a, b in ((out.inner.theta, ref.theta),
                 (out.inner.theta_dot, ref.theta_dot)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jout = jax.vmap(jenv.step_phys)(
        JaxPendulumParams(*(jnp.asarray(x.numpy()) for x in (par.mass,
                                                             par.length))),
        JaxNormalizedPhys(JaxPendulumPhys(jnp.asarray(inner.theta.numpy()),
                                          jnp.asarray(inner.theta_dot.numpy())),
                          jax.vmap(lambda _: JaxObsStats.init(3))(jnp.arange(E))),
        jnp.asarray(act))
    np.testing.assert_allclose(out.inner.theta.numpy(),
                               np.asarray(jout.inner.theta), atol=ATOL)
    np.testing.assert_allclose(out.inner.theta_dot.numpy(),
                               np.asarray(jout.inner.theta_dot), atol=ATOL)


def test_per_env_whitening_matches_vmap_of_the_reference():
    """Running obs statistics are per env and per episode: 6 steps of 4
    envs whose episodes (4 steps long) end at different steps, the reset
    starting their statistics again. Whitened obs, stats and dones agree
    with ``jax.vmap`` of the reference."""
    env = NormalizedEnv(DetCartPole(device="cpu"), normalize_obs=True)
    jenv = JaxNormalizedEnv(DetJaxCartPole(), normalize_obs=True)
    rng = np.random.RandomState(1)
    phys_np = [f32(rng, E, lo=-0.2, hi=0.2) for _ in range(4)]
    t0 = np.array([0, 1, 2, 3], np.int32)
    jpar = JaxCartPoleParams(jnp.asarray(f32(rng, E, lo=7.5, hi=12.5)),
                             jnp.asarray(f32(rng, E, lo=0.4, hi=0.6)))
    jphys = JaxNormalizedPhys(
        JaxCartPolePhys(*map(jnp.asarray, phys_np)),
        jax.vmap(lambda _: JaxObsStats.init(5))(jnp.arange(E)))
    jstates = JaxEnvState(
        phys=jphys, obs=jax.vmap(jenv.observe)(jpar, jphys), params=jpar,
        t=jnp.asarray(t0), rng=jax.random.split(jax.random.key(0), E),
        done=jnp.zeros(E, bool))
    par = CartPoleParams(*(torch.from_numpy(np.array(x))
                           for x in (jpar.force_mag, jpar.length)))
    phys = NormalizedPhys(CartPolePhys(*map(torch.from_numpy, phys_np)),
                          ObsStats.init(E, 5))
    states = EnvState(phys=phys, obs=env.observe(par, phys), params=par,
                      t=torch.from_numpy(t0), done=torch.zeros(E, dtype=torch.bool))
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = torch.Generator().manual_seed(0)
    resets = 0
    for t in range(6):
        act = f32(rng, E, 1)
        jstates, jobs, jr, jdone = jstep(jstates, jnp.asarray(act))
        states, obs, r, done = env.step(states, torch.from_numpy(act), gen)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        resets += int(done.sum())
        for a, b in ((obs, jobs), (r, jr), (states.obs, jstates.obs),
                     (states.phys.stats.mean, jstates.phys.stats.mean),
                     (states.phys.stats.var, jstates.phys.stats.var),
                     (states.phys.stats.count, jstates.phys.stats.count)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=ATOL, err_msg=f"step {t}")
    assert resets == 6  # envs at t0 = 2, 3 end twice, the others once
    # the statistics are per env: envs reset at different steps have
    # different counts
    assert len(set(states.phys.stats.count.tolist())) > 1


def test_normalized_env_delegates_bad_transition_not_unstable():
    """The wrapper passes on the inner env's blowup limits, but, as the
    reference's, has no ``unstable``: the base's all-False applies, so a
    wrapped hopper loses its blow-up guard; ``bad_obs_limit`` is inf."""
    inner = HopperEnv(device="cpu")
    env = NormalizedEnv(inner)
    obs = torch.zeros(2, inner.obs_dim)
    blown = obs.clone()
    blown[1, 0] = 1e6
    assert env.bad_transition(obs, blown).tolist() == [False, True]
    assert torch.equal(env.bad_transition(obs, blown),
                       inner.bad_transition(obs, blown))
    state = env.reset(torch.Generator().manual_seed(0), 2)
    qvel = state.phys.inner.qvel.clone()
    qvel[0, 0] = float("nan")
    blown_phys = NormalizedPhys(RigidPhys(state.phys.inner.qpos, qvel),
                                state.phys.stats)
    assert inner.unstable(blown_phys.inner).tolist() == [True, False]
    assert env.unstable(blown_phys).tolist() == [False, False]
    assert env.bad_obs_limit == float("inf") and env.symmetry_maps() is None
    # the reference's wrapper: the same
    jinner = JaxHopper()
    jenv = JaxNormalizedEnv(jinner)
    jphys = JaxRigidPhys(jnp.asarray(state.phys.inner.qpos[0].numpy()),
                         jnp.asarray(qvel[0].numpy()))
    assert bool(jinner.unstable(jphys))
    assert not bool(jenv.unstable(JaxNormalizedPhys(jphys,
                                                    JaxObsStats.init(11))))
    assert jenv.bad_obs_limit == float("inf") and jenv.symmetry_maps() is None


def jax_uniform_actions(rng, n_steps, n, act_dim):
    """The reference Sampler's random actions for key ``rng``."""
    _, r_run = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(
        k, (n, act_dim), minval=-1.0, maxval=1.0))
        for k in jax.random.split(r_run, n_steps)])


def jax_policy(obs, hists, k):
    return jnp.tanh(0.7 * obs[:, :1] + 0.3 * hists.dobs.sum((1, 2))[:, None]
                    - 0.1 * hists.valid.sum(1)[:, None])


def port_policy(obs, hists, gen):
    return torch.tanh(0.7 * obs[:, :1] + 0.3 * hists.dobs.sum((1, 2))[:, None]
                      - 0.1 * hists.valid.sum(1)[:, None])


@pytest.mark.parametrize("policy", ["random", "history"])
def test_sampler_paths_match_the_reference(policy):
    """Time-major paths of 12 steps over 3 envs with 5-step episodes: with
    the reference's uniform draws injected, and with a policy that reads
    the histories (wiped at each done)."""
    jenv, env = WideJaxPendulum(), WidePendulum(device="cpu")
    rng, n_steps = jax.random.key(3), 12
    jsampler = JaxSampler(jenv, n_envs=3, history_k=3)
    sampler = Sampler(env, n_envs=3, history_k=3)
    gen = torch.Generator().manual_seed(0)
    if policy == "random":
        jpaths = jsampler.obtain_samples(rng, n_steps, random=True)
        paths = sampler.obtain_samples(gen, n_steps, actions=torch.from_numpy(
            jax_uniform_actions(rng, n_steps, 3, 1)))
    else:
        jpaths = jsampler.obtain_samples(rng, n_steps, policy=jax_policy)
        paths = sampler.obtain_samples(gen, n_steps, policy=port_policy)
    assert sorted(paths) == sorted(jpaths)
    for k, v in paths.items():
        assert v.shape == jpaths[k].shape and v.dtype == jpaths[k].dtype, k
        np.testing.assert_allclose(v, jpaths[k], atol=ATOL, err_msg=k)
    assert paths["dones"].sum() == 6 and paths["observations"].shape == (
        12, 3, 3)


def test_sampler_contract_and_processor_match_the_reference():
    """The reference test's contract on the port (250 random steps of 4
    cartpoles) and ``ModelSampleProcessor`` equal to the reference's on the
    same numpy paths."""
    env = CartPoleEnv(device="cpu")
    paths = Sampler(env, n_envs=4, history_k=3).obtain_samples(
        torch.Generator().manual_seed(0), n_steps=250, random=True)
    assert paths["observations"].shape == (250, 4, env.obs_dim)
    assert paths["dones"].sum() >= 4
    flat = ModelSampleProcessor().process_samples(paths)
    ref = JaxProcessor().process_samples(paths)
    assert flat["observations"].shape == (1000, env.obs_dim)
    assert len(flat["episode_returns"]) == int(paths["dones"].sum())
    assert sorted(flat) == sorted(ref)
    for k in flat:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    assert np.isfinite(flat["average_return"])


def test_normalize_env_wired_into_build():
    cfg = ExperimentConfig(
        env="pendulum", model="vanilla", planner="rs", normalize_env=True,
        n_envs=4, n_candidates=16, plan_horizon=4, steps_per_itr=32,
        n_itr=1, model_updates_per_itr=5, batch_size=32, buffer_capacity=64,
        eval_envs=2, eval_modes=(0,), hidden=(16,), history_k=3, future_m=2,
        env_horizon=8)
    env, model, planner, trainer = cfg.build("cpu")
    assert isinstance(env, NormalizedEnv) and env.horizon == 8
    assert isinstance(env.env, PendulumEnv)
    _, hist = trainer.train(torch.Generator().manual_seed(0))
    assert np.isfinite(hist[0]["fit/model_loss_last"])
    assert hist[0]["collect/episodes"] == 16
    assert not dataclasses.replace(cfg, normalize_env=False).build(
        "cpu")[0].__class__ is NormalizedEnv
