"""The port's MPC planner against the JAX planner on the same numbers.

Both planners score with HalfCheetah's reward and blowup guard and plan
through the same (JAX-initialized) CaDM weights. ``jax.random`` streams
cannot be reproduced in torch, so the test rebuilds the JAX planner's key
splits (cadm_tpu/planners/mpc.py ``plan`` → ``_plan_single``) to get its
exact truncated-normal ε / uniform actions and hands them to the port
through ``noise``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import DynamicsState as JaxState
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig, DynamicsState
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.utils.convert import params_from_jax

# Tolerances: returns are sums of 5 float32 rewards through 3-layer MLP
# rollouts (and a 1e4 blowup penalty), compared at rtol 1e-5 / atol 1e-4;
# actions and CEM means are averages of the same ε-derived actions, 1e-5.
RET_RTOL, RET_ATOL, ACT_ATOL = 1e-5, 1e-4, 1e-5
E, C, H, ITERS, ELITES = 3, 16, 5, 2, 4
PLAN = dict(horizon=H, n_candidates=C, cem_iters=ITERS, cem_elites=ELITES)
MODEL = dict(obs_dim=17, act_dim=6, hidden=(32, 32), context="encoder")


def build(kind, warm_start=False):
    jenv, env = JaxCheetah(), HalfCheetahEnv()
    jm = JaxDynamics(JaxConfig(**MODEL))
    jparams = jm.init_params(jax.random.key(7))
    jnorm = JaxNorm.identity(17, 6)
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm))
    jplanner = JaxPlanner(JaxPlannerConfig(kind=kind, warm_start=warm_start,
                                           **PLAN), jm, jenv.reward,
                          6, bad_transition_fn=jenv.bad_transition,
                          obs_limit=jenv.bad_obs_limit)
    planner = MPCPlanner(PlannerConfig(kind=kind, warm_start=warm_start,
                                       **PLAN),
                         Dynamics(DynamicsConfig(**MODEL)), env.reward, 6,
                         bad_transition_fn=env.bad_transition,
                         obs_limit=env.bad_obs_limit)
    jstate = JaxState(params=jparams, opt_state=None, norm=jnorm, updates=0)
    return jplanner, jstate, planner, DynamicsState(params, norm)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.randn(E, 17).astype(np.float32)
    obs[2, 3] = 160.0  # beyond bad_obs_limit: env 2's rollouts blow up at once
    z = rng.randn(E, 10).astype(np.float32)
    return obs, z


def jax_noise(kind, key):
    """The ε (CEM) or actions (RS) the JAX planner draws for each env."""
    out = []
    for k_env in jax.random.split(key, E):
        if kind == "rs":
            r_a, _ = jax.random.split(k_env)
            out.append(jax.random.uniform(r_a, (C, H, 6), minval=-1.0,
                                          maxval=1.0))
            continue
        eps = [jax.random.truncated_normal(jax.random.split(k)[0], -2.0, 2.0,
                                           (C, H, 6))
               for k in jax.random.split(k_env, ITERS)]
        out.append(jnp.stack(eps))
    noise = np.asarray(jnp.stack(out))
    return np.array(noise if kind == "rs" else np.swapaxes(noise, 0, 1))


def test_evaluate_matches_jax_including_blowup_penalty():
    jplanner, jstate, planner, state = build("cem")
    obs, z = inputs()
    actions = np.random.RandomState(1).uniform(-1, 1, (E, C, H, 6)).astype(np.float32)
    ref = jax.vmap(lambda o, zz, a: jplanner._evaluate(
        jstate.params, jstate.norm, o, zz, a, jax.random.key(0)))(
        *map(jnp.asarray, (obs, z, actions)))
    out = planner._evaluate(state.params, state.norm,
                            *map(torch.from_numpy, (obs, z, actions)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RET_RTOL,
                               atol=RET_ATOL)
    assert np.all(out.numpy()[2] < -9e3)  # penalized once, then masked


def test_refit_matches_jax_elites_with_nan_returns():
    _, _, planner, _ = build("cem")
    rng = np.random.RandomState(2)
    actions = rng.uniform(-1, 1, (E, C, H, 6)).astype(np.float32)
    returns = rng.randn(E, C).astype(np.float32)
    returns[0, :3] = np.nan  # NaN ranks last, as in the reference
    returns[1] = -1e4        # a blown-up env: every candidate ties
    ref_mu, ref_sigma = [], []
    for e in range(E):
        r = jnp.where(jnp.isnan(returns[e]), -jnp.inf, returns[e])
        _, idx = jax.lax.top_k(r, ELITES)
        elites = jnp.asarray(actions[e])[idx]
        ref_mu.append(elites.mean(axis=0))
        ref_sigma.append(elites.std(axis=0))
    mu, sigma = planner._refit(torch.from_numpy(actions),
                               torch.from_numpy(returns))
    np.testing.assert_allclose(mu.numpy(), np.stack(ref_mu), atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.stack(ref_sigma), atol=1e-6)


@pytest.mark.parametrize("kind,warm_start",
                         [("cem", False), ("cem", True), ("rs", False)])
def test_plan_matches_jax_with_the_same_noise(kind, warm_start):
    jplanner, jstate, planner, state = build(kind, warm_start)
    obs, z = inputs()
    prev_mu = np.random.RandomState(5).uniform(-1, 1, (E, H, 6)).astype(np.float32)
    key = jax.random.key(11)
    ref_a, ref_mu = jax.vmap(lambda o, zz, m, k: jplanner._plan_single(
        jstate.params, jstate.norm, o, zz, m, k))(
        jnp.asarray(obs), jnp.asarray(z), jnp.asarray(prev_mu),
        jax.random.split(key, E))
    a, mu = planner.plan(state, torch.from_numpy(obs), torch.from_numpy(z),
                         gen=None, prev_mu=torch.from_numpy(prev_mu),
                         noise=torch.from_numpy(jax_noise(kind, key)))
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=ACT_ATOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=ACT_ATOL)
    assert a.shape == (E, 6) and mu.shape == (E, H, 6)


def test_plan_samples_from_the_generator():
    """Without injected noise the planner draws from the generator: the same
    seed gives the same plan, another seed another one."""
    _, _, planner, state = build("cem")
    obs, z = map(torch.from_numpy, inputs())
    plans = [planner.plan(state, obs, z, torch.Generator().manual_seed(s))[0]
             for s in (0, 0, 1)]
    assert torch.equal(plans[0], plans[1]) and not torch.equal(plans[0], plans[2])
    assert plans[0].abs().max() <= 1.0
