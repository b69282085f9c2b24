"""The port's ensemble planner against the JAX planner on the same numbers.

A 5-member probabilistic CaDM (JAX-initialized weights) plans on
HalfCheetah's reward and blowup guard in each ``ensemble_eval`` mode: 'ts1'
(block-granular TS1, 16 candidates padded to 20 = 5 blocks of 4), 'mean',
'ts1_exact' and 'assign' (the same blocks, block m under member m). ``jax.random`` streams cannot be reproduced in torch, so
the test rebuilds the JAX planner's key splits (``_plan_single`` →
``_evaluate*``, cadm_tpu/planners/mpc.py) and hands the port the same
ε, member draws (TS1 permutations, i.i.d. member indices) and, for
``sample_predictions``, the same standard normals.
"""
import dataclasses

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

# test_torch_planner.py's tolerances: returns are sums of float32 rewards
# through MLP rollouts (and a 1e4 blowup penalty); actions and CEM means are
# averages of the same ε-derived actions
RET_RTOL, RET_ATOL, ACT_ATOL = 1e-5, 1e-4, 1e-5
E, C, H, ITERS, ELITES, N = 3, 16, 5, 2, 4, 5
CM = -(-C // N)
OBS, ACT = 17, 6
PLAN = dict(horizon=H, n_candidates=C, cem_iters=ITERS, cem_elites=ELITES)
MODEL = dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), context="encoder",
             n_members=N, probabilistic=True)
MODES = ("ts1", "mean", "ts1_exact", "assign")


def build(mode, kind="cem", sample=False):
    jenv, env = JaxCheetah(), HalfCheetahEnv(device="cpu")
    jm = JaxDynamics(JaxConfig(**MODEL))
    jparams = jm.init_params(jax.random.key(7))
    jnorm = JaxNorm.identity(OBS, ACT)
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm), "cpu")
    pcfg = dict(PLAN, kind=kind, ensemble_eval=mode, sample_predictions=sample)
    jplanner = JaxPlanner(JaxPlannerConfig(**pcfg), jm, jenv.reward, ACT,
                          bad_transition_fn=jenv.bad_transition,
                          obs_limit=jenv.bad_obs_limit)
    planner = MPCPlanner(PlannerConfig(**pcfg),
                         Dynamics(DynamicsConfig(**MODEL), "cpu"), env.reward,
                         ACT, bad_transition_fn=env.bad_transition,
                         obs_limit=env.bad_obs_limit)
    jstate = JaxState(params=jparams, opt_state=None, norm=jnorm, updates=0)
    return jplanner, jstate, planner, DynamicsState(params, norm)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.randn(E, OBS).astype(np.float32)
    obs[2, 3] = 160.0  # beyond bad_obs_limit: env 2's rollouts blow up at once
    z = rng.randn(E, 10).astype(np.float32)
    return obs, z


def evaluate_draws(mode, key):
    """What one JAX ``_evaluate`` call of one env draws from ``key``, step by
    step: (member draws (H, ·), standard normals (H, n, rows, OBS))."""
    members, noise = [], []
    rows = {"ts1": CM, "mean": C, "ts1_exact": C, "assign": CM}[mode]
    rng = key
    for _ in range(H):
        if mode in ("mean", "assign"):
            rng, k_pred = jax.random.split(rng)
        else:
            rng, k_draw, k_pred = jax.random.split(rng, 3)
            members.append(jax.random.permutation(k_draw, N) if mode == "ts1"
                           else jax.random.randint(k_draw, (C,), 0, N))
        noise.append(jnp.stack([jax.random.normal(k, (rows, OBS))
                                for k in jax.random.split(k_pred, N)]))
    return (np.asarray(jnp.stack(members)) if members else None,
            np.asarray(jnp.stack(noise)))


def stack_envs(mode, draws):
    """Per-env draws → the port's (H, E, ·) members and (H, *prediction
    shape) normals: (n, E·C) rows in 'mean' mode, (n, E, rows) otherwise."""
    members = None
    if draws[0][0] is not None:
        members = torch.from_numpy(np.stack([m for m, _ in draws], axis=0))
    noise = np.stack([nz for _, nz in draws], axis=2)   # (H, n, E, rows, d)
    if mode == "mean":
        noise = noise.reshape(H, N, E * C, OBS)
    return members, torch.from_numpy(noise)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sample", [False, True])
def test_evaluate_matches_jax(mode, sample):
    jplanner, jstate, planner, state = build(mode, sample=sample)
    obs, z = inputs()
    actions = np.random.RandomState(1).uniform(
        -1, 1, (E, C, H, ACT)).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), E)
    ref = jax.vmap(lambda o, zz, a, k: jplanner._evaluate(
        jstate.params, jstate.norm, o, zz, a, k))(
        *map(jnp.asarray, (obs, z, actions)), keys)
    members, noise = stack_envs(mode, [evaluate_draws(mode, k) for k in keys])
    out = planner._evaluate(state.params, state.norm,
                            *map(torch.from_numpy, (obs, z, actions)),
                            members=members, pred_noise=noise)
    assert out.shape == (E, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RET_RTOL,
                               atol=RET_ATOL)
    assert np.all(out.numpy()[2] < -9e3)  # penalized once, then masked


def plan_draws(kind, mode, key):
    """The ε (CEM, (iters, E, C, H, act)) or actions (RS, (E, C, H, act)) and
    the member draws the JAX planner takes for each env from ``key``."""
    eps, members = [], []
    for k_env in jax.random.split(key, E):
        if kind == "rs":
            r_a, r_e = jax.random.split(k_env)
            eps.append(jax.random.uniform(r_a, (C, H, ACT), minval=-1.0,
                                          maxval=1.0))
            members.append(evaluate_draws(mode, r_e)[0])
            continue
        e_i, m_i = [], []
        for k in jax.random.split(k_env, ITERS):
            r_s, r_e = jax.random.split(k)
            e_i.append(jax.random.truncated_normal(r_s, -2.0, 2.0, (C, H, ACT)))
            m_i.append(evaluate_draws(mode, r_e)[0])
        eps.append(jnp.stack(e_i))
        members.append(None if mode == "assign" else np.stack(m_i))
    eps = np.asarray(jnp.stack(eps))
    if kind == "cem":   # iteration axis first
        eps = np.swapaxes(eps, 0, 1)
    if mode == "assign":  # draws no members
        return torch.from_numpy(np.array(eps)), None
    members = np.stack(members)
    if kind == "cem":
        members = np.swapaxes(members, 0, 1)
    return torch.from_numpy(np.array(eps)), torch.from_numpy(members)


@pytest.mark.parametrize("kind,mode", [("cem", m) for m in ("ts1",
                                                              "ts1_exact",
                                                              "assign")]
                         + [("rs", "ts1")])
def test_plan_matches_jax_with_the_same_draws(kind, mode):
    jplanner, jstate, planner, state = build(mode, kind)
    obs, z = inputs()
    prev_mu = np.random.RandomState(5).uniform(-1, 1, (E, H, ACT)).astype(
        np.float32)
    key = jax.random.key(11)
    ref_a, ref_mu = jax.vmap(lambda o, zz, m, k: jplanner._plan_single(
        jstate.params, jstate.norm, o, zz, m, k))(
        jnp.asarray(obs), jnp.asarray(z), jnp.asarray(prev_mu),
        jax.random.split(key, E))
    noise, members = plan_draws(kind, mode, key)
    a, mu = planner.plan(state, torch.from_numpy(obs), torch.from_numpy(z),
                         gen=None, prev_mu=torch.from_numpy(prev_mu),
                         noise=noise, members=members)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=ACT_ATOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=ACT_ATOL)


def test_plan_mean_mode_matches_jax():
    """'mean' draws nothing but the ε: the JAX plan's own ε suffice."""
    jplanner, jstate, planner, state = build("mean")
    obs, z = inputs()
    key = jax.random.key(12)
    ref_a, ref_mu = jax.vmap(lambda o, zz, m, k: jplanner._plan_single(
        jstate.params, jstate.norm, o, zz, m, k))(
        jnp.asarray(obs), jnp.asarray(z), jnp.zeros((E, H, ACT)),
        jax.random.split(key, E))
    noise, _ = plan_draws("cem", "ts1", key)  # ε only; members unused
    a, mu = planner.plan(state, torch.from_numpy(obs), torch.from_numpy(z),
                         gen=None, noise=noise)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=ACT_ATOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=ACT_ATOL)


def test_member_draws_come_from_the_generator():
    """Without injected draws: TS1 permutations are permutations, i.i.d.
    members lie in range, and one seed gives one plan."""
    for mode in MODES:
        _, _, planner, state = build(mode)
        d = planner.member_draws(torch.Generator().manual_seed(0), E, C)
        if mode == "ts1":
            assert d.shape == (E, H, N)
            assert torch.equal(d.sort(-1).values,
                               torch.arange(N).expand(E, H, N))
        elif mode == "ts1_exact":
            assert d.shape == (E, H, C) and 0 <= d.min() and d.max() < N
        else:
            assert d is None
        obs, z = map(torch.from_numpy, inputs())
        plans = [planner.plan(state, obs, z,
                              torch.Generator().manual_seed(s))[0]
                 for s in (0, 0, 1)]
        assert torch.equal(plans[0], plans[1])
        assert not torch.equal(plans[0], plans[2])


def test_assign_matches_mean_on_agreeing_ensemble():
    """The counterpart of the JAX ``test_ts1_assign_matches_mean_on_agreeing_
    ensemble`` (tests/test_planner.py): with every member a copy of member
    0, 'assign', 'ts1' and 'ts1_exact' give 'mean''s plan from the same ε
    (the member draws move nothing). One generator seed per mode: the port
    draws ε and members from one stream, so the ε are injected."""
    _, _, planner, state = build("mean")
    fwd = [{k: v[:1].expand_as(v).clone() for k, v in layer.items()}
           for layer in state.params["fwd"]]
    state = DynamicsState({**state.params, "fwd": fwd}, state.norm)
    obs, z = map(torch.from_numpy, inputs())
    eps = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (ITERS, E, C, H, ACT)).clip(-2, 2).astype(np.float32))
    plans = {}
    for mode in MODES:
        p = MPCPlanner(dataclasses.replace(planner.cfg, ensemble_eval=mode),
                       planner.model, planner.reward_fn, ACT,
                       bad_transition_fn=planner.bad_transition_fn,
                       obs_limit=planner.obs_limit)
        plans[mode] = p.plan(state, obs, z, torch.Generator().manual_seed(0),
                             noise=eps)
    for mode in ("assign", "ts1", "ts1_exact"):
        for got, ref in zip(plans[mode], plans["mean"]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       atol=ACT_ATOL)
