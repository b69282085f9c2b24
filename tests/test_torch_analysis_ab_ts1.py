"""The port's block-vs-exact TS1 A/B (``cadm_tpu_torch/analysis/ab_ts1.py``)
against scripts/ab_ts1.py: five ``Dynamics.update`` steps of
``train_cartpole_ensemble`` from the script's initial state, on its
collect (reset states and actions rebuilt from ``key(seed + 1)``) and its
minibatch indices (``key(10_000 + i)``): the norm statistics within 1e-5
and the loss of the trained state within 1e-4; and the elite study: the
overlap statistics of the script's own returns equal to its record, and
the port's candidate returns within the planner tests' tolerances on the
script's start states, candidates and member draws (rebuilt from
``key(1000·d + seed)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import env_states_to_torch, jax_reset
import scripts.ab_ts1 as jax_ab
from cadm_tpu.models.dynamics import SegmentBatch as JaxSegmentBatch
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu_torch.analysis import ab_ts1
from cadm_tpu_torch.analysis.snapshot import dyn_state_from_jax
from cadm_tpu_torch.models.dynamics import SegmentBatch

N, STEPS, BATCH = 5, 5, 32
LOSS_ATOL, NORM_RTOL = 1e-4, 1e-5
# tests/test_torch_planner_ensemble.py's tolerances on returns
RET_RTOL, RET_ATOL = 1e-5, 1e-4


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t(x):
    return torch.from_numpy(np.array(x))


def collect_draws(env_j, seed=0):
    """The script's collect: reset states and actions from key(seed+1)."""
    r_reset, r_act = jax.random.split(jax.random.key(seed + 1))
    states = jax_reset(env_j, jax.random.split(r_reset, ab_ts1.N_ENV))
    actions = jnp.stack([
        jax.random.uniform(k, (ab_ts1.N_ENV, env_j.act_dim), minval=-1,
                           maxval=1)
        for k in jax.random.split(r_act, ab_ts1.T)])
    return states, t(actions)


@pytest.fixture(scope="module")
def jax_trained():
    """The script's ensemble after STEPS updates: (env, model, state)."""
    return jax_ab.train_cartpole_ensemble(n_members=N, steps=STEPS,
                                          batch=BATCH, seed=0)


def test_training_matches_the_script(jax_trained):
    env_j, model_j, jstate = jax_trained
    jinit = model_j.init_state(jax.random.key(0))
    jstates, actions = collect_draws(env_j)
    n = ab_ts1.N_ENV * ab_ts1.T
    indices = [t(jax.random.randint(jax.random.key(10_000 + i), (N, BATCH),
                                    0, n)) for i in range(STEPS)]
    env, model, _ = ab_ts1.train_cartpole_ensemble(steps=0, device="cpu",
                                                   log=lambda *a: None)
    _, _, state = ab_ts1.train_cartpole_ensemble(
        n_members=N, steps=STEPS, batch=BATCH, device="cpu",
        state=dyn_state_from_jax(np_tree(jinit), "cpu"),
        start=env_states_to_torch(env, jstates), actions=actions,
        indices=indices, log=lambda *a: None)
    assert state.updates == STEPS
    for f in ("obs_mean", "obs_std", "act_mean", "act_std", "dobs_mean",
              "dobs_std"):
        np.testing.assert_allclose(getattr(state.norm, f).numpy(),
                                   np.asarray(getattr(jstate.norm, f)),
                                   rtol=NORM_RTOL, atol=1e-7, err_msg=f)
    # the trained states' loss on one seeded batch of transitions
    rng = np.random.RandomState(0)
    obs = rng.randn(N, 16, 1, 5).astype(np.float32)
    act = rng.uniform(-1, 1, (N, 16, 1, 1)).astype(np.float32)
    nobs = (obs + 0.05 * rng.randn(*obs.shape)).astype(np.float32)
    hist = [np.zeros((N, 16, 2, d), np.float32) for d in (5, 5, 1)]
    fields = (*hist, np.zeros((N, 16, 2), np.float32), obs, act, nobs,
              np.ones((N, 16, 1), np.float32))
    ref, _ = model_j.loss(jstate.params, jstate.norm,
                          JaxSegmentBatch(*map(jnp.asarray, fields)))
    loss, _ = model.loss(state.params, state.norm,
                         SegmentBatch(*map(torch.from_numpy, fields)))
    np.testing.assert_allclose(float(loss), float(ref), atol=LOSS_ATOL)


def evaluate_draws(mode, key, c, h):
    """What one JAX ``_evaluate_ts1*`` call draws from ``key`` per step: a
    block permutation ('ts1') or i.i.d. members per candidate."""
    out, rng = [], key
    for _ in range(h):
        rng, k_draw, _ = jax.random.split(rng, 3)
        out.append(jax.random.permutation(k_draw, N) if mode == "ts1"
                   else jax.random.randint(k_draw, (c,), 0, N))
    return np.asarray(jnp.stack(out))


def test_elite_study_matches_on_injected_draws(jax_trained):
    n_obs, c, h, k_elite, draws = 3, 25, 5, 4, 4
    env_j, model_j, jstate = jax_trained
    ref = jax_ab.elite_study(env_j, model_j, jstate, n_obs, c, h, k_elite,
                             draws, seed=0)

    # the script's returns, rebuilt as it computes them
    r_obs, r_act, _ = jax.random.split(jax.random.key(0), 3)
    jstates = jax_reset(env_j, jax.random.split(r_obs, n_obs))
    obs = jax.vmap(env_j.observe)(jstates.params, jstates.phys)
    actions = jax.random.uniform(r_act, (n_obs, c, h, env_j.act_dim),
                                 minval=-1, maxval=1)
    z = jnp.zeros((n_obs, 0))
    jrets, members = {}, {}
    for mode in ab_ts1.MODES:
        p = JaxPlanner(JaxPlannerConfig(kind="cem", horizon=h, n_candidates=c,
                                        cem_elites=k_elite,
                                        ensemble_eval=mode),
                       model_j, env_j.reward, env_j.act_dim)
        f = jax.jit(jax.vmap(lambda o, zz, a, k: p._evaluate(
            jstate.params, jstate.norm, o, zz, a, k)))
        keys = [jax.random.split(jax.random.key(1000 * d), n_obs)
                for d in range(draws)]
        jrets[mode] = np.stack([np.asarray(f(obs, z, actions, ks))
                                for ks in keys])
        members[mode] = [t(np.stack([evaluate_draws(mode, k, c, h)
                                     for k in ks])) for ks in keys]
    stats = ab_ts1.overlap_stats(jrets, k_elite)
    assert stats == {k: ref[k] for k in stats}
    assert sorted(ref) == sorted({"n_obs", "candidates", "horizon", "elites",
                                  "draws_per_mode", *stats})

    env, model, _ = ab_ts1.train_cartpole_ensemble(steps=0, device="cpu",
                                                   log=lambda *a: None)
    rets = ab_ts1.candidate_returns(
        env, model, dyn_state_from_jax(np_tree(jstate), "cpu"), n_obs, c, h,
        k_elite, draws, obs=t(obs), actions=t(actions), members=members)
    for mode in ab_ts1.MODES:
        assert rets[mode].shape == (draws, n_obs, c)
        np.testing.assert_allclose(rets[mode], jrets[mode], rtol=RET_RTOL,
                                   atol=RET_ATOL, err_msg=mode)


def test_closed_loop_runs_each_mode():
    env, model, state = ab_ts1.train_cartpole_ensemble(
        steps=2, batch=16, device="cpu", log=lambda *a: None)
    for mode in ab_ts1.MODES:
        r = [ab_ts1.closed_loop(env, model, state, mode, 0, episodes=2, t=4)
             for _ in range(2)]
        assert r[0] == r[1] and np.isfinite(r[0])
