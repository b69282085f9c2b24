"""The port's GrBAL model and planner against the JAX package, with the JAX
weights loaded; a toy GrBAL training loop on the cheetah; the planner's
blowup guard.

Narrow width (net (32, 32), K = 4, M = 3); normalization statistics,
windows and batches are numpy draws shared by both sides, the windows partly
valid.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cadm_tpu.core.types import History as JaxHistory
from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu.models.grbal import GrBAL as JaxGrBAL
from cadm_tpu.models.grbal import GrBALConfig as JaxGrBALConfig
from cadm_tpu.planners.grbal_mpc import GrBALPlanner as JaxGrBALPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import History, tree_leaves
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.models.grbal import GrBAL, GrBALConfig, GrBALState
from cadm_tpu_torch.models.dynamics import SegmentBatch
from cadm_tpu_torch.planners.grbal_mpc import GrBALPlanner
from cadm_tpu_torch.planners.mpc import PlannerConfig
from cadm_tpu_torch.utils.convert import adam_state_from_jax, params_from_jax

# float32 matmul chains of ≤ 3 layers, one inner gradient step and the
# meta-gradient through it (second order through swish), summed in another
# order than XLA's: the model tests' 1e-5
ATOL = 1e-5
# the planner's returns: sums of 5 float32 rewards and a 1e4 penalty, as in
# test_torch_planner.py
RET_RTOL, RET_ATOL = 1e-5, 1e-4
OBS, ACT, K, M, E, B, C, H = 17, 6, 4, 3, 4, 10, 8, 5
CFG = dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), history_k=K,
           future_m=M)


def norm_np(seed=0):
    rng = np.random.RandomState(seed)
    return JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS), (-1, 1, ACT),
                                       (0.5, 2, ACT), (-0.2, 0.2, OBS),
                                       (0.1, 1, OBS))))


def models(seed=3):
    jm = JaxGrBAL(JaxGrBALConfig(**CFG))
    jstate = dataclasses.replace(jm.init_state(jax.random.key(seed)),
                                 norm=norm_np())
    params, norm = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.norm), "cpu")
    return jm, jstate, GrBAL(GrBALConfig(**CFG), "cpu"), params, norm


def windows(seed=1, n=E):
    """(obs, act, dobs, valid) windows (n, K, ·), one empty and one full."""
    rng = np.random.RandomState(seed)
    obs, dobs = rng.randn(2, n, K, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (n, K, ACT)).astype(np.float32)
    valid = (rng.rand(n, K) > 0.4).astype(np.float32)
    valid[0], valid[1] = 0.0, 1.0
    return obs, act, 0.3 * dobs, valid


def batch_np(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(1, B, *s).astype(np.float32)  # noqa: E731
    obs = f(M, OBS)
    return dict(
        hist_obs=f(K, OBS), hist_dobs=0.3 * f(K, OBS),
        hist_act=rng.uniform(-1, 1, (1, B, K, ACT)).astype(np.float32),
        hist_valid=(rng.rand(1, B, K) > 0.3).astype(np.float32),
        obs=obs, act=rng.uniform(-1, 1, (1, B, M, ACT)).astype(np.float32),
        next_obs=obs + 0.3 * f(M, OBS),
        valid=(rng.rand(1, B, M) > 0.2).astype(np.float32),
    )


def to_jax(b):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def to_port(b):
    return SegmentBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def assert_trees_close(port_tree, jax_tree, atol):
    ours, ref = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol)


def jax_adapted(jm, jstate, obs, act, dobs, valid):
    """The reference's fast weights of each window (vmapped ``adapt``)."""
    return jax.jit(jax.vmap(lambda o, a, d, v: jm.adapt(
        jstate.params, jstate.norm, o, a, d, v)))(
        *map(jnp.asarray, (obs, act, dobs, valid)))


def test_config_defaults_and_state_match_the_reference():
    ref = JaxGrBALConfig(obs_dim=OBS, act_dim=ACT)
    ours = GrBALConfig(obs_dim=OBS, act_dim=ACT)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.hidden, ours.inner_lr, ours.inner_steps, ours.grad_clip,
            ours.n_members) == ((200, 200, 200), 0.01, 1, 10.0, 1)
    jm, jstate, model, params, _ = models()
    state = model.init_state(torch.Generator().manual_seed(0))
    assert [x.shape for x in tree_leaves(state.params)] == [
        tuple(x.shape) for x in jax.tree.leaves(jstate.params)]
    # the trainer replaces the norm of a model state
    assert dataclasses.replace(state, norm=state.norm).updates == 0


def test_adapt_matches_jax():
    jm, jstate, model, params, norm = models()
    obs, act, dobs, valid = windows()
    ref = jax_adapted(jm, jstate, obs, act, dobs, valid)
    live = {"net": [{k: v.requires_grad_(True) for k, v in layer.items()}
                    for layer in params["net"]]}
    net = model.adapt(live, norm, *map(torch.from_numpy,
                                       (obs, act, dobs, valid)))
    assert net[0]["w"].shape == (E, OBS + ACT, 32)
    assert_trees_close(net, ref, ATOL)
    # the empty window takes no step: its fast weights are the prior's
    np.testing.assert_array_equal(net[0]["w"][0].detach().numpy(),
                                  params["net"][0]["w"].detach().numpy())


def test_predict_matches_jax_for_shared_and_per_env_weights():
    jm, jstate, model, params, norm = models()
    rng = np.random.RandomState(4)
    obs = rng.randn(E, C, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (E, C, ACT)).astype(np.float32)
    ref = jax.jit(jm.predict)(jstate.params["net"], jstate.norm,
                              jnp.asarray(obs), jnp.asarray(act))
    out = model.predict(params["net"], norm, torch.from_numpy(obs),
                        torch.from_numpy(act))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # per-env fast weights: each env's rows through its own net
    hist = windows(5)
    jnet = jax_adapted(jm, jstate, *hist)
    ref = jax.jit(jax.vmap(lambda n, o, a: jm.predict(n, jstate.norm, o, a)))(
        jnet, jnp.asarray(obs), jnp.asarray(act))
    net, _ = params_from_jax(jax.tree.map(np.asarray, jnet), norm_np(), "cpu")
    out = model.predict(net, norm, torch.from_numpy(obs),
                        torch.from_numpy(act))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_meta_loss_gradient_and_update_match_jax():
    """The meta-loss, its gradient (second order through swish and the
    inner step) and one clip + Adam step from a mid-training state."""
    jm, jstate, model, params, norm = models()
    b = batch_np(2)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jstate.params, jstate.norm, to_jax(b))
    live = {"net": [{k: v.requires_grad_(True) for k, v in layer.items()}
                    for layer in params["net"]]}
    loss, met = model.loss(live, norm, to_port(b))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    assert sorted(met) == ["model_loss"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=ATOL)
    assert_trees_close(list(grads), jgrads, ATOL)
    # under no_grad (the trainer's valid loss) the value is the same
    with torch.no_grad():
        v, _ = model.loss(params, norm, to_port(b))
    np.testing.assert_allclose(v.item(), float(jloss), rtol=1e-6, atol=ATOL)

    jupdate = jax.jit(jm.update)
    for s in range(3):
        jstate, _ = jupdate(jstate, to_jax(batch_np(10 + s)))
    p, n = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                           jax.tree.map(np.asarray, jstate.norm), "cpu")
    opt = adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state[1][0]),
                              "cpu")
    state = GrBALState(p, n, opt, int(jstate.updates))
    b = batch_np(20)
    jstate, jmet = jupdate(jstate, to_jax(b))
    with torch.no_grad():  # as the trainer's fit calls it
        state, met = model.update(state, to_port(b))
    np.testing.assert_allclose(met["model_loss"].item(),
                               float(jmet["model_loss"]), rtol=1e-6, atol=ATOL)
    assert state.opt_state.count == state.updates == 4
    assert_trees_close(state.params, jstate.params, ATOL)
    assert_trees_close(state.opt_state.mu, jstate.opt_state[1][0].mu, ATOL)


def test_context_from_history_matches_jax_per_env():
    jm, jstate, model, params, norm = models()
    obs, act, dobs, valid = windows(6)
    jh = JaxHistory(*map(jnp.asarray, (obs, dobs, act, valid)),
                    rnn_h=jnp.zeros((E, 0)))
    ref = jax.jit(jm.context_from_history)(jstate.params, jstate.norm, jh)
    th = History(*map(torch.from_numpy, (obs, dobs, act, valid)),
                 rnn_h=torch.zeros(E, 0))
    with torch.no_grad():  # as the collect and eval loops call it
        net = model.context_from_history(params, norm, th)
    assert not any(x.requires_grad for x in tree_leaves(net))
    assert_trees_close(net, ref, ATOL)


def test_planner_evaluate_matches_the_reference_mapped_over_envs():
    jm, jstate, model, params, norm = models()
    jenv, env = JaxCheetah(), HalfCheetahEnv(device="cpu")
    plan = dict(kind="cem", horizon=H, n_candidates=C, cem_iters=1,
                cem_elites=2)
    jplanner = JaxGrBALPlanner(JaxPlannerConfig(**plan), jm, jenv.reward, ACT,
                               bad_transition_fn=jenv.bad_transition,
                               obs_limit=jenv.bad_obs_limit)
    planner = GrBALPlanner(PlannerConfig(**plan), model, env.reward, ACT,
                           bad_transition_fn=env.bad_transition,
                           obs_limit=env.bad_obs_limit)
    rng = np.random.RandomState(7)
    obs0 = rng.randn(E, OBS).astype(np.float32)
    obs0[2, 3] = 160.0  # beyond bad_obs_limit: env 2's rollouts blow up
    actions = rng.uniform(-1, 1, (E, C, H, ACT)).astype(np.float32)
    jnet = jax_adapted(jm, jstate, *windows(8))
    ref = jax.jit(jax.vmap(lambda o, z, a: jplanner._evaluate(
        jstate.params, jstate.norm, o, z, a, jax.random.key(0))))(
        jnp.asarray(obs0), jnet, jnp.asarray(actions))
    net, _ = params_from_jax(jax.tree.map(np.asarray, jnet), norm_np(), "cpu")
    out = planner._evaluate(params, norm, torch.from_numpy(obs0), net,
                            torch.from_numpy(actions))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RET_RTOL,
                               atol=RET_ATOL)
    assert np.all(out.numpy()[2] < -9e3)


def test_grbal_full_trainer_loop_on_the_cheetah():
    """As tests/test_grbal.py's loop, on the cheetah here: GrBAL as the
    trainer's model, adapted context and MPC end to end; the valid MSE is
    NaN (GrBAL reports none), as in the reference."""
    cfg = dataclasses.replace(
        PRESETS["halfcheetah_cadm_cem"], model="grbal", hidden=(16, 16, 16, 99),
        n_envs=2, eval_envs=2, eval_modes=(0,), n_candidates=6,
        plan_horizon=3, cem_iters=2, cem_elites=2, n_itr=2, steps_per_itr=4,
        env_horizon=3, buffer_capacity=12, batch_size=4, max_epochs=2)
    _, model, planner, trainer = cfg.build("cpu")
    assert isinstance(planner, GrBALPlanner)
    assert model.cfg.hidden == (16, 16, 16)  # hidden[:3], as the reference
    dyn, history = trainer.train(torch.Generator().manual_seed(0))
    assert len(history) == 2 and dyn.updates > 0
    assert np.isfinite(history[-1]["fit/model_loss_last"])
    assert np.isfinite(history[-1]["eval/return_mode0"])
    assert np.isnan(history[-1]["fit/valid_fwd_mse_after"])


def test_grbal_planner_blowup_guard():
    """As tests/test_grbal.py: an adapted net whose predictions explode
    gives finite, penalized returns; unguarded, the exploit pays."""

    class StubModel:
        def predict(self, z, norm, obs, act):
            return obs * 2.0 + 100.0  # doubles per step from a large base

    def bad(o, no):
        return (no.abs().amax(-1) > 150.0) | ((no - o).abs().amax(-1) > 100.0)

    def reward(o, a, no):
        return no[..., 0]

    cfg = PlannerConfig(kind="rs", horizon=10, n_candidates=8)
    guarded = GrBALPlanner(cfg, StubModel(), reward, 1, bad_transition_fn=bad,
                           obs_limit=150.0)
    unguarded = GrBALPlanner(cfg, StubModel(), reward, 1)
    acts, obs0 = torch.zeros(2, 8, 10, 1), torch.zeros(2, 2)
    r_g = guarded._evaluate(None, None, obs0, None, acts)
    r_u = unguarded._evaluate(None, None, obs0, None, acts)
    assert torch.isfinite(r_g).all() and r_g.max() < 0.0
    assert r_u.min() > 1e4
