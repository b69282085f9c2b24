"""The port's model fit against the JAX package: loss and gradient, the
optimizer step (optax ``clip_by_global_norm(10)`` → ``adam(1e-3)``), the norm
refresh, the epoch arithmetic, the early-stop rule and a whole epoch fit (one
deterministic member, the result matrix's five probabilistic PE-TS + CaDM
members with the shared and the detached log-variance trunk, and the history
baselines Stacked, ReBAL and GrBAL).

Weights, optimizer state and inputs come from the JAX side (converted with
``utils.convert``); where the JAX trainer draws segment indices from its keys,
the test rebuilds those draws and hands the port the same indices.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu.models.grbal import GrBAL as JaxGrBAL
from cadm_tpu.models.grbal import GrBALConfig as JaxGrBALConfig
from cadm_tpu.planners.grbal_mpc import GrBALPlanner as JaxGrBALPlanner
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu.train.mb_trainer import MBTrainer as JaxTrainer
from cadm_tpu.train.mb_trainer import TrainerConfig as JaxTrainerConfig
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.models.dynamics import (
    Dynamics,
    DynamicsConfig,
    DynamicsState,
    SegmentBatch,
)
from cadm_tpu_torch.models.grbal import GrBAL, GrBALConfig, GrBALState
from cadm_tpu_torch.planners.grbal_mpc import GrBALPlanner
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.mb_trainer import (
    MBTrainer,
    TrainerConfig,
    early_stop_step,
    epoch_minibatches,
)
from cadm_tpu_torch.utils.convert import adam_state_from_jax, params_from_jax

# float32 matmul chains of ≤ 5 layers and their gradients, summed in another
# order than XLA's: 1e-5 absolute (the model tests' tolerance). Twenty Adam
# steps move each weight by ≤ 20·lr, and Adam divides the gradient by its own
# RMS, so the per-step gradient noise stays at the same 1e-5 level.
ATOL = 1e-5
# a whole epoch fit: up to a few dozen updates, valid losses of O(10)
FIT_ATOL, FIT_RTOL = 1e-4, 1e-5
OBS, ACT, K, M, B = 17, 6, 3, 4, 16
MODEL = dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), context="encoder",
             history_k=K, future_m=M)


def norm_np(seed=0):
    rng = np.random.RandomState(seed)
    return JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS), (-1, 1, ACT),
                                       (0.5, 2, ACT), (-0.2, 0.2, OBS),
                                       (0.1, 1, OBS))))


def batch_np(seed, target_scale=1.0):
    """A (1, B, ...) segment batch with partly masked steps."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(1, B, *s).astype(np.float32)  # noqa: E731
    obs = f(M, OBS)
    return dict(
        hist_obs=f(K, OBS), hist_dobs=f(K, OBS),
        hist_act=rng.uniform(-1, 1, (1, B, K, ACT)).astype(np.float32),
        hist_valid=(rng.rand(1, B, K) > 0.3).astype(np.float32),
        obs=obs, act=rng.uniform(-1, 1, (1, B, M, ACT)).astype(np.float32),
        next_obs=obs + target_scale * 0.3 * f(M, OBS),
        valid=(rng.rand(1, B, M) > 0.2).astype(np.float32),
    )


def to_jax(b):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def to_port(b):
    return SegmentBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def port_state(jstate, model):
    params, norm = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.norm), "cpu")
    opt = adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state[1][0]),
                              "cpu")
    if isinstance(model, GrBAL):
        return GrBALState(params, norm, opt, int(jstate.updates))
    return DynamicsState(params, norm, opt, int(jstate.updates))


def assert_trees_close(port_tree, jax_tree, atol, rtol=0.0):
    ours = tree_leaves(port_tree)
    ref = jax.tree.leaves(jax_tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=rtol)


def test_loss_and_gradient_match_jax():
    jm = JaxDynamics(JaxConfig(**MODEL))
    jparams, jnorm = jm.init_params(jax.random.key(1)), norm_np()
    b = batch_np(2)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, jnorm, to_jax(b))
    model = Dynamics(DynamicsConfig(**MODEL), "cpu")
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm), "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss, met = model.loss(params, norm, to_port(b))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(met["fwd_mean_mse"].item(),
                               float(jmet["fwd_mean_mse"]), rtol=1e-6,
                               atol=ATOL)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL)


def test_twenty_updates_match_optax_from_a_mid_training_state():
    jm = JaxDynamics(JaxConfig(**MODEL))
    jstate = dataclasses.replace(jm.init_state(jax.random.key(3)),
                                 norm=norm_np(1))
    jupdate = jax.jit(jm.update)
    for s in range(3):  # a mid-training Adam state: count 3, moments set
        jstate, _ = jupdate(jstate, to_jax(batch_np(100 + s)))
    model = Dynamics(DynamicsConfig(**MODEL), "cpu")
    state = port_state(jstate, model)
    assert state.opt_state.count == 3 and state.updates == 3

    batches = [batch_np(s, target_scale=40.0 if s == 7 else 1.0)
               for s in range(20)]
    # the scaled batch's gradient has a global norm above the clip: the clip
    # branch of both optimizers runs
    g = jax.grad(lambda p: jm.loss(p, jstate.norm, to_jax(batches[7]))[0])(
        jstate.params)
    assert float(optax.global_norm(g)) > 10.0
    for b in batches:
        jstate, jmet = jupdate(jstate, to_jax(b))
        state, met = model.update(state, to_port(b))
        np.testing.assert_allclose(met["model_loss"].item(),
                                   float(jmet["model_loss"]), rtol=1e-5,
                                   atol=ATOL)
    assert state.opt_state.count == int(jstate.opt_state[1][0].count) == 23
    assert state.updates == int(jstate.updates) == 23
    assert_trees_close(state.params, jstate.params, ATOL)
    assert_trees_close(state.opt_state.mu, jstate.opt_state[1][0].mu, ATOL)


# ------------------------------------------------------------- trainers --
def trainers(n_envs=4, capacity=40, model_cfg=None, grbal=False, **fit):
    """The JAX and port trainers at toy width on HalfCheetah (``grbal``: of
    a ``GrBAL`` model config, with each package's ``GrBALPlanner``)."""
    model_cfg = MODEL if model_cfg is None else model_cfg
    tcfg = dict(n_envs=n_envs, batch_size=B, buffer_capacity=capacity,
                fit_protocol="epochs", **fit)
    plan = dict(kind="cem", horizon=3, n_candidates=8, cem_iters=1,
                cem_elites=2)
    jenv = JaxCheetah()
    jm = (JaxGrBAL(JaxGrBALConfig(**model_cfg)) if grbal
          else JaxDynamics(JaxConfig(**model_cfg)))
    jplanner = (JaxGrBALPlanner if grbal else JaxPlanner)(
        JaxPlannerConfig(**plan), jm, jenv.reward, ACT)
    env = HalfCheetahEnv(device="cpu")
    model = (GrBAL(GrBALConfig(**model_cfg), "cpu") if grbal
             else Dynamics(DynamicsConfig(**model_cfg), "cpu"))
    planner = (GrBALPlanner if grbal else MPCPlanner)(
        PlannerConfig(**plan), model, env.reward, ACT)
    return (JaxTrainer(jenv, jm, jplanner, JaxTrainerConfig(**tcfg)),
            MBTrainer(env, model, planner, TrainerConfig(**tcfg)))


_jax_append = jax.jit(JaxBuffer.append)  # one compile, not one per op


def filled_buffers(n_envs, capacity, n_appends, seed=0):
    rng = np.random.RandomState(seed)
    jbuf = JaxBuffer.create(n_envs, capacity, OBS, ACT)
    buf = ReplayBuffer.create(n_envs, capacity, OBS, ACT, "cpu")
    ep = np.zeros(n_envs, np.int32)
    for _ in range(n_appends):
        obs = rng.randn(n_envs, OBS).astype(np.float32)
        act = rng.uniform(-1, 1, (n_envs, ACT)).astype(np.float32)
        nxt = obs + 0.2 * obs[:, ::-1] + 0.1 * np.roll(act, 1, -1).sum(-1,
                                                                       keepdims=True)
        done = rng.rand(n_envs) < 0.1
        bad = rng.rand(n_envs) < 0.03
        es = ep.copy()
        ep = np.where(done, 0, ep + 1).astype(np.int32)
        jbuf = _jax_append(jbuf, *map(jnp.asarray,
                                      (obs, act, nxt, done, es, bad)))
        buf.append(*map(torch.from_numpy, (obs, act, nxt.astype(np.float32),
                                           done, es, bad)))
    return jbuf, buf


def test_refresh_norm_matches_jax():
    jtr, tr = trainers()
    jbuf, buf = filled_buffers(4, 40, 53)
    jm = jtr.model
    jstate = jm.init_state(jax.random.key(0))
    jnorm = jtr._refresh_norm(jbuf, jstate).norm
    norm = tr._refresh_norm(buf, port_state(jstate, tr.model)).norm
    for f in dataclasses.fields(norm):
        np.testing.assert_allclose(getattr(norm, f.name).numpy(),
                                   np.asarray(getattr(jnorm, f.name)),
                                   atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("n_train,capacity,n_envs,batch,cap", [
    (18, 20000, 2048, 256, 400),   # the preset after one 20-step collect
    (36, 20000, 2048, 256, 400),
    (900, 20000, 2048, 256, 400),  # capped at 400
    (1, 7, 3, 2, 500),             # 1·3/2: floor 1, not the ceiling 2
    (5, 9, 1, 4, 500),
    (0, 10, 4, 8, 500),
])
def test_epoch_minibatches_match_the_reference_expressions(
        n_train, capacity, n_envs, batch, cap):
    # mb_trainer.py:376-385, with n_train_anchors() a jnp int32 as there
    mb_cap = min(cap, max(1, -(-capacity * n_envs * 9 // 10 // batch)))
    n_mb = jnp.minimum(jnp.maximum(
        -(-jnp.asarray(n_train, jnp.int32) * n_envs) // batch, 1), mb_cap)
    assert epoch_minibatches(n_train, capacity, n_envs, batch, cap) == (
        mb_cap, int(n_mb))
    assert epoch_minibatches(n_train, capacity, n_envs, batch, cap)[1] == min(
        max(n_train * n_envs // batch, 1), mb_cap)


SCRIPTS = {
    "improving": [10.0, 9.0, 8.0, 7.0, 6.0, 5.0, 4.0],
    "plateau": [10.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0],
    "below_min_rel": [10.0, 9.995, 9.99, 9.985, 9.98, 9.975, 9.97],
    "nan": [10.0, 9.0, np.nan, 8.0, 7.0, 6.0, 5.0],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_early_stop_sequence_matches_jax(script):
    """A scripted valid-loss sequence (indexed by updates // n_mb) through
    both trainers' epoch loops."""
    vals = np.asarray(SCRIPTS[script], np.float32)
    jtr, tr = trainers(max_epochs=6, early_stop_patience=2)
    jbuf, buf = filled_buffers(4, 40, 30)
    _, n_mb = epoch_minibatches(buf.n_train_anchors(), 40, 4, B, 500)
    jtr._valid_metrics = lambda buffer, rng, st: (
        jnp.asarray(vals)[st.updates // n_mb], jnp.nan)
    tr._valid_metrics = lambda buffer, idx, st: (
        torch.tensor(vals[st.updates // n_mb]), torch.tensor(np.nan))
    jstate = jtr.model.init_state(jax.random.key(0))
    tr_state = port_state(jstate, tr.model)
    _, jmet = jtr._fit(jax.random.key(1), jbuf, jstate)
    state, met = tr._fit(torch.Generator().manual_seed(0), buf, tr_state)
    for key in ("fit/epochs_run", "fit/valid_loss_before",
                "fit/valid_loss_after", "fit/valid_monitored_best"):
        np.testing.assert_array_equal(np.float32(met[key]),
                                      np.asarray(jmet[key]), err_msg=key)
    ran = {"improving": 6, "plateau": 3, "below_min_rel": 2, "nan": 2}[script]
    assert met["fit/epochs_run"] == ran
    # the port stops where the reference's skipped epochs begin
    stopped_at = {"improving": 6, "plateau": 3, "below_min_rel": 2, "nan": 3}
    assert state.updates == stopped_at[script] * n_mb


@functools.partial(jax.jit, static_argnums=(2, 3))
def _segment_indices(key, high, shape, n_envs):
    """(env_idx, u) of one segment draw from ``key``."""
    r_seg, _ = jax.random.split(key)          # MBTrainer._sample
    r_env, r_t = jax.random.split(r_seg)      # ReplayBuffer.sample_segments
    return (jax.random.randint(r_env, shape, 0, n_envs),
            jax.random.randint(r_t, shape, 0, jnp.maximum(high, 1)))


def jax_fit_draws(jtr, jbuf, rng, n_mb, mb_cap):
    """Every (split, env_idx, u) the JAX ``_fit_epochs_impl`` draws from
    ``rng``, in order (all ``max_epochs`` epochs)."""
    cfg, shape = jtr.cfg, (jtr.model.cfg.n_members, B)

    def draw(key, split):
        high = {"train": jbuf.n_train_anchors(),
                "valid": jbuf.n_valid_anchors()}[split]
        return (split, *(torch.tensor(np.asarray(x)) for x in
                         _segment_indices(key, high, shape, jbuf.n_envs)))

    r_init, r_epochs = jax.random.split(rng)
    out = [draw(k, "valid")
           for k in jax.random.split(r_init, cfg.valid_batches)]
    for k_epoch in jax.random.split(r_epochs, cfg.max_epochs):
        keys = jax.random.split(k_epoch, mb_cap + 1)
        out += [draw(keys[i], "train") for i in range(n_mb)]
        out += [draw(k, "valid")
                for k in jax.random.split(keys[-1], cfg.valid_batches)]
    return out


# PE-TS + CaDM as the result matrix trains it (cli/matrix.py's pets_cadm and
# pets_cadm_dv): five probabilistic members under the decoupled loss, each
# drawing its own bootstrap minibatch
PETS = dict(MODEL, n_members=5, probabilistic=True, mean_anchor=1.0)
# the baselines (cli/matrix.py's vanilla, stacked, rebal and grbal): no
# context (the heads read obs and action alone), the flat window fed to the
# heads, the GRU encoder over the window, and GrBAL's meta-loss through one
# inner step on the window (its net of the same width); ``grbal`` marks a
# GrBAL config
EPOCH_FITS = {
    "deterministic": (MODEL, {}),
    "pets_cadm": (PETS, {}),
    "pets_cadm_detached": (dict(PETS, detach_logvar_trunk=True), {}),
    "pets_cadm_dv": (dict(PETS, detach_logvar_trunk=True),
                     dict(early_stop_metric="fwd_mse")),
    "vanilla": (dict(MODEL, context="none"), {}),
    "stacked": (dict(MODEL, context="stacked"), {}),
    "rnn": (dict(MODEL, context="rnn", z_dim=4, rnn_hidden=8), {}),
    "grbal": (dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), history_k=K,
                   future_m=M), dict(grbal=True)),
}


@pytest.mark.parametrize("case", list(EPOCH_FITS))
def test_epoch_fit_matches_jax_with_the_same_batches(case):
    model_cfg, fit = EPOCH_FITS[case]
    grbal = fit.get("grbal", False)
    jtr, tr = trainers(model_cfg=model_cfg, max_epochs=4,
                       early_stop_patience=2, **fit)
    jbuf, buf = filled_buffers(4, 40, 30, seed=4)
    mb_cap, n_mb = epoch_minibatches(buf.n_train_anchors(), 40, 4, B, 500)
    assert n_mb == 27 * 4 // B
    jstate = jtr.model.init_state(jax.random.key(5))
    rng = jax.random.key(6)
    draws = jax_fit_draws(jtr, jbuf, rng, n_mb, mb_cap)
    assert draws[0][1].shape == (model_cfg.get("n_members", 1), B)

    def injected(buffer, gen, split):
        want, env_idx, u = draws.pop(0)
        assert split == want
        return env_idx, buffer.anchor_columns(u, split)

    tr._draw = injected
    n_draws = len(draws)
    jstate_out, jmet = jtr._fit(rng, jbuf, jstate)
    state, met = tr._fit(torch.Generator().manual_seed(0), buf,
                         port_state(jstate, tr.model))
    epochs = int(jmet["fit/epochs_run"])
    assert met["fit/epochs_run"] == epochs >= 2
    # the port drew exactly the batches of the epochs that ran
    assert n_draws - len(draws) == 4 + epochs * (n_mb + 4)
    assert sorted(met) == sorted(jmet)
    for key, val in met.items():
        np.testing.assert_allclose(float(val), float(jmet[key]),
                                   atol=FIT_ATOL, rtol=FIT_RTOL, err_msg=key)
    # GrBAL's loss reports no forward MSE: NaN on both sides, and its early
    # stop ran on the valid loss
    assert np.isnan(float(met["fit/valid_fwd_mse_after"])) == grbal
    assert np.isnan(float(jmet["fit/valid_fwd_mse_after"])) == grbal
    assert_trees_close(state.params, jstate_out.params, FIT_ATOL)
    jadam = jstate_out.opt_state[1][0]
    assert int(state.opt_state.count) == int(jadam.count) == epochs * n_mb
    assert_trees_close(state.opt_state.mu, jadam.mu, FIT_ATOL)
    assert_trees_close(state.opt_state.nu, jadam.nu, FIT_ATOL)
    assert state.updates == int(jstate_out.updates) == epochs * n_mb
    # the fitted models' loss terms on one held-out batch, the members'
    # log-variance bound penalty among them
    jb = jtr._sample(jbuf, jax.random.key(7), "valid")
    _, jlm = jtr.model.loss(jstate_out.params, jstate_out.norm, jb)
    _, lm = tr.model.loss(state.params, state.norm, SegmentBatch(
        **{f.name: torch.tensor(np.asarray(getattr(jb, f.name)))
           for f in dataclasses.fields(jb)}))
    assert sorted(lm) == sorted(jlm)
    assert ("logvar_bound_penalty" in lm) == model_cfg.get("probabilistic",
                                                            False)
    for key, val in lm.items():
        np.testing.assert_allclose(float(val), float(jlm[key]),
                                   atol=FIT_ATOL, rtol=FIT_RTOL, err_msg=key)


def test_early_stop_step_float32_rule():
    # 9.99 is not below 10·0.999 in float32: no improvement
    assert early_stop_step(10.0, 0, 9.99, 1e-3, 2) == (np.float32(9.99), 1,
                                                       False)
    best, since, stop = early_stop_step(10.0, 1, np.nan, 1e-3, 2)
    assert np.isnan(best) and since == 2 and stop


def test_fixed_fit_matches_jax_with_the_same_batches():
    jtr, tr = trainers(model_updates_per_itr=6)
    jtr = JaxTrainer(jtr.env, jtr.model, jtr.planner,
                     dataclasses.replace(jtr.cfg, fit_protocol="fixed"))
    tr = MBTrainer(tr.env, tr.model, tr.planner,
                   dataclasses.replace(tr.cfg, fit_protocol="fixed"))
    jbuf, buf = filled_buffers(4, 40, 30, seed=7)
    jstate, rng = jtr.model.init_state(jax.random.key(8)), jax.random.key(9)
    # _fit_impl: valid batches from r_valid, then one train batch per update
    r_train, r_valid = jax.random.split(rng)
    draws = []
    for split, keys in (("valid", jax.random.split(r_valid, 4)),
                        ("train", jax.random.split(r_train, 6))):
        for k in keys:
            r_env, r_t = jax.random.split(jax.random.split(k)[0])
            high = jbuf.n_valid_anchors() if split == "valid" else \
                jbuf.n_train_anchors()
            draws.append((split, jax.random.randint(r_env, (1, B), 0, 4),
                          jax.random.randint(r_t, (1, B), 0, high)))

    def injected(buffer, gen, split):
        want, env_idx, u = draws.pop(0)
        assert split == want
        return (torch.tensor(np.asarray(env_idx)),
                buffer.anchor_columns(torch.tensor(np.asarray(u)), split))

    tr._draw = injected
    jstate_out, jmet = jtr._fit(rng, jbuf, jstate)
    state, met = tr._fit(torch.Generator(), buf, port_state(jstate, tr.model))
    assert not draws and sorted(met) == sorted(jmet)
    for key, val in met.items():
        np.testing.assert_allclose(float(val), float(jmet[key]),
                                   atol=FIT_ATOL, rtol=FIT_RTOL, err_msg=key)
    assert_trees_close(state.params, jstate_out.params, FIT_ATOL)
