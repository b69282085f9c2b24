"""The port's stacked and ReBAL (``context='rnn'``) models against the JAX
package, with the JAX weights loaded (``params_from_jax`` copies the GRU's
``{"z","r","h"} × {"wx","wh","b"}`` leaf for leaf).

Narrow width (heads (32, 32), GRU hidden 8, K = 4); normalization
statistics, windows and batches are numpy draws shared by both sides, the
windows partly valid.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.core.types import batched_history as jax_batched_history
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu.models.nets import gru_apply as jax_gru_apply
from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import batched_history, tree_leaves
from cadm_tpu_torch.models.dynamics import (
    Dynamics,
    DynamicsConfig,
    DynamicsState,
    SegmentBatch,
)
from cadm_tpu_torch.models.nets import gru_apply, gru_init
from cadm_tpu_torch.utils.convert import adam_state_from_jax, params_from_jax

# float32 matmul chains of ≤ 5 layers (and K GRU steps) and their gradients,
# summed in another order than XLA's: the model tests' 1e-5
ATOL = 1e-5
OBS, ACT, K, M, E, B, H = 17, 6, 4, 3, 5, 12, 8
CONTEXTS = ("stacked", "rnn")


def cfg(context):
    return dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), context=context,
                z_dim=4, rnn_hidden=H, history_k=K, future_m=M)


def norm_np(seed=0):
    rng = np.random.RandomState(seed)
    return JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS), (-1, 1, ACT),
                                       (0.5, 2, ACT), (-0.2, 0.2, OBS),
                                       (0.1, 1, OBS))))


def models(context, seed=3):
    jm = JaxDynamics(JaxConfig(**cfg(context)))
    jparams, jnorm = jm.init_params(jax.random.key(seed)), norm_np()
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm), "cpu")
    return jm, jparams, jnorm, Dynamics(DynamicsConfig(**cfg(context)),
                                        "cpu"), params, norm


def window(seed=1, lead=(E,)):
    rng = np.random.RandomState(seed)
    dobs = rng.randn(*lead, K, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (*lead, K, ACT)).astype(np.float32)
    valid = (rng.rand(*lead, K) > 0.4).astype(np.float32)
    valid[0] = 0.0   # an empty window
    valid[1] = 1.0   # a full one
    return dobs, act, valid


def batch_np(seed):
    """A (1, B, ...) segment batch with partly masked steps."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(1, B, *s).astype(np.float32)  # noqa: E731
    obs = f(M, OBS)
    return dict(
        hist_obs=f(K, OBS), hist_dobs=f(K, OBS),
        hist_act=rng.uniform(-1, 1, (1, B, K, ACT)).astype(np.float32),
        hist_valid=(rng.rand(1, B, K) > 0.3).astype(np.float32),
        obs=obs, act=rng.uniform(-1, 1, (1, B, M, ACT)).astype(np.float32),
        next_obs=obs + 0.3 * f(M, OBS),
        valid=(rng.rand(1, B, M) > 0.2).astype(np.float32),
    )


def assert_trees_close(port_tree, jax_tree, atol):
    ours, ref = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol)


@pytest.mark.parametrize("context", CONTEXTS)
def test_param_tree_matches_jax_layout(context):
    jm, jparams, _, model, params, _ = models(context)
    own = model.init_params(torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(jparams)
    assert [x.shape for x in tree_leaves(own)] == [
        tuple(x.shape) for x in jax.tree.leaves(jparams)]
    # stacked: the flat window is the context, no encoder, no backward head
    assert sorted(own) == (["fwd"] if context == "stacked"
                           else ["bwd", "encoder", "fwd"])
    assert model.cfg.context_dim == (K * (OBS + ACT) if context == "stacked"
                                     else 4)


def test_gru_apply_matches_jax():
    from cadm_tpu.models.nets import gru_init as jax_gru_init

    jp = jax_gru_init(jax.random.key(0), OBS + ACT, H)
    p, _ = params_from_jax(jax.tree.map(np.asarray, jp), norm_np(), "cpu")
    rng = np.random.RandomState(0)
    h = rng.randn(E, H).astype(np.float32)
    x = rng.randn(E, OBS + ACT).astype(np.float32)
    ref = jax.jit(jax_gru_apply)(jp, jnp.asarray(h), jnp.asarray(x))
    out = gru_apply(p, torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the port's own init: the reference's layout and scales
    own = gru_init(torch.Generator().manual_seed(0), OBS + ACT, H)
    assert {g: sorted(v) for g, v in own.items()} == {
        g: ["b", "wh", "wx"] for g in ("h", "r", "z")}
    assert own["z"]["wx"].abs().max() <= 1.0 / np.sqrt(OBS + ACT)
    assert own["z"]["wh"].abs().max() <= 1.0 / np.sqrt(H)


@pytest.mark.parametrize("context", CONTEXTS)
def test_get_context_matches_jax_on_partly_valid_windows(context):
    jm, jparams, jnorm, model, params, norm = models(context)
    dobs, act, valid = window()
    ref = jax.jit(jm.get_context)(jparams, jnorm, *map(jnp.asarray,
                                                        (dobs, act, valid)))
    z = model.get_context(params, norm, *map(torch.from_numpy,
                                             (dobs, act, valid)))
    assert z.shape == (E, model.cfg.context_dim)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("context", CONTEXTS)
def test_push_history_and_context_from_history_match_jax(context):
    """Five pushes (past K, so the recurrent state outlives the window),
    ``rnn_h`` and the acting context against the reference's."""
    jm, jparams, jnorm, model, params, norm = models(context)
    jh = jax_batched_history(jm.cfg, E)
    th = batched_history(model.cfg, E)
    assert th.rnn_h.shape == (E, H if context == "rnn" else 0)
    push = jax.jit(jm.push_history)
    rng = np.random.RandomState(2)
    for _ in range(K + 1):
        obs, dobs = rng.randn(2, E, OBS).astype(np.float32)
        act = rng.uniform(-1, 1, (E, ACT)).astype(np.float32)
        jh = push(jparams, jnorm, jh, *map(jnp.asarray, (obs, dobs, act)))
        th = model.push_history(params, norm, th,
                                *map(torch.from_numpy, (obs, dobs, act)))
    for name in ("obs", "dobs", "act", "valid"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)), name)
    np.testing.assert_allclose(th.rnn_h.numpy(), np.asarray(jh.rnn_h),
                               atol=ATOL)
    np.testing.assert_allclose(
        model.context_from_history(params, norm, th).numpy(),
        np.asarray(jax.jit(jm.context_from_history)(jparams, jnorm, jh)),
        atol=ATOL)


@pytest.mark.parametrize("context", CONTEXTS)
def test_loss_and_gradient_match_jax(context):
    jm, jparams, jnorm, model, params, norm = models(context)
    b = batch_np(4)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, jnorm, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss, met = model.loss(params, norm, SegmentBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(met["fwd_mean_mse"].item(),
                               float(jmet["fwd_mean_mse"]), rtol=1e-6,
                               atol=ATOL)
    assert_trees_close(list(grads), jgrads, ATOL)


@pytest.mark.parametrize("context", CONTEXTS)
def test_update_matches_optax_from_a_mid_training_state(context):
    """One clip + Adam step from the state of three reference updates (so
    no gradient entry sits at Adam's first-step sign)."""
    jm = JaxDynamics(JaxConfig(**cfg(context)))
    jstate = dataclasses.replace(jm.init_state(jax.random.key(5)),
                                 norm=norm_np(1))
    jupdate = jax.jit(jm.update)
    to_jax = lambda b: JaxBatch(**{k: jnp.asarray(v)  # noqa: E731
                                   for k, v in b.items()})
    for s in range(3):
        jstate, _ = jupdate(jstate, to_jax(batch_np(10 + s)))
    params, norm = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.norm), "cpu")
    opt = adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state[1][0]),
                              "cpu")
    state = DynamicsState(params, norm, opt, int(jstate.updates))
    model = Dynamics(DynamicsConfig(**cfg(context)), "cpu")
    b = batch_np(20)
    jstate, jmet = jupdate(jstate, to_jax(b))
    state, met = model.update(state, SegmentBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}))
    np.testing.assert_allclose(met["model_loss"].item(),
                               float(jmet["model_loss"]), rtol=1e-6, atol=ATOL)
    assert state.opt_state.count == state.updates == 4
    assert_trees_close(state.params, jstate.params, ATOL)
    assert_trees_close(state.opt_state.mu, jstate.opt_state[1][0].mu, ATOL)
    assert_trees_close(state.opt_state.nu, jstate.opt_state[1][0].nu, ATOL)


def test_rnn_context_is_episode_recurrent():
    """As tests/test_rebal.py: two histories equal in their last K
    transitions and different before give different ReBAL contexts; the
    window encoder's are equal."""
    rng = np.random.RandomState(0)
    tail = rng.randn(K, E, OBS).astype(np.float32)
    heads = rng.randn(2, 2 * K, E, OBS).astype(np.float32)
    acts = rng.uniform(-1, 1, (3 * K, E, ACT)).astype(np.float32)

    def ctx(context, head):
        model = Dynamics(DynamicsConfig(**cfg(context)), "cpu")
        state = model.init_state(torch.Generator().manual_seed(0))
        h = batched_history(model.cfg, E)
        obs = torch.zeros(E, OBS)
        for d, a in zip(np.concatenate([head, tail]), acts):
            d = torch.from_numpy(d)
            h = model.push_history(state.params, state.norm, h, obs, d,
                                   torch.from_numpy(a))
            obs = obs + d
        return model.context_from_history(state.params, state.norm, h)

    assert (ctx("rnn", heads[0]) - ctx("rnn", heads[1])).abs().max() > 1e-5
    torch.testing.assert_close(ctx("encoder", heads[0]),
                               ctx("encoder", heads[1]), rtol=0, atol=1e-6)


def test_the_collect_wipes_the_recurrent_context_on_done():
    """A ReBAL collect on the cheetah: ``rnn_h`` runs across the episode
    (non-zero before the end) and is zero for every env whose episode just
    ended, as the rest of the window."""
    cfg_ = dataclasses.replace(
        PRESETS["halfcheetah_cadm_cem"], model="rnn", hidden=(8,), n_envs=2,
        eval_envs=2, n_candidates=4, plan_horizon=2, cem_iters=1,
        cem_elites=2, env_horizon=3, buffer_capacity=10, steps_per_itr=2)
    _, model, _, trainer = cfg_.build("cpu")
    gen = torch.Generator().manual_seed(0)
    states, hists, buf, dyn = trainer.init(gen)
    states, hists, buf, _ = trainer._collect(gen, states, hists, buf, dyn, True)
    assert hists.rnn_h.shape == (2, 64) and (hists.rnn_h != 0).any(1).all()
    states, hists, buf, _ = trainer._collect(gen, states, hists, buf, dyn,
                                             False)
    # step 3 of the second collect's 2 ended both episodes; step 4 is the new
    # episodes' first
    assert bool(buf.done[:, 2].all())
    assert (hists.valid.sum(1) == 1).all() and (hists.rnn_h != 0).any(1).all()
    states, hists, buf, _ = trainer._collect(
        gen, states, hists, buf, dyn, True)
    assert bool(buf.done[:, 5].all())
    assert (hists.rnn_h == 0).all() and (hists.valid == 0).all()
