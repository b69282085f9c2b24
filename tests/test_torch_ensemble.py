"""The port's 5-member probabilistic CaDM (PE-TS) against the JAX package's.

Weights come from the JAX side through ``utils.convert.params_from_jax``
(member-stacked heads and the learned ``max_logvar``/``min_logvar``), with the
log-variance bounds moved off their init values so that both soft bounds
bend. Covered: ``_head_out`` for one member and for all members at once,
``predict`` (the mean, and a sample with the JAX package's own normals
injected), the loss with ``mean_anchor`` ∈ {0, 1} and ``detach_logvar_trunk``
∈ {False, True}, its gradients (and that the detached logvar path trains no
trunk weight), and 20 optimizer steps with the global-norm clip firing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.models.dynamics import (
    Dynamics,
    DynamicsConfig,
    DynamicsState,
    SegmentBatch,
)
from cadm_tpu_torch.models.nets import member
from cadm_tpu_torch.utils.convert import adam_state_from_jax, params_from_jax

# float32 matmul chains of ≤ 4 layers, the NLL's exp(−logvar) and their
# gradients, summed in another order than XLA's (test_torch_fit.py's 1e-5)
ATOL = 1e-5
OBS, ACT, K, M, B, N = 8, 3, 3, 4, 8, 5
MODEL = dict(obs_dim=OBS, act_dim=ACT, hidden=(16, 16), context="encoder",
             history_k=K, future_m=M, n_members=N, probabilistic=True)
VARIANTS = [(a, d) for a in (0.0, 1.0) for d in (False, True)]


def norm_np(seed=0):
    rng = np.random.RandomState(seed)
    return JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS), (-1, 1, ACT),
                                       (0.5, 2, ACT), (-0.2, 0.2, OBS),
                                       (0.1, 1, OBS))))


def jax_params(jm, seed):
    """JAX init, with the logvar bounds moved to where both bend."""
    p = jm.init_params(jax.random.key(seed))
    rng = np.random.RandomState(seed)
    p["max_logvar"] = jnp.asarray(rng.uniform(-0.5, 0.5, OBS), jnp.float32)
    p["min_logvar"] = jnp.asarray(rng.uniform(-2.0, -1.0, OBS), jnp.float32)
    return p


def to_port(jparams, jnorm):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           jax.tree.map(np.asarray, jnorm), "cpu")


def batch_np(seed, target_scale=1.0):
    """An (N, B, ...) bootstrap segment batch with partly masked steps."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(N, B, *s).astype(np.float32)  # noqa: E731
    obs = f(M, OBS)
    return dict(
        hist_obs=f(K, OBS), hist_dobs=f(K, OBS),
        hist_act=rng.uniform(-1, 1, (N, B, K, ACT)).astype(np.float32),
        hist_valid=(rng.rand(N, B, K) > 0.3).astype(np.float32),
        obs=obs, act=rng.uniform(-1, 1, (N, B, M, ACT)).astype(np.float32),
        next_obs=obs + target_scale * 0.3 * f(M, OBS),
        valid=(rng.rand(N, B, M) > 0.2).astype(np.float32),
    )


def models(mean_anchor=1.0, detach=False):
    cfg = dict(MODEL, mean_anchor=mean_anchor, detach_logvar_trunk=detach)
    return JaxDynamics(JaxConfig(**cfg)), Dynamics(DynamicsConfig(**cfg), "cpu")


def close(a, b, atol=ATOL, **kw):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol,
                               **kw)


@pytest.mark.parametrize("detach", [False, True])
def test_head_out_and_predict_match_jax(detach):
    jm, model = models(detach=detach)
    jparams, jnorm = jax_params(jm, 0), norm_np()
    params, norm = to_port(jparams, jnorm)
    rng = np.random.RandomState(1)
    x, z = rng.randn(N, 6, OBS), rng.randn(N, 6, 10)
    a = rng.uniform(-1, 1, (N, 6, ACT))
    x, a, z = (v.astype(np.float32) for v in (x, a, z))
    tx, ta, tz = map(torch.from_numpy, (x, a, z))
    mean, logvar = model._head_out(params["fwd"], params, norm, tx, ta, tz)
    assert mean.shape == logvar.shape == (N, 6, OBS)
    keys = jax.random.split(jax.random.key(5), N)
    for m in range(N):
        jfwd = jax.tree.map(lambda p: p[m], jparams["fwd"])
        jmean, jlogvar = jm._head_out(jfwd, jparams, jnorm, x[m], a[m], z[m])
        close(mean[m], jmean)
        close(logvar[m], jlogvar)
        one = model._head_out(member(params["fwd"], m), params, norm, tx[m],
                              ta[m], tz[m])
        close(one[0], jmean)
        close(one[1], jlogvar)
        # predict: the mean, and a sample from the JAX package's normals
        close(model.predict(params, norm, member(params["fwd"], m), tx[m],
                            ta[m], tz[m]),
              jm.predict(jparams, jnorm, jfwd, x[m], a[m], z[m]))
        eps = jax.random.normal(keys[m], (6, OBS))
        close(model.predict(params, norm, member(params["fwd"], m), tx[m],
                            ta[m], tz[m], torch.from_numpy(np.array(eps))),
              jm.predict(jparams, jnorm, jfwd, x[m], a[m], z[m], keys[m]))
    assert (logvar <= params["max_logvar"]).all()
    assert (logvar >= params["min_logvar"]).all()


@pytest.mark.parametrize("mean_anchor,detach", VARIANTS)
def test_loss_and_gradients_match_jax(mean_anchor, detach):
    jm, model = models(mean_anchor, detach)
    jparams, jnorm = jax_params(jm, 1), norm_np()
    b = batch_np(2)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, jnorm, jb)
    params, norm = to_port(jparams, jnorm)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, met = model.loss(params, norm, SegmentBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=ATOL)
    assert sorted(met) == sorted(jmet) == ["fwd_mean_mse",
                                           "logvar_bound_penalty",
                                           "model_loss"]
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-6,
                                   atol=ATOL, err_msg=k)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        close(g, jg)


def test_detached_logvar_path_trains_no_trunk_weight():
    """Σ logvar's gradient: with the detach only the last layer's logvar
    columns (and the bounds) move; without it the trunk does too."""
    for detach in (False, True):
        jm, model = models(detach=detach)
        jparams, jnorm = jax_params(jm, 2), norm_np()
        params, norm = to_port(jparams, jnorm)
        rng = np.random.RandomState(3)
        x, z = rng.randn(N, 6, OBS), rng.randn(N, 6, 10)
        a = rng.uniform(-1, 1, (N, 6, ACT))
        x, a, z = (v.astype(np.float32) for v in (x, a, z))
        fwd = params["fwd"]
        for leaf in tree_leaves(fwd):
            leaf.requires_grad_(True)
        _, logvar = model._head_out(fwd, params, norm,
                                    *map(torch.from_numpy, (x, a, z)))
        grads = torch.autograd.grad(logvar.sum(), tree_leaves(fwd),
                                    allow_unused=True, materialize_grads=True)
        jg = jax.grad(lambda f: jm._head_out(
            jax.tree.map(lambda p: p[0], f), jparams, jnorm, x[0], a[0],
            z[0])[1].sum())(jparams["fwd"])
        for g, ref in zip(grads, jax.tree.leaves(jg)):
            close(g[0], np.asarray(ref)[0])
        # tree_leaves order per layer: b, w
        trunk = grads[:-2]
        last_b, last_w = grads[-2:]
        assert all((g == 0).all() for g in trunk) == detach
        assert (last_w[..., :OBS] == 0).all() and (last_b[..., :OBS] == 0).all()
        assert (last_w[..., OBS:] != 0).any()


def test_twenty_updates_match_optax_with_the_clip_firing():
    jm, model = models()
    jstate = dataclasses.replace(jm.init_state(jax.random.key(3)),
                                 norm=norm_np(1))
    jstate = dataclasses.replace(jstate, params=jax_params(jm, 3),
                                 opt_state=jm.tx.init(jax_params(jm, 3)))
    jupdate = jax.jit(jm.update)
    to_jb = lambda b: JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})  # noqa: E731
    for s in range(3):  # a mid-training Adam state: count 3, moments set
        jstate, _ = jupdate(jstate, to_jb(batch_np(100 + s)))
    params, norm = to_port(jstate.params, jstate.norm)
    opt = adam_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state[1][0]),
                              "cpu")
    state = DynamicsState(params, norm, opt, int(jstate.updates))

    batches = [batch_np(s, target_scale=40.0 if s == 7 else 1.0)
               for s in range(20)]
    g = jax.grad(lambda p: jm.loss(p, jstate.norm, to_jb(batches[7]))[0])(
        jstate.params)
    assert float(optax.global_norm(g)) > 10.0  # the clip branch runs
    for b in batches:
        jstate, jmet = jupdate(jstate, to_jb(b))
        state, met = model.update(state, SegmentBatch(
            **{k: torch.from_numpy(v) for k, v in b.items()}))
        for k in ("model_loss", "logvar_bound_penalty"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                       rtol=1e-5, atol=ATOL, err_msg=k)
    assert state.opt_state.count == int(jstate.opt_state[1][0].count) == 23
    for ours, ref in ((state.params, jstate.params),
                      (state.opt_state.mu, jstate.opt_state[1][0].mu),
                      (state.opt_state.nu, jstate.opt_state[1][0].nu)):
        leaves, jleaves = tree_leaves(ours), jax.tree.leaves(ref)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            close(a, b)
    # the logvar bounds are trained leaves, in the clip and in Adam
    assert not torch.equal(state.params["max_logvar"], params["max_logvar"])
