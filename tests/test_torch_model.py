"""The port's CaDM model against the JAX model, with the JAX weights loaded.

Narrow width (heads (32, 32), the preset's encoder (256, 128)); weights are
initialized by the JAX package and converted with ``params_from_jax``;
normalization statistics and inputs are numpy draws shared by both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.core.types import History as JaxHistory
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu_torch.core.types import batched_history, tree_leaves
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.models.nets import member
from cadm_tpu_torch.utils.convert import (
    NORM_FIELDS,
    params_from_jax,
    params_to_numpy,
    ppo_state_from_jax,
    ppo_state_to_numpy,
)

# float32 matmul chains of ≤ 5 layers summed in another order than XLA's
ATOL = 1e-5
OBS, ACT, K, E = 17, 6, 10, 5
CFG = dict(obs_dim=OBS, act_dim=ACT, hidden=(32, 32), context="encoder")


def jax_model_and_port():
    jm = JaxDynamics(JaxConfig(**CFG))
    rng = np.random.RandomState(0)
    jnorm = JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                      for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS), (-1, 1, ACT),
                                        (0.5, 2, ACT), (-0.2, 0.2, OBS),
                                        (0.1, 1, OBS))))
    jparams = jm.init_params(jax.random.key(3))
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm), "cpu")
    return (jm, jparams, jnorm, Dynamics(DynamicsConfig(**CFG), "cpu"), params,
            norm)


def window(seed=1):
    rng = np.random.RandomState(seed)
    dobs = rng.randn(E, K, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (E, K, ACT)).astype(np.float32)
    valid = (rng.rand(E, K) > 0.3).astype(np.float32)
    return dobs, act, valid


def test_param_tree_matches_jax_layout():
    jm, jparams, _, model, params, _ = jax_model_and_port()
    own = model.init_params(torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(params) == ["bwd", "encoder", "fwd"]
    for key in own:
        for a, b in zip(own[key], params[key]):
            for leaf in ("w", "b"):
                assert a[leaf].shape == b[leaf].shape, (key, leaf)
    # mlp_init's truncated-normal scale: std 1/(2·sqrt(fan_in)), |w| ≤ 2σ
    w = own["fwd"][0]["w"]
    bound = 2.0 / (2.0 * np.sqrt(w.shape[-2]))
    assert w.abs().max() <= bound and torch.all(own["fwd"][0]["b"] == 0)


def test_params_round_trip_jax_port_numpy_jax_bit_for_bit():
    """``params_to_numpy`` inverts ``params_from_jax``: the JAX params and
    norm statistics come back as the same tree of float32 arrays, and the
    JAX model's prediction from them is the one from the originals."""
    jm, jparams, jnorm, _, params, norm = jax_model_and_port()
    back, back_norm = params_to_numpy(params, norm)
    flat, tree = jax.tree.flatten(jparams)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_back == tree and sorted(back_norm) == sorted(NORM_FIELDS)
    for a, b in zip(flat, flat_back):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))
    for f in NORM_FIELDS:
        np.testing.assert_array_equal(back_norm[f], np.asarray(getattr(jnorm, f)))
    rng = np.random.RandomState(4)
    obs = jnp.asarray(rng.randn(E, OBS).astype(np.float32))
    act = jnp.asarray(rng.uniform(-1, 1, (E, ACT)).astype(np.float32))
    z = jnp.asarray(rng.randn(E, 10).astype(np.float32))
    back = jax.tree.map(jnp.asarray, back)
    ref = jm.predict(jparams, jnorm, jax.tree.map(lambda x: x[0],
                                                   jparams["fwd"]), obs, act, z)
    got = jm.predict(back, JaxNorm(**{k: jnp.asarray(v)
                                      for k, v in back_norm.items()}),
                     jax.tree.map(lambda x: x[0], back["fwd"]), obs, act, z)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_ppo_state_round_trip_port_numpy_port_bit_for_bit():
    """``ppo_state_to_numpy`` inverts ``ppo_state_from_jax``: a JAX PPO
    state after three Adam steps (count, mu and nu all nonzero) comes back
    from the port as the same arrays where the JAX ``PPOState`` keeps them,
    and ``ppo_state_from_jax`` of that is the port's state again."""
    import optax

    from cadm_tpu.models.nets import mlp_init as jax_mlp_init
    from cadm_tpu.train.ppo import PPOState as JaxPPOState

    k1, k2 = jax.random.split(jax.random.key(3))
    params = {"policy": jax_mlp_init(k1, [OBS + 4, 16, 16, ACT]),
              "log_std": jnp.full((ACT,), -0.5, jnp.float32),
              "value": jax_mlp_init(k2, [OBS + 4, 16, 16, 1])}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    opt = tx.init(params)
    rng = np.random.RandomState(5)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
            params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    jstate = JaxPPOState(params=params, opt_state=opt,
                         updates=jnp.asarray(3, jnp.int32))
    port = ppo_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    back = ppo_state_to_numpy(port)
    adam, jadam = back.opt_state[1][0], jstate.opt_state[1][0]
    assert int(back.updates) == 3 and int(adam.count) == int(jadam.count) == 3
    assert back.updates.dtype == adam.count.dtype == np.int32
    for ours, ref in ((back.params, jstate.params), (adam.mu, jadam.mu),
                      (adam.nu, jadam.nu)):
        flat, tree = jax.tree.flatten(ref)
        flat_back, tree_back = jax.tree.flatten(ours)
        assert tree_back == tree
        for a, b in zip(flat, flat_back):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, np.asarray(a))
    again = ppo_state_from_jax(back, "cpu")
    assert again.updates == port.updates == 3
    assert again.opt_state.count.dtype == torch.int32
    assert torch.equal(again.opt_state.count, port.opt_state.count)
    for a, b in zip(tree_leaves(again.params) + tree_leaves(again.opt_state.mu)
                    + tree_leaves(again.opt_state.nu),
                    tree_leaves(port.params) + tree_leaves(port.opt_state.mu)
                    + tree_leaves(port.opt_state.nu)):
        assert torch.equal(a, b)


def test_get_context_matches_jax():
    jm, jparams, jnorm, model, params, norm = jax_model_and_port()
    dobs, act, valid = window()
    ref = jm.get_context(jparams, jnorm, jnp.asarray(dobs), jnp.asarray(act),
                         jnp.asarray(valid))
    z = model.get_context(params, norm, *map(torch.from_numpy,
                                             (dobs, act, valid)))
    assert z.shape == (E, 10)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), atol=ATOL)


def test_push_history_and_context_from_history_match_jax():
    jm, jparams, jnorm, model, params, norm = jax_model_and_port()
    rng = np.random.RandomState(2)
    jh = jax.vmap(lambda _: JaxHistory.zeros(K, OBS, ACT))(jnp.arange(E))
    th = batched_history(model.cfg, E)
    for _ in range(3):
        obs, dobs = rng.randn(2, E, OBS).astype(np.float32)
        act = rng.uniform(-1, 1, (E, ACT)).astype(np.float32)
        jh = jm.push_history(jparams, jnorm, jh, *map(jnp.asarray, (obs, dobs, act)))
        th = model.push_history(params, norm, th,
                                *map(torch.from_numpy, (obs, dobs, act)))
    for name in ("obs", "dobs", "act", "valid"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)), err_msg=name)
    np.testing.assert_allclose(
        model.context_from_history(params, norm, th).numpy(),
        np.asarray(jm.context_from_history(jparams, jnorm, jh)), atol=ATOL)


@pytest.mark.parametrize("rows", [1, 64])
def test_predict_matches_jax(rows):
    jm, jparams, jnorm, model, params, norm = jax_model_and_port()
    rng = np.random.RandomState(4)
    obs = rng.randn(rows, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (rows, ACT)).astype(np.float32)
    z = rng.randn(rows, 10).astype(np.float32)
    jfwd = jax.tree.map(lambda x: x[0], jparams["fwd"])
    ref = jm.predict(jparams, jnorm, jfwd, *map(jnp.asarray, (obs, act, z)))
    out = model.predict(params, norm, member(params["fwd"], 0),
                        *map(torch.from_numpy, (obs, act, z)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_vanilla_context_is_zero_width_and_ensembles_are_refused():
    model = Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, hidden=(8,)),
                     "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    assert sorted(params) == ["fwd"]
    dobs, act, valid = map(torch.from_numpy, window())
    z = model.get_context(params, model.init_state(torch.Generator()).norm,
                          dobs, act, valid)
    assert z.shape == (E, 0)
    # ensembles are ported (tests/test_torch_ensemble.py), and so are the
    # baselines' contexts (tests/test_torch_rebal_stacked.py), with members
    # too; what stays refused is a context the reference does not have
    for context, width in (("stacked", K * (OBS + ACT)), ("rnn", 10)):
        m = Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, n_members=5,
                                    context=context), "cpu")
        p = m.init_params(torch.Generator().manual_seed(0))
        assert p["fwd"][0]["w"].shape == (5, OBS + ACT + width, 200)
    with pytest.raises(ValueError, match="context"):
        Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, context="lstm"),
                 "cpu")
    ens = Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, n_members=5,
                                  probabilistic=True), "cpu")
    p = ens.init_params(torch.Generator().manual_seed(0))
    assert p["fwd"][-1]["w"].shape == (5, 200, 2 * OBS)
