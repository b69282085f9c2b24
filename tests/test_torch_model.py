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
from cadm_tpu_torch.core.types import batched_history
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.models.nets import member
from cadm_tpu_torch.utils.convert import params_from_jax

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
                                   jax.tree.map(np.asarray, jnorm))
    return jm, jparams, jnorm, Dynamics(DynamicsConfig(**CFG)), params, norm


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
    model = Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, hidden=(8,)))
    params = model.init_params(torch.Generator().manual_seed(0))
    assert sorted(params) == ["fwd"]
    dobs, act, valid = map(torch.from_numpy, window())
    z = model.get_context(params, model.init_state(torch.Generator()).norm,
                          dobs, act, valid)
    assert z.shape == (E, 0)
    with pytest.raises(NotImplementedError):
        Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, n_members=5))
