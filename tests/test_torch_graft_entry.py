"""The port's ``graft_entry.entry`` against the reference's
``__graft_entry__.entry()``: the JAX ``fn`` under ``jax.jit`` and the port's
``fn`` on the same weights (the JAX state's, through ``params_from_jax``)
and the same seeded numpy inputs at B=256 (histories with some invalid
slots), for the JAX state's identity normalization and a seeded one; the
example args' shapes and the parameter tree's against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu_torch import graft_entry
from cadm_tpu_torch.utils.convert import params_from_jax

# float32 matmul chains of ≤ 5 layers summed in another order than XLA's
# (tests/test_torch_model.py)
ATOL = 1e-5


@pytest.fixture(scope="module")
def both():
    jfn, jargs = jax_entry.entry()
    fn, args = graft_entry.entry("cpu")
    return jax.jit(jfn), jargs, fn, args


def shapes(tree):
    return [tuple(np.shape(x)) for x in jax.tree.leaves(tree)]


def test_example_args_match_the_reference(both):
    _, jargs, _, args = both
    jparams, jnorm, *jrest = jargs
    params, norm, *rest = args
    assert sorted(params) == sorted(jparams)
    for key in jparams:
        assert shapes(params[key]) == shapes(jparams[key]), key
    for f in ("obs_mean", "obs_std", "act_mean", "act_std", "dobs_mean",
              "dobs_std"):
        np.testing.assert_array_equal(getattr(norm, f).numpy(),
                                      np.asarray(getattr(jnorm, f)))
    assert [tuple(x.shape) for x in rest] == [x.shape for x in jrest]
    for x, jx in zip(rest, jrest):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert rest[0].shape[0] == graft_entry.B == 256


@pytest.mark.parametrize("seeded_norm", [False, True])
def test_forward_matches_the_reference(both, seeded_norm):
    jfn, jargs, fn, _ = both
    jparams, jnorm = jargs[:2]
    b, k, obs_dim, act_dim = jargs[2].shape[0], 10, 17, 6
    rng = np.random.RandomState(7)
    if seeded_norm:
        jnorm = JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                          for lo, hi, n in ((-1, 1, obs_dim), (0.5, 2, obs_dim),
                                            (-1, 1, act_dim), (0.5, 2, act_dim),
                                            (-0.2, 0.2, obs_dim),
                                            (0.1, 1, obs_dim))))
    inputs = (
        rng.randn(b, k, obs_dim).astype(np.float32),
        rng.uniform(-1, 1, (b, k, act_dim)).astype(np.float32),
        (rng.rand(b, k) > 0.3).astype(np.float32),
        rng.randn(b, obs_dim).astype(np.float32),
        rng.uniform(-1, 1, (b, act_dim)).astype(np.float32),
    )
    assert 0 < inputs[2].sum() < inputs[2].size
    ref = np.asarray(jfn(jparams, jnorm, *map(jnp.asarray, inputs)))
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm), "cpu")
    with torch.no_grad():
        out = fn(params, norm, *map(torch.from_numpy, inputs))
    assert out.shape == ref.shape == (b, obs_dim)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    assert graft_entry.dryrun_multichip.__module__ == \
        "cadm_tpu_torch.parallel.dryrun"
