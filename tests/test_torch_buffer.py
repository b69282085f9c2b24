"""The port's replay ring against the JAX package's.

Appends through a wrap past capacity must leave every field, ``ptr`` and
``size`` identical. Segment sampling is compared with the same indices: the
JAX package draws them inside ``sample_segments`` from its key, so the test
rebuilds that draw (``buffer.py:133-151``) and hands the port the same uniform
anchors; the segments, masks included, must then be identical. The norm
statistics are float32 sums over the ring, compared at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu.train.buffer import masked_mean_std as jax_masked_mean_std
from cadm_tpu_torch.train.buffer import ReplayBuffer, masked_mean_std

E, S, OBS, ACT, K, M = 3, 23, 4, 2, 3, 4
SEGMENT_FIELDS = ("hist_obs", "hist_dobs", "hist_act", "hist_valid", "obs",
                  "act", "next_obs", "valid")
STATS_ATOL = 1e-6


def filled(n_appends, seed=0):
    """The same random stream appended to both rings: episodes of random
    lengths (done, ep_step) and a few bad transitions."""
    rng = np.random.RandomState(seed)
    jbuf = JaxBuffer.create(E, S, OBS, ACT)
    buf = ReplayBuffer.create(E, S, OBS, ACT, "cpu")
    ep = np.zeros(E, np.int32)
    for _ in range(n_appends):
        obs = rng.randn(E, OBS).astype(np.float32)
        act = rng.uniform(-1, 1, (E, ACT)).astype(np.float32)
        nxt = obs + 0.1 * rng.randn(E, OBS).astype(np.float32)
        done = rng.rand(E) < 0.15
        bad = rng.rand(E) < 0.05
        es = ep.copy()
        ep = np.where(done, 0, ep + 1).astype(np.int32)
        jbuf = jbuf.append(*map(jnp.asarray, (obs, act, nxt, done, es, bad)))
        buf.append(*map(torch.from_numpy, (obs, act, nxt, done, es, bad)))
    return jbuf, buf


@pytest.mark.parametrize("n_appends", [5, S, 2 * S + 7])
def test_append_matches_jax_through_the_wrap(n_appends):
    jbuf, buf = filled(n_appends)
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    for name in ("obs", "act", "next_obs", "done", "ep_step", "bad"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)),
                                      err_msg=name)
    assert (buf.n_train_anchors(), buf.n_valid_anchors()) == (
        int(jbuf.n_train_anchors()), int(jbuf.n_valid_anchors()))


def jax_draws(jbuf, key, shape, split):
    """(env_idx, u) as JaxBuffer.sample_segments draws them from ``key``."""
    r_env, r_t = jax.random.split(key)
    env_idx = jax.random.randint(r_env, shape, 0, jbuf.n_envs)
    high = {None: jbuf.size, "train": jbuf.n_train_anchors(),
            "valid": jbuf.n_valid_anchors()}[split]
    u = jax.random.randint(r_t, shape, 0, jnp.maximum(high, 1))
    return torch.tensor(np.asarray(env_idx)), torch.tensor(np.asarray(u))


@pytest.mark.parametrize("split", [None, "train", "valid"])
@pytest.mark.parametrize("n_appends", [15, 2 * S + 7])
def test_gather_matches_jax_with_the_same_indices(split, n_appends):
    jbuf, buf = filled(n_appends, seed=1)
    shape = (1, 64)
    key = jax.random.key(n_appends)
    ref = jbuf.sample_segments(key, shape, K, M, split=split)
    env_idx, u = jax_draws(jbuf, key, shape, split)
    t_idx = buf.anchor_columns(u, split)
    if split == "valid":
        assert torch.all(t_idx % ReplayBuffer.VALID_STRIDE == 9)
    if split == "train":
        assert torch.all(t_idx % ReplayBuffer.VALID_STRIDE != 9)
    seg = buf.gather(env_idx, t_idx, K, M)
    for name in SEGMENT_FIELDS:
        got = getattr(seg, name)
        assert got.shape == getattr(ref, name).shape, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # the masks are not trivial: both real and masked slots occur
    assert 0 < seg.valid.mean() < 1 and 0 < seg.hist_valid.mean() < 1


@pytest.mark.parametrize("split", ["train", "valid"])
def test_bootstrap_draws_of_five_members_match_jax(split):
    """The PE-TS batch shape (n_members, B): every member's indices are
    drawn independently (the bootstrap), and the gather takes them as the
    JAX package's ``sample_segments`` does."""
    jbuf, buf = filled(2 * S + 7, seed=4)
    shape = (5, 16)
    key = jax.random.key(5)
    ref = jbuf.sample_segments(key, shape, K, M, split=split)
    env_idx, u = jax_draws(jbuf, key, shape, split)
    seg = buf.gather(env_idx, buf.anchor_columns(u, split), K, M)
    for name in SEGMENT_FIELDS:
        np.testing.assert_array_equal(getattr(seg, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    env_idx, t_idx = buf.draw_indices(torch.Generator().manual_seed(0), shape,
                                      split)
    assert env_idx.shape == t_idx.shape == shape
    assert len({tuple(row) for row in t_idx.tolist()}) == 5


def test_draw_indices_stay_in_their_split():
    _, buf = filled(2 * S + 7, seed=2)
    gen = torch.Generator().manual_seed(0)
    for split, ok in (("train", lambda t: t % 10 != 9),
                      ("valid", lambda t: t % 10 == 9),
                      (None, lambda t: t >= 0)):
        env_idx, t_idx = buf.draw_indices(gen, (1, 500), split)
        assert env_idx.min() >= 0 and env_idx.max() < E
        assert t_idx.min() >= 0 and t_idx.max() < buf.size
        assert torch.all(ok(t_idx)), split
    with pytest.raises(ValueError):
        buf.draw_indices(gen, (1, 2), "test")


@pytest.mark.parametrize("n_appends", [7, 2 * S + 7])
def test_norm_statistics_match_jax(n_appends):
    jbuf, buf = filled(n_appends, seed=3)
    jin, tin = jbuf.norm_inputs(), buf.norm_inputs()
    np.testing.assert_array_equal(tin[3].numpy(), np.asarray(jin[3]))
    for jx, x in zip(jin[:3], tin[:3]):
        jm, js = jax_masked_mean_std(jx, jin[3])
        m, s = masked_mean_std(x, tin[3])
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=STATS_ATOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=STATS_ATOL)


def test_masked_mean_std_is_the_population_std():
    x = torch.tensor([[1.0], [3.0], [100.0]])
    mean, std = masked_mean_std(x, torch.tensor([True, True, False]))
    assert mean.item() == 2.0
    assert abs(std.item() - (np.sqrt(1.0 + 1e-6) + 1e-6)) < 1e-7
