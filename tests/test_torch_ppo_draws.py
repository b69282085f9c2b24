"""The port's PPO + CaDM samplers against the JAX package's, as
distributions, at the half_cheetah cell's shapes (128 envs, T 256, 10
epochs × 8 minibatches, fit batches of 256 from a 4096-column ring).

The fixed-input tests (tests/test_torch_ppo_rigid.py and the others) hand
both packages the JAX draws, so they never run the port's own samplers.
Here each package draws from its own generator, through the code the
trainer runs where it can be driven alone: the port's ε through
``PPOTrainer._collect`` (a stub env, the policy's mean held at 0 and its
std at 0.01, so ε = act / 0.01 exactly), its permutations through
``_ppo_update`` (the minibatch step recorded), its segment anchors through
``ReplayBuffer.draw_indices`` + ``gather`` on a wrapped ring whose obs
record their own (column, env), and its initialisation through
``mlp_init``. The JAX side draws as its trainer does: ε and permutations
from the keys its collect and update split, anchors through
``sample_segments`` on the same marked ring, weights through ``mlp_init``.
Seeds are fixed, so each check is deterministic; a two-sample
Kolmogorov–Smirnov or χ² test holds the two distributions to p ≥ P_MIN.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cadm_tpu.models.nets import mlp_init as jax_mlp_init
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu_torch.core.types import EnvState
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.models.nets import mlp_init
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.ppo import PPOConfig, PPOTrainer

E, T, OBS, ACT = 128, 256, 17, 6          # the cheetah cell's collect
EPOCHS, MINIBATCHES = 10, 8
CAPACITY, FIT_BATCH, K, M = 4096, 256, 10, 10
P_MIN = 1e-3
SIGMA = 0.01                                # the stub policy's std


def ks(a, b):
    return scipy.stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue


class StubEnv:
    """An env that stands still: the collect's draws are the policy's ε
    alone."""
    obs_dim, act_dim, device = OBS, ACT, torch.device("cpu")

    def reset(self, gen, n, mode=0):
        return EnvState(None, torch.zeros(n, OBS), None,
                        torch.zeros(n, dtype=torch.int32),
                        torch.zeros(n, dtype=torch.bool))

    def step(self, states, act, gen, mode=0):
        n = act.shape[0]
        return (states, states.obs, torch.zeros(n),
                torch.zeros(n, dtype=torch.bool))

    def bad_transition(self, prev_obs, obs):
        return torch.zeros(obs.shape[0], dtype=torch.bool)


def port_trainer(**ppo):
    model = Dynamics(DynamicsConfig(obs_dim=OBS, act_dim=ACT, hidden=(8,),
                                    context="encoder", z_dim=2, history_k=2,
                                    future_m=2, encoder_hidden=(8,)), "cpu")
    cfg = PPOConfig(**{**dict(n_envs=E, rollout_len=T, policy_hidden=(8,),
                              ppo_epochs=EPOCHS, minibatches=MINIBATCHES,
                              buffer_capacity=T), **ppo})
    return PPOTrainer(StubEnv(), model, cfg)


def port_eps(seed=0):
    """(T, E, ACT) ε of one port collect, read back from its actions."""
    tr = port_trainer()
    gen = torch.Generator().manual_seed(seed)
    states, hists, buf, ps, dyn = tr.init(gen)
    ps.params["policy"][-1]["w"].zero_()
    ps.params["log_std"].fill_(math.log(SIGMA))
    traj = tr._collect(gen, states, hists, buf, ps, dyn)[3]
    return (traj["act"] / torch.exp(ps.params["log_std"])).numpy()


def jax_eps(seed=0):
    """The JAX collect's ε (cadm_tpu/train/ppo.py:162-163): step t's key
    of ``split(rng, T)``, split, first half."""
    keys = jax.random.split(jax.random.key(seed), T)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[0], (E, ACT)))(keys))


def test_collect_eps_is_the_jax_collects_standard_normal():
    """The port's ε against the JAX collect's: each a standard normal
    (moments within 5 SE of N(0, 1)), the same distribution (KS), no
    correlation between consecutive steps or between action dims."""
    ours, ref = port_eps(), jax_eps()
    assert ours.shape == ref.shape == (T, E, ACT)
    n = ours.size
    for eps in (ours, ref):
        assert abs(eps.mean()) < 5 / math.sqrt(n)
        assert abs(eps.var() - 1.0) < 5 * math.sqrt(2.0 / n)
        lag = np.corrcoef(eps[1:].ravel(), eps[:-1].ravel())[0, 1]
        dims = np.corrcoef(eps[..., 0].ravel(), eps[..., 1].ravel())[0, 1]
        assert abs(lag) < 5 / math.sqrt(n) and abs(dims) < 5 / math.sqrt(
            n / ACT)
    assert ks(ours, ref) >= P_MIN


def port_perms(t_len, e, seed=0, epochs=EPOCHS):
    """The rows of each minibatch of ``_ppo_update`` on a (t_len, e)
    rollout, (epochs, minibatches, mb), recorded at the minibatch step."""
    tr = port_trainer(ppo_epochs=epochs, rollout_len=t_len, n_envs=e)
    taken = []

    def step(state, flat, idx):
        taken.append(idx.clone())
        return state, torch.zeros(())

    tr._minibatch_step = step
    traj = {"value": torch.zeros(t_len, e), "reward": torch.ones(t_len, e),
            "done": torch.zeros(t_len, e, dtype=torch.bool)}
    tr._ppo_update(torch.Generator().manual_seed(seed), None, traj,
                   torch.zeros(e))
    mb = t_len * e // MINIBATCHES
    return torch.stack(taken).reshape(epochs, MINIBATCHES, mb).numpy()


def jax_perms(n_rows, seed=0, epochs=EPOCHS):
    """The JAX update's (cadm_tpu/train/ppo.py:264-290): a permutation per
    epoch key, its first mb·minibatches rows."""
    mb = n_rows // MINIBATCHES
    keys = jax.random.split(jax.random.key(seed), epochs)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_rows))(
        keys))
    return perms[:, :mb * MINIBATCHES].reshape(epochs, MINIBATCHES, mb)


def test_permutations_cover_every_row_at_the_cell_width():
    """T·E = 32768 rows, 8 minibatches of 4096: each epoch takes every row
    once, on both sides, and the row at each position is uniform
    (position against row: Spearman ρ ≈ 0; fixed points ~ Poisson(1) per
    epoch, summed over the epochs)."""
    n = T * E
    for perms in (port_perms(T, E), jax_perms(n)):
        assert perms.shape == (EPOCHS, MINIBATCHES, n // MINIBATCHES)
        flat = perms.reshape(EPOCHS, n)
        for p in flat:
            np.testing.assert_array_equal(np.sort(p), np.arange(n))
        rho = scipy.stats.spearmanr(np.tile(np.arange(n), EPOCHS),
                                    flat.ravel()).statistic
        assert abs(rho) < 5 / math.sqrt(n * EPOCHS)
        fixed = int((flat == np.arange(n)).sum())
        assert scipy.stats.poisson.sf(fixed - 1, EPOCHS) >= P_MIN
        assert scipy.stats.poisson.cdf(fixed, EPOCHS) >= P_MIN


def test_the_rows_a_short_epoch_takes_match_jax():
    """Where mb·minibatches < T·E (59 × 17 = 1003 rows: 8 minibatches of
    125 take 1000, 3 left out an epoch) the rows left out are uniform on
    both sides, and each minibatch's rows are one distribution of row
    indices in both packages (KS per minibatch)."""
    n, epochs = 1003, 400
    ours = port_perms(59, 17, seed=1, epochs=epochs)
    ref = jax_perms(n, seed=1, epochs=epochs)
    for perms in (ours, ref):
        left_out = []
        for p in perms.reshape(epochs, -1):
            assert np.unique(p).size == p.size == 1000
            left_out.extend(np.setdiff1d(np.arange(n), p))
        assert len(left_out) == 3 * epochs
        assert scipy.stats.kstest((np.array(left_out) + 0.5) / n,
                                  "uniform").pvalue >= P_MIN
    for j in range(MINIBATCHES):
        assert ks(ours[:, j], ref[:, j]) >= P_MIN


def marked_rings(ptr):
    """A full ring of the cell's shape that wrapped ``ptr`` columns ago
    (size CAPACITY, next write at ``ptr``), its obs recording (physical
    column, env) and every ep_step consecutive, in both packages."""
    cols = np.arange(CAPACITY, dtype=np.float32)
    obs = np.zeros((E, CAPACITY, 2), np.float32)
    obs[..., 0] = cols[None]
    obs[..., 1] = np.arange(E, dtype=np.float32)[:, None]
    logical = (np.arange(CAPACITY) - ptr) % CAPACITY
    ep_step = np.broadcast_to(logical, (E, CAPACITY)).astype(np.int32)
    zeros_b = np.zeros((E, CAPACITY), bool)
    act = np.zeros((E, CAPACITY, 1), np.float32)
    fields = (obs, act, obs, zeros_b, ep_step, zeros_b)
    port = ReplayBuffer(*(torch.from_numpy(np.array(x)) for x in fields),
                        ptr, CAPACITY)
    ref = JaxBuffer(*(jnp.asarray(x) for x in fields), jnp.int32(ptr),
                    jnp.int32(CAPACITY))
    return port, ref


def anchors_of(obs0, ptr):
    """(logical column, env) of each segment's first future obs."""
    col = np.asarray(obs0[..., 0]).astype(np.int64).ravel()
    env = np.asarray(obs0[..., 1]).astype(np.int64).ravel()
    return (col - ptr) % CAPACITY, env


@pytest.mark.parametrize("split", ["train", "valid"])
def test_segment_anchors_after_a_wrap_match_jax(split):
    """On a ring that wrapped 256 columns ago (iteration 16's ring), 100
    fit batches of (1, 256): the logical anchor columns land only in the
    split's partition (every 10th for valid) and are uniform over it, the
    envs uniform, on both sides, and the two packages' anchors are one
    distribution (KS on columns and on envs)."""
    ptr, draws = 256, 100
    port, ref = marked_rings(ptr)
    gen = torch.Generator().manual_seed(0)
    ours = [port.gather(*port.draw_indices(gen, (1, FIT_BATCH), split),
                        K, M).obs[..., 0, :] for _ in range(draws)]
    sample = jax.jit(jax.vmap(lambda k: ref.sample_segments(
        k, (1, FIT_BATCH), K, M, split=split).obs[..., 0, :]))
    theirs = sample(jax.random.split(jax.random.key(0), draws))
    (col, env), (jcol, jenv) = (anchors_of(torch.stack(ours).numpy(), ptr),
                                anchors_of(np.asarray(theirs), ptr))
    valid_col = np.arange(CAPACITY) % 10 == 9
    n_anchors = int(valid_col.sum()) if split == "valid" else int(
        (~valid_col).sum())
    for c, e in ((col, env), (jcol, jenv)):
        assert c.size == draws * FIT_BATCH
        assert np.all(valid_col[c] == (split == "valid"))
        counts = np.bincount(c, minlength=CAPACITY)[
            valid_col if split == "valid" else ~valid_col]
        assert counts.size == n_anchors
        assert scipy.stats.chisquare(counts).pvalue >= P_MIN
        assert scipy.stats.chisquare(np.bincount(e, minlength=E)).pvalue \
            >= P_MIN
    assert ks(col, jcol) >= P_MIN and ks(env, jenv) >= P_MIN


# the truncated normal on [-2, 2]: its variance
TRUNC_VAR = 1.0 - 2.0 * 2.0 * scipy.stats.norm.pdf(2.0) / (
    scipy.stats.norm.cdf(2.0) - scipy.stats.norm.cdf(-2.0))


@pytest.mark.parametrize("sizes", [[27, 64, 64, 6], [33, 200, 200, 200, 200,
                                                     17]],
                         ids=["policy", "model_head"])
def test_truncated_normal_init_matches_jax(sizes):
    """``mlp_init`` at the policy's and a CaDM head's widths: each layer's
    weights × 2√fan_in lie in [-2, 2] with the truncated normal's variance
    (within 5 SE), biases 0, and the two packages' weights are one
    distribution (KS per layer)."""
    ours = mlp_init(torch.Generator().manual_seed(0), sizes)
    ref = jax.jit(jax_mlp_init, static_argnums=1)(jax.random.key(0),
                                                  tuple(sizes))
    for n_in, layer, jlayer in zip(sizes[:-1], ours, ref):
        w = layer["w"].numpy() * 2.0 * math.sqrt(n_in)
        jw = np.asarray(jlayer["w"]) * 2.0 * math.sqrt(n_in)
        assert w.shape == jw.shape
        assert not layer["b"].any() and not np.asarray(jlayer["b"]).any()
        for x in (w, jw):
            assert np.abs(x).max() <= 2.0 + 1e-5
            # var of x² over n: E[x⁴] − E[x²]² ≤ 3 for this law
            assert abs(x.var() - TRUNC_VAR) < 5 * math.sqrt(3.0 / x.size)
        assert ks(w, jw) >= P_MIN


def test_stub_env_leaves_the_actions_unclipped():
    """ε = act / σ holds only where no action was clipped: |σ·ε| < 1."""
    eps = port_eps(seed=3)
    assert np.abs(eps).max() * SIGMA < 1.0
