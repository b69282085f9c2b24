"""The port's HalfCheetah env against the JAX env.

Stepping is compared at fixed states, actions and hidden params, train
scales and the extreme corners. Sampling cannot reproduce ``jax.random``
bit for bit, so resets are checked by what they may produce: every mode
draws only from its own CANONICAL_SET values, each value and each (mass,
damping) pair as often as a uniform draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.core.types import EnvState as JaxEnvState
from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.envs.rigid_base import MassDampingParams as JaxParams
from cadm_tpu.envs.rigid_base import RigidPhys as JaxPhys
from cadm_tpu_torch.core.types import EnvState
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.envs.ranges import CANONICAL_RANGE, CANONICAL_SET
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from tests.torch_families_common import CORNERS, active_contacts

# float32 physics through one control step (see test_torch_physics.py for
# the measured ~2e-6); obs are qpos/qvel, rewards their linear function
OBS_ATOL, REW_ATOL = 1e-4, 1e-4
N = 4


def fixed_batch():
    env = JaxCheetah()
    rng = np.random.RandomState(0)
    qpos = (env.sys.default_qpos() + rng.uniform(-0.1, 0.1, (N, env.sys.nq)))
    qvel = 0.1 * rng.randn(N, env.sys.nv)
    qvel[3, 2] = 2e3              # env 3 is past QVEL_BLOWUP: unstable → done
    ms = np.array([0.75, 1.0, 1.25, 0.85])
    ds = np.array([1.15, 0.75, 1.0, 1.25])
    t = np.array([0, 5, 999, 1], np.int32)   # env 2 reaches the horizon
    act = rng.uniform(-1, 1, (N, env.sys.nu))
    act[1, 0] = 3.0               # clipped to the action box
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return env, f32(qpos), f32(qvel), f32(ms), f32(ds), t, f32(act)


JAX_ENV = JaxCheetah()
# one jitted step for every test of this file (same batch shape)
_jax_env_step = jax.jit(jax.vmap(JAX_ENV.step))


def both_states(qpos, qvel, ms, ds, t):
    """The same env states in both packages."""
    jphys = JaxPhys(jnp.asarray(qpos), jnp.asarray(qvel))
    jparams = JaxParams(jnp.asarray(ms), jnp.asarray(ds))
    jstate = JaxEnvState(phys=jphys, obs=jax.vmap(JAX_ENV.observe)(jparams, jphys),
                         params=jparams, t=jnp.asarray(t),
                         rng=jax.random.split(jax.random.key(0), N),
                         done=jnp.zeros(N, bool))
    env = HalfCheetahEnv(device="cpu")
    phys = RigidPhys(torch.from_numpy(qpos), torch.from_numpy(qvel))
    params = MassDampingParams(torch.from_numpy(ms), torch.from_numpy(ds))
    state = EnvState(phys=phys, obs=env.observe(params, phys), params=params,
                     t=torch.from_numpy(t), done=torch.zeros(N, dtype=torch.bool))
    return jstate, env, state


def test_step_matches_jax_and_auto_resets():
    _, qpos, qvel, ms, ds, t, act = fixed_batch()
    jstate, env, state = both_states(qpos, qvel, ms, ds, t)
    _, jobs, jrew, jdone = _jax_env_step(jstate, jnp.asarray(act))
    params = state.params
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))
    nxt, obs, rew, done = env.step(state, torch.from_numpy(act),
                                   torch.Generator().manual_seed(0))

    # env 3 blew up: both packages emit some sanitized, finite obs
    np.testing.assert_allclose(obs[:3].numpy(), np.asarray(jobs)[:3],
                               atol=OBS_ATOL)
    np.testing.assert_allclose(rew[:3].numpy(), np.asarray(jrew)[:3],
                               atol=REW_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done.tolist() == [False, False, True, True]
    # running envs carry the stepped state; done envs are freshly reset
    assert nxt.t.tolist() == [1, 6, 0, 0] and torch.equal(nxt.done, done)
    assert torch.equal(nxt.obs[:2], obs[:2])
    assert torch.equal(nxt.params.mass_scale[:2], params.mass_scale[:2])
    fresh = nxt.phys.qpos[2:] - torch.tensor(env.sys.default_qpos()).float()
    assert fresh.abs().max() <= 0.1 + 1e-6
    assert torch.equal(nxt.obs[2:], env.observe(nxt.params, nxt.phys)[2:])
    assert torch.isfinite(obs).all() and obs.abs().max() <= 1e4


def test_step_matches_jax_at_eval_scales():
    """Three control steps at the extreme corners of (mass, damping), roots
    lowered so that each env touches the ground: obs, reward and done after
    each step."""
    rng = np.random.RandomState(1)
    sys_ = JAX_ENV.sys
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (N, sys_.nq))
    qpos[:, 1] -= np.linspace(0.15, 0.3, N)
    qvel = 0.1 * rng.randn(N, sys_.nv)
    ms, ds = np.array(CORNERS).T
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    qpos, qvel, ms, ds = map(f32, (qpos, qvel, ms, ds))
    assert active_contacts("half_cheetah", qpos).min() >= 1
    jstate, env, state = both_states(qpos, qvel, ms, ds,
                                     np.array([0, 5, 10, 1], np.int32))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        act = f32(rng.uniform(-1, 1, (N, sys_.nu)))
        jstate, jobs, jrew, jdone = _jax_env_step(jstate, jnp.asarray(act))
        state, obs, rew, done = env.step(state, torch.from_numpy(act), gen)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=OBS_ATOL)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=REW_ATOL)
        assert not done.any() and not np.asarray(jdone).any()
    assert torch.equal(state.params.mass_scale, torch.from_numpy(ms))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_reset_draws_each_scale_and_pair_uniformly(mode):
    """4096 resets: each value's count, and each (mass, damping) pair's, is
    within 5σ of uniform, so mass and damping are drawn apart (not the
    same value row for row)."""
    n = 4096
    env = make("half_cheetah", device="cpu")
    state = env.reset(torch.Generator().manual_seed(10 + mode), n, mode)
    vals = np.float32((CANONICAL_SET.train, CANONICAL_SET.moderate,
                       CANONICAL_SET.extreme)[mode])
    idx = [np.searchsorted(vals, x.numpy()) for x in (
        state.params.mass_scale, state.params.damping_scale)]
    k = len(vals)
    for counts, p in ((np.bincount(i, minlength=k), 1 / k) for i in idx):
        assert counts.sum() == n
        assert np.abs(counts - n * p).max() <= 5 * np.sqrt(n * p * (1 - p))
    pairs = np.bincount(idx[0] * k + idx[1], minlength=k * k)
    p = 1 / k ** 2
    assert np.abs(pairs - n * p).max() <= 5 * np.sqrt(n * p * (1 - p))
    assert (idx[0] != idx[1]).mean() > 0.5


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_reset_samples_only_the_modes_set(mode):
    env = make("half_cheetah", device="cpu")
    state = env.reset(torch.Generator().manual_seed(mode), 4096, mode)
    allowed = (CANONICAL_SET.train, CANONICAL_SET.moderate,
               CANONICAL_SET.extreme)[mode]
    for x in (state.params.mass_scale, state.params.damping_scale):
        got = sorted(set(np.round(x.numpy().astype(np.float64), 6)))
        assert got == sorted(np.round(np.float32(allowed).astype(np.float64), 6))
    assert state.obs.shape == (4096, 17) and state.t.eq(0).all()
    assert (state.phys.qvel.std() - 0.1).abs() < 0.01


def test_continuous_bands_stay_in_their_bands():
    gen = torch.Generator().manual_seed(0)
    train = CANONICAL_RANGE.sample(gen, 0, 2000)
    assert train.min() >= 0.75 and train.max() <= 1.25
    ext = CANONICAL_RANGE.sample(gen, 2, 2000)
    assert ((ext >= 0.2) & (ext <= 0.4) | (ext >= 1.6) & (ext <= 1.8)).all()
    assert (ext < 1).any() and (ext > 1).any()


def test_bad_transition_matches_jax():
    jenv, env = JaxCheetah(), HalfCheetahEnv(device="cpu")
    rng = np.random.RandomState(3)
    obs = rng.randn(64, 17).astype(np.float32) * 60
    nxt = obs + rng.randn(64, 17).astype(np.float32) * 40
    np.testing.assert_array_equal(
        env.bad_transition(torch.from_numpy(obs), torch.from_numpy(nxt)).numpy(),
        np.asarray(jenv.bad_transition(jnp.asarray(obs), jnp.asarray(nxt))))


def test_unknown_env_is_not_ported():
    """Every family of the reference is ported (cartpole and pendulum
    too); a name outside the registry is a ``KeyError``, as in the
    reference's ``make``."""
    for name in ("cartpole", "pendulum"):
        assert make(name, device="cpu").horizon == 200
    with pytest.raises(KeyError, match="walker"):
        make("walker", device="cpu")
