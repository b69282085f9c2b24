"""The port's symmetry-group augmentation (``TrainerConfig.symmetry_aug``)
against the JAX trainer's, on CrippleAnt's 4-fold leg relabeling.

``_symmetrize_stats`` and the symmetrized norm refresh are compared on the
same replay ring; the augmented minibatch on the same segments with the
group indices the JAX trainer draws from its key (rebuilt here and handed to
the port).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.ant import CrippleAntEnv as JaxCrippleAnt
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu.train.mb_trainer import MBTrainer as JaxTrainer
from cadm_tpu.train.mb_trainer import TrainerConfig as JaxTrainerConfig
from cadm_tpu.train.mb_trainer import _symmetrize_stats as jax_symmetrize
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig, SegmentBatch
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.mb_trainer import (
    MBTrainer,
    TrainerConfig,
    _symmetrize_stats,
)

# float32 sums over a few hundred rows and over the 4 group elements
ATOL = 1e-5
OBS, ACT, K, M, B, N = 27, 8, 3, 4, 6, 2
MODEL = dict(obs_dim=OBS, act_dim=ACT, hidden=(16,), context="encoder",
             history_k=K, future_m=M, n_members=N, probabilistic=True)
TRAINER = dict(n_envs=3, batch_size=B, buffer_capacity=20, symmetry_aug=True)


def trainers():
    plan = dict(kind="cem", horizon=2, n_candidates=4, cem_iters=1,
                cem_elites=2)
    jenv = JaxCrippleAnt()
    jm = JaxDynamics(JaxConfig(**MODEL))
    jtr = JaxTrainer(jenv, jm, JaxPlanner(JaxPlannerConfig(**plan), jm,
                                          jenv.reward, ACT),
                     JaxTrainerConfig(**TRAINER))
    env = make("cripple_ant", device="cpu")
    model = Dynamics(DynamicsConfig(**MODEL), "cpu")
    tr = MBTrainer(env, model, MPCPlanner(PlannerConfig(**plan), model,
                                          env.reward, ACT),
                   TrainerConfig(**TRAINER))
    return jtr, tr


def filled_buffers(n_appends=17, seed=0):
    rng = np.random.RandomState(seed)
    n, cap = TRAINER["n_envs"], TRAINER["buffer_capacity"]
    jbuf = JaxBuffer.create(n, cap, OBS, ACT)
    buf = ReplayBuffer.create(n, cap, OBS, ACT, "cpu")
    ep = np.zeros(n, np.int32)
    for _ in range(n_appends):
        obs = (rng.randn(n, OBS) + rng.randn(OBS)).astype(np.float32)
        act = rng.uniform(-1, 1, (n, ACT)).astype(np.float32)
        nxt = (obs + 0.1 * rng.randn(n, OBS)).astype(np.float32)
        done = rng.rand(n) < 0.1
        bad = rng.rand(n) < 0.05
        es = ep.copy()
        ep = np.where(done, 0, ep + 1).astype(np.int32)
        jbuf = jbuf.append(*map(jnp.asarray, (obs, act, nxt, done, es, bad)))
        buf.append(*map(torch.from_numpy, (obs, act, nxt, done, es, bad)))
    return jbuf, buf


@pytest.mark.parametrize("key", ["obs", "act"])
def test_symmetrize_stats_matches_jax(key):
    maps = make("cripple_ant", device="cpu").symmetry_maps()[key]
    rng = np.random.RandomState(1)
    d = maps.shape[-1]
    mean = rng.randn(d).astype(np.float32)
    std = rng.uniform(0.1, 2.0, d).astype(np.float32)
    m32 = maps.astype(np.float32)
    ref_m, ref_s = jax_symmetrize(jnp.asarray(m32), jnp.asarray(mean),
                                  jnp.asarray(std))
    out_m, out_s = _symmetrize_stats(*map(torch.from_numpy, (m32, mean, std)))
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), atol=ATOL)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=ATOL)


def test_symmetrized_norm_refresh_matches_jax():
    jtr, tr = trainers()
    jbuf, buf = filled_buffers()
    jstate = jtr.model.init_state(jax.random.key(0))
    jnorm = jtr._refresh_norm(jbuf, jstate).norm
    state = tr.model.init_state(torch.Generator().manual_seed(0))
    norm = tr._refresh_norm(buf, state).norm
    for f in dataclasses.fields(norm):
        np.testing.assert_allclose(getattr(norm, f.name).numpy(),
                                   np.asarray(getattr(jnorm, f.name)),
                                   atol=ATOL, err_msg=f.name)


def test_augmented_minibatch_matches_jax_with_fixed_group_indices():
    jtr, tr = trainers()
    jbuf, buf = filled_buffers()
    key = jax.random.key(4)
    # the JAX trainer's _sample: segments from r_seg, group indices from r_aug
    r_seg, r_aug = jax.random.split(key)
    raw = jbuf.sample_segments(r_seg, (N, B), K, M, split="train")
    ref = jtr._sample(jbuf, key, "train")
    kidx = jax.random.randint(r_aug, (N, B), 0, 4)
    assert len(set(np.asarray(kidx).ravel().tolist())) > 1
    batch = SegmentBatch(**{f.name: torch.from_numpy(np.array(
        getattr(raw, f.name))) for f in dataclasses.fields(raw)})
    out = tr._augment(batch, torch.from_numpy(np.array(kidx)).long())
    for f in dataclasses.fields(JaxBatch):
        np.testing.assert_allclose(getattr(out, f.name).numpy(),
                                   np.asarray(getattr(ref, f.name)),
                                   atol=ATOL, err_msg=f.name)
    # the valid flags and windows are untouched by the relabeling
    assert torch.equal(out.valid, batch.valid)
    assert torch.equal(out.hist_valid, batch.hist_valid)


def test_train_step_augments_only_train_batches_and_symmetry_needs_maps():
    _, tr = trainers()
    _, buf = filled_buffers()
    gen = torch.Generator().manual_seed(0)
    state = tr._refresh_norm(buf, tr.model.init_state(gen))
    state, loss = tr._train_step(buf, gen, state)
    assert torch.isfinite(loss) and state.updates == 1
    env = make("ant", device="cpu")  # no symmetry group
    model = Dynamics(DynamicsConfig(**MODEL), "cpu")
    with pytest.raises(ValueError, match="symmetry_maps"):
        MBTrainer(env, model, MPCPlanner(PlannerConfig(), model, env.reward,
                                         ACT), TrainerConfig(**TRAINER))
