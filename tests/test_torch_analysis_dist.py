"""The port's distribution-shift probe (``cadm_tpu_torch/analysis/
probe_dist.py``) against scripts/probe_dist.py: the shared Δobs std of a
ring and ``score_on_buffer`` of a 5-member cartpole PE-TS + CaDM snapshot
on the same ring contents (seeded, with episode ends and an unhealthy
column) and the same segment indices, rebuilt from the script's keys
(``split(rng, batches)``, then ``sample_segments``' env and anchor draws):
within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_analysis_common import jax_cell, snapshots
from scripts.probe_dist import score_on_buffer as jax_score
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu_torch.analysis import probe_dist
from cadm_tpu_torch.analysis.snapshot import load_cell
from cadm_tpu_torch.train.buffer import ReplayBuffer

CELL = "cartpole__pets_cadm__s0"
E, S, FILLED, BATCHES, BATCH = 4, 24, 18, 3, 16
RTOL = 1e-5


def rings():
    """The same seeded transitions in both packages' rings: episodes of 7
    steps, one unhealthy column."""
    rng = np.random.RandomState(0)
    jbuf = JaxBuffer.create(E, S, 5, 1)
    buf = ReplayBuffer.create(E, S, 5, 1, "cpu")
    for t in range(FILLED):
        obs = rng.randn(E, 5).astype(np.float32)
        act = rng.uniform(-1, 1, (E, 1)).astype(np.float32)
        nobs = (obs + 0.1 * rng.randn(E, 5)).astype(np.float32)
        ep_step = np.full(E, t % 7, np.int32)
        done = ep_step == 6
        bad = np.zeros(E, bool)
        if t == 9:
            bad[1] = True
        cols = (obs, act, nobs, done, ep_step, bad)
        jbuf = jbuf.append(*map(jnp.asarray, cols[:5]), bad=jnp.asarray(bad))
        buf.append(*map(torch.from_numpy, cols))
    return jbuf, buf


def script_indices(key, n_members):
    """What ``sample_segments`` draws from each of ``split(key, BATCHES)``
    (anchors anywhere in the filled columns)."""
    out = []
    for k in jax.random.split(key, BATCHES):
        r_env, r_t = jax.random.split(k)
        shape = (n_members, BATCH)
        out.append(tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(r_env, shape, 0, E),
            jax.random.randint(r_t, shape, 0, FILLED))))
    return out


def test_shared_std_and_score_match_the_script(tmp_path):
    jstate, _ = snapshots(CELL, tmp_path, dobs_std=0.2, act_std=0.7)
    _, jdyn, _, _ = jax_cell(CELL)
    _, _, dyn, _, _, state = load_cell(CELL, device="cpu",
                                       ckpt_dir=str(tmp_path))
    jbuf, buf = rings()

    # the script's std: numpy over the masked Δobs rows
    _, _, dobs, mask = jbuf.norm_inputs()
    d, m = np.asarray(dobs), np.asarray(mask, bool).reshape(-1)
    ref_std = d.reshape(-1, d.shape[-1])[m].std(0) + 1e-8
    std = probe_dist.shared_std(buf)
    np.testing.assert_allclose(std.numpy(), ref_std, rtol=RTOL)

    key = jax.random.key(5)
    ref = jax_score(jdyn, jstate, jbuf, key, BATCHES, BATCH, ref_std)
    out = probe_dist.score_on_buffer(
        dyn, state, buf, None, BATCHES, BATCH, torch.from_numpy(ref_std),
        indices=script_indices(key, dyn.cfg.n_members))
    assert ref > 0
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_score_draws_its_own_indices(tmp_path):
    """Without indices: a seeded draw of anchors anywhere in the ring."""
    snapshots(CELL, tmp_path)
    _, _, dyn, _, _, state = load_cell(CELL, device="cpu",
                                       ckpt_dir=str(tmp_path))
    _, buf = rings()
    std = probe_dist.shared_std(buf)
    scores = [probe_dist.score_on_buffer(
        dyn, state, buf, torch.Generator().manual_seed(s), 2, 8, std)
        for s in (0, 0, 1)]
    assert scores[0] == scores[1] != scores[2] and np.isfinite(scores[0])
