"""The graphed fit's bookkeeping, on the CPU (train/fit_graph.py).

A ``FitGraphs`` over a ``StepGraphs`` made with ``capture=False`` runs the
fit's bodies on their static buffers without capturing: the copies in and
out that replays on the card rely on. Its fit must give what the op-by-op
fit gives, bit for bit: parameters, Adam moments and count, the updates
taken, every fit metric (``epochs_run`` included) and the generator's
state, for vanilla, CaDM, stacked, ReBAL, GrBAL and a 5-member
probabilistic ensemble with symmetry augmentation, over two fits with the
ring grown between them (a new capture each) and a third on the same ring
(the same one reloaded). The ring holds random rows, not env steps.

Also: the device-resident Adam count through ``convert.py`` and a
checkpoint, a payload whose count is a host int (the format of earlier
checkpoints) loading and training on alike, and injected draws refused by
the graphed fit. The capture itself needs the card (``chip_smoke.py``
phase 16); ``tests/test_torch_step_capture_safe.py`` checks here what a
capture would refuse.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import tree_leaves, tree_map
from cadm_tpu_torch.train.fit_graph import FitGraphs
from cadm_tpu_torch.train.step_graph import StepGraphs
from cadm_tpu_torch.utils.checkpoint import Checkpointer, from_plain, to_plain
from cadm_tpu_torch.utils.convert import adam_state_from_jax

TOY = dict(hidden=(8, 8), n_envs=4, history_k=2, future_m=2, batch_size=8,
           buffer_capacity=40, max_epochs=3, early_stop_patience=2,
           epoch_updates_cap=3, model_updates_per_itr=4)
CASES = {
    "vanilla_fixed": ("halfcheetah_cadm_cem", dict(model="vanilla",
                                                   fit_protocol="fixed")),
    "cadm": ("halfcheetah_cadm_cem", {}),
    "stacked": ("halfcheetah_cadm_cem", dict(model="stacked")),
    "rebal": ("halfcheetah_cadm_cem", dict(model="rnn")),
    "grbal": ("halfcheetah_cadm_cem", dict(model="grbal", hidden=(8, 8, 8))),
    # 5 probabilistic members, bootstrap batches, the 4-fold leg relabeling
    "pets_symmetry": ("cripple_ant_cadm_ensemble_cem",
                      dict(symmetry_aug=True, early_stop_metric="fwd_mse")),
}


def build(name):
    preset, extra = CASES[name]
    cfg = dataclasses.replace(PRESETS[preset], **{**TOY, **extra})
    return cfg.build("cpu")[3]


def graphed(trainer):
    """``trainer`` with static-buffer fit graphs (the card's bookkeeping,
    no capture)."""
    trainer.fit_graphs = FitGraphs(StepGraphs(trainer, capture=False))
    return trainer


def fill(buffer, gen, steps, episode=7):
    """``steps`` columns of random rows: episodes of ``episode`` steps, a
    few bad transitions."""
    n, d = buffer.n_envs, buffer.obs.shape[-1]
    for _ in range(steps):
        t = buffer.size % episode
        obs = torch.randn(n, d, generator=gen)
        buffer.append(obs, torch.rand(n, buffer.act.shape[-1], generator=gen)
                      * 2 - 1, obs + 0.1 * torch.randn(n, d, generator=gen),
                      torch.full((n,), t == episode - 1),
                      torch.full((n,), t, dtype=torch.int32),
                      torch.rand(n, generator=gen) < 0.05)


def assert_same(a, b):
    """Equal trees, leaf by leaf (dicts matched by key)."""
    pairs = []
    tree_map(lambda x, y: pairs.append((x, y)) or x, a, b)
    assert pairs
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def same_metrics(a: dict, b: dict):
    assert list(a) == list(b)
    np.testing.assert_array_equal(np.array([float(v) for v in a.values()]),
                                  np.array([float(v) for v in b.values()]))


def run_fits(trainer):
    """Two fits with 12 columns appended between them, then a third on the
    same ring → (states, metric rows, generator state, fit objects)."""
    gen = torch.Generator().manual_seed(5)
    _, _, buf, state = trainer.init(gen)
    fill(buf, gen, 28)
    states, rows, fits = [], [], []
    for extra in (0, 12, 0):
        fill(buf, gen, extra)
        state, m = trainer._fit(gen, buf, state)
        states.append(state)
        rows.append(m)
        if trainer.fit_graphs is not None:
            fits.append(trainer.fit_graphs.fits["fit"])
    return states, rows, gen.get_state(), fits


@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_fit_matches_the_op_by_op_fit(name):
    eager = build(name)
    assert eager.fit_graphs is None   # the CPU fits op by op ...
    s0, r0, g0, _ = run_fits(eager)
    s1, r1, g1, fits = run_fits(graphed(build(name)))   # ... unless told
    for a, b, ma, mb in zip(s0, s1, r0, r1):
        assert_same(a.params, b.params)
        assert_same(a.norm, b.norm)
        assert_same([a.opt_state.count, a.opt_state.mu, a.opt_state.nu],
                    [b.opt_state.count, b.opt_state.mu, b.opt_state.nu])
        assert a.updates == b.updates == int(a.opt_state.count) > 0
        same_metrics(ma, mb)
    assert torch.equal(g0, g1)
    if "fit/epochs_run" in r0[0]:
        assert {m["fit/epochs_run"] for m in r0} <= {1, 2, 3}
    # a grown ring is captured anew; the same ring reloads the same fit
    assert fits[0] is not fits[1] and fits[1] is fits[2]
    # the trainer's state holds no static buffer of the graphs
    static = {x.data_ptr() for x in tree_leaves(fits[2].steps.carry.params)}
    assert not static & {x.data_ptr() for x in tree_leaves(s1[2].params)}


def test_the_graphed_fit_takes_no_injected_draws():
    trainer = graphed(build("cadm"))
    gen = torch.Generator().manual_seed(0)
    buf, state = trainer.init(gen)[2:]
    fill(buf, gen, 20)
    trainer._draw = lambda buffer, g, split: buffer.draw_indices(
        g, (1, 8), split)
    with pytest.raises(ValueError, match="op-by-op"):
        trainer._fit(gen, buf, state)


def test_adam_count_lives_on_the_device_and_round_trips(tmp_path):
    trainer = build("cadm")
    gen = torch.Generator().manual_seed(1)
    buf, state = trainer.init(gen)[2:]
    assert state.opt_state.count.dtype == torch.int32
    assert state.opt_state.count.ndim == 0
    fill(buf, gen, 28)
    state, _ = trainer._fit(gen, buf, state)
    count = int(state.opt_state.count)
    assert count == state.updates > 0
    # optax's ScaleByAdamState (numpy leaves) → the port's
    ref = adam_state_from_jax(types.SimpleNamespace(
        count=np.int32(count),
        mu=[np.asarray(x) for x in tree_leaves(state.opt_state.mu)],
        nu=[np.asarray(x) for x in tree_leaves(state.opt_state.nu)]), "cpu")
    assert ref.count.dtype == torch.int32 and int(ref.count) == count
    # a checkpoint and back
    ck = Checkpointer(str(tmp_path))
    ck.save(0, state)
    back = from_plain(state, ck.restore()["state"])
    assert torch.equal(back.opt_state.count, state.opt_state.count)
    assert_same(back.opt_state.mu, state.opt_state.mu)
    # the count as a host int (earlier checkpoints): loads as the tensor
    # and trains on alike
    plain = to_plain(state)
    plain["opt_state"]["count"] = count
    old = from_plain(state, plain)
    assert old.opt_state.count.dtype == torch.int32
    assert torch.equal(old.opt_state.count, state.opt_state.count)
    fill(buf, gen, 4)
    runs = []
    for st in (state, old):
        g = torch.Generator().manual_seed(2)
        runs.append(trainer._fit(g, buf, st)[0])
    assert_same(runs[0].params, runs[1].params)
    assert int(runs[1].opt_state.count) == runs[1].updates
