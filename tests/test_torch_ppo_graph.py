"""The PPO trainer's graphed programs, on the CPU (train/ppo.py).

A ``PPOTrainer`` given a ``StepGraphs(capture=False)`` of its step table and
a ``FitGraphs`` over it runs each collect step, eval step, GAE, PPO
minibatch step and model update on static buffers without capturing: the
copies in and out that replays on the card rely on. It must give what the
op-by-op trainer gives, bit for bit, on the toy pendulum through episodes
that end inside a collect: each program alone (collect: trajectory, ring,
env states, histories; eval: returns; update: parameters, Adam state,
losses; model fit: parameters, Adam state, losses) and two whole
iterations (rows, final states, generator state). The capture itself needs
the card (``chip_smoke.py`` phase 16).
"""
import dataclasses

import numpy as np
import pytest
import torch

from cadm_tpu_torch.cli.presets import ExperimentConfig
from cadm_tpu_torch.core.types import tree_map
from cadm_tpu_torch.train import ppo
from cadm_tpu_torch.train.fit_graph import FitGraphs
from cadm_tpu_torch.train.step_graph import StepGraphs

CFG = ExperimentConfig(
    env="pendulum", trainer="ppo", model="cadm", hidden=(16, 16),
    policy_hidden=(8, 8), n_envs=4, eval_envs=3, rollout_len=12,
    env_horizon=5, n_itr=2, ppo_epochs=2, ppo_minibatches=3,
    model_updates_per_itr=4, batch_size=8, buffer_capacity=40, history_k=3,
    future_m=2, eval_modes=(0, 2))


def build(graph: bool):
    trainer = CFG.build("cpu")[3]
    assert trainer.graphs is None and trainer.fit_graphs is None
    if graph:
        trainer.graphs = StepGraphs(trainer, capture=False, steps=ppo.STEPS)
        trainer.fit_graphs = FitGraphs(trainer.graphs)
    return trainer


def assert_same(a, b):
    pairs = []
    tree_map(lambda x, y: pairs.append((x, y)) or x, a, b)
    assert pairs
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (
            torch.equal(x.isnan(), y.isnan())
            and torch.equal(x.nan_to_num(), y.nan_to_num()))


def collected(trainer, seed=0):
    """A collect from a fresh start → (generator, start, its outputs)."""
    gen = torch.Generator().manual_seed(seed)
    start = trainer.init(gen)
    env_states, hists, buf, ps, dyn = start
    out = trainer._collect(gen, env_states, hists, buf, ps, dyn)
    return gen, start, out


def test_collect_step_matches_op_by_op():
    (g0, _, c0), (g1, _, c1) = collected(build(False)), collected(build(True))
    states, hists, buf, traj, last = c0
    assert traj["done"].any(), "no episode ended inside the collect"
    assert torch.isfinite(traj["ep_return"]).sum() == traj["done"].sum()
    assert_same(c0, c1)
    assert torch.equal(g0.get_state(), g1.get_state())


def test_eval_update_and_fit_match_op_by_op():
    runs = []
    for graph in (False, True):
        tr = build(graph)
        gen, start, (_, _, buf, traj, last) = collected(tr, 1)
        traj.pop("ep_return")
        ps, ppo_m = tr._ppo_update(gen, start[3], traj, last)
        dyn, fit_m = tr._fit_model(gen, buf, start[4])
        returns = [tr.evaluate(ps, dyn, m, gen) for m in (0, 2)]
        # the update and the fit again: the graphs reloaded, not captured
        ps2, _ = tr._ppo_update(gen, ps, traj, last)
        dyn2, _ = tr._fit_model(gen, buf, dyn)
        runs.append(((ps, ps2), (dyn, dyn2), ppo_m, fit_m, returns,
                     gen.get_state(), tr))
    (a, b) = runs
    for x, y in zip(a[:2], b[:2]):
        for s, t in zip(x, y):
            assert_same(s.params, t.params)
            assert_same(s.opt_state, t.opt_state)
            assert s.updates == t.updates == int(s.opt_state.count)
    assert a[0][1].updates == 2 * CFG.ppo_epochs * CFG.ppo_minibatches
    for ma, mb in ((a[2], b[2]), (a[3], b[3])):
        assert list(ma) == list(mb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert_same(a[4], b[4])
    assert torch.equal(a[5], b[5])
    # one GAE graph, one minibatch fit, one model fit, and the step graphs
    tr = b[6]
    assert tr._prep is not None and sorted(tr.fit_graphs.fits) == ["fit",
                                                                   "ppo"]
    assert sorted(k[:3] for k in tr.graphs.graphs) == [
        ("collect", 4, 0), ("eval", 3, 0), ("eval", 3, 2)]


def test_training_matches_op_by_op():
    runs = []
    for graph in (False, True):
        gen = torch.Generator().manual_seed(2)
        ps, dyn, rows = build(graph).train(gen)
        runs.append((ps, dyn, rows, gen.get_state()))
    (ps0, d0, r0, g0), (ps1, d1, r1, g1) = runs
    assert [list(r) for r in r0] == [list(r) for r in r1]
    for x, y in zip(r0, r1):
        np.testing.assert_array_equal(np.array(list(x.values()), float),
                                      np.array(list(y.values()), float))
    assert_same(ps0.params, ps1.params)
    assert_same(d0.params, d1.params)
    assert torch.equal(g0, g1)


def test_the_graphed_programs_take_no_injected_draws():
    tr = build(True)
    gen, start, (_, _, buf, traj, last) = collected(tr)
    env_states, hists, buf0, ps, dyn = start
    noise = torch.zeros(CFG.rollout_len, CFG.n_envs, 1)
    with pytest.raises(ValueError, match="op-by-op"):
        tr._collect(gen, env_states, hists, buf0, ps, dyn, noise=noise)
    tr._draw = lambda buffer, g, split: buffer.draw_indices(g, (1, 8), split)
    with pytest.raises(ValueError, match="op-by-op"):
        tr._fit_model(gen, buf, dyn)


def test_gae_graph_is_the_op_by_op_gae():
    tr = build(True)
    _, _, (_, _, _, traj, last) = collected(tr)
    traj.pop("ep_return")
    flat = tr._flatten(traj, last)
    adv, ret = tr._gae(traj, last)
    assert torch.equal(flat["adv"], adv.reshape(-1))
    assert torch.equal(flat["ret"], ret.reshape(-1))
    tr._ppo_update(torch.Generator(), tr.init(torch.Generator())[3], traj,
                   last)
    assert_same(tr._prep.out, flat)
    assert dataclasses.is_dataclass(tr.fit_graphs.fits["ppo"].final())
