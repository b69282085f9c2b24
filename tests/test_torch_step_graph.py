"""The graphed control step's bookkeeping, on the CPU (train/step_graph.py).

A ``StepGraph`` made with ``capture=False`` runs its body on its static
buffers without capturing: the same copies in and out that a replay on the
card relies on. It must give what the op-by-op steps give, bit for bit:
carry (env states, histories, CEM warm-start plan), per-step outputs, the
ring, the metrics and the generator's state, for a toy cheetah CaDM and a
toy 5-member TS1 ensemble, through an auto-reset (3-step
episodes), across new weights loaded between calls (the stale-weights
trap), with outputs kept across steps (the aliasing trap).

The capture itself needs the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 15; ``tests/test_torch_step_capture_safe.py``
checks here what a capture would refuse.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import tree_map
from cadm_tpu_torch.ops import _build, fk_kernel, pgs
from cadm_tpu_torch.train import step_graph
from cadm_tpu_torch.train.mb_trainer import MBTrainer
from cadm_tpu_torch.train.step_graph import STEPS, StepGraphs

TOY = dict(hidden=(8, 8), n_envs=3, eval_envs=2, n_candidates=6,
           plan_horizon=3, cem_iters=2, cem_elites=2, warm_start=True,
           history_k=2, future_m=2, buffer_capacity=16, env_horizon=3,
           steps_per_itr=6, n_itr=2, batch_size=4, max_epochs=1,
           epoch_updates_cap=2, eval_modes=(0, 1))
CASES = {
    "cheetah_cadm": ("halfcheetah_cadm_cem", {}),
    # a 5-member probabilistic TS1 ensemble (the cripple_ant preset's model)
    # on the cheetah's cheaper physics
    "cheetah_ts1": ("halfcheetah_cadm_cem", dict(ensemble=5,
                                                 ensemble_eval="ts1")),
}
STEPS_RUN, NEW_WEIGHTS_AT = 5, 3


def build(name, **override):
    preset, extra = CASES.get(name, (name, {}))
    cfg = dataclasses.replace(PRESETS[preset], **{**TOY, **extra, **override})
    return cfg.build("cpu")


def leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and \
            torch.equal(x.nan_to_num(), y.nan_to_num())


def start(trainer, kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    env_states, hists, _, dyn = trainer.init(gen)
    n = trainer.cfg.n_envs
    if kind == "eval":
        n = trainer.cfg.eval_envs
        env_states = trainer.env.reset(gen, n, 1)
        hists = tree_map(lambda x: x[:n], hists)
    return gen, dyn, (env_states, hists, trainer.planner.init_plan(n))


def perturbed(dyn, seed):
    g = torch.Generator().manual_seed(seed)
    return dataclasses.replace(dyn, params=tree_map(
        lambda p: p + 0.05 * torch.randn(p.shape, generator=g), dyn.params))


@pytest.mark.parametrize("kind", ["collect", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_step_graph_matches_the_op_by_op_steps(name, kind):
    _, _, _, trainer = build(name)
    mode = 1 if kind == "eval" else 0
    gen, dyn, carry = start(trainer, kind)
    gen_g, _, carry_g = start(trainer, kind)
    new_dyn = perturbed(dyn, 1)

    ref_outs = []
    for t in range(STEPS_RUN):
        use = dyn if t < NEW_WEIGHTS_AT else new_dyn
        carry, out = STEPS[kind](trainer, use, carry, gen, mode)
        ref_outs.append(tree_map(torch.clone, out))

    graphs = StepGraphs(trainer, capture=False)
    graph = graphs.load(kind, mode, dyn, carry_g, gen_g)
    outs, kept = [], []
    for t in range(STEPS_RUN):
        if t == NEW_WEIGHTS_AT:   # a fit's new weights: copied in by the next load
            carry_g = graph.carry_out()
            assert graphs.load(kind, mode, new_dyn, carry_g, gen_g) is graph
        out = graph()
        kept.append(out)
        outs.append(tree_map(torch.clone, out))
    for got, ref in zip(outs, ref_outs):
        assert_same(got, ref)
    # the aliasing trap: an output not copied out holds the last step's
    assert all(k is kept[0] for k in kept)
    assert_same(kept[0], ref_outs[-1])
    dones = torch.stack([leaves(o)[-3 if kind == "collect" else 1]
                         for o in ref_outs])
    assert dones.any(), "no episode ended: the auto-reset path is not checked"
    assert_same(graph.carry_out(), carry)
    assert torch.equal(gen_g.get_state(), gen.get_state())
    # the static weights are the loaded ones, not copies of the first
    assert_same(graphs.weights.params, new_dyn.params)


def test_trainer_with_step_graphs_matches_op_by_op():
    """Two iterations of ``train`` (random collect, fit; planned collect,
    fit, eval in modes 0 and 1) of the toy cheetah through the
    static-buffer steps against the op-by-op trainer: the same rows, final
    state and generator state."""
    _, _, _, eager = build("cheetah_cadm", eval_every=2)
    graphed = MBTrainer(eager.env, eager.model, eager.planner, eager.cfg)
    assert graphed.graphs is None   # the CPU runs op by op ...
    graphed.graphs = StepGraphs(graphed, capture=False)   # ... unless told
    runs = []
    for trainer in (eager, graphed):
        gen = torch.Generator().manual_seed(3)
        state, rows = trainer.train(gen)
        runs.append((state, rows, gen.get_state()))
    (s0, r0, g0), (s1, r1, g1) = runs
    assert [list(r) for r in r0] == [list(r) for r in r1]
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(np.array(list(a.values())),
                                      np.array(list(b.values())))
    assert_same(s0.params, s1.params)
    assert torch.equal(g0, g1)
    # collect, eval mode 0, eval mode 1, the random collect: one graph each
    assert sorted(k[:3] for k in graphed.graphs.graphs) == [
        ("collect", 3, 0), ("eval", 2, 0), ("eval", 2, 1), ("random", 3, 0)]


def test_the_graphed_path_takes_no_injected_noise():
    _, _, _, trainer = build("cheetah_cadm")
    trainer.graphs = StepGraphs(trainer, capture=False)
    gen, dyn, (states, hists, _) = start(trainer, "collect")
    buffer = trainer.init(gen)[2]
    noise = torch.zeros(trainer.cfg.steps_per_itr, 2, 3, 6, 3, 6)
    with pytest.raises(ValueError, match="op-by-op"):
        trainer._collect(gen, states, hists, buffer, dyn, False, noise)


def test_replays_add_their_recorded_launches():
    before = (pgs.launches, fk_kernel.launches, fk_kernel.fk_vel_launches)
    _build.add_replayed({"pgs": 5, "full_dyn": 5, "fk_vel": 0})
    assert (pgs.launches, fk_kernel.launches, fk_kernel.fk_vel_launches) == (
        before[0] + 5, before[1] + 5, before[2])
    assert step_graph.WARMUP_STEPS >= 1
