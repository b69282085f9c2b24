"""The Sampler's graphed rollout, its bookkeeping on the CPU
(train/sampler.py, train/step_graph.py).

A ``Sampler`` told to graph on a CPU env runs each control step on the
call's ``Graph``'s static buffers without capturing: the injected action
row copied into a static input, the rows copied out of the static output
after each step. It must give what the op-by-op rollout gives, bit for bit,
paths and generator state, for each action source (uniform draws, injected
actions, a policy that reads its weights, the histories and draws), through
auto-resets, and again on a second call whose policy weights were rebound.
Each call makes its own graph and drops it at return, as the reference jits
its rollout on each call, so no later call replays what an earlier one
captured. The capture itself needs the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17.
"""
import numpy as np
import pytest
import torch

from cadm_tpu_torch import envs
from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.train import sampler as sampler_mod
from cadm_tpu_torch.train.sampler import PATH_KEYS, Sampler
from cadm_tpu_torch.train.step_graph import Graph

N_ENVS, N_STEPS, HISTORY_K = 3, 12, 3


class Policy:
    """Reads its weight ``w`` (rebound between calls), the histories (wiped
    at each done) and draws."""

    def __init__(self, w):
        self.w = torch.tensor(w)

    def __call__(self, obs, hists, gen):
        return torch.tanh(self.w * obs[:, :1]
                          + 0.3 * hists.dobs.sum((1, 2))[:, None]
                          - 0.1 * hists.valid.sum(1)[:, None]) \
            + 0.1 * rand(gen, obs.shape[0], 1)


def rollouts(sampler, source, actions):
    """Two calls from one generator, the policy's weight rebound between
    them: the paths of each and its state."""
    gen = torch.Generator().manual_seed(7)
    policy = Policy(0.7)
    out = []
    for call in range(2):
        kw = dict(random=True) if source == "random" else \
            dict(actions=actions[call]) if source == "actions" else \
            dict(policy=policy)
        out.append((sampler.obtain_samples(gen, N_STEPS, **kw),
                    gen.get_state()))
        policy.w = torch.tensor(-1.3)
    return out


class Recorded(Graph):
    """A ``Graph`` that records its making and its reset."""
    made, reset_ = [], []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        Recorded.made.append(self)

    def reset(self):
        Recorded.reset_.append(self)
        super().reset()


@pytest.mark.parametrize("source", ["random", "actions", "policy"])
def test_static_buffer_rollout_equals_op_by_op(source, monkeypatch):
    env = envs.make("pendulum", device="cpu", horizon=5)
    actions = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, N_STEPS, N_ENVS, env.act_dim)).astype(np.float32))
    eager = Sampler(env, N_ENVS, HISTORY_K)
    assert not eager.graph  # the CPU runs op by op ...
    graphed = Sampler(env, N_ENVS, HISTORY_K)
    graphed.graph = True  # ... unless told
    monkeypatch.setattr(sampler_mod, "Graph", Recorded)
    monkeypatch.setattr(Recorded, "made", [])
    monkeypatch.setattr(Recorded, "reset_", [])
    ref, got = rollouts(eager, source, actions), rollouts(graphed, source,
                                                          actions)
    for (rp, rg), (gp, gg) in zip(ref, got):
        assert sorted(gp) == sorted(PATH_KEYS)
        for k in PATH_KEYS:
            assert gp[k].dtype == rp[k].dtype and gp[k].shape == rp[k].shape
            np.testing.assert_array_equal(gp[k], rp[k], err_msg=k)
        assert torch.equal(gg, rg)
    assert ref[0][0]["dones"].sum() == 2 * N_ENVS  # episodes of 5 steps
    if source == "policy":  # the second call ran on the rebound weight
        assert not np.array_equal(ref[0][0]["actions"], ref[1][0]["actions"])
    # the op-by-op calls made no graph; each graphed call its own, dropped
    # at return
    assert len(Recorded.made) == 2 and Recorded.made == Recorded.reset_
    assert Recorded.made[0] is not Recorded.made[1]


def test_a_failing_step_raises_and_drops_its_graph(monkeypatch):
    """A step that fails inside the graph raises out of ``obtain_samples``
    (no op-by-op fallback), and the call's graph is dropped all the same."""
    env = envs.make("pendulum", device="cpu", horizon=5)
    sampler = Sampler(env, N_ENVS, HISTORY_K)
    sampler.graph = True
    monkeypatch.setattr(sampler_mod, "Graph", Recorded)
    monkeypatch.setattr(Recorded, "made", [])
    monkeypatch.setattr(Recorded, "reset_", [])

    def refused(obs, hists, gen):
        raise RuntimeError("refused by the capture")

    with pytest.raises(RuntimeError, match="refused by the capture"):
        sampler.obtain_samples(torch.Generator().manual_seed(0), 4,
                               policy=refused)
    assert len(Recorded.made) == 1 and Recorded.made == Recorded.reset_
