"""What a CUDA-graph capture of the trainers' programs would refuse, on
the CPU.

A capture (train/step_graph.py, train/fit_graph.py) refuses a read of a
tensor's value on the host (a sync) and a tensor made from host memory (a
copy that syncs). Once a body has run (the graph's warm-up fills the
caches of host constants), the bodies of every preset, model, planner mode
and env family must do neither: a dispatch mode raises on the ops that
would, and ``torch.tensor``/``as_tensor``/``from_numpy`` are refused while
they run. The bodies: the MB trainer's planned and random collect steps,
its eval step, a fit's update (draw, gather, symmetry augmentation,
``model.update``) and its valid metrics; the PPO trainer's collect and eval
steps, GAE with the flattened rollout, a minibatch step, and its model
update and valid loss; the ``Sampler``'s step under uniform draws,
injected actions and a policy.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cadm_tpu_torch import envs
from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.core.types import History
from cadm_tpu_torch.models.dynamics import DynamicsState
from cadm_tpu_torch.train import ppo, sampler as sampler_mod
from cadm_tpu_torch.train.step_graph import STEPS
from tests.test_torch_fit_graph import fill
from tests.test_torch_step_graph import TOY, start


class HostSyncs(TorchDispatchMode):
    """Raise on an op that reads a tensor's values on the host or makes a
    tensor from host data: on the card each is a sync or a copy from host
    memory, which a CUDA-graph capture refuses."""

    aten = torch.ops.aten
    REFUSED = {aten._local_scalar_dense.default, aten.nonzero.default,
               aten.masked_select.default, aten.is_nonzero.default,
               aten.equal.default, aten._unique2.default,
               aten.unique_consecutive.default, aten.unique_dim.default,
               aten.lift_fresh.default, aten.repeat_interleave.Tensor}
    INDEXING = {aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._unsafe_index_put.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.REFUSED:
            raise AssertionError(f"host sync or host data in the step: {func}")
        if func in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise AssertionError(f"boolean-mask indexing in the step: {func}")
        return func(*args, **kwargs)


def refuse(*args, **kwargs):
    raise AssertionError("a tensor made from host memory in the step")


def safe(monkeypatch, body):
    """Run ``body`` once as warm-up, then again under ``HostSyncs`` with
    host-data tensors refused."""
    with torch.no_grad():
        body()
        with monkeypatch.context() as m:
            for fn in ("tensor", "as_tensor", "from_numpy"):
                m.setattr(torch, fn, refuse)
            with HostSyncs():
                body()


def mb_bodies(trainer, monkeypatch):
    for kind, mode in (("collect", 0), ("eval", 2), ("random", 0)):
        gen, dyn, carry = start(trainer, kind)
        safe(monkeypatch, lambda: STEPS[kind](trainer, dyn, carry, gen, mode))
    gen = torch.Generator().manual_seed(1)
    _, _, buf, dyn = trainer.init(gen)
    fill(buf, gen, 30)
    dyn = trainer._refresh_norm(buf, dyn)
    idx = trainer._draw_valid(buf, gen)
    safe(monkeypatch, lambda: trainer._train_step(buf, gen, dyn))
    safe(monkeypatch, lambda: trainer._valid_metrics(buf, idx, dyn))


def ppo_bodies(trainer, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    env_states, hists, buf, ps, dyn = trainer.init(gen)
    weights = (ps, DynamicsState(dyn.params, dyn.norm))
    n = trainer.cfg.n_envs
    carry = (env_states, hists, torch.zeros(n))
    safe(monkeypatch, lambda: ppo.collect_step(trainer, weights, carry, gen))
    safe(monkeypatch, lambda: ppo.eval_step(trainer, weights, carry[:2], gen,
                                            2))
    env_states, hists, buf, traj, last = trainer._collect(
        gen, env_states, hists, buf, ps, dyn)
    traj.pop("ep_return")
    safe(monkeypatch, lambda: trainer._flatten(traj, last))
    flat = trainer._flatten(traj, last)
    idx = torch.randperm(flat["adv"].shape[0], generator=gen)[:8]
    safe(monkeypatch, lambda: trainer._minibatch_step(ps, flat, idx))
    dyn = dataclasses.replace(dyn, norm=buf.norm_stats())
    safe(monkeypatch, lambda: trainer.model.update(dyn, trainer._sample(
        buf, trainer._draw(buf, gen, "train"))))
    valid = trainer._draw(buf, gen, "valid")
    safe(monkeypatch, lambda: trainer.model.loss(dyn.params, dyn.norm,
                                                 trainer._sample(buf, valid)))


@pytest.mark.parametrize("name,override", [
    ("halfcheetah_cadm_cem", {}),
    ("halfcheetah_cadm_cem", dict(model="stacked")),
    ("halfcheetah_cadm_cem", dict(model="rnn")),
    ("halfcheetah_cadm_cem", dict(model="grbal", hidden=(8, 8, 8))),
    ("halfcheetah_cadm_cem", dict(planner="rs", randomization="continuous")),
    ("cripple_ant_cadm_ensemble_cem", dict(ensemble_eval="ts1")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="assign")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="mean")),
    ("halfcheetah_cadm_cem", dict(ensemble=5, ensemble_eval="ts1_exact")),
    ("hopper_cadm_cem", dict(normalize_env=True)),
    ("slim_humanoid_cadm_cem", {}),
    ("pendulum_cadm_cem", {}),
    ("cartpole_vanilla_rs", {}),
    ("cripple_ant_cadm_ensemble_cem", dict(symmetry_aug=True)),
    ("hopper_ppo_cadm", dict(rollout_len=4, policy_hidden=(8, 8))),
    ("slim_humanoid_ppo_cadm", dict(rollout_len=4, policy_hidden=(8, 8),
                                    model="vanilla")),
], ids=lambda x: x if isinstance(x, str) else "-".join(
    f"{k}={v}" for k, v in x.items() if k not in ("hidden", "rollout_len",
                                                  "policy_hidden"))
    or "preset")
def test_step_bodies_are_capture_safe(name, override, monkeypatch):
    cfg = dataclasses.replace(PRESETS[name], **{**TOY, **override})
    trainer = cfg.build("cpu")[3]
    if cfg.trainer == "ppo":
        ppo_bodies(trainer, monkeypatch)
    else:
        mb_bodies(trainer, monkeypatch)


def test_sampler_step_bodies_are_capture_safe(monkeypatch):
    env = envs.make("half_cheetah", device="cpu")
    sampler = sampler_mod.Sampler(env, 2, history_k=3)
    gen = torch.Generator().manual_seed(0)
    carry = (env.reset(gen, 2),
             History.zeros(2, 3, env.obs_dim, env.act_dim, env.device))
    act = torch.full((2, env.act_dim), 0.3)

    def policy(obs, hists, g):
        return torch.tanh(obs[:, :env.act_dim] + hists.dobs.sum((1, 2))[:, None]
                          + rand(g, obs.shape[0], env.act_dim))

    safe(monkeypatch, lambda: sampler_mod.random_step(sampler, carry, gen))
    safe(monkeypatch, lambda: sampler_mod.injected_step(sampler, carry, gen,
                                                        act))
    safe(monkeypatch, lambda: sampler_mod.policy_step(policy, sampler, carry,
                                                      gen))
