"""Rank functions of the mesh tests (test_torch_mesh*.py).

Importable without jax: ``parallel.mesh.spawn`` starts each rank in a fresh
process that imports this module by name, so it imports only torch, numpy
and the port. Each function runs on one rank of a gloo mesh on the CPU and
returns plain values (rows, tensors) that the tests compare with the same
run without a mesh (``assert_rows_close``, ``assert_weights_close``).
"""
import dataclasses

import numpy as np
import torch

from cadm_tpu_torch.cli.presets import PRESETS, ExperimentConfig
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.utils.checkpoint import Checkpointer

# float32 matmul chains and their gradients, summed in another order (the
# norm statistics over two rings, the encoder's gradient over two member
# blocks): test_torch_fit.py's 1e-5 for weights; rows (losses, returns)
# within 1e-5 relative
ATOL, ROW_RTOL = 1e-5, 1e-5
LAYOUTS = [(2, 2), (2, 1)]  # (dp, model)
# a toy CaDM with 2 probabilistic members on pendulum: a random collect and
# an epoch fit, then a planned collect, an epoch fit and an eval
PENDULUM = dict(
    env="pendulum", model="cadm", ensemble=2, planner="cem",
    fit_protocol="epochs", hidden=(16, 16), z_dim=4, history_k=3, future_m=2,
    n_envs=4, eval_envs=4, eval_modes=(0, 1), n_candidates=8, plan_horizon=4,
    cem_iters=2, cem_elites=3, steps_per_itr=12, env_horizon=8, n_itr=2,
    buffer_capacity=32, batch_size=8, max_epochs=2, epoch_updates_cap=4)
# one planned cheetah collect of 4 envs × 2 steps: K1/K2's plain versions
# run on each rank's block
CHEETAH = dict(
    dataclasses.asdict(PRESETS["halfcheetah_cadm_cem"]), ensemble=2,
    hidden=(16, 16), z_dim=4, history_k=3, future_m=2, n_envs=4,
    eval_envs=4, n_candidates=8, plan_horizon=3, cem_iters=1, cem_elites=2,
    steps_per_itr=2, buffer_capacity=8)
# PPO + CaDM (2 members) on pendulum: two rows
PPO = dict(
    trainer="ppo", env="pendulum", model="cadm", ensemble=2, hidden=(16, 16),
    z_dim=4, history_k=3, future_m=2, policy_hidden=(8, 8), n_envs=4,
    eval_envs=4, eval_modes=(0,), rollout_len=8, env_horizon=6, n_itr=2,
    ppo_epochs=2, ppo_minibatches=2, model_updates_per_itr=4, batch_size=8,
    buffer_capacity=16)


def assert_rows_close(rows, ref):
    assert [r["itr"] for r in rows] == [r["itr"] for r in ref]
    for a, b in zip(rows, ref):
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=ROW_RTOL, atol=1e-6,
                                       err_msg=k)


def assert_weights_close(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def without_mesh(fn, *args):
    """``fn(None, *args)`` in this process on one thread, as each rank
    runs (``parallel.mesh.spawn``): the ranks share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(None, *args)
    finally:
        torch.set_num_threads(threads)


def gather_mixed(mesh) -> list:
    """A bool, an int32, a float32 and a float64 tensor of 2 × 3 rows
    (dim 0 for three, dim 1 for the last), this rank's rows gathered over
    dp; the whole tensors with no mesh."""
    g = torch.Generator().manual_seed(3)
    whole = [torch.rand(6, 5, generator=g) > 0.5,
             torch.randint(-2**31, 2**31 - 1, (6, 2), generator=g,
                           dtype=torch.int32),
             torch.randn(6, generator=g),
             torch.randn(4, 6, generator=g, dtype=torch.float64)]
    if mesh is None:
        return whole
    dims = [0, 0, 0, 1]
    blocks = [mesh.take(x, "dp", d) for x, d in zip(whole, dims)]
    out = mesh.gather(blocks[:3], "dp") + mesh.gather(blocks[3:], "dp", 1)
    return [x.clone() for x in out]


def train(mesh, fields: dict, ckpt_dir=None) -> dict:
    """``ExperimentConfig(**fields)`` trained on ``mesh`` (None: no mesh,
    on the CPU) → the rows and every weight of the final state (the PPO
    state's, then the model's)."""
    cfg = ExperimentConfig(**fields)
    _, _, _, trainer = (cfg.build("cpu") if mesh is None
                        else cfg.build(mesh=mesh))
    gen = torch.Generator().manual_seed(cfg.seed)
    ckpt = None if ckpt_dir is None else Checkpointer(
        ckpt_dir, writes=mesh is None or mesh.rank == 0)
    out = trainer.train(gen, checkpointer=ckpt)
    *states, history = out
    return {"history": history,
            "params": [x.clone() for s in states
                       for x in tree_leaves(s.params)]}


def collect(mesh, fields: dict) -> dict:
    """One planned collect of ``fields``' envs from the initial state (the
    members at their initial weights) → the ring's columns and the env
    states' observations, gathered over dp, and the collect metrics."""
    cfg = ExperimentConfig(**fields)
    _, _, _, trainer = (cfg.build("cpu") if mesh is None
                        else cfg.build(mesh=mesh))
    gen = torch.Generator().manual_seed(cfg.seed)
    states, hists, buf, dyn = trainer.init(gen)
    states, _, buf, metrics = trainer._collect(
        gen, states, hists, buf, trainer.planning_state(dyn), False)
    cols = [buf.obs[:, :buf.size], buf.act[:, :buf.size],
            buf.next_obs[:, :buf.size], states.obs]
    if mesh is not None:
        cols = mesh.gather(cols, "dp")
    return {"cols": [c.clone() for c in cols],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def build_raises(mesh, fields: dict) -> str:
    """The message of the ``ValueError`` that building ``fields`` on
    ``mesh`` raises ('' if it builds)."""
    try:
        ExperimentConfig(**fields).build(mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""


def layout(mesh, ckpt_dir: str) -> dict:
    """On one mesh: ``train`` of PENDULUM (checkpointed into
    ``ckpt_dir``), ``collect`` of CHEETAH, and the ``build_raises`` message
    of a 5-member PENDULUM."""
    return {"train": train(mesh, PENDULUM, ckpt_dir),
            "collect": collect(mesh, CHEETAH),
            "raises": build_raises(mesh, dict(PENDULUM, ensemble=5))}


def update(mesh, path: str) -> list:
    """``Dynamics.update`` with this rank's members, from the whole model
    state on each whole batch saved at ``path`` (``{"cfg", "state",
    "batches"}``, written by the test) → every weight and Adam moment of
    the final state, gathered over the model axis."""
    from cadm_tpu_torch.models.dynamics import Dynamics
    from cadm_tpu_torch.parallel.mesh import (
        gather_dynamics_state,
        shard_dynamics_state,
    )

    saved = torch.load(path, weights_only=False)
    model = Dynamics(saved["cfg"], device="cpu", mesh=mesh)
    st = shard_dynamics_state(saved["state"], mesh, model.member_keys)
    for batch in saved["batches"]:
        st, _ = model.update(st, dataclasses.replace(batch, **{
            f.name: mesh.take(getattr(batch, f.name), "model")
            for f in dataclasses.fields(batch)}))
    st = gather_dynamics_state(st, mesh, model.member_keys)
    return [x.clone() for tree in (st.params, st.opt_state.mu,
                                   st.opt_state.nu)
            for x in tree_leaves(tree)]
