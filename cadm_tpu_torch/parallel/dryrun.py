"""The multi-rank dry run (counterpart of the reference's
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` builds an n-rank (dp, model) mesh (model = 2 when n
is even), places the flagship HalfCheetah CaDM training state on it (envs
and replay ring split over dp, ensemble members over model), and runs one
planned collect (CEM planner, physics, histories, ring) and one fit (norm
statistics, segment gathers, Adam) at the dry run's small shapes; it
asserts a finite loss.

    python -m cadm_tpu_torch.parallel.dryrun 4          # ranks on the cards
    python -m cadm_tpu_torch.parallel.dryrun 4 cpu      # 4 CPU ranks
"""
from __future__ import annotations

import math
import sys

import torch

from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.parallel.mesh import spawn


def flagship(n_envs: int = 8, n_members: int = 2, mesh=None, device=None):
    """The reference's dry-run trainer: HalfCheetah, a probabilistic CaDM
    ensemble with 4×200 heads, CEM 32 candidates × 5 steps × 2 iterations,
    8 control steps a collect, 2 updates of batch 16 from a 64-column
    ring."""
    from cadm_tpu_torch.envs import make
    from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
    from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
    from cadm_tpu_torch.train.mb_trainer import MBTrainer, TrainerConfig

    device = mesh.device if mesh is not None else device
    env = make("half_cheetah", device=device)
    model = Dynamics(
        DynamicsConfig(obs_dim=env.obs_dim, act_dim=env.act_dim,
                       hidden=(200, 200, 200, 200), n_members=n_members,
                       probabilistic=True, context="encoder", z_dim=10,
                       history_k=10, future_m=10),
        device=device, mesh=mesh)
    planner = MPCPlanner(
        PlannerConfig(kind="cem", horizon=5, n_candidates=32, cem_iters=2,
                      cem_elites=8),
        model, env.reward, env.act_dim)
    return MBTrainer(
        env, model, planner,
        TrainerConfig(n_envs=n_envs, steps_per_itr=8, n_itr=1,
                      model_updates_per_itr=2, batch_size=16,
                      buffer_capacity=64, eval_envs=n_envs, eval_modes=()),
        mesh=mesh)


def _rank(mesh) -> float:
    trainer = flagship(max(8, mesh.dp), 2 * mesh.model, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    env_states, hists, buffer, dyn_state = trainer.init(gen)
    plan_state = trainer.planning_state(dyn_state)
    trainer._collect(gen, env_states, hists, buffer, plan_state,
                     random_actions=False)
    _, metrics = trainer._fit(gen, buffer, dyn_state)
    loss = float(metrics["fit/model_loss_last"])
    if not math.isfinite(loss):
        raise AssertionError(f"rank {mesh.rank}: fit metrics {metrics}")
    return loss


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> float:
    """One planned collect and one fit of the flagship CaDM on an
    ``n_ranks`` mesh (one process per rank; on ``cuda`` rank r takes card
    r mod the card count, and without a card it raises) → the last
    update's loss, the same on every rank."""
    model = 2 if n_ranks % 2 == 0 else 1
    device = resolve_device(device)
    devices = None if device.type == "cuda" else [device] * n_ranks
    losses = spawn(_rank, n_ranks // model, model, devices)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    print(f"dryrun_multichip ok on {n_ranks} ranks ({device}): mesh dp="
          f"{n_ranks // model} model={model} loss={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), *sys.argv[2:3])
