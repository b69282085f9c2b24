"""Benchmark: randomized-dynamics physics, CEM planning and model training
(counterpart of the reference's ``bench.py``).

Prints ONE JSON line to stdout; progress and a readable summary go to
stderr:

    {"metric": "halfcheetah_env_steps_per_sec_per_chip", "value": N,
     "unit": "steps/sec/chip", "vs_baseline": null,
     "secondary": {"cem_model_rollouts_per_sec": N,
                   "dynamics_train_steps_per_sec": N,
                   "slim_humanoid_env_steps_per_sec": N | null},
     "device": {"type": ..., "name": ..., "power_limit": ...},
     "shapes": {...}}

The headline is HalfCheetah env steps/s: random actions through the
batch-first ``Env.step`` (per-env hidden dynamics, auto-reset), every
substep running the smooth-stage kernel (K2) and the PGS contact solve
(K1). The 23-DOF SlimHumanoid (29 contacts) is the contact-solver stress
line; it runs on a card only and is ``null`` ("not measured") on the CPU.
``cem_model_rollouts_per_sec`` counts envs × candidates × CEM iterations ×
members, the reference's formula, although the default block TS1
(``planners/mpc.py``) rolls out each candidate under one member per step,
so the rows evaluated are a ``n_members``-th of that count.
``vs_baseline`` is null: no speed target is set for the card.

Each rate is the mean over ``ITERS`` timed calls after one warm-up call,
on the host clock, every call ended by ``torch.cuda.synchronize()`` on a
card.

    python -m cadm_tpu_torch.bench                  # full shapes, the card
    python -m cadm_tpu_torch.bench --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from cadm_tpu_torch.core.rng import rand, randn
from cadm_tpu_torch.core.types import resolve_device

# the reference's shapes (bench.py:194-201)
FULL = dict(n_envs=4096, t=100, cem_envs=256, candidates=200, horizon=30,
            batch=256, updates=50)
SMOKE = dict(n_envs=64, t=20, cem_envs=8, candidates=32, horizon=5,
             batch=32, updates=5)
ITERS = 3
CEM_ITERS = 5
MEMBERS = 5
RING = (64, 256)  # the training line's ring: envs × columns


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device) -> float:
    """Seconds per call of ``fn()``: one warm-up call, then the mean over
    ``ITERS`` calls, each ended by a synchronize on a card."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / ITERS


def _model(env, device):
    """The bench's model: 5 probabilistic CaDM members, heads 4×200."""
    from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig

    return Dynamics(
        DynamicsConfig(
            obs_dim=env.obs_dim, act_dim=env.act_dim,
            hidden=(200, 200, 200, 200), n_members=MEMBERS,
            probabilistic=True, context="encoder", z_dim=10, history_k=10,
            future_m=10,
        ),
        device=device,
    )


def bench_env_steps(n_envs: int, t: int, env_name: str = "half_cheetah",
                    device="cuda") -> float:
    """Env steps/s of ``t`` random-action steps of ``n_envs`` envs, each
    timed call starting from the same reset states."""
    from cadm_tpu_torch import envs

    device = resolve_device(device)
    env = envs.make(env_name, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    start = env.reset(gen, n_envs)

    def rollout():
        state, total = start, torch.zeros((), device=device)
        for _ in range(t):
            a = rand(gen, n_envs, env.act_dim) * 2.0 - 1.0
            state, _, r, _ = env.step(state, a, gen)
            total = total + r.sum()
        return total

    return n_envs * t / _time(rollout, device)


def bench_cem(n_envs: int, n_candidates: int, horizon: int,
              device="cuda") -> float:
    """CEM "model rollouts"/s of one plan for ``n_envs`` envs: envs ×
    candidates × CEM iterations × members over seconds (the reference's
    count; block TS1 evaluates a ``n_members``-th of it)."""
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig

    device = resolve_device(device)
    env = envs.make("half_cheetah", device=device)
    model = _model(env, device)
    planner = MPCPlanner(
        PlannerConfig(
            kind="cem", horizon=horizon, n_candidates=n_candidates,
            cem_iters=CEM_ITERS, cem_elites=max(10, n_candidates // 10),
        ),
        model, env.reward, env.act_dim,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    state = model.init_state(gen)
    obs = torch.zeros(n_envs, env.obs_dim, device=device)
    z = torch.zeros(n_envs, model.cfg.z_dim, device=device)
    dt = _time(lambda: planner.plan(state, obs, z, gen)[0], device)
    rollouts = n_envs * n_candidates * CEM_ITERS * model.cfg.n_members
    return rollouts / dt


def train_line(batch: int, updates: int, device, graph: bool = True):
    """The training line's ``fit()``: ``updates`` ``Dynamics.update``s on
    (members, ``batch``) bootstrap segment batches from a 64-env ×
    256-column ring, from the same model state at every call (the draws go
    on) → the state after. On a card each update is a replay of one
    captured graph (``train/fit_graph.py``, the reference's jitted scan of
    updates), unless ``graph`` is False."""
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.train.buffer import ReplayBuffer
    from cadm_tpu_torch.train.fit_graph import FitGraphs, fitter, ring_key
    from cadm_tpu_torch.train.step_graph import Graphs

    env = envs.make("half_cheetah", device=device)
    model = _model(env, device)
    mc = model.cfg
    gen = torch.Generator(device=device).manual_seed(0)
    state = model.init_state(gen)
    n, cols = RING
    buf = ReplayBuffer.create(n, cols, env.obs_dim, env.act_dim, device)
    obs = randn(gen, n, env.obs_dim)
    act = torch.zeros(n, env.act_dim, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    for t in range(cols):
        buf.append(obs, act, obs, done,
                   torch.full((n,), t % 100, dtype=torch.int32,
                              device=device))
    graphs = (FitGraphs(Graphs(device)) if graph and device.type == "cuda"
              else None)

    def step(st):
        idx = buf.draw_indices(gen, (mc.n_members, batch))
        return model.update(st, buf.gather(*idx, mc.history_k, mc.future_m))

    def fit():
        f = fitter(graphs, "bench", ring_key(buf), state, gen, step)
        for _ in range(updates):
            f.update()
        return f.final()

    return fit


def bench_train_steps(batch: int, updates: int, device="cuda") -> float:
    """``Dynamics.update``s/s of ``train_line``'s ``fit``."""
    device = resolve_device(device)
    return updates / _time(train_line(batch, updates, device), device)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30,
            check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small shapes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    s = SMOKE if args.smoke else FULL
    humanoid_envs = max(s["n_envs"] // 2, 8)

    def log(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    log(f"half_cheetah env steps: {s['n_envs']} envs x {s['t']} steps")
    steps_per_sec = bench_env_steps(s["n_envs"], s["t"], device=device)
    humanoid = None
    if on_card:
        log(f"slim_humanoid env steps: {humanoid_envs} envs x {s['t']} steps")
        humanoid = bench_env_steps(humanoid_envs, s["t"], "slim_humanoid",
                                   device=device)
    log(f"CEM plan: {s['cem_envs']} envs, {s['candidates']} candidates, "
        f"horizon {s['horizon']}")
    cem = bench_cem(s["cem_envs"], s["candidates"], s["horizon"],
                    device=device)
    log(f"model updates: batch {s['batch']} x {s['updates']}")
    train = bench_train_steps(s["batch"], s["updates"], device=device)
    rates = [steps_per_sec, cem, train] + ([humanoid] if on_card else [])
    if not all(math.isfinite(r) and r > 0 for r in rates):
        raise RuntimeError(f"a rate is not finite and positive: {rates}")

    name = torch.cuda.get_device_name(device) if on_card else None
    log(f"env_steps/sec={steps_per_sec:,.0f}  humanoid_steps/sec="
        f"{'not measured' if humanoid is None else f'{humanoid:,.0f}'}  "
        f"cem_rollouts/sec={cem:,.0f}  model_train_steps/sec={train:,.1f}  "
        f"(n_envs={s['n_envs']}, device={name or device.type})")
    result = {
        "metric": "halfcheetah_env_steps_per_sec_per_chip",
        "value": steps_per_sec,
        "unit": "steps/sec/chip",
        "vs_baseline": None,
        "secondary": {
            "cem_model_rollouts_per_sec": cem,
            "dynamics_train_steps_per_sec": train,
            "slim_humanoid_env_steps_per_sec": humanoid,
        },
        "device": {"type": device.type, "name": name,
                   "power_limit": power_limit() if on_card else None},
        "shapes": {
            "env_steps": {"env": "half_cheetah", "n_envs": s["n_envs"],
                          "t": s["t"]},
            "slim_humanoid": ({"n_envs": humanoid_envs, "t": s["t"]}
                              if on_card else None),
            "cem": {"n_envs": s["cem_envs"], "n_candidates": s["candidates"],
                    "horizon": s["horizon"], "cem_iters": CEM_ITERS,
                    "n_members": MEMBERS, "ensemble_eval": "ts1"},
            "train": {"batch": s["batch"], "updates": s["updates"],
                      "n_members": MEMBERS, "ring": list(RING)},
            "iters": ITERS,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
