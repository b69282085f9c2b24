#!/usr/bin/env python3
"""Where a control step's time goes, per preset, on the card.

    python scripts/profile_torch_acting.py [--steps 2]
        [--preset NAME:ENVS ...]

For each preset (default: the acting paths of chip_smoke.py, plus the
cripple_ant ensemble at its 1024 envs, plus the two PPO + CaDM presets'
collect at their 128 envs) it builds the preset on the card with random
weights from seed 0, resets ``ENVS`` envs and, after one warm-up, times
``--steps`` control steps on the host clock: plan → env step for a planner
preset (each half between synchronizes), a PPO collect of ``--steps`` steps
(policy, env step, ring append, history push) for a PPO preset. It then
profiles the same loop with ``torch.profiler`` and prints the device time
per kernel class (GEMMs, elementwise and copy/gather passes, reductions,
K1, K2), the device-idle share (1 − device time / wall, profiler on) and the
kernels with the most device time. Needs a CUDA card; prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT = ("halfcheetah_cadm_cem:2048", "cripple_ant_cadm_ensemble_cem:1024",
           "slim_humanoid_cadm_cem:512", "hopper_cadm_cem:512",
           "hopper_ppo_cadm:128", "slim_humanoid_ppo_cadm:128")
# kernel classes by name, first match wins
CLASSES = (("K1 pgs", ("pgs_kernel",)), ("K2 full_dyn", ("full_dyn_kernel",)),
           ("GEMM", ("gemm", "cutlass", "bmm", "gemv", "sm90_xmma")),
           ("gather/index/copy/cat", ("index", "gather", "scatter", "copy",
                                      "cat", "Cat")),
           ("reduction/sort", ("reduce", "Reduce", "sort", "Sort", "scan")),
           ("elementwise", ("elementwise", "vectorized", "Elementwise")))


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profiled(run):
    """(wall seconds, device kernels) of ``run()`` under torch.profiler."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [a for a in prof.key_averages()
                  if a.device_type == DeviceType.CUDA]


def report(label: str, wall: float, kernels, steps: int) -> None:
    busy = sum(a.self_device_time_total for a in kernels) / 1e6
    by_class = {}
    for a in kernels:
        c = kernel_class(a.key)
        by_class[c] = by_class.get(c, 0.0) + a.self_device_time_total / 1e6
    print(f"{label}; profiler on: wall {1e3 * wall / steps:.1f} ms, device "
          f"busy {1e3 * busy / steps:.1f} ms per step, idle "
          f"{100 * (1 - busy / wall):.1f} %, "
          f"{sum(a.count for a in kernels) / steps:.0f} kernel launches per "
          f"step")
    print("  device time by class: " + ", ".join(
        f"{c} {100 * t / busy:.1f} %"
        for c, t in sorted(by_class.items(), key=lambda kv: -kv[1])))
    for a in sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]:
        print(f"  {a.self_device_time_total / 1e3 / steps:9.2f} ms/step  "
              f"{a.count / steps:6.1f}x  {a.key[:90]}")


def profile_ppo(PRESETS, preset: str, n: int, steps: int) -> None:
    """A PPO collect of ``steps`` steps at ``n`` envs."""
    cfg = dataclasses.replace(PRESETS[preset], n_envs=n, rollout_len=steps)
    env, _, _, trainer = cfg.build("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    states, hists, buf, ppo_state, dyn = trainer.init(gen)

    def collect():
        nonlocal states, hists
        states, hists, _, _, _ = trainer._collect(gen, states, hists, buf,
                                                  ppo_state, dyn)

    collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    collect()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    wall, kernels = profiled(collect)
    report(f"{preset} at {n} envs (PPO collect, {env.frame_skip} substeps): "
           f"host clock {host_ms:.2f} ms per control step", wall, kernels,
           steps)


def profile_preset(PRESETS, preset: str, n: int, steps: int) -> None:
    from cadm_tpu_torch.core.types import batched_history

    if PRESETS[preset].trainer == "ppo":
        return profile_ppo(PRESETS, preset, n, steps)
    cfg = dataclasses.replace(PRESETS[preset], eval_envs=n)
    env, model, planner, trainer = cfg.build("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dyn = model.init_state(gen)
    states = env.reset(gen, n)
    hists = batched_history(model.cfg, n, env.device)
    plan_mu = planner.init_plan(n, env.device)
    split = {"plan": 0.0, "env step": 0.0}

    def control_step(timed: bool):
        nonlocal states, hists, plan_mu
        t0 = time.perf_counter()
        z = model.context_from_history(dyn.params, dyn.norm, hists)
        actions, plan_mu = planner.plan(dyn, states.obs, z, gen, plan_mu)
        if timed:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split["plan"] += t1 - t0
        prev = states.obs
        states, obs, _, _ = env.step(states, actions, gen)
        hists = model.push_history(dyn.params, dyn.norm, hists, prev,
                                   obs - prev, actions)
        if timed:
            torch.cuda.synchronize()
            split["env step"] += time.perf_counter() - t1

    control_step(False)
    torch.cuda.synchronize()
    for _ in range(steps):
        control_step(True)
    host_ms = {k: 1e3 * v / steps for k, v in split.items()}

    def loop():
        for _ in range(steps):
            control_step(False)

    wall, kernels = profiled(loop)
    report(f"{preset} at {n} envs ({model.cfg.n_members} member(s), "
           f"{cfg.ensemble_eval}, {env.frame_skip} substeps): host clock "
           f"plan {host_ms['plan']:.1f} ms + env step "
           f"{host_ms['env step']:.1f} ms per control step", wall, kernels,
           steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--preset", action="append", default=None,
                    help="NAME:ENVS, repeatable (default: %s)" % (DEFAULT,))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from cadm_tpu_torch.cli.presets import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for item in args.preset or DEFAULT:
        name, n = item.split(":")
        profile_preset(PRESETS, name, int(n), args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
