"""Range-potency probe: do the shifted dynamics ranges change the task?
(counterpart of scripts/probe_ranges.py)

Rolls the true simulator at FIXED hidden scales, with no learned-model
adaptation in the way, under (a) a uniform random policy and (b) a planner
through a Vanilla snapshot (``<family>__vanilla__s0``, when it exists),
and splits the return into its velocity part (the obs's forward velocity,
``env._vx_index``) and the rest. If even the planner's velocity return
barely moves from scale 0.2 to 1.8, the family does not separate under this
protocol.

The pinned scale replaces EVERY leaf of the env's hidden params (as the
script's ``tree_map(full_like)``): CrippleAnt's actuator mask too.

Usage:
  python -m cadm_tpu_torch.analysis.probe_ranges --families hopper slim_humanoid half_cheetah

Writes (updates) ``results/torch/range_potency.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import torch

from cadm_tpu_torch.analysis.snapshot import (
    add_common_args,
    cell_config,
    out_path,
    read_snapshot,
)
from cadm_tpu_torch.cli.matrix import cell_name
from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.core.types import batched_history, tree_map

OUT_PATH = out_path("range_potency.json")
SCALES = [0.2, 0.5, 1.0, 1.5, 1.8]


def make_rollout(env, n_envs: int, policy: dict,
                 horizon: Optional[int] = None):
    """``run(scale, gen, start=None) -> (return, velocity return)``, each
    (n_envs,): one fixed-horizon episode per env (``horizon``, default
    ``env.horizon``) at a PINNED hidden scale, each env's return counted up
    to its first done.

    ``policy`` is a dict of closures: ``init(n) -> aux``, ``act(states, aux,
    gen, t) -> (actions, aux)``, ``post(aux, prev_obs, obs, actions) ->
    aux``. ``start`` replaces the reset states (their params are pinned all
    the same).
    """
    vx_index = getattr(env, "_vx_index", None)
    horizon = horizon or env.horizon

    @torch.no_grad()
    def run(scale: float, gen: torch.Generator, start=None):
        states = env.reset(gen, n_envs, 0) if start is None else start
        states = dataclasses.replace(states, params=tree_map(
            lambda x: torch.full_like(x, scale), states.params))
        aux = policy["init"](n_envs)
        ret = torch.zeros(n_envs, device=env.device)
        vel_ret = torch.zeros(n_envs, device=env.device)
        alive = torch.ones(n_envs, device=env.device)
        for t in range(horizon):
            actions, aux = policy["act"](states, aux, gen, t)
            prev_obs = states.obs
            states, obs, reward, done = env.step(states, actions, gen, 0)
            aux = policy["post"](aux, prev_obs, obs, actions)
            ret = ret + reward * alive
            if vx_index is not None:
                vel_ret = vel_ret + obs[:, vx_index] * alive
            alive = alive * (1.0 - done.float())
        return ret, vel_ret

    return run


def random_policy(env, actions=None) -> dict:
    """Uniform actions in [-1, 1]; ``actions`` (horizon, n, act) replaces
    the draws."""
    def act(states, aux, gen, t):
        if actions is not None:
            return actions[t], aux
        return 2.0 * rand(gen, states.obs.shape[0], env.act_dim) - 1.0, aux

    return {"init": lambda n: None, "act": act,
            "post": lambda aux, prev, obs, a: aux}


def planner_policy(env, model, planner, dyn_state) -> dict:
    """Plan through ``dyn_state``; aux = (histories, warm-start plan)."""
    def act(states, aux, gen, t):
        hists, plan_mu = aux
        z = model.context_from_history(dyn_state.params, dyn_state.norm, hists)
        actions, plan_mu = planner.plan(dyn_state, states.obs, z, gen, plan_mu)
        return actions, (hists, plan_mu)

    def post(aux, prev_obs, obs, actions):
        hists, plan_mu = aux
        hists = model.push_history(dyn_state.params, dyn_state.norm, hists,
                                   prev_obs, obs - prev_obs, actions)
        return hists, plan_mu

    return {"init": lambda n: (batched_history(model.cfg, n, env.device),
                               planner.init_plan(n, env.device)),
            "act": act, "post": post}


def scale_seed(scale: float) -> int:
    """The script's per-scale key, ``17 + int(scale * 10)``."""
    return 17 + int(scale * 10)


def scale_sweep(env, n_envs: int, policies: dict,
                horizon: Optional[int] = None, scales=SCALES,
                tag: str = "") -> dict:
    """{scale: {policy: return mean/std, velocity return mean}} of
    ``make_rollout`` under each of ``policies`` at each scale, each scale's
    generator seeded as the script's key; ``tag`` leads the log lines."""
    out = {}
    for pname, pol in policies.items():
        run = make_rollout(env, n_envs, pol, horizon)
        for scale in scales:
            gen = torch.Generator(device=env.device).manual_seed(
                scale_seed(scale))
            ret, vel = (x.cpu().numpy() for x in run(scale, gen))
            out.setdefault(str(scale), {})[pname] = {
                "return_mean": float(ret.mean()),
                "return_std": float(ret.std()),
                "velocity_return_mean": float(vel.mean()),
            }
            print(f"[ranges] {tag}scale={scale} {pname}: "
                  f"ret={ret.mean():.1f}±{ret.std():.1f} "
                  f"vel_ret={vel.mean():.1f}", flush=True)
    return out


def probe_family(family: str, n_envs: int, device, ckpt_dir: str,
                 horizon: Optional[int] = None) -> dict:
    """The family's record: the random policy's and (with the family's
    Vanilla snapshot in ``ckpt_dir``) the planner's returns at each
    scale."""
    cfg = cell_config(cell_name(family, "vanilla", 0))
    env, model, planner, _ = cfg.build(device)
    policies = {"random": random_policy(env)}
    ckpt = os.path.join(ckpt_dir, cell_name(family, "vanilla", 0) + ".pt")
    if os.path.exists(ckpt):
        policies["planner_vanilla_s0"] = planner_policy(
            env, model, planner, read_snapshot(model, ckpt, device))
    return {"horizon": horizon or env.horizon,
            "alive_bonus": float(getattr(env, "alive_bonus", 0.0)),
            "n_envs": n_envs,
            "scales": scale_sweep(env, n_envs, policies, horizon,
                                  tag=family + " ")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--families", nargs="*",
                    default=["hopper", "slim_humanoid", "half_cheetah"])
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=None,
                    help="episode length (default: the env's horizon)")
    ap.add_argument("--out", default=OUT_PATH)
    add_common_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for family in args.families:
        results[family] = probe_family(family, args.n_envs, args.device,
                                       args.ckpt_dir, args.horizon)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(f"[ranges] wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
