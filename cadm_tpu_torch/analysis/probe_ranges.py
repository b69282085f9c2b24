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
import time
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
    ``env.horizon``) at a PINNED hidden scale (``None``: the mode-0 reset's
    own scales), each env's return counted up to its first done.

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
        if scale is not None:
            states = pinned(states, scale)
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


def ppo_policy(trainer, ppo_state, dyn_state) -> dict:
    """The PPO trainer's eval policy (``PPOTrainer._eval_step``): the
    clipped deterministic mean of the policy on concat(obs, z), z from the
    pushed (never wiped) history; aux = histories."""
    model = trainer.model

    def act(states, hists, gen, t):
        mean, _ = trainer._dist(ppo_state.params, trainer._obs_z(
            dyn_state, states.obs, hists))
        return torch.clamp(mean, -1.0, 1.0), hists

    def post(hists, prev_obs, obs, actions):
        return model.push_history(dyn_state.params, dyn_state.norm, hists,
                                  prev_obs, obs - prev_obs, actions)

    return {"init": lambda n: batched_history(model.cfg, n,
                                              trainer.env.device),
            "act": act, "post": post}


def pinned(states, scale: float):
    """``states`` with every leaf of the hidden params set to ``scale``."""
    return dataclasses.replace(states, params=tree_map(
        lambda x: torch.full_like(x, scale), states.params))


def scale_seed(scale: float) -> int:
    """The script's per-scale key, ``17 + int(scale * 10)``."""
    return 17 + int(scale * 10)


def scale_sweep(env, n_envs: int, policies: dict,
                horizon: Optional[int] = None, scales=SCALES,
                tag: str = "") -> dict:
    """{scale: {policy: return mean/std, velocity return mean}} of
    ``make_rollout`` under each of ``policies`` at each scale, each scale's
    generator seeded as the script's key; ``tag`` leads the log lines.
    Beside the script's keys each record holds ``n``, the per-env
    ``returns`` and the rollout's ``wall_s``."""
    out = {}
    for pname, pol in policies.items():
        run = make_rollout(env, n_envs, pol, horizon)
        for scale in scales:
            gen = torch.Generator(device=env.device).manual_seed(
                scale_seed(scale))
            t0 = time.perf_counter()
            ret, vel = (x.cpu().numpy() for x in run(scale, gen))
            out.setdefault(str(scale), {})[pname] = {
                "return_mean": float(ret.mean()),
                "return_std": float(ret.std()),
                "velocity_return_mean": float(vel.mean()),
                "n": int(ret.size),
                "returns": ret.astype(float).tolist(),
                "wall_s": time.perf_counter() - t0,
            }
            print(f"[ranges] {tag}scale={scale} {pname}: "
                  f"ret={ret.mean():.1f}±{ret.std():.1f} "
                  f"vel_ret={vel.mean():.1f}", flush=True)
    return out


def ppo_sweep(trainer, policy: dict, dyn_state, scales=SCALES,
              key_offset: int = 0, tag: str = "", graph: bool = True) -> dict:
    """{scale or ``mode0``: record} of the PPO trainer's eval
    (``PPOTrainer.evaluate``: ``eval_envs`` envs, ``env.horizon`` steps)
    with the policy params ``policy``, from reset states pinned to each
    scale (the generator seeded with ``scale_seed`` + ``key_offset``) and
    from mode-0 resets (seed 7 + ``key_offset``): the port side of
    ``scripts/cross_eval_ranges.py`` for a PPO cell. A record holds the
    return mean, population std, ``n``, the per-env ``returns`` and the
    eval's ``wall_s`` (no velocity return: the eval does not split it
    out). ``graph=False`` rolls ``ppo_policy`` through ``make_rollout``
    instead, op by op on any device: the same episodes."""
    from cadm_tpu_torch.train.ppo import PPOState

    env, n = trainer.env, trainer.cfg.eval_envs
    ppo = PPOState(policy, None)
    rollout = make_rollout(env, n, ppo_policy(trainer, ppo, dyn_state))
    out = {}
    for scale in [*scales, None]:
        seed = 7 if scale is None else scale_seed(scale)
        gen = torch.Generator(device=env.device).manual_seed(seed + key_offset)
        start = None if scale is None else pinned(env.reset(gen, n, 0), scale)
        t0 = time.perf_counter()
        ret = (trainer.evaluate(ppo, dyn_state, 0, gen, start=start) if graph
               else rollout(scale, gen, start)[0]).cpu().numpy().astype(float)
        key = "mode0" if scale is None else str(scale)
        out[key] = {"return_mean": float(ret.mean()),
                    "return_std": float(ret.std()),
                    "velocity_return_mean": None, "n": int(ret.size),
                    "returns": ret.tolist(),
                    "wall_s": time.perf_counter() - t0}
        print(f"[ranges] {tag}{key}: ret={ret.mean():.1f}±{ret.std():.1f} "
              f"({out[key]['wall_s']:.1f} s)", flush=True)
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
