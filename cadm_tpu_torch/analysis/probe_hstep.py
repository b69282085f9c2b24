"""Open-loop H-step error of a model snapshot against the real env
(counterpart of scripts/probe_hstep.py).

The planner consumes H-step open-loop trajectories: predicted obs fed back
in for ``plan_horizon`` steps. This probe rolls one random action sequence
through (a) the real env, (b) the model (ensemble-mean prediction, z frozen
from each env's collected history, the planner's conditioning) and (c) each
member on its own trajectory, and reports the per-step normalized MSE
between model and real trajectories and the members' spread.

Normalization: the per-dim population std of the real trajectory's obs over
(step, env). A real-env done masks every later step of that env.

Usage:
  python -m cadm_tpu_torch.analysis.probe_hstep --cell cartpole__pets_cadm__s0
  python -m cadm_tpu_torch.analysis.probe_hstep --cell cripple_ant__cadm__s0 \\
      --horizon 30
  python -m cadm_tpu_torch.analysis.probe_hstep --ckpt snap.pt --cell fam__model__s0

Writes ``results/torch/hstep_probe/<cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from cadm_tpu_torch.analysis.snapshot import (
    add_common_args,
    load_cell,
    out_path,
    random_start,
)
from cadm_tpu_torch.core.rng import rand

OUT_DIR = out_path("hstep_probe")


@torch.no_grad()
def rollouts(env, dyn, dyn_state, env_states, hists, actions, gen):
    """(real obs (h, e, d), alive (h, e), ensemble-mean model obs (h, e, d),
    per-member model obs (h, n, e, d)) from the same start states and
    actions (h, e, act), as numpy."""
    params, norm = dyn_state.params, dyn_state.norm
    n = dyn.cfg.n_members
    obs0 = env.observe(env_states.params, env_states.phys)
    z = dyn.context_from_history(params, norm, hists)
    e = obs0.shape[0]
    z_m = z.expand(n, *z.shape)

    def predict(obs_m, a_t):   # member-leading rows (n, e, ·)
        return dyn.predict(params, norm, params["fwd"], obs_m,
                           a_t.expand(n, *a_t.shape), z_m)

    real, alive_by_step, mean_obs, member_obs = [], [], [], []
    states, alive = env_states, obs0.new_ones(e)
    obs, obs_m = obs0, obs0.expand(n, *obs0.shape)
    for a_t in actions:
        states, o, _, done = env.step(states, a_t, gen)
        alive = alive * (1.0 - done.to(o.dtype))
        real.append(o)
        alive_by_step.append(alive)
        obs = predict(obs.expand(n, *obs.shape), a_t).mean(0)
        mean_obs.append(obs)
        obs_m = predict(obs_m, a_t)
        member_obs.append(obs_m)
    return tuple(torch.stack(x).cpu().numpy()
                 for x in (real, alive_by_step, mean_obs, member_obs))


def summarize(cell, real_obs, alive, pred_obs, member_obs) -> dict:
    """The script's record from the rollouts (numpy, as the script
    computes it)."""
    h, n, e = member_obs.shape[:3]
    std = real_obs.reshape(-1, real_obs.shape[-1]).std(0) + 1e-8  # (d,)
    sq = (((pred_obs - real_obs) / std) ** 2).mean(-1)            # (h, e)
    w = alive / np.maximum(alive.sum(1, keepdims=True), 1e-8)
    mse_by_step = (sq * w).sum(1)                                 # (h,)
    m_sq = (((member_obs - real_obs[:, None]) / std) ** 2).mean(-1)  # (h,n,e)
    member_nmse_by_step = (m_sq * w[:, None]).sum(-1)                # (h, n)
    spread = ((member_obs.std(1) / std) ** 2).mean(-1)               # (h, e)
    spread_by_step = (spread * w).sum(1)                             # (h,)
    return {
        "cell": cell, "n_envs": int(e), "members": int(n), "horizon": int(h),
        "alive_frac_by_step": [round(float(v), 4) for v in alive.mean(1)],
        "openloop_nmse_by_step": [round(float(v), 4) for v in mse_by_step],
        "openloop_nmse_final": round(float(mse_by_step[-1]), 4),
        "openloop_nmse_mean": round(float(mse_by_step.mean()), 4),
        "member_nmse_final": [round(float(v), 4)
                              for v in member_nmse_by_step[-1]],
        "member_spread_by_step": [round(float(v), 4) for v in spread_by_step],
        "member_spread_final": round(float(spread_by_step[-1]), 4),
    }


def run_probe(cell: str, ckpt_path: Optional[str] = None,
              n_envs: Optional[int] = None, horizon: Optional[int] = None,
              collect_steps: Optional[int] = None, seed: int = 99,
              device="cuda", ckpt_dir: Optional[str] = None, start=None,
              actions=None) -> dict:
    """The probe's record. ``start`` (env states, histories) replaces the
    random-policy collect that warms the start states; ``actions`` (h, e,
    act) replaces the uniform action draw."""
    cfg, env, dyn, _, trainer, dyn_state = load_cell(
        cell, ckpt_path, device, ckpt_dir, n_envs=n_envs,
        steps_per_itr=collect_steps)
    h = horizon or cfg.plan_horizon
    gen = torch.Generator(device=env.device).manual_seed(seed)
    env_states, hists = (random_start(trainer, dyn_state, gen)
                         if start is None else start)
    if actions is None:
        e = env_states.obs.shape[0]
        actions = 2.0 * rand(gen, h, e, env.act_dim, dim=1) - 1.0
    return summarize(cell, *rollouts(env, dyn, dyn_state, env_states, hists,
                                     actions, gen))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="explicit snapshot path (.pt, or the reference's .pkl)")
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--collect-steps", type=int, default=None)
    ap.add_argument("--out-dir", default=OUT_DIR)
    add_common_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run_probe(args.cell, args.ckpt, args.n_envs, args.horizon,
                    args.collect_steps, device=args.device,
                    ckpt_dir=args.ckpt_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, args.cell + ".json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
