"""How often do planner-style TS1 rollouts through a model snapshot leave
the env's healthy envelope, and how soon? (counterpart of
scripts/probe_blowup.py)

Collects fresh windows in the cell's env family, rolls random candidate
action sequences through the model as the block TS1 planner does, WITHOUT
the planner's blow-up guard (the raw model is what is measured), and
reports per horizon step, averaged over the start states:

  - alive fraction (rows still inside the env's bad_transition limits),
  - max |predicted obs|,
  - non-finite fraction.

All start states roll out as one batch; each step's block→member
permutation is the argsort of uniforms.

Usage:
  python -m cadm_tpu_torch.analysis.probe_blowup --cell cripple_ant__pets_cadm__s0
  python -m cadm_tpu_torch.analysis.probe_blowup --cell half_cheetah__cadm__s0 \\
      --n-envs 16

Writes ``results/torch/blowup_probe/<cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from cadm_tpu_torch.analysis.snapshot import (
    add_common_args,
    load_cell,
    out_path,
    random_start,
)
from cadm_tpu_torch.core.rng import rand

SEED = 99  # the script's key(99)
OUT_DIR = out_path("blowup_probe")
MAX_START_STATES = 8


@torch.no_grad()
def ts1_rollout_stats(dyn, dyn_state, obs0, z, actions, perms,
                      lim_obs: float, lim_dobs: float):
    """Unguarded block-TS1 rollouts from each start state → per-step
    (alive fraction, max |pred|, non-finite fraction), each (e, h).

    ``obs0`` (e, d), ``z`` (e, ctx); ``actions`` (e, n·cm, h, act): each
    start state's candidates, block b holding candidates b·cm … (b+1)·cm−1;
    ``perms`` (e, h, n): at step t block b is integrated by member
    ``perms[:, t, b]``.
    """
    params, norm = dyn_state.params, dyn_state.norm
    n = dyn.cfg.n_members
    e, c, h, _ = actions.shape
    cm = c // n
    acts = actions.reshape(e, n, cm, h, -1)
    obs = obs0[:, None, None].expand(e, n, cm, obs0.shape[-1])
    z_b = z[None, :, None].expand(n, e, cm, z.shape[-1])
    alive = obs0.new_ones(e, n, cm)
    rows = torch.arange(e, device=obs0.device)[:, None]
    stats = []
    for t in range(h):
        perm = perms[:, t]                      # block b → member
        inv = perm.argsort(-1)                  # member m → block
        a_t = acts[:, :, :, t]
        pred = dyn.predict(params, norm, params["fwd"],
                           obs[rows, inv].transpose(0, 1),
                           a_t[rows, inv].transpose(0, 1), z_b)
        nxt = pred.transpose(0, 1)[rows, perm]  # (e, n, cm, d)
        finite = torch.isfinite(nxt).all(-1)
        bad = ((nxt.abs().amax(-1) > lim_obs)
               | ((nxt - obs).abs().amax(-1) > lim_dobs) | ~finite)
        alive = alive * (1.0 - bad.to(obs.dtype))
        mx = torch.nan_to_num(nxt, nan=torch.inf, posinf=torch.inf,
                              neginf=-torch.inf).abs().flatten(1).amax(1)
        stats.append((alive.flatten(1).mean(1), mx,
                      1.0 - finite.to(obs.dtype).flatten(1).mean(1)))
        obs = nxt
    return tuple(torch.stack(s, dim=1) for s in zip(*stats))


def draws(gen, e: int, n: int, cm: int, h: int, act_dim: int):
    """The rollout's draws: uniform candidate actions (e, n·cm, h, act) in
    [-1, 1] and the block→member permutations (e, h, n)."""
    actions = 2.0 * rand(gen, e, n * cm, h, act_dim) - 1.0
    return actions, rand(gen, e, h, n).argsort(-1)


def run_probe(cell: str, n_envs: Optional[int] = None,
              steps: Optional[int] = None, candidates: Optional[int] = None,
              device="cuda", ckpt_dir: Optional[str] = None,
              start=None, actions=None, perms=None) -> dict:
    """The probe's record. ``start`` (env states, histories) replaces the
    random-policy collect; ``actions``/``perms`` replace ``draws``."""
    cfg, env, dyn, _, trainer, dyn_state = load_cell(
        cell, device=device, ckpt_dir=ckpt_dir, n_envs=n_envs,
        steps_per_itr=steps)
    gen = torch.Generator(device=env.device).manual_seed(SEED)
    env_states, hists = (random_start(trainer, dyn_state, gen)
                         if start is None else start)
    obs_all = env.observe(env_states.params, env_states.phys)
    z_all = dyn.context_from_history(dyn_state.params, dyn_state.norm, hists)
    n = dyn.cfg.n_members
    c = candidates or cfg.n_candidates
    cm = -(-c // n)
    h = cfg.plan_horizon
    e = min(MAX_START_STATES, obs_all.shape[0])
    if actions is None:
        actions, perms = draws(gen, e, n, cm, h, env.act_dim)
    alive, mx, nonfin = (s.cpu().numpy() for s in ts1_rollout_stats(
        dyn, dyn_state, obs_all[:e], z_all[:e], actions, perms,
        env.bad_obs_limit, env.bad_dobs_limit))
    return {
        "cell": cell, "n_start_states": int(e),
        "candidates": int(c), "members": int(n), "horizon": int(h),
        "alive_frac_by_step": [round(float(v), 4) for v in alive.mean(0)],
        "max_abs_pred_by_step": [float(v) for v in mx.mean(0)],
        "nonfinite_frac_by_step": [round(float(v), 4)
                                   for v in nonfin.mean(0)],
        "alive_frac_final": round(float(alive[:, -1].mean()), 4),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--candidates", type=int, default=None)
    ap.add_argument("--out-dir", default=OUT_DIR)
    add_common_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run_probe(args.cell, args.n_envs, args.steps, args.candidates,
                    args.device, args.ckpt_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, args.cell + ".json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
