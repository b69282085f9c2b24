"""Is the hidden dynamics context linearly decodable from CaDM's latent z?
(counterpart of scripts/probe_context.py; the paper's §5.3 probing
analysis.)

Loads a cell's snapshot (``results/torch/ckpt/<cell>.pt``), collects fresh
windows in the cell's env family (the planner through the snapshot, or
random actions, the only choice on a shifted range), encodes each env's
K-window to z and fits closed-form linear decoders z → hidden params:

  - continuous targets (mass_scale, damping_scale, pole length, push
    force ...): ridge regression, held-out R² per target;
  - CrippleAnt's leg id: one-hot least squares → argmax, held-out accuracy
    against the majority share.

Windows that straddle a reset are dropped. The decoders run in numpy
float64, as the script's.

Usage:
  python -m cadm_tpu_torch.analysis.probe_context --cell cartpole__cadm__s0
  python -m cadm_tpu_torch.analysis.probe_context --cell cripple_ant__cadm__s0 \\
      --random-policy --mode 1

Writes ``results/torch/context_probe/<cell>[__mode<m>].json`` (and with
``--save-arrays`` the (z, targets) npz beside it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from cadm_tpu_torch.analysis.snapshot import (
    add_common_args,
    load_cell,
    out_path,
    split_cell,
)
from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.core.types import batched_history, tree_map, tree_where
from cadm_tpu_torch.envs.ant import LEG_ACTUATORS

SEED = 1234  # the script's key(1234)
OUT_DIR = out_path("context_probe")


def targets_from_params(family: str, params) -> dict:
    """Per-env decode targets (each an (E,) float64 array) from the hidden
    params the env sampled at reset."""
    p = {f.name: getattr(params, f.name).detach().cpu().numpy()
         for f in dataclasses.fields(params)}
    if family == "cripple_ant":
        # the crippled leg is the actuator group the mask zeroes
        mask = p["act_mask"]
        legs = np.full(mask.shape[0], -1)
        for leg, acts in enumerate(LEG_ACTUATORS):
            zeroed = (mask[:, list(acts)] == 0.0).all(axis=1)
            legs[zeroed] = leg
        return {"crippled_leg": legs.astype(np.float64)}
    return {k: v.astype(np.float64) for k, v in p.items() if v.ndim == 1}


def ridge_r2(z: np.ndarray, y: np.ndarray, lam: float = 1e-3):
    """Held-out R² of a ridge decoder z -> y (half/half split)."""
    n = z.shape[0]
    idx = np.random.RandomState(0).permutation(n)
    tr, te = idx[: n // 2], idx[n // 2:]
    x = np.concatenate([z, np.ones((n, 1))], axis=1)
    a = x[tr].T @ x[tr] + lam * np.eye(x.shape[1])
    w = np.linalg.solve(a, x[tr].T @ y[tr])
    pred = x[te] @ w
    ss_res = ((y[te] - pred) ** 2).sum()
    ss_tot = ((y[te] - y[te].mean()) ** 2).sum() + 1e-12
    return 1.0 - ss_res / ss_tot


def onehot_accuracy(z: np.ndarray, labels: np.ndarray, lam: float = 1e-3):
    """Held-out argmax accuracy of a one-hot least-squares decoder →
    (accuracy, majority share, number of classes)."""
    classes = np.unique(labels)
    y = (labels[:, None] == classes[None, :]).astype(np.float64)
    n = z.shape[0]
    idx = np.random.RandomState(0).permutation(n)
    tr, te = idx[: n // 2], idx[n // 2:]
    x = np.concatenate([z, np.ones((n, 1))], axis=1)
    a = x[tr].T @ x[tr] + lam * np.eye(x.shape[1])
    w = np.linalg.solve(a, x[tr].T @ y[tr])
    pred = classes[np.argmax(x[te] @ w, axis=1)]
    acc = float((pred == labels[te]).mean())
    chance = float(max((labels[te] == c).mean() for c in classes))
    return acc, chance, len(classes)


def decode(z: np.ndarray, targets: dict) -> dict:
    """Each target's decoder result, as the script's ``targets`` entry."""
    out = {}
    for name, y in targets.items():
        if name == "crippled_leg":
            acc, chance, k = onehot_accuracy(z, y)
            out[name] = {"decoder": "onehot-lstsq", "held_out_accuracy": acc,
                         "majority_chance": chance, "n_classes": k}
        else:
            out[name] = {"decoder": "ridge",
                         "held_out_r2": float(ridge_r2(z, y))}
    return out


@torch.no_grad()
def collect_random(env, dyn, dyn_state, n_envs: int, steps: int, mode: int,
                   gen: torch.Generator, start=None, actions=None):
    """A random-policy collect on range ``mode`` → (env states, histories).

    Every env resets on ``mode`` (or starts from the injected ``start``
    states), takes ``steps`` uniform actions in [-1, 1] (or the injected
    ``actions``, (steps, E, act)), pushes each transition into its history
    and wipes the history where the step ended the episode, as the
    trainer's collect does.
    """
    states = env.reset(gen, n_envs, mode) if start is None else start
    hists = batched_history(dyn.cfg, n_envs, env.device)
    params, norm = dyn_state.params, dyn_state.norm
    for t in range(steps):
        obs = env.observe(states.params, states.phys)
        a = (actions[t] if actions is not None
             else 2.0 * rand(gen, n_envs, env.act_dim) - 1.0)
        states, nobs, _, done = env.step(states, a, gen, mode)
        pushed = dyn.push_history(params, norm, hists, obs, nobs - obs, a)
        hists = tree_where(done, tree_map(torch.zeros_like, pushed), pushed)
    return states, hists


def full_windows(dyn, dyn_state, env_states, hists, family: str):
    """(z, targets) of the envs whose K-window holds no reset: z as float64
    numpy, targets from ``targets_from_params``."""
    z = dyn.context_from_history(dyn_state.params, dyn_state.norm, hists)
    full = (hists.valid.min(dim=-1).values > 0).cpu().numpy()
    z = z.detach().cpu().numpy().astype(np.float64)[full]
    return z, {k: v[full] for k, v in
               targets_from_params(family, env_states.params).items()}


def run_probe(cell: str, rounds: int = 2, random_policy: bool = False,
              mode: int = 0, n_envs: Optional[int] = None,
              steps: Optional[int] = None, device="cuda",
              ckpt_dir: Optional[str] = None,
              starts=None, actions=None, log=print):
    """The probe's record, and the (z, targets) arrays it decoded.

    ``starts``/``actions`` inject each round's reset states and actions
    into the random-policy collector (lists of ``rounds``). The planner
    collect (mode 0 without ``random_policy``) is the trainer's own,
    continued over the rounds from one ``init``.
    """
    family = split_cell(cell)[0]
    cfg, env, dyn, _, trainer, dyn_state = load_cell(
        cell, device=device, ckpt_dir=ckpt_dir, n_envs=n_envs,
        steps_per_itr=steps)
    random = random_policy or mode != 0
    gen = torch.Generator(device=env.device).manual_seed(SEED)
    if not random:
        env_states, hists, buffer, _ = trainer.init(gen)
    zs, tgts = [], None
    for r in range(rounds):
        if random:
            env_states, hists = collect_random(
                env, dyn, dyn_state, cfg.n_envs, cfg.steps_per_itr, mode, gen,
                None if starts is None else starts[r],
                None if actions is None else actions[r])
        else:
            env_states, hists, buffer, _ = trainer._collect(
                gen, env_states, hists, buffer, dyn_state,
                random_actions=False)
        z, t = full_windows(dyn, dyn_state, env_states, hists, family)
        zs.append(z)
        tgts = t if tgts is None else {
            k: np.concatenate([tgts[k], t[k]]) for k in t}
        log(f"[probe-context] round {r}: {z.shape[0]} full windows")
    z = np.concatenate(zs, axis=0)
    out = {"cell": cell, "n_windows": int(z.shape[0]),
           "z_dim": int(z.shape[1]), "mode": mode,
           "policy": "random" if random else "planner",
           "targets": decode(z, tgts)}
    return out, z, tgts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", required=True,
                    help="e.g. cripple_ant__cadm__s0 (needs <ckpt-dir>/<cell>.pt)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="collect rounds; samples = rounds * n_envs")
    ap.add_argument("--random-policy", action="store_true",
                    help="collect with random actions instead of the planner")
    ap.add_argument("--mode", type=int, default=0,
                    help="hidden-param range: 0 train / 1 moderate / 2 extreme")
    ap.add_argument("--n-envs", type=int, default=None,
                    help="override the cell's env batch")
    ap.add_argument("--steps", type=int, default=None,
                    help="override steps_per_itr for the collect rounds")
    ap.add_argument("--save-arrays", action="store_true",
                    help="also save the raw (z, targets) to <cell>.npz")
    ap.add_argument("--out-dir", default=OUT_DIR)
    add_common_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out, z, tgts = run_probe(args.cell, args.rounds, args.random_policy,
                             args.mode, args.n_envs, args.steps, args.device,
                             args.ckpt_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    suffix = "" if args.mode == 0 else f"__mode{args.mode}"
    base = os.path.join(args.out_dir, args.cell + suffix)
    with open(base + ".json", "w") as f:
        json.dump(out, f, indent=2)
    if args.save_arrays:
        np.savez(base + ".npz", z=z, **tgts)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
