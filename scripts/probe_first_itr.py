"""The first iteration of a PPO + CaDM cell, at many seeds, in either package.

Each seed runs what ``train`` runs before its first eval: ``init``, the
first collect, the PPO update and the model fit, at the cell's full width
(``cli/matrix.py``'s tables, the reference's ``scripts/run_matrix.py``).
Per seed it records the collect's reward per env and its parts (the mean
forward velocity and the mean control cost per step, reward = vx −
ctrl_cost·|a|²), the policy's initial mean action size, the first PPO
losses and the fit's last and valid losses, so the two packages' first
iterations can be set beside each other as distributions: the RNG streams
differ, so they agree as distributions, not seed by seed.

  python scripts/probe_first_itr.py --side port --seeds 20
      the port (``--device``, default cuda), each iteration graphed on the
      card as in the cell
  JAX_PLATFORMS=cpu taskset -c 4-7 python scripts/probe_first_itr.py \\
          --side jax --seeds 20
      the JAX package on the CPU
  python scripts/probe_first_itr.py --side compare
      per metric the two means, their standard errors and whether they
      agree within 2·√(SE_port² + SE_jax²)

Writes ``results/torch/first_itr/<cell>.<side>.json``. The port side
imports nothing of JAX; the JAX side nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "results", "torch", "first_itr")
METRICS = ("reward_per_env", "vx_per_step", "ctrl_per_step", "mean_abs_mu",
           "ppo_loss_first", "ppo_loss_last", "fit_loss_last", "fit_valid")


def row(reward, act, mean, ctrl_cost, ppo, fit) -> dict:
    """One seed's record from the collect's (T, E) rewards, (T, E, act)
    actions, the policy's (T, E, act) means, and the update's and fit's
    metrics (numpy)."""
    ctrl = ctrl_cost * float(np.mean(np.sum(act ** 2, axis=-1)))
    return {"reward_per_env": float(reward.sum(0).mean()),
            "vx_per_step": float(reward.mean()) + ctrl,
            "ctrl_per_step": ctrl,
            "mean_abs_mu": float(np.mean(np.abs(mean))),
            "ppo_loss_first": float(ppo["ppo/loss_first"]),
            "ppo_loss_last": float(ppo["ppo/loss_last"]),
            "fit_loss_last": float(fit["fit/model_loss_last"]),
            "fit_valid": float(fit["fit/valid_loss"])}


def port_side(args) -> dict:
    import torch

    from cadm_tpu_torch.cli.matrix import card, cell_config

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        _, _, _, tr = cell_config(args.family, args.model, seed).build(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        states, hists, buf, ps, dyn = tr.init(gen)
        _, _, buf, traj, last = tr._collect(gen, states, hists, buf, ps, dyn)
        traj.pop("ep_return")
        mean = tr._dist(ps.params, traj["obs_z"])[0]
        _, ppo = tr._ppo_update(gen, ps, traj, last)
        _, fit = tr._fit_model(gen, buf, dyn)
        rows.append(dict(row(*(x.cpu().numpy() for x in (
            traj["reward"], traj["act"], mean)), tr.env.ctrl_cost, ppo, fit),
            seed=seed, wall_s=time.perf_counter() - t0))
        print(f"[first_itr] port s{seed}: {rows[-1]}", flush=True)
    return {"side": "port", "device": card(device), "rows": rows}


def jax_side(args) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from cadm_tpu.cli.presets import ExperimentConfig
    from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS

    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        cfg = ExperimentConfig(**{**FAMILY_BASE[args.family],
                                  **MODEL_VARIANTS[args.model]},
                               seed=seed, eval_modes=(0, 1, 2))
        _, _, _, tr = cfg.build()
        if seed == 0:
            init = jax.jit(tr.init)
        else:   # the same programs: keep the compiled ones
            tr._collect, tr._ppo_update, tr._fit_model = programs
        # train's own key schedule up to its first eval
        r_init, rng = jax.random.split(jax.random.key(seed))
        _, k_col, k_ppo, k_fit, _ = jax.random.split(rng, 5)
        states, hists, buf, ps, dyn = init(r_init)
        _, _, buf, traj, last = tr._collect(k_col, states, hists, buf, ps, dyn)
        traj = dict(traj)
        traj.pop("ep_return")
        mean = tr._dist(ps.params, traj["obs_z"])[0]
        _, ppo = tr._ppo_update(k_ppo, ps, traj, last)
        _, fit = tr._fit_model(k_fit, buf, dyn)
        programs = (tr._collect, tr._ppo_update, tr._fit_model)
        rows.append(dict(row(*(np.asarray(x) for x in (
            traj["reward"], traj["act"], mean)), tr.env.ctrl_cost, ppo, fit),
            seed=seed, wall_s=time.perf_counter() - t0))
        print(f"[first_itr] jax s{seed}: {rows[-1]}", flush=True)
    return {"side": "jax", "device": f"CPU, {len(os.sched_getaffinity(0))} "
            f"cores, jax {jax.__version__}", "rows": rows}


def compare(port: dict, jax_: dict) -> dict:
    """Per metric: each side's mean, SE (sample std / √n) and n, and
    whether |Δ| ≤ 2·√(SE_port² + SE_jax²)."""
    out = {}
    for m in METRICS:
        sides = {}
        for name, side in (("port", port), ("jax", jax_)):
            x = np.array([r[m] for r in side["rows"]])
            sides[name] = (float(x.mean()), float(x.std(ddof=1) /
                                                  math.sqrt(x.size)), x.size)
        (pm, ps, pn), (jm, js, jn) = sides["port"], sides["jax"]
        bound = 2.0 * math.sqrt(ps ** 2 + js ** 2)
        out[m] = {"port_mean": pm, "port_se": ps, "port_n": pn,
                  "jax_mean": jm, "jax_se": js, "jax_n": jn,
                  "delta": pm - jm, "bound": bound,
                  "agree": abs(pm - jm) <= bound}
        print(f"[first_itr] {m}: port {pm:.4f} ± {ps:.4f} (n {pn}), jax "
              f"{jm:.4f} ± {js:.4f} (n {jn}): |Δ| {abs(pm - jm):.4f} vs 2 SE "
              f"{bound:.4f} → {'agree' if out[m]['agree'] else 'DIFFER'}",
              flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", required=True, choices=["port", "jax",
                                                      "compare"])
    ap.add_argument("--family", default="half_cheetah")
    ap.add_argument("--model", default="ppo_cadm")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="port: torch device")
    args = ap.parse_args(argv)
    cell = f"{args.family}__{args.model}"
    path = lambda side: os.path.join(OUT_DIR, f"{cell}.{side}.json")  # noqa: E731
    if args.side == "compare":
        sides = []
        for side in ("port", "jax"):
            with open(path(side)) as f:
                sides.append(json.load(f))
        out = compare(*sides)
    else:
        out = (port_side if args.side == "port" else jax_side)(args)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path(args.side), "w") as f:
        json.dump(out, f, indent=1)
    print(f"[first_itr] wrote {path(args.side)}", flush=True)


if __name__ == "__main__":
    main()
