"""The first iterations of a PPO + CaDM cell, at many seeds, in either package.

Each seed runs what ``train`` runs, evals left out: ``init``, then
``--itrs`` iterations of collect, PPO update and model fit, at the cell's
full width (``cli/matrix.py``'s tables, the reference's
``scripts/run_matrix.py``); the JAX side splits its keys as ``train``
does (cadm_tpu/train/ppo.py:409-420). Per (seed, iteration) it records the
collect's reward per env and its parts (the mean forward velocity and the
mean control cost per step, reward = vx − ctrl_cost·|a|²), the policy's
mean action size before the update, the PPO losses, the fit's last and
valid losses, and after the iteration the policy's mean ``log_std``, the
norm's mean obs std and the ring's size, so the two packages' iterations
can be set beside each other as distributions: the RNG streams differ, so
they agree as distributions, not seed by seed.

  python scripts/probe_first_itr.py --side port --seeds 20
      the port (``--device``, default cuda), each iteration graphed on the
      card as in the cell
  JAX_PLATFORMS=cpu taskset -c 4-7 python scripts/probe_first_itr.py \\
          --side jax --seeds 20
      the JAX package on the CPU
  python scripts/probe_first_itr.py --side compare
      per metric (and iteration) the two means, their standard errors and
      whether they agree within 2·√(SE_port² + SE_jax²)

``--itrs k`` (default 1) runs k iterations; ``--seed-from A`` starts at
seed A, so one side can run as several processes (``taskset -c 0-3`` /
``4-7``), each writing a part that ``compare`` joins. A side's file is
written after each seed, so a cut run keeps the seeds it finished. Writes
``results/torch/first_itr/<cell>[.k<k>].<side>[.from<A>].json``: the k = 1
files keep their names. With k > 1 ``compare`` also names, per metric, the
first iteration that begins a run of three iterations outside 2 SE (a lone
miss among some 200 comparisons is expected by chance). The port side
imports nothing of JAX; the JAX side nothing of the port.
"""
from __future__ import annotations

import argparse
import glob
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
# recorded with k > 1: the state after each iteration
STATE_METRICS = ("log_std", "norm_obs_std", "ring_size")
RUN = 3  # consecutive iterations outside 2 SE that make a parting


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


def ctrl_weight(env) -> float:
    """The env's control-cost weight (0 where its reward has none: its
    ``vx_per_step`` is then the mean reward)."""
    return getattr(env, "ctrl_cost", 0.0)


def port_iterations(tr, gen, k: int):
    """The port's ``train`` without its evals, from ``tr.init(gen)``:
    yields (itr, row) for k iterations and returns the state after the
    last, (env states, histories, ring, PPO state, model state)."""
    state = tr.init(gen)
    for itr in range(k):
        states, hists, buf, ps, dyn = state
        states, hists, buf, traj, last = tr._collect(gen, states, hists,
                                                      buf, ps, dyn)
        traj.pop("ep_return")
        mean = tr._dist(ps.params, traj["obs_z"])[0]
        ps, ppo = tr._ppo_update(gen, ps, traj, last)
        dyn, fit = tr._fit_model(gen, buf, dyn)
        r = row(*(x.cpu().numpy() for x in (traj["reward"], traj["act"],
                                             mean)), ctrl_weight(tr.env), ppo,
                fit)
        r.update(log_std=float(ps.params["log_std"].mean()),
                 norm_obs_std=float(dyn.norm.obs_std.mean()),
                 ring_size=int(buf.size))
        state = (states, hists, buf, ps, dyn)
        yield itr, r
    return state


def port_side(args, save=None) -> dict:
    """The port's rows; ``save`` gets the record so far after each seed."""
    import torch

    from cadm_tpu_torch.cli.matrix import card

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    rows = []
    for seed in seeds(args):
        t0 = time.perf_counter()
        tr = port_trainer(args.family, args.model, seed, device, args.width)
        gen = torch.Generator(device=device).manual_seed(seed)
        for itr, r in port_iterations(tr, gen, args.itrs):
            rows.append(record(args, r, seed, itr, t0))
            t0 = time.perf_counter()
            print(f"[first_itr] port s{seed} itr {itr}: {rows[-1]}",
                  flush=True)
        out = {"side": "port", "device": card(device), "itrs": args.itrs,
               "rows": rows}
        if save is not None:
            save(out)
    return out


def port_trainer(family: str, model: str, seed: int, device, width=()):
    """The port's trainer of the cell at ``seed`` (``width``: KEY=VALUE
    overrides of the config, for a test at toy width)."""
    import dataclasses

    from cadm_tpu_torch.cli.matrix import cell_config

    cfg = dataclasses.replace(cell_config(family, model, seed),
                              **overrides(width))
    return cfg.build(device)[3]


def overrides(width) -> dict:
    """``KEY=VALUE`` strings → config fields (a comma makes a tuple of
    ints)."""
    out = {}
    for kv in width:
        k, v = kv.split("=", 1)
        out[k] = (tuple(int(x) for x in v.split(",") if x) if "," in v
                  else json.loads(v))
    return out


def seeds(args) -> range:
    return range(args.seed_from, args.seed_from + args.seeds)


def record(args, r: dict, seed: int, itr: int, t0: float) -> dict:
    """One row of the output: k = 1 keeps its earlier keys."""
    if args.itrs == 1:
        r = {m: r[m] for m in METRICS}
        return dict(r, seed=seed, wall_s=time.perf_counter() - t0)
    return dict(r, seed=seed, itr=itr, wall_s=time.perf_counter() - t0)


def jax_trainer(family: str, model: str, seed: int, programs=None,
                width=()):
    """The JAX package's trainer of the cell at ``seed``; ``programs``:
    another seed's (init, collect, update, fit) programs, which it takes
    over (the same programs: no compile); ``width`` as ``port_trainer``.
    Returns (trainer, programs)."""
    import jax

    from cadm_tpu.cli.presets import ExperimentConfig
    from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS

    cfg = ExperimentConfig(**{**FAMILY_BASE[family], **MODEL_VARIANTS[model],
                              **overrides(width)},
                           seed=seed, eval_modes=(0, 1, 2))
    _, _, _, tr = cfg.build()
    if programs is None:
        init = tr.init

        @jax.jit
        def typed_init(rng):
            # log_std is weak-typed at init, so the second iteration would
            # compile the collect and the update again: the same values,
            # typed
            states, hists, buf, ps, dyn = init(rng)
            return (states, hists, buf,
                    jax.tree.map(lambda x: x.astype(x.dtype), ps), dyn)

        programs = (typed_init, tr._collect, tr._ppo_update, tr._fit_model)
    tr.init, tr._collect, tr._ppo_update, tr._fit_model = programs
    return tr, programs


def jax_iterations(tr, seed: int, k: int):
    """The JAX package's ``train`` without its evals, its keys split as
    ``train`` splits them: yields (itr, row) for k iterations and returns
    (the state after the last, as ``port_iterations``, and the key that
    ``train`` splits next)."""
    import jax

    r_init, rng = jax.random.split(jax.random.key(seed))
    state = tr.init(r_init)
    for itr in range(k):
        rng, k_col, k_ppo, k_fit, _ = jax.random.split(rng, 5)
        states, hists, buf, ps, dyn = state
        states, hists, buf, traj, last = tr._collect(k_col, states, hists,
                                                      buf, ps, dyn)
        traj = dict(traj)
        traj.pop("ep_return")
        mean = tr._dist(ps.params, traj["obs_z"])[0]
        ps, ppo = tr._ppo_update(k_ppo, ps, traj, last)
        dyn, fit = tr._fit_model(k_fit, buf, dyn)
        r = row(*(np.asarray(x) for x in (traj["reward"], traj["act"],
                                           mean)), ctrl_weight(tr.env), ppo,
                fit)
        r.update(log_std=float(np.mean(ps.params["log_std"])),
                 norm_obs_std=float(np.mean(dyn.norm.obs_std)),
                 ring_size=int(buf.size))
        state = (states, hists, buf, ps, dyn)
        yield itr, r
    return state, rng


def exhaust(iterations):
    """Run ``port_iterations``/``jax_iterations`` to their end → what they
    return."""
    while True:
        try:
            next(iterations)
        except StopIteration as stop:
            return stop.value


def jax_side(args, programs=None, save=None):
    """The JAX rows → (record, the trainer's programs); ``programs``: those
    of an earlier call at the same width, taken over; ``save`` gets the
    record so far after each seed."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    rows = []
    for seed in seeds(args):
        t0 = time.perf_counter()
        tr, programs = jax_trainer(args.family, args.model, seed, programs,
                                   args.width)
        for itr, r in jax_iterations(tr, seed, args.itrs):
            rows.append(record(args, r, seed, itr, t0))
            t0 = time.perf_counter()
            print(f"[first_itr] jax s{seed} itr {itr}: {rows[-1]}",
                  flush=True)
        out = {"side": "jax", "device": f"CPU, "
               f"{len(os.sched_getaffinity(0))} cores, jax {jax.__version__}",
               "itrs": args.itrs, "rows": rows}
        if save is not None:
            save(out)
    return out, programs


def verdict(port_x, jax_x) -> dict:
    """Each side's mean, SE (sample std / √n) and n, Δ, and whether
    |Δ| ≤ 2·√(SE_port² + SE_jax²)."""
    sides = []
    for x in (port_x, jax_x):
        x = np.asarray(x, np.float64)
        sides.append((float(x.mean()), float(x.std(ddof=1) /
                                             math.sqrt(x.size)), x.size))
    (pm, ps, pn), (jm, js, jn) = sides
    bound = 2.0 * math.sqrt(ps ** 2 + js ** 2)
    return {"port_mean": pm, "port_se": ps, "port_n": pn,
            "jax_mean": jm, "jax_se": js, "jax_n": jn,
            "delta": pm - jm, "bound": bound,
            "agree": abs(pm - jm) <= bound}


def say(name: str, v: dict) -> None:
    print(f"[first_itr] {name}: port {v['port_mean']:.4f} ± "
          f"{v['port_se']:.4f} (n {v['port_n']}), jax {v['jax_mean']:.4f} ± "
          f"{v['jax_se']:.4f} (n {v['jax_n']}): |Δ| {abs(v['delta']):.4f} "
          f"vs 2 SE {v['bound']:.4f} → "
          f"{'agree' if v['agree'] else 'DIFFER'}", flush=True)


def first_parting(agree) -> int | None:
    """The first index that begins ``RUN`` consecutive disagreements."""
    for i in range(len(agree) - RUN + 1):
        if not any(agree[i:i + RUN]):
            return i
    return None


def compare(port: dict, jax_: dict) -> dict:
    """k = 1: per metric ``verdict``. k > 1: per metric and iteration, and
    per metric the first parting iteration (``first_parting``), with the
    first over all metrics; and per metric the verdict on each seed's mean
    over the k iterations (``pooled``: a shift that persists over
    iterations, which the per-iteration verdicts see one at a time)."""
    itrs = port.get("itrs", 1)
    if itrs == 1:
        out = {}
        for m in METRICS:
            out[m] = verdict([r[m] for r in port["rows"]],
                             [r[m] for r in jax_["rows"]])
            say(m, out[m])
        return out
    if jax_.get("itrs") != itrs:
        raise ValueError(f"the sides ran {itrs} and {jax_.get('itrs')} "
                         "iterations")
    by_metric, parts, pooled = {}, {}, {}
    for m in METRICS + STATE_METRICS:
        per_itr = []
        for itr in range(itrs):
            px, jx = ([r[m] for r in side["rows"] if r["itr"] == itr]
                      for side in (port, jax_))
            if m == "ring_size" and len(set(px + jx)) == 1:
                v = dict(verdict(px, jx), agree=True)  # no spread: equal
            else:
                v = verdict(px, jx)
            per_itr.append(dict(v, itr=itr))
            say(f"{m} itr {itr}", per_itr[-1])
        by_metric[m] = per_itr
        parts[m] = first_parting([v["agree"] for v in per_itr])
        if m != "ring_size":
            pooled[m] = verdict(*([np.mean([r[m] for r in side["rows"]
                                            if r["seed"] == s])
                                   for s in sorted({r["seed"]
                                                    for r in side["rows"]})]
                                  for side in (port, jax_)))
            say(f"{m} pooled over itrs 0-{itrs - 1}", pooled[m])
    parted = [i for i in parts.values() if i is not None]
    first = min(parted) if parted else None
    seeds = {name: sorted({r["seed"] for r in side["rows"]})
             for name, side in (("port", port), ("jax", jax_))}
    out = {"itrs": itrs, "seeds": seeds, "run": RUN,
           "first_parting_itr": first if first is not None else
           f"none by {itrs}",
           "first_parting_by_metric": parts,
           "misses": sum(not v["agree"] for per in by_metric.values()
                         for v in per),
           "comparisons": sum(len(per) for per in by_metric.values()),
           "pooled": pooled, "metrics": by_metric}
    print(f"[first_itr] first parting iteration (3 consecutive misses): "
          f"{out['first_parting_itr']}; by metric {parts}; "
          f"{out['misses']} misses in {out['comparisons']}", flush=True)
    return out


def side_path(out_dir: str, cell: str, itrs: int, side: str,
              seed_from: int = 0) -> str:
    stem = cell if itrs == 1 else f"{cell}.k{itrs}"
    part = f".from{seed_from}" if seed_from else ""
    return os.path.join(out_dir, f"{stem}.{side}{part}.json")


def load_side(out_dir: str, cell: str, itrs: int, side: str) -> dict:
    """A side's rows, its parts (``--seed-from``) joined."""
    first = side_path(out_dir, cell, itrs, side)
    paths = [first] + sorted(glob.glob(first[:-len(".json")] + ".from*.json"))
    out = None
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            d = json.load(f)
        if out is None:
            out = d
        else:
            out["rows"] = out["rows"] + d["rows"]
    if out is None:
        raise FileNotFoundError(first)
    return out


def main(argv=None, programs=None):
    """Runs ``--side``; returns the JAX programs where it made some."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", required=True, choices=["port", "jax",
                                                      "compare"])
    ap.add_argument("--family", default="half_cheetah")
    ap.add_argument("--model", default="ppo_cadm")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--seed-from", type=int, default=0)
    ap.add_argument("--itrs", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="port: torch device")
    ap.add_argument("--width", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides on both sides (a toy width)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    cell = f"{args.family}__{args.model}"
    if args.side == "compare":
        out = compare(*(load_side(args.out_dir, cell, args.itrs, side)
                        for side in ("port", "jax")))
        path = side_path(args.out_dir, cell, args.itrs, "compare")
    else:
        path = side_path(args.out_dir, cell, args.itrs, args.side,
                         args.seed_from)
        save = lambda out: write(path, out)  # noqa: E731
        if args.side == "port":
            out = port_side(args, save)
        else:
            out, programs = jax_side(args, programs, save)
    write(path, out)
    print(f"[first_itr] wrote {path}", flush=True)
    return programs


def write(path: str, out: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
