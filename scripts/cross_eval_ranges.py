"""Evaluate one trained model in both packages at pinned hidden scales.

The model (a ``half_cheetah`` MB snapshot of the port: CaDM, or Vanilla
with no context, ``--cell half_cheetah__vanilla__s1``) is kept as an npz
of float32 arrays: ``params/<path>`` for each leaf of the params tree (list
indices as path parts) and ``norm/<field>`` for the six normalization
statistics, the layout both packages share. Each side rolls the env's full
episode (1000 steps) at each of the range probe's scales, mass and damping
both pinned to the scale on every env, with the cell's CEM planner (256
candidates × H 30 × 5 iterations) planning through the model, and writes
per scale the return's mean, std and n, the per-env returns, the velocity
return and the wall seconds:

  python scripts/cross_eval_ranges.py --side export --cell half_cheetah__cadm__s4
      the npz from ``results/torch/ckpt/<cell>.pt`` (the matrix runner's
      snapshot), by the port's ``utils/convert.params_to_numpy``
  python scripts/cross_eval_ranges.py --side port --cell half_cheetah__cadm__s4
      the PyTorch port (``--device``, default cuda): ``analysis.
      probe_ranges.scale_sweep`` with ``planner_policy``, at 8 and 32 envs
  JAX_PLATFORMS=cpu taskset -c 4-7 python scripts/cross_eval_ranges.py \\
          --side jax --cell half_cheetah__cadm__s4
      the JAX package on the CPU: ``scripts/probe_ranges.py``'s
      ``make_rollout`` and ``planner_policy``, jitted, at 8 envs
  python scripts/cross_eval_ranges.py --side verdict
      at each scale the two agree if |Δmean| ≤ 2·√(SE_port² + SE_jax²),
      SE = sample std / √n, for every pair of env counts the sides ran
      (also printed after ``port`` or ``jax`` when the other side's file
      exists)

A PPO cell (``--cell half_cheetah__ppo_cadm__s<k> --trained-by
port|jax``): the npz also holds the policy tree, ``policy/<path>`` (the
PPO state's params: ``policy``, ``log_std``, ``value``), exported from the
port's snapshot (``results/torch/ckpt/<cell>.pt``, its ``ppo`` entry) or
from the JAX runner's (``results/torch/ckpt/jax_cpu/<cell>.pkl`` and
``<cell>.ppo.pkl``, kept by ``scripts/run_jax_cpu_cell.py``), through
``utils/convert.params_to_numpy`` and ``ppo_state_to_numpy``. Each side
acts as its trainer's eval does, the clipped deterministic mean of the
policy on concat(obs, z) with z from the pushed history: the port through
``analysis.probe_ranges.ppo_sweep`` → ``PPOTrainer.evaluate`` (its eval
step graphed on the card) from reset
states pinned to each scale, and once from mode-0 resets (the train
range's random scales, labelled ``mode0``); the JAX package through
``scripts/probe_ranges.py``'s ``make_rollout`` with ``jax_ppo_policy``
(its ``PPOTrainer._dist``) at the pinned scales and its trainer's own
``_eval_impl`` on mode 0. 64 envs a scale on each side by default. The
files are ``<cell>__<trained-by>.npz`` and ``<cell>__<trained-by>.<side>.json``;
``--side table`` sets every PPO policy of the family's cell beside every
other, by package (``<family>__<model>.table.json``):

  python scripts/cross_eval_ranges.py --side export \
      --cell half_cheetah__ppo_cadm__s4 --trained-by port
  python scripts/cross_eval_ranges.py --side port \
      --cell half_cheetah__ppo_cadm__s4 --trained-by port
  JAX_PLATFORMS=cpu taskset -c 4-7 python scripts/cross_eval_ranges.py \
      --side jax --cell half_cheetah__ppo_cadm__s4 --trained-by port
  python scripts/cross_eval_ranges.py --side table --cell half_cheetah__ppo_cadm

A side run again with other ``--n-envs`` or ``--scales`` adds its runs to
its file (same npz and horizon); a run it repeats is replaced. ``--device
cpu`` and ``--plain-kernels`` (K1 and K2's plain versions on the card)
label the port's runs apart, ``--key-offset`` the JAX side's (the script's
keys split per env, so a larger ``--n-envs`` repeats the first episodes).

The port and export sides import nothing of JAX; the JAX side imports
nothing of the port; the verdict neither. Each side writes
``results/torch/cross_eval/<side>.json`` for the first cell, ``CELL``, and
``<cell>.<side>.json`` for any other; the RNG streams of the two
packages differ, so the sides agree as distributions, not env by env.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "results", "torch", "cross_eval")
CELL = "half_cheetah__cadm__s4"
SCALES = [0.2, 0.5, 1.0, 1.5, 1.8]   # scripts/probe_ranges.py's SCALES


# --------------------------------------------------------------- the npz

def flatten(tree, prefix: str) -> dict:
    """``{prefix/path: array}`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


def unflatten(arrays: dict, prefix: str):
    """The tree ``flatten`` wrote under ``prefix``; a level whose keys are
    all digits is a list."""
    root: dict = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr, np.float32)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def is_ppo(cell: str) -> bool:
    return cell.split("__")[1].startswith("ppo")


def tag(args) -> str:
    """The name of a cross-evaluation's files: the cell, and for a PPO
    cell the package that trained it."""
    return (f"{args.cell}__{args.trained_by}" if is_ppo(args.cell)
            else args.cell)


def npz_path(name: str) -> str:
    return os.path.join(OUT_DIR, name + ".npz")


def read_npz(name: str):
    """(params tree, {norm field: array}, the policy tree or None, sha256
    of the file)."""
    path = npz_path(name)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with np.load(path) as z:
        arrays = dict(z)
    policy = unflatten(arrays, "policy") or None
    return (unflatten(arrays, "params"), unflatten(arrays, "norm"), policy,
            digest)


def cell_kwargs(cell: str):
    family, model, seed = cell.split("__")
    return family, model, int(seed[1:])


# ------------------------------------------------------------- the sides

def export(args) -> None:
    from cadm_tpu_torch.analysis.snapshot import (
        CKPT_DIR,
        load_cell,
        read_ppo_snapshot,
    )
    from cadm_tpu_torch.utils.convert import (
        params_to_numpy,
        ppo_state_to_numpy,
    )

    ckpt = args.ckpt or (
        os.path.join(CKPT_DIR, "jax_cpu", args.cell + ".pkl")
        if args.trained_by == "jax" else
        os.path.join(CKPT_DIR, args.cell + ".pt"))
    *_, state = load_cell(args.cell, ckpt, "cpu")
    params, norm = params_to_numpy(state.params, state.norm)
    arrays = {**flatten(params, "params"), **flatten(norm, "norm")}
    if is_ppo(args.cell):
        ppo = read_ppo_snapshot(ckpt.replace(".pkl", ".ppo.pkl"), "cpu")
        arrays.update(flatten(ppo_state_to_numpy(ppo).params, "policy"))
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(npz_path(tag(args)), **arrays)
    print(f"[cross_eval] wrote {npz_path(tag(args))}: {len(arrays)} arrays, "
          f"{sum(a.size for a in arrays.values())} floats", flush=True)


def record(ret, vel, wall: float) -> dict:
    """A run's returns; ``vel`` (the velocity returns) None where the
    rollout does not split them out (the trainers' mode-0 evals)."""
    ret = np.asarray(ret, np.float64)
    vel = None if vel is None else float(np.mean(np.asarray(vel, np.float64)))
    return {"return_mean": float(ret.mean()), "return_std": float(ret.std()),
            "n": int(ret.size), "returns": ret.tolist(),
            "velocity_return_mean": vel, "wall_s": wall}


def port_side(args) -> dict:
    import torch

    from cadm_tpu_torch.analysis import probe_ranges
    from cadm_tpu_torch.analysis.snapshot import cell_config
    from cadm_tpu_torch.cli.matrix import card
    from cadm_tpu_torch.models.dynamics import DynamicsState, NormStats
    from cadm_tpu_torch.utils.convert import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    params_np, norm_np, policy_np, digest = read_npz(tag(args))
    device = torch.device(args.device)
    label = "" if device.type == "cuda" else f" {device.type}"
    if args.plain_kernels:
        plain_physics()
        label += " plain-kernels"
    if args.key_offset and policy_np is not None:   # ppo_sweep's seeds
        label += f" key{args.key_offset}"
    params, norm = params_from_jax(params_np, NormStats(**norm_np), device)
    state = DynamicsState(params, norm)
    runs = {}
    for n in args.n_envs:
        if policy_np is not None:
            cfg = cell_config(args.cell, eval_envs=n,
                              env_horizon=args.horizon)
            env, _, _, trainer = cfg.build(device)
            policy = params_from_jax(policy_np, NormStats(**norm_np),
                                     device)[0]
            sweep = probe_ranges.ppo_sweep(
                trainer, policy, state, args.scales, args.key_offset,
                tag=f"port n={n}{label} ")
        else:
            env, model, planner, _ = cell_config(args.cell).build(device)
            sweep = {s: p["planner"] for s, p in probe_ranges.scale_sweep(
                env, n, {"planner": probe_ranges.planner_policy(
                    env, model, planner, state)},
                args.horizon, args.scales, tag=f"port n={n}{label} ").items()}
        runs[f"{n}{label}"] = {s: dict(r, device=card(device))
                               for s, r in sweep.items()}
    return {"side": "port", "cell": args.cell,
            "trained_by": args.trained_by if policy_np is not None else None,
            "npz_sha256": digest, "horizon": args.horizon or env.horizon,
            "torch": torch.__version__, "runs": runs}


def plain_physics() -> None:
    """Route the engine's K1 and K2 calls to their plain PyTorch versions
    (the CPU's arithmetic) on any device, to tell the kernels apart from
    the rest of the port."""
    from cadm_tpu_torch.ops import fk_kernel, pgs
    from cadm_tpu_torch.physics.rigid import dynamics as rdyn

    rdyn.pgs_solve = lambda A, b, v_star, mu, lam0, *, iters: \
        pgs.pgs_solve_plain(A, b, v_star, mu, lam0, iters)
    fk_kernel.full_dyn = fk_kernel.full_dyn_plain


def jax_side(args) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    import scripts.probe_ranges as probe
    from cadm_tpu.cli.presets import ExperimentConfig
    from cadm_tpu.models.dynamics import DynamicsState, NormStats
    from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS

    params_np, norm_np, policy_np, digest = read_npz(tag(args))
    family, model_name, seed = cell_kwargs(args.cell)
    if policy_np is not None:
        return jax_ppo_side(args, params_np, norm_np, policy_np, digest)
    cfg = ExperimentConfig(**FAMILY_BASE[family], **MODEL_VARIANTS[model_name],
                           seed=seed, eval_modes=(0, 1, 2))
    env, model, planner, _ = cfg.build()
    state = DynamicsState(params=jax.tree.map(jnp.asarray, params_np),
                          opt_state=None,
                          norm=NormStats(**{k: jnp.asarray(v)
                                            for k, v in norm_np.items()}),
                          updates=jnp.asarray(0, jnp.int32))
    horizon = args.horizon or env.horizon
    env.horizon = horizon   # the script's rollout runs env.horizon steps
    cores = len(os.sched_getaffinity(0))
    label = f" key{args.key_offset}" if args.key_offset else ""
    runs = {}
    for n in args.n_envs:
        run = jax.jit(probe.make_rollout(
            env, n, probe.planner_policy(env, model, planner, state)))
        t0 = time.time()
        run = run.lower(jnp.asarray(1.0),
                        jax.random.key(0)).compile()
        print(f"[cross_eval] jax n={n}: compiled in {time.time() - t0:.1f} s",
              flush=True)
        out = {}
        for scale in args.scales:
            t0 = time.time()
            key = jax.random.key(17 + int(scale * 10))   # the script's
            if args.key_offset:
                key = jax.random.fold_in(key, args.key_offset)
            ret, vel = jax.block_until_ready(run(jnp.asarray(scale), key))
            out[str(scale)] = dict(record(ret, vel, time.time() - t0),
                                   device=f"CPU, {cores} cores")
            print(f"[cross_eval] jax n={n}{label} scale={scale}: "
                  f"ret={np.mean(ret):.1f}±{np.std(ret):.1f} "
                  f"({out[str(scale)]['wall_s']:.1f} s)", flush=True)
            write_side(side_name(args, "jax.partial"),
                       {"runs": {f"{n}{label}": out}})
        runs[f"{n}{label}"] = out
    return {"side": "jax", "cell": args.cell, "npz_sha256": digest,
            "horizon": horizon, "jax": jax.__version__, "runs": runs}


def jax_ppo_policy(trainer, params, dyn_state) -> dict:
    """The JAX PPO trainer's eval policy (``_eval_impl``): the clipped
    deterministic mean of ``trainer._dist`` on concat(obs, z), z from the
    pushed history; aux = histories. For ``scripts/probe_ranges.py``'s
    ``make_rollout``."""
    import jax.numpy as jnp

    from cadm_tpu.core.types import batched_history

    model = trainer.model

    def act(states, hists, k):
        z = model.context_from_history(dyn_state.params, dyn_state.norm,
                                       hists)
        mean, _ = trainer._dist(params, jnp.concatenate([states.obs, z],
                                                        axis=-1))
        return jnp.clip(mean, -1.0, 1.0), hists

    def post(hists, prev_obs, obs, actions):
        return model.push_history(dyn_state.params, dyn_state.norm, hists,
                                  prev_obs, obs - prev_obs, actions)

    return {"init": lambda n: batched_history(model.cfg, n), "act": act,
            "post": post}


def jax_ppo_side(args, params_np, norm_np, policy_np, digest) -> dict:
    """The JAX side of a PPO cell: at each pinned scale ``make_rollout``
    with ``jax_ppo_policy`` (the script's per-scale key), and on mode 0 the
    trainer's own ``_eval_impl`` (key 7), ``--key-offset`` folded into
    each key."""
    import jax
    import jax.numpy as jnp

    import scripts.probe_ranges as probe
    from cadm_tpu.cli.presets import ExperimentConfig
    from cadm_tpu.models.dynamics import DynamicsState, NormStats
    from cadm_tpu.train.ppo import PPOState
    from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS

    family, model_name, seed = cell_kwargs(args.cell)
    state = DynamicsState(params=jax.tree.map(jnp.asarray, params_np),
                          opt_state=None,
                          norm=NormStats(**{k: jnp.asarray(v)
                                            for k, v in norm_np.items()}),
                          updates=jnp.asarray(0, jnp.int32))
    policy = jax.tree.map(jnp.asarray, policy_np)
    ppo = PPOState(params=policy, opt_state=None,
                   updates=jnp.asarray(0, jnp.int32))
    cores = len(os.sched_getaffinity(0))
    label = f" key{args.key_offset}" if args.key_offset else ""

    def key(seed_):
        k = jax.random.key(seed_)
        return jax.random.fold_in(k, args.key_offset) if args.key_offset \
            else k

    runs = {}
    for n in args.n_envs:
        cfg = ExperimentConfig(**{**FAMILY_BASE[family],
                                  **MODEL_VARIANTS[model_name],
                                  "eval_envs": n, "eval_modes": (0,)},
                               seed=seed)
        env, model, _, trainer = cfg.build()
        horizon = args.horizon or env.horizon
        env.horizon = horizon   # both rollouts run env.horizon steps
        t0 = time.time()
        pinned = jax.jit(probe.make_rollout(
            env, n, jax_ppo_policy(trainer, policy, state))).lower(
                jnp.asarray(1.0), jax.random.key(0)).compile()
        mode0 = jax.jit(lambda k: trainer._eval_impl(k, ppo, state, 0)
                        ).lower(jax.random.key(0)).compile()
        print(f"[cross_eval] jax n={n}: compiled in {time.time() - t0:.1f} s",
              flush=True)
        out = {}
        for scale in [*args.scales, None]:
            t0 = time.time()
            if scale is None:
                name = "mode0"
                ret, vel = jax.block_until_ready(mode0(key(7))), None
            else:
                name = str(scale)
                ret, vel = jax.block_until_ready(pinned(
                    jnp.asarray(scale), key(17 + int(scale * 10))))
            out[name] = dict(record(ret, vel, time.time() - t0),
                             device=f"CPU, {cores} cores")
            print(f"[cross_eval] jax n={n}{label} {name}: "
                  f"ret={np.mean(ret):.1f}±{np.std(ret):.1f} "
                  f"({out[name]['wall_s']:.1f} s)", flush=True)
            write_side(side_name(args, "jax.partial"),
                       {"runs": {f"{n}{label}": out}})
        runs[f"{n}{label}"] = out
    return {"side": "jax", "cell": args.cell, "trained_by": args.trained_by,
            "npz_sha256": digest, "horizon": horizon,
            "jax": jax.__version__, "runs": runs}


# ------------------------------------------------------------ the verdict

def se(rec: dict) -> float:
    """Standard error of the mean return (sample std over √n)."""
    n = rec["n"]
    std = np.std(rec["returns"], ddof=1) if n > 1 else float("inf")
    return float(std / math.sqrt(n))


def pooled(side: dict) -> dict:
    """{scale: record} over every run of ``side`` on its default path (a
    label that is an env count, or one with a ``key`` offset; not ``cpu``
    or ``plain-kernels``), each distinct episode once: a larger env count
    under the same keys repeats a smaller one's episodes bit for bit."""
    returns: dict = {}
    for label, runs in side["runs"].items():
        extra = label.split()[1:]
        if extra and not extra[0].startswith("key"):
            continue
        for s, rec in runs.items():
            returns.setdefault(s, {}).update(dict.fromkeys(rec["returns"]))
    return {s: {"return_mean": float(np.mean(list(r))), "n": len(r),
                "returns": list(r)} for s, r in returns.items()}


def verdict(port: dict, jax_: dict) -> dict:
    """Per pair of runs (port, jax) and scale both ran: Δmean, the 2-SE
    bound, agreement; ``pooled`` pairs each side's distinct episodes."""
    out = {}
    jax_runs = dict(jax_["runs"], pooled=pooled(jax_))
    port_runs = dict(port["runs"], pooled=pooled(port))
    for jn, jruns in jax_runs.items():
        for n, pruns in port_runs.items():
            if (n == "pooled") != (jn == "pooled"):
                continue
            rows = {}
            for s, p in pruns.items():
                if s not in jruns:
                    continue
                j = jruns[s]
                delta = p["return_mean"] - j["return_mean"]
                bound = 2.0 * math.sqrt(se(p) ** 2 + se(j) ** 2)
                rows[s] = {"port_mean": p["return_mean"], "port_se": se(p),
                           "port_n": p["n"], "jax_mean": j["return_mean"],
                           "jax_se": se(j), "jax_n": j["n"], "delta": delta,
                           "bound": bound, "agree": abs(delta) <= bound}
            name = lambda x: x if x == "pooled" else f"n={x}"  # noqa: E731
            out[f"port {name(n)} vs jax {name(jn)}"] = rows
    return out


def print_verdict(v: dict) -> None:
    for name, rows in v.items():
        print(f"[cross_eval] {name}", flush=True)
        for s, r in rows.items():
            print(f"  scale {s}: port {r['port_mean']:.1f} ± {r['port_se']:.1f}"
                  f" (n {r['port_n']}), jax {r['jax_mean']:.1f} ± "
                  f"{r['jax_se']:.1f} (n {r['jax_n']}): |Δ| "
                  f"{abs(r['delta']):.1f} vs 2 SE {r['bound']:.1f} → "
                  f"{'agree' if r['agree'] else 'DISAGREE'}", flush=True)


def side_name(args, side: str) -> str:
    """The file stem of ``side``'s record: the side alone for the first
    cell, ``CELL`` (its records keep their names), ``<tag>.<side>`` for any
    other cell or PPO policy."""
    return side if args.cell == CELL else f"{tag(args)}.{side}"


def side_path(name: str) -> str:
    return os.path.join(OUT_DIR, name + ".json")


def write_side(name: str, out: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = side_path(name) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1)
    os.replace(tmp, side_path(name))


def merged(name: str, out: dict) -> dict:
    """``out`` with the runs of an earlier ``<name>.json`` of the same npz
    and horizon that it does not redo (another env count, another scale)
    kept."""
    if not os.path.exists(side_path(name)):
        return out
    with open(side_path(name)) as f:
        old = json.load(f)
    if (old.get("npz_sha256"), old.get("horizon")) != (out["npz_sha256"],
                                                       out["horizon"]):
        return out
    runs = {n: dict(r) for n, r in old["runs"].items()}
    for n, r in out["runs"].items():
        runs.setdefault(n, {}).update(r)
    return dict(old, **dict(out, runs=runs))


def verdict_if_both(args) -> dict | None:
    names = {s: side_name(args, s) for s in ("port", "jax")}
    if not all(os.path.exists(side_path(n)) for n in names.values()):
        return None
    sides = {}
    for s, n in names.items():
        with open(side_path(n)) as f:
            sides[s] = json.load(f)
    if sides["port"]["npz_sha256"] != sides["jax"]["npz_sha256"]:
        raise SystemExit(f"{names['port']}.json and {names['jax']}.json "
                         "evaluated different npz")
    v = verdict(sides["port"], sides["jax"])
    print_verdict(v)
    write_side(side_name(args, "verdict"), v)
    return v


def table(args) -> dict:
    """The PPO policies of ``args.cell``'s family and model (every
    ``<family>__<model>__s<k>__<trained-by>`` with both sides' records),
    each evaluated by each package: per scale the pooled mean, SE and n;
    and within each package, for each pair of policies, Δmean against the
    2-SE bound."""
    import glob

    family, model = args.cell.split("__")[:2]
    stem = f"{family}__{model}__s"
    policies = {}
    for path in sorted(glob.glob(os.path.join(OUT_DIR, stem + "*.jax.json"))):
        name = os.path.basename(path)[:-len(".jax.json")]
        if not os.path.exists(side_path(name + ".port")):
            continue
        policies[name] = {}
        for side in ("port", "jax"):
            with open(side_path(f"{name}.{side}")) as f:
                policies[name][side] = {
                    s: {"mean": r["return_mean"], "se": se(r), "n": r["n"],
                        "returns": r["returns"]}
                    for s, r in pooled(json.load(f)).items()}
    pairs = {}
    names = sorted(policies)
    for side in ("port", "jax"):
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                rows = {}
                for s, ra in policies[a][side].items():
                    rb = policies[b][side].get(s)
                    if rb is None:
                        continue
                    delta = ra["mean"] - rb["mean"]
                    bound = 2.0 * math.sqrt(ra["se"] ** 2 + rb["se"] ** 2)
                    rows[s] = {"delta": delta, "bound": bound,
                               "agree": abs(delta) <= bound}
                pairs[f"{a} vs {b}, evaluated by {side}"] = rows
    for p in policies.values():
        for side in p.values():
            for r in side.values():
                r.pop("returns")
    out = {"policies": policies, "pairs": pairs}
    for name, p in policies.items():
        for side, rows in p.items():
            print(f"[cross_eval] {name} by {side}: " + ", ".join(
                f"{s} {r['mean']:.1f}±{r['se']:.1f} (n {r['n']})"
                for s, r in rows.items()), flush=True)
    for name, rows in pairs.items():
        print(f"[cross_eval] {name}: " + ", ".join(
            f"{s} Δ {r['delta']:.1f} vs {r['bound']:.1f} "
            f"{'agree' if r['agree'] else 'DIFFER'}"
            for s, r in rows.items()), flush=True)
    write_side(f"{family}__{model}.table", out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", required=True,
                    choices=["export", "port", "jax", "verdict", "table"])
    ap.add_argument("--cell", default=CELL)
    ap.add_argument("--trained-by", default="port", choices=["port", "jax"],
                    help="a PPO cell: the package whose training made the "
                         "policy (its snapshot for export, its files' "
                         "names)")
    ap.add_argument("--ckpt", default="",
                    help="export: the snapshot (default "
                         "results/torch/ckpt/<cell>.pt, or for --trained-by "
                         "jax results/torch/ckpt/jax_cpu/<cell>.pkl)")
    ap.add_argument("--device", default="cuda", help="port: torch device")
    ap.add_argument("--plain-kernels", action="store_true",
                    help="port: K1 and K2's plain versions in place of the "
                         "kernels (runs labelled 'plain-kernels')")
    ap.add_argument("--n-envs", type=int, nargs="*", default=None,
                    help="envs per scale (port: 8 32, jax: 8; a PPO "
                         "cell: 64 on both)")
    ap.add_argument("--scales", type=float, nargs="*", default=SCALES)
    ap.add_argument("--key-offset", type=int, default=0,
                    help="fold this into each scale's key (jax) or add it "
                         "to each seed (a PPO cell's port side) for "
                         "episodes of their own (a larger --n-envs repeats "
                         "the first n's episodes); runs labelled 'key<k>'")
    ap.add_argument("--horizon", type=int, default=None,
                    help="episode length (default: the env's, 1000)")
    args = ap.parse_args(argv)
    if args.side == "export":
        return export(args)
    if args.side == "table":
        return table(args)
    if args.side in ("port", "jax"):
        args.n_envs = args.n_envs or (
            [64] if is_ppo(args.cell) else [8, 32] if args.side == "port"
            else [8])
        out = (port_side if args.side == "port" else jax_side)(args)
        name = side_name(args, args.side)
        write_side(name, merged(name, out))
        partial = side_path(side_name(args, "jax.partial"))
        if args.side == "jax" and os.path.exists(partial):
            os.remove(partial)
        print(f"[cross_eval] wrote {side_path(name)}", flush=True)
    v = verdict_if_both(args)
    if v is None and args.side == "verdict":
        raise SystemExit("needs both sides' records")


if __name__ == "__main__":
    main()
