"""One state of a PPO + CaDM cell, each piece of an iteration run on it by
both packages, each with its own draws.

The state is the start of iteration k* of the cell (seed ``--seed``, the
key schedule of ``train`` without evals, ``probe_first_itr.py``'s
iterations), trained once by each package, plus that iteration's collect
in its trainer's package: the trajectory, its bootstrap value and the ring
after it. Each package takes both states (a port-trained state crosses
through ``utils/convert.py``'s ``params_to_numpy``/``ppo_state_to_numpy``
and ``state_to_numpy``, a JAX-trained one through ``params_from_jax``,
``ppo_state_from_jax`` and the ring, env-state and history converters) and
runs on each, ``--reps`` times with fresh draws of its own:

  fit      the model fit of iteration k* on the ring after its collect
  ppo      the PPO update of iteration k* on the common trajectory
  collect  the collect of iteration k*, from the state's envs, histories,
           policy and model

Each outcome is judged by one function for both sides: the fitted
params' loss (the port's ``Dynamics.loss``) on one fixed train and one
fixed valid batch of the ring (``JUDGE_BATCHES`` × the fit's minibatch,
drawn once with the state); the updated policy's mean KL from the old one,
its Δ mean ``log_std``, clip fraction and clipped surrogate on the whole
trajectory (advantages from the port's GAE); the collect's reward per
env, episodes ended and mean |a|. ``verdict`` sets each side's mean beside
the other's: Δ against 2·√(SE² + SE²), and the smallest Δ that the reps
could detect, (2 + 0.84)·√(SE² + SE²) (a 2-SE call with 80% power).

  python scripts/probe_common_state.py --side port-state --itr 16
      the port-trained state (card), to ``--state-dir``
  JAX_PLATFORMS=cpu taskset -c 0-3 python scripts/probe_common_state.py \\
          --side jax-state --itr 16
      the JAX-trained state (CPU)
  python scripts/probe_common_state.py --side port --itr 16 --reps 20
      the port's pieces on both states (card); the fit and the update are
      judged here, on the device they ran on
  JAX_PLATFORMS=cpu python scripts/probe_common_state.py --side jax ...
      the JAX package's pieces on both states; the fitted and updated
      params are kept in ``--state-dir`` for the verdict
  python scripts/probe_common_state.py --side verdict --itr 16 --device cpu
      judges the JAX outcomes with the port's functions, compares

``--width KEY=VALUE`` overrides the config on both sides, ``--port-width``
on the port's side only (``lr=0.002``: a fault the verdict must see).
States (``<cell>.<trainer>.k<k*>.npz``, the ring's ``next_obs`` kept only
where it is not the next column's obs) and the JAX side's params go to
``--state-dir`` (git-ignored); outcomes to
``results/torch/common_state/<cell>.k<k*>.<side>.json``. The port side
imports nothing of JAX; the JAX side nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.probe_first_itr import (  # noqa: E402
    exhaust,
    jax_iterations,
    jax_trainer,
    port_iterations,
    port_trainer,
    verdict,
)

OUT_DIR = os.path.join(ROOT, "results", "torch", "common_state")
STATE_DIR = os.path.join(ROOT, "results", "torch", "ckpt", "common_state")
TRAINERS = ("port", "jax")
PIECES = ("fit", "ppo", "collect")
JUDGE_BATCHES = 16     # the judge's batches: 16 × the fit's minibatch
JUDGE_SEED = 12345     # their anchors, drawn once with the state
REP_SEED = 1000        # rep r draws from seed REP_SEED + r on either side
POWER_Z = 2.0 + 0.84   # 2-SE call, 80% power


# ------------------------------------------------------- the state file --
def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists of arrays → {"a/b/0/w": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict):
    """The inverse of ``flatten``: a path segment of digits is a list
    index."""
    root: dict = {}
    for path, v in flat.items():
        node, parts = root, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(x):
        if not isinstance(x, dict):
            return x
        if x and all(k.isdigit() for k in x):
            return [lists(x[str(i)]) for i in range(len(x))]
        return {k: lists(v) for k, v in x.items()}
    return lists(root)


def save_state(path: str, state: dict, meta: dict) -> None:
    """``state`` as one compressed npz; the ring's ``next_obs`` is kept
    only in the columns where it is not the next physical column's obs (an
    episode's end, the newest column), which halves the file."""
    flat = flatten(state)
    obs, nxt = flat["ring/obs"], flat.pop("ring/next_obs")
    at = np.nonzero(np.any(nxt != np.roll(obs, -1, axis=1), axis=-1))
    flat["ring/next_obs_at"] = np.stack(at).astype(np.int32)
    flat["ring/next_obs_val"] = nxt[at]
    flat["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_state(path: str) -> tuple:
    """(state, meta) of ``save_state``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    meta = json.loads(str(flat.pop("meta")))
    at, val = flat.pop("ring/next_obs_at"), flat.pop("ring/next_obs_val")
    nxt = np.roll(flat["ring/obs"], -1, axis=1).copy()
    nxt[tuple(at)] = val
    flat["ring/next_obs"] = nxt
    return unflatten(flat), meta


def state_path(args, trainer: str) -> str:
    return os.path.join(args.state_dir, f"{cell(args)}.{trainer}.k{args.itr}"
                        ".npz")


def cell(args) -> str:
    return f"{args.family}__{args.model}"


def judge_anchors(n_envs: int, size: int, batch: int, n_members: int,
                  valid_stride: int = 10) -> dict:
    """The judge's fixed (env_idx, t_idx) of a train and a valid batch of
    (n_members, JUDGE_BATCHES · batch) segments, as the ring's
    ``anchor_columns`` maps them (numpy, seeded)."""
    rng = np.random.RandomState(JUDGE_SEED)
    n_valid = size // valid_stride
    s = valid_stride
    shape = (n_members, JUDGE_BATCHES * batch)
    u = rng.randint(0, max(size - n_valid, 1), shape)
    v = rng.randint(0, max(n_valid, 1), shape)
    return {"train": {"env_idx": rng.randint(0, n_envs, shape),
                      "t_idx": (u // (s - 1)) * s + u % (s - 1)},
            "valid": {"env_idx": rng.randint(0, n_envs, shape),
                      "t_idx": v * s + (s - 1)}}


# -------------------------------------------------------------- judges --
def collect_outcome(reward, done, act) -> dict:
    """A collect's (T, E) rewards and dones and (T, E, act) actions."""
    reward, act = np.asarray(reward, np.float64), np.asarray(act, np.float64)
    return {"reward_per_env": float(reward.sum(0).mean()),
            "episodes": int(np.asarray(done).sum()),
            "mean_abs_act": float(np.abs(act).mean())}


def fit_outcome(tr, params, norm, buf, judge: dict) -> dict:
    """The port's ``Dynamics.loss`` of fitted ``params``/``norm`` on the
    judge's fixed train and valid batches of the ring ``buf``."""
    import torch

    mc, dev = tr.model.cfg, buf.obs.device
    out = {}
    with torch.no_grad():
        for split in ("train", "valid"):
            idx = [torch.as_tensor(np.asarray(judge[split][k]), device=dev,
                                   dtype=torch.int64)
                   for k in ("env_idx", "t_idx")]
            batch = buf.gather(*idx, mc.history_k, mc.future_m)
            out[f"{split}_loss"] = float(tr.model.loss(params, norm,
                                                       batch)[0])
    return out


def ppo_outcome(tr, old: dict, new: dict, traj: dict, last) -> dict:
    """The updated policy ``new`` against ``old`` on the whole trajectory
    (the port's GAE, ``_dist`` and ``_logp``): mean KL(old ‖ new), Δ mean
    log_std, the share of rows whose ratio left [1 − ε, 1 + ε], and the
    clipped surrogate −mean(min(r·A, clip(r)·A))."""
    import torch

    eps = tr.cfg.clip_eps
    with torch.no_grad():
        flat = tr._flatten(traj, last)
        mo, lo = tr._dist(old, flat["obs_z"])
        mn, ln = tr._dist(new, flat["obs_z"])
        kl = torch.sum(ln - lo + (torch.exp(2 * lo) + (mo - mn) ** 2)
                       / (2 * torch.exp(2 * ln)) - 0.5, dim=-1)
        ratio = torch.exp(tr._logp(mn, ln, flat["act"]) - flat["logp"])
        adv = flat["adv"]
        surr = -torch.mean(torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv))
        clipped = ((ratio < 1 - eps) | (ratio > 1 + eps)).float().mean()
        return {"kl": float(kl.mean()),
                "d_log_std": float(ln.mean() - lo.mean()),
                "clip_frac": float(clipped), "surrogate": float(surr)}


# ----------------------------------------------------------- port side --
def port_objects(tr, state: dict, device):
    """The port's (env states, histories, ring, PPO state, model state,
    trajectory, bootstrap value) of a state file."""
    import torch

    from cadm_tpu_torch.utils.convert import (
        AdamNumpy,
        PPOStateNumpy,
        buffer_from_jax,
        dynamics_state_from_jax,
        env_state_from_jax,
        history_from_jax,
        ppo_state_from_jax,
    )

    like = tr.init(torch.Generator(device=device).manual_seed(0))[0]
    ppo = state["ppo"]
    ps = ppo_state_from_jax(PPOStateNumpy(
        ppo["params"], ((), (AdamNumpy(**ppo["opt_state"]), ())),
        ppo["updates"]), device)
    return (env_state_from_jax(state["env"], device, type(like.phys),
                               type(like.params)),
            history_from_jax(state["hist"], device),
            buffer_from_jax(state["ring"], device), ps,
            dynamics_state_from_jax(state["dyn"], device),
            {k: torch.as_tensor(v, device=device)
             for k, v in state["traj"].items()},
            torch.as_tensor(state["last_value"], device=device))


def port_state_dict(states, hists, buf, ps, dyn, traj, last) -> dict:
    """A port state as the state file's dict."""
    from cadm_tpu_torch.utils.convert import (
        params_to_numpy,
        ppo_state_to_numpy,
        state_to_numpy,
    )

    ppo = ppo_state_to_numpy(ps)
    adam = ppo.opt_state[1][0]
    params, norm = params_to_numpy(dyn.params, dyn.norm)
    return {"env": state_to_numpy(states), "hist": state_to_numpy(hists),
            "ring": state_to_numpy(buf),
            "ppo": {"params": ppo.params,
                    "opt_state": {"count": adam.count, "mu": adam.mu,
                                  "nu": adam.nu},
                    "updates": ppo.updates},
            "dyn": {"params": params, "norm": norm,
                    "opt_state": state_to_numpy(dyn.opt_state),
                    "updates": np.asarray(dyn.updates, np.int32)},
            "traj": state_to_numpy(traj), "last_value": state_to_numpy(last)}


def port_state(args) -> None:
    """Train the port's seed for ``--itr`` iterations, collect once more,
    save the state file."""
    import torch

    from cadm_tpu_torch.cli.matrix import card

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    t0 = time.perf_counter()
    tr = port_trainer(args.family, args.model, args.seed, device, args.width)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    states, hists, buf, ps, dyn = exhaust(port_iterations(tr, gen, args.itr))
    after = tr._collect(gen, states, hists, buf, ps, dyn)
    traj = dict(after[3])
    traj.pop("ep_return")
    state = port_state_dict(states, hists, buf, ps, dyn, traj, after[4])
    state["judge"] = judge_anchors(buf.n_envs, buf.size, tr.cfg.model_batch,
                                   tr.model.cfg.n_members)
    meta = {"trainer": "port", "itr": args.itr, "seed": args.seed,
            "device": card(device), "ring": [buf.ptr, buf.size],
            "wall_s": time.perf_counter() - t0}
    save_state(state_path(args, "port"), state, meta)
    print(f"[common_state] port state: {meta} → {state_path(args, 'port')} "
          f"({os.path.getsize(state_path(args, 'port')) / 2**20:.1f} MiB)",
          flush=True)


def port_side(args) -> dict:
    """The port's pieces, ``--reps`` times each, on every state given."""
    import dataclasses

    import torch

    from cadm_tpu_torch.cli.matrix import card

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    tr = port_trainer(args.family, args.model, args.seed, device,
                      list(args.width) + list(args.port_width))
    out = {"side": "port", "device": card(device), "reps": args.reps,
           "port_width": args.port_width, "states": {}}
    for trainer in args.states:
        state, meta = load_state(state_path(args, trainer))
        states, hists, buf, ps, dyn, traj, last = port_objects(tr, state,
                                                               device)
        saved = [x.clone() for x in (buf.obs, buf.act, buf.next_obs,
                                     buf.done, buf.ep_step, buf.bad)]
        ring_at = (buf.ptr, buf.size)

        def restore():
            # the same tensors, so a fit graph keyed by them is replayed
            for x, y in zip((buf.obs, buf.act, buf.next_obs, buf.done,
                             buf.ep_step, buf.bad), saved):
                x.copy_(y)
            buf.ptr, buf.size = ring_at

        rows = {p: [] for p in PIECES}
        t0 = time.perf_counter()
        for rep in range(args.reps):
            gen = torch.Generator(device=device).manual_seed(REP_SEED + rep)
            restore()
            fitted, fit = tr._fit_model(gen, buf, dataclasses.replace(dyn))
            rows["fit"].append(dict(
                fit_outcome(tr, fitted.params, fitted.norm, buf,
                            state["judge"]),
                **{k: float(v) for k, v in fit.items()}))
            new, ppo = tr._ppo_update(gen, ps, dict(traj), last)
            rows["ppo"].append(dict(
                ppo_outcome(tr, ps.params, new.params, traj, last),
                **{k: float(v) for k, v in ppo.items()}))
            col = tr._collect(gen, states, hists, buf, ps, dyn)[3]
            rows["collect"].append(collect_outcome(
                *(col[k].cpu().numpy() for k in ("reward", "done", "act"))))
            print(f"[common_state] port on {trainer} state rep {rep}: "
                  f"{ {p: r[-1] for p, r in rows.items()} }", flush=True)
        restore()
        out["states"][trainer] = {"meta": meta, "rows": rows,
                                  "wall_s": time.perf_counter() - t0}
    return out


# ------------------------------------------------------------ JAX side --
def jax_fill(template, src):
    """``template`` (a JAX pytree of flax structs, dicts and lists) with
    its leaves taken from the state file's dict ``src``, each in the
    template's dtype; fields ``src`` lacks keep the template's."""
    import dataclasses

    import jax.numpy as jnp

    if dataclasses.is_dataclass(template):
        return template.replace(**{
            f.name: jax_fill(getattr(template, f.name), src[f.name])
            for f in dataclasses.fields(template) if f.name in src})
    if isinstance(template, dict):
        return {k: jax_fill(v, src[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(jax_fill(t, s) for t, s in zip(template, src))
    return jnp.asarray(np.asarray(src), dtype=template.dtype)


def jax_objects(tr, state: dict, env_key):
    """The JAX package's (env states, histories, ring, PPO state, model
    state, trajectory, bootstrap value) of a state file. Each env's reset
    key is drawn from ``env_key``: a port-trained state has none, and a
    JAX-trained state's own would repeat its resets in every rep."""
    import jax
    import jax.numpy as jnp

    states, hists, buf, ps, dyn = tr.init(jax.random.key(0))
    states = jax_fill(states, state["env"]).replace(
        rng=jax.random.split(env_key, state["env"]["obs"].shape[0]))

    def with_adam(opt, adam):
        clip, (scale, rest) = opt
        return (clip, (scale._replace(
            count=jnp.asarray(adam["count"], scale.count.dtype),
            mu=jax_fill(scale.mu, adam["mu"]),
            nu=jax_fill(scale.nu, adam["nu"])), rest))

    ppo, dsrc = state["ppo"], state["dyn"]
    ps = ps.replace(params=jax_fill(ps.params, ppo["params"]),
                    opt_state=with_adam(ps.opt_state, ppo["opt_state"]),
                    updates=jnp.asarray(ppo["updates"], ps.updates.dtype))
    dyn = dyn.replace(params=jax_fill(dyn.params, dsrc["params"]),
                      norm=jax_fill(dyn.norm, dsrc["norm"]),
                      opt_state=with_adam(dyn.opt_state, dsrc["opt_state"]),
                      updates=jnp.asarray(dsrc["updates"], dyn.updates.dtype))
    traj = {k: jnp.asarray(v) for k, v in state["traj"].items()}
    return (states, jax_fill(hists, state["hist"]),
            jax_fill(buf, state["ring"]), ps, dyn, traj,
            jnp.asarray(state["last_value"]))


def jax_state_dict(states, hists, buf, ps, dyn, traj, last) -> dict:
    """A JAX state as the state file's dict (the env keys left out)."""
    import dataclasses

    import jax

    def fields(x, skip=()):
        return {f.name: fields(getattr(x, f.name))
                if dataclasses.is_dataclass(getattr(x, f.name))
                else np.asarray(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name not in skip}

    def adam(opt):
        a = opt[1][0]
        return {"count": np.asarray(a.count),
                "mu": jax.tree.map(np.asarray, a.mu),
                "nu": jax.tree.map(np.asarray, a.nu)}

    tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return {"env": fields(states, skip=("rng",)), "hist": fields(hists),
            "ring": fields(buf),
            "ppo": {"params": tree(ps.params), "opt_state": adam(ps.opt_state),
                    "updates": np.asarray(ps.updates)},
            "dyn": {"params": tree(dyn.params), "norm": fields(dyn.norm),
                    "opt_state": adam(dyn.opt_state),
                    "updates": np.asarray(dyn.updates)},
            "traj": tree(traj), "last_value": np.asarray(last)}


def jax_state(args, programs=None):
    """``port_state`` in the JAX package: its keys split as ``train``
    splits them, the collect of iteration k* from that iteration's key.
    Returns the trainer's programs."""
    import jax

    t0 = time.perf_counter()
    tr, programs = jax_trainer(args.family, args.model, args.seed, programs,
                               args.width)
    (states, hists, buf, ps, dyn), rng = exhaust(
        jax_iterations(tr, args.seed, args.itr))
    _, k_col, _, _, _ = jax.random.split(rng, 5)
    after = tr._collect(k_col, states, hists, buf, ps, dyn)
    traj = dict(after[3])
    traj.pop("ep_return")
    state = jax_state_dict(states, hists, after[2], ps, dyn, traj, after[4])
    size = int(after[2].size)
    state["judge"] = judge_anchors(tr.cfg.n_envs, size, tr.cfg.model_batch,
                                   tr.model.cfg.n_members)
    meta = {"trainer": "jax", "itr": args.itr, "seed": args.seed,
            "device": jax_device(), "ring": [int(after[2].ptr), size],
            "wall_s": time.perf_counter() - t0}
    save_state(state_path(args, "jax"), state, meta)
    print(f"[common_state] jax state: {meta} → {state_path(args, 'jax')}",
          flush=True)
    return programs


def jax_device() -> str:
    import jax

    return (f"CPU, {len(os.sched_getaffinity(0))} cores, jax "
            f"{jax.__version__}")


def jax_side(args, programs=None):
    """The JAX package's pieces, ``--reps`` times each, on every state
    given; its keys per rep split as ``train`` splits an iteration's. The
    collect is judged here; the fitted and updated params go to
    ``--state-dir`` for the verdict. Returns (record, programs)."""
    import jax

    tr, programs = jax_trainer(args.family, args.model, args.seed, programs,
                               args.width)
    out = {"side": "jax", "device": jax_device(), "reps": args.reps,
           "states": {}}
    for trainer in args.states:
        state, meta = load_state(state_path(args, trainer))
        rows, kept = {p: [] for p in PIECES}, {"fit": [], "ppo": []}
        t0 = time.perf_counter()
        for rep in range(args.reps):
            key = jax.random.key(REP_SEED + rep)
            k_env, k_col, k_ppo, k_fit, _ = jax.random.split(key, 5)
            states, hists, buf, ps, dyn, traj, last = jax_objects(
                tr, state, k_env)
            fitted, fit = tr._fit_model(k_fit, buf, dyn)
            rows["fit"].append({k: float(v) for k, v in fit.items()})
            kept["fit"].append({
                "params": jax.tree.map(np.asarray, fitted.params),
                "norm": {f: np.asarray(getattr(fitted.norm, f))
                         for f in state["dyn"]["norm"]}})
            new, ppo = tr._ppo_update(k_ppo, ps, traj, last)
            rows["ppo"].append({k: float(v) for k, v in ppo.items()})
            kept["ppo"].append(jax.tree.map(np.asarray, new.params))
            col = tr._collect(k_col, states, hists, buf, ps, dyn)[3]
            rows["collect"].append(collect_outcome(
                *(np.asarray(col[k]) for k in ("reward", "done", "act"))))
            print(f"[common_state] jax on {trainer} state rep {rep}: "
                  f"{ {p: r[-1] for p, r in rows.items()} }", flush=True)
        np.savez_compressed(kept_path(args, trainer), **flatten(kept))
        out["states"][trainer] = {"meta": meta, "rows": rows,
                                  "wall_s": time.perf_counter() - t0}
    return out, programs


def kept_path(args, trainer: str) -> str:
    return os.path.join(args.state_dir, f"{cell(args)}.k{args.itr}.jax_on_"
                        f"{trainer}.params.npz")


# ------------------------------------------------------------- verdict --
def judge_jax(args, jax_out: dict) -> None:
    """Fill the JAX side's fit and PPO rows with the port's judges (on
    ``--device``), from the params it kept."""
    import torch

    from cadm_tpu_torch.utils.convert import (
        params_from_jax,
        policy_params_from_jax,
    )

    device = torch.device(args.device)
    tr = port_trainer(args.family, args.model, args.seed, device, args.width)
    for trainer, rec in jax_out["states"].items():
        state, _ = load_state(state_path(args, trainer))
        _, _, buf, ps, _, traj, last = port_objects(tr, state, device)
        with np.load(kept_path(args, trainer)) as f:
            kept = unflatten({k: f[k] for k in f.files})
        for row, k in zip(rec["rows"]["fit"], kept["fit"]):
            params, norm = params_from_jax(k["params"], k["norm"], device)
            row.update(fit_outcome(tr, params, norm, buf, state["judge"]))
        for row, k in zip(rec["rows"]["ppo"], kept["ppo"]):
            row.update(ppo_outcome(tr, ps.params,
                                   policy_params_from_jax(k, device), traj,
                                   last))


def compare(port_out: dict, jax_out: dict) -> dict:
    """Per state, piece and outcome: ``verdict`` and the detectable Δ."""
    out = {}
    for trainer in port_out["states"]:
        if trainer not in jax_out["states"]:
            continue
        per = out[trainer] = {}
        for piece in PIECES:
            prow = port_out["states"][trainer]["rows"][piece]
            jrow = jax_out["states"][trainer]["rows"][piece]
            per[piece] = {}
            for m in prow[0]:
                if m not in jrow[0]:
                    continue
                v = verdict([r[m] for r in prow], [r[m] for r in jrow])
                v["detectable"] = POWER_Z * v["bound"] / 2.0
                per[piece][m] = v
                print(f"[common_state] {trainer}-trained, {piece} {m}: port "
                      f"{v['port_mean']:.5g} ± {v['port_se']:.3g}, jax "
                      f"{v['jax_mean']:.5g} ± {v['jax_se']:.3g}: |Δ| "
                      f"{abs(v['delta']):.4g} vs 2 SE {v['bound']:.4g} → "
                      f"{'agree' if v['agree'] else 'DIFFER'} (detectable "
                      f"{v['detectable']:.4g})", flush=True)
    return out


def out_path(args, side: str) -> str:
    return os.path.join(args.out_dir, f"{cell(args)}.k{args.itr}.{side}"
                        ".json")


def parse(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", required=True, choices=[
        "port-state", "jax-state", "port", "jax", "verdict"])
    ap.add_argument("--family", default="half_cheetah")
    ap.add_argument("--model", default="ppo_cadm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--itr", type=int, default=16,
                    help="k*: the iteration whose start is the state")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--states", nargs="+", default=list(TRAINERS),
                    choices=TRAINERS)
    ap.add_argument("--device", default="cuda", help="port: torch device")
    ap.add_argument("--width", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--port-width", nargs="*", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--state-dir", default=STATE_DIR)
    ap.add_argument("--out-dir", default=OUT_DIR)
    return ap.parse_args(argv)


def main(argv=None, programs=None):
    """Runs ``--side``; returns the JAX programs where it made some."""
    args = parse(argv)
    if args.side == "port-state":
        return port_state(args)
    if args.side == "jax-state":
        return jax_state(args, programs)
    if args.side == "verdict":
        sides = []
        for side in ("port", "jax"):
            with open(out_path(args, side)) as f:
                sides.append(json.load(f))
        judge_jax(args, sides[1])
        out = {"itr": args.itr, "reps": {s["side"]: s["reps"] for s in sides},
               "devices": {s["side"]: s["device"] for s in sides},
               "port_width": sides[0].get("port_width", []),
               "power_z": POWER_Z, "verdicts": compare(*sides),
               "jax_judged": sides[1]["states"]}
        path = out_path(args, "verdict")
    else:
        if args.side == "port":
            out = port_side(args)
        else:
            out, programs = jax_side(args, programs)
        path = out_path(args, args.side)
        if os.path.exists(path):
            # a run on other states (``--states``) adds to the side's file
            with open(path) as f:
                earlier = json.load(f)
            if (earlier.get("side"), earlier.get("reps"),
                    earlier.get("port_width")) == (
                        out["side"], out["reps"], out.get("port_width")):
                out["states"] = {**earlier["states"], **out["states"]}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[common_state] wrote {path}", flush=True)
    return programs


if __name__ == "__main__":
    main()
