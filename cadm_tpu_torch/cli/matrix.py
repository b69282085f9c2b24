"""Result-matrix runner on the card (counterpart of scripts/run_matrix.py).

Runs the matrix's cells (env family × model variant × seed, each evaluated
on the train/moderate/extreme ranges) one after another and writes one JSON
per cell into ``results/torch/raw/``, and the final model state into
``results/torch/ckpt/`` (git-ignored; a PPO cell's PPO state with it).
Resume-safe: a cell whose JSON exists is skipped, so the runner can be
stopped and started again at any time. ``python -m cadm_tpu_torch.cli.results`` renders ``RESULTS_TORCH.md``
from the raw cells.

Usage:
  python -m cadm_tpu_torch.cli.matrix                # everything not yet done
  python -m cadm_tpu_torch.cli.matrix --families half_cheetah --models cadm \\
      --seeds 0
  python -m cadm_tpu_torch.cli.matrix --list         # the planned cells

``--device`` defaults to ``cuda`` and raises without a card (no CPU
fallback). A cell JSON holds the reference's keys (family, model, seed,
config, code_version, loss_variant, wall_clock_s, history) and ``card``:
the card's name and power limit as ``nvidia-smi`` gives them, or ``cpu``.

Bookkeeping, as the reference's: a Python error writes ``<cell>.failed``
(skipped from then on); ``<cell>.attempts`` counts starts that ended
neither in a JSON nor in a ``.failed``, and a cell started 3 times is
marked ``.crashed`` and skipped; a CUDA error leaves the process's CUDA
context unusable, so the runner exits 17 with the attempt counted and a
new process goes on from the next undone cell; a SIGTERM that reaches the
interpreter restores the in-flight cell's counter and exits 143.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import time
import traceback

import torch

from cadm_tpu_torch.cli.presets import ExperimentConfig
from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.models.dynamics import LOSS_VARIANT
from cadm_tpu_torch.utils.checkpoint import to_plain

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(ROOT, "results", "torch", "raw")
CKPT_DIR = os.path.join(ROOT, "results", "torch", "ckpt")

# The reference's cell tables (scripts/run_matrix.py:45-170), with every
# `max_parallel_rollouts` dropped: that knob chunks the planner's env axis
# to stay under a libtpu row-count fault, and the port plans every env in
# one batch. buffer_capacity >= n_itr * steps_per_itr in every family: the
# ring never wraps, as the reference's dataset never evicts. hopper and
# slim_humanoid run the MBBL fixed-horizon protocol (no early termination,
# 1000-step episodes).
FAMILY_BASE = {
    "cartpole": dict(
        env="cartpole", planner="rs", n_candidates=500, plan_horizon=20,
        history_k=10, future_m=5, n_envs=16, steps_per_itr=210, n_itr=10,
        buffer_capacity=4000, eval_envs=32, fit_protocol="epochs",
    ),
    "pendulum": dict(
        env="pendulum", planner="cem", n_candidates=200, plan_horizon=20,
        n_envs=16, steps_per_itr=210, n_itr=12, buffer_capacity=4000,
        eval_envs=32, warm_start=True, fit_protocol="epochs",
    ),
    "half_cheetah": dict(
        env="half_cheetah", planner="cem", n_candidates=256, plan_horizon=30,
        n_envs=256, steps_per_itr=500, n_itr=16, buffer_capacity=8000,
        batch_size=256, eval_envs=32, warm_start=True, fit_protocol="epochs",
        eval_every=3,
    ),
    "cripple_ant": dict(
        env="cripple_ant", planner="cem", n_candidates=256, plan_horizon=30,
        n_envs=256, steps_per_itr=500, n_itr=18, buffer_capacity=9000,
        batch_size=256, eval_envs=32, warm_start=True, fit_protocol="epochs",
        eval_every=3,
    ),
    "slim_humanoid": dict(
        env="slim_humanoid", planner="cem", n_candidates=256, plan_horizon=30,
        n_envs=256, steps_per_itr=500, n_itr=12, buffer_capacity=6000,
        batch_size=256, eval_envs=32, warm_start=True, fit_protocol="epochs",
        eval_every=4, terminate_unhealthy=False, env_horizon=1000,
    ),
    "hopper": dict(
        env="hopper", planner="cem", n_candidates=256, plan_horizon=30,
        n_envs=256, steps_per_itr=500, n_itr=16, buffer_capacity=8000,
        batch_size=256, eval_envs=32, warm_start=True, fit_protocol="epochs",
        eval_every=4, terminate_unhealthy=False, env_horizon=1000,
    ),
    # a family beyond the paper's six: the mass/damping variant of CrippleAnt
    "ant": dict(
        env="ant", planner="cem", n_candidates=256, plan_horizon=30,
        n_envs=256, steps_per_itr=500, n_itr=12, buffer_capacity=6000,
        batch_size=256, eval_envs=32, warm_start=True, fit_protocol="epochs",
        eval_every=3,
    ),
}

MODEL_VARIANTS = {
    "vanilla": dict(model="vanilla", ensemble=1),
    "cadm": dict(model="cadm", ensemble=1),
    "pets": dict(model="vanilla", ensemble=5),
    "pets_cadm": dict(model="cadm", ensemble=5),
    # the ensemble's early stop on the forward-mean MSE instead of the total
    # valid loss (_mse16 also doubles the epoch cap)
    "pets_cadm_mse": dict(model="cadm", ensemble=5,
                          early_stop_metric="fwd_mse"),
    "pets_cadm_mse16": dict(model="cadm", ensemble=5,
                            early_stop_metric="fwd_mse", max_epochs=16),
    # ... and the log-variance columns reading the trunk through a
    # stop-gradient
    "pets_cadm_dv": dict(model="cadm", ensemble=5,
                         early_stop_metric="fwd_mse",
                         detach_logvar_trunk=True),
    "pets_mse": dict(model="vanilla", ensemble=5,
                     early_stop_metric="fwd_mse"),
    "pets_dv": dict(model="vanilla", ensemble=5, early_stop_metric="fwd_mse",
                    detach_logvar_trunk=True),
    # CrippleAnt's 4-fold leg-relabelling train-batch augmentation
    "cadm_aug": dict(model="cadm", ensemble=1, symmetry_aug=True),
    "pets_cadm_aug": dict(model="cadm", ensemble=5, symmetry_aug=True),
    # the baselines (opt-in through --models)
    "stacked": dict(model="stacked", ensemble=1),
    "rebal": dict(model="rnn", ensemble=1),
    "grbal": dict(model="grbal", ensemble=1),
    # model-free rows: PPO on raw obs, and on concat(obs, z); the variant's
    # keys override the family's planner knobs
    "ppo": dict(
        trainer="ppo", model="vanilla", ensemble=1, n_envs=128,
        rollout_len=256, n_itr=60, model_updates_per_itr=200,
        batch_size=256, buffer_capacity=4096, eval_envs=32,
    ),
    "ppo_cadm": dict(
        trainer="ppo", model="cadm", ensemble=1, n_envs=128,
        rollout_len=256, n_itr=60, model_updates_per_itr=200,
        batch_size=256, buffer_capacity=4096, eval_envs=32,
    ),
}

DEFAULT_FAMILIES = [
    "cartpole", "pendulum", "half_cheetah", "cripple_ant",
    "slim_humanoid", "hopper",
]


def cell_name(family: str, model: str, seed: int) -> str:
    return f"{family}__{model}__s{seed}"


def cell_config(family: str, model: str, seed: int) -> ExperimentConfig:
    """The cell's config: the family's base, the variant over it, eval on
    the three ranges."""
    return ExperimentConfig(**{**FAMILY_BASE[family], **MODEL_VARIANTS[model]},
                            seed=seed, eval_modes=(0, 1, 2))


def code_version() -> str:
    """The checkout's short commit, or (with no git history, as in a copy
    of the tree) ``src-`` and a hash of the package's sources."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, timeout=10).stdout.strip()
        if out:
            return out
    except (OSError, subprocess.SubprocessError):
        pass
    h = hashlib.sha256()
    pkg = os.path.join(ROOT, "cadm_tpu_torch")
    for d, dirs, files in sorted(os.walk(pkg)):
        dirs[:] = sorted(x for x in dirs if x not in ("_build", "__pycache__"))
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".xml", ".npz")):
                with open(os.path.join(d, f), "rb") as fh:
                    h.update(os.path.relpath(os.path.join(d, f), pkg).encode())
                    h.update(fh.read())
    return "src-" + h.hexdigest()[:12]


def card(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``'s CSV), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def run_cell(family: str, model: str, seed: int, device="cuda"):
    """Train one cell → (its JSON record, the final model state), and for
    a PPO cell the final PPO state after them."""
    device = resolve_device(device)
    cfg = cell_config(family, model, seed)
    _, _, _, trainer = cfg.build(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.time()
    # MBTrainer returns (model state, history); PPOTrainer (ppo state,
    # model state, history): unpack tail-first for both
    out = trainer.train(gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    return {
        "family": family,
        "model": model,
        "seed": seed,
        "config": dataclasses.asdict(cfg),
        "code_version": code_version(),
        "loss_variant": LOSS_VARIANT,
        "wall_clock_s": wall,
        "history": out[-1],
        "card": card(device),
    }, out[-2], *out[:-2]


def save_snapshot(name: str, dyn_state, ppo_state=None) -> None:
    """The final model state as plain dicts and tensors
    (``utils/checkpoint.to_plain``), ``torch.load(weights_only=True)``
    reads it back: analysis state for the snapshot probes, not resume
    state. A PPO cell's policy state goes beside it, under ``ppo``."""
    os.makedirs(CKPT_DIR, exist_ok=True)
    plain = to_plain(dyn_state)
    if ppo_state is not None:
        plain["ppo"] = to_plain(ppo_state)
    torch.save(plain, os.path.join(CKPT_DIR, name + ".pt"))


# The in-flight cell's .attempts file, for the SIGTERM handler below.
_CURRENT_ATTEMPT = {"path": None, "before": 0}


def _on_sigterm(signum, frame):
    """A SIGTERM that reaches a responsive interpreter (a job's time limit
    on a slow but healthy cell): restore the in-flight cell's pre-start
    attempt count instead of charging it a start toward ``.crashed``. A
    process hung in a device call never runs this, so its start counts."""
    path = _CURRENT_ATTEMPT["path"]
    if path and os.path.exists(path):
        before = _CURRENT_ATTEMPT["before"]
        if before <= 0:
            os.remove(path)
        else:
            with open(path, "w") as f:
                f.write(str(before))
        print("[matrix] SIGTERM while healthy; restored attempt counter",
              flush=True)
    raise SystemExit(143)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--families", nargs="*", default=DEFAULT_FAMILIES,
                   choices=sorted(FAMILY_BASE))
    # the default is the paper's primary comparison; the baselines and the
    # protocol variants are opt-in
    p.add_argument("--models", nargs="*",
                   default=["vanilla", "cadm", "pets_cadm"],
                   choices=sorted(MODEL_VARIANTS))
    p.add_argument("--seeds", nargs="*", type=int, default=[0, 1])
    p.add_argument("--list", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # seed-major: one whole family × model sweep per seed, so a partial run
    # still covers the matrix at one seed
    cells = [(f, m, s) for s in args.seeds for f in args.families
             for m in args.models]
    if args.list:
        for c in cells:
            done = os.path.exists(
                os.path.join(RESULTS_DIR, cell_name(*c) + ".json"))
            print(("DONE " if done else "todo ") + cell_name(*c))
        return
    device = resolve_device(args.device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    saved = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        for family, model, seed in cells:
            _run_one(family, model, seed, device)
    finally:
        signal.signal(signal.SIGTERM, saved)


def _run_one(family: str, model: str, seed: int, device) -> None:
    name = cell_name(family, model, seed)
    path = os.path.join(RESULTS_DIR, name + ".json")
    fail_path, crash_path, attempt_path = (
        path[:-5] + ext for ext in (".failed", ".crashed", ".attempts"))
    for marker, why in ((path, "done"), (fail_path, "failed earlier"),
                        (crash_path, "crashed/hung earlier")):
        if os.path.exists(marker):
            print(f"[matrix] skip ({why}): {name}", flush=True)
            return
    # Start-attempt counter: covers both a CUDA error (the process exits 17)
    # and a hang (the process killed from outside, with no exception at
    # all). A cell that starts 3 times without ever writing its .json or
    # .failed is marked .crashed and skipped from then on.
    attempts = 0
    if os.path.exists(attempt_path):
        with open(attempt_path) as f:
            attempts = int(f.read().strip() or "0")
    if attempts >= 3:
        with open(crash_path, "w") as f:
            f.write(f"started {attempts}x, never finished (crash or hang)\n")
        os.remove(attempt_path)
        print(f"[matrix] cell started {attempts}x without finishing; marking "
              f".crashed and skipping from now on", flush=True)
        return
    with open(attempt_path, "w") as f:
        f.write(str(attempts + 1))
    _CURRENT_ATTEMPT.update(path=attempt_path, before=attempts)
    print(f"[matrix] run: {name} (start attempt {attempts + 1})", flush=True)
    try:
        result, *states = run_cell(family, model, seed, device)
    except Exception as exc:
        _CURRENT_ATTEMPT["path"] = None
        tb = traceback.format_exc()
        print(f"[matrix] FAILED: {name}", flush=True)
        traceback.print_exc()
        acc = getattr(torch, "AcceleratorError", None)
        if "CUDA error" in tb or (acc is not None and isinstance(exc, acc)):
            # the CUDA context is lost; a new process must start (the
            # .attempts counter persists and bounds the retries)
            print("[matrix] CUDA error; exiting for restart", flush=True)
            raise SystemExit(17)
        with open(fail_path, "w") as f:
            f.write(tb)
        os.remove(attempt_path)
        return
    _CURRENT_ATTEMPT["path"] = None
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, path)
    try:
        save_snapshot(name, *states)
    except Exception:
        traceback.print_exc()  # snapshots are best-effort analysis state
    if os.path.exists(attempt_path):
        os.remove(attempt_path)
    last = result["history"][-1]
    print(f"[matrix] done in {result['wall_clock_s']:.0f}s: "
          f"train={last.get('eval/return_mode0'):.1f} "
          f"mod={last.get('eval/return_mode1'):.1f} "
          f"ext={last.get('eval/return_mode2'):.1f}", flush=True)


if __name__ == "__main__":
    main()
