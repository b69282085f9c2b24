"""Train one result-matrix cell with the JAX package on the CPU.

The cell is the reference runner's (``scripts/run_matrix.py``: the family's
base, the model variant over it, eval on the three ranges) without the
variant's ``max_parallel_rollouts``, the TPU's row budget, which the port's
tables (``cadm_tpu_torch/cli/matrix.py``) drop as well. It is trained by the
runner's own ``run_cell`` under ``JAX_PLATFORMS=cpu``, so the JAX package's
learning result at today's config can be set beside the port's cell of the
same name (``python -m cadm_tpu_torch.cli.results --raw results/torch/raw
--against results/torch/jax_cpu``).

Writes ``results/torch/jax_cpu/<cell>.json`` (the runner's keys plus
``card: "cpu"``) and the runner's ``.pkl`` snapshot under the git-ignored
``results/torch/ckpt/jax_cpu/``; nothing under ``results/raw/``. A PPO
cell also keeps its final ``PPOState`` there, as ``<cell>.ppo.pkl`` (a
numpy pytree, the runner's snapshot format), which the runner drops:
``scripts/cross_eval_ranges.py --side export --trained-by jax`` reads it. A cell
whose JSON exists is not trained again, as the runner skips a done cell.
With ``--probe-context`` it then runs ``scripts/probe_context.py
--random-policy --n-envs 128`` on the snapshot (2 rounds: 256 windows, as
the reference's record and the port's probe of the cell), its record under
``results/torch/jax_cpu/context_probe/``.

    python scripts/run_jax_cpu_cell.py --family cartpole --model cadm \\
        --seed 0 --probe-context
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "results", "torch", "jax_cpu")
CKPT_DIR = os.path.join(ROOT, "results", "torch", "ckpt", "jax_cpu")

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(ROOT, ".jax_cache"))
sys.path.insert(0, ROOT)


def keep_ppo_state() -> dict:
    """Wrap ``PPOTrainer.train`` so that the runner's ``run_cell``, which
    returns the model state only, leaves the final ``PPOState`` in the
    returned dict."""
    from cadm_tpu.train.ppo import PPOTrainer

    kept: dict = {}
    train = PPOTrainer.train

    def train_keeping_state(self, *args, **kwargs):
        out = train(self, *args, **kwargs)
        kept["ppo_state"] = out[0]
        return out

    PPOTrainer.train = train_keeping_state
    return kept


def save_ppo_state(name: str, ppo_state) -> None:
    """Pickle ``ppo_state`` as a numpy pytree beside the model snapshot."""
    import pickle

    import jax
    import numpy as np

    os.makedirs(CKPT_DIR, exist_ok=True)
    with open(os.path.join(CKPT_DIR, name + ".ppo.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, ppo_state), f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--probe-context", action="store_true",
                   help="then run probe_context --random-policy on the "
                        "snapshot")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import scripts.probe_context as probe_context
    import scripts.run_matrix as rm

    variant = {k: v for k, v in rm.MODEL_VARIANTS[args.model].items()
               if k != "max_parallel_rollouts"}
    base = {k: v for k, v in rm.FAMILY_BASE[args.family].items()
            if k != "max_parallel_rollouts"}
    rm.FAMILY_BASE = {**rm.FAMILY_BASE, args.family: base}
    rm.MODEL_VARIANTS = {**rm.MODEL_VARIANTS, args.model: variant}
    # the runner's probed budget (results/row_fault_probe.json) is the same
    # TPU row budget, measured
    rm.probed_budget = lambda family, model: None
    rm.CKPT_DIR = CKPT_DIR
    kept = keep_ppo_state()

    name = rm.cell_name(args.family, args.model, args.seed)
    path = os.path.join(OUT_DIR, name + ".json")
    if os.path.exists(path):
        print(f"[jax_cpu] skip (done): {path}", flush=True)
    else:
        t0 = time.time()
        record, dyn_state = rm.run_cell(args.family, args.model, args.seed)
        record["card"] = "cpu"
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f)
        rm.save_snapshot(name, dyn_state)
        if "ppo_state" in kept:
            save_ppo_state(name, kept["ppo_state"])
        print(f"[jax_cpu] {name}: trained in {record['wall_clock_s']:.1f} s "
              f"({time.time() - t0:.1f} s with the build) -> {path}",
              flush=True)

    if args.probe_context:
        probe_context.OUT_DIR = os.path.join(OUT_DIR, "context_probe")
        saved = sys.argv
        sys.argv = ["probe_context.py", "--cell", name, "--random-policy",
                    "--n-envs", "128"]
        try:
            probe_context.main()
        finally:
            sys.argv = saved


if __name__ == "__main__":
    main()
