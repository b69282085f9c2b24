"""Render RESULTS_TORCH.md from results/torch/raw/*.json (counterpart of
scripts/make_results.py).

Every planned cell of the family × model variant × {train, moderate,
extreme} matrix is either a number (the mean ± half-range over seeds of each
run's mean of its last two evals) or an explicit skip reason. The table's
columns and row rules are the reference's, so the same raw directory gives
the same rows under either renderer.

Usage:
  python -m cadm_tpu_torch.cli.results            # writes RESULTS_TORCH.md
  python -m cadm_tpu_torch.cli.results --raw results/raw --out /tmp/r.md \\
      --print
  python -m cadm_tpu_torch.cli.results --against results/raw   # vs the JAX
  python -m cadm_tpu_torch.cli.results --fit-trace --against results/raw

``--fit-trace`` prints, instead of writing the file, each cell's fit
trajectory (``fit_trace``): a learning signature that does not rest on the
last two evals. ``--against`` also prints each run's evals as the mean of
its last ``--last-k`` (default 4) beside the last two (``last_k_table``),
an added view: the table and the comparison keep the last two.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RAW = os.path.join(ROOT, "results", "torch", "raw")
OUT = os.path.join(ROOT, "RESULTS_TORCH.md")

FAMILIES = [
    "cartpole", "pendulum", "half_cheetah", "cripple_ant",
    "slim_humanoid", "hopper", "ant",
]
MODELS = ["vanilla", "stacked", "rebal", "grbal", "pets", "pets_mse",
          "pets_dv", "cadm", "cadm_aug",
          "pets_cadm", "pets_cadm_mse", "pets_cadm_mse16", "pets_cadm_dv",
          "pets_cadm_aug", "ppo", "ppo_cadm"]
MODEL_LABEL = {
    "vanilla": "Vanilla",
    "stacked": "Stacked",
    "rebal": "ReBAL (RNN)",
    "grbal": "GrBAL",
    "cadm": "Vanilla + CaDM",
    "pets": "PE-TS",
    "pets_cadm": "PE-TS + CaDM",
    "pets_cadm_mse": "PE-TS + CaDM (MSE-gated fit)",
    "pets_cadm_mse16": "PE-TS + CaDM (MSE-gated, 16-epoch cap)",
    "cadm_aug": "Vanilla + CaDM (leg-sym aug)",
    "pets_cadm_dv": "PE-TS + CaDM (detached var head)",
    "pets_mse": "PE-TS (MSE-gated fit)",
    "pets_dv": "PE-TS (detached var head)",
    "pets_cadm_aug": "PE-TS + CaDM (leg-sym aug)",
    "ppo": "PPO",
    "ppo_cadm": "PPO + CaDM",
}
# opt-in rows (run on selected families only): a (family, model) with no
# cell and no failure is left out instead of printed as a skip
OPTIONAL_MODELS = {"stacked", "rebal", "grbal", "pets", "ppo", "ppo_cadm",
                   "pets_cadm_mse", "pets_cadm_mse16", "pets_cadm_dv",
                   "pets_mse", "pets_dv", "cadm_aug", "pets_cadm_aug"}
# 'ant' (mass/damping) is beyond the paper's six families
OPTIONAL_FAMILIES = {"ant"}


def load_cells(raw_dir: str = RAW):
    """({(family, model): [cell records]}, {(family, model): [failure
    reasons]}) of ``raw_dir``."""
    cells = {}
    for path in glob.glob(os.path.join(raw_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        cells.setdefault((r["family"], r["model"]), []).append(r)
    fails = {}
    for path in glob.glob(os.path.join(raw_dir, "*.failed")):
        fam, model, _ = os.path.basename(path)[:-len(".failed")].split("__")
        with open(path) as f:
            txt = f.read()
        # a CUDA error first: "an illegal memory access" is not an OOM
        reason = "CUDA error" if "CUDA error" in txt else (
            "OOM" if "memory" in txt.lower() else "error")
        fails.setdefault((fam, model), []).append(reason)
    return cells, fails


def _run_value(run, key, tail=2):
    """Mean of the last ``tail`` recorded (non-NaN) values of ``key`` in one
    run: eval returns at the matrix's scale swing between iterations, so
    one final point is a poor estimate."""
    vals = [h[key] for h in run["history"]
            if key in h and h[key] == h[key]]
    if not vals:
        return None
    return sum(vals[-tail:]) / len(vals[-tail:])


def final_metric(runs, key):
    """``mean`` over the runs (one run) or ``mean ± half-range``; None
    where no run recorded ``key``."""
    vals = [v for v in (_run_value(r, key) for r in runs) if v is not None]
    if not vals:
        return None
    mean = sum(vals) / len(vals)
    if len(vals) == 1:
        return f"{mean:.0f}"
    return f"{mean:.0f} ± {(max(vals) - min(vals)) / 2:.0f}"


def table(cells, fails) -> list:
    """The header and one row per planned (family, model), in the
    reference's format."""
    lines = [
        "| family | model | train | moderate | extreme | collect | seeds | "
        "wall/run |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for fam in FAMILIES:
        for model in MODELS:
            runs = cells.get((fam, model))
            if not runs:
                opt = model in OPTIONAL_MODELS or fam in OPTIONAL_FAMILIES
                if opt and not fails.get((fam, model)):
                    continue
                reason = ("; ".join(set(fails.get((fam, model), [])))
                          or "not yet run")
                lines.append(f"| {fam} | {MODEL_LABEL[model]} | — | — | "
                             f"— | — | 0 | skip: {reason} |")
                continue
            runs = sorted(runs, key=lambda r: r["seed"])
            row = [final_metric(runs, k) or "—" for k in METRICS]
            wall = sum(r["wall_clock_s"] for r in runs) / len(runs)
            # a probabilistic-ensemble run recorded without the loss-variant
            # tag may have trained under another loss
            mark = " †" if any(
                r.get("config", {}).get("ensemble", 1) > 1
                and r.get("config", {}).get("probabilistic") is not False
                and "loss_variant" not in r for r in runs) else ""
            lines.append(f"| {fam} | {MODEL_LABEL[model]} | {row[0]} | "
                         f"{row[1]} | {row[2]} | {row[3]} | {len(runs)}{mark}"
                         f" | {wall / 60:.1f} min |")
    return lines


METRICS = ("eval/return_mode0", "eval/return_mode1", "eval/return_mode2",
           "collect/mean_episode_return")


def compare(raw_dir: str, ref_dir: str) -> list:
    """A table of each (family, model) of ``raw_dir`` beside the same row of
    ``ref_dir`` (e.g. the JAX package's ``results/raw``): per metric, this
    directory's mean over its runs, the reference's mean ± half-range over
    its seeds, and "out" where the two means differ by more than the
    half-range, "out ×2" by more than twice it. Unrounded to 0.1."""
    cells, _ = load_cells(raw_dir)
    refs, _ = load_cells(ref_dir)
    lines = ["| family | model | train | moderate | extreme | collect | "
             "runs / ref seeds |", "|---|---|---|---|---|---|---|"]
    for fam in FAMILIES:
        for model in MODELS:
            runs, ref = cells.get((fam, model)), refs.get((fam, model), [])
            if not runs:
                continue
            parts = []
            for key in METRICS:
                ours = [v for v in (_run_value(r, key) for r in runs)
                        if v is not None]
                theirs = [v for v in (_run_value(r, key) for r in ref)
                          if v is not None]
                if not ours or not theirs:
                    parts.append("—")
                    continue
                mean = sum(ours) / len(ours)
                ref_mean = sum(theirs) / len(theirs)
                half = (max(theirs) - min(theirs)) / 2
                gap = abs(mean - ref_mean)
                mark = ("" if gap <= half else
                        " out" if gap <= 2 * half else " out ×2")
                parts.append(
                    f"{mean:.1f} / {ref_mean:.1f} ± {half:.1f}{mark}")
            lines.append(f"| {fam} | {MODEL_LABEL[model]} | "
                         + " | ".join(parts)
                         + f" | {len(runs)} / {len(ref)} |")
    return lines


def _evals_text(run, tail: int) -> str:
    """train / moderate / extreme: each the mean of the run's last
    ``tail`` evals, unrounded to 0.1."""
    vals = [_run_value(run, key, tail) for key in METRICS[:3]]
    return " / ".join("—" if v is None else f"{v:.1f}" for v in vals)


def last_k_table(raw_dir: str = RAW, ref_dir: str = None,
                 k: int = 4) -> list:
    """A line per run of ``raw_dir``: its eval returns per mode as the mean
    of the last two evals (the protocol's statistic) and of the last ``k``
    (with ``ref_dir``, each seed's last ``k`` of the same family and model
    there). One eval swings ×2–×3 between iterations, so the last ``k``
    is an added view; the table and ``compare`` keep the last two."""
    cells, _ = load_cells(raw_dir)
    refs = load_cells(ref_dir)[0] if ref_dir else {}
    lines = [f"| cell | last 2 evals | last {k} evals |"
             + (f" reference seeds, last {k} |" if ref_dir else ""),
             "|---|---|---|" + ("---|" if ref_dir else "")]
    for key in sorted(cells):
        for run in sorted(cells[key], key=lambda r: r["seed"]):
            row = (f"| {key[0]}__{key[1]}__s{run['seed']} | "
                   f"{_evals_text(run, 2)} | {_evals_text(run, k)} |")
            if ref_dir:
                row += " " + ("; ".join(
                    f"s{r['seed']} {_evals_text(r, k)}" for r in
                    sorted(refs.get(key, []), key=lambda r: r["seed"]))
                    or "—") + " |"
            lines.append(row)
    return lines


FIT_MSE, FIT_EPOCHS = "fit/valid_fwd_mse_after", "fit/epochs_run"
FIT_LOSS = "fit/valid_loss_after"


def fit_trace(run):
    """(first-3 mean, last-4 mean, maximum) of the valid forward MSE over a
    run's iterations, the mean ``fit/epochs_run`` over its last 8, and the
    column read. A run whose model reports no forward MSE (GrBAL: the
    column recorded, NaN at every iteration) is read on its valid loss
    ``FIT_LOSS`` instead; None where the run did not record the MSE."""
    col = lambda key: [h[key] for h in run["history"]  # noqa: E731
                       if key in h and h[key] == h[key]]
    column = FIT_MSE
    if not col(FIT_MSE) and any(FIT_MSE in h for h in run["history"]):
        column = FIT_LOSS
    vals, epochs = col(column), col(FIT_EPOCHS)
    if not vals:
        return None
    return (sum(vals[:3]) / len(vals[:3]), sum(vals[-4:]) / len(vals[-4:]),
            max(vals), sum(epochs[-8:]) / len(epochs[-8:]), column)


def _trace_text(trace) -> str:
    text = "{:.4f} → {:.4f}, max {:.3f}, epochs {:.2f}".format(*trace[:4])
    return text if trace[4] == FIT_MSE else f"{trace[4]} {text}"


def fit_trace_table(raw_dir: str = RAW, ref_dir: str = None) -> list:
    """A line per cell of ``raw_dir``: its ``fit_trace`` (and, with
    ``ref_dir``, each seed's of the same family and model there), or the
    cell named as skipped where it has no forward-MSE column. A trace read
    on the valid loss (GrBAL) names that column first."""
    cells, _ = load_cells(raw_dir)
    refs = load_cells(ref_dir)[0] if ref_dir else {}
    lines = ["| cell | valid fwd MSE (or the column named) first-3 → last-4, "
             "max, epochs (last 8) |"
             + (" reference seeds |" if ref_dir else ""),
             "|---|---|" + ("---|" if ref_dir else "")]
    for key in sorted(cells):
        for run in sorted(cells[key], key=lambda r: r["seed"]):
            name = f"{key[0]}__{key[1]}__s{run['seed']}"
            trace = fit_trace(run)
            row = (_trace_text(trace) if trace
                   else f"skip: no {FIT_MSE} column")
            if ref_dir:
                ref = [(r["seed"], fit_trace(r)) for r in
                       sorted(refs.get(key, []), key=lambda r: r["seed"])]
                row += " | " + ("; ".join(
                    f"s{seed} " + (_trace_text(t) if t else "no column")
                    for seed, t in ref) or "—")
            lines.append(f"| {name} | {row} |")
    return lines


def render(raw_dir: str = RAW) -> list:
    """The lines of RESULTS_TORCH.md for the cells in ``raw_dir``."""
    cells, fails = load_cells(raw_dir)
    cards = sorted({r.get("card", "not recorded")
                    for runs in cells.values() for r in runs})
    return [
        "# RESULTS_TORCH — the result matrix on the PyTorch port",
        "",
        "Generated by `python -m cadm_tpu_torch.cli.results` from "
        "`results/torch/raw/` (each cell = mean over a run's last TWO "
        "recorded evals — each eval = mean return over `eval_envs` full "
        "episodes — then mean ± half-range over seeds; discrete paper "
        "randomization sets, warm-started CEM, epoch fit protocol — configs "
        "in `cadm_tpu_torch/cli/matrix.py`, the reference's "
        "`scripts/run_matrix.py` values). The JAX package's table is "
        "`RESULTS.md`.",
        "",
        *table(cells, fails),
        "",
        "Notes:",
        "- train/moderate/extreme = hidden-parameter ranges mode 0/1/2 "
        "(scale sets {0.75,0.85,1.0,1.15,1.25} / {0.4,0.5,1.5,1.6} / "
        "{0.2,0.3,1.7,1.8}).",
        "- collect = mean return of episodes finished during on-policy "
        "collection at the final iteration (train range).",
        "- Each run executes on one CUDA card (each cell's `card`: "
        + ("; ".join(cards) if cards else "none yet") + "); wall-clock is "
        "the training loop's (a rigid family's first cell in a fresh "
        "checkout also builds the CUDA kernels).",
        "- † = at least one probabilistic-ensemble run has no recorded "
        "loss-variant tag.",
        "- hopper and slim_humanoid run the MBBL fixed-horizon protocol, "
        "under which true-sim returns move <5% across the ranges "
        "(RESULTS.md's note), so flat train≈moderate≈extreme rows there "
        "are a property of the benchmark. cripple_ant's moderate and "
        "extreme are the same distribution (held-out leg 3).",
        "- PE-TS + CaDM runs probabilistic members, today's config in both "
        "packages; RESULTS.md's cartpole and pendulum cells of that row ran "
        "deterministic ones. On cartpole, the JAX package's own cell at "
        "today's config (seed 0, trained on the CPU by "
        "`scripts/run_jax_cpu_cell.py`) also falls below RESULTS.md's row "
        "(`python -m cadm_tpu_torch.cli.results --raw results/torch/jax_cpu "
        "--against results/raw`), but its extreme (119.1) stays above this "
        "table's (81.0), n = 1 each. Pendulum's JAX cell at today's config "
        "was not run.",
        "- half_cheetah Vanilla + CaDM: RESULTS.md's two seeds ran two code "
        "versions. Its s0 (written in `6930946`) predates the planner's "
        "model-rollout blow-up guard (`beca625`) and the tri-state "
        "`probabilistic`/`mean_anchor` (`941b933`) and evaluated with "
        "`ensemble_eval: assign`: 5651 / 3860 / 2887 alone. Its s1 "
        "(`13b77a2`, code `806c03e`) ran today's config: 4188 / 2977 / "
        "2272. One trained model of this table's cell (s4), evaluated by "
        "both packages at pinned scales 0.2–1.8 "
        "(`scripts/cross_eval_ranges.py`, `results/torch/cross_eval/`), "
        "acts alike in both: the extreme shortfall here is training or the "
        "record, not the acting path (ROADMAP C5).",
        "- Sharing the card: the first eight seed-0 cells (cartpole, "
        "pendulum, and the cheetah's s0 and hopper's PPO + CaDM) ran as "
        "five processes sharing one card, so their wall is not a cell's "
        "own time; every later cell ran alone on the card, one at a time.",
        "- half_cheetah PPO + CaDM: the JAX package's own cell at today's "
        "config, trained on the CPU (`scripts/run_jax_cpu_cell.py`, "
        "`results/torch/jax_cpu/`, seeds 0–3), lands out ×2 of "
        "RESULTS.md's row too, so that row is not this cell's reference "
        "at today's config. Against the JAX cell (`--raw "
        "results/torch/raw --against results/torch/jax_cpu`, 5 seeds "
        "against 4) this table's row is out ×2 above on train (every seed "
        "of it above every JAX seed) and in on the rest. One policy from "
        "each package, evaluated by both (`scripts/cross_eval_ranges.py`, "
        "`results/torch/cross_eval/`), scores alike in both, and the "
        "port-trained one lies above the JAX-trained one in both: the gap "
        "is made in training, not in acting (ROADMAP C3).",
        "- The cripple_ant, slim_humanoid and hopper MB rows are one seed "
        "each. Out ×2 of RESULTS.md's rows (`--against results/raw`): "
        "cripple_ant Vanilla below on train, moderate and extreme, "
        "cripple_ant Vanilla + CaDM above on collect, slim_humanoid "
        "Vanilla below on extreme, hopper Vanilla below on collect, hopper "
        "Vanilla + CaDM below on train and collect. Each reference "
        "half-range there is narrower than the swing of either reference "
        "seed between its own evals; the second seeds are queued (ROADMAP "
        "C7).",
        "- half_cheetah PE-TS + CaDM, seed 0 of the shared-trunk row and of "
        "its detached-variance-head variant (NVIDIA H100 80GB HBM3, "
        "700.00 W): the fit's trajectory (`--fit-trace --against "
        "results/raw`: the valid forward MSE's first-3 mean → last-4 mean, "
        "its maximum) is the records' on both. The shared trunk degrades "
        "(0.0245 → 0.0536, max 0.073; the records 0.0313 → 0.0660, max "
        "0.117 and 0.0260 → 0.0577, max 0.330) and its returns collapse "
        "into RESULTS.md's band on all three ranges; the detached head "
        "holds (0.0141 → 0.0093, max 0.015; the records 0.0139 → 0.0082 "
        "and 0.0130 → 0.0090, max 0.016). The detached row is out ×2 above "
        "RESULTS.md's on every column at n = 1: its last two evals are its "
        "best two (train 1,208–4,932 at its four earlier evals). "
        "cripple_ant PE-TS + CaDM (seed 0, same card): its forward MSE "
        "falls as the records' do and ends at their last-4 means (0.0585 "
        "against 0.0609 / 0.0620); out ×2 above RESULTS.md's row on train "
        "and collect, in on moderate and extreme.",
        "- half_cheetah Vanilla, Stacked, ReBAL (RNN), GrBAL and PPO: seed 0 "
        "each (same card). Each fit trace (`--fit-trace --against "
        "results/raw`; GrBAL's on its valid loss, as its model reports no "
        "forward MSE) lies with the records'. Out ×2 of RESULTS.md's rows "
        "at n = 1: Vanilla below on the three ranges, ReBAL above on all "
        "four columns, GrBAL above on moderate and below on collect (both "
        "against half-ranges of about 2 %), Stacked above on train and "
        "moderate, PPO above on train "
        "and moderate, where, as for PPO + CaDM, the record may not be the "
        "cell's reference at today's config. The second seeds are queued "
        "(ROADMAP C7).",
        "",
    ]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw", default=RAW, help="directory of the cell JSONs")
    p.add_argument("--out", default=OUT, help="the Markdown file to write")
    p.add_argument("--print", action="store_true", help="also print it")
    p.add_argument("--against", default=None, metavar="REF_RAW",
                   help="also print each row beside REF_RAW's (e.g. "
                        "results/raw, the JAX package's cells)")
    p.add_argument("--last-k", type=int, default=4, metavar="K",
                   help="with --against, also print each run's evals as "
                        "the mean of its last K beside its last two")
    p.add_argument("--fit-trace", action="store_true",
                   help="print each cell's fit trajectory (beside "
                        "--against's seeds) and write nothing")
    args = p.parse_args(argv)
    if args.fit_trace:
        print("\n".join(fit_trace_table(args.raw, args.against)))
        return
    lines = render(args.raw)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}")
    if args.print:
        print("\n".join(lines))
    if args.against:
        print("\n".join(compare(args.raw, args.against)))
        print("\n".join(last_k_table(args.raw, args.against, args.last_k)))


if __name__ == "__main__":
    main()
