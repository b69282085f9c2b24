"""Epoch-cap audit over recorded matrix cells (counterpart of
scripts/probe_epochs.py); reads cell JSONs only, no tensor.

Every cell JSON records per iteration ``fit/epochs_run`` (epochs run before
early stop or the cap) and ``fit/valid_fwd_mse_after``, so whether the fits
ended on the cap with the valid error still falling is answerable offline:

* ``cap_frac``       — share of iterations whose fit ran to ``max_epochs``
                       (early stop never fired);
* ``late_cap_frac``  — the same over the second half of training;
* ``mse_tail_ratio`` — valid forward MSE at the last iteration over its
                       minimum: > ~2 means the model got worse after its best
                       point, ~1 converged and held.

Usage:
  python -m cadm_tpu_torch.analysis.probe_epochs                # the port's cells
  python -m cadm_tpu_torch.analysis.probe_epochs --raw results/raw

Writes ``results/torch/epochs_audit.json`` and prints a table.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

from cadm_tpu_torch.cli.matrix import RESULTS_DIR
from cadm_tpu_torch.analysis.snapshot import out_path


def audit_cell(path: str) -> dict | None:
    """The audit row of one cell JSON, or None if it has no epoch counts."""
    with open(path) as f:
        d = json.load(f)
    hist = d.get("history") or []
    runs = [h.get("fit/epochs_run") for h in hist
            if h.get("fit/epochs_run") is not None]
    mses = [
        h.get("fit/valid_fwd_mse_after")
        for h in hist
        if h.get("fit/valid_fwd_mse_after") is not None
        and not math.isnan(h.get("fit/valid_fwd_mse_after"))
    ]
    if not runs:
        return None
    cap = max(d.get("config", {}).get("max_epochs", 8), max(runs))
    n = len(runs)
    at_cap = [r >= cap for r in runs]
    late = at_cap[n // 2:]
    out = {
        "cell": os.path.basename(path)[: -len(".json")],
        "iters": n,
        "epoch_cap": cap,
        "cap_frac": round(sum(at_cap) / n, 3),
        "late_cap_frac": round(sum(late) / max(len(late), 1), 3),
    }
    if mses:
        best = min(mses)
        out["valid_fwd_mse_last"] = round(mses[-1], 5)
        out["valid_fwd_mse_best"] = round(best, 5)
        out["mse_tail_ratio"] = round(mses[-1] / best, 2) if best > 0 else None
    return out


def audit(raw: str) -> list:
    """The rows of every readable cell JSON in ``raw``, by file name."""
    rows = []
    for path in sorted(glob.glob(os.path.join(raw, "*.json"))):
        try:
            row = audit_cell(path)
        except (json.JSONDecodeError, KeyError):
            continue
        if row is not None:
            rows.append(row)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw", default=RESULTS_DIR,
                   help="directory of cell JSONs (default results/torch/raw)")
    p.add_argument("--out", default=out_path("epochs_audit.json"))
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    rows = audit(args.raw)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    hdr = (f"{'cell':42s} {'itrs':>4s} {'cap%':>5s} {'late%':>5s} "
           f"{'mse_last':>9s} {'mse_best':>9s} {'tail':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(
            f"{r['cell']:42s} {r['iters']:4d} {r['cap_frac']:5.0%} "
            f"{r['late_cap_frac']:5.0%} "
            f"{r.get('valid_fwd_mse_last', float('nan')):9.4f} "
            f"{r.get('valid_fwd_mse_best', float('nan')):9.4f} "
            f"{(r.get('mse_tail_ratio') or float('nan')):5.2f}"
        )
    print(f"\nwrote {os.path.normpath(args.out)}")
    return rows


if __name__ == "__main__":
    main()
