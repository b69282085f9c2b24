"""Summarize the nvidia-smi samples that scripts/matrix_cells.sh logs beside
its cells (``smi_<start>.csv``: timestamp, SM clock, power draw and
utilization every 30 s):

    python scripts/smi_summary.py out/cells/smi_*.csv

Prints, per file and for all files together, the sample count, the SM
clocks seen under load (utilization ≥ 90 %), how many samples were at
≥ 90 % utilization, and the median, minimum and maximum power draw.
"""
import csv
import statistics
import sys


def samples(path):
    """[(clock MHz, power W, utilization %)] of one log."""
    with open(path) as f:
        rows = list(csv.reader(f))
    out = []
    for row in rows[1:]:
        if len(row) != 4:
            continue
        clock, power, util = (float(x.strip().split()[0]) for x in row[1:])
        out.append((clock, power, util))
    return out


def summary(rows) -> str:
    busy = [r for r in rows if r[2] >= 90]
    power = [r[1] for r in rows]
    clocks = sorted({r[0] for r in busy})
    return (f"{len(rows)} samples; under load {clocks} MHz; ≥ 90 % "
            f"utilization in {len(busy)} of {len(rows)}; power median "
            f"{statistics.median(power):.1f} W, {min(power):.1f}–"
            f"{max(power):.1f} W")


def main(paths) -> None:
    every = []
    for path in paths:
        rows = samples(path)
        every += rows
        print(f"{path}: {summary(rows)}")
    if len(paths) > 1:
        print(f"all: {summary(every)}")


if __name__ == "__main__":
    main(sys.argv[1:])
