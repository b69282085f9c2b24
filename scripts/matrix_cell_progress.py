"""Run result-matrix cells of the PyTorch port with a line per trainer phase.

``python -m cadm_tpu_torch.cli.matrix`` prints nothing until a cell ends,
and a model-based cell at the matrix's width can take longer than a job's
time limit. This runs the same ``cli.matrix.main`` (same arguments, same
files, same numbers) and prints, after every collect, fit and eval call of
``MBTrainer`` (and collect, PPO update, model fit and eval of
``PPOTrainer``), the seconds since the start and the call's own seconds, so
a cut run still shows how far it got and at what rate. Each stamp waits
for the card (``torch.cuda.synchronize``): a call returns while its last
graph replays still run, and without the wait their time would land on the
next call's stamp.

    python scripts/matrix_cell_progress.py --families half_cheetah \\
        --models cadm --seeds 0

``--summarize LOG...`` reads such logs instead and prints, per log, each
call name's count, seconds and share of the stamped time, and the range of
its calls' seconds (the first collect, the random one, apart).
"""
import os
import re
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cadm_tpu_torch.cli import matrix  # noqa: E402
from cadm_tpu_torch.train.mb_trainer import MBTrainer  # noqa: E402
from cadm_tpu_torch.train.ppo import PPOTrainer  # noqa: E402

T0 = time.time()


def stamp(cls, name: str) -> None:
    orig = getattr(cls, name)

    def inner(self, *args, **kwargs):
        t = time.time()
        out = orig(self, *args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"{name} ended at {time.time() - T0:.1f} s "
              f"({time.time() - t:.1f} s)", flush=True)
        return out

    setattr(cls, name, inner)


def summarize(path: str) -> None:
    calls = []
    with open(path) as f:
        for line in f:
            m = re.match(r"(\w+) ended at [\d.]+ s \(([\d.]+) s\)", line)
            if m:
                calls.append((m.group(1), float(m.group(2))))
    total = sum(s for _, s in calls)
    if calls and calls[0][0] == "_collect":
        calls[0] = ("_collect (first)", calls[0][1])
    parts = []
    for name in dict.fromkeys(n for n, _ in calls):
        secs = [s for n, s in calls if n == name]
        share = 100 * sum(secs) / total
        parts.append(f"{name} {len(secs)} × {min(secs):.1f}–{max(secs):.1f}"
                     f" s = {sum(secs):.1f} s ({share:.1f} %)")
    print(f"{path}: {total:.1f} s stamped; " + "; ".join(parts))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--summarize"]:
        for log in sys.argv[2:]:
            summarize(log)
        sys.exit(0)
    # before the trainer is built: it binds its fit method at construction
    for n in ("_collect", "_fit_epochs_impl", "_fit_impl", "evaluate"):
        stamp(MBTrainer, n)
    for n in ("_collect", "_ppo_update", "_fit_model", "evaluate"):
        stamp(PPOTrainer, n)
    matrix.main()
