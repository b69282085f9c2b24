"""rllab-style tabular logger (counterpart of cadm_tpu/utils/logger.py).

The same observable contract as the reference: ``logkv``/``dumpkvs``/``log``,
a ``progress.csv`` with one row per outer iteration, ``params.json`` for the
experiment config, ``debug.log`` for messages, mirrored to stderr.

The CSV header grows monotonically: new keys appearing later trigger a
rewrite of the file with the widened header (the reference family's CSV
consumers tolerate this; plotting tools read the final header).
"""
from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import Any, Dict


class TabularLogger:
    def __init__(self, log_dir: str, exp_name: str = "exp", mirror_stdout: bool = True):
        self.dir = os.path.join(log_dir, exp_name)
        os.makedirs(self.dir, exist_ok=True)
        self.csv_path = os.path.join(self.dir, "progress.csv")
        self.txt_path = os.path.join(self.dir, "debug.log")
        self._kvs: Dict[str, Any] = {}
        self._keys: list = []
        self._rows: list = []
        self._mirror = mirror_stdout
        self._t0 = time.time()

    # ------------------------------------------------------------------
    def log(self, msg: str) -> None:
        line = f"[{time.time() - self._t0:9.1f}s] {msg}"
        if self._mirror:
            print(line, file=sys.stderr)
        with open(self.txt_path, "a") as f:
            f.write(line + "\n")

    def logkv(self, key: str, value: Any) -> None:
        if hasattr(value, "item"):
            value = value.item()
        self._kvs[key] = value
        if key not in self._keys:
            self._keys.append(key)

    def dumpkvs(self) -> Dict[str, Any]:
        row = dict(self._kvs)
        self._rows.append(row)
        self._write_csv()
        if self._mirror:
            width = max((len(k) for k in row), default=0)
            print("-" * (width + 16), file=sys.stderr)
            for k in self._keys:
                if k in row:
                    v = row[k]
                    s = f"{v:.4g}" if isinstance(v, float) else str(v)
                    print(f"| {k:<{width}} | {s:>9} |", file=sys.stderr)
            print("-" * (width + 16), file=sys.stderr)
        self._kvs = {}
        return row

    def _write_csv(self) -> None:
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, restval="")
            w.writeheader()
            for r in self._rows:
                w.writerow(r)

    # ------------------------------------------------------------------
    def save_params(self, params: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "params.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)
