#!/usr/bin/env python3
"""Where kernel K1 (PGS) spends its time: device time against the sweep
count and the number of active contacts, at nc 16 (cheetah).

    python scripts/probe_pgs.py [TREE]

TREE is the root of the tree whose kernel to time (default: this one), for
example a commit unpacked with ``git archive <commit> | tar -x -C DIR``. Each
case is ``chip_smoke.device_ms`` over 20 calls: chip_smoke's random systems
(2/3 of the contacts active) at 1, 2, 6 and 15 sweeps, the same systems with
0, 1, 4 or all 16 contacts active per env, and 1056, 2112 and 4096 envs.
The slope over the sweep count is the cost of a sweep (the chain of
contact updates of the env with the most active contacts); the intercept is
the load, the launch and the write. Prints one JSON object, times in µs.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_pgs.py needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.insert(0, tree)
    from cadm_tpu_torch.ops import pgs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A, b, vstar, actmu, _ = cs.pgs_inputs(16, dev, gen)

    def us(mu, iters, A=A, b=b, vstar=vstar):
        lam0 = torch.zeros_like(b)
        return 1e3 * cs.device_ms(
            lambda: pgs.pgs_solve(A, b, vstar, mu, lam0, iters=iters), 20)

    out = {f"random it{it}": us(actmu, it) for it in (1, 2, 6, 15)}
    out["0 active it15"] = us(torch.zeros_like(actmu), 15)
    for na in (1, 4, 16):
        mu = torch.zeros_like(actmu)
        mu[:, :na] = 1.0
        out.update({f"{na} active it{it}": us(mu, it) for it in (1, 6, 15)})
    for e in (132 * 8, 264 * 8, 4096):
        A_, b_, v_, m_, _ = cs.pgs_inputs(16, dev, gen, e=e)
        out[f"random E{e} it15"] = us(m_, 15, A_, b_, v_)
    print(json.dumps({"tree": tree, "card": cs.card_line(),
                      "us": {k: round(v, 2) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
