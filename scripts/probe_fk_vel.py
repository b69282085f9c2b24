#!/usr/bin/env python3
"""Kernel K3 (FK-velocity walk) with 4, 8 and 16 lanes per env, and what
ptxas gives each build.

    python scripts/probe_fk_vel.py
    python scripts/probe_fk_vel.py --ptxas TREE   # ptxas's report only

Each lane count is built into its own library (``-DCADM_FK_LANES=4``, ``8``
or ``16``; the source's default is the one kept) and timed in a process of
its own, in the order 4, 8, 16, 16, 8, 4: ``chip_smoke.device_ms`` over 20
calls on chip_smoke's random states of all four Systems at 2048 and 65,536
envs, beside chip_smoke's bound for the same call, and of the cheetah and
the humanoid at the sizes between (time against the number of rounds of
resident envs: ``envs_per_sm`` is what shared memory alone lets an SM
hold); each case is also checked against the plain version (float64, on
the float32 constants the kernel's table holds). Each process prints one
JSON line, times in µs, and the ptxas report of its build (``-Xptxas -v``:
registers, stack frame and spills of each kernel and non-inlined
function); the script then prints the mean per lane count. ``--ptxas``
prints that report alone for the kernels of TREE, the root of another tree
(for example a commit unpacked with ``git archive <commit> | tar -x -C
DIR``), built with this tree's flags.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = (4, 8, 16)
ENVS = (2048, 65536)
# the sizes between, for these Systems
SWEEP, SWEEP_SYSTEMS = (4096, 8192, 16384, 32768), ("half_cheetah",
                                                   "slim_humanoid")
# an SM's shared memory and what the system keeps of it per block (H100)
SM_SMEM, BLOCK_RESERVED = 233472, 1024
FUNCTIONS = re.compile(r"_Z\w*?((?:full_dyn_kernel|fk_vel_kernel)(?:ILi\d+E)?"
                       r"|fk_body_step|fk_body_row|fk_dof_row|fk_walk)\w*")


def envs_per_sm(fk_kernel, sys_, lanes: int) -> int:
    """Envs that shared memory lets one SM hold: the launch's dynamic
    shared memory (csrc/full_dyn.cu fk_vel_env_bytes: a Walk, COM and COM
    acceleration in double, the row, qpos and qvel in float) and the static
    table, per block of 64 / lanes envs."""
    walk = 8 * (3 * 5 * fk_kernel.NB_MAX + 4 * fk_kernel.NB_MAX
                + 3 * 2 * fk_kernel.NV_MAX)
    env_bytes = walk + 48 * sys_.nb + 4 * (
        fk_kernel.fk_width(sys_) + sys_.nq + sys_.nv)
    groups = 64 // lanes
    block = groups * env_bytes + ctypes.sizeof(fk_kernel.SysTable) \
        + BLOCK_RESERVED
    return min(SM_SMEM // block, 32) * groups


def ptxas_report(flags, tree: str = ROOT) -> str:
    """Registers, stack frame and spills that ptxas reports for each kernel
    and non-inlined function of ``tree``'s csrc/full_dyn.cu built with
    ``flags``."""
    from cadm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *(f for f in flags if f != "-shared"),
               "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "k.o"),
               os.path.join(tree, "cadm_tpu_torch", "csrc", "full_dyn.cu")]
        p = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return "\n".join(FUNCTIONS.sub(r"\1", line) for line in
                     (p.stdout + p.stderr).splitlines()
                     if any(w in line for w in ("properties", "stack frame",
                                                "registers")))


def time_lanes(lanes: int) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
    from cadm_tpu_torch.ops import _build, fk_kernel

    _build.NVCC_FLAGS += (f"-DCADM_FK_LANES={lanes}",)
    _build.lib()
    dev = torch.device("cuda")
    out = {"lanes": lanes, "card": cs.card_line(), "us": {}, "share": {},
           "envs_per_sm": {}, "err": 0.0}
    rng = np.random.RandomState(cs.SEED)
    for asset in ASSETS:
        sys_ = load_system(asset)
        out["envs_per_sm"][asset] = envs_per_sm(fk_kernel, sys_, lanes)
        for e in ENVS[:1] + SWEEP * (asset in SWEEP_SYSTEMS) + ENVS[1:]:
            qpos, qvel = (torch.tensor(x, dtype=torch.float32, device=dev)
                          for x in cs.smooth_state(sys_, rng, e)[:2])
            ref = fk_kernel.fk_vel_plain(cs.f32_constants(sys_),
                                         qpos.double(), qvel.double())
            out["err"] = max(out["err"], cs.fk_err(
                fk_kernel.fk_vel(sys_, qpos, qvel), ref))
            ms = cs.device_ms(lambda: fk_kernel.launch_fk_vel(sys_, qpos, qvel))
            bound_ms, _ = cs.bound(
                4 * e * (sys_.nq + sys_.nv + fk_kernel.fk_width(sys_)),
                e * cs.fk_ops(sys_), cs.FP64_FLOPS)
            out["us"][f"{asset} E{e}"] = 1e3 * ms
            out["share"][f"{asset} E{e}"] = bound_ms / ms
    out["ok"] = out["err"] <= cs.FK_ATOL
    out["ptxas"] = ptxas_report(_build.NVCC_FLAGS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", metavar="TREE",
                    help="print ptxas's report for TREE's kernels and stop")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_fk_vel.py needs a CUDA card", file=sys.stderr)
        return 1
    if a.ptxas:
        sys.path.insert(0, ROOT)
        from cadm_tpu_torch.ops import _build

        print(ptxas_report(_build.NVCC_FLAGS, os.path.abspath(a.ptxas)))
        return 0
    if a.lanes:
        r = time_lanes(a.lanes)
        print(json.dumps(r))
        return 0 if r["ok"] else 1
    runs = []
    for lanes in (*LANES, *LANES[::-1]):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--lanes", str(lanes)], capture_output=True,
                           text=True)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            raise RuntimeError(f"timing {lanes} lanes failed ({p.returncode})")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        report = r.pop("ptxas")
        runs.append(r)
        if len(runs) <= len(LANES):
            print(report)
        print(json.dumps(r))
    for lanes in LANES:
        mine = [r for r in runs if r["lanes"] == lanes]
        print(f"{lanes} lanes, mean µs: " + ", ".join(
            f"{k} {np.mean([r['us'][k] for r in mine]):.2f} "
            f"({100 * np.mean([r['share'][k] for r in mine]):.1f} % of bound)"
            for k in mine[0]["us"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
