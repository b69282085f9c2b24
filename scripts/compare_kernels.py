#!/usr/bin/env python3
"""Time kernels K1 (PGS), K2 (fused smooth dynamics) and K3 (FK-velocity
walk) of two trees of the PyTorch port on one card, on the same inputs.

    git archive <commit> | tar -x -C _archive/parent   # any git-ignored dir
    python scripts/compare_kernels.py --parent _archive/parent

The inputs are ``chip_smoke.py``'s: K1 on 2048 random systems at nc 16, cold
(15 sweeps) and warm (6), and on the main path's own (A, b, v*, μ, λ0) of one
cold and one warm substep of 2048 cheetahs, captured once with this tree's
env; K2 at 2048 random cheetah and slim_humanoid states (kernel alone, and
the ``full_dyn`` wrapper); K3 at random states of all four Systems at 2048
and 65,536 envs; and the env step of 2048 cheetahs under random actions
(host clock, ms per control step). Kernel times are device times from
``torch.profiler``; "call ms" is the time per call of 50 calls back to back
(CUDA events), host launch gaps included. Each tree runs in its own
process, in the order parent, this, this, parent, each building its own
kernels; every process prints one JSON line, and the script prints them and
their per-tree means. Each process also checks its kernels against this
tree's plain versions (λ 1e-4; M⁻¹ 5e-5, v_pred 5e-4 and the FK fields 1e-5
against the plain version in float64 on the float32 constants the kernels'
table holds).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K2_SYSTEMS = ("half_cheetah", "slim_humanoid")


def time_tree(tree: str, inputs: str) -> dict:
    """Time ``tree``'s kernels on the saved main-path inputs and on
    chip_smoke's random inputs (run in a process of its own)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cadm_tpu_torch.envs.rigid_base import load_system as ref_load
    from cadm_tpu_torch.ops import fk_kernel as ref_fk
    from cadm_tpu_torch.ops import pgs as ref_pgs

    # the tree under test is imported under the same package name: drop
    # this tree's modules first (the plain versions above stay bound)
    for name in [m for m in sys.modules if m.startswith("cadm_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(tree))
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
    from cadm_tpu_torch.ops import _build, fk_kernel, pgs

    assert os.path.abspath(_build.__file__).startswith(os.path.abspath(tree))
    _build.lib()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": tree}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A, b, vstar, actmu, warm0 = cs.pgs_inputs(16, dev, gen)
    cases = [("random cold", (A, b, vstar, actmu, torch.zeros_like(b), 15)),
             ("random warm", (A, b, vstar, actmu, warm0, 6))]
    saved = torch.load(inputs)
    cases += [(f"main-path {tag}", tuple(x.to(dev) for x in v[:5]) + (v[5],))
              for tag, v in saved.items()]
    for label, (A_, b_, v_, m_, l0, iters) in cases:
        lam = pgs.pgs_solve(A_, b_, v_, m_, l0, iters=iters)
        err = (lam - ref_pgs.pgs_solve_plain(A_, b_, v_, m_, l0, iters)).abs()
        out[f"K1 {label} err"] = err.max().item()

        def call():
            return pgs.pgs_solve(A_, b_, v_, m_, l0, iters=iters)

        out[f"K1 {label} ms"] = cs.device_ms(call, reps=50)
        out[f"K1 {label} call ms"] = cs.cuda_ms(call, reps=50)
    for asset in K2_SYSTEMS:
        sys_ = load_system(asset)
        args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
                cs.smooth_state(sys_, np.random.RandomState(cs.SEED), cs.E)]
        _, minv, vpred = fk_kernel.full_dyn(sys_, *args)
        _, minv_r, vpred_r = ref_fk.full_dyn_plain(
            cs.f32_constants(ref_load(asset)), *(a.double() for a in args))
        out[f"K2 {asset} minv err"] = (minv.double() - minv_r).abs().max().item()
        out[f"K2 {asset} v_pred err"] = (
            vpred.double() - vpred_r).abs().max().item()
        out[f"K2 {asset} kernel ms"] = cs.device_ms(
            lambda: fk_kernel.launch(sys_, *args), reps=50)
        out[f"K2 {asset} kernel call ms"] = cs.cuda_ms(
            lambda: fk_kernel.launch(sys_, *args), reps=50)
        out[f"K2 {asset} wrapper ms"] = cs.cuda_ms(
            lambda: fk_kernel.full_dyn(sys_, *args), reps=50)
    rng = np.random.RandomState(cs.SEED)
    for asset in ASSETS:
        sys_ = load_system(asset)
        for e in cs.FK_VEL_ENVS:
            qpos, qvel = (torch.tensor(x, dtype=torch.float32, device=dev)
                          for x in cs.smooth_state(sys_, rng, e)[:2])
            ref = ref_fk.fk_vel_plain(cs.f32_constants(ref_load(asset)),
                                      qpos.double(), qvel.double())
            out[f"K3 {asset} E{e} err"] = cs.fk_err(
                fk_kernel.fk_vel(sys_, qpos, qvel), ref)
            out[f"K3 {asset} E{e} ms"] = cs.device_ms(
                lambda: fk_kernel.launch_fk_vel(sys_, qpos, qvel), reps=50)
    out["env step ms"] = env_step_ms(envs, dev, cs)
    out["ok"] = all(v <= err_limit(cs, k) for k, v in out.items()
                    if k.endswith(" err"))
    return out


def err_limit(cs, key: str) -> float:
    """chip_smoke's tolerance for the error ``key`` of ``time_tree``."""
    if key.startswith("K1"):
        return cs.LAM_ATOL
    if key.startswith("K3"):
        return cs.FK_ATOL
    return cs.MINV_ATOL if "minv" in key else cs.VPRED_ATOL


def env_step_ms(envs, dev, cs, warmup=5, steps=30) -> float:
    """Host-clock ms per control step (5 substeps, K2 and K1 each) of
    2048 cheetahs under uniform random actions, after ``warmup`` steps."""
    env = envs.make("half_cheetah", device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    states = env.reset(gen, cs.E)
    low, high = env.action_limits()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        u = torch.rand(cs.E, env.act_dim, generator=gen, device=dev)
        states = env.step(states, low + (high - low) * u, gen)[0]
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other tree to compare")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels.py needs a CUDA card", file=sys.stderr)
        return 1
    if a.time_tree:
        r = time_tree(a.time_tree, a.inputs)
        print(json.dumps(r))
        return 0 if r["ok"] else 1
    if not a.parent:
        ap.error("--parent is required")

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.physics.rigid import dynamics as rdyn

    print(cs.card_line())
    from cadm_tpu_torch.ops import fk_kernel

    captured = cs.capture_main_path(envs, rdyn, fk_kernel,
                                    torch.device("cuda"))[0]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main_path_pgs.pt")
        torch.save({k: tuple(x.cpu() if torch.is_tensor(x) else x for x in v)
                    for k, v in captured.items()}, path)
        for tree in (a.parent, ROOT, ROOT, a.parent):
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-tree",
                 tree, "--inputs", path],
                capture_output=True, text=True)
            if p.returncode != 0:
                print(p.stdout, p.stderr, file=sys.stderr)
                raise RuntimeError(f"timing {tree} failed ({p.returncode})")
            runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]))
    for tree, name in ((a.parent, "parent"), (ROOT, "this")):
        mine = [r for r in runs if r["tree"] == tree]
        keys = [k for k in mine[0] if k.endswith(" ms")]
        print(name + ": " + ", ".join(
            f"{k} {np.mean([r[k] for r in mine]):.4f}" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
