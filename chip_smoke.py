#!/usr/bin/env python3
"""Drive the PyTorch port (``cadm_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each, any failure raising (exit code != 0):

1. the card's name and power limit; the nvcc build of the kernels;
2. K1 (PGS contact solve) against its plain PyTorch version on 2048 random
   SPD systems at nc 16 and 29, cold (15 sweeps) and warm-started (6);
3. K2 (fused smooth dynamics) against its plain version (run in float64)
   on all four rigid Systems at 2048 random states;
4. a toy-width slice (plan → env step, 3 control steps) on the card against
   the same slice on the CPU (plain versions), same weights/states/noise;
5. the full-width HalfCheetah CaDM + CEM control path
   (``halfcheetah_cadm_cem``: 2048 envs, 200 candidates × horizon 30 × 5 CEM
   iterations, 4×200 heads) for ``env_horizon`` control steps in each of the
   modes 0, 1, 2, with both kernels' launch counts checked against
   steps × frame_skip.

The last two lines are a JSON object describing the kernels and the JSON
contract line ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
E = 2048  # envs for the kernel checks (the preset's batch)
SLICE_HORIZON = 10  # control steps per eval mode in phase 5
# tolerances: λ 1e-4 (the reference's own for its PGS kernel); M⁻¹ 5e-5,
# v_pred 5e-4 (its fused-kernel tolerances); FK fields 1e-5
LAM_ATOL, MINV_ATOL, VPRED_ATOL, FK_ATOL = 1e-4, 5e-5, 5e-4, 1e-5
# toy slice, card vs CPU: float32 model rollouts and 5-substep physics in
# another summation order; measured differences are far below this
SLICE_ATOL = 1e-3
FK_FIELDS = ("body_pos", "body_rot", "com", "inertia_w", "dof_axis",
             "dof_anchor", "omega", "v_com", "alpha0", "a_com0")


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 2: K1 --
def check_pgs(pgs, dev, gen):
    results = []
    for nc in (16, 29):
        n = 3 * nc
        G = torch.randn(E, n, n, generator=gen, device=dev)
        A = G @ G.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
        b = torch.randn(E, n, generator=gen, device=dev)
        vstar = torch.randn(E, nc, generator=gen, device=dev).abs()
        pick = torch.randint(0, 3, (E, nc), generator=gen, device=dev)
        actmu = torch.tensor([0.0, 0.5, 1.0], device=dev)[pick]
        inactive = (actmu == 0).repeat_interleave(3, dim=1)
        warm0 = torch.randn(E, n, generator=gen, device=dev).abs() * ~inactive
        for tag, iters, lam0 in (("cold", 15, torch.zeros_like(b)),
                                 ("warm", 6, warm0)):
            lam = pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)
            ref = pgs.pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
            torch.cuda.synchronize()
            err = (lam - ref).abs().max().item()
            zero = bool((lam[inactive] == 0).all())
            ms = cuda_ms(lambda: pgs.pgs_solve(A, b, vstar, actmu, lam0,
                                               iters=iters), reps=20)
            plain_ms = cuda_ms(lambda: pgs.pgs_solve_plain(A, b, vstar, actmu,
                                                           lam0, iters), reps=2)
            print(f"K1 pgs nc={nc} {tag} iters={iters} E={E}: max_abs_err="
                  f"{err:.3e} inactive_zero={zero} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms")
            results.append(dict(nc=nc, tag=tag, err=err, zero=zero, ms=ms,
                                plain_ms=plain_ms))
    bad = [r for r in results if not (r["err"] <= LAM_ATOL and r["zero"])]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return results


# ------------------------------------------------------------- phase 3: K2 --
def smooth_state(sys_, rng, n):
    """Near-default poses, random velocities/controls/scales, one masked
    actuator per 16 envs."""
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (n, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    am = np.ones((n, sys_.nu))
    am[::16, 0] = 0.0
    return [qpos, rng.uniform(-1, 1, (n, sys_.nv)),
            rng.uniform(-1, 1, (n, sys_.nu)), rng.uniform(0.8, 1.2, n),
            rng.uniform(0.8, 1.2, n), am]


def check_full_dyn(fk_kernel, load_system, ASSETS, dev):
    """K2 against its plain version run in float64 on the same inputs.

    The kernel computes in double internally; the float32 plain version
    itself is up to 3.5e-4 off in M⁻¹ on slim_humanoid (cond(M) ≈ 3e3), so
    the float64 plain run is the reference the tolerances apply to. The
    float32 plain version's own errors are printed beside.
    """
    rng = np.random.RandomState(SEED)
    results = []

    def errs(out, ref):
        (fkv, minv, vpred), (fkv_r, minv_r, vpred_r) = out, ref
        return {
            "minv": (minv.double() - minv_r).abs().max().item(),
            "v_pred": (vpred.double() - vpred_r).abs().max().item(),
            "fk": max((getattr(fkv, f).double() - getattr(fkv_r, f)).abs()
                      .max().item() for f in FK_FIELDS),
        }

    for asset in ASSETS:
        sys_ = load_system(asset)
        args = [torch.tensor(x, dtype=torch.float32, device=dev)
                for x in smooth_state(sys_, rng, E)]
        out = fk_kernel.full_dyn(sys_, *args)
        ref = fk_kernel.full_dyn_plain(sys_, *(a.double() for a in args))
        e_kernel = errs(out, ref)
        e_plain32 = errs(fk_kernel.full_dyn_plain(sys_, *args), ref)
        ms = cuda_ms(lambda: fk_kernel.launch(sys_, *args), reps=20)
        wrapper_ms = cuda_ms(lambda: fk_kernel.full_dyn(sys_, *args), reps=20)
        plain_ms = cuda_ms(lambda: fk_kernel.full_dyn_plain(sys_, *args), reps=2)
        fmt = lambda e: " ".join(f"{k}={v:.3e}" for k, v in e.items())  # noqa: E731
        print(f"K2 full_dyn {asset} nv={sys_.nv} E={E}: kernel vs plain(f64) "
              f"{fmt(e_kernel)}; plain(f32) vs plain(f64) {fmt(e_plain32)}; "
              f"kernel {ms:.4f} ms, wrapper (+ derived rotations/inertias) "
              f"{wrapper_ms:.4f} ms, plain(f32) {plain_ms:.3f} ms")
        results.append(dict(asset=asset, errs=e_kernel, ms=ms,
                            plain_ms=plain_ms))
    bad = [r for r in results if not (
        r["errs"]["minv"] <= MINV_ATOL and r["errs"]["v_pred"] <= VPRED_ATOL
        and r["errs"]["fk"] <= FK_ATOL)]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version: {bad}")
    return results


# -------------------------------------------------- phase 4: toy slice ----
def run_toy_slice(cfg, device, dyn_cpu, start_cpu, noise, steps):
    """``steps`` control steps of plan → env step on ``device`` from CPU
    weights/states; returns the actions and observations of each step."""
    from cadm_tpu_torch.core.types import batched_history, tree_map

    env, model, planner, _ = cfg.build(device)
    to = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    dyn, states = to(dyn_cpu), to(start_cpu)
    gen = torch.Generator(device=device).manual_seed(SEED)
    hists = batched_history(model.cfg, cfg.eval_envs, env.device)
    out = []
    for t in range(steps):
        z = model.context_from_history(dyn.params, dyn.norm, hists)
        actions, _ = planner.plan(dyn, states.obs, z, gen,
                                  noise=noise[t].to(device))
        prev = states.obs
        states, obs, _, _ = env.step(states, actions, gen)
        hists = model.push_history(dyn.params, dyn.norm, hists, prev,
                                   obs - prev, actions)
        out.append((actions.cpu(), obs.cpu()))
    return out


def check_toy_slice(PRESETS):
    cfg = dataclasses.replace(
        PRESETS["halfcheetah_cadm_cem"], hidden=(32, 32), n_candidates=16,
        plan_horizon=5, cem_iters=2, cem_elites=4, n_envs=4, eval_envs=4,
    )
    env, model, _, _ = cfg.build("cpu")
    gen = torch.Generator().manual_seed(SEED)
    dyn = model.init_state(gen)
    start = env.reset(gen, cfg.eval_envs)
    steps = 3
    noise = torch.empty(steps, cfg.cem_iters, cfg.eval_envs, cfg.n_candidates,
                        cfg.plan_horizon, env.act_dim)
    torch.nn.init.trunc_normal_(noise, 0.0, 1.0, -2.0, 2.0, generator=gen)
    cpu = run_toy_slice(cfg, "cpu", dyn, start, noise, steps)
    gpu = run_toy_slice(cfg, "cuda", dyn, start, noise, steps)
    err_a = max((a - b).abs().max().item() for (a, _), (b, _) in zip(cpu, gpu))
    err_o = max((a - b).abs().max().item() for (_, a), (_, b) in zip(cpu, gpu))
    print(f"toy slice card vs cpu, {steps} control steps: max_abs_err actions "
          f"{err_a:.3e}, obs {err_o:.3e} (atol {SLICE_ATOL})")
    if not (err_a <= SLICE_ATOL and err_o <= SLICE_ATOL):
        raise AssertionError("toy slice on the card disagrees with the CPU")


# ------------------------------------------------ phase 5: full slice -----
def run_full_slice(PRESETS, pgs, fk_kernel):
    cfg = dataclasses.replace(PRESETS["halfcheetah_cadm_cem"], eval_envs=E,
                              env_horizon=SLICE_HORIZON)
    env, _, _, trainer = cfg.build("cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    _, _, dyn_state = trainer.init(gen)
    torch.cuda.synchronize()
    per_mode = env.horizon * env.frame_skip
    pgs.launches = fk_kernel.launches = 0
    step_ms = []
    for mode in cfg.eval_modes:
        before = (pgs.launches, fk_kernel.launches)
        t0 = time.perf_counter()
        returns = trainer.evaluate(dyn_state, mode, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = (pgs.launches - before[0], fk_kernel.launches - before[1])
        ms = 1e3 * dt / env.horizon
        step_ms.append(ms)
        print(f"slice mode {mode}: {E} envs x {env.horizon} control steps, "
              f"{ms:.1f} ms/control step, return mean "
              f"{returns.mean().item():.3f} std {returns.std().item():.3f}, "
              f"launches pgs={launched[0]} full_dyn={launched[1]} "
              f"(expected {per_mode} each)")
        if returns.shape != (E,) or not torch.isfinite(returns).all():
            raise AssertionError(f"mode {mode}: returns not finite/shape "
                                 f"{tuple(returns.shape)}")
        if launched != (per_mode, per_mode):
            raise AssertionError(f"mode {mode}: launches {launched} != "
                                 f"{per_mode} per kernel")
    return pgs.launches, fk_kernel.launches, step_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    # imported only once a card is known to exist
    from cadm_tpu_torch.cli.presets import PRESETS
    from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
    from cadm_tpu_torch.ops import _build, fk_kernel, pgs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: nvcc sm_90a -> {path} in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_pgs(pgs, dev, gen)
    k2 = check_full_dyn(fk_kernel, load_system, ASSETS, dev)
    check_toy_slice(PRESETS)
    n_pgs, n_fd, step_ms = run_full_slice(PRESETS, pgs, fk_kernel)

    k1_main = next(r for r in k1 if r["nc"] == 16 and r["tag"] == "cold")
    k2_main = next(r for r in k2 if r["asset"] == "half_cheetah")
    kernels = {"kernels": [
        {"name": "pgs_solve", "route": "cuda",
         "source": "cadm_tpu_torch/csrc/pgs.cu",
         "replaces": "cadm_tpu/ops/pgs.py:79", "launches": n_pgs,
         "max_abs_err": max(r["err"] for r in k1),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"]},
        {"name": "full_dyn", "route": "cuda",
         "source": "cadm_tpu_torch/csrc/full_dyn.cu",
         "replaces": "cadm_tpu/ops/fk_kernel.py:535", "launches": n_fd,
         "max_abs_err": max(max(r["errs"].values()) for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"]},
    ]}
    print(f"slice ms per control step (modes {list(PRESETS['halfcheetah_cadm_cem'].eval_modes)}): "
          f"{', '.join(f'{ms:.1f}' for ms in step_ms)}")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
