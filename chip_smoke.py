#!/usr/bin/env python3
"""Drive the PyTorch port (``cadm_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one or more lines each, any failure raising (exit code != 0):

1. the card's name and power limit; the nvcc build of the kernels;
2. K1 (PGS contact solve) against its plain PyTorch version on 2048 random
   SPD systems at nc 16 and 29, cold (15 sweeps) and warm-started (6), on
   16 × 2048 of them (a launch whose blocks share their shared-memory pool
   in rounds), and on each family's own main-path inputs: the (A, b, v*, μ,
   λ0) of one cold and one warm substep after 10 random-action control
   steps at its preset's batch (2048 cheetahs, 512 hoppers, 1024 ants and
   crippled ants, 512 humanoids), with the histogram of active contacts per
   env; K2 against its plain version (run in float64) on the same step's
   smooth-stage inputs, the crippled ants' per-env leg mask included;
3. K2 (fused smooth dynamics) against its plain version (run in float64)
   on all four rigid Systems at 2048 random states, every field of its row
   (body rotations and world inertias included), and a profiler count that
   one CUDA ``full_dyn`` call runs exactly one kernel and no other device op;
4. K3 (FK-velocity walk) against its plain version (run in float64 on the
   constants its table holds) on all four rigid Systems at 2048 and at
   65,536 random states, its rows bit for bit K2's first columns, with its
   device, launch and wrapper times, bound and share of it at each size,
   and a profiler count that one ``launch_fk_vel`` runs exactly one kernel
   and no other device op;
5. a toy-width slice (plan → env step, 3 control steps) on the card against
   the same slice on the CPU (plain versions), same weights/states/noise,
   for ``halfcheetah_cadm_cem``, for ``cripple_ant_cadm_ensemble_cem``
   (5 probabilistic members, TS1, the same block permutations on both) and
   for the cheetah's three baselines (stacked, ReBAL, GrBAL);
6. a toy-width fit of the same five, 20 model updates on the card against
   the same 20 on the CPU: same starting weights, same segment batches;
   and ``hopper_ppo_cadm`` at toy width (heads 16×16, policy 8×8, 4 envs,
   rollout 8) on the card against the CPU: one collect, one PPO update,
   one fit and one eval step from the same start states, weights, ε,
   permutations and segment indices;
7. the training path at full width through the CLI
   (``cadm_tpu_torch.cli.run.main``), cut in depth only: 2 iterations
   (random collect, then planned) of 20 control steps, 10-step episodes, for
   ``halfcheetah_cadm_cem`` (2048 envs, 4×200 heads, a 20000-column ring,
   batch 256, CEM 200×30×5), ``cripple_ant_cadm_ensemble_cem`` (1024
   envs, 5 members, the same ring, batch and CEM, TS1), the cheetah's
   stacked, ReBAL and GrBAL at the result matrix's configuration (256 envs,
   CEM 256×30×5 warm-started, an 8000-column ring, batch 256, eval 32 envs
   every 3 iterations; GrBAL's net 3×200) and the analytic presets
   ``cartpole_vanilla_rs`` (8 envs, RS 500×20, the fixed fit) and
   ``pendulum_cadm_cem`` (8 envs, CEM 200×20×5). Checks the log, the fit
   metrics (``logvar_bound_penalty`` of the ensemble included; GrBAL's valid
   MSE NaN, as the reference's), the episode counts and K1/K2 launches =
   frame_skip × every control step (0 on the analytic envs). Then PPO +
   CaDM: ``hopper_ppo_cadm`` and ``slim_humanoid_ppo_cadm`` at the presets'
   width (128 envs, rollout 256, policy 64×64, heads 4×200, model batch
   256, a 4096-column ring, eval 16 envs), 2 iterations of 100-step
   episodes: the PPO row, finite ``ppo/`` and ``fit/`` values, ``updates`` =
   itr × epochs × minibatches, K1/K2 launches = frame_skip × (collect +
   eval steps);
8. resume: the matrix's cheetah CaDM for 3 iterations with ``--checkpoint``,
   then ``--resume`` from step 1 in a new process state (trainer,
   generator): its itr 2 row equals the uninterrupted run's bit for bit;
   the checkpoint's size and save/restore seconds; the same for
   ``hopper_ppo_cadm`` at the width of phase 7;
9. the trajectory dump: one iteration of the same with ``--dump-trajs``;
   ``read_trajfile`` gives back itr0/obs|act|next_obs equal to the ring's
   columns, 0 records dropped;
10. the acting path at full width (``trainer.evaluate``) for
   ``SLICE_HORIZON`` control steps in each of the modes 0, 1, 2: cheetah at
   2048 envs, slim_humanoid and hopper at 512, with both kernels' launch
   counts checked against steps × frame_skip;
11. the mesh (``cadm_tpu_torch/parallel``), ranks under
   ``torch.multiprocessing`` (spawn) through ``cli.run.main(argv, mesh)``:
   (a) the toy cheetah of phases 5/6 with 2 members, 3 iterations, on a
   dp=2 × model=2 mesh (4 ranks sharing the card, gloo) and on dp=2, and the
   toy hopper PPO at dp=2, against the same runs without a mesh: rows
   within SLICE_ATOL (collect/eval) and FIT_LOSS_RTOL (losses), final
   weights within FIT_ATOL; (b) the toy cheetah on an nccl group of world
   size 1, bit for bit; (c) phase 7's 2048-env cheetah at dp=2 (1024 envs a
   rank, both on the card): per rank the random-collect env steps/s, ms per
   planned step, fit updates/s and peak memory (the ranks share one card:
   not scaling numbers), the phase-7 columns finite, and the gather a
   checkpoint of that run makes (each rank's 20000-column ring gathered
   over dp): its seconds, the device memory it adds and the host copy's
   seconds; (d) the dp=2 × model=2 checkpoint of iteration 1 resumed
   without a mesh, its iteration 2 against the uninterrupted sharded run's;
   (e) nccl with a card per rank where there are two cards (else a line
   says it did not run); (f) ``dryrun_multichip(4)`` on the card (4 ranks
   sharing it), a finite loss alike on every rank. Every rank's K1/K2
   launches = frame_skip × its control steps.

12. the result-matrix runner (``cadm_tpu_torch.cli.matrix.main``) on
   ``half_cheetah cadm s0`` at full width (256 envs, CEM 256 × 30 × 5
   warm-started, heads 4×200, an 8000-column ring, eval 32 envs), cut in
   depth only through a copy of its table (TRAIN_DEPTH), its output in a
   temporary directory: the cell JSON has the keys of the reference's
   record (``results/raw/half_cheetah__cadm__s1.json``, read as data) plus
   ``code_version``, ``loss_variant`` and ``card``, its history columns and
   config are the record's (bar the seed, the cut and
   ``max_parallel_rollouts``), every value finite; K1/K2 launches =
   frame_skip × control steps; a second ``main`` skips the done cell with 0
   launches; ``cli.results.render`` gives the cell's row. Prints the full
   cell's planned and eval steps' time at the measured rates.
13. the snapshot analyses (``cadm_tpu_torch.analysis``) on phase 12's
   snapshot at the cell's full width: probe_context with the planner (one
   round of 12 steps at 256 envs) and with the random policy on mode 1,
   probe_hstep at H 30 over 32 envs, probe_blowup with the cell's 256
   candidates over 8 start states, probe_dist with the snapshot as
   generator and eval cell at 8 envs (40 + 40 steps), probe_ranges on the
   cheetah (the random policy at the full 1000-step horizon and the
   planner through the snapshot for 10 steps, 16 envs, 5 scales), ab_ts1
   cut to 300 updates and closed loops of 50 steps, probe_epochs on
   ``results/raw`` and ``results/torch/raw``: each record has the keys of
   the reference's (its JSON under ``results/``), finite values and
   fractions in [0, 1]; K1/K2 launches = frame_skip × each probe's env
   control steps (0 for ab_ts1 and probe_epochs); each probe's wall time.

Each path of phases 7–13 sets the launch counts to 0 before it runs and
reads them after (in its rank's process on a mesh).

``python3 chip_smoke.py --only mesh`` (``--only matrix``) runs phase 1 and
phase 11 (12) alone, ``--only probes`` phases 1, 12 and 13, and prints each
path's launches (no JSON lines).

The last three lines are a JSON object describing the kernels (with each
kernel's bound: the least time the card could take for the same work), the
card's name and power limit, and the JSON contract line
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
E = 2048  # envs for the kernel checks (the preset's batch)
FK_VEL_ENVS = (E, 65536)  # K3's random states: the preset batch, and one
# large enough that the bytes, not the launch, set its bound
SLICE_HORIZON = 3  # control steps per eval mode in phase 10
# tolerances: λ 1e-4 (the reference's own for its PGS kernel); M⁻¹ 5e-5,
# v_pred 5e-4 (its fused-kernel tolerances); FK fields 1e-5
LAM_ATOL, MINV_ATOL, VPRED_ATOL, FK_ATOL = 1e-4, 5e-5, 5e-4, 1e-5
# on a main path the FK fields also get one float32 ulp of |ref|: the
# kernel's float32 rows round a body acceleration of up to ~450 (humanoid)
# by up to 2^-24·|value| ≈ 3e-5 however exactly it computes
F32_EPS = 2.0 ** -23
# toy slice, card vs CPU: float32 model rollouts and 5-substep physics in
# another summation order; measured differences are far below this
SLICE_ATOL = 1e-3
# toy fit, card vs CPU: float32 losses and gradients summed in another order
# (cuBLAS vs the CPU's BLAS) differ by ~1e-6 relative; Adam moves each
# weight by at most lr = 1e-3 per update and divides the gradient by its own
# RMS, so 20 updates keep weights within 1e-4 unless a gradient entry sits
# at rounding level, and losses within 1e-4 relative
FIT_STEPS, FIT_ATOL, FIT_LOSS_RTOL = 20, 1e-4, 1e-4
FK_FIELDS = ("body_pos", "body_rot", "com", "inertia_w", "dof_axis",
             "dof_anchor", "omega", "v_com", "alpha0", "a_com0")
# the reference trainer's CSV row (its jitted dicts come back key-sorted)
TRAIN_KEYS = [
    "itr",
    "collect/bad_transition_frac", "collect/episodes",
    "collect/mean_episode_return", "collect/mean_step_reward",
    "fit/epochs_run", "fit/model_loss_first", "fit/model_loss_last",
    "fit/model_loss_mean", "fit/valid_fwd_mse_after", "fit/valid_loss_after",
    "fit/valid_loss_before", "fit/valid_monitored_best",
    "eval/return_mode0", "eval/return_mode0_std",
    "eval/return_mode1", "eval/return_mode1_std",
    "eval/return_mode2", "eval/return_mode2_std",
]
# the fixed fit's row (cartpole_vanilla_rs)
FIXED_TRAIN_KEYS = [k for k in TRAIN_KEYS if k not in (
    "fit/epochs_run", "fit/valid_monitored_best")]
TRAIN_DEPTH = ["--n-itr", "2", "--steps-per-itr", "20", "--env-horizon", "10"]
# the reference PPO trainer's row (cadm_tpu/train/ppo.py:421-440)
PPO_KEYS = [
    "itr", "collect/mean_episode_return", "collect/episodes",
    "collect/rollout_reward_per_env", "ppo/loss_first", "ppo/loss_last",
    "fit/model_loss_last", "fit/valid_loss",
    "eval/return_mode0", "eval/return_mode0_std",
    "eval/return_mode1", "eval/return_mode1_std",
    "eval/return_mode2", "eval/return_mode2_std",
]
PPO_DEPTH = ["--n-itr", "2", "--env-horizon", "100"]
# The cheetah's row of the result matrix (RESULTS.md:14-19) comes from
# `cli.matrix`'s copy of the reference's tables (`matrix_argv`). The model
# widths are the defaults: heads 4×200 (GrBAL's net hidden[:3]), z 10,
# rnn_hidden 64, K 10.
BASELINES = ("stacked", "rebal", "grbal")
# each System's main path and the batch its preset runs: K1's and K2's
# inputs are captured there (phase 2)
MAIN_PATH_SYSTEMS = (("half_cheetah", 2048), ("hopper", 512), ("ant", 1024),
                     ("cripple_ant", 1024), ("slim_humanoid", 512))
# the training paths (phase 7) and the acting paths with their env counts
# (phase 10); phases 5 and 6 run the training presets at toy width
TRAIN_PRESETS = ("halfcheetah_cadm_cem", "cripple_ant_cadm_ensemble_cem")
ANALYTIC_PRESETS = ("cartpole_vanilla_rs", "pendulum_cadm_cem")
PPO_PRESETS = ("hopper_ppo_cadm", "slim_humanoid_ppo_cadm")
ACT_PRESETS = (("halfcheetah_cadm_cem", 2048), ("slim_humanoid_cadm_cem", 512),
               ("hopper_cadm_cem", 512))
ROOT = os.path.dirname(os.path.abspath(__file__))
AB_TS1_STEPS = 300  # ab_ts1's ensemble updates in phase 13 (3000 by default)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 and FP64 FLOP/s
# outside the tensor cores
HBM_BPS, FP32_FLOPS, FP64_FLOPS = 3.35e12, 67e12, 34e12


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


def device_ops(fn, reps: int = 1):
    """[(name, count, device µs)] of every device-side op (kernels, copies,
    sets) that ``reps`` warmed-up calls of ``fn`` run, from
    ``torch.profiler`` (CUPTI durations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps: int = 20, profiles: int = 5) -> float:
    """Mean device time in ms of one call of ``fn``, which runs one device
    op: unlike ``cuda_ms`` it leaves out the gaps while the host launches.
    The profiler may drop some of a profile's events (up to half of them on
    some H100 hosts), so the mean is taken over the launches it did record,
    and profiles are added until ``reps`` launches are recorded or
    ``profiles`` were taken. If none recorded any, the CUDA-event time of
    back-to-back calls stands in, and a line says so."""
    names, seen, total_us = set(), 0, 0.0
    for _ in range(profiles):
        for name, n, t in device_ops(fn, reps):
            names.add(name)
            seen += n
            total_us += t
        if seen >= reps:
            break
    if len(names) > 1:
        raise AssertionError(f"one call ran more than one kind of device op: "
                             f"{sorted(names)}")
    if seen == 0:
        print(f"torch.profiler recorded no device op in {profiles} profiles "
              f"of {reps} calls: timing back-to-back calls with CUDA events")
        return cuda_ms(fn, reps)
    return total_us / seen / 1e3


def only_kernel(fn, kernel: str, what: str, reps: int = 10):
    """Check that each call of ``fn`` runs one device op, the kernel
    ``kernel``: a profile of ``reps`` calls records that kernel and nothing
    else, at most ``reps`` times (the profiler may drop events, so fewer is
    allowed). A profile that recorded no op at all is taken again, up to 5
    times."""
    for _ in range(5):
        ops = [(name, n) for name, n, _ in device_ops(fn, reps)]
        if ops:
            break
    print(f"{what} ({reps} calls): {ops}")
    if (len(ops) != 1 or kernel not in ops[0][0]
            or not 1 <= ops[0][1] <= reps):
        raise AssertionError(f"{what} ran {ops}, not one {kernel} a call")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------- operation counts --
# Arithmetic of the kernels per env, counted from their loops (csrc/*.cu):
# one per add, multiply, divide, sqrt or sincos; V3 add/sub/scale 3, dot 5,
# cross 9, quaternion product 28, quaternion rotation 38, symmetric 3×3
# times vector 15.
def fk_ops(sys_) -> int:
    """FK + velocity walk and the nine output fields (K3, K2's first part)."""
    per_joint = {0: 164, 2: 103, 3: 275}  # FREE, SLIDE, HINGE
    walk = 114 * (sys_.nb - 1) + sum(per_joint[int(t)] for t in sys_.jnt_type)
    return walk + 86 * sys_.nb


def full_dyn_ops(sys_) -> int:
    """K2: the walk, then inertias, bias, τ, mass matrix, Cholesky, L⁻¹,
    M⁻¹ and v_pred."""
    from cadm_tpu_torch.physics.rigid import kinematics

    nv, mask = sys_.nv, sys_.ancestry_mask()
    rot = kinematics._dof_is_rot(sys_)
    ops = fk_ops(sys_) + 190 * sys_.nb + 5 * sys_.nu + 11 * sys_.nj
    for d in range(nv):
        ops += 3 + int(mask[:, d].sum()) * (24 if rot[d] else 12)
        for e in range(d + 1):
            common = int((mask[:, d] * mask[:, e]).sum())
            ops += common * (8 + 12 * (rot[d] + rot[e]) + 21 * (rot[d] and rot[e]))
    for j in range(nv):  # Cholesky, L⁻¹
        ops += 2 * j + 2 + (nv - j - 1) * (2 * j + 1)
        ops += 1 + sum(2 * (i - j) + 1 for i in range(j + 1, nv))
    for a in range(nv):  # M⁻¹ = L⁻ᵀL⁻¹ and M⁻¹τ
        ops += 3 + sum(2 * (nv - b) + 2 + 2 * (b != a) for b in range(a, nv))
    return ops


def pgs_ops(nc: int, iters: int) -> int:
    """K1: per sweep and contact three row dots of 3nc and ~20 scalar ops."""
    return iters * nc * (3 * 2 * 3 * nc + 20)


# ------------------------------------------------------------- phase 2: K1 --
def pgs_inputs(nc, dev, gen, e=E):
    """Random SPD Delassus systems, a third of the contacts inactive:
    (A, b, v*, μ, warm-start λ0 that is zero on the inactive contacts)."""
    n = 3 * nc
    G = torch.randn(e, n, n, generator=gen, device=dev)
    A = G @ G.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
    b = torch.randn(e, n, generator=gen, device=dev)
    vstar = torch.randn(e, nc, generator=gen, device=dev).abs()
    pick = torch.randint(0, 3, (e, nc), generator=gen, device=dev)
    actmu = torch.tensor([0.0, 0.5, 1.0], device=dev)[pick]
    inactive = (actmu == 0).repeat_interleave(3, dim=1)
    warm0 = torch.randn(e, n, generator=gen, device=dev).abs() * ~inactive
    return A, b, vstar, actmu, warm0


def pgs_case(pgs, label, A, b, vstar, actmu, lam0, iters, timed=True):
    """K1 against its plain version on one problem; times both if asked.
    The bound counts the function's bytes and operations at the full nc,
    whatever the kernel skips."""
    e, nc = vstar.shape
    n = 3 * nc
    inactive = (actmu <= 0).repeat_interleave(3, dim=1)
    lam = pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)
    ref = pgs.pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
    torch.cuda.synchronize()
    err = (lam - ref).abs().max().item()
    zero = bool((lam[inactive] == 0).all())
    r = dict(label=label, nc=nc, iters=iters, err=err, zero=zero)
    msg = ""
    if timed:
        def call():
            return pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)

        r["ms"] = device_ms(call)
        r["call_ms"] = cuda_ms(call, reps=20)
        r["plain_ms"] = cuda_ms(lambda: pgs.pgs_solve_plain(
            A, b, vstar, actmu, lam0, iters), reps=2)
        # A, b, v*, μ, λ0 read once, λ written once
        r["bound_ms"], r["bound_by"] = bound(
            4 * e * (n * n + 3 * n + 2 * nc), e * pgs_ops(nc, iters),
            FP32_FLOPS)
        msg = (f" kernel {r['ms']:.4f} ms (device), {r['call_ms']:.4f} ms a "
               f"call back to back, plain {r['plain_ms']:.3f} ms, bound "
               f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"K1 pgs {label} nc={nc} iters={iters} E={e}: max_abs_err="
          f"{err:.3e} inactive_zero={zero}{msg}")
    return r


def check_pgs(pgs, dev, gen):
    results = []
    for nc in (16, 29):
        A, b, vstar, actmu, warm0 = pgs_inputs(nc, dev, gen)
        for tag, iters, lam0 in (("cold", 15, torch.zeros_like(b)),
                                 ("warm", 6, warm0)):
            results.append(dict(pgs_case(pgs, tag, A, b, vstar, actmu, lam0,
                                         iters), tag=tag))
    # 16 × 2048 envs: the launch shrinks each block's pool to one env's worst
    # case, so a block's envs take turns
    A, b, vstar, actmu, _ = pgs_inputs(16, dev, gen, e=16 * E)
    results.append(dict(pgs_case(pgs, "pool-rounds cold", A, b, vstar, actmu,
                                 torch.zeros_like(b), 15, timed=False),
                        tag="rounds"))
    bad = [r for r in results if not (r["err"] <= LAM_ATOL and r["zero"])]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return results


def capture_main_path(envs, rdyn, fk_kernel, dev, name="half_cheetah",
                      n=E, steps=10):
    """K1's and K2's inputs on a family's main path: ``n`` envs (its preset's
    batch) take ``steps`` random-action control steps so that they reach
    the ground; of the next step, the first two solves (cold, then warm) and
    the first smooth-stage call are kept."""
    env = envs.make(name, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = env.reset(gen, n)
    low, high = env.action_limits()

    def act():
        u = torch.rand(n, env.act_dim, generator=gen, device=dev)
        return low + (high - low) * u

    for _ in range(steps):
        states = env.step(states, act(), gen)[0]
    captured, smooth = [], []
    solve, full_dyn = rdyn.pgs_solve, fk_kernel.full_dyn

    def keep(A, b, vstar, actmu, lam0, *, iters):
        if len(captured) < 2:
            captured.append(tuple(x.clone() for x in (A, b, vstar, actmu, lam0))
                            + (iters,))
        return solve(A, b, vstar, actmu, lam0, iters=iters)

    def keep_smooth(sys_, *args):
        if not smooth:
            smooth.append((sys_,) + tuple(x.clone() for x in args))
        return full_dyn(sys_, *args)

    rdyn.pgs_solve, fk_kernel.full_dyn = keep, keep_smooth
    try:
        env.step(states, act(), gen)
    finally:
        rdyn.pgs_solve, fk_kernel.full_dyn = solve, full_dyn
    torch.cuda.synchronize()
    return dict(zip(("cold", "warm"), captured)), smooth[0]


def check_pgs_main_path(pgs, captured, system="half_cheetah"):
    """K1 on a main path's own inputs, with the histogram of active
    contacts per env."""
    results = []
    for tag, (A, b, vstar, actmu, lam0, iters) in captured.items():
        na = (actmu > 0).sum(1)
        hist = torch.bincount(na, minlength=vstar.shape[1] + 1).tolist()
        print(f"K1 main path {system} {tag}: active contacts per env (count "
              f"of envs with 0, 1, ... {vstar.shape[1]}): {hist}; mean "
              f"{na.float().mean().item():.3f}")
        results.append(dict(pgs_case(pgs, f"main-path {system} {tag}", A, b,
                                     vstar, actmu, lam0, iters),
                            tag=tag, hist=hist, system=system))
    bad = [r for r in results if not (r["err"] <= LAM_ATOL and r["zero"])]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version on the "
                             f"main path's inputs: {bad}")
    return results


def check_full_dyn_main_path(fk_kernel, smooth, system):
    """K2 on a main path's own smooth-stage inputs (CrippleAnt's per-env
    leg mask included)."""
    sys_, *args = smooth
    r = full_dyn_case(fk_kernel, sys_, args, f"main-path {system}",
                      fk_rtol=F32_EPS)
    if not full_dyn_ok(r):
        raise AssertionError(f"K2 disagrees with its plain version on the "
                             f"main path's inputs: {r}")
    return dict(r, system=system)


# ------------------------------------------------------------- phase 3: K2 --
def full_dyn_case(fk_kernel, sys_, args, label, fk_rtol=0.0):
    """K2 against its plain version run in float64 on one batch of
    smooth-stage inputs; times the kernel, its wrapper and the float32
    plain version, and works out the bound.

    The kernel computes in double internally; the float32 plain version
    itself is up to 3.5e-4 off in M⁻¹ on slim_humanoid (cond(M) ≈ 3e3), so
    the float64 plain run is the reference the tolerances apply to. It runs
    on the constants the kernel's table holds (``f32_constants``). The
    float32 plain version's own errors are printed beside. ``fk_over`` is
    the FK fields' largest |err| − fk_rtol·|ref|, held to FK_ATOL.
    """
    def errs(out, ref):
        (fkv, minv, vpred), (fkv_r, minv_r, vpred_r) = out, ref
        return {
            "minv": (minv.double() - minv_r).abs().max().item(),
            "v_pred": (vpred.double() - vpred_r).abs().max().item(),
            "fk": fk_err(fkv, fkv_r),
            "fk_over": fk_err(fkv, fkv_r, fk_rtol),
        }

    e = args[0].shape[0]
    ref = fk_kernel.full_dyn_plain(f32_constants(sys_),
                                   *(a.double() for a in args))
    e_kernel = errs(fk_kernel.full_dyn(sys_, *args), ref)
    e_plain32 = errs(fk_kernel.full_dyn_plain(sys_, *args), ref)
    ms = device_ms(lambda: fk_kernel.launch(sys_, *args))
    call_ms = cuda_ms(lambda: fk_kernel.launch(sys_, *args), reps=20)
    wrapper_ms = cuda_ms(lambda: fk_kernel.full_dyn(sys_, *args), reps=20)
    plain_ms = cuda_ms(lambda: fk_kernel.full_dyn_plain(sys_, *args), reps=2)
    # qpos, qvel, ctrl, the two scales and act_mask read once, the row
    # written once
    n_in = sys_.nq + sys_.nv + 2 * sys_.nu + 2
    bound_ms, bound_by = bound(4 * e * (n_in + fk_kernel.row_layout(sys_)[1]),
                               e * full_dyn_ops(sys_), FP64_FLOPS)
    masked = int((args[5] == 0).any(1).sum())
    fmt = lambda x: " ".join(f"{k}={v:.3e}" for k, v in x.items())  # noqa: E731
    print(f"K2 full_dyn {label} nv={sys_.nv} E={e} ({masked} envs with a "
          f"masked actuator): kernel vs plain(f64) {fmt(e_kernel)}; "
          f"plain(f32) vs plain(f64) {fmt(e_plain32)}; kernel {ms:.4f} ms "
          f"(device), {call_ms:.4f} ms a launch back to back, wrapper "
          f"{wrapper_ms:.4f} ms, plain(f32) {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return dict(label=label, errs=e_kernel, err=max(
                    e_kernel[k] for k in ("minv", "v_pred", "fk")), ms=ms,
                call_ms=call_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def f32_constants(sys_):
    """The System with its float constants rounded to float32, as K2's
    device table (and the reference's float32 System) holds them: on a
    humanoid's main path the rounding alone moves a_com0 by ~1.3e-4."""
    return dataclasses.replace(sys_, **{
        f.name: np.asarray(v, np.float32).astype(np.float64)
        if isinstance(v, np.ndarray) else float(np.float32(v))
        for f in dataclasses.fields(sys_)
        for v in [getattr(sys_, f.name)]
        if isinstance(v, float) or (isinstance(v, np.ndarray)
                                    and v.dtype == np.float64)})


def full_dyn_ok(r) -> bool:
    return (r["errs"]["minv"] <= MINV_ATOL and r["errs"]["v_pred"] <= VPRED_ATOL
            and r["errs"]["fk_over"] <= FK_ATOL)


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


def fk_err(fkv, fkv_ref, rtol: float = 0.0) -> float:
    """Largest |err| − rtol·|ref| over the FK fields."""
    return max((getattr(fkv, f).double() - getattr(fkv_ref, f)).abs()
               .sub(rtol * getattr(fkv_ref, f).abs()).max().item()
               for f in FK_FIELDS)


def check_full_dyn(fk_kernel, load_system, ASSETS, dev):
    """K2 against its plain version run in float64 (``full_dyn_case``) on
    all four Systems at E random states, and a profiler count that one CUDA
    ``full_dyn`` call runs exactly one kernel and no other device op."""
    rng = np.random.RandomState(SEED)
    results = []
    for asset in ASSETS:
        sys_ = load_system(asset)
        args = [torch.tensor(x, dtype=torch.float32, device=dev)
                for x in smooth_state(sys_, rng, E)]
        r = full_dyn_case(fk_kernel, sys_, args, asset)
        only_kernel(lambda: fk_kernel.full_dyn(sys_, *args), "full_dyn_kernel",
                    f"K2 full_dyn {asset}: device ops of one full_dyn call")
        results.append(dict(r, asset=asset))
    bad = [r for r in results if not full_dyn_ok(r)]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version: {bad}")
    return results


# ------------------------------------------------------------- phase 4: K3 --
def check_fk_vel(fk_kernel, load_system, ASSETS, dev):
    """K3 against its plain version run in float64 on the constants its
    table holds (``f32_constants``), on every System at each of
    FK_VEL_ENVS random states: every field, and quat_to_mat(quat) against
    body_rot; its rows against K2's first ``fk_width`` columns on the same
    states, bit for bit; a profiler count that one ``launch_fk_vel`` runs
    exactly one device op, ``fk_vel_kernel``."""
    from cadm_tpu_torch.physics.rigid.math3d import quat_to_mat

    rng = np.random.RandomState(SEED)
    results = []
    for asset in ASSETS:
        sys_ = load_system(asset)
        ref_sys = f32_constants(sys_)
        for e in FK_VEL_ENVS:
            qpos, qvel = (torch.tensor(x, dtype=torch.float32, device=dev)
                          for x in smooth_state(sys_, rng, e)[:2])
            ref = fk_kernel.fk_vel_plain(ref_sys, qpos.double(), qvel.double())
            err = fk_err(fk_kernel.fk_vel(sys_, qpos, qvel), ref)
            rows = fk_kernel.launch_fk_vel(sys_, qpos, qvel)
            off, nb, _ = fk_kernel.row_layout(sys_)[0]["quat"]
            rot = quat_to_mat(rows[:, off: off + 4 * nb].view(e, nb, 4))
            err_rot = (rot.double() - ref.body_rot).abs().max().item()
            # K2's first fk_width columns come from the same per-body code
            ones, u = torch.ones(e, device=dev), torch.ones(e, sys_.nu,
                                                            device=dev)
            k2_rows = fk_kernel.launch(sys_, qpos, qvel, torch.zeros_like(u),
                                       ones, ones, u)
            same = torch.equal(k2_rows[:, : rows.shape[1]], rows)

            def launch():
                return fk_kernel.launch_fk_vel(sys_, qpos, qvel)

            ms = device_ms(launch)
            call_ms = cuda_ms(launch, reps=20)
            wrapper_ms = cuda_ms(lambda: fk_kernel.fk_vel(sys_, qpos, qvel),
                                 reps=20)
            plain_ms = cuda_ms(lambda: fk_kernel.fk_vel_plain(sys_, qpos, qvel),
                               reps=2)
            bound_ms, bound_by = bound(
                4 * e * (sys_.nq + sys_.nv + fk_kernel.fk_width(sys_)),
                e * fk_ops(sys_), FP64_FLOPS)
            print(f"K3 fk_vel {asset} nb={sys_.nb} nv={sys_.nv} E={e}: kernel "
                  f"vs plain(f64) fields {err:.3e}, quat_to_mat(quat) vs "
                  f"body_rot {err_rot:.3e}, rows bit for bit K2's {same}; "
                  f"kernel {ms:.4f} ms (device), "
                  f"{call_ms:.4f} ms a launch back to back, wrapper (+ "
                  f"derived rotations/inertias) {wrapper_ms:.4f} ms, "
                  f"plain(f32) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.1f} % of it")
            results.append(dict(asset=asset, e=e, err=max(err, err_rot),
                                same=same, ms=ms, call_ms=call_ms,
                                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                share=bound_ms / ms))
        only_kernel(launch, "fk_vel_kernel",
                    f"K3 fk_vel {asset}: device ops of one launch_fk_vel")
    bad = [r for r in results if not (r["err"] <= FK_ATOL and r["same"])]
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version or with "
                             f"K2's rows: {bad}")
    return results


# -------------------------------------------------- phase 5: toy slice ----
def run_toy_slice(cfg, device, dyn_cpu, start_cpu, noise, members, steps):
    """``steps`` control steps of plan → env step on ``device`` from CPU
    weights/states, the planner's ε and member draws given; returns the
    actions and observations of each step."""
    from cadm_tpu_torch.core.types import batched_history, tree_map

    env, model, planner, _ = cfg.build(device)
    to = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    dyn, states = to(dyn_cpu), to(start_cpu)
    gen = torch.Generator(device=device).manual_seed(SEED)
    hists = batched_history(model.cfg, cfg.eval_envs, env.device)
    out = []
    for t in range(steps):
        z = model.context_from_history(dyn.params, dyn.norm, hists)
        actions, _ = planner.plan(
            dyn, states.obs, z, gen, noise=noise[t].to(device),
            members=None if members is None else members[t].to(device))
        prev = states.obs
        states, obs, _, _ = env.step(states, actions, gen)
        hists = model.push_history(dyn.params, dyn.norm, hists, prev,
                                   obs - prev, actions)
        out.append((actions.cpu(), obs.cpu()))
    return out


TOY = dict(hidden=(32, 32), n_candidates=16, plan_horizon=5, cem_iters=2,
           cem_elites=4, n_envs=4, eval_envs=4)


def check_toy_slice(PRESETS, preset="halfcheetah_cadm_cem", **override):
    """The toy slice on the card against the CPU: same weights, states, CEM
    ε and (for an ensemble) the same TS1 block permutations. ``override``
    replaces config fields (e.g. ``model``)."""
    cfg = dataclasses.replace(PRESETS[preset], **TOY, **override)
    env, model, planner, _ = cfg.build("cpu")
    gen = torch.Generator().manual_seed(SEED)
    dyn = model.init_state(gen)
    start = env.reset(gen, cfg.eval_envs)
    steps = 3
    noise = torch.empty(steps, cfg.cem_iters, cfg.eval_envs, cfg.n_candidates,
                        cfg.plan_horizon, env.act_dim)
    torch.nn.init.trunc_normal_(noise, 0.0, 1.0, -2.0, 2.0, generator=gen)
    members = None
    if model.cfg.n_members > 1:
        members = torch.stack([torch.stack([
            planner.member_draws(gen, cfg.eval_envs, cfg.n_candidates)
            for _ in range(cfg.cem_iters)]) for _ in range(steps)])
    cpu = run_toy_slice(cfg, "cpu", dyn, start, noise, members, steps)
    gpu = run_toy_slice(cfg, "cuda", dyn, start, noise, members, steps)
    err_a = max((a - b).abs().max().item() for (a, _), (b, _) in zip(cpu, gpu))
    err_o = max((a - b).abs().max().item() for (_, a), (_, b) in zip(cpu, gpu))
    print(f"toy slice {preset} ({cfg.env}, model {cfg.model}, "
          f"{model.cfg.n_members} member(s), "
          f"{cfg.ensemble_eval}) card vs cpu, {steps} control steps: "
          f"max_abs_err actions {err_a:.3e}, obs {err_o:.3e} (atol "
          f"{SLICE_ATOL})")
    if not (err_a <= SLICE_ATOL and err_o <= SLICE_ATOL):
        raise AssertionError(f"toy slice {preset} {cfg.model} on the card "
                             f"disagrees with the CPU")


# ---------------------------------------------------- phase 6: toy fit ----
def check_toy_fit(PRESETS, preset="halfcheetah_cadm_cem",
                  devices=("cpu", "cuda"), **override):
    """20 updates on the card against the same 20 on the CPU.

    A random collect on the CPU fills a toy ring; 20 train minibatches'
    indices are drawn once there. Each device gets a copy of the ring and of
    the starting weights, refreshes the norm statistics and takes the 20
    updates on the segments those indices gather. ``override`` replaces
    config fields (e.g. ``model``).
    """
    from cadm_tpu_torch.core.types import tree_leaves, tree_map

    cfg = dataclasses.replace(PRESETS[preset], **TOY, batch_size=16,
                              buffer_capacity=64, steps_per_itr=40,
                              **override)
    _, _, _, trainer = cfg.build("cpu")
    gen = torch.Generator().manual_seed(SEED)
    states, hists, buf, dyn = trainer.init(gen)
    buf = trainer._collect(gen, states, hists, buf, dyn, True)[2]
    idx = [trainer._draw(buf, gen, "train") for _ in range(FIT_STEPS)]
    runs = []
    for device in devices:
        _, _, _, tr = cfg.build(device)
        to = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        ring = dataclasses.replace(buf, **{
            f: getattr(buf, f).to(device)
            for f in ("obs", "act", "next_obs", "done", "ep_step", "bad")})
        st = tr._refresh_norm(ring, to(dyn))
        losses = []
        for i in idx:
            st, m = tr.model.update(st, tr._sample(ring, to(i)))
            losses.append(m["model_loss"].item())
            if not all(math.isfinite(v.item()) for v in m.values()):
                raise AssertionError(f"toy fit {preset}: metrics {m}")
        runs.append((tree_leaves(st.params), np.asarray(losses)))
    (p_cpu, l_cpu), (p_gpu, l_gpu) = runs
    err_p = max((a - b.cpu()).abs().max().item() for a, b in zip(p_cpu, p_gpu))
    err_l = float(np.max(np.abs(l_cpu - l_gpu) / np.abs(l_cpu)))
    print(f"toy fit {preset} model {cfg.model} card vs cpu, {FIT_STEPS} "
          f"updates (heads "
          f"{cfg.hidden}, batch 16, {trainer.model.cfg.n_members} member(s)): "
          f"max_abs_err params {err_p:.3e} (atol {FIT_ATOL}), losses rel "
          f"{err_l:.3e} (rtol {FIT_LOSS_RTOL}); loss {l_cpu[0]:.4f} → "
          f"{l_cpu[-1]:.4f}")
    if not (err_p <= FIT_ATOL and err_l <= FIT_LOSS_RTOL):
        raise AssertionError(f"toy fit {preset} {cfg.model} on the card "
                             f"disagrees with the CPU")


TOY_PPO = dict(hidden=(16, 16), policy_hidden=(8, 8), n_envs=4,
               rollout_len=8, eval_envs=4, env_horizon=20, batch_size=16,
               buffer_capacity=64, model_updates_per_itr=FIT_STEPS)


def run_toy_ppo(cfg, device, start, noise, perms, fit_idx):
    """One collect, one PPO update, one fit and one eval step of ``cfg`` on
    ``device`` from the CPU start state ``start`` (env states, histories,
    ring, PPO state, model state), with the collect's ε, the update's
    permutations and the fit's segment indices given (``fit_idx`` None:
    drawn here and returned)."""
    from cadm_tpu_torch.core.types import tree_leaves, tree_map

    _, _, _, tr = cfg.build(device)
    # copies: the collect writes the ring in place
    to = lambda t: tree_map(lambda x: x.to(device, copy=True), t)  # noqa: E731
    states, hists, buf, ps, dyn = to(start)
    gen = torch.Generator(device=device).manual_seed(SEED)
    states, hists, buf, traj, last = tr._collect(gen, states, hists, buf, ps,
                                                 dyn, noise=noise.to(device))
    if traj["done"].any():
        raise AssertionError("toy PPO: an episode ended inside the collect "
                             "(its reset draws differ between devices)")
    ps, ppo_m = tr._ppo_update(gen, ps, traj, last, perms=perms.to(device))
    drawn, draw = [], tr._draw
    if fit_idx is None:
        tr._draw = lambda *a: drawn.append(draw(*a)) or drawn[-1]
    else:
        it = iter(fit_idx)
        tr._draw = lambda *a: to(next(it))
    dyn, fit_m = tr._fit_model(gen, buf, dyn)
    _, _, ev_act, ev_obs, _, _ = tr._eval_step(ps, dyn, states, hists, gen, 0)
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    return dict(
        actions=[cpu(traj["act"]), cpu(ev_act)],
        obs=[cpu(traj["obs_z"]), cpu(buf.next_obs), cpu(ev_obs)],
        params=[cpu(x) for x in tree_leaves(ps.params)
                + tree_leaves(dyn.params)],
        losses=np.array([float(v) for v in (*ppo_m.values(),
                                            *fit_m.values())]),
        updates=(ps.updates, dyn.updates)), drawn


def check_toy_ppo(PRESETS, preset="hopper_ppo_cadm"):
    """PPO + CaDM at toy width on the card against the CPU: the same start
    state and weights (made on the CPU), ε, permutations and segment
    indices; actions and obs within SLICE_ATOL, weights within FIT_ATOL,
    losses within FIT_LOSS_RTOL."""
    cfg = dataclasses.replace(PRESETS[preset], **TOY_PPO)
    env, _, _, tr = cfg.build("cpu")
    gen = torch.Generator().manual_seed(SEED)
    start = tr.init(gen)
    noise = torch.randn(cfg.rollout_len, cfg.n_envs, env.act_dim,
                        generator=gen)
    n = cfg.rollout_len * cfg.n_envs
    perms = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(cfg.ppo_epochs)])
    cpu, fit_idx = run_toy_ppo(cfg, "cpu", start, noise, perms, None)
    gpu, _ = run_toy_ppo(cfg, "cuda", start, noise, perms, fit_idx)
    err = {k: max((a - b).abs().max().item() for a, b in zip(cpu[k], gpu[k]))
           for k in ("actions", "obs", "params")}
    err["losses"] = float(np.max(np.abs(cpu["losses"] - gpu["losses"])
                                 / np.maximum(np.abs(cpu["losses"]), 1e-30)))
    print(f"toy PPO {preset} ({cfg.env}, policy {cfg.policy_hidden}, heads "
          f"{cfg.hidden}, {cfg.n_envs} envs, rollout {cfg.rollout_len}, "
          f"{cfg.ppo_epochs}×{cfg.ppo_minibatches} PPO steps, {FIT_STEPS} "
          f"model updates) card vs cpu: max_abs_err actions "
          f"{err['actions']:.3e}, obs {err['obs']:.3e} (atol {SLICE_ATOL}), "
          f"params {err['params']:.3e} (atol {FIT_ATOL}), losses rel "
          f"{err['losses']:.3e} (rtol {FIT_LOSS_RTOL}); losses "
          f"{cpu['losses'].round(4).tolist()}; updates {gpu['updates']}")
    if not (err["actions"] <= SLICE_ATOL and err["obs"] <= SLICE_ATOL
            and err["params"] <= FIT_ATOL and err["losses"] <= FIT_LOSS_RTOL
            and cpu["updates"] == gpu["updates"]
            and np.isfinite(cpu["losses"]).all()):
        raise AssertionError(f"toy PPO {preset} on the card disagrees with "
                             f"the CPU: {err}")


# ------------------------------------------- phase 7: full-width training --
@contextlib.contextmanager
def timed(cls, names, log):
    """Time every call of ``cls``'s methods ``names`` on the host clock
    between two synchronizes; appends (name, seconds, args, result)."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append((name, time.perf_counter() - t0, args, out))
            return out
        return inner

    for n in names:
        setattr(cls, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


@contextlib.contextmanager
def last_output(cls, name, keep):
    """Keep the latest output of ``cls.name`` in ``keep[0]`` (no
    synchronize: the calls are not timed)."""
    saved = getattr(cls, name)

    def inner(*args, **kwargs):
        out = saved(*args, **kwargs)
        keep[:] = [out]
        return out

    setattr(cls, name, inner)
    try:
        yield
    finally:
        setattr(cls, name, saved)


def cli_flags(fields: dict) -> list:
    """CLI flags setting ``fields`` of ExperimentConfig."""
    flags = []
    for k, v in fields.items():
        if isinstance(v, tuple):
            v = ",".join(map(str, v))
        flags += ["--" + k.replace("_", "-"), str(v).lower()
                  if isinstance(v, bool) else str(v)]
    return flags


def matrix_argv(model: str) -> list:
    """The matrix's cheetah cell of ``model`` as CLI flags: the family's
    base, the variant over it, eval modes 0, 1, 2 (``cli.matrix``'s
    tables)."""
    from cadm_tpu_torch.cli.matrix import FAMILY_BASE, MODEL_VARIANTS

    return cli_flags({**FAMILY_BASE["half_cheetah"], **MODEL_VARIANTS[model],
                      "eval_modes": (0, 1, 2)})


def evaluating_itrs(cfg) -> list:
    return [i for i in range(cfg.n_itr)
            if (i + 1) % cfg.eval_every == 0 or i == cfg.n_itr - 1]


@contextlib.contextmanager
def counted(pgs, fk_kernel, out):
    """Set the kernels' launch counts to 0, run the block, and put
    (pgs, full_dyn, fk_vel) launches into ``out``."""
    pgs.launches = fk_kernel.launches = fk_kernel.fk_vel_launches = 0
    yield
    out[:] = [pgs.launches, fk_kernel.launches, fk_kernel.fk_vel_launches]


def control_steps(log) -> int:
    """Control steps of the ``_collect`` and ``evaluate`` calls in a
    ``timed`` log (args[0] is the trainer)."""
    return sum(a[0].cfg.steps_per_itr if n == "_collect" else a[0].env.horizon
               for n, _, a, _ in log if n in ("_collect", "evaluate"))


def check_launches(tag, launched, frame_skip, control_steps):
    expected = frame_skip * control_steps
    print(f"{tag} launches: pgs={launched[0]} full_dyn={launched[1]} "
          f"fk_vel={launched[2]} (expected {expected} = {frame_skip} × "
          f"{control_steps} control steps for pgs and full_dyn)")
    if tuple(launched[:2]) != (expected, expected):
        raise AssertionError(f"{tag} launches {launched[:2]} != {expected}")


def run_training(pgs, fk_kernel, tag, argv):
    """The training path at full width through the CLI with ``argv`` (a
    preset's or the matrix's flags), cut in depth by TRAIN_DEPTH: returns
    the launches of each kernel in the run."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.models.dynamics import Dynamics
    from cadm_tpu_torch.models.grbal import GrBAL
    from cadm_tpu_torch.train.mb_trainer import MBTrainer

    argv = [*argv, *TRAIN_DEPTH]
    cfg = run.config_from_args(run.build_parser().parse_args(argv))
    log, last_update, launched = [], [], []
    gc.collect()  # an earlier path's trainer and ring, held by a cycle
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp, \
            timed(MBTrainer, ("_collect", "_fit_epochs_impl", "_fit_impl",
                              "evaluate"), log), \
            last_output(Dynamics, "update", last_update), \
            last_output(GrBAL, "update", last_update):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counted(pgs, fk_kernel, launched):
            history = run.main([*argv, "--log-dir", tmp, "--exp-name", "t"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "t", "progress.csv")) as f:
            rows = list(csv.DictReader(f))

    n_envs, steps, horizon = cfg.n_envs, cfg.steps_per_itr, cfg.env_horizon
    collects = [(s, a[6]) for n, s, a, _ in log if n == "_collect"]
    # args[0] is the trainer; an analytic env has no substeps and no kernel
    frame_skip = getattr(log[0][2][0].env, "frame_skip", 0)
    fits = [(s, o[0].updates - a[3].updates) for n, s, a, o in log
            if n in ("_fit_epochs_impl", "_fit_impl")]
    evals = [s for n, s, _, _ in log if n == "evaluate"]
    for itr, ((c_s, random), (f_s, updates)) in enumerate(zip(collects, fits)):
        kind = (f"random collect {n_envs * steps / c_s:.1f} env steps/s"
                if random else f"planned collect {1e3 * c_s / steps:.1f} ms "
                f"per control step")
        print(f"{tag} itr {itr}: {kind} ({c_s:.2f} s); fit {updates} updates "
              f"in {f_s:.2f} s = {updates / f_s:.1f} updates/s")
    print(f"{tag}: {len(evals)} evals of {horizon} control steps at "
          f"{cfg.eval_envs} envs, "
          f"{1e3 * sum(evals) / (horizon * len(evals)):.1f} ms per control "
          f"step; wall {wall:.1f} s; peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, {cfg.buffer_capacity}-column "
          f"ring, {n_envs} envs; {held / 2**30:.2f} GiB held before the run)")

    epochs = cfg.fit_protocol == "epochs"
    keys = TRAIN_KEYS if epochs else FIXED_TRAIN_KEYS
    if len(rows) != cfg.n_itr or list(rows[0]) != keys:
        raise AssertionError(f"{tag} progress.csv: {len(rows)} rows, keys "
                             f"{list(rows[0]) if rows else None}")
    metrics = {k: v.item() for k, v in last_update[0][1].items()}
    print(f"{tag}: the last update's metrics {metrics}")
    if not all(math.isfinite(v) for v in metrics.values()) or (
            cfg.ensemble > 1 and "logvar_bound_penalty" not in metrics):
        raise AssertionError(f"{tag}: update metrics {metrics}")
    # GrBAL's loss reports no forward MSE: NaN, as in the reference
    nan_mse = cfg.model == "grbal"
    eval_itrs = evaluating_itrs(cfg)
    for row in rows:
        itr = int(row["itr"])
        bad = [k for k in keys if k.startswith("fit/")
               and math.isfinite(float(row[k])) == (
                   nan_mse and k == "fit/valid_fwd_mse_after")]
        if bad:
            raise AssertionError(f"{tag} itr {itr}: fit metrics {bad} "
                                 f"{'finite' if nan_mse else 'not finite'}")
        if epochs and not 1 <= float(row["fit/epochs_run"]) <= cfg.max_epochs:
            raise AssertionError(f"{tag} itr {itr}: epochs_run "
                                 f"{row['fit/epochs_run']}")
        has_eval = row["eval/return_mode0"] != ""
        if has_eval != (itr in eval_itrs):
            raise AssertionError(f"{tag} itr {itr}: eval columns {has_eval}")
        returns = ("eval returns " + " / ".join(
            f"{float(row[f'eval/return_mode{m}']):.3f}" for m in cfg.eval_modes)
            if has_eval else "no eval")
        episodes = float(row["collect/episodes"])
        print(f"{tag} itr {itr}: episodes {episodes:.0f} "
              f"({episodes - 2 * n_envs:.0f} ended early), epochs_run "
              f"{row.get('fit/epochs_run', 'n/a (fixed fit)')}, valid loss "
              f"{float(row['fit/valid_loss_before']):.4f} → "
              f"{float(row['fit/valid_loss_after']):.4f}, {returns}")
        if episodes < steps // horizon * n_envs:
            raise AssertionError(f"{tag} itr {itr}: {episodes} episodes")
    first = rows[0]
    if not float(first["fit/valid_loss_after"]) < float(
            first["fit/valid_loss_before"]):
        raise AssertionError(f"{tag} itr 0: the fit did not lower the valid "
                             f"loss")
    n_evals = len(eval_itrs) * len(cfg.eval_modes)
    if [len(collects), len(fits), len(evals)] != [cfg.n_itr, cfg.n_itr,
                                                 n_evals] or \
            [r for _, r in collects] != [True] + [False] * (cfg.n_itr - 1) \
            or len(history) != cfg.n_itr:
        raise AssertionError(f"{tag}: unexpected calls: {len(collects)} "
                             f"collects, {len(fits)} fits, {len(evals)} evals")
    check_launches(tag, launched, frame_skip, control_steps(log))
    return launched


def ppo_control_steps(log) -> int:
    """Control steps of the PPO trainer's ``_collect`` and ``evaluate``
    calls in a ``timed`` log (args[0] is the trainer)."""
    return sum(a[0].cfg.rollout_len if n == "_collect" else a[0].env.horizon
               for n, _, a, _ in log if n in ("_collect", "evaluate"))


def run_ppo_training(pgs, fk_kernel, tag, argv):
    """PPO + CaDM at full width through the CLI with ``argv``, cut in depth
    by PPO_DEPTH: returns the launches of each kernel in the run."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.train.ppo import PPOTrainer

    argv = [*argv, *PPO_DEPTH]
    cfg = run.config_from_args(run.build_parser().parse_args(argv))
    log, result, launched = [], [], []
    gc.collect()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp, \
            timed(PPOTrainer, ("_collect", "_ppo_update", "_fit_model",
                               "evaluate"), log), \
            last_output(PPOTrainer, "train", result):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counted(pgs, fk_kernel, launched):
            history = run.main([*argv, "--log-dir", tmp, "--exp-name", "t"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "t", "progress.csv")) as f:
            rows = list(csv.DictReader(f))

    trainer = log[0][2][0]
    frame_skip = trainer.env.frame_skip
    ppo_state = result[0][0]
    per_update = cfg.ppo_epochs * cfg.ppo_minibatches
    secs = {n: [s for m, s, _, _ in log if m == n] for n in
            ("_collect", "_ppo_update", "_fit_model", "evaluate")}
    for itr in range(cfg.n_itr):
        c_s, u_s, f_s = (secs[n][itr] for n in ("_collect", "_ppo_update",
                                                 "_fit_model"))
        print(f"{tag} itr {itr}: collect {1e3 * c_s / cfg.rollout_len:.2f} ms "
              f"per control step at {cfg.n_envs} envs "
              f"({cfg.n_envs * cfg.rollout_len / c_s:.1f} env steps/s, "
              f"{c_s:.2f} s); PPO {per_update} minibatch steps in {u_s:.2f} s"
              f" = {per_update / u_s:.1f} updates/s; fit "
              f"{cfg.model_updates_per_itr} updates in {f_s:.2f} s = "
              f"{cfg.model_updates_per_itr / f_s:.1f} updates/s")
    horizon = trainer.env.horizon
    print(f"{tag}: {len(secs['evaluate'])} evals of {horizon} control steps "
          f"at {cfg.eval_envs} envs, "
          f"{1e3 * sum(secs['evaluate']) / (horizon * len(secs['evaluate'])):.2f}"
          f" ms per control step; wall {wall:.1f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated, "
          f"{cfg.buffer_capacity}-column ring, {cfg.n_envs} envs; "
          f"{held / 2**30:.2f} GiB held before the run)")

    if len(rows) != cfg.n_itr or list(rows[0]) != PPO_KEYS or \
            len(history) != cfg.n_itr:
        raise AssertionError(f"{tag} progress.csv: {len(rows)} rows, keys "
                             f"{list(rows[0]) if rows else None}")
    for row in rows:
        bad = [k for k in PPO_KEYS[4:] if not math.isfinite(float(row[k]))]
        episodes = float(row["collect/episodes"])
        print(f"{tag} itr {row['itr']}: episodes {episodes:.0f}, PPO loss "
              f"{float(row['ppo/loss_first']):.4f} → "
              f"{float(row['ppo/loss_last']):.4f}, model loss "
              f"{float(row['fit/model_loss_last']):.4f}, valid "
              f"{float(row['fit/valid_loss']):.4f}, eval returns " + " / ".join(
                  f"{float(row[f'eval/return_mode{m}']):.3f}"
                  for m in cfg.eval_modes))
        if bad or episodes < cfg.rollout_len // horizon * cfg.n_envs:
            raise AssertionError(f"{tag} itr {row['itr']}: not finite {bad}, "
                                 f"episodes {episodes}")
    if ppo_state.updates != cfg.n_itr * per_update or \
            [len(v) for v in secs.values()] != [cfg.n_itr] * 3 + [
                cfg.n_itr * len(cfg.eval_modes)]:
        raise AssertionError(f"{tag}: {ppo_state.updates} PPO updates, calls "
                             f"{[len(v) for v in secs.values()]}")
    print(f"{tag}: PPO updates {ppo_state.updates} = {cfg.n_itr} itr × "
          f"{cfg.ppo_epochs} epochs × {cfg.ppo_minibatches} minibatches")
    check_launches(tag, launched, frame_skip, ppo_control_steps(log))
    return launched


# ------------------------------------------------------- phase 8: resume ----
def run_resume(pgs, fk_kernel):
    """The matrix's cheetah CaDM through the CLI: 3 iterations with
    ``--checkpoint``, then (the last step removed) ``--resume`` from step 1
    in the same process but a new trainer and generator. Its itr 2 row
    must equal the uninterrupted run's bit for bit. Returns the launches of
    the two runs."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.train.mb_trainer import MBTrainer
    from cadm_tpu_torch.utils.checkpoint import Checkpointer

    argv = [*matrix_argv("cadm"), "--n-itr", "3", "--steps-per-itr", "20",
            "--env-horizon", "10", "--exp-name", "r"]
    cfg = run.config_from_args(run.build_parser().parse_args(argv))
    log, launched = [], []
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp, \
            timed(Checkpointer, ("save", "restore"), log), \
            timed(MBTrainer, ("_collect", "evaluate"), log), \
            counted(pgs, fk_kernel, launched):
        full = run.main([*argv, "--log-dir", tmp, "--checkpoint"])
        ck = os.path.join(tmp, "r", "checkpoints")
        sizes = {f: os.path.getsize(os.path.join(ck, f))
                 for f in sorted(os.listdir(ck))}
        os.remove(os.path.join(ck, "step_2.pt"))
        resumed = run.main([*argv, "--log-dir", tmp, "--resume"])
        torch.cuda.synchronize()
    save_s = [s for n, s, _, _ in log if n == "save"]
    restore_s = [s for n, s, _, _ in log if n == "restore"]
    frame_skip = next(a[0].env.frame_skip for n, _, a, _ in log
                      if n == "_collect")
    print(f"resume: checkpoint files {sizes} bytes ({cfg.n_envs} envs, "
          f"{cfg.buffer_capacity}-column ring); save "
          f"{', '.join(f'{x:.3f}' for x in save_s)} s, restore "
          f"{', '.join(f'{x:.3f}' for x in restore_s)} s")
    if [r["itr"] for r in full] != [0, 1, 2] or \
            [r["itr"] for r in resumed] != [2] or len(restore_s) != 1:
        raise AssertionError(f"resume: itrs {[r['itr'] for r in full]} then "
                             f"{[r['itr'] for r in resumed]}")
    a, b = full[2], resumed[0]
    differ = {k: (a[k], b.get(k)) for k in a
              if not (a[k] == b.get(k) or (isinstance(a[k], float)
                                           and math.isnan(a[k])
                                           and math.isnan(b.get(k))))}
    print(f"resume: itr 2 resumed from step 1 vs uninterrupted, "
          f"{len(a)} columns: {len(differ)} differ {differ}; eval "
          f"{b['eval/return_mode0']:.3f} / {b['eval/return_mode1']:.3f} / "
          f"{b['eval/return_mode2']:.3f}")
    if differ or a.keys() != b.keys():
        raise AssertionError(f"resume: itr 2 differs after resume: {differ}")
    check_launches("resume cadm", launched, frame_skip, control_steps(log))
    return launched


def run_ppo_resume(pgs, fk_kernel, preset="hopper_ppo_cadm"):
    """``preset`` at the width of phase 7 through the CLI: 3 iterations with
    ``--checkpoint``, then (the last step removed) ``--resume`` from step
    1 with a new trainer and generator; its itr 2 row must equal the
    uninterrupted run's bit for bit. Returns the launches of the two
    runs."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.train.ppo import PPOTrainer

    argv = ["--preset", preset, "--n-itr", "3", "--env-horizon", "100",
            "--exp-name", "r"]
    log, launched = [], []
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp, \
            timed(PPOTrainer, ("_collect", "evaluate"), log), \
            counted(pgs, fk_kernel, launched):
        full = run.main([*argv, "--log-dir", tmp, "--checkpoint"])
        ck = os.path.join(tmp, "r", "checkpoints")
        sizes = {f: os.path.getsize(os.path.join(ck, f))
                 for f in sorted(os.listdir(ck))}
        os.remove(os.path.join(ck, "step_2.pt"))
        resumed = run.main([*argv, "--log-dir", tmp, "--resume"])
        torch.cuda.synchronize()
    a, b = full[2], resumed[0]
    differ = {k: (a[k], b.get(k)) for k in a
              if not (a[k] == b.get(k) or (isinstance(a[k], float)
                                           and math.isnan(a[k])
                                           and math.isnan(b.get(k))))}
    print(f"resume {preset}: checkpoint files {sizes} bytes; itr 2 resumed "
          f"from step 1 vs uninterrupted, {len(a)} columns: {len(differ)} "
          f"differ {differ}")
    if [r["itr"] for r in full] != [0, 1, 2] or \
            [r["itr"] for r in resumed] != [2] or differ or a.keys() != b.keys():
        raise AssertionError(f"resume {preset}: itrs {[r['itr'] for r in full]}"
                             f" then {[r['itr'] for r in resumed]}, {differ}")
    check_launches(f"resume {preset}", launched, log[0][2][0].env.frame_skip,
                   ppo_control_steps(log))
    return launched


# ---------------------------------------------- phase 9: trajectory dump ----
def run_dump(pgs, fk_kernel):
    """One iteration of the matrix's cheetah CaDM with ``--dump-trajs``:
    ``read_trajfile`` gives back the ring's columns, 0 records dropped."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.train.mb_trainer import MBTrainer
    from cadm_tpu_torch.utils.trajsink import TrajectorySink, read_trajfile

    if not TrajectorySink.available():
        raise AssertionError("dump: the native trajectory sink did not build")
    argv = [*matrix_argv("cadm"), "--n-itr", "1", "--steps-per-itr", "20",
            "--env-horizon", "10", "--exp-name", "d"]
    log, launched = [], []
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp, \
            timed(MBTrainer, ("_collect", "evaluate"), log), \
            counted(pgs, fk_kernel, launched):
        t0 = time.perf_counter()
        run.main([*argv, "--log-dir", tmp, "--dump-trajs"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, "d", "trajectories.bin")
        out = dict(read_trajfile(path))
        size = os.path.getsize(path)
        with open(os.path.join(tmp, "d", "debug.log")) as f:
            note = [line for line in f if "trajectories.bin:" in line]
    trainer, buf = log[0][2][0], log[0][3][2]  # the collect's ring
    steps = trainer.cfg.steps_per_itr
    errs = {k: float(np.abs(out[f"itr0/{k}"]
                            - getattr(buf, k)[:, :steps].cpu().numpy()).max())
            for k in ("obs", "act", "next_obs")}
    shapes = {k: v.shape for k, v in out.items()}
    print(f"dump: {path.split(os.sep)[-1]} {size} bytes in a {wall:.1f} s "
          f"run; {shapes}; max |file − ring| {errs}; sink: "
          f"{note[0].split('] ')[-1].strip() if note else None}")
    if sorted(out) != [f"itr0/{k}" for k in ("act", "next_obs", "obs")] or \
            any(errs.values()) or not note or \
            not note[0].strip().endswith("6 records, 0 dropped"):
        raise AssertionError(f"dump: {sorted(out)} {errs} {note}")
    check_launches("dump cadm", launched, trainer.env.frame_skip,
                   control_steps(log))
    return launched


# ------------------------------------------ phase 10: full-width acting ----
def run_full_slice(PRESETS, pgs, fk_kernel, preset="halfcheetah_cadm_cem",
                   n_envs=E):
    """``trainer.evaluate`` at ``n_envs`` for SLICE_HORIZON control steps in
    each eval mode; returns the ms per control step of each mode and the
    launches of K1 and K2."""
    cfg = dataclasses.replace(PRESETS[preset], eval_envs=n_envs,
                              env_horizon=SLICE_HORIZON)
    env, model, _, trainer = cfg.build("cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    dyn_state = model.init_state(gen)
    torch.cuda.synchronize()
    per_mode = env.horizon * env.frame_skip
    pgs.launches = fk_kernel.launches = fk_kernel.fk_vel_launches = 0
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
        print(f"slice {preset} mode {mode}: {n_envs} envs x {env.horizon} "
              f"control steps, {ms:.1f} ms/control step, return mean "
              f"{returns.mean().item():.3f} std {returns.std().item():.3f}, "
              f"launches pgs={launched[0]} full_dyn={launched[1]} "
              f"(expected {per_mode} each = {env.frame_skip} × "
              f"{env.horizon})")
        if returns.shape != (n_envs,) or not torch.isfinite(returns).all():
            raise AssertionError(f"{preset} mode {mode}: returns not "
                                 f"finite/shape {tuple(returns.shape)}")
        if launched != (per_mode, per_mode):
            raise AssertionError(f"{preset} mode {mode}: launches {launched} "
                                 f"!= {per_mode} per kernel")
    return step_ms, (pgs.launches, fk_kernel.launches,
                     fk_kernel.fk_vel_launches)


# ---------------------------------------------------- phase 11: the mesh --
# the toy cheetah of phases 5/6 with 2 members, 3 iterations (checkpointed on
# the dp=2, model=2 mesh; (d) resumes its iteration 2 without a mesh), the
# toy PPO of phase 6 for 2 iterations, and phase 7's cheetah
MESH_TOY = dict(TOY, ensemble=2, n_itr=3, steps_per_itr=10, env_horizon=5,
                buffer_capacity=40, batch_size=16, max_epochs=3)
MESH_ARGV = {
    "toy cheetah": ["--preset", "halfcheetah_cadm_cem", *cli_flags(MESH_TOY)],
    "toy ppo": ["--preset", "hopper_ppo_cadm", *cli_flags(TOY_PPO),
                "--n-itr", "2"],
    "full cheetah": ["--preset", "halfcheetah_cadm_cem", *TRAIN_DEPTH],
}


def mesh_job(mesh, tag, log_dir, extra=()):
    """MESH_ARGV[tag] through ``cli.run.main`` on ``mesh`` (None: no mesh)
    in this process → its rows, final weights, kernel launches, its env's
    frame_skip and its control steps, the seconds
    of each collect and fit call (and the fit's updates), this rank's env
    count and its peak device memory."""
    from cadm_tpu_torch.cli import run
    from cadm_tpu_torch.core.types import tree_leaves
    from cadm_tpu_torch.ops import fk_kernel, pgs
    from cadm_tpu_torch.train.mb_trainer import MBTrainer
    from cadm_tpu_torch.train.ppo import PPOTrainer

    argv = [*MESH_ARGV[tag], *extra]
    cfg = run.config_from_args(run.build_parser().parse_args(argv))
    ppo = cfg.trainer == "ppo"
    cls = PPOTrainer if ppo else MBTrainer
    fit = ("_fit_model",) if ppo else ("_fit_epochs_impl", "_fit_impl")
    log, result, launched = [], [], []
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with timed(cls, ("_collect", "evaluate", *fit), log), \
            last_output(cls, "train", result), \
            counted(pgs, fk_kernel, launched):
        t0 = time.perf_counter()
        rows = run.main([*argv, "--log-dir", log_dir, "--exp-name",
                         tag.replace(" ", "_")], mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trainer = log[0][2][0]
    *states, _ = result[0]
    steps = (ppo_control_steps if ppo else control_steps)(log)
    out = dict(
        rows=rows, launches=list(launched),
        params=[x.detach().cpu() for s in states
                for x in tree_leaves(s.params)],
        frame_skip=getattr(trainer.env, "frame_skip", 0), control_steps=steps,
        collect_s=[s for n, s, _, _ in log if n == "_collect"],
        fits=[(s, int(o[0].updates - a[3].updates))
              for n, s, a, o in log if n in fit],
        steps=cfg.rollout_len if ppo else cfg.steps_per_itr,
        n_local=trainer.n_local, peak=torch.cuda.max_memory_allocated(),
        wall=wall)
    if tag == "full cheetah" and mesh is not None:
        del log, result, states  # the run's ring and model
        out["gather"] = checkpoint_gather(trainer, mesh)
    return out


def checkpoint_gather(trainer, mesh):
    """The gather a checkpoint makes on ``mesh`` (``MBTrainer.train``):
    this rank's env states, histories and ring, fresh from ``init`` at the
    run's shapes, gathered over dp → (their bytes, seconds of the gather,
    the device memory it adds at its peak, seconds of the copy to the host
    that ``torch.save`` makes)."""
    from cadm_tpu_torch.core.types import tree_map
    from cadm_tpu_torch.parallel.mesh import gather_leading_axis

    rings = trainer.init(torch.Generator(device=mesh.device).manual_seed(0))
    rings = rings[:3]
    leaves = []
    tree_map(leaves.append, rings)
    held = sum(x.numel() * x.element_size() for x in leaves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = gather_leading_axis(rings, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    added = torch.cuda.max_memory_allocated() - base
    host = []
    tree_map(lambda x: host.append(x.cpu()), full)
    t2 = time.perf_counter()
    return dict(bytes=held, s=t1 - t0, added=added, host_s=t2 - t1)


def mesh_rank(mesh, jobs, log_dir):
    """One rank of a phase-11 mesh: ``mesh_job`` of each (tag, extra flags)
    in ``jobs``, in order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {tag: mesh_job(mesh, tag, log_dir, extra) for tag, extra in jobs}


def rows_err(rows, ref):
    """(largest |Δ| of the collect/eval columns, largest relative |Δ| of the
    fit/ and ppo/ columns) between two runs' rows; NaN matches NaN only."""
    if [list(r) for r in rows] != [list(r) for r in ref]:
        raise AssertionError(f"rows differ in shape: {len(rows)} vs "
                             f"{len(ref)} rows, keys {list(rows[0])}")
    err_abs = err_rel = 0.0
    for a, b in zip(rows, ref):
        for k in b:
            x, y = float(a[k]), float(b[k])
            if math.isnan(x) or math.isnan(y):
                d = 0.0 if math.isnan(x) and math.isnan(y) else math.inf
            else:
                d = abs(x - y)
            if k.startswith(("fit/", "ppo/")):
                err_rel = max(err_rel, d / max(abs(y), 1e-30))
            else:
                err_abs = max(err_abs, d)
    return err_abs, err_rel


def check_mesh_agrees(what, out, ref, against="no mesh"):
    """A mesh run's rows and weights against the run without a mesh (or
    ``against``), within phase 5/6's tolerances (SLICE_ATOL on returns and
    rewards, FIT_LOSS_RTOL on losses, FIT_ATOL on weights)."""
    err_abs, err_rel = rows_err(out["rows"], ref["rows"])
    err_p = max((a - b).abs().max().item()
                for a, b in zip(out["params"], ref["params"]))
    print(f"mesh {what} vs {against}, {len(ref['rows'])} rows: max |Δ| "
          f"collect/eval {err_abs:.3e} (atol {SLICE_ATOL}), fit/ppo rel "
          f"{err_rel:.3e} (rtol {FIT_LOSS_RTOL}); final weights {err_p:.3e} "
          f"(atol {FIT_ATOL})")
    if not (err_abs <= SLICE_ATOL and err_rel <= FIT_LOSS_RTOL
            and err_p <= FIT_ATOL and len(out["params"]) ==
            len(ref["params"])):
        raise AssertionError(f"mesh {what} disagrees with {against}")


def mesh_launches(paths, what, outs, tag):
    """Check each rank's K1/K2 launches of ``tag`` against frame_skip × its
    control steps; add the path (launches summed over its ranks)."""
    for r, out in enumerate(outs):
        o = out[tag]
        check_launches(f"mesh {what} rank {r}", o["launches"],
                       o["frame_skip"], o["control_steps"])
    paths[f"mesh {what}"] = [sum(o[tag]["launches"][i] for o in outs)
                             for i in range(3)]


def run_mesh():
    """Phase 11: the mesh (``cadm_tpu_torch/parallel``) on the card, ranks
    under ``torch.multiprocessing`` (spawn); returns each path's launches."""
    from cadm_tpu_torch.parallel.dryrun import dryrun_multichip
    from cadm_tpu_torch.parallel.mesh import make_mesh, spawn

    t_phase = time.perf_counter()
    paths = {}
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' processes share the card
    with tempfile.TemporaryDirectory() as tmp:
        ref = {tag: mesh_job(None, tag, f"{tmp}/plain")
               for tag in ("toy cheetah", "toy ppo")}
        for tag, out in ref.items():
            mesh_launches(paths, f"{tag} (no mesh)", [{tag: out}], tag)

        # (b) nccl at world size 1: bit for bit
        mesh = make_mesh(1, 1, ["cuda:0"], rank=0,
                         init_method=f"file://{tmp}/nccl_store")
        try:
            backend = mesh.backend
            nccl = mesh_job(mesh, "toy cheetah", f"{tmp}/nccl")
        finally:
            mesh.close()
        same = [a == b or (isinstance(a, float) and math.isnan(a)
                           and math.isnan(b))
                for ra, rb in zip(nccl["rows"], ref["toy cheetah"]["rows"])
                for a, b in zip(ra.values(), rb.values())]
        same_w = all(torch.equal(a, b) for a, b in zip(
            nccl["params"], ref["toy cheetah"]["params"]))
        print(f"mesh (b) toy cheetah on a world-1 {backend} group vs no "
              f"mesh: {sum(same)}/{len(same)} row values equal, final "
              f"weights bit for bit {same_w}")
        if backend != "nccl" or not all(same) or not same_w:
            raise AssertionError("mesh (b): the nccl run differs")
        mesh_launches(paths, "toy cheetah (nccl, world 1)",
                      [{"t": nccl}], "t")

        # (a) 4 ranks on the card (gloo), checkpointed for (d)
        t0 = time.perf_counter()
        r22 = spawn(mesh_rank, 2, 2, ["cuda:0"] * 4,
                    args=([("toy cheetah", ("--checkpoint",))],
                          f"{tmp}/m22"))
        t22 = time.perf_counter() - t0
        for r, out in enumerate(r22):
            check_mesh_agrees(f"(a) toy cheetah dp=2 model=2 rank {r}",
                              out["toy cheetah"], ref["toy cheetah"])
        mesh_launches(paths, "toy cheetah dp=2 model=2", r22, "toy cheetah")

        # (a) and (c): 2 ranks on the card (gloo)
        t0 = time.perf_counter()
        r21 = spawn(mesh_rank, 2, 1, ["cuda:0"] * 2,
                    args=([("toy cheetah", ()), ("toy ppo", ()),
                           ("full cheetah", ())], f"{tmp}/m21"))
        t21 = time.perf_counter() - t0
        for r, out in enumerate(r21):
            for tag in ("toy cheetah", "toy ppo"):
                check_mesh_agrees(f"(a) {tag} dp=2 rank {r}", out[tag],
                                  ref[tag])
        for tag in ("toy cheetah", "toy ppo", "full cheetah"):
            mesh_launches(paths, f"{tag} dp=2", r21, tag)
        for r, out in enumerate(r21):
            c = out["full cheetah"]
            (s0, s1), fits = c["collect_s"], c["fits"]
            print(f"mesh (c) full cheetah dp=2 rank {r} ({c['n_local']} of "
                  f"2048 envs; 2 ranks share one card, so not a scaling "
                  f"number): random collect "
                  f"{c['n_local'] * c['steps'] / s0:.1f} env steps/s, "
                  f"planned collect {1e3 * s1 / c['steps']:.1f} ms per "
                  f"control step, fit " + " / ".join(
                      f"{u / s:.1f}" for s, u in fits) + " updates/s ("
                  + " / ".join(str(u) for _, u in fits) + " updates), "
                  f"peak device memory {c['peak'] / 2**30:.2f} GiB, wall "
                  f"{c['wall']:.1f} s; launches pgs={c['launches'][0]} "
                  f"full_dyn={c['launches'][1]} (frame_skip × control steps "
                  f"= {c['frame_skip'] * c['control_steps']})")
            g = c["gather"]
            print(f"mesh (c) checkpoint gather dp=2 rank {r}: this rank's "
                  f"env states, histories and ring {g['bytes'] / 2**30:.2f} "
                  f"GiB gathered over dp in {g['s']:.2f} s, adding "
                  f"{g['added'] / 2**30:.2f} GiB of device memory at its "
                  f"peak; the copy to the host {g['host_s']:.2f} s")
        with open(f"{tmp}/m21/full_cheetah/progress.csv") as f:
            rows = list(csv.DictReader(f))
        bad = [(r["itr"], k) for r in rows for k in TRAIN_KEYS
               if not math.isfinite(float(r[k]))]
        if len(rows) != 2 or list(rows[0]) != TRAIN_KEYS or bad:
            raise AssertionError(f"mesh (c) progress.csv: {len(rows)} rows, "
                                 f"keys {list(rows[0])}, not finite {bad}")
        print(f"mesh (c) progress.csv (rank 0): {len(rows)} rows, the "
              f"phase-7 columns, all finite; eval returns " + " / ".join(
                  f"{float(rows[-1][f'eval/return_mode{m}']):.3f}"
                  for m in (0, 1, 2)))

        # (d) the dp=2, model=2 checkpoint of iteration 1 resumes without
        # a mesh
        ck = f"{tmp}/m22/toy_cheetah/checkpoints"
        os.remove(f"{ck}/step_2.pt")
        resumed = mesh_job(None, "toy cheetah", f"{tmp}/m22", ("--resume",))
        sharded = r22[0]["toy cheetah"]
        check_mesh_agrees("(d) itr 2 resumed without a mesh from the dp=2 "
                          "model=2 checkpoint of itr 1", resumed,
                          dict(sharded, rows=sharded["rows"][2:]),
                          "the uninterrupted dp=2 model=2 run")
        mesh_launches(paths, "toy cheetah resume (no mesh)",
                      [{"t": resumed}], "t")

        # (e) nccl with one rank per card
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            r_e = spawn(mesh_rank, 2, 1, ["cuda:0", "cuda:1"],
                        args=([("toy cheetah", ())], f"{tmp}/m_e"))
            for r, out in enumerate(r_e):
                check_mesh_agrees(f"(e) toy cheetah dp=2 nccl rank {r}",
                                  out["toy cheetah"], ref["toy cheetah"])
            mesh_launches(paths, "toy cheetah dp=2 (nccl, a card each)", r_e,
                          "toy cheetah")
        else:
            print(f"mesh (e) nccl with one rank per card: not run "
                  f"({n_cards} card)")

    # (f) the dry run on the card, 4 ranks sharing it
    t0 = time.perf_counter()
    loss = dryrun_multichip(4)
    if not math.isfinite(loss):
        raise AssertionError(f"mesh (f) dryrun_multichip(4): loss {loss}")
    print(f"mesh (f) dryrun_multichip(4) on the card: loss {loss:.6f} on "
          f"every rank, {time.perf_counter() - t0:.1f} s")
    print(f"mesh: 4-rank spawn {t22:.1f} s, 2-rank spawn {t21:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------- phase 12: the matrix --
# the newest reference record of the cell (s0 predates the loss-variant tag
# and three history columns its runner writes now)
MATRIX_REFERENCE = os.path.join(ROOT, "results", "raw",
                                "half_cheetah__cadm__s1.json")


def run_matrix(pgs, fk_kernel):
    """``cli.matrix.main`` on ``half_cheetah cadm s0`` at full width (256
    envs, CEM 256 × 30 × 5, heads 4×200, an 8000-column ring), cut in depth
    by TRAIN_DEPTH through a copy of the runner's table, its output
    directories in a temporary one. Checks the cell JSON against the
    reference's record, the launches, a second run skipping the done cell
    and the renderer's row; returns the launches of the first run and the
    snapshot it wrote (plain dicts, on the host)."""
    from unittest import mock

    from cadm_tpu_torch.cli import matrix, results
    from cadm_tpu_torch.train.mb_trainer import MBTrainer

    cut = {f[2:].replace("-", "_"): int(v)
           for f, v in zip(TRAIN_DEPTH[::2], TRAIN_DEPTH[1::2])}
    table = {**matrix.FAMILY_BASE,
             "half_cheetah": {**matrix.FAMILY_BASE["half_cheetah"], **cut}}
    argv = ["--families", "half_cheetah", "--models", "cadm", "--seeds",
            str(SEED)]
    name = matrix.cell_name("half_cheetah", "cadm", SEED)
    with open(MATRIX_REFERENCE) as f:
        ref = json.load(f)
    log, launched, again = [], [], []
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(matrix, "FAMILY_BASE", table), \
            mock.patch.object(matrix, "RESULTS_DIR", f"{tmp}/raw"), \
            mock.patch.object(matrix, "CKPT_DIR", f"{tmp}/ckpt"):
        t0 = time.perf_counter()
        with timed(MBTrainer, ("_collect", "evaluate"), log), \
                counted(pgs, fk_kernel, launched):
            matrix.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(f"{tmp}/raw/{name}.json") as f:
            cell = json.load(f)
        snapshot = torch.load(f"{tmp}/ckpt/{name}.pt", map_location="cpu",
                              weights_only=True)
        with counted(pgs, fk_kernel, again):
            matrix.main(argv)
        rows = [r for r in results.render(f"{tmp}/raw")
                if r.startswith("| half_cheetah | Vanilla + CaDM |")]
        left = sorted(os.listdir(f"{tmp}/raw"))

    cols = set().union(*cell["history"])
    ref_cols = set().union(*ref["history"])
    values = [v for row in cell["history"] for v in row.values()]
    print(f"matrix {name}: keys {sorted(cell)}; {len(cell['history'])} rows, "
          f"{len(cols)} history columns; code_version {cell['code_version']}, "
          f"loss_variant {cell['loss_variant']}, card {cell['card']}; "
          f"training {cell['wall_clock_s']:.1f} s of a {wall:.1f} s main; "
          f"snapshot {sorted(snapshot)}; files {left}")
    expected = set(ref) | {"code_version", "loss_variant", "card"}
    if set(cell) != expected or cols != ref_cols or not all(
            math.isfinite(v) for v in values) or cell["card"] != card_line():
        raise AssertionError(
            f"matrix {name}: keys {sorted(set(cell) ^ expected)} differ, "
            f"columns {sorted(cols ^ ref_cols)} differ, or a value is not "
            f"finite, or card {cell['card']!r}")
    # the config is the reference cell's, bar the seed, the depth cut and
    # the dropped max_parallel_rollouts
    differ = {k: (cell["config"].get(k), v) for k, v in ref["config"].items()
              if k not in ("seed", "max_parallel_rollouts", *cut)
              and cell["config"].get(k) != v}
    if differ or cell["loss_variant"] != ref["loss_variant"]:
        raise AssertionError(f"matrix {name}: config differs {differ}")
    # the full cell's time at this run's rates: 15 planned iterations of
    # 500 steps, 6 evals × 3 modes of 1000 steps (fits not counted)
    planned = next(s / a[0].cfg.steps_per_itr for n, s, a, _ in log
                   if n == "_collect" and not a[6])
    evals = [s / a[0].env.horizon for n, s, a, _ in log if n == "evaluate"]
    eval_step = sum(evals) / len(evals)
    full = {**matrix.FAMILY_BASE["half_cheetah"],
            **matrix.MODEL_VARIANTS["cadm"]}
    n_evals = sum((i + 1) % full["eval_every"] == 0 or i == full["n_itr"] - 1
                  for i in range(full["n_itr"]))
    estimate = ((full["n_itr"] - 1) * full["steps_per_itr"] * planned
                + n_evals * 3 * 1000 * eval_step)
    print(f"matrix {name}: planned collect {1e3 * planned:.1f} ms per step "
          f"at {full['n_envs']} envs, eval {1e3 * eval_step:.1f} ms per step "
          f"at {full['eval_envs']} envs; the full cell's planned and eval "
          f"steps alone at these rates: {estimate:.0f} s")
    print(f"matrix second main (cell done): launches {again}; renderer: "
          f"{rows}")
    if again != [0, 0, 0] or len(rows) != 1 or "| 1 |" not in rows[0]:
        raise AssertionError(f"matrix: the done cell ran again ({again}) or "
                             f"the renderer's row is {rows}")
    check_launches(f"matrix {name}", launched, log[0][2][0].env.frame_skip,
                   control_steps(log))
    return launched, snapshot


# ---------------------------------------------------- phase 13: the probes --
# the reference's record each probe's JSON must hold the keys of
PROBE_RECORDS = {
    "context planner": "context_probe/half_cheetah__ppo_cadm__s0.json",
    "context random mode 1": "context_probe/half_cheetah__ppo_cadm__s0.json",
    "hstep": "hstep_probe/cripple_ant__cadm__s0.json",
    "blowup": "blowup_probe/cripple_ant__cadm__s0.json",
    "dist": "dist_probe/cripple_ant__cadm__s0.json",
    "ranges": "range_potency.json",
    "ab_ts1": "ab_ts1.json",
    "epochs results/raw": "epochs_audit.json",
    "epochs results/torch/raw": "epochs_audit.json",
}
# control steps of the probes' collects (≥ the CaDM window K = 10, so the
# context probe's windows are full), the dist probe's collects, the
# planner's episodes in the range probe
PROBE_STEPS, DIST_STEPS, RANGES_PLANNER_HORIZON = 12, 40, 10
HSTEP_ENVS, HSTEP_H, RANGES_ENVS = 32, 30, 16


def key_paths(x, prefix=""):
    """The dotted key paths of a JSON value, through dicts and the first
    element of lists; a cell name or a scale becomes '*'."""
    if isinstance(x, list):
        return (key_paths(x[0], prefix + "[]")
                if x and isinstance(x[0], (dict, list)) else set())
    if not isinstance(x, dict):
        return set()
    out = set()
    for k, v in x.items():
        k = "*" if "__" in k or k.replace(".", "").isdigit() else k
        out |= {f"{prefix}.{k}"} | key_paths(v, f"{prefix}.{k}")
    return out


def json_numbers(x, key=""):
    """(key, number) of every number in a JSON value."""
    if isinstance(x, dict):
        return [n for k, v in x.items() for n in json_numbers(v, k)]
    if isinstance(x, list):
        return [n for v in x for n in json_numbers(v, key)]
    return ([(key, x)] if isinstance(x, (int, float))
            and not isinstance(x, bool) else [])


def check_probe_record(tag, out, record):
    """``out`` has the keys of the reference's ``record`` (a range record:
    its hopper entry's, whose planner is a Vanilla one), only finite
    numbers, and every fraction in [0, 1]."""
    with open(os.path.join(ROOT, "results", record)) as f:
        ref = json.load(f)
    if record == "range_potency.json":
        ref = {**ref["hopper"], "scales": {s: {"random": p["random"]}
                                           for s, p in ref["hopper"][
                                               "scales"].items()}}
    missing = key_paths(ref) - key_paths(out)
    nums = json_numbers(out)
    bad = [(k, v) for k, v in nums if not math.isfinite(v)
           or ("frac" in k and not 0.0 <= v <= 1.0)]
    if missing or bad or not nums:
        raise AssertionError(f"probes {tag}: keys {sorted(missing)} missing, "
                             f"values {bad[:5]} not finite or not in [0, 1]")


def run_probes(pgs, fk_kernel, snap):
    """Phase 13: every snapshot analysis (``cadm_tpu_torch/analysis``) on
    phase 12's ``half_cheetah cadm s0`` snapshot ``snap`` at the cell's
    full width (256 envs, CEM 256 × 30 × 5, heads 4×200), cut in depth
    only. Each probe's record has the keys of the reference's, finite
    values, fractions in [0, 1], and K1/K2 launches = frame_skip × its env
    control steps; returns each probe's launches."""
    from cadm_tpu_torch.analysis import (
        ab_ts1,
        probe_blowup,
        probe_context,
        probe_dist,
        probe_epochs,
        probe_hstep,
        probe_ranges,
        snapshot,
    )
    from cadm_tpu_torch.cli.matrix import cell_name

    cell = cell_name("half_cheetah", "cadm", SEED)
    t_phase = time.perf_counter()
    paths, walls = {}, {}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(snap, os.path.join(tmp, cell + ".pt"))
        cfg, env, dyn, planner, _, state = snapshot.load_cell(
            cell, device="cuda", ckpt_dir=tmp)
        frame_skip = env.frame_skip

        def probe(tag, steps, fn, show):
            launched = []
            t0 = time.perf_counter()
            with counted(pgs, fk_kernel, launched):
                out = fn()
                torch.cuda.synchronize()
            walls[tag] = time.perf_counter() - t0
            check_probe_record(tag, out, PROBE_RECORDS[tag])
            print(f"probes {tag}: {walls[tag]:.1f} s; {show(out)}")
            check_launches(f"probes {tag}", launched,
                           frame_skip if steps else 0, steps)
            paths[f"probe {tag}"] = launched
            return out

        def r2(out):
            return ", ".join(f"{k} R² {v['held_out_r2']:.4f}"
                             for k, v in out["targets"].items())

        def context(**kw):
            out = probe_context.run_probe(
                cell, rounds=1, steps=PROBE_STEPS, device="cuda",
                ckpt_dir=tmp, log=lambda *a: None, **kw)[0]
            if out["n_windows"] < 1 or sorted(out["targets"]) != [
                    "damping_scale", "mass_scale"]:
                raise AssertionError(f"probes context: {out}")
            return out

        probe("context planner", PROBE_STEPS, context,
              lambda o: f"{o['n_windows']} windows at {cfg.n_envs} envs, "
              + r2(o))
        probe("context random mode 1", PROBE_STEPS,
              lambda: context(random_policy=True, mode=1),
              lambda o: f"{o['n_windows']} windows, " + r2(o))
        probe("hstep", PROBE_STEPS + HSTEP_H,
              lambda: probe_hstep.run_probe(
                  cell, n_envs=HSTEP_ENVS, horizon=HSTEP_H,
                  collect_steps=PROBE_STEPS, device="cuda", ckpt_dir=tmp),
              lambda o: f"H {o['horizon']} over {o['n_envs']} envs, "
              f"open-loop nmse final {o['openloop_nmse_final']} mean "
              f"{o['openloop_nmse_mean']}, alive final "
              f"{o['alive_frac_by_step'][-1]}")
        probe("blowup", PROBE_STEPS,
              lambda: probe_blowup.run_probe(
                  cell, n_envs=8, steps=PROBE_STEPS, device="cuda",
                  ckpt_dir=tmp),
              lambda o: f"{o['candidates']} candidates × {o['horizon']} "
              f"steps from {o['n_start_states']} start states, alive final "
              f"{o['alive_frac_final']}, max |pred| final "
              f"{o['max_abs_pred_by_step'][-1]:.2f}")
        dist_args = probe_dist.build_parser().parse_args([
            "--gen-cell", cell, "--eval-cells", cell, "--steps",
            str(DIST_STEPS), "--ckpt-dir", tmp, "--out-dir", tmp])
        probe("dist", 2 * DIST_STEPS, lambda: probe_dist.run_probe(dist_args),
              lambda o: f"8 envs × {DIST_STEPS} random + {DIST_STEPS} planned "
              f"steps, nmse {o['nmse'][cell]}")

        def ranges():
            scales = probe_ranges.scale_sweep(
                env, RANGES_ENVS, {"random": probe_ranges.random_policy(env)})
            planned = probe_ranges.scale_sweep(
                env, RANGES_ENVS, {"planner_cadm_s0": probe_ranges.
                                   planner_policy(env, dyn, planner, state)},
                RANGES_PLANNER_HORIZON)
            for s, p in planned.items():
                scales[s].update(p)
            return {"horizon": env.horizon,
                    "alive_bonus": float(getattr(env, "alive_bonus", 0.0)),
                    "n_envs": RANGES_ENVS, "scales": scales}

        n_scales = len(probe_ranges.SCALES)
        probe("ranges", n_scales * (env.horizon + RANGES_PLANNER_HORIZON),
              ranges, lambda o: f"{n_scales} scales × ({env.horizon} random + "
              f"{RANGES_PLANNER_HORIZON} planned steps) at {RANGES_ENVS} envs; "
              "random return at 0.2 / 1.8: " + " / ".join(
                  f"{o['scales'][s]['random']['return_mean']:.1f}"
                  for s in ("0.2", "1.8")))

        def ab():
            t0 = time.time()
            env_c, model, st = ab_ts1.train_cartpole_ensemble(
                steps=AB_TS1_STEPS, device="cuda", log=lambda *a: None)
            study = ab_ts1.elite_study(env_c, model, st, draws=4)
            cl = {m: [ab_ts1.closed_loop(env_c, model, st, m, s, t=50)
                      for s in (0, 1)] for m in ab_ts1.MODES}
            return {"elite_study": study, "closed_loop_mean_reward_sum": cl,
                    "wall_s": time.time() - t0}

        def ab_line(o):
            st = o["elite_study"]
            return (f"{AB_TS1_STEPS} updates, elite overlap block vs exact "
                    f"{st['elite_overlap_block_vs_exact']:.3f} (exact floor "
                    f"{st['elite_overlap_exact_vs_exact_noise_floor']:.3f}), "
                    f"closed loop {o['closed_loop_mean_reward_sum']}")

        probe("ab_ts1", 0, ab, ab_line)
        for raw in ("results/raw", "results/torch/raw"):
            probe(f"epochs {raw}", 0,
                  lambda: probe_epochs.audit(os.path.join(ROOT, raw)),
                  lambda o: f"{len(o)} cells")
    print(f"probes: phase {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")
    return paths


def kernel_entry(name, source, replaces, launches, by_path, err, main,
                 **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": main["ms"], "call_ms": main["call_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, **extra}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the port on the card.")
    parser.add_argument("--only", choices=["mesh", "matrix", "probes"],
                        help="run phase 1 and this phase alone (probes: "
                             "phase 12, whose snapshot they read, and 13)")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    # imported only once a card is known to exist
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.cli.matrix import MODEL_VARIANTS
    from cadm_tpu_torch.cli.presets import PRESETS
    from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
    from cadm_tpu_torch.ops import _build, fk_kernel, pgs
    from cadm_tpu_torch.physics.rigid import dynamics as rdyn

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: nvcc sm_90a -> {path} in {time.perf_counter() - t0:.1f} s")
    if only == "mesh":
        paths = run_mesh()
    elif only:
        launched, snap = run_matrix(pgs, fk_kernel)
        paths = {"matrix half_cheetah cadm": launched}
        if only == "probes":
            paths.update(run_probes(pgs, fk_kernel, snap))
    if only:
        for name, counts in paths.items():
            print(f"{name}: launches pgs/full_dyn/fk_vel {counts}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_pgs(pgs, dev, gen)
    k1_path, k2_path = [], []
    for name, n in MAIN_PATH_SYSTEMS:
        captured, smooth = capture_main_path(envs, rdyn, fk_kernel, dev, name, n)
        k1_path += check_pgs_main_path(pgs, captured, name)
        k2_path.append(check_full_dyn_main_path(fk_kernel, smooth, name))
    k2 = check_full_dyn(fk_kernel, load_system, ASSETS, dev)
    k3 = check_fk_vel(fk_kernel, load_system, ASSETS, dev)
    for preset in TRAIN_PRESETS:
        check_toy_slice(PRESETS, preset)
        check_toy_fit(PRESETS, preset)
    for name in BASELINES:
        check_toy_slice(PRESETS, **MODEL_VARIANTS[name])
        check_toy_fit(PRESETS, **MODEL_VARIANTS[name])
    check_toy_ppo(PRESETS)
    # every path starts with the counts at 0 and reads them at its end
    paths = {f"train {p}": run_training(pgs, fk_kernel, f"train {p}",
                                        ["--preset", p])
             for p in TRAIN_PRESETS + ANALYTIC_PRESETS}
    for name in BASELINES:
        paths[f"train half_cheetah {name}"] = run_training(
            pgs, fk_kernel, f"train half_cheetah {name} (matrix)",
            matrix_argv(name))
    for p in PPO_PRESETS:
        paths[f"train {p}"] = run_ppo_training(pgs, fk_kernel, f"train {p}",
                                               ["--preset", p])
    paths["resume half_cheetah cadm"] = run_resume(pgs, fk_kernel)
    paths["resume hopper_ppo_cadm"] = run_ppo_resume(pgs, fk_kernel)
    paths["dump half_cheetah cadm"] = run_dump(pgs, fk_kernel)
    step_ms = {}
    for preset, n in ACT_PRESETS:
        step_ms[preset], paths[f"act {preset}"] = run_full_slice(
            PRESETS, pgs, fk_kernel, preset, n)
    paths.update(run_mesh())
    paths["matrix half_cheetah cadm"], snap = run_matrix(pgs, fk_kernel)
    paths.update(run_probes(pgs, fk_kernel, snap))

    def launches(i):
        return (sum(v[i] for v in paths.values()),
                {k: v[i] for k, v in paths.items()})

    k1_main = next(r for r in k1 if r["nc"] == 16 and r["tag"] == "cold")
    k2_main = next(r for r in k2 if r["asset"] == "half_cheetah")
    k3_main = next(r for r in k3
                   if r["asset"] == "half_cheetah" and r["e"] == E)
    k1_systems = {}
    for r in k1_path:
        k1_systems.setdefault(r["system"], {})[r["tag"]] = r["ms"]
        k1_systems[r["system"]][f"{r['tag']}_bound_ms"] = r["bound_ms"]
    k3_sizes = {}
    for r in k3:
        k3_sizes.setdefault(r["asset"], {})[str(r["e"])] = {
            k: r[k] for k in ("ms", "call_ms", "wrapper_ms", "plain_ms",
                              "bound_ms", "share", "err")}
    kernels = {"kernels": [
        kernel_entry("pgs_solve", "cadm_tpu_torch/csrc/pgs.cu",
                     "cadm_tpu/ops/pgs.py:79", *launches(0),
                     max(r["err"] for r in k1 + k1_path), k1_main,
                     main_path_ms=k1_systems),
        kernel_entry("full_dyn", "cadm_tpu_torch/csrc/full_dyn.cu",
                     "cadm_tpu/ops/fk_kernel.py:535", *launches(1),
                     max(r["err"] for r in k2 + k2_path), k2_main,
                     main_path_ms={r["system"]: {
                         k: r[k] for k in ("ms", "bound_ms", "plain_ms", "err")}
                         for r in k2_path}),
        # on no main path (the reference's dispatcher has no caller either):
        # its launches on every path are 0 by design
        kernel_entry("fk_vel", "cadm_tpu_torch/csrc/full_dyn.cu",
                     "cadm_tpu/ops/fk_kernel.py:267", *launches(2),
                     max(r["err"] for r in k3), k3_main, main_path=False,
                     by_envs=k3_sizes),
    ]}
    for preset, ms in step_ms.items():
        print(f"slice {preset} ms per control step (modes "
              f"{list(PRESETS[preset].eval_modes)}): "
              f"{', '.join(f'{x:.1f}' for x in ms)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
