#!/usr/bin/env python3
"""Profile the PyTorch port's model fit on the card at full width.

    python scripts/profile_torch_fit.py [--updates 200]

Builds the ``halfcheetah_cadm_cem`` preset on the card (2048 envs, a
20000-column replay ring, batch 256, CaDM with 4×200 heads), fills the ring
with one 20-step random collect and refreshes the norm statistics, then
times the fit's pieces separately (host clock between synchronizes): the
segment draw + gather, the update (loss, backward, clip, Adam), and the
whole train step, and one whole epoch fit as the trainer runs it
(``_fit_epochs_impl``: norm refresh, valid passes, up to 8 epochs of 144
updates). Finally it runs ``--updates // 4`` train steps under
``torch.profiler`` and prints the device-busy share (kernel time over
wall), the kernel launches per update and the kernels with the most device
time. Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, n: int) -> float:
    """Seconds per call of ``fn`` over ``n`` calls (synchronized)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType

    from cadm_tpu_torch.cli.presets import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(PRESETS["halfcheetah_cadm_cem"], steps_per_itr=20)
    _, _, _, trainer = cfg.build("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    states, hists, buf, dyn = trainer.init(gen)
    buf = trainer._collect(gen, states, hists, buf, dyn, True)[2]
    t_norm = timed(lambda: trainer._refresh_norm(buf, dyn), 3)
    dyn = trainer._refresh_norm(buf, dyn)
    print(f"ring {buf.n_envs} envs x {buf.capacity} columns, {buf.size} "
          f"filled; norm refresh {1e3 * t_norm:.2f} ms")

    idx = trainer._draw(buf, gen, "train")
    batch = trainer._sample(buf, idx)
    state = [dyn]

    def step():
        state[0], _ = trainer._train_step(buf, gen, state[0])

    n = args.updates
    t_draw = timed(lambda: trainer._draw(buf, gen, "train"), n)
    t_gather = timed(lambda: trainer._sample(buf, idx), n)
    t_update = timed(lambda: trainer.model.update(state[0], batch), n)
    t_step = timed(step, n)
    print(f"per update ({n} each): draw {1e3 * t_draw:.3f} ms, gather "
          f"{1e3 * t_gather:.3f} ms, update {1e3 * t_update:.3f} ms; train "
          f"step {1e3 * t_step:.3f} ms = {1 / t_step:.1f} updates/s")

    fit_state = dyn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_state, met = trainer._fit_epochs_impl(gen, buf, fit_state)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    print(f"epoch fit: {fit_state.updates - dyn.updates} updates "
          f"({met['fit/epochs_run']} epochs) in {t_fit:.2f} s = "
          f"{(fit_state.updates - dyn.updates) / t_fit:.1f} updates/s")

    m = max(1, n // 4)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(m):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    busy = sum(a.self_device_time_total for a in kernels) / 1e6
    launches = sum(a.count for a in kernels)
    print(f"profiled {m} train steps: wall {1e3 * wall / m:.3f} ms per step "
          f"(profiler on), device busy {1e3 * busy / m:.3f} ms per step = "
          f"{100 * busy / wall:.1f} % of wall, {launches / m:.0f} kernel "
          f"launches per step")
    for a in sorted(kernels, key=lambda a: -a.self_device_time_total)[:12]:
        print(f"  {a.self_device_time_total / m:9.1f} us/step  "
              f"{a.count / m:5.1f}x  {a.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
