"""A/B: block-granular TS1 (``PlannerConfig.ensemble_eval='ts1'``) against
the PETS paper's exact per-candidate TS1 (``'ts1_exact'``) (counterpart of
scripts/ab_ts1.py).

1. Train a 5-member probabilistic ensemble on CartPole transitions.
2. For a batch of start states and one FIXED candidate set, estimate each
   candidate's return under each propagation mode, many draws per mode.
3. Report the cross-mode return correlation (of the mean-over-draws
   estimates), the top-k elite overlap between the modes, and the same
   overlap between independent halves of the draws WITHIN a mode: the
   sampling-noise floor any TS1 lives with. The block variant behaves as
   the exact one iff their disagreement is within that floor.
4. Closed-loop CartPole returns with CEM under each mode (same seeds).

Usage:
  python -m cadm_tpu_torch.analysis.ab_ts1
  python -m cadm_tpu_torch.analysis.ab_ts1 --steps 300 --draws 4 --episodes 8 \
      --closed-loop-steps 50

Writes ``results/torch/ab_ts1.json`` and prints a summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from cadm_tpu_torch.analysis.snapshot import add_common_args, out_path
from cadm_tpu_torch.core.rng import rand
from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.models.dynamics import (
    Dynamics,
    DynamicsConfig,
    NormStats,
    SegmentBatch,
)
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig

OUT_PATH = out_path("ab_ts1.json")
MODES = ("ts1", "ts1_exact")
N_ENV, T = 64, 50   # the training data: random-policy steps of N_ENV envs


@torch.no_grad()
def collect(env, gen, start=None, actions=None):
    """(obs, act, next_obs) of T random-action steps of N_ENV envs,
    flattened time-major; ``start``/``actions`` (T, N_ENV, act) replace
    the reset states and the draws."""
    st = env.reset(gen, N_ENV, 0) if start is None else start
    obs, act, nobs = [], [], []
    for t in range(T):
        a = (actions[t] if actions is not None
             else 2.0 * rand(gen, N_ENV, env.act_dim) - 1.0)
        obs.append(env.observe(st.params, st.phys))
        st, o, _, _ = env.step(st, a, gen)
        act.append(a)
        nobs.append(o)
    return tuple(torch.stack(x).reshape(T * N_ENV, -1)
                 for x in (obs, act, nobs))


def train_cartpole_ensemble(n_members=5, steps=3000, batch=256, seed=0,
                            device="cuda", state=None, start=None,
                            actions=None, indices=None, log=print):
    """(env, model, state): a probabilistic ensemble (hidden (64, 64),
    K=2) on CartPole's random-policy transitions, its norm statistics the
    dataset's, trained for ``steps`` updates on uniform (n_members, batch)
    draws of single transitions. ``state`` (the initial model state),
    ``start``/``actions`` (``collect``) and ``indices`` (steps, n_members,
    batch) replace the draws."""
    device = resolve_device(device)
    env = make("cartpole", device=device)
    cfg = DynamicsConfig(
        obs_dim=env.obs_dim, act_dim=env.act_dim, hidden=(64, 64),
        n_members=n_members, probabilistic=True, history_k=2, future_m=1,
        lr=1e-3,
    )
    model = Dynamics(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if state is None:
        state = model.init_state(gen)
    obs, act, nobs = collect(env, gen, start, actions)
    n = obs.shape[0]
    dobs = nobs - obs

    def stats(x):
        return x.mean(0), x.std(0, correction=0) + 1e-6

    state = dataclasses.replace(state, norm=NormStats(
        *stats(obs), *stats(act), *stats(dobs)))
    z = torch.zeros
    metrics = {}
    for i in range(steps):
        idx = (indices[i] if indices is not None else torch.randint(
            0, n, (n_members, batch), generator=gen, device=device))
        mb = SegmentBatch(
            hist_obs=z(n_members, batch, 2, env.obs_dim, device=device),
            hist_dobs=z(n_members, batch, 2, env.obs_dim, device=device),
            hist_act=z(n_members, batch, 2, env.act_dim, device=device),
            hist_valid=z(n_members, batch, 2, device=device),
            obs=obs[idx][:, :, None], act=act[idx][:, :, None],
            next_obs=nobs[idx][:, :, None],
            valid=torch.ones(n_members, batch, 1, device=device),
        )
        state, metrics = model.update(state, mb)
    if metrics:
        log(f"[ab_ts1] trained: loss={float(metrics['model_loss']):.4f} "
            f"fwd_mse={float(metrics['fwd_mean_mse']):.4f}")
    return env, model, state


@torch.no_grad()
def candidate_returns(env, model, state, n_obs=8, c=200, h=20, k_elite=20,
                      draws=20, gen=None, obs=None, actions=None,
                      members=None) -> dict:
    """Each mode's returns (draws, n_obs, c) of one fixed candidate set.
    ``obs`` (n_obs, obs_dim), ``actions`` (n_obs, c, h, act) and
    ``members`` ({mode: per-draw member draws, see
    ``MPCPlanner.member_draws``}) replace the draws."""
    base = PlannerConfig(kind="cem", horizon=h, n_candidates=c,
                         cem_elites=k_elite)
    if obs is None:
        states = env.reset(gen, n_obs, 0)
        obs = env.observe(states.params, states.phys)
    if actions is None:
        actions = 2.0 * rand(gen, n_obs, c, h, env.act_dim) - 1.0
    z = obs.new_zeros(n_obs, 0)
    rets = {}
    for mode in MODES:
        p = MPCPlanner(dataclasses.replace(base, ensemble_eval=mode), model,
                       env.reward, env.act_dim)
        rets[mode] = np.stack([p._evaluate(
            state.params, state.norm, obs, z, actions, gen,
            None if members is None else members[mode][d]).cpu().numpy()
            for d in range(draws)])
    return rets


def overlap_stats(rets: dict, k_elite: int) -> dict:
    """The study's statistics of ``candidate_returns``' output."""

    def topk_overlap(a, b):
        """Mean |topk(a) ∩ topk(b)| / k over the obs batch."""
        out = []
        for i in range(a.shape[0]):
            ta = set(np.argsort(a[i])[-k_elite:])
            tb = set(np.argsort(b[i])[-k_elite:])
            out.append(len(ta & tb) / k_elite)
        return float(np.mean(out))

    block, exact = rets["ts1"], rets["ts1_exact"]
    mean_block, mean_exact = block.mean(0), exact.mean(0)
    return {
        "return_correlation_block_vs_exact": float(np.corrcoef(
            mean_block.ravel(), mean_exact.ravel())[0, 1]),
        "elite_overlap_block_vs_exact": topk_overlap(mean_block, mean_exact),
        # the sampling-noise floor: independent half-splits of the draws
        "elite_overlap_exact_vs_exact_noise_floor": topk_overlap(
            exact[0::2].mean(0), exact[1::2].mean(0)),
        "elite_overlap_block_vs_block_noise_floor": topk_overlap(
            block[0::2].mean(0), block[1::2].mean(0)),
        "single_draw_overlap_block_vs_exact": topk_overlap(block[0], exact[0]),
        "single_draw_overlap_exact_vs_exact": topk_overlap(exact[0], exact[1]),
    }


def elite_study(env, model, state, n_obs=8, c=200, h=20, k_elite=20,
                draws=20, seed=0, **injected) -> dict:
    """The study's record; ``injected`` as in ``candidate_returns``."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    rets = candidate_returns(env, model, state, n_obs, c, h, k_elite, draws,
                             gen, **injected)
    return {"n_obs": n_obs, "candidates": c, "horizon": h, "elites": k_elite,
            "draws_per_mode": draws, **overlap_stats(rets, k_elite)}


@torch.no_grad()
def closed_loop(env, model, state, mode, seed, episodes=16, t=200) -> float:
    """Mean over ``episodes`` CartPole episodes of the reward summed over
    ``t`` steps, acting with warm-started CEM (100 × 20 × 4) in ``mode``."""
    p = MPCPlanner(
        PlannerConfig(kind="cem", horizon=20, n_candidates=100, cem_iters=4,
                      cem_elites=10, ensemble_eval=mode, warm_start=True),
        model, env.reward, env.act_dim)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    st = env.reset(gen, episodes, 0)
    mu = p.init_plan(episodes, env.device)
    tot = torch.zeros(episodes, device=env.device)
    z = tot.new_zeros(episodes, 0)
    for _ in range(t):
        o = env.observe(st.params, st.phys)
        a, mu = p.plan(state, o, z, gen, mu)
        st, _, rew, _ = env.step(st, a, gen)
        tot = tot + rew
    return float(tot.mean())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3000,
                    help="training updates of the ensemble")
    ap.add_argument("--draws", type=int, default=20,
                    help="rng draws per mode in the elite study")
    ap.add_argument("--episodes", type=int, default=16,
                    help="closed-loop episodes per mode and seed")
    ap.add_argument("--closed-loop-steps", type=int, default=200,
                    help="control steps of each closed-loop run")
    ap.add_argument("--out", default=OUT_PATH)
    add_common_args(ap, ckpt=False)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    t0 = time.time()
    env, model, state = train_cartpole_ensemble(steps=args.steps,
                                                device=args.device)
    study = elite_study(env, model, state, draws=args.draws)
    print("[ab_ts1] elite study:", json.dumps(study, indent=2), flush=True)
    cl = {}
    for mode in MODES:
        cl[mode] = [closed_loop(env, model, state, mode, s, args.episodes,
                                args.closed_loop_steps) for s in (0, 1)]
        print(f"[ab_ts1] closed-loop {mode}: {cl[mode]}", flush=True)
    out = {"elite_study": study, "closed_loop_mean_reward_sum": cl,
           "wall_s": time.time() - t0}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[ab_ts1] wrote {args.out} in {out['wall_s']:.0f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
