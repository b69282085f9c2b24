"""Distribution-shift probe: score snapshots on random vs planner-driven
data (counterpart of scripts/probe_dist.py).

A generator snapshot drives a planner-driven ("gait") collect and a
random-policy control collect; each eval snapshot's one-step forward error
(its members' means) is then scored on both rings in shared units: the
per-dim population std of Δobs over the ring's filled, healthy columns.
A model that never saw gait data scores like a healthy one on random data
and much worse on gait data.

Usage:
  python -m cadm_tpu_torch.analysis.probe_dist --gen-cell cripple_ant__cadm__s0 \\
      --eval-cells cripple_ant__cadm__s0 cripple_ant__pets_cadm__s0 \\
      --n-envs 8 --steps 300 --candidates 50 --horizon 15

Writes ``results/torch/dist_probe/<gen-cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

import torch

from cadm_tpu_torch.analysis.snapshot import add_common_args, load_cell, out_path
from cadm_tpu_torch.train.buffer import ReplayBuffer

OUT_DIR = out_path("dist_probe")
SEED = 11  # the script's key(11)
Indices = Tuple[torch.Tensor, torch.Tensor]


def load(cell: str, args):
    """``load_cell`` at the probe's widths: its envs, collect steps (a ring
    of twice that), candidates and planning horizon."""
    return load_cell(cell, device=args.device, ckpt_dir=args.ckpt_dir,
                     n_envs=args.n_envs, steps_per_itr=args.steps,
                     buffer_capacity=2 * args.steps,
                     n_candidates=args.candidates, plan_horizon=args.horizon)


def shared_std(buffer: ReplayBuffer) -> torch.Tensor:
    """Per-dim population std of Δobs over the ring's filled, healthy
    columns (+1e-8)."""
    _, _, dobs, mask = buffer.norm_inputs()
    return dobs[mask].std(0, correction=0) + 1e-8


@torch.no_grad()
def score_on_buffer(dyn, dyn_state, buffer: ReplayBuffer,
                    gen: Optional[torch.Generator], batches: int, batch: int,
                    std: torch.Tensor,
                    indices: Optional[Sequence[Indices]] = None) -> float:
    """Mean one-step forward error of the members' means on segments drawn
    from ``buffer`` (anchors anywhere), in Δobs units of ``std``: each
    member scores its own (batch,) draw, valid-weighted; members and
    ``batches`` draws are averaged. ``indices`` replaces the draws
    (``batches`` of (env_idx, t_idx), each (n_members, batch))."""
    c = dyn.cfg
    params, norm = dyn_state.params, dyn_state.norm
    scores: List[torch.Tensor] = []
    for b in range(batches):
        idx = (indices[b] if indices is not None else
               buffer.draw_indices(gen, (c.n_members, batch)))
        seg = buffer.gather(*idx, c.history_k, c.future_m)
        z = dyn.get_context(params, norm, seg.hist_dobs, seg.hist_act,
                            seg.hist_valid)
        pred = dyn.predict(params, norm, params["fwd"], seg.obs[:, :, 0],
                           seg.act[:, :, 0], z)
        sq = (((pred - seg.next_obs[:, :, 0]) / std) ** 2).mean(-1)
        valid = seg.valid[:, :, 0]
        w = valid / (valid.sum(-1, keepdim=True) + 1e-8)
        scores.append((sq * w).sum(-1).mean())
    return float(torch.stack(scores).mean())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gen-cell", required=True,
                    help="healthy snapshot that drives the gait collection")
    ap.add_argument("--eval-cells", nargs="+", required=True)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--candidates", type=int, default=50)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out-dir", default=OUT_DIR)
    add_common_args(ap)
    return ap


def run_probe(args) -> dict:
    """The probe's record for parsed ``args``."""
    _, env, _, _, trainer, gen_state = load(args.gen_cell, args)
    gen = torch.Generator(device=env.device).manual_seed(SEED)
    env_states, hists, buf_rand, _ = trainer.init(gen)
    # the random-policy control ring (also warms the histories the
    # planner's conditioning needs)
    env_states, hists, buf_rand, m_rand = trainer._collect(
        gen, env_states, hists, buf_rand, gen_state, random_actions=True)
    # the planner-driven ring: a fresh ring, the env states continued
    buf_gait = ReplayBuffer.create(buf_rand.n_envs, buf_rand.capacity,
                                   env.obs_dim, env.act_dim, env.device)
    env_states, hists, buf_gait, m_gait = trainer._collect(
        gen, env_states, hists, buf_gait, gen_state, random_actions=False)
    gait_r = float(m_gait["collect/mean_step_reward"])
    rand_r = float(m_rand["collect/mean_step_reward"])
    print(f"[probe_dist] gait collect mean_step_reward={gait_r:.3f} "
          f"(random: {rand_r:.3f})", flush=True)
    buffers = {"random": buf_rand, "gait": buf_gait}
    stds = {name: shared_std(buf) for name, buf in buffers.items()}
    out = {"gen_cell": args.gen_cell, "n_envs": args.n_envs,
           "steps": args.steps, "gait_mean_step_reward": round(gait_r, 4),
           "random_mean_step_reward": round(rand_r, 4), "nmse": {}}
    for cell in args.eval_cells:
        _, _, dyn, _, _, state = load(cell, args)
        out["nmse"][cell] = {
            name: round(score_on_buffer(dyn, state, buf, gen, args.batches,
                                        args.batch, stds[name]), 4)
            for name, buf in buffers.items()}
        print(f"[probe_dist] {cell}: {out['nmse'][cell]}", flush=True)
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run_probe(args)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, args.gen_cell + ".json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
