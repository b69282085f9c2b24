"""Experiment CLI (counterpart of cadm_tpu/cli/run.py).

Examples:
  python -m cadm_tpu_torch.cli.run --preset halfcheetah_cadm_cem
  python -m cadm_tpu_torch.cli.run --preset cripple_ant_cadm_ensemble_cem \\
      --n-itr 2 --steps-per-itr 20 --env-horizon 10 --log-dir runs
  python -m cadm_tpu_torch.cli.run --env half_cheetah --model grbal \\
      --exp-name cheetah_grbal --checkpoint      # ... and later --resume
  python -m cadm_tpu_torch.cli.run --preset hopper_ppo_cadm   # PPO + CaDM
  torchrun --standalone --nproc-per-node 4 -m cadm_tpu_torch.cli.run \\
      --preset halfcheetah_cadm_cem --dp 4                # 4 cards

Presets (the reference's values): cartpole_vanilla_rs, pendulum_cadm_cem,
halfcheetah_cadm_cem, hopper_cadm_cem, slim_humanoid_cadm_cem,
ant_cadm_ensemble_cem, cripple_ant_cadm_ensemble_cem, hopper_ppo_cadm,
slim_humanoid_ppo_cadm. Without a preset the config's defaults apply
(cartpole, CaDM, CEM, as in the reference).

One flag per ``ExperimentConfig`` field overrides the preset; ``--device``
(default ``cuda``) picks the card or, for tests, ``cpu``. Writes
``<log-dir>/<exp-name>/progress.csv`` (one row per outer iteration),
``params.json`` and ``debug.log``. ``--checkpoint`` saves the whole
training state after every iteration to ``<log-dir>/<exp-name>/checkpoints``
(the newest 3 kept); ``--resume`` restores the latest one there and goes on
at the next iteration, so a long run can span several processes. A resumed
process rewrites ``progress.csv`` with its own rows only, as the
reference's logger does: keep each process's copy. ``--dump-trajs`` streams
each iteration's transitions to ``trajectories.bin`` (``utils/trajsink.py``);
under ``--trainer ppo`` it is ignored, as in the reference.

``--dp``/``--model-par`` run the experiment on a (dp, model) mesh
(``parallel/mesh.py``): the envs split over dp ranks, the ensemble members
over model ranks, one process per rank under ``torchrun`` with
``--nproc-per-node`` = dp × model-par. With ``--device cuda`` rank r runs on
card ``LOCAL_RANK`` (nccl), with ``--device cpu`` every rank on the CPU
(gloo). The rows are those of the same run without a mesh, within float32
reduction order; rank 0 writes the log and the checkpoints, which resume
on any layout. ``--dp`` without a launcher, or with another number of
ranks, raises (it never runs unsharded instead).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import typing

import torch

from cadm_tpu_torch.cli.presets import PRESETS, ExperimentConfig
from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.parallel.mesh import (
    launched_world_size,
    make_mesh,
    writes_files,
)
from cadm_tpu_torch.utils.checkpoint import Checkpointer
from cadm_tpu_torch.utils.logger import TabularLogger
from cadm_tpu_torch.utils.trajsink import TrajectorySink


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--exp-name", default=None)
    p.add_argument("--log-dir", default="data")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--checkpoint", action="store_true",
                   help="save the full training state after every iteration")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in the experiment dir "
                        "and continue")
    p.add_argument("--dump-trajs", action="store_true",
                   help="stream collected trajectories to the native async "
                        "sink")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis: the envs split over this "
                        "many ranks (0: no mesh; run under torchrun)")
    p.add_argument("--model-par", type=int, default=1,
                   help="ensemble-member mesh axis (with --dp)")
    # f.type is a string under `from __future__ import annotations`:
    # resolve the real types, unwrapping Optional/Tuple
    hints = typing.get_type_hints(ExperimentConfig)
    for f in dataclasses.fields(ExperimentConfig):
        flag = "--" + f.name.replace("_", "-")
        t = hints[f.name]
        if typing.get_origin(t) is typing.Union:  # Optional[X] -> X
            t = next(a for a in typing.get_args(t) if a is not type(None))
        if typing.get_origin(t) is tuple:
            elem = typing.get_args(t)[0]
            p.add_argument(
                flag,
                type=lambda s, e=elem: tuple(e(x) for x in s.split(",")),
                default=None,
            )
        elif t is bool:
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        elif t in (int, float):
            p.add_argument(flag, type=t, default=None)
        else:
            p.add_argument(flag, type=str, default=None)
    return p


def config_from_args(args) -> ExperimentConfig:
    cfg = PRESETS[args.preset] if args.preset else ExperimentConfig()
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(ExperimentConfig)
        if getattr(args, f.name) is not None
    }
    return dataclasses.replace(cfg, **overrides)


def main(argv=None, mesh=None):
    """Parse ``argv``, train, and return the list of metric rows.

    ``mesh``: a ``parallel.mesh.Mesh`` built by the caller (its device
    replaces ``--device``, its axes ``--dp``/``--model-par``); without one
    ``--dp`` builds it from the launcher's environment and closes it at the
    end."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    own_mesh = mesh is None and args.dp > 0
    if mesh is None and args.model_par != 1 and not args.dp:
        raise ValueError("--model-par needs --dp (the mesh's dp axis)")
    device = resolve_device(args.device) if mesh is None else mesh.device
    if own_mesh:
        mesh = make_mesh(args.dp, args.model_par, None if device.type == "cuda"
                         else [device] * launched_world_size())
        device = mesh.device
    writes = writes_files(mesh)

    exp_name = args.exp_name or (args.preset
                                 or f"{cfg.env}_{cfg.model}_{cfg.planner}")
    logger = None
    if writes:
        logger = TabularLogger(args.log_dir, exp_name)
        logger.save_params(dataclasses.asdict(cfg))
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        logger.log(f"device: {device} ({name})"
                   + ("" if mesh is None else f"; {mesh}"))

    _, _, _, trainer = (cfg.build(mesh=mesh) if mesh is not None
                        else cfg.build(device))
    exp_dir = os.path.join(args.log_dir, exp_name)
    # every rank of a mesh joins the gathers of a save or a dump; rank 0
    # writes the files
    ckpt = (Checkpointer(f"{exp_dir}/checkpoints", map_location=device,
                         writes=writes)
            if args.checkpoint or args.resume else None)
    resume = None
    if args.resume and ckpt.latest_step is not None:
        resume = ckpt.restore()
        if writes:
            logger.log(f"resumed full training state from checkpoint step "
                       f"{ckpt.latest_step}")
    sink = None
    if args.dump_trajs and cfg.trainer != "ppo":
        if TrajectorySink.available():
            sink = TrajectorySink(f"{exp_dir}/trajectories.bin" if writes
                                  else os.devnull)
        elif writes:
            logger.log("native trajsink unavailable; --dump-trajs ignored")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    try:
        if cfg.trainer == "ppo":
            _, _, history = trainer.train(gen, logger=logger,
                                          checkpointer=ckpt, resume=resume)
        else:
            _, history = trainer.train(gen, logger=logger, checkpointer=ckpt,
                                       traj_sink=sink, resume=resume)
    finally:
        if sink is not None:
            sink.flush()
            if writes:
                logger.log(f"trajectories.bin: {sink.written} records, "
                           f"{sink.dropped} dropped")
            sink.close()
        if own_mesh:
            mesh.close()
    if writes:
        logger.log("done.")
    return history


if __name__ == "__main__":
    main()
