"""Experiment CLI (counterpart of cadm_tpu/cli/run.py).

Examples:
  python -m cadm_tpu_torch.cli.run --preset halfcheetah_cadm_cem
  python -m cadm_tpu_torch.cli.run --preset cripple_ant_cadm_ensemble_cem \\
      --n-itr 2 --steps-per-itr 20 --env-horizon 10 --log-dir runs

Presets: halfcheetah_cadm_cem, hopper_cadm_cem, slim_humanoid_cadm_cem,
ant_cadm_ensemble_cem, cripple_ant_cadm_ensemble_cem (the reference's
values).

One flag per ``ExperimentConfig`` field overrides the preset; ``--device``
(default ``cuda``) picks the card or, for tests, ``cpu``. Writes
``<log-dir>/<exp-name>/progress.csv`` (one row per outer iteration),
``params.json`` and ``debug.log``. The reference's checkpoint, resume,
trajectory-dump and mesh flags are not offered by the port (argparse
rejects them).
"""
from __future__ import annotations

import argparse
import dataclasses
import typing

import torch

from cadm_tpu_torch.cli.presets import PRESETS, ExperimentConfig
from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.utils.logger import TabularLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--exp-name", default=None)
    p.add_argument("--log-dir", default="data")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
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


def main(argv=None):
    """Parse ``argv``, train, and return the list of metric rows."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)

    exp_name = args.exp_name or (args.preset
                                 or f"{cfg.env}_{cfg.model}_{cfg.planner}")
    logger = TabularLogger(args.log_dir, exp_name)
    logger.save_params(dataclasses.asdict(cfg))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.log(f"device: {device} ({name})")

    _, _, _, trainer = cfg.build(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    _, history = trainer.train(gen, logger=logger)
    logger.log("done.")
    return history


if __name__ == "__main__":
    main()
