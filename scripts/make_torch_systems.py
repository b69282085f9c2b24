"""Record mujoco's compilation of the four MJCF assets as npz data.

``cadm_tpu_torch`` compiles its Systems from its own copies of the MJCF
assets with its own compiler (``cadm_tpu_torch/physics/rigid/mjcf.py``), as
it runs where ``mujoco`` is not installed. This script compiles the assets
with the JAX package's ``system_from_mjcf`` (through mujoco, the same call
``cadm_tpu.envs.rigid_base.load_system`` makes) and stores every ``System``
field, array or scalar, in one ``.npz`` per asset under
``cadm_tpu_torch/envs/assets/``: the record that ``tests/test_torch_mjcf.py``
and ``chip_smoke.py`` (phase 17, on a machine without mujoco) hold the
port's compiler to (``cadm_tpu_torch.envs.rigid_base.npz_system``).

Run from the repository root after an asset or ``System`` changes:

    python scripts/make_torch_systems.py

``tests/test_torch_systems.py`` checks that the committed files still equal
what this script would write.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cadm_tpu.physics.rigid.mjcf import system_from_mjcf  # noqa: E402

ASSETS = ("half_cheetah.xml", "hopper.xml", "ant.xml", "slim_humanoid.xml")
SRC_DIR = os.path.join(ROOT, "cadm_tpu", "envs", "assets")
OUT_DIR = os.path.join(ROOT, "cadm_tpu_torch", "envs", "assets")


def system_arrays(sys_) -> dict:
    """Every System field as a numpy array (scalars as 0-d arrays)."""
    return {
        f.name: np.asarray(getattr(sys_, f.name))
        for f in dataclasses.fields(sys_)
    }


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    for asset in ASSETS:
        with open(os.path.join(SRC_DIR, asset)) as f:
            sys_ = system_from_mjcf(f.read())
        out = os.path.join(OUT_DIR, asset.replace(".xml", ".npz"))
        np.savez(out, **system_arrays(sys_))
        print(f"wrote {os.path.relpath(out, ROOT)}: nb={sys_.nb} nv={sys_.nv}")


if __name__ == "__main__":
    main()
