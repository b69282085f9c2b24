"""The port's committed System npz files equal what MJCF parsing gives.

``cadm_tpu_torch`` cannot parse MJCF (no mujoco where it runs), so
``scripts/make_torch_systems.py`` stores every System field per asset; this
test fails if an asset, the parser or ``System`` changed without the npz
files being regenerated.
"""
import dataclasses
import os

import numpy as np
import pytest

from cadm_tpu.physics.rigid.mjcf import system_from_mjcf
from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "cadm_tpu", "envs",
                         "assets")


@pytest.mark.parametrize("asset", ASSETS)
def test_npz_system_equals_mjcf(asset):
    with open(os.path.join(ASSET_DIR, asset + ".xml")) as f:
        ref = system_from_mjcf(f.read())
    port = load_system(asset)
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert type(a) is type(b) and a == b, name
    assert (port.nb, port.nv, port.nq, port.nu) == (ref.nb, ref.nv, ref.nq,
                                                    ref.nu)
