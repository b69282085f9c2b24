"""slim_humanoid's ``step_phys`` against the JAX package's, three control
steps on the same numpy-drawn states (tests/torch_families_common.py). In a
file of its own: compiling the JAX reference's smooth stage at nv = 23 takes
~20 s on the CPU.

At moderate and extreme scales (one and three steps) the reference is the
JAX package's step run in float64, stored by
``scripts/make_eval_scale_references.py``: at the (mass 1.8, damping 0.2)
corner its float32 step is itself 1.33e-4 from that answer in qvel (|qvel|
≈ 14, M's condition number ≈ 3e3), beyond QVEL_ATOL, while the port's
float32 step is within 4.8e-5 of it."""
import os

import numpy as np
import pytest
import torch

from tests.torch_families_common import (
    QPOS_ATOL,
    QVEL_ATOL,
    CORNERS,
    active_contacts,
    family_batch,
    port_params,
    step_matches_jax,
)
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.rigid_base import RigidPhys

X64_REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                             "slim_humanoid_eval_scales_x64.npz")


def test_step_phys_matches_jax():
    active = step_matches_jax("slim_humanoid")
    assert active.max() >= 2  # the contact solve does real work


@pytest.mark.parametrize("control_steps", [1, 3])
def test_step_phys_matches_jax_at_eval_scales(control_steps):
    """Mass and damping scales from the moderate and extreme sets, the
    extreme corners included, against the JAX package's float64 step."""
    name = "slim_humanoid"
    qpos, qvel, ctrl, params = family_batch(name, 1, eval_range=True)
    with np.load(X64_REFERENCE) as ref:
        ref = dict(ref)
    for k, x in zip(("qpos", "qvel", "ctrl", "mass_scale", "damping_scale"),
                    (qpos, qvel, ctrl, *params)):
        np.testing.assert_array_equal(ref[k], x, err_msg=k)  # the same batch
    assert sorted(zip(params[0][-4:].tolist(), params[1][-4:].tolist())) == \
        sorted(map(tuple, np.float32(CORNERS).tolist()))
    env = make(name, device="cpu")
    phys = RigidPhys(torch.from_numpy(qpos), torch.from_numpy(qvel))
    for _ in range(control_steps):
        phys = env.step_phys(port_params(name, params), phys,
                             torch.from_numpy(ctrl))
    np.testing.assert_allclose(phys.qpos.numpy(), ref[f"qpos_{control_steps}"],
                               atol=QPOS_ATOL)
    np.testing.assert_allclose(phys.qvel.numpy(), ref[f"qvel_{control_steps}"],
                               atol=QVEL_ATOL)
    active = active_contacts(name, qpos)
    assert active.max() >= 2 and active[-4:].sum() > 0  # corners in contact
