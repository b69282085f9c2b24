"""K3's plain version (``cadm_tpu_torch.ops.fk_kernel.fk_vel`` on CPU
tensors) against the Pallas FK-velocity kernel ``fk_vel_pallas`` run in
interpret mode, at the JAX test's own tolerance (tests/test_fk_kernel.py:54).
The CUDA kernel is compared with this plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.rigid_base import load_system as jax_load_system
from cadm_tpu.ops.fk_kernel import fk_vel_pallas
from cadm_tpu.physics.rigid import math3d as jmath3d
from cadm_tpu_torch.envs.rigid_base import load_system
from cadm_tpu_torch.ops import fk_kernel
from tests.test_torch_kernels_plain import smooth_state

FK_VEL_ATOL = 2e-6


@pytest.mark.parametrize("asset", ["half_cheetah", "ant", "hopper"])
def test_fk_vel_plain_matches_pallas_interpret(asset):
    """Every field, and the quaternions through their rotation matrices."""
    jsys = jax_load_system(asset + ".xml")
    qpos, qvel = smooth_state(jsys)[:2]
    d = fk_vel_pallas(jsys, jnp.asarray(qpos), jnp.asarray(qvel),
                      interpret=True)
    before = fk_kernel.fk_vel_launches
    fkv = fk_kernel.fk_vel(load_system(asset), torch.from_numpy(qpos),
                           torch.from_numpy(qvel))
    assert fk_kernel.fk_vel_launches == before
    for name, key in (("body_pos", "pos"), ("com", "com"), ("omega", "omega"),
                      ("v_com", "v_com"), ("alpha0", "alpha0"),
                      ("a_com0", "a_com0"), ("dof_axis", "dof_axis"),
                      ("dof_anchor", "dof_anchor")):
        np.testing.assert_allclose(getattr(fkv, name).numpy(),
                                   np.asarray(d[key]), atol=FK_VEL_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(
        fkv.body_rot.numpy(), np.asarray(jmath3d.quat_to_mat(d["quat"])),
        atol=FK_VEL_ATOL)
    assert fk_kernel.fk_width(load_system(asset)) == sum(
        np.asarray(v).shape[1] * np.asarray(v).shape[2] for v in d.values())
