"""The port's rigid engine (``step_n``) against the JAX engine at HalfCheetah.

Both packages get the same float32 states, controls and hidden params, drawn
with numpy; some envs are lowered into the ground so that 1–6 of the 16
contacts are active and the contact solve (K1's plain version, warm-started
over the 5 substeps) does real work. The hidden scales come from the train
set and, in a second batch, from the moderate and extreme sets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.rigid_base import load_system as jax_load_system
from cadm_tpu.physics.rigid import dynamics as jdyn
from cadm_tpu_torch.envs.rigid_base import load_system
from cadm_tpu_torch.physics.rigid import dynamics as tdyn
from tests.torch_families_common import CORNERS, active_contacts, eval_scales

# Tolerance: float32 through 5 substeps of FK, an SPD inverse and up to 15
# PGS sweeps, summed in another order than XLA's. Measured max differences
# are ~2e-7 (qpos) and ~2e-6 (qvel, |qvel| up to ~9) over three control
# steps; the bounds below leave a 50x margin.
QPOS_ATOL, QVEL_ATOL = 1e-5, 1e-4


def cheetah_batch(n=8, seed=0, eval_range=False):
    """``eval_range``: mass and damping scales from the moderate and extreme
    sets, the extreme corners on the lowest roots (``eval_scales``)."""
    sys_ = jax_load_system("half_cheetah.xml")
    rng = np.random.RandomState(seed)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (n, sys_.nq))
    qpos[:, 1] -= np.linspace(0.0, 0.3, n)  # rootz: from airborne to in contact
    qvel = rng.uniform(-1, 1, (n, sys_.nv))
    ctrl = rng.uniform(-1, 1, (n, sys_.nu))
    if eval_range:
        ms, ds = eval_scales(rng, n)
    else:
        ms = rng.choice([0.75, 1.0, 1.25], n)
        ds = rng.choice([0.75, 1.0, 1.25], n)
    return sys_, [x.astype(np.float32) for x in (qpos, qvel, ctrl, ms, ds)]


@jax.jit
def _jax_step_n(q, v, c, m, d):
    jsys = jax_load_system("half_cheetah.xml")
    return jax.vmap(lambda *a: jdyn.step_n(
        jsys, jdyn.RigidParams(a[3], a[4], jnp.ones(jsys.nu)), *a[:3], 5
    ))(q, v, c, m, d)


def test_batch_has_ground_contacts():
    _, (qpos, qvel, ctrl, ms, ds) = cheetah_batch()
    sys_ = load_system("half_cheetah")
    fk, _, _ = tdyn.fk_kernel.full_dyn(
        sys_, *map(torch.from_numpy, (qpos, qvel, ctrl, ms, ds)),
        torch.ones(len(ms), sys_.nu),
    )
    c_body, c_off, c_rad, _ = tdyn._contact_points(sys_)
    p = fk.body_pos[:, c_body] + torch.einsum(
        "ecij,cj->eci", fk.body_rot[:, c_body], torch.tensor(c_off).float())
    active = (p[..., 2] < torch.tensor(c_rad).float()).sum(1)
    assert active[0] == 0 and active[-1] >= 4


def test_eval_batch_has_ground_contacts():
    _, (qpos, *_, ms, ds) = cheetah_batch(seed=1, eval_range=True)
    active = active_contacts("half_cheetah", qpos)
    assert active[-4:].min() >= 1 and active.max() >= 4
    assert sorted(zip(ms[-4:].tolist(), ds[-4:].tolist())) == sorted(
        map(tuple, np.float32(CORNERS).tolist()))


@pytest.mark.parametrize("control_steps", [1, 3])
def test_step_n_matches_jax(control_steps):
    step_n_matches_jax(control_steps)


@pytest.mark.parametrize("control_steps", [1, 3])
def test_step_n_matches_jax_at_eval_scales(control_steps):
    """Moderate and extreme scales, the extreme corners included (M⁻¹
    grows ×5 at mass 0.2)."""
    step_n_matches_jax(control_steps, eval_range=True)


def step_n_matches_jax(control_steps, eval_range=False):
    _, (qpos, qvel, ctrl, ms, ds) = cheetah_batch(seed=int(eval_range),
                                                   eval_range=eval_range)
    tsys = load_system("half_cheetah")

    jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
    tq, tv = torch.from_numpy(qpos), torch.from_numpy(qvel)
    params = tdyn.RigidParams(torch.from_numpy(ms), torch.from_numpy(ds),
                              torch.ones(len(ms), tsys.nu))
    for _ in range(control_steps):
        jq, jv = _jax_step_n(jq, jv, jnp.asarray(ctrl), jnp.asarray(ms),
                             jnp.asarray(ds))
        tq, tv = tdyn.step_n(tsys, params, tq, tv, torch.from_numpy(ctrl), 5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=QPOS_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=QVEL_ATOL)


def test_contact_solve_warm_start_is_masked_and_inactive_is_zero():
    """λ0 of an inactive contact is dropped; its impulse stays exactly 0."""
    _, (qpos, qvel, ctrl, ms, ds) = cheetah_batch()
    sys_ = load_system("half_cheetah")
    args = [torch.from_numpy(x) for x in (qpos, qvel, ctrl, ms, ds)]
    fk, minv, v_pred = tdyn.fk_kernel.full_dyn(sys_, *args,
                                               torch.ones(len(ms), sys_.nu))
    lam0 = torch.ones(len(ms), 3 * len(tdyn._contact_points(sys_)[0]))
    _, lam = tdyn.contact_solve(sys_, fk, minv, v_pred, sys_.dt, lam0, iters=6)
    assert torch.all(lam[0] == 0.0)  # env 0 is airborne
    assert torch.any(lam[-1] != 0.0)
