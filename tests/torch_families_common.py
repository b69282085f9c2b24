"""Shared set-up of the env-family parity tests (test_torch_env_families.py,
test_torch_env_humanoid.py).

Both packages get the same float32 states, controls and hidden params, drawn
with numpy. The JAX reference of one control step is the JAX package's own
substep pieces (its smooth stage, ``contact_solve`` and ``integrate_qpos``,
as ``physics/rigid/dynamics.py::step_n`` composes them: one cold solve, then
warm-started ones), each jitted once per System and mapped over envs with
``lax.map``. Mapping keeps the JAX package on its per-env path: under
``vmap`` its dispatchers would also trace the TPU kernels, and the smooth
stage would compile twice (cold and warm substep), which costs slim_humanoid
about a minute of compile time on the CPU.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cadm_tpu.envs import make as jax_make
from cadm_tpu.envs.ant import CrippleParams as JaxCrippleParams
from cadm_tpu.envs.rigid_base import MassDampingParams as JaxMDParams
from cadm_tpu.envs.rigid_base import RigidPhys as JaxPhys
from cadm_tpu.envs.rigid_base import load_system as jax_load_system
from cadm_tpu.physics.rigid import dynamics as jdyn
from cadm_tpu.physics.rigid.kinematics import integrate_qpos as jax_integrate
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.ant import ANT_INIT_QPOS, LEG_ACTUATORS, CrippleParams
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from cadm_tpu_torch.physics.rigid import dynamics as tdyn

# test_torch_physics.py's tolerances: float32 physics through the substeps
# of a control step, summed in another order than XLA's
QPOS_ATOL, QVEL_ATOL = 1e-5, 1e-4
# obs are qpos/qvel and rewards their linear functions (test_torch_env.py)
OBS_ATOL, REW_ATOL = 1e-4, 1e-4
FAMILIES = ("hopper", "ant", "cripple_ant", "slim_humanoid")
N = 8
# the moderate and extreme scale sets (envs/ranges.py's CANONICAL_SET) and
# the (mass, damping) corners of the extreme one
EVAL_SCALES = (0.2, 0.3, 0.4, 0.5, 1.5, 1.6, 1.7, 1.8)
CORNERS = ((0.2, 1.8), (1.8, 0.2), (0.2, 0.2), (1.8, 1.8))


def eval_scales(rng, n: int):
    """(mass_scale, damping_scale), each (n,): the first n − 4 drawn from
    EVAL_SCALES, the last 4 the CORNERS."""
    ms, ds = rng.choice(EVAL_SCALES, (2, n - len(CORNERS)))
    cm, cd = np.array(CORNERS).T
    return np.concatenate([ms, cm]), np.concatenate([ds, cd])


def family_batch(name: str, seed: int = 0, eval_range: bool = False):
    """(qpos, qvel, ctrl, params) as float32 numpy: near-initial poses with
    the root lowered step by step from its start height (so that feet and
    limbs reach the ground), unit root quaternions, random velocities and
    controls; params are (mass_scale, damping_scale) or, for cripple_ant,
    act_mask (N, nu) with one leg zeroed per env. ``eval_range`` draws the
    scales with ``eval_scales`` (the corners on the lowest roots) instead
    of from the train set."""
    env = make(name, device="cpu")
    sys_ = env.sys
    rng = np.random.RandomState(seed)
    base = ANT_INIT_QPOS if name in ("ant", "cripple_ant") \
        else sys_.default_qpos()
    qpos = base + rng.uniform(-0.05, 0.05, (N, sys_.nq))
    zi = 1 if name == "hopper" else 2          # the root's height coordinate
    qpos[:, zi] -= np.linspace(0.0, 0.15, N)
    if name != "hopper":
        qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
    qvel = rng.uniform(-0.5, 0.5, (N, sys_.nv))
    ctrl = rng.uniform(-1, 1, (N, sys_.nu))
    if name == "cripple_ant":
        mask = np.ones((N, sys_.nu))
        for e in range(N):
            mask[e, LEG_ACTUATORS[e % 4]] = 0.0
        params = (mask,)
    elif eval_range:
        params = eval_scales(rng, N)
    else:
        params = (rng.choice([0.75, 1.0, 1.25], N),
                  rng.choice([0.75, 1.0, 1.25], N))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(qpos), f32(qvel), f32(ctrl), tuple(map(f32, params))


def port_params(name, params):
    t = tuple(map(torch.from_numpy, params))
    return CrippleParams(*t) if name == "cripple_ant" else MassDampingParams(*t)


def jax_params(name, params):
    t = tuple(map(jnp.asarray, params))
    return JaxCrippleParams(*t) if name == "cripple_ant" else JaxMDParams(*t)


@lru_cache(maxsize=None)
def _jax_substeps(asset):
    """Jitted (smooth, contact cold, contact warm, integrate) over envs."""
    sys_ = jax_load_system(asset)
    smooth = jdyn._smooth_dispatch(sys_)

    def mapped(fn):
        return jax.jit(lambda *a: jax.lax.map(lambda x: fn(*x), a))

    def contact(iters):
        return mapped(lambda fk, minv, vp, lam: jdyn.contact_solve(
            sys_, fk, minv, vp, sys_.dt, lam, iters=iters))

    return (mapped(smooth), contact(sys_.solver_iters),
            contact(sys_.solver_iters_warm),
            mapped(lambda q, v: jax_integrate(sys_, q, v, sys_.dt)))


def jax_step_phys(name, params, qpos, qvel, ctrl):
    """One control step of the JAX package's ``step_phys`` (``step_n`` of
    ``frame_skip`` substeps under the family's ``rigid_params``)."""
    jenv = jax_make(name)
    rp = jax.vmap(jenv.rigid_params)(jax_params(name, params))
    n = qpos.shape[0]
    ms, ds, am = (jnp.broadcast_to(x, s) for x, s in (
        (rp.mass_scale, (n,)), (rp.damping_scale, (n,)),
        (rp.act_mask, (n, jenv.sys.nu))))
    smooth, cold, warm, integrate = _jax_substeps(jenv.asset)
    q, v = jnp.asarray(qpos), jnp.asarray(qvel)
    lam = jnp.zeros((n, 3 * len(jdyn._contact_points(jenv.sys)[0])))
    for i in range(jenv.frame_skip):
        fk, minv, vp = smooth(q, v, jnp.asarray(ctrl), ms, ds, am)
        v, lam = (warm if i else cold)(fk, minv, vp, lam)
        q = integrate(q, v)
    return np.asarray(q), np.asarray(v)


def active_contacts(name, qpos):
    """Active contacts per env at ``qpos`` (the port's contact geometry)."""
    sys_ = make(name, device="cpu").sys
    q = torch.from_numpy(qpos)
    n = q.shape[0]
    fk, _, _ = tdyn.fk_kernel.full_dyn(
        sys_, q, torch.zeros(n, sys_.nv), torch.zeros(n, sys_.nu),
        torch.ones(n), torch.ones(n), torch.ones(n, sys_.nu))
    c_body, c_off, c_rad, _ = tdyn._contact_points(sys_)
    p = fk.body_pos[:, c_body] + torch.einsum(
        "ecij,cj->eci", fk.body_rot[:, c_body], torch.tensor(c_off).float())
    return (p[..., 2] < torch.tensor(c_rad).float()).sum(1)


def step_matches_jax(name, control_steps=3, eval_range=False):
    """``control_steps`` of the port's ``step_phys`` against the JAX step
    (on ``family_batch(name, eval_range=...)``, a second seed for the eval
    range); returns the active-contact counts of the start states."""
    qpos, qvel, ctrl, params = family_batch(name, int(eval_range), eval_range)
    env = make(name, device="cpu")
    phys = RigidPhys(torch.from_numpy(qpos), torch.from_numpy(qvel))
    tparams, tctrl = port_params(name, params), torch.from_numpy(ctrl)
    jq, jv = qpos, qvel
    for _ in range(control_steps):
        phys = env.step_phys(tparams, phys, tctrl)
        jq, jv = jax_step_phys(name, params, jq, jv, ctrl)
    np.testing.assert_allclose(phys.qpos.numpy(), jq, atol=QPOS_ATOL)
    np.testing.assert_allclose(phys.qvel.numpy(), jv, atol=QVEL_ATOL)
    return active_contacts(name, qpos)


def jax_phys(qpos, qvel):
    return JaxPhys(jnp.asarray(qpos), jnp.asarray(qvel))
