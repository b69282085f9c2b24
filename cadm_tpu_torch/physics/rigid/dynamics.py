"""Joint-space dynamics: mass matrix, bias forces, contacts, stepping.

Counterpart of cadm_tpu/physics/rigid/dynamics.py, batch-first: every
state tensor has a leading env axis and the static ``System`` is host data.

  M(q)   = Σ_b  m_b·J_linᵀJ_lin + J_rotᵀ I_w J_rot   (+ armature diag)
  c(q,v) = Σ_b  J_linᵀ m_b (v̇⁰_b − g) + J_rotᵀ (I_w ω̇⁰_b + ω_b × I_w ω_b)

Contacts are sphere/capsule-vs-plane with a velocity-level projected
Gauss–Seidel impulse solve. The reference's ``custom_vmap`` /
``platform_dependent`` dispatchers become one device check inside the two
kernel wrappers this module calls: ``ops.fk_kernel.full_dyn`` for the smooth
stage (kernel K2) and ``ops.pgs.pgs_solve`` for the contacts (kernel K1). A
CPU tensor takes their plain versions; a CUDA tensor launches the kernels.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from cadm_tpu_torch.ops import fk_kernel
from cadm_tpu_torch.ops.pgs import pgs_solve
from cadm_tpu_torch.physics.rigid.kinematics import (
    FK,
    FKVel,
    com_jacobians,
    integrate_qpos,
    point_jacobians,
    sys_tensors,
)
from cadm_tpu_torch.physics.rigid.math3d import cross
from cadm_tpu_torch.physics.rigid.system import (
    GEOM_CAPSULE,
    GEOM_SPHERE,
    HINGE,
    SLIDE,
    System,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class RigidParams:
    """Per-episode hidden dynamics parameters, one row per env."""

    mass_scale: Tensor     # (E,) multiplies all body masses & inertias
    damping_scale: Tensor  # (E,) multiplies all joint damping
    act_mask: Tensor       # (E, nu) 1.0 normally; 0.0 for crippled actuators

    @staticmethod
    def default(sys: System, n: int, device=None) -> "RigidParams":
        return RigidParams(
            mass_scale=torch.ones(n, device=device),
            damping_scale=torch.ones(n, device=device),
            act_mask=torch.ones(n, sys.nu, device=device),
        )


# --------------------------------------------------------------- dynamics --
def mass_matrix(sys: System, fk: FK, mass_scale: Tensor) -> Tensor:
    c = sys_tensors(sys, fk.com)
    jlin, jrot = com_jacobians(sys, fk)
    m = c.body_mass * mass_scale[:, None]                 # (E, nb)
    iw = fk.inertia_w * mass_scale[:, None, None, None]
    M = torch.einsum("ebdv,eb,ebdw->evw", jlin, m, jlin) + torch.einsum(
        "ebdv,ebdf,ebfw->evw", jrot, iw, jrot
    )
    M = 0.5 * (M + M.transpose(-1, -2))  # exact symmetry for the Cholesky
    return M + torch.diag(c.dof_armature)


def passive_forces(
    sys: System, qpos: Tensor, qvel: Tensor, damping_scale: Tensor
) -> Tensor:
    """Joint springs + joint-limit penalties (MuJoCo passive/limit forces).

    Joint damping is NOT applied here — ``step`` integrates it implicitly
    through the (M + h·diag(B)) system matrix, as MuJoCo's Euler integrator.
    """
    t = _dyn_tensors(sys, qpos)
    if t.qadr is None:
        return qpos.new_zeros(qpos.shape[0], sys.nv)
    q = qpos[:, t.qadr]
    v = qvel[:, t.dadr]
    f = -t.k_spring * (q - t.spring_ref)
    viol_hi = torch.clamp(q - t.hi, min=0.0)
    viol_lo = torch.clamp(t.lo - q, min=0.0)
    active = t.limited * ((viol_hi > 0) | (viol_lo > 0))
    f = f - sys.limit_stiffness * (viol_hi - viol_lo) * t.limited
    f = f - sys.limit_damping * v * active
    return f @ t.scatter


@lru_cache(maxsize=None)
def _act_matrix(sys: System) -> np.ndarray:
    """(nu, nv) static one-hot map from actuators onto their dofs."""
    mat = np.zeros((sys.nu, sys.nv))
    for a in range(sys.nu):
        mat[a, int(sys.jnt_dofadr[int(sys.act_joint[a])])] = 1.0
    return mat


@lru_cache(maxsize=None)
def _scalar_joint_meta(sys: System):
    """Static vectorized metadata for all 1-dof (hinge/slide) joints."""
    rows = [
        j for j in range(sys.nj) if int(sys.jnt_type[j]) in (HINGE, SLIDE)
    ]
    if not rows:
        return None
    qadr = np.array([int(sys.jnt_qposadr[j]) for j in rows])
    dadr = np.array([int(sys.jnt_dofadr[j]) for j in rows])
    k_spring = np.array([float(sys.jnt_stiffness[j]) for j in rows])
    spring_ref = np.array([float(sys.qpos_spring[q]) for q in qadr])
    lo = np.array([float(sys.jnt_range[j, 0]) for j in rows])
    hi = np.array([float(sys.jnt_range[j, 1]) for j in rows])
    limited = np.array([float(sys.jnt_limited[j]) for j in rows])
    scatter = np.zeros((len(rows), sys.nv))
    for i, d in enumerate(dadr):
        scatter[i, d] = 1.0
    return qadr, dadr, k_spring, spring_ref, lo, hi, limited, scatter


def _dyn_tensors(sys: System, like: Tensor) -> SimpleNamespace:
    """The static maps above on ``like``'s device and in its dtype."""
    return _dyn_tensors_on(sys, like.device, like.dtype)


@lru_cache(maxsize=None)
def _dyn_tensors_on(sys: System, device: torch.device, dtype: torch.dtype
                    ) -> SimpleNamespace:
    def cast(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)

    out = SimpleNamespace(
        act_matrix=cast(_act_matrix(sys)),
        ctrl_lo=cast(sys.act_ctrlrange[:, 0]),
        ctrl_hi=cast(sys.act_ctrlrange[:, 1]),
        act_gear=cast(sys.act_gear),
        qadr=None,
    )
    meta = _scalar_joint_meta(sys)
    if meta is not None:
        qadr, dadr, k, ref, lo, hi, limited, scatter = meta
        out.qadr, out.dadr = idx(qadr), idx(dadr)
        out.k_spring, out.spring_ref = cast(k), cast(ref)
        out.lo, out.hi, out.limited = cast(lo), cast(hi), cast(limited)
        out.scatter = cast(scatter)
    c_body, c_off, c_rad, c_mu = _contact_points(sys)
    out.c_body = idx(c_body)
    out.c_off, out.c_rad, out.c_mu = cast(c_off), cast(c_rad), cast(c_mu)
    return out


def actuation(sys: System, ctrl: Tensor, act_mask: Tensor) -> Tensor:
    """Joint torques from (clipped) controls through gears onto dofs."""
    t = _dyn_tensors(sys, ctrl)
    force = torch.clamp(ctrl, t.ctrl_lo, t.ctrl_hi) * t.act_gear * act_mask
    return force @ t.act_matrix


def bias_from_fkvel(sys: System, fkv: FKVel, mass_scale: Tensor) -> Tensor:
    """Generalized bias forces (E, nv) from the analytic propagation."""
    c = sys_tensors(sys, fkv.com)
    jlin, jrot = com_jacobians(sys, fkv)
    m = c.body_mass * mass_scale[:, None]
    iw = fkv.inertia_w * mass_scale[:, None, None, None]
    f_lin = m[..., None] * (fkv.a_com0 - c.gravity)
    torque = torch.einsum("ebdf,ebf->ebd", iw, fkv.alpha0) + cross(
        fkv.omega, torch.einsum("ebdf,ebf->ebd", iw, fkv.omega)
    )
    return torch.einsum("ebdv,ebd->ev", jlin, f_lin) + torch.einsum(
        "ebdv,ebd->ev", jrot, torque
    )


# --------------------------------------------------------------- contacts --
@lru_cache(maxsize=None)
def _contact_points(sys: System) -> Tuple[np.ndarray, ...]:
    """Static candidate contact list: (body, local offset, radius, μ).

    Spheres contribute their center; capsules contribute both axis endpoints
    (the standard two-point approximation of capsule-vs-plane).
    """
    bodies, offsets, radii, frictions = [], [], [], []
    for gi in range(sys.ng):
        gt = int(sys.geom_type[gi])
        b = int(sys.geom_body[gi])
        size = sys.geom_size[gi]
        gpos = sys.geom_pos[gi]
        Rg = _np_quat_mat(sys.geom_quat[gi])
        if gt == GEOM_SPHERE:
            bodies.append(b)
            offsets.append(gpos)
            radii.append(float(size[0]))
            frictions.append(float(sys.geom_friction[gi]))
        elif gt == GEOM_CAPSULE:
            half = float(size[1])
            for s in (-1.0, 1.0):
                bodies.append(b)
                offsets.append(gpos + Rg @ np.array([0.0, 0.0, s * half]))
                radii.append(float(size[0]))
                frictions.append(float(sys.geom_friction[gi]))
    if not bodies:
        return (np.zeros((0,), int), np.zeros((0, 3)), np.zeros((0,)),
                np.zeros((0,)))
    return (np.array(bodies, int), np.array(offsets), np.array(radii),
            np.array(frictions))


def _np_quat_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def contact_solve(
    sys: System,
    fk: FK,
    Minv: Tensor,
    v_pred: Tensor,
    dt: float,
    lam0: Optional[Tensor] = None,
    iters: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Velocity-level PGS impulse solve against the ground plane z=0.

    Returns (post-contact qvel (E,nv), impulses λ (E,3nc)). Inactive
    contacts (separation > 0) are clamped to zero impulse. The Delassus
    operator and the impulse back-substitution are batched matmuls; the
    sweeps are kernel K1 (``ops.pgs.pgs_solve``). ``lam0`` warm-starts the
    solve from the previous substep's λ; ``iters`` overrides the sweep count.
    """
    t = _dyn_tensors(sys, v_pred)
    nc = len(t.c_body)
    e = v_pred.shape[0]
    if nc == 0:
        return v_pred, v_pred.new_zeros(e, 0)

    p_world = fk.body_pos[:, t.c_body] + torch.einsum(
        "ecij,cj->eci", fk.body_rot[:, t.c_body], t.c_off
    )
    phi = p_world[..., 2] - t.c_rad  # signed separation (E, nc)
    contact_pt = p_world.clone()
    contact_pt[..., 2] -= t.c_rad

    Jp = point_jacobians(sys, fk, contact_pt, t.c_body)
    # rows: x/y tangent, z normal — plane frame is world-aligned
    Jc = Jp.reshape(e, 3 * nc, sys.nv)

    MinvJt = Minv @ Jc.transpose(-1, -2)                    # (E, nv, 3nc)
    A = Jc @ MinvJt + 1e-6 * torch.eye(3 * nc, dtype=Jc.dtype, device=Jc.device)
    b = (Jc @ v_pred[..., None])[..., 0]

    # Baumgarte push-out target on the normal component
    v_star = -sys.contact_stiffness / dt * torch.clamp(phi, max=0.0)
    active_mu = (phi < 0.0).to(phi.dtype) * t.c_mu

    if lam0 is None:
        lam0 = torch.zeros_like(b)
    # a warm-started impulse is only valid while its contact is active
    lam0 = lam0 * torch.repeat_interleave(active_mu > 0.0, 3, dim=1)
    lam = pgs_solve(
        A, b, v_star, active_mu, lam0,
        iters=sys.solver_iters if iters is None else iters,
    )
    return v_pred + (MinvJt @ lam[..., None])[..., 0], lam


# ------------------------------------------------------------------- step --
def step(
    sys: System,
    params: RigidParams,
    qpos: Tensor,
    qvel: Tensor,
    ctrl: Tensor,
    lam0: Optional[Tensor] = None,
    warm: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One physics substep (semi-implicit Euler, like MuJoCo's Euler).

    Returns (qpos, qvel, λ). ``lam0`` warm-starts the contact solve;
    ``warm=True`` additionally runs the reduced sys.solver_iters_warm sweeps.
    """
    # smooth stage (FK, mass matrix, bias, actuation/passive, implicit
    # damping, SPD inverse, v_pred): kernel K2 on CUDA, composed on CPU
    fk, Minv, v_pred = fk_kernel.full_dyn(
        sys, qpos, qvel, ctrl,
        params.mass_scale, params.damping_scale, params.act_mask,
    )
    v_post, lam = contact_solve(
        sys, fk, Minv, v_pred, sys.dt, lam0,
        iters=sys.solver_iters_warm if warm else None,
    )
    return integrate_qpos(sys, qpos, v_post, sys.dt), v_post, lam


def step_n(
    sys: System,
    params: RigidParams,
    qpos: Tensor,
    qvel: Tensor,
    ctrl: Tensor,
    n: int,
) -> Tuple[Tensor, Tensor]:
    """``n`` substeps under one control (the env frame_skip loop).

    The first substep solves contacts cold at the full sweep count; the rest
    warm-start from the previous λ and run sys.solver_iters_warm sweeps.
    """
    qpos, qvel, lam = step(sys, params, qpos, qvel, ctrl)
    for _ in range(n - 1):
        qpos, qvel, lam = step(sys, params, qpos, qvel, ctrl, lam, warm=True)
    return qpos, qvel
