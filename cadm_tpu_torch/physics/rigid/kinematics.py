"""Forward kinematics and Jacobian assembly, batch-first.

Counterpart of cadm_tpu/physics/rigid/kinematics.py. The tree walk is a
host loop over the static System's bodies; every quantity carries a leading
env axis (E, ...) instead of being vmapped per env. Every degree of freedom
is reduced to a world-space (axis, anchor, is_rotational) triple, so COM and
point Jacobians are dense masked einsums over (nb, nv)-shaped tensors.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from cadm_tpu_torch.physics.rigid import math3d
from cadm_tpu_torch.physics.rigid.system import FREE, HINGE, SLIDE, System

Tensor = torch.Tensor


def sys_tensors(sys: System, like: Tensor) -> SimpleNamespace:
    """The System's constants on ``like``'s device and in its dtype."""
    return _sys_tensors(sys, like.device, like.dtype)


@lru_cache(maxsize=None)
def _sys_tensors(sys: System, device: torch.device, dtype: torch.dtype
                 ) -> SimpleNamespace:
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    return SimpleNamespace(
        body_pos=t(sys.body_pos),
        body_quat=t(sys.body_quat),
        body_ipos=t(sys.body_ipos),
        body_iquat=t(sys.body_iquat),
        body_inertia=t(sys.body_inertia),
        body_mass=t(sys.body_mass),
        jnt_axis=t(sys.jnt_axis),
        jnt_pos=t(sys.jnt_pos),
        ancestry=t(sys.ancestry_mask()),
        is_rot=t(_dof_is_rot(sys)),
        dof_damping=t(sys.dof_damping),
        dof_armature=t(sys.dof_armature),
        gravity=t(sys.gravity),
        eye3=torch.eye(3, dtype=dtype, device=device),
    )


@dataclasses.dataclass
class FK:
    body_pos: Tensor     # (E,nb,3) frame origins, world
    body_rot: Tensor     # (E,nb,3,3) frame rotations, world
    com: Tensor          # (E,nb,3) body COM, world
    inertia_w: Tensor    # (E,nb,3,3) rotational inertia about COM, world axes
    dof_axis: Tensor     # (E,nv,3) world axis per dof
    dof_anchor: Tensor   # (E,nv,3) world anchor per dof (rotational dofs)


@dataclasses.dataclass
class FKVel(FK):
    """FK extended with body velocities and zero-q̈ bias accelerations:
    omega (world angular velocity), v_com (COM velocity), alpha0 (angular
    acceleration at q̈ = 0), a_com0 (COM acceleration at q̈ = 0), each
    (E, nb, 3)."""

    omega: Tensor
    v_com: Tensor
    alpha0: Tensor
    a_com0: Tensor


def world_inertia(sys: System, body_quat: Tensor) -> Tensor:
    """(E,nb,3,3) rotational inertias in world axes from body quaternions."""
    c = sys_tensors(sys, body_quat)
    R_i = math3d.quat_to_mat(math3d.quat_mul(body_quat, c.body_iquat))
    return torch.einsum("ebij,bj,ebkj->ebik", R_i, c.body_inertia, R_i)


def forward_velocities(sys: System, qpos: Tensor, qvel: Tensor) -> FKVel:
    """FK + velocity/bias-acceleration propagation in one tree walk.

    qpos (E, nq), qvel (E, nv) → FKVel with a leading env axis.
    """
    nb, nv = sys.nb, sys.nv
    c = sys_tensors(sys, qpos)
    cross, qrot = math3d.cross, math3d.quat_rotate
    z3 = qpos.new_zeros(qpos.shape[0], 3)
    unit_quat = torch.cat([torch.ones_like(z3[:, :1]), z3], dim=-1)

    pos = [z3] * nb
    quat = [unit_quat] * nb
    w = [z3] * nb       # world angular velocity
    vx = [z3] * nb      # velocity of body frame origin
    al = [z3] * nb      # angular acceleration (q̈ = 0)
    ax = [z3] * nb      # linear acceleration of frame origin (q̈ = 0)
    dof_axis = [None] * nv
    dof_anchor = [None] * nv

    for b in range(1, nb):
        p = int(sys.body_parent[b])
        q = math3d.quat_mul(quat[p], c.body_quat[b])
        x = pos[p] + qrot(quat[p], c.body_pos[b])
        # fixed offset: origin is a material point of the parent
        rel = x - pos[p]
        om, alp = w[p], al[p]
        v = vx[p] + cross(om, rel)
        a = ax[p] + cross(alp, rel) + cross(om, cross(om, rel))

        for j in np.nonzero(sys.jnt_body == b)[0]:
            jt = int(sys.jnt_type[j])
            qadr = int(sys.jnt_qposadr[j])
            dadr = int(sys.jnt_dofadr[j])
            if jt == FREE:
                x = qpos[:, qadr: qadr + 3]
                q = qpos[:, qadr + 3: qadr + 7]
                q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                v = qvel[:, dadr: dadr + 3]
                om = qrot(q, qvel[:, dadr + 3: dadr + 6])
                alp = z3  # Σ q̇ᵢ (ω × aᵢ) = ω × ω = 0
                a = z3
                for i in range(3):
                    dof_axis[dadr + i] = c.eye3[i].expand_as(z3)
                    dof_anchor[dadr + i] = z3
                for i in range(3):
                    dof_axis[dadr + 3 + i] = qrot(q, c.eye3[i])
                    dof_anchor[dadr + 3 + i] = x
            elif jt == SLIDE:
                a_w = qrot(q, c.jnt_axis[j])
                s = (qpos[:, qadr] - float(sys.qpos0[qadr]))[:, None]
                sd = qvel[:, dadr: dadr + 1]
                x = x + a_w * s
                # axis is fixed in the pre-joint frame: ȧ = ω × a
                wxa = cross(om, a_w)
                v = v + wxa * s + a_w * sd
                a = (
                    a
                    + cross(alp, a_w) * s
                    + cross(om, wxa) * s
                    + 2.0 * wxa * sd
                )
                dof_axis[dadr] = a_w
                dof_anchor[dadr] = x
            elif jt == HINGE:
                a_w = qrot(q, c.jnt_axis[j])
                o_w = x + qrot(q, c.jnt_pos[j])
                th = qpos[:, qadr] - float(sys.qpos0[qadr])
                thd = qvel[:, dadr: dadr + 1]
                dq = math3d.quat_from_axis_angle(a_w, th)
                q = math3d.quat_mul(dq, q)
                # anchor point kinematics (material point of pre-joint frame)
                rel_o = o_w - x
                v_o = v + cross(om, rel_o)
                a_o = a + cross(alp, rel_o) + cross(om, cross(om, rel_o))
                x = o_w + qrot(dq, x - o_w)
                # post-joint angular state
                om_new = om + a_w * thd
                alp_new = alp + cross(om, a_w) * thd
                # new origin is a material point of the post-joint body
                rel_n = x - o_w
                v = v_o + cross(om_new, rel_n)
                a = (
                    a_o
                    + cross(alp_new, rel_n)
                    + cross(om_new, cross(om_new, rel_n))
                )
                om, alp = om_new, alp_new
                dof_axis[dadr] = a_w
                dof_anchor[dadr] = o_w
            else:
                raise NotImplementedError(f"joint type {jt}")
        pos[b], quat[b] = x, q
        w[b], vx[b], al[b], ax[b] = om, v, alp, a

    body_pos = torch.stack(pos, dim=1)
    body_quat = torch.stack(quat, dim=1)
    com = body_pos + qrot(body_quat, c.body_ipos)
    omega = torch.stack(w, dim=1)
    alpha0 = torch.stack(al, dim=1)
    rel_c = com - body_pos
    return FKVel(
        body_pos=body_pos,
        body_rot=math3d.quat_to_mat(body_quat),
        com=com,
        inertia_w=world_inertia(sys, body_quat),
        dof_axis=torch.stack(dof_axis, dim=1),
        dof_anchor=torch.stack(dof_anchor, dim=1),
        omega=omega,
        v_com=torch.stack(vx, dim=1) + cross(omega, rel_c),
        alpha0=alpha0,
        a_com0=(
            torch.stack(ax, dim=1)
            + cross(alpha0, rel_c)
            + cross(omega, cross(omega, rel_c))
        ),
    )


def _dof_is_rot(sys: System) -> np.ndarray:
    """(nv,) static bool — rotational (hinge-like) vs translational dofs."""
    out = np.zeros((sys.nv,), bool)
    for j in range(sys.nj):
        jt = int(sys.jnt_type[j])
        d = int(sys.jnt_dofadr[j])
        if jt == FREE:
            out[d + 3: d + 6] = True
        elif jt == HINGE:
            out[d] = True
    return out


def point_jacobians(
    sys: System, fk: FK, points: Tensor, point_body: Tensor
) -> Tensor:
    """Translational Jacobians of world points attached to bodies.

    points: (E, n, 3) world positions; point_body: (n,) static body indices,
    a long tensor on the points' device.
    Returns (E, n, 3, nv). Columns: rot dof → a × (p − o); trans dof → a.
    """
    c = sys_tensors(sys, points)
    mask = c.ancestry[point_body]
    is_rot = c.is_rot[:, None]
    a = fk.dof_axis[:, None]                          # (E, 1, nv, 3)
    rel = points[:, :, None, :] - fk.dof_anchor[:, None]  # (E, n, nv, 3)
    col = is_rot * math3d.cross(a, rel) + (1 - is_rot) * a
    return torch.einsum("envd,nv->endv", col, mask)


def com_jacobians(sys: System, fk: FK):
    """(Jlin, Jrot), each (E, nb, 3, nv), at body COMs."""
    c = sys_tensors(sys, fk.com)
    is_rot = c.is_rot[:, None]
    a = fk.dof_axis
    rel = fk.com[:, :, None, :] - fk.dof_anchor[:, None]   # (E, nb, nv, 3)
    lin_col = is_rot * math3d.cross(a[:, None], rel) + (1 - is_rot) * a[:, None]
    jlin = torch.einsum("ebvd,bv->ebdv", lin_col, c.ancestry)
    jrot = torch.einsum("evd,bv,v->ebdv", a, c.ancestry, c.is_rot)
    return jlin, jrot


def integrate_qpos(sys: System, qpos: Tensor, qvel: Tensor, dt: float) -> Tensor:
    """Semi-implicit position update (quat exponential for free joints)."""
    out = []
    for j in range(sys.nj):
        jt = int(sys.jnt_type[j])
        qadr = int(sys.jnt_qposadr[j])
        dadr = int(sys.jnt_dofadr[j])
        if jt == FREE:
            out.append(qpos[:, qadr: qadr + 3] + dt * qvel[:, dadr: dadr + 3])
            out.append(
                math3d.quat_integrate_local(
                    qpos[:, qadr + 3: qadr + 7], qvel[:, dadr + 3: dadr + 6], dt
                )
            )
        else:
            out.append(qpos[:, qadr: qadr + 1] + dt * qvel[:, dadr: dadr + 1])
    return torch.cat(out, dim=1)
