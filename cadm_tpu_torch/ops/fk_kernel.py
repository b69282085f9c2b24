"""Fused smooth-dynamics step: kernel K2 and its plain version.

Replaces the Pallas TPU kernel ``cadm_tpu/ops/fk_kernel.py::full_dyn_pallas``
(body ``_full_dyn_kernel``). ``full_dyn`` launches the CUDA kernel of
``csrc/full_dyn.cu`` for a CUDA tensor and runs ``full_dyn_plain`` — the
reference's composed smooth stage ``pure_one``
(``cadm_tpu/physics/rigid/dynamics.py:413-426``) — for a CPU tensor. The
kernel reads the System from a packed table (``SysTable``, one layout for
every System), so the same binary serves all four rigid families; what bounds
it on the card is described in ``csrc/full_dyn.cu``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from cadm_tpu_torch.ops import _build
from cadm_tpu_torch.ops.linalg import spd_inverse
from cadm_tpu_torch.physics.rigid import kinematics
from cadm_tpu_torch.physics.rigid.math3d import quat_to_mat
from cadm_tpu_torch.physics.rigid.system import System

Tensor = torch.Tensor

# same bound as the reference dispatcher (cadm_tpu/ops/fk_kernel.py); every
# rigid family qualifies (nv 6/9/14/23)
FULL_DYN_MAX_NV = 24
NB_MAX, NJ_MAX, NV_MAX, NU_MAX = 16, 24, 24, 24

# Launches of the CUDA kernel in this process (read and reset by
# chip_smoke.py to show that the main path went through the kernel).
launches = 0

_i, _f = ctypes.c_int32, ctypes.c_float


class SysTable(ctypes.Structure):
    """Host mirror of ``struct SysTable`` in csrc/full_dyn.cu (same order)."""

    _fields_ = [
        ("nb", _i), ("nj", _i), ("nq", _i), ("nv", _i), ("nu", _i),
        ("pad_", _i),
        ("body_parent", _i * NB_MAX),
        ("body_jnt_start", _i * NB_MAX),
        ("body_jnt_num", _i * NB_MAX),
        ("jnt_type", _i * NJ_MAX),
        ("jnt_qposadr", _i * NJ_MAX),
        ("jnt_dofadr", _i * NJ_MAX),
        ("jnt_limited", _i * NJ_MAX),
        ("dof_is_rot", _i * NV_MAX),
        ("dof_bodies", ctypes.c_uint32 * NV_MAX),
        ("act_dof", _i * NU_MAX),
        ("body_pos", _f * 3 * NB_MAX),
        ("body_quat", _f * 4 * NB_MAX),
        ("body_ipos", _f * 3 * NB_MAX),
        ("body_iquat", _f * 4 * NB_MAX),
        ("body_inertia", _f * 3 * NB_MAX),
        ("body_mass", _f * NB_MAX),
        ("jnt_axis", _f * 3 * NJ_MAX),
        ("jnt_pos", _f * 3 * NJ_MAX),
        ("jnt_range", _f * 2 * NJ_MAX),
        ("jnt_stiffness", _f * NJ_MAX),
        ("jnt_qpos0", _f * NJ_MAX),
        ("jnt_qpos_spring", _f * NJ_MAX),
        ("dof_damping", _f * NV_MAX),
        ("dof_armature", _f * NV_MAX),
        ("act_gear", _f * NU_MAX),
        ("act_lo", _f * NU_MAX),
        ("act_hi", _f * NU_MAX),
        ("gravity", _f * 3),
        ("dt", _f), ("limit_stiffness", _f), ("limit_damping", _f),
    ]


def pack_system(sys: System) -> SysTable:
    """The System as the kernel's table (raises beyond the table's maxima)."""
    nb, nj, nv, nu = sys.nb, sys.nj, sys.nv, sys.nu
    if nb > NB_MAX or nj > NJ_MAX or nv > min(NV_MAX, FULL_DYN_MAX_NV) \
            or nu > NU_MAX:
        raise ValueError(f"System too large for the K2 table: nb={nb} nj={nj} "
                         f"nv={nv} nu={nu}")
    t = SysTable(nb=nb, nj=nj, nq=sys.nq, nv=nv, nu=nu)
    for b in range(nb):
        joints = np.nonzero(sys.jnt_body == b)[0]
        # the walk applies a body's joints in order: they must be contiguous
        if len(joints) and not np.array_equal(
                joints, np.arange(joints[0], joints[0] + len(joints))):
            raise ValueError(f"joints of body {b} are not contiguous")
        t.body_parent[b] = int(sys.body_parent[b])
        t.body_jnt_start[b] = int(joints[0]) if len(joints) else 0
        t.body_jnt_num[b] = len(joints)
        t.body_mass[b] = float(sys.body_mass[b])
        for k in range(3):
            t.body_pos[b][k] = float(sys.body_pos[b, k])
            t.body_ipos[b][k] = float(sys.body_ipos[b, k])
            t.body_inertia[b][k] = float(sys.body_inertia[b, k])
        for k in range(4):
            t.body_quat[b][k] = float(sys.body_quat[b, k])
            t.body_iquat[b][k] = float(sys.body_iquat[b, k])
    for j in range(nj):
        qa = int(sys.jnt_qposadr[j])
        t.jnt_type[j] = int(sys.jnt_type[j])
        t.jnt_qposadr[j] = qa
        t.jnt_dofadr[j] = int(sys.jnt_dofadr[j])
        t.jnt_limited[j] = int(bool(sys.jnt_limited[j]))
        t.jnt_stiffness[j] = float(sys.jnt_stiffness[j])
        t.jnt_qpos0[j] = float(sys.qpos0[qa])
        t.jnt_qpos_spring[j] = float(sys.qpos_spring[qa])
        for k in range(3):
            t.jnt_axis[j][k] = float(sys.jnt_axis[j, k])
            t.jnt_pos[j][k] = float(sys.jnt_pos[j, k])
        for k in range(2):
            t.jnt_range[j][k] = float(sys.jnt_range[j, k])
    mask = sys.ancestry_mask()
    is_rot = kinematics._dof_is_rot(sys)
    for d in range(nv):
        t.dof_is_rot[d] = int(is_rot[d])
        t.dof_bodies[d] = sum(1 << b for b in np.nonzero(mask[:, d])[0])
        t.dof_damping[d] = float(sys.dof_damping[d])
        t.dof_armature[d] = float(sys.dof_armature[d])
    for a in range(nu):
        t.act_dof[a] = int(sys.jnt_dofadr[int(sys.act_joint[a])])
        t.act_gear[a] = float(sys.act_gear[a])
        t.act_lo[a] = float(sys.act_ctrlrange[a, 0])
        t.act_hi[a] = float(sys.act_ctrlrange[a, 1])
    for k in range(3):
        t.gravity[k] = float(sys.gravity[k])
    t.dt = float(sys.dt)
    t.limit_stiffness = float(sys.limit_stiffness)
    t.limit_damping = float(sys.limit_damping)
    return t


@lru_cache(maxsize=None)
def _device_table(sys: System, device: torch.device) -> Tensor:
    """The packed table as a uint8 tensor on ``device`` (one per pair)."""
    expect = _build.lib().cadm_sys_table_bytes()
    if ctypes.sizeof(SysTable) != expect:
        raise RuntimeError(f"SysTable layout mismatch: host "
                           f"{ctypes.sizeof(SysTable)} B, device {expect} B")
    raw = bytearray(pack_system(sys))
    return torch.frombuffer(raw, dtype=torch.uint8).to(device)


def row_layout(sys: System) -> Tuple[Dict[str, Tuple[int, int, int]], int]:
    """Offsets (start, rows, comps) of each output field in one env's row."""
    nb, nv = sys.nb, sys.nv
    fields = [
        ("pos", nb, 3), ("quat", nb, 4), ("com", nb, 3), ("omega", nb, 3),
        ("v_com", nb, 3), ("alpha0", nb, 3), ("a_com0", nb, 3),
        ("dof_axis", nv, 3), ("dof_anchor", nv, 3), ("minv", nv, nv),
        ("v_pred", nv, 1),
    ]
    off, layout = 0, {}
    for name, rows, comps in fields:
        layout[name] = (off, rows, comps)
        off += rows * comps
    return layout, off


def full_dyn_plain(
    sys: System, qpos: Tensor, qvel: Tensor, ctrl: Tensor,
    mass_scale: Tensor, damping_scale: Tensor, act_mask: Tensor,
) -> Tuple[kinematics.FKVel, Tensor, Tensor]:
    """The composed smooth stage (the reference's ``pure_one``), batched."""
    from cadm_tpu_torch.physics.rigid import dynamics as rdyn

    c = kinematics.sys_tensors(sys, qpos)
    fkv = kinematics.forward_velocities(sys, qpos, qvel)
    M = rdyn.mass_matrix(sys, fkv, mass_scale)
    bias = rdyn.bias_from_fkvel(sys, fkv, mass_scale)
    B = c.dof_damping * damping_scale[:, None]
    tau = (
        rdyn.actuation(sys, ctrl, act_mask)
        + rdyn.passive_forces(sys, qpos, qvel, damping_scale)
        - bias
        - B * qvel
    )
    Minv = spd_inverse(M + sys.dt * torch.diag_embed(B))
    v_pred = qvel + sys.dt * (Minv @ tau[..., None])[..., 0]
    return fkv, Minv, v_pred


def launch(
    sys: System, qpos: Tensor, qvel: Tensor, ctrl: Tensor,
    mass_scale: Tensor, damping_scale: Tensor, act_mask: Tensor,
) -> Tensor:
    """Launch kernel K2 on CUDA tensors → merged rows (E, width) laid out
    as ``row_layout(sys)``."""
    global launches
    args = (qpos, qvel, ctrl, mass_scale, damping_scale, act_mask)
    if sys.nv > FULL_DYN_MAX_NV:
        raise ValueError(f"full_dyn: nv={sys.nv} > {FULL_DYN_MAX_NV}")
    e = qpos.shape[0]
    shapes = ((e, sys.nq), (e, sys.nv), (e, sys.nu), (e,), (e,), (e, sys.nu))
    if any(tuple(x.shape) != s for x, s in zip(args, shapes)):
        raise ValueError(f"full_dyn shapes {[tuple(x.shape) for x in args]}, "
                         f"expected {list(shapes)}")
    args = tuple(x.contiguous() for x in args)
    _build.require_cuda_f32("full_dyn", *args)
    width = row_layout(sys)[1]
    out = torch.empty(e, width, device=qpos.device, dtype=torch.float32)
    code = _build.lib().cadm_full_dyn(
        _device_table(sys, qpos.device).data_ptr(),
        *(x.data_ptr() for x in args), out.data_ptr(), e, width,
        _build.stream_handle(qpos),
    )
    _build.check(code, "full_dyn")
    launches += 1
    return out


def full_dyn(
    sys: System, qpos: Tensor, qvel: Tensor, ctrl: Tensor,
    mass_scale: Tensor, damping_scale: Tensor, act_mask: Tensor,
) -> Tuple[kinematics.FKVel, Tensor, Tensor]:
    """Smooth stage of one substep → (FKVel, M⁻¹ (E,nv,nv), v_pred (E,nv)).

    qpos (E,nq), qvel (E,nv), ctrl (E,nu), mass/damping scales (E,),
    act_mask (E,nu). A CPU tensor takes the plain version; a CUDA tensor
    launches kernel K2 (which requires nv ≤ FULL_DYN_MAX_NV). The kernel
    returns quaternions; body rotations and world inertias are derived from
    them here, as the reference's kernel branch does.
    """
    args = (qpos, qvel, ctrl, mass_scale, damping_scale, act_mask)
    if qpos.device.type == "cpu":
        return full_dyn_plain(sys, *args)
    if qpos.device.type != "cuda":
        raise ValueError(f"full_dyn: unsupported device {qpos.device}")
    out = launch(sys, *args)
    layout, _ = row_layout(sys)
    e = qpos.shape[0]

    def field(name):
        off, rows, comps = layout[name]
        return out[:, off: off + rows * comps].view(e, rows, comps)

    quat = field("quat")
    fkv = kinematics.FKVel(
        body_pos=field("pos"), body_rot=quat_to_mat(quat), com=field("com"),
        inertia_w=kinematics.world_inertia(sys, quat),
        dof_axis=field("dof_axis"), dof_anchor=field("dof_anchor"),
        omega=field("omega"), v_com=field("v_com"), alpha0=field("alpha0"),
        a_com0=field("a_com0"),
    )
    return fkv, field("minv"), field("v_pred")[..., 0]
