"""Fused smooth-dynamics step (kernel K2), FK-velocity walk (kernel K3), and
their plain versions.

K2 replaces the Pallas TPU kernel ``cadm_tpu/ops/fk_kernel.py::full_dyn_pallas``
(body ``_full_dyn_kernel``). ``full_dyn`` launches the CUDA kernel of
``csrc/full_dyn.cu`` for a CUDA tensor and runs ``full_dyn_plain`` — the
reference's composed smooth stage ``pure_one``
(``cadm_tpu/physics/rigid/dynamics.py:413-426``) — for a CPU tensor. The
kernel writes every field the step reads, body rotations and world inertias
included, into one row per env (``row_layout``); on the card ``full_dyn`` is
that one launch and the output allocation, and returns views of the row.
What bounds K2 is latency: the serial tree walk and the column chain of the
factorisation. It spreads each env over a group of lanes (the walk in one
lane, the per-body, per-dof, mass-matrix, Cholesky, L⁻¹ and M⁻¹ work across
the group) and 2048 envs over all the SMs; ``csrc/full_dyn.cu`` has the
details.

K3 replaces ``cadm_tpu/ops/fk_kernel.py::fk_vel_pallas`` (body
``_fk_kernel_merged``) together with its dispatcher ``_fkvel_dispatch``
(``cadm_tpu/physics/rigid/dynamics.py:347-399``): ``fk_vel`` launches the
FK-velocity walk of ``csrc/full_dyn.cu`` for a CUDA tensor (a group of lanes
per env, walking the tree level by level in the order ``walk_levels`` packs
into the table, each body through K2's per-body step) and derives the body
rotations and world inertias from its quaternions, as the dispatcher's
kernel branch does, since its rows hold only the nine FK fields; a CPU
tensor takes ``fk_vel_plain`` (``kinematics.forward_velocities``). No
trainer path calls it: it serves callers that need FK without the
dynamics.

Both kernels read the System from a packed table (``SysTable``, one layout
for every System), so the same binary serves all four rigid families.
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

# Launches of the CUDA kernels in this process, K2 and K3, replays of CUDA
# graphs that hold them included (read and reset by chip_smoke.py to show
# that the main path went through the kernel).
launches = 0
fk_vel_launches = 0

_i, _f = ctypes.c_int32, ctypes.c_float


class SysTable(ctypes.Structure):
    """Host mirror of ``struct SysTable`` in csrc/full_dyn.cu (same order)."""

    _fields_ = [
        ("nb", _i), ("nj", _i), ("nq", _i), ("nv", _i), ("nu", _i),
        ("n_levels", _i),
        ("body_parent", _i * NB_MAX),
        ("body_jnt_start", _i * NB_MAX),
        ("body_jnt_num", _i * NB_MAX),
        ("level_start", _i * NB_MAX),
        ("level_body", _i * NB_MAX),
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


def walk_levels(sys: System) -> Tuple[Tuple[int, ...], ...]:
    """Bodies 1..nb-1 by depth below the world body (level l holds the
    bodies at depth l + 1, in body order): K3's walk takes a level at once,
    since a body's step reads only its parent's state. Raises where a
    parent does not precede its body, which the serial walk relies on."""
    depth = [0] * sys.nb
    for b in range(1, sys.nb):
        p = int(sys.body_parent[b])
        if not 0 <= p < b:
            raise ValueError(f"body {b}'s parent {p} does not precede it")
        depth[b] = depth[p] + 1
    return tuple(tuple(b for b in range(1, sys.nb) if depth[b] == d)
                 for d in range(1, max(depth) + 1))


def pack_system(sys: System) -> SysTable:
    """The System as the kernel's table (raises beyond the table's maxima)."""
    nb, nj, nv, nu = sys.nb, sys.nj, sys.nv, sys.nu
    if nb > NB_MAX or nj > NJ_MAX or nv > min(NV_MAX, FULL_DYN_MAX_NV) \
            or nu > NU_MAX:
        raise ValueError(f"System too large for the kernels' table: nb={nb} "
                         f"nj={nj} nv={nv} nu={nu}")
    t = SysTable(nb=nb, nj=nj, nq=sys.nq, nv=nv, nu=nu)
    levels = walk_levels(sys)
    t.n_levels = len(levels)
    for i, b in enumerate(b for level in levels for b in level):
        t.level_body[i] = b
    for lvl in range(len(levels)):
        t.level_start[lvl + 1] = t.level_start[lvl] + len(levels[lvl])
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
        ("dof_axis", nv, 3), ("dof_anchor", nv, 3),
        # K2 only (K3's row ends above): row-major 3×3 per body
        ("body_rot", nb, 9), ("inertia_w", nb, 9),
        ("minv", nv, nv), ("v_pred", nv, 1),
    ]
    off, layout = 0, {}
    for name, rows, comps in fields:
        layout[name] = (off, rows, comps)
        off += rows * comps
    return layout, off


def fk_width(sys: System) -> int:
    """Row width of the nine FK fields (K3's whole row, K2's first part)."""
    return 22 * sys.nb + 6 * sys.nv


@lru_cache(maxsize=None)
def _field_shapes(sys: System) -> Tuple[Tuple[str, int, Tuple[int, ...]], ...]:
    """(name, width, per-env shape) of each field of ``row_layout``, in
    order: 3×3 matrices for body_rot/inertia_w, (nv,) for v_pred."""
    out = []
    for name, (_, rows, comps) in row_layout(sys)[0].items():
        shape = {"body_rot": (rows, 3, 3), "inertia_w": (rows, 3, 3),
                 "v_pred": (rows,)}.get(name, (rows, comps))
        out.append((name, rows * comps, shape))
    return tuple(out)


def row_fields(sys: System, out: Tensor) -> Dict[str, Tensor]:
    """Views (E, ...) of the fields that kernel rows (E, width) hold, from
    the start of ``row_layout``: all of them for K2's rows, the nine FK
    fields for K3's. One split and a reshape per field, no device op."""
    e, width = out.shape
    names, sizes, shapes, used = [], [], [], 0
    for name, size, shape in _field_shapes(sys):
        if used + size > width:
            break
        names.append(name)
        sizes.append(size)
        shapes.append(shape)
        used += size
    if used < width:
        sizes.append(width - used)
    parts = out.split(sizes, dim=1)
    return {n: p.view(e, *sh) for n, p, sh in zip(names, parts, shapes)}


def _fkvel_from_fields(sys: System, f: Dict[str, Tensor]) -> kinematics.FKVel:
    """FKVel from ``row_fields``. K2's rows hold ``body_rot`` and
    ``inertia_w``; K3's end before them, so for those the two are derived
    from the quaternions."""
    if "inertia_w" in f:
        rot, inertia = f["body_rot"], f["inertia_w"]
    else:
        rot = quat_to_mat(f["quat"])
        inertia = kinematics.world_inertia(sys, f["quat"])
    return kinematics.FKVel(
        body_pos=f["pos"], body_rot=rot, com=f["com"], inertia_w=inertia,
        dof_axis=f["dof_axis"], dof_anchor=f["dof_anchor"], omega=f["omega"],
        v_com=f["v_com"], alpha0=f["alpha0"], a_com0=f["a_com0"],
    )


def _fkvel_from_rows(sys: System, out: Tensor) -> kinematics.FKVel:
    """FKVel of kernel rows (E, ≥ fk_width) laid out as ``row_layout``:
    views of the row, but for K3's rows the two derived fields."""
    return _fkvel_from_fields(sys, row_fields(sys, out))


def fk_vel_plain(sys: System, qpos: Tensor, qvel: Tensor) -> kinematics.FKVel:
    """The FK-velocity walk as plain batched tensor ops."""
    return kinematics.forward_velocities(sys, qpos, qvel)


def launch_fk_vel(sys: System, qpos: Tensor, qvel: Tensor) -> Tensor:
    """Launch kernel K3 on CUDA tensors → rows (E, fk_width(sys)) laid out
    as the first nine fields of ``row_layout(sys)``."""
    global fk_vel_launches
    e = qpos.shape[0]
    if tuple(qpos.shape) != (e, sys.nq) or tuple(qvel.shape) != (e, sys.nv):
        raise ValueError(f"fk_vel shapes {tuple(qpos.shape)}, "
                         f"{tuple(qvel.shape)}, expected ({e}, {sys.nq}), "
                         f"({e}, {sys.nv})")
    qpos, qvel = qpos.contiguous(), qvel.contiguous()
    _build.require_cuda_f32("fk_vel", qpos, qvel)
    width = fk_width(sys)
    out = torch.empty(e, width, device=qpos.device, dtype=torch.float32)
    code = _build.lib().cadm_fk_vel(
        _device_table(sys, qpos.device).data_ptr(), qpos.data_ptr(),
        qvel.data_ptr(), out.data_ptr(), e, sys.nb, sys.nq, sys.nv,
        _build.stream_handle(qpos),
    )
    _build.check(code, "fk_vel")
    fk_vel_launches += _build.eager_launch("fk_vel")
    return out


def fk_vel(sys: System, qpos: Tensor, qvel: Tensor) -> kinematics.FKVel:
    """FK + velocities + zero-q̈ bias accelerations → FKVel (E, ...).

    qpos (E, nq), qvel (E, nv). A CPU tensor takes the plain version; a
    CUDA tensor launches kernel K3; any other device raises.
    """
    if qpos.device.type == "cpu":
        return fk_vel_plain(sys, qpos, qvel)
    if qpos.device.type != "cuda":
        raise ValueError(f"fk_vel: unsupported device {qpos.device}")
    return _fkvel_from_rows(sys, launch_fk_vel(sys, qpos, qvel))


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
    width = sum(size for _, size, _ in _field_shapes(sys))
    out = torch.empty(e, width, device=qpos.device, dtype=torch.float32)
    code = _build.lib().cadm_full_dyn(
        _device_table(sys, qpos.device).data_ptr(),
        *(x.data_ptr() for x in args), out.data_ptr(), e, width, sys.nb,
        sys.nv, _build.stream_handle(qpos),
    )
    _build.check(code, "full_dyn")
    launches += _build.eager_launch("full_dyn")
    return out


def full_dyn(
    sys: System, qpos: Tensor, qvel: Tensor, ctrl: Tensor,
    mass_scale: Tensor, damping_scale: Tensor, act_mask: Tensor,
) -> Tuple[kinematics.FKVel, Tensor, Tensor]:
    """Smooth stage of one substep → (FKVel, M⁻¹ (E,nv,nv), v_pred (E,nv)).

    qpos (E,nq), qvel (E,nv), ctrl (E,nu), mass/damping scales (E,),
    act_mask (E,nu). A CPU tensor takes the plain version; a CUDA tensor
    launches kernel K2 (which requires nv ≤ FULL_DYN_MAX_NV) and returns
    views of its rows, with no other device op.
    """
    args = (qpos, qvel, ctrl, mass_scale, damping_scale, act_mask)
    if qpos.device.type == "cpu":
        return full_dyn_plain(sys, *args)
    if qpos.device.type != "cuda":
        raise ValueError(f"full_dyn: unsupported device {qpos.device}")
    out = launch(sys, *args)
    f = row_fields(sys, out)
    return _fkvel_from_fields(sys, f), f["minv"], f["v_pred"]
