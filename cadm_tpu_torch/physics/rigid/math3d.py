"""Quaternion / rotation helpers (counterpart of cadm_tpu/physics/rigid/math3d.py).

Conventions as in the reference: quaternions are (w, x, y, z), normalized,
rotating vectors from the local frame into the parent/world frame. Every
function broadcasts over leading axes.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector v by quaternion q (local → world)."""
    w = q[..., :1]
    u = q[..., 1:]
    return (
        v * (w * w - torch.sum(u * u, dim=-1, keepdim=True))
        + 2.0 * u * torch.sum(u * v, dim=-1, keepdim=True)
        + 2.0 * w * cross(u, v)
    )


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_to_mat(q: Tensor) -> Tensor:
    """3x3 rotation matrix from quaternion."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def quat_from_axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    half = 0.5 * angle
    return torch.cat(
        [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1
    )


def quat_integrate(q: Tensor, omega_world: Tensor, dt) -> Tensor:
    """q' = exp(ω_world·dt/2) ∘ q, renormalized (world-frame ω convention)."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.clamp(angle, min=1e-9)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    out = quat_mul(dq, q)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def quat_deriv(q: Tensor, omega_world: Tensor) -> Tensor:
    """q̇ = ½ (0, ω_world) ∘ q — world-frame angular-velocity kinematics."""
    omega_q = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world], -1)
    return 0.5 * quat_mul(omega_q, q)


def quat_integrate_local(q: Tensor, omega_local: Tensor, dt) -> Tensor:
    """q' = q ∘ exp(ω_local·dt/2) — BODY-frame ω (MuJoCo free-joint dofs)."""
    angle = torch.linalg.vector_norm(omega_local, dim=-1, keepdim=True)
    axis = omega_local / torch.clamp(angle, min=1e-9)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    out = quat_mul(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def quat_deriv_local(q: Tensor, omega_local: Tensor) -> Tensor:
    """q̇ = ½ q ∘ (0, ω_local) — BODY-frame angular-velocity kinematics."""
    omega_q = torch.cat([torch.zeros_like(omega_local[..., :1]), omega_local], -1)
    return 0.5 * quat_mul(q, omega_q)
