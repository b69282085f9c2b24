"""Static rigid-body system description (counterpart of
cadm_tpu/physics/rigid/system.py, numpy only).

A ``System`` is immutable host-side data describing topology, geometry,
inertia, joints, actuators and collision geoms. The port's engine reads it
when it builds its per-device constant tensors and the K2 kernel's table;
per-episode randomized physics (mass/damping scales, actuator masks) stay
tensors. The port loads Systems from the npz files under ``envs/assets/``
(see ``envs/rigid_base.load_system``) and has no MJCF parser.

Joint model follows MuJoCo semantics: each body owns 0+ joints applied
sequentially inside the body frame; supported types are FREE (3
translational + 3 rotational DOFs), SLIDE and HINGE.
"""
from __future__ import annotations

import dataclasses
import numpy as np

# joint / dof type codes
FREE, SLIDE, HINGE = 0, 2, 3
# geom type codes (collision supports sphere & capsule vs world plane)
GEOM_SPHERE, GEOM_CAPSULE, GEOM_PLANE, GEOM_BOX, GEOM_OTHER = 2, 3, 0, 6, 7


@dataclasses.dataclass(frozen=True, eq=False)
class System:
    """Immutable model description. All arrays are host numpy constants."""

    # bodies (index 0 is the world)
    body_parent: np.ndarray   # (nb,) int
    body_pos: np.ndarray      # (nb,3) frame offset in parent frame
    body_quat: np.ndarray     # (nb,4)
    body_mass: np.ndarray     # (nb,)
    body_inertia: np.ndarray  # (nb,3) diagonal, in inertial frame
    body_ipos: np.ndarray     # (nb,3) COM offset in body frame
    body_iquat: np.ndarray    # (nb,4) inertial frame orientation

    # joints (MuJoCo-style, each belongs to one body; applied in order)
    jnt_body: np.ndarray      # (nj,) int
    jnt_type: np.ndarray      # (nj,) int — FREE/SLIDE/HINGE
    jnt_axis: np.ndarray      # (nj,3) in body frame
    jnt_pos: np.ndarray       # (nj,3) anchor in body frame
    jnt_qposadr: np.ndarray   # (nj,)
    jnt_dofadr: np.ndarray    # (nj,)
    jnt_range: np.ndarray     # (nj,2)
    jnt_limited: np.ndarray   # (nj,) bool
    jnt_stiffness: np.ndarray # (nj,) passive spring toward qpos_spring
    qpos0: np.ndarray         # (nq,) reference configuration (MuJoCo ref)
    qpos_spring: np.ndarray   # (nq,) spring reference configuration

    # dofs
    dof_damping: np.ndarray   # (nv,)
    dof_armature: np.ndarray  # (nv,)

    # actuators (direct joint torque with gear)
    act_joint: np.ndarray     # (nu,) joint index
    act_gear: np.ndarray      # (nu,)
    act_ctrlrange: np.ndarray # (nu,2)

    # collision geoms (vs world plane z=0)
    geom_body: np.ndarray     # (ng,) int
    geom_type: np.ndarray     # (ng,) int
    geom_size: np.ndarray     # (ng,3)
    geom_pos: np.ndarray      # (ng,3) in body frame
    geom_quat: np.ndarray     # (ng,4)
    geom_friction: np.ndarray # (ng,) sliding friction

    # options
    dt: float                 # physics timestep (per substep)
    gravity: np.ndarray       # (3,)

    # solver parameters (MuJoCo-soft-constraint-flavoured)
    contact_stiffness: float = 0.2    # Baumgarte push-out factor (per step)
    contact_damping: float = 0.0
    solver_iters: int = 15
    # sweep count when the solve is warm-started from the previous substep's
    # impulses (persistent contacts over a ~1 ms substep): a handful of
    # sweeps reaches the same residual the cold solve needs solver_iters
    # for. The contact-phase golden tests vs MuJoCo gate this choice.
    solver_iters_warm: int = 6
    limit_stiffness: float = 400.0    # joint-limit penalty spring
    limit_damping: float = 10.0

    # ------------------------------------------------------------------
    @property
    def nb(self) -> int:
        return len(self.body_parent)

    @property
    def nj(self) -> int:
        return len(self.jnt_body)

    @property
    def nv(self) -> int:
        return int(self.jnt_dofadr[-1] + _dof_width(self.jnt_type[-1])) if self.nj else 0

    @property
    def nq(self) -> int:
        return int(self.jnt_qposadr[-1] + _qpos_width(self.jnt_type[-1])) if self.nj else 0

    @property
    def nu(self) -> int:
        return len(self.act_joint)

    @property
    def ng(self) -> int:
        return len(self.geom_body)

    # static derived structure -----------------------------------------
    def ancestry_mask(self) -> np.ndarray:
        """(nb, nv) bool: does dof d move body b? Computed host-side once."""
        mask = np.zeros((self.nb, self.nv), bool)
        for j in range(self.nj):
            b = int(self.jnt_body[j])
            width = _dof_width(self.jnt_type[j])
            dofs = range(int(self.jnt_dofadr[j]), int(self.jnt_dofadr[j]) + width)
            # mark body b and all descendants
            desc = self._descendants(b)
            for d in dofs:
                mask[desc, d] = True
        return mask

    def _descendants(self, b: int) -> np.ndarray:
        out = []
        for k in range(b, self.nb):
            cur = k
            while cur > 0 and cur != b:
                cur = int(self.body_parent[cur])
            if cur == b:
                out.append(k)
        return np.array(out, int)

    def dof_to_joint(self) -> np.ndarray:
        out = np.zeros((self.nv,), int)
        for j in range(self.nj):
            w = _dof_width(self.jnt_type[j])
            out[int(self.jnt_dofadr[j]): int(self.jnt_dofadr[j]) + w] = j
        return out

    def default_qpos(self) -> np.ndarray:
        """Reference configuration (MuJoCo qpos0: ref offsets, unit quats)."""
        return self.qpos0.copy()


def _dof_width(jt: int) -> int:
    return {FREE: 6, SLIDE: 1, HINGE: 1}[int(jt)]


def _qpos_width(jt: int) -> int:
    return {FREE: 7, SLIDE: 1, HINGE: 1}[int(jt)]
