"""Ant (mass/damping randomized) and CrippleAnt (hidden crippled leg)
(counterpart of cadm_tpu/envs/ant.py).

AntEnv hides per-episode mass/damping scales; CrippleAntEnv zeroes the two
actuators of one leg per episode instead, so the crippled leg's id is the
hidden context the CaDM encoder must infer. Train mode cripples legs
{0, 1, 2}; the moderate and extreme modes hold out leg 3.

Observation [qpos[2:], qvel] (27,): x/y translation excluded, the root's
world linear velocity at indices 13..15, so the reward's vx = obs[13] is a
function of observations alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cadm_tpu_torch.core.types import PyTree, constant, leading_dim
from cadm_tpu_torch.envs.base import uniform
from cadm_tpu_torch.envs.rigid_base import (
    RigidEnv,
    RigidPhys,
    normalize_root_quat,
)
from cadm_tpu_torch.core.rng import randint, randn
from cadm_tpu_torch.physics.rigid import dynamics as rdyn

Tensor = torch.Tensor

# gym ant's init keyframe (legs bent into their joint ranges)
ANT_INIT_QPOS = np.array(
    [0, 0, 0.55, 1, 0, 0, 0, 0, 1.0, 0, -1.0, 0, -1.0, 0, 1.0]
)
# actuator indices per leg, following the asset's actuator order
# (hip_4, ankle_4, hip_1, ankle_1, hip_2, ankle_2, hip_3, ankle_3)
LEG_ACTUATORS = np.array([[2, 3], [4, 5], [6, 7], [0, 1]])


class AntEnv(RigidEnv):
    asset = "ant"
    frame_skip = 5
    horizon = 1000
    obs_dim = 27

    ctrl_cost = 0.005
    survive_bonus = 0.05
    _vx_index = 13

    def init_phys(self, gen: torch.Generator, params: PyTree) -> RigidPhys:
        n = leading_dim(params)
        qpos0 = constant(ANT_INIT_QPOS, self.device)
        qpos = qpos0 + uniform(gen, (n, self.sys.nq), -0.1, 0.1)
        qvel = 0.1 * randn(gen, n, self.sys.nv)
        return RigidPhys(qpos=normalize_root_quat(qpos), qvel=qvel)

    def observe(self, params: PyTree, phys: RigidPhys) -> Tensor:
        return torch.cat([phys.qpos[:, 2:], phys.qvel], dim=-1)

    def reward(self, obs: Tensor, act: Tensor, next_obs: Tensor) -> Tensor:
        vx = next_obs[..., self._vx_index]
        return (vx - self.ctrl_cost * torch.sum(act**2, dim=-1)
                + self.survive_bonus)


@dataclasses.dataclass
class CrippleParams:
    """Hidden context: which leg is disabled, as a per-actuator mask."""

    act_mask: Tensor  # (E, nu)


class CrippleAntEnv(AntEnv):
    """Ant with one leg's actuators zeroed per episode (hidden context)."""

    def sample_params(self, gen: torch.Generator, mode: int, n: int
                      ) -> CrippleParams:
        if mode == 0:   # train legs {0, 1, 2}
            leg = randint(gen, 3, n)
        else:           # the held-out leg
            leg = torch.full((n,), 3, dtype=torch.long, device=self.device)
        legs = constant(LEG_ACTUATORS, self.device, torch.long)[leg]
        mask = torch.ones(n, self.sys.nu, device=self.device)
        return CrippleParams(act_mask=mask.scatter(1, legs, 0.0))

    def rigid_params(self, params: CrippleParams) -> rdyn.RigidParams:
        n = params.act_mask.shape[0]
        ones = torch.ones(n, device=params.act_mask.device)
        return rdyn.RigidParams(mass_scale=ones, damping_scale=ones,
                                act_mask=params.act_mask)

    def symmetry_maps(self):
        m = leg_symmetry_maps()
        return {"obs": m["obs"], "act": m["act"]}


# --------------------------------------------------------------------------
# 4-fold leg symmetry: the gym ant model is exactly invariant under renaming
# the torso's body frame by a 90° yaw together with relabeling the legs —
# leg i's geometry, joint ranges, gears and masses map onto leg (i+1)%4's,
# with the ankle hinge AXIS flipping sign on two of the four transitions
# (the asset alternates ankle axes (-1,1,0)/(1,1,0)). Renaming is
# body-internal: world position and world-frame velocities are untouched, so
# the forward-x reward is invariant and a transformed transition is a valid
# transition of the relabeled-cripple env (the reference property-tests this
# against its simulator). Copied from the reference, numpy only.
#
# Layouts (ant.xml):
#   qpos (15): [x, y, z, qw qx qy qz, hip1 ank1 hip2 ank2 hip3 ank3 hip4 ank4]
#   qvel (14): [v_world(3), omega_BODY(3), 8 joint vels]
#   obs  (27): qpos[2:] ++ qvel
#   act   (8): [hip4 ank4 hip1 ank1 hip2 ank2 hip3 ank3]  (gym actuator order)
# Leg indices follow LEG_ACTUATORS: 0=front_left(leg_1) .. 3=right_back(leg_4).

_PHI = -np.pi / 2          # body-frame yaw per single relabel step
# ankle sign on arrival slot j (slot j's value = sign * old leg (j-1)'s):
# ankle_1->2 flips, ->3 same, ->4 flips, ->1 same (axis alternation above)
_ANKLE_SIGN_AT_SLOT = np.array([1.0, -1.0, 1.0, -1.0])
_ACT_LEG_OF_BLOCK = np.array([3, 0, 1, 2])  # actuator block b drives leg


def _quat_rmul_mat(phi: float) -> np.ndarray:
    """Matrix of q -> q ⊗ r, r = (cos(phi/2), 0, 0, sin(phi/2)) (w-first)."""
    c, s = np.cos(phi / 2.0), np.sin(phi / 2.0)
    return np.array([
        [c, 0.0, 0.0, -s],
        [0.0, c, s, 0.0],
        [0.0, -s, c, 0.0],
        [s, 0.0, 0.0, c],
    ])


def _rz(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _leg_sym_step() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(qpos 15x15, qvel 14x14, act 8x8) matrices of ONE relabel step
    (leg i -> leg i+1; body-frame yaw _PHI)."""
    qpos = np.zeros((15, 15))
    qpos[0, 0] = qpos[1, 1] = qpos[2, 2] = 1.0        # x, y, z
    qpos[3:7, 3:7] = _quat_rmul_mat(_PHI)
    for i in range(4):                                 # leg i -> slot j
        j = (i + 1) % 4
        qpos[7 + 2 * j, 7 + 2 * i] = 1.0               # hip
        qpos[8 + 2 * j, 8 + 2 * i] = _ANKLE_SIGN_AT_SLOT[j]
    qvel = np.zeros((14, 14))
    qvel[0:3, 0:3] = np.eye(3)                         # v_world unchanged
    # omega is body-frame: re-express components in the renamed axes
    qvel[3:6, 3:6] = _rz(_PHI).T
    qvel[6:, 6:] = qpos[7:, 7:]                        # joint vels permute alike
    act = np.zeros((8, 8))
    for b in range(4):                                 # actuator block b
        i = _ACT_LEG_OF_BLOCK[b]
        j = (i + 1) % 4
        bj = int(np.where(_ACT_LEG_OF_BLOCK == j)[0][0])
        act[2 * bj, 2 * b] = 1.0                       # hip torque
        act[2 * bj + 1, 2 * b + 1] = _ANKLE_SIGN_AT_SLOT[j]
    return qpos, qvel, act


def leg_symmetry_maps() -> dict:
    """All four powers of the relabel step, as obs/act/phys matrices.

    Returns {'obs': (4, 27, 27), 'act': (4, 8, 8), 'qpos': (4, 15, 15),
    'qvel': (4, 14, 14)}; index k maps a leg-L-crippled transition onto a
    leg-(L+k)%4-crippled one (k=0 is the identity)."""
    qp1, qv1, ac1 = _leg_sym_step()
    qp, qv, ac = [np.eye(15)], [np.eye(14)], [np.eye(8)]
    for _ in range(3):
        qp.append(qp1 @ qp[-1])
        qv.append(qv1 @ qv[-1])
        ac.append(ac1 @ ac[-1])
    obs = []
    for k in range(4):
        m = np.zeros((27, 27))
        m[:13, :13] = qp[k][2:, 2:]                    # z + quat + joints
        m[13:, 13:] = qv[k]
        obs.append(m)
    return {
        "obs": np.stack(obs),
        "act": np.stack(ac),
        "qpos": np.stack(qp),
        "qvel": np.stack(qv),
    }
