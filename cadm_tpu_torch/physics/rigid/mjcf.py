"""MJCF → System compiler (counterpart of cadm_tpu/physics/rigid/mjcf.py),
numpy and the standard library only.

The reference compiles an asset through ``mujoco.MjModel`` and reads the
compiled model (``system_from_mjmodel``). The port runs where mujoco is not
installed, so it compiles the subset of MJCF that the reference supports
itself, with the arithmetic of MuJoCo 3.10's compiler in its order of
operations, and gives the same System, float64 bit for bit: the body tree
in depth-first order, bodies' frames in their parent's frame, masses and
inertial frames from the geoms (``density``, ``settotalmass``; a body with
several geoms diagonalised by the compiler's own Jacobi ``mjuu_eig3``,
whose choice of frame is not unique where two principal moments are
equal), FREE/SLIDE/HINGE joints with ``ref``, ``springref``,
``range`` and ``limited``, joint-torque motors, collision geoms by the
reference's rules, ``<option>``'s ``timestep`` and ``gravity``,
``<default>`` classes, ``<compiler angle=...>`` and the orientations
``quat``, ``axisangle``, ``euler`` and ``fromto``.

What the System does not read is ignored, as the reference ignores it
(``IGNORED``). Any other element or attribute, and a joint or geom type
this compiler cannot compute, raises ``NotImplementedError`` naming it;
input that MuJoCo itself refuses raises ``ValueError``.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from cadm_tpu_torch.physics.rigid.system import (
    FREE,
    GEOM_CAPSULE,
    GEOM_SPHERE,
    HINGE,
    SLIDE,
    System,
)

# attributes the System does not read: names, contact softness and
# filtering, the integrator and what is only drawn
IGNORED = frozenset({
    "name", "solref", "solimp", "margin", "condim", "contype",
    "conaffinity", "integrator", "rgba", "material",
})

# the attributes each element may carry (bar IGNORED); the defaultable ones
# may also be set in a <default> class
ATTRS = {
    "mujoco": {"model"},
    "compiler": {"angle", "coordinate", "inertiafromgeom", "settotalmass"},
    "option": {"timestep", "gravity"},
    "default": {"class"},
    "worldbody": set(),
    "actuator": set(),
    "body": {"pos", "quat", "axisangle", "euler", "childclass"},
    "geom": {"class", "type", "size", "pos", "quat", "axisangle", "euler",
             "fromto", "friction", "density"},
    "joint": {"class", "type", "pos", "axis", "range", "limited", "ref",
              "springref", "damping", "armature", "stiffness"},
    "motor": {"class", "joint", "gear", "ctrlrange", "ctrllimited"},
}
DEFAULTABLE = {
    "geom": {"type", "size", "friction", "density"},
    "joint": {"type", "pos", "axis", "range", "limited", "ref", "springref",
              "damping", "armature", "stiffness"},
    "motor": {"gear", "ctrlrange", "ctrllimited"},
}
ORIENTATIONS = ("quat", "axisangle", "euler")

JOINT_TYPES = {"free": FREE, "slide": SLIDE, "hinge": HINGE}
GEOM_TYPES = ("plane", "sphere", "capsule", "box")
_MJ_GEOM = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE,
            # other shapes: the reference's sphere of the geom's sizes
            "box": GEOM_SPHERE}

MJ_PI = 3.14159265358979323846
MJ_MINVAL = 1e-15
MJ_EPS = 1e-14
EIG_EPS = 1e-12
# MuJoCo's defaults
DENSITY = 1000.0
TIMESTEP = 0.002
GRAVITY = (0.0, 0.0, -9.81)
FRICTION = (1.0, 0.005, 0.0001)


def system_from_mjcf(xml: str, **overrides) -> System:
    """Build a System from an MJCF string (``overrides``: System fields
    set after the compile, as the reference's)."""
    kwargs = _Compiler(ET.fromstring(xml)).compile()
    kwargs.update(overrides)
    return System(**kwargs)


# ---------------------------------------------------------------------------
# MuJoCo's vector, quaternion and matrix helpers, in its order of operations


def _sum(xs) -> float:
    """Left-to-right float sum, as C adds ``a + b + c`` (Python's ``sum``
    of floats compensates its rounding, so its last bits differ)."""
    it = iter(xs)
    total = next(it)
    for x in it:
        total += x
    return total


def _normvec(v: List[float]) -> float:
    """mjuu_normvec: normalise ``v`` in place and return its norm (0 for a
    vector whose squared norm is below mjEPS; one within mjEPS of unit
    length is left as it is)."""
    sq = _sum(x * x for x in v)
    if sq < MJ_EPS:
        return 0.0
    nrm = math.sqrt(sq)
    if abs(nrm - 1.0) > MJ_EPS:
        for i in range(len(v)):
            v[i] /= nrm
    return nrm


def _mulquat(a, b) -> List[float]:
    return [a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
            a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
            a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
            a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0]]


def _quat2mat(q) -> List[float]:
    """mjuu_quat2mat: the row-major 3×3 rotation of a unit quaternion."""
    if q[0] == 1 and q[1] == 0 and q[2] == 0 and q[3] == 0:
        return [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    q00, q01, q02, q03 = q[0] * q[0], q[0] * q[1], q[0] * q[2], q[0] * q[3]
    q11, q12, q13 = q[1] * q[1], q[1] * q[2], q[1] * q[3]
    q22, q23, q33 = q[2] * q[2], q[2] * q[3], q[3] * q[3]
    return [q00 + q11 - q22 - q33, 2 * (q12 - q03), 2 * (q13 + q02),
            2 * (q12 + q03), q00 - q11 + q22 - q33, 2 * (q23 - q01),
            2 * (q13 - q02), 2 * (q23 + q01), q00 - q11 - q22 + q33]


def _mat_t_mat(a, b) -> List[float]:
    """a' b for row-major 3×3 a, b."""
    return [_sum(a[3 * k + i] * b[3 * k + j] for k in range(3))
            for i in range(3) for j in range(3)]


def _mat_mat(a, b) -> List[float]:
    """a b for row-major 3×3 a, b."""
    return [_sum(a[3 * i + k] * b[3 * k + j] for k in range(3))
            for i in range(3) for j in range(3)]


def _eig3(mat) -> tuple:
    """mjuu_eig3: eigenvalues (decreasing) and the quaternion of the
    eigenvectors of a symmetric 3×3 matrix, by Jacobi rotations."""
    quat = [1.0, 0.0, 0.0, 0.0]
    eigval = [0.0, 0.0, 0.0]
    for _ in range(500):
        vec = _quat2mat(quat)
        d = _mat_mat(_mat_t_mat(vec, mat), vec)
        eigval = [d[0], d[4], d[8]]
        if abs(d[1]) > abs(d[2]) and abs(d[1]) > abs(d[5]):
            rk, ck, rotk = 0, 1, 2
        elif abs(d[2]) > abs(d[5]):
            rk, ck, rotk = 0, 2, 1
        else:
            rk, ck, rotk = 1, 2, 0
        if abs(d[3 * rk + ck]) < EIG_EPS:
            break
        tau = (d[4 * ck] - d[4 * rk]) / (2 * d[3 * rk + ck])
        if tau >= 0:
            t = 1.0 / (tau + math.sqrt(1 + tau * tau))
        else:
            t = -1.0 / (-tau + math.sqrt(1 + tau * tau))
        c = 1.0 / math.sqrt(1 + t * t)
        if c > 1.0 - EIG_EPS:
            break
        rot = [0.0, 0.0, 0.0, 0.0]
        s = math.sqrt(0.5 - 0.5 * c)
        rot[rotk + 1] = -s if tau >= 0 else s
        if rotk == 1:
            rot[rotk + 1] = -rot[rotk + 1]
        rot[0] = math.sqrt(1.0 - rot[rotk + 1] * rot[rotk + 1])
        _normvec(rot)
        quat = _mulquat(quat, rot)
        _normvec(quat)
    # sort the eigenvalues in decreasing order (bubble sort: 0, 1, 0),
    # leaving those within EIG_EPS of each other in place
    for j in range(3):
        j1 = j % 2
        if eigval[j1] + EIG_EPS < eigval[j1 + 1]:
            eigval[j1], eigval[j1 + 1] = eigval[j1 + 1], eigval[j1]
            rot = [0.707106781186548, 0.0, 0.0, 0.0]
            rot[(j1 + 2) % 3 + 1] = rot[0]
            quat = _mulquat(quat, rot)
            _normvec(quat)
    return eigval, quat


def _global_inertia(diag, quat) -> List[float]:
    """mjuu_globalinertia: R diag R' as (xx, yy, zz, xy, xz, yz), entry
    (a, b) summed over k of R[a, k] (R[b, k] diag[k])."""
    m = _quat2mat(quat)
    t = [m[3 * i + k] * diag[k] for i in range(3) for k in range(3)]
    return [_sum(m[3 * a + k] * t[3 * b + k] for k in range(3))
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]


def _offcenter(mass: float, d) -> List[float]:
    """mjuu_offcenter: the parallel-axis term of a point mass at ``d``."""
    return [mass * (d[1] * d[1] + d[2] * d[2]),
            mass * (d[0] * d[0] + d[2] * d[2]),
            mass * (d[0] * d[0] + d[1] * d[1]),
            -mass * d[0] * d[1], -mass * d[0] * d[2], -mass * d[1] * d[2]]


def _z2quat(vec) -> List[float]:
    """mjuu_z2quat: the least rotation of +z onto ``vec`` (about x by π
    where ``vec`` lies along −z)."""
    z = (0.0, 0.0, 1.0)
    axis = [z[1] * vec[2] - z[2] * vec[1], z[2] * vec[0] - z[0] * vec[2],
            z[0] * vec[1] - z[1] * vec[0]]
    s = _normvec(axis)
    if s < 1e-10:
        axis = [1.0, 0.0, 0.0]
    ang = math.atan2(s, vec[2])
    sa = math.sin(ang / 2)
    return [math.cos(ang / 2), axis[0] * sa, axis[1] * sa, axis[2] * sa]


# ---------------------------------------------------------------------------


def _floats(elem: ET.Element, attr: str, text: str, lo: int, hi: int
            ) -> List[float]:
    try:
        vals = [float(x) for x in text.split()]
    except ValueError:
        raise ValueError(f"<{elem.tag}> {attr}={text!r}: not numbers") from None
    if not lo <= len(vals) <= hi:
        raise ValueError(f"<{elem.tag}> {attr}={text!r}: expected "
                         f"{lo}–{hi} numbers, got {len(vals)}")
    return vals


def _fill(base, vals) -> List[float]:
    """``vals`` over the first entries of ``base`` (MuJoCo reads fewer
    numbers than an array holds into its front)."""
    return list(vals) + list(base[len(vals):])


def _choice(elem: ET.Element, attr: str, text: str, allowed) -> str:
    if text not in allowed:
        raise ValueError(f"<{elem.tag}> {attr}={text!r}: expected one of "
                         f"{sorted(allowed)}")
    return text


def _check_attrs(elem: ET.Element) -> None:
    allowed = ATTRS[elem.tag]
    for attr in elem.attrib:
        if attr not in allowed and attr not in IGNORED:
            raise NotImplementedError(
                f"MJCF attribute '{attr}' of <{elem.tag}> is not supported")


class _Compiler:
    def __init__(self, root: ET.Element):
        if root.tag != "mujoco":
            raise ValueError(f"MJCF root is <{root.tag}>, not <mujoco>")
        _check_attrs(root)
        self.degree = True
        self.settotalmass = -1.0
        self.timestep = TIMESTEP
        self.gravity = list(GRAVITY)
        # class name → {element kind → {attribute: text}}
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {
            "main": {k: {} for k in DEFAULTABLE}}
        self.worldbody: Optional[ET.Element] = None
        self.motors: List[ET.Element] = []
        for elem in root:
            if elem.tag == "compiler":
                self._compiler(elem)
            elif elem.tag == "option":
                self._option(elem)
            elif elem.tag == "default":
                self._defaults(elem, None)
            elif elem.tag == "worldbody":
                if self.worldbody is not None:
                    raise NotImplementedError("more than one <worldbody>")
                _check_attrs(elem)
                self.worldbody = elem
            elif elem.tag == "actuator":
                _check_attrs(elem)
                for act in elem:
                    if act.tag != "motor":
                        raise NotImplementedError(
                            f"MJCF actuator <{act.tag}> is not supported "
                            "(joint-torque <motor> only)")
                    _check_attrs(act)
                    self.motors.append(act)
            else:
                raise NotImplementedError(
                    f"MJCF element <{elem.tag}> is not supported")

    # -- the model-wide settings -------------------------------------------
    def _compiler(self, elem: ET.Element) -> None:
        _check_attrs(elem)
        a = elem.attrib
        if "angle" in a:
            self.degree = _choice(elem, "angle", a["angle"],
                                  {"degree", "radian"}) == "degree"
        if "coordinate" in a and _choice(
                elem, "coordinate", a["coordinate"],
                {"local", "global"}) != "local":
            raise NotImplementedError(
                "MJCF <compiler coordinate='global'> is not supported")
        if "inertiafromgeom" in a and _choice(
                elem, "inertiafromgeom", a["inertiafromgeom"],
                {"true", "false", "auto"}) == "false":
            raise NotImplementedError(
                    "MJCF <compiler inertiafromgeom='false'> is not supported"
                    " (no <inertial> element either)")
        if "settotalmass" in a:
            self.settotalmass = _floats(elem, "settotalmass",
                                        a["settotalmass"], 1, 1)[0]

    def _option(self, elem: ET.Element) -> None:
        _check_attrs(elem)
        for child in elem:
            raise NotImplementedError(
                f"MJCF element <{child.tag}> in <option> is not supported")
        a = elem.attrib
        if "timestep" in a:
            self.timestep = _floats(elem, "timestep", a["timestep"], 1, 1)[0]
        if "gravity" in a:
            self.gravity = _floats(elem, "gravity", a["gravity"], 3, 3)

    def _defaults(self, elem: ET.Element, parent: Optional[str]) -> None:
        _check_attrs(elem)
        name = elem.get("class", "main" if parent is None else None)
        if name is None:
            raise ValueError("a nested <default> needs a class")
        if parent is not None and name in self.classes:
            raise ValueError(f"repeated default class '{name}'")
        base = self.classes[parent] if parent is not None else \
            self.classes["main"]
        own = {k: dict(v) for k, v in base.items()}
        for child in elem:
            if child.tag == "default":
                continue
            kind = child.tag
            if kind not in DEFAULTABLE:
                raise NotImplementedError(
                    f"MJCF default <{kind}> is not supported")
            for attr in child.attrib:
                if attr in IGNORED:
                    continue
                if attr not in DEFAULTABLE[kind]:
                    raise NotImplementedError(
                        f"MJCF attribute '{attr}' of a default <{kind}> is "
                        "not supported")
            own[kind].update(child.attrib)
        self.classes[name] = own
        for child in elem:
            if child.tag == "default":
                self._defaults(child, name)

    def _defaults_of(self, elem: ET.Element, kind: str, childclass: str
                     ) -> Dict[str, str]:
        """The defaults of ``elem``'s class (its ``class``, else the
        nearest ``childclass`` around it) for its ``kind``."""
        cls = elem.get("class", childclass)
        if cls not in self.classes:
            raise ValueError(f"unknown default class '{cls}'")
        return self.classes[cls][kind]

    def _attrs(self, elem: ET.Element, kind: str, childclass: str
               ) -> Dict[str, str]:
        """``elem``'s attributes over its class's defaults."""
        return {**self._defaults_of(elem, kind, childclass), **elem.attrib}

    def _angle(self, x: float) -> float:
        """An orientation's angle in radians."""
        return x / 180.0 * MJ_PI if self.degree else x

    def _joint_angle(self, x: float) -> float:
        """A hinge's range, ref or springref in radians (MuJoCo multiplies
        these by π/180, and divides an orientation's by 180)."""
        return x * (MJ_PI / 180.0) if self.degree else x

    def _orientation(self, elem: ET.Element, a: Dict[str, str]
                     ) -> List[float]:
        """The unit quaternion of ``quat``, ``axisangle`` or ``euler``
        (identity if none is given)."""
        given = [k for k in ORIENTATIONS if k in a]
        if len(given) > 1:
            raise ValueError(f"<{elem.tag}> has several orientations: {given}")
        if not given:
            return [1.0, 0.0, 0.0, 0.0]
        kind = given[0]
        if kind == "quat":
            quat = _floats(elem, "quat", a["quat"], 4, 4)
        elif kind == "axisangle":
            aa = _floats(elem, "axisangle", a["axisangle"], 4, 4)
            axis = aa[:3]
            if _normvec(axis) < MJ_EPS:
                raise ValueError(f"<{elem.tag}> axisangle too small")
            ang2 = self._angle(aa[3]) / 2
            quat = [math.cos(ang2), math.sin(ang2) * axis[0],
                    math.sin(ang2) * axis[1], math.sin(ang2) * axis[2]]
        else:
            euler = [self._angle(x)
                     for x in _floats(elem, "euler", a["euler"], 3, 3)]
            quat = [1.0, 0.0, 0.0, 0.0]
            for i, axis in enumerate("xyz"):  # MuJoCo's eulerseq "xyz"
                rot = [math.cos(euler[i] / 2), 0.0, 0.0, 0.0]
                rot["xyz".index(axis) + 1] = math.sin(euler[i] / 2)
                quat = _mulquat(quat, rot)  # moving axes: post-multiply
        if _normvec(quat) < MJ_EPS:
            raise ValueError(f"<{elem.tag}> quaternion is zero")
        return quat

    # -- the body tree -----------------------------------------------------
    def compile(self) -> dict:
        if self.worldbody is None:
            raise ValueError("MJCF has no <worldbody>")
        self.bodies: List[dict] = [dict(
            parent=0, pos=[0.0] * 3, quat=[1.0, 0.0, 0.0, 0.0], mass=0.0,
            inertia=[0.0] * 3, ipos=[0.0] * 3, iquat=[1.0, 0.0, 0.0, 0.0])]
        self.joints: List[dict] = []
        self.joint_names: Dict[str, int] = {}
        self.geoms: List[dict] = []
        self._body_tree(self.worldbody, 0, "main")
        self._settotalmass()
        return self._system()

    def _body_tree(self, elem: ET.Element, b: int, childclass: str
                       ) -> None:
        """The geoms and joints of body ``b`` (element ``elem``), then its
        child bodies depth first."""
        geoms, joints, bodies = [], [], []
        for child in elem:
            if child.tag == "geom":
                geoms.append(child)
            elif child.tag == "joint":
                if b == 0:
                    raise ValueError("a joint on the world body")
                joints.append(child)
            elif child.tag == "body":
                bodies.append(child)
            elif child.tag == "inertial":
                raise NotImplementedError(
                    "MJCF element <inertial> is not supported (inertia "
                    "from the geoms only)")
            else:
                raise NotImplementedError(
                    f"MJCF element <{child.tag}> in a body is not supported")
        for j in joints:
            self._joint(j, b, childclass)
        body_geoms = [self._geom(g, b, childclass) for g in geoms]
        if b:
            self._inertia_from_geoms(self.bodies[b], body_geoms)
        self.geoms += body_geoms
        for child in bodies:
            _check_attrs(child)
            a = child.attrib
            pos = _floats(child, "pos", a["pos"], 3, 3) if "pos" in a \
                else [0.0] * 3
            nb = len(self.bodies)
            self.bodies.append(dict(
                parent=b, pos=pos, quat=self._orientation(child, a), mass=0.0,
                inertia=[0.0] * 3, ipos=[0.0] * 3,
                iquat=[1.0, 0.0, 0.0, 0.0]))
            self._body_tree(child, nb, a.get("childclass", childclass))

    def _joint(self, elem: ET.Element, b: int, childclass: str) -> None:
        _check_attrs(elem)
        a = self._attrs(elem, "joint", childclass)
        kind = a.get("type", "hinge")
        if kind not in JOINT_TYPES:
            raise NotImplementedError(f"joint type '{kind}' unsupported")
        jtype = JOINT_TYPES[kind]
        if jtype == FREE and self.bodies[b]["parent"] != 0:
            raise ValueError("a free joint on a body that is not a child "
                             "of the world body")
        axis = _floats(elem, "axis", a["axis"], 3, 3) if "axis" in a \
            else [0.0, 0.0, 1.0]
        if _normvec(axis) < MJ_EPS:
            raise ValueError(f"joint axis too small: {a.get('axis')}")
        rng = _floats(elem, "range", a["range"], 2, 2) if "range" in a \
            else [0.0, 0.0]
        ref = _floats(elem, "ref", a["ref"], 1, 1)[0] if "ref" in a else 0.0
        springref = (_floats(elem, "springref", a["springref"], 1, 1)[0]
                     if "springref" in a else 0.0)
        limited = _choice(elem, "limited", a.get("limited", "auto"),
                          {"true", "false", "auto"})
        # MuJoCo 3's autolimits: "auto" is limited where a range is given
        is_limited = limited == "true" or (limited == "auto" and "range" in a)
        if jtype == HINGE:
            # MuJoCo converts the range of a limited hinge only
            if is_limited:
                rng = [self._joint_angle(x) for x in rng]
            ref = self._joint_angle(ref)
            springref = self._joint_angle(springref)
        if is_limited and rng[0] >= rng[1]:
            raise ValueError(f"joint range {rng}: range[0] should be "
                             "smaller than range[1]")

        def scalar(attr):
            return _floats(elem, attr, a[attr], 1, 1)[0] if attr in a else 0.0

        self.joints.append(dict(
            body=b, type=jtype,
            pos=_floats(elem, "pos", a["pos"], 3, 3) if "pos" in a
            else [0.0] * 3,
            axis=axis, range=rng, limited=is_limited, ref=ref,
            springref=springref, damping=scalar("damping"),
            armature=scalar("armature"), stiffness=scalar("stiffness")))
        name = elem.get("name")
        if name is not None:
            self.joint_names[name] = len(self.joints) - 1

    def _geom(self, elem: ET.Element, b: int, childclass: str) -> dict:
        _check_attrs(elem)
        a = self._attrs(elem, "geom", childclass)
        kind = a.get("type", "sphere")
        if kind not in GEOM_TYPES:
            raise NotImplementedError(f"geom type '{kind}' unsupported")
        # the class's numbers, then the geom's own, over the front of each
        size, friction = [0.0] * 3, list(FRICTION)
        for layer in (self._defaults_of(elem, "geom", childclass),
                      elem.attrib):
            if "size" in layer:
                size = _fill(size, _floats(elem, "size", layer["size"], 1, 3))
            if "friction" in layer:
                friction = _fill(friction, _floats(
                    elem, "friction", layer["friction"], 1, 3))
        pos = _floats(elem, "pos", a["pos"], 3, 3) if "pos" in a \
            else [0.0] * 3
        if "fromto" in a:
            if kind != "capsule":
                raise NotImplementedError(
                    f"fromto on a '{kind}' geom is not supported")
            if "pos" in a or any(k in a for k in ORIENTATIONS):
                raise ValueError("a geom with fromto has no pos or "
                                 "orientation of its own")
            ft = _floats(elem, "fromto", a["fromto"], 6, 6)
            vec = [ft[0] - ft[3], ft[1] - ft[4], ft[2] - ft[5]]
            length = _normvec(vec)
            if length < MJ_EPS:
                raise ValueError("geom fromto: points too close")
            pos = [(ft[0] + ft[3]) / 2, (ft[1] + ft[4]) / 2,
                   (ft[2] + ft[5]) / 2]
            size[1] = length / 2
            quat = _z2quat(vec)
        else:
            quat = self._orientation(elem, a)
        if kind == "plane":
            if b != 0:
                raise ValueError("a plane geom on a moving body")
            if pos[2] != 0.0 or quat != [1.0, 0.0, 0.0, 0.0]:
                raise NotImplementedError(
                    "a plane other than the world's z = 0 ground plane")
            return dict(type=kind, body=b)
        need = {"sphere": 1, "capsule": 2, "box": 3}[kind]
        if any(s <= 0 for s in size[:need]):
            raise ValueError(f"{kind} geom size {size[:need]} must be > 0")
        density = _floats(elem, "density", a["density"], 1, 1)[0] \
            if "density" in a else DENSITY
        mass = density * _volume(kind, size)
        return dict(type=kind, body=b, size=size, pos=pos, quat=quat,
                    friction=friction[0], mass=mass,
                    inertia=_inertia(kind, size, mass))

    @staticmethod
    def _inertia_from_geoms(body: dict, geoms: List[dict]) -> None:
        """mjCBody::InertiaFromGeom: one geom's frame and inertia, or the
        several geoms' summed inertia diagonalised."""
        geoms = [g for g in geoms if g["type"] != "plane"]
        if not geoms:
            # no mass: MuJoCo puts the inertial frame at the body's frame
            # in its parent
            body.update(ipos=list(body["pos"]), iquat=list(body["quat"]))
        elif len(geoms) == 1:
            g = geoms[0]
            body.update(ipos=list(g["pos"]), iquat=list(g["quat"]),
                        mass=g["mass"], inertia=list(g["inertia"]))
        else:
            mass, com = 0.0, [0.0] * 3
            for g in geoms:
                mass += g["mass"]
                for k in range(3):
                    com[k] += g["mass"] * g["pos"][k]
            if mass < MJ_MINVAL:
                raise ValueError("body mass is too small")
            ipos = [c / mass for c in com]
            tot = [0.0] * 6
            for g in geoms:
                d = [g["pos"][k] - ipos[k] for k in range(3)]
                i0 = _global_inertia(g["inertia"], g["quat"])
                i1 = _offcenter(g["mass"], d)
                tot = [tot[k] + i0[k] + i1[k] for k in range(6)]
            full = [tot[0], tot[3], tot[4], tot[3], tot[1], tot[5],
                    tot[4], tot[5], tot[2]]
            eigval, quat = _eig3(full)
            if eigval[2] < MJ_EPS:
                raise ValueError("inertia must have positive eigenvalues")
            body.update(ipos=ipos, iquat=quat, mass=mass, inertia=eigval)

    def _settotalmass(self) -> None:
        if self.settotalmass <= 0:
            return
        total = _sum(b["mass"] for b in self.bodies[1:])
        scale = self.settotalmass / max(MJ_MINVAL, total)
        for b in self.bodies[1:]:
            b["mass"] *= scale
            b["inertia"] = [x * scale for x in b["inertia"]]

    # -- the System --------------------------------------------------------
    def _system(self) -> dict:
        bodies, joints = self.bodies, self.joints
        qposadr, dofadr, qpos0, qpos_spring = [], [], [], []
        dof_damping, dof_armature = [], []
        for j in joints:
            qposadr.append(len(qpos0))
            dofadr.append(len(dof_damping))
            if j["type"] == FREE:
                body = bodies[j["body"]]
                qpos0 += body["pos"] + body["quat"]
                qpos_spring += body["pos"] + body["quat"]
                nv = 6
            else:
                qpos0.append(j["ref"])
                qpos_spring.append(j["springref"])
                nv = 1
            dof_damping += [j["damping"]] * nv
            dof_armature += [j["armature"]] * nv
        act_joint, act_gear, act_ctrlrange = [], [], []
        for m in self.motors:
            a = self._attrs(m, "motor", "main")
            if "joint" not in a:
                raise NotImplementedError(
                    "a <motor> without a joint (joint-torque motors only)")
            if a["joint"] not in self.joint_names:
                raise ValueError(f"motor joint '{a['joint']}' not found")
            act_joint.append(self.joint_names[a["joint"]])
            gear = _fill([1.0, 0, 0, 0, 0, 0],
                         _floats(m, "gear", a["gear"], 1, 6)) \
                if "gear" in a else [1.0]
            act_gear.append(gear[0])
            ctrl = _floats(m, "ctrlrange", a["ctrlrange"], 2, 2) \
                if "ctrlrange" in a else [0.0, 0.0]
            limited = _choice(m, "ctrllimited", a.get("ctrllimited", "auto"),
                              {"true", "false", "auto"})
            if limited == "true" or (limited == "auto" and "ctrlrange" in a):
                if ctrl[0] >= ctrl[1]:
                    raise ValueError(f"motor ctrlrange {ctrl}: ctrlrange[0] "
                                     "should be smaller than ctrlrange[1]")
                act_ctrlrange.append(ctrl)
            else:
                act_ctrlrange.append([-1.0, 1.0])
        geoms = [g for g in self.geoms if g["body"] != 0]

        def arr(rows, width, dtype=np.float64):
            return np.array(rows, dtype).reshape((len(rows), width))

        return dict(
            body_parent=np.array([b["parent"] for b in bodies], int),
            body_pos=arr([b["pos"] for b in bodies], 3),
            body_quat=arr([b["quat"] for b in bodies], 4),
            body_mass=np.array([b["mass"] for b in bodies]),
            body_inertia=arr([b["inertia"] for b in bodies], 3),
            body_ipos=arr([b["ipos"] for b in bodies], 3),
            body_iquat=arr([b["iquat"] for b in bodies], 4),
            jnt_body=np.array([j["body"] for j in joints], int),
            jnt_type=np.array([j["type"] for j in joints], int),
            jnt_axis=arr([j["axis"] for j in joints], 3),
            jnt_pos=arr([j["pos"] for j in joints], 3),
            jnt_qposadr=np.array(qposadr, int),
            jnt_dofadr=np.array(dofadr, int),
            jnt_range=arr([j["range"] for j in joints], 2),
            jnt_limited=np.array([j["limited"] for j in joints], bool),
            jnt_stiffness=np.array([j["stiffness"] for j in joints],
                                   np.float64),
            qpos0=np.array(qpos0, np.float64),
            qpos_spring=np.array(qpos_spring, np.float64),
            dof_damping=np.array(dof_damping, np.float64),
            dof_armature=np.array(dof_armature, np.float64),
            act_joint=np.array(act_joint, int),
            act_gear=np.array(act_gear, np.float64),
            act_ctrlrange=arr(act_ctrlrange, 2),
            geom_body=np.array([g["body"] for g in geoms], int),
            geom_type=np.array([_MJ_GEOM[g["type"]] for g in geoms], int),
            geom_size=arr([g["size"] for g in geoms], 3),
            geom_pos=arr([g["pos"] for g in geoms], 3),
            geom_quat=arr([g["quat"] for g in geoms], 4),
            geom_friction=np.array([g["friction"] for g in geoms],
                                   np.float64),
            dt=float(self.timestep),
            gravity=np.array(self.gravity, np.float64),
        )


def _volume(kind: str, size) -> float:
    """mjCGeom::GetVolume."""
    if kind == "sphere":
        return 4 * MJ_PI * size[0] * size[0] * size[0] / 3
    if kind == "capsule":
        height = 2 * size[1]
        return MJ_PI * (size[0] * size[0] * height
                        + 4 * size[0] * size[0] * size[0] / 3)
    return size[0] * size[1] * size[2] * 8  # box


def _inertia(kind: str, size, mass: float) -> List[float]:
    """mjCGeom::GetInertia: the diagonal inertia in the geom's frame."""
    if kind == "sphere":
        i = 2 * mass * size[0] * size[0] / 5
        return [i, i, i]
    if kind == "capsule":
        height, radius = 2 * size[1], size[0]
        sphere_mass = mass * 4 * radius / (4 * radius + 3 * height)
        cylinder_mass = mass - sphere_mass
        ixy = cylinder_mass * (3 * radius * radius + height * height) / 12
        iz = cylinder_mass * radius * radius / 2
        sphere_inertia = 2 * sphere_mass * radius * radius / 5
        ixy += sphere_inertia + sphere_mass * height * (3 * radius
                                                        + 2 * height) / 8
        return [ixy, ixy, iz + sphere_inertia]
    return [mass * (size[1] * size[1] + size[2] * size[2]) / 3,  # box
            mass * (size[0] * size[0] + size[2] * size[2]) / 3,
            mass * (size[0] * size[0] + size[1] * size[1]) / 3]
