"""The port's MJCF compiler (cadm_tpu_torch/physics/rigid/mjcf.py) against
the JAX package's ``system_from_mjcf``, which compiles through mujoco.

For the four assets and for one small MJCF string per feature, every
System field is held to the reference's: int and bool fields equal, float
fields within 1e-12 absolute, and the float32 casts (what the engine's
tensors and the K2 kernel's table are built from) equal bit for bit. The
compiler follows MuJoCo 3.10's order of operations, so the float64 fields
are also equal bit for bit (mujoco's own rounding, sign of zero included):
an operation done in another order shows here. The
assets also equal the committed npz files (mujoco's compilation recorded by
scripts/make_torch_systems.py), and the port's asset copies are
byte-identical to the JAX package's. What the compiler does not support
raises ``NotImplementedError``.
"""
import dataclasses
import os

import numpy as np
import pytest

from cadm_tpu.physics.rigid.mjcf import system_from_mjcf as ref_compile
from cadm_tpu_torch.envs.rigid_base import (
    ASSET_DIR,
    ASSETS,
    load_system,
    npz_system,
)
from cadm_tpu_torch.physics.rigid.mjcf import system_from_mjcf

REF_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "cadm_tpu",
                             "envs", "assets")
ATOL = 1e-12


def assert_same_system(port, ref):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (
            name, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(
            a.astype(np.float32).view(np.uint32),
            b.astype(np.float32).view(np.uint32), err_msg=name)
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64),
                                      err_msg=name)
    assert type(port.dt) is type(ref.dt)


def read(directory, asset):
    with open(os.path.join(directory, asset + ".xml")) as f:
        return f.read()


@pytest.mark.parametrize("asset", ASSETS)
def test_asset_equals_mujoco_compilation(asset):
    """The port's copy compiled here = the reference's asset through
    mujoco; and the copy is the reference's file byte for byte."""
    with open(os.path.join(ASSET_DIR, asset + ".xml"), "rb") as f, \
            open(os.path.join(REF_ASSET_DIR, asset + ".xml"), "rb") as g:
        assert f.read() == g.read()
    assert_same_system(system_from_mjcf(read(ASSET_DIR, asset)),
                       ref_compile(read(REF_ASSET_DIR, asset)))
    # what the envs load, against the recorded compilation
    assert_same_system(load_system(asset), npz_system(asset))


def world(body, head=""):
    return (f'<mujoco>{head}<worldbody><geom type="plane" size="5 5 .1"/>'
            f'{body}</worldbody></mujoco>')


# one MJCF string per feature the compiler supports
FEATURES = {
    "default_classes": world(
        '<body childclass="a" pos="0 0 1"><joint type="slide" axis="1 0 0"/>'
        '<geom size=".1"/><body childclass="b" pos="0 0 -.3">'
        '<joint range="-10 20"/><geom fromto="0 0 0 0 0 -.2" size=".05"/>'
        '</body><body pos=".2 0 0"><joint class="b" axis="0 1 0"/>'
        '<geom class="main" size=".03"/></body></body>',
        '<default><joint damping="2" armature=".3"/>'
        '<geom density="300" friction=".7"/><default class="a">'
        '<joint stiffness="5"/><geom type="capsule" size=".1 .2"/>'
        '<default class="b"><joint damping="7"/></default></default>'
        '</default>'),
    "fromto": world(
        '<body><joint/><geom type="capsule" fromto=".1 .2 .3 -.4 .5 .6" '
        'size=".05"/><body pos="0 0 -1"><joint/><geom type="capsule" '
        'fromto="0 0 0 0 0 -1" size=".1"/></body><body pos="1 0 0"><joint/>'
        '<geom type="capsule" fromto="0 0 0 0 0 1" size=".1"/></body></body>'),
    "axisangle": world(
        '<body axisangle="1 2 3 40"><joint/><geom type="capsule" '
        'size=".05 .2" axisangle="0 1 0 90"/></body>'),
    "euler": world(
        '<body euler="10 20 30"><joint/><geom type="box" size=".1 .2 .3" '
        'euler="-40 15 70"/></body>'),
    "quat": world(
        '<body quat="1 0.1 0 -0.2"><joint/><geom type="capsule" '
        'size=".05 .2" quat="0.3 0 1 0"/></body>'),
    "degree": world(
        '<body><joint axis="1 1 0" range="-30 45" ref="5" springref="-7"/>'
        '<joint axis="0 1 0" range="-85 60" limited="false"/>'
        '<geom size=".1" euler="0 0 33"/></body>'),
    "radian": world(
        '<body euler="0.1 0.2 0.3"><joint axis="1 1 0" range="-.3 .45" '
        'ref=".05"/><geom type="box" size=".1 .2 .3" euler="-.4 .15 .7"/>'
        '</body>', '<compiler angle="radian"/>'),
    "settotalmass": world(
        '<body><joint/><geom size=".1"/><geom type="box" size=".1 .1 .2" '
        'pos=".3 0 0"/><body pos="1 0 0"><joint/><geom type="capsule" '
        'fromto="0 0 0 0 0 -1" size=".1"/></body></body>',
        '<compiler settotalmass="10"/>'),
    "density": world(
        '<body><joint/><geom size=".1" density="7"/><body pos="0 .2 0">'
        '<joint/><geom type="capsule" size=".1 .3" density="123"/></body>'
        '</body>', '<default><geom density="50"/></default>'),
    "free": world(
        '<body pos="0.1 0.2 1" quat="0.9 0 0.1 0"><joint type="free"/>'
        '<geom size=".1"/><body pos=".2 0 0"><joint axis="0 1 0" '
        'range="-1 1"/><geom size=".05"/></body></body><body pos="0 0 2">'
        '<joint type="free" damping=".5" armature=".2"/><geom size=".1"/>'
        '</body>', '<compiler angle="radian"/>'),
    "slide": world(
        '<body pos="0 0 1"><joint type="slide" axis="0 0 1" pos="0 0 -1" '
        'range="-2 2" limited="true" stiffness="3"/><geom size=".1"/>'
        '</body>'),
    "hinge": world(
        '<body><joint range="-10 10"/><joint axis="1 0 0"/><joint '
        'axis="2 1 1" pos=".1 0 0" damping="3" armature=".01"/>'
        '<geom size=".1"/></body>'),
    "ref": world(
        '<body pos="0 0 1.25"><joint type="slide" axis="0 0 1" '
        'pos="0 0 -1.25" ref="1.25" springref=".5"/><joint axis="0 1 0" '
        'ref="20" springref="-10"/><geom size=".1"/></body>'),
    "ctrllimited_false": world(
        '<body><joint name="j1"/><joint name="j2" axis="1 0 0"/>'
        '<joint name="j3" axis="0 1 0"/><geom size=".1"/></body>',
        '<default><motor gear="3"/></default><actuator>'
        '<motor joint="j1" gear="5" ctrllimited="false" ctrlrange="-3 3"/>'
        '<motor joint="j2" gear="7 0 0 0 0 0" ctrlrange="-2 1"/>'
        '<motor joint="j3"/></actuator>'),
    "multi_geom_body": world(
        '<body><joint/><geom type="box" size=".3 .2 .1" quat="1 1 0 0"/>'
        '<geom size=".05" pos=".4 .1 0"/><geom type="capsule" '
        'fromto="0 0 0 .2 .3 .4" size=".02"/></body><body pos="0 0 1">'
        '<joint/><geom size=".1" pos="0 0 .1"/><geom size=".1" '
        'pos="0 0 -.1"/></body>'
        # two equal principal moments about a skewed axis: the frame is
        # not unique, so only MuJoCo's own eigensolver gives its frame
        '<body pos="1 0 0"><joint/><geom size=".1" pos=".1 .2 .3"/>'
        '<geom size=".1" pos="-.1 -.2 -.3"/></body>'
        '<body pos="2 0 0"><joint/><geom type="capsule" '
        'fromto="0 0 0 .3 .1 .2" size=".05"/><geom type="capsule" '
        'fromto="0 0 0 -.1 .3 .2" size=".04"/></body>'),
    "sphere_mapped_box": world(
        '<geom type="box" size=".3 .3 .3"/><body><joint/><geom type="box" '
        'size=".1 .2 .3" pos=".1 0 0" friction=".6"/><body pos="0 0 1"/>'
        '</body>'),
    "option": world('<body><joint/><geom size=".1"/></body>',
                    '<option timestep="0.005" gravity="0 -1 -9"/>'),
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_equals_mujoco_compilation(feature):
    xml = FEATURES[feature]
    assert_same_system(system_from_mjcf(xml), ref_compile(xml))


def test_overrides_are_set_after_the_compile():
    xml = FEATURES["hinge"]
    port = system_from_mjcf(xml, solver_iters=3, dt=0.01)
    assert_same_system(port, ref_compile(xml, solver_iters=3, dt=0.01))


BODY = '<body><joint {}/><geom size=".1" {}/></body>'


@pytest.mark.parametrize("xml,refused_by_reference", [
    (world(BODY.format('type="ball"', "")), True),
    (world(BODY.format('frictionloss="1"', "")), False),
    (world(BODY.format("", 'shellinertia="true"')), False),
    (world('<body><joint/><geom type="cylinder" size=".1 .2"/></body>'),
     False),
    (world('<body><joint/><inertial pos="0 0 0" mass="1" '
           'diaginertia="1 1 1"/></body>'), False),
    (world('<body><joint name="j"/><geom size=".1"/></body>',
           '<actuator><position joint="j"/></actuator>'), False),
], ids=["ball_joint", "joint_attribute", "geom_attribute", "cylinder",
        "inertial", "position_actuator"])
def test_unsupported_input_raises(xml, refused_by_reference):
    """An unsupported joint type raises as the reference raises; an
    attribute, element or geom type the compiler does not compute raises
    and is named."""
    with pytest.raises(NotImplementedError):
        system_from_mjcf(xml)
    if refused_by_reference:
        with pytest.raises(NotImplementedError):
            ref_compile(xml)
