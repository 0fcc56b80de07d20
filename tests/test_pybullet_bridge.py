"""Executed coverage for the PyBullet bridge (sim/pybullet_bridge.py).

pybullet is an optional dependency that the test environment lacks, so
the bridge's logic —
terrain construction calls, the reference reset/stand-up sequence
(walking_simulation.py:170-198), the exact imu[10]/leg[24] sensor packing
(:521-573) and the torque-application call (:239-244) — is exercised here
against a minimal in-memory fake of the pybullet API surface the bridge
uses. The controller behind it is the REAL native runtime + jitted
controller (runtime/native.py), so a full stand-up session runs end to end;
only the physics stepping is fake (the robot stays at its reset pose).
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _make_fake_pybullet():
    pb = types.ModuleType("pybullet")
    pb.GUI, pb.DIRECT = 1, 2
    pb.GEOM_PLANE, pb.GEOM_HEIGHTFIELD, pb.GEOM_BOX = 10, 11, 12
    pb.VELOCITY_CONTROL, pb.TORQUE_CONTROL = 20, 21

    state = dict(
        base_pos=(0.0, 0.0, 0.30),
        base_orn=(0.0, 0.0, 0.0, 1.0),       # xyzw
        lin_vel=(0.0, 0.0, 0.0),
        ang_vel=(0.0, 0.0, 0.0),
        joints={},                            # id -> (pos, vel)
        torques=[],                           # recorded TORQUE_CONTROL calls
        bodies=0,
        calls=[],
    )
    pb._state = state

    def _rec(name):
        def f(*a, **k):
            state["calls"].append(name)
        return f

    pb.connect = _rec("connect")
    pb.resetSimulation = _rec("resetSimulation")
    pb.setTimeStep = _rec("setTimeStep")
    pb.setGravity = _rec("setGravity")
    pb.setAdditionalSearchPath = _rec("setAdditionalSearchPath")
    pb.changeDynamics = _rec("changeDynamics")
    pb.stepSimulation = _rec("stepSimulation")
    pb.setJointMotorControl2 = _rec("setJointMotorControl2")

    def createCollisionShape(shapeType=None, **kw):
        state["calls"].append(("shape", shapeType))
        return 100 + shapeType

    def createMultiBody(mass, shape, basePosition=None):
        state["bodies"] += 1
        return state["bodies"]

    def loadURDF(path, pos, useFixedBase=False):
        state["calls"].append(("loadURDF", path))
        state["bodies"] += 1
        return state["bodies"]

    def resetBasePositionAndOrientation(body, pos, orn):
        state["base_pos"], state["base_orn"] = tuple(pos), tuple(orn)

    def resetBaseVelocity(body, lin, ang):
        state["lin_vel"], state["ang_vel"] = tuple(lin), tuple(ang)

    def resetJointState(body, jid, pos, vel):
        state["joints"][jid] = (pos, vel)

    def getBasePositionAndOrientation(body):
        return state["base_pos"], state["base_orn"]

    def getBaseVelocity(body):
        return state["lin_vel"], state["ang_vel"]

    def invertTransform(pos, orn):
        # identity orientation in the tests: inverse == (-pos, orn)
        return tuple(-p for p in pos), orn

    def getMatrixFromQuaternion(orn):
        x, y, z, w = orn
        # standard xyzw quaternion -> row-major rotation matrix
        return (
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        )

    def getJointStates(body, ids):
        return [state["joints"].get(j, (0.0, 0.0)) + ((), 0.0) for j in ids]

    def setJointMotorControlArray(bodyUniqueId=None, jointIndices=None,
                                  controlMode=None, forces=None):
        state["torques"].append(list(forces))

    pb.createCollisionShape = createCollisionShape
    pb.createMultiBody = createMultiBody
    pb.loadURDF = loadURDF
    pb.resetBasePositionAndOrientation = resetBasePositionAndOrientation
    pb.resetBaseVelocity = resetBaseVelocity
    pb.resetJointState = resetJointState
    pb.getBasePositionAndOrientation = getBasePositionAndOrientation
    pb.getBaseVelocity = getBaseVelocity
    pb.invertTransform = invertTransform
    pb.getMatrixFromQuaternion = getMatrixFromQuaternion
    pb.getJointStates = getJointStates
    pb.setJointMotorControlArray = setJointMotorControlArray

    pbd = types.ModuleType("pybullet_data")
    pbd.getDataPath = lambda: "/nonexistent"
    return pb, pbd


@pytest.fixture()
def bridge_mod(monkeypatch):
    pb, pbd = _make_fake_pybullet()
    monkeypatch.setitem(sys.modules, "pybullet", pb)
    monkeypatch.setitem(sys.modules, "pybullet_data", pbd)
    import importlib

    import quadruped_ctrl_tpu.sim.pybullet_bridge as m
    m = importlib.reload(m)
    yield m, pb
    monkeypatch.delitem(sys.modules, "pybullet")
    monkeypatch.delitem(sys.modules, "pybullet_data")
    importlib.reload(m)


def test_bridge_reset_and_step(bridge_mod):
    m, pb = bridge_mod
    assert m.HAVE_PYBULLET
    bridge = m.PyBulletBridge(terrain="plane", gui=False)
    bridge.reset()                       # 10 warmups + 200 stand ticks
    # the reference reset crouch pose reached every motor joint
    for j, jid in enumerate(m.MOTOR_IDS):
        assert pb._state["joints"][jid][0] == m.INIT_POS[j]
    # 200 stand-up torque commands were applied, 12 finite torques each
    assert len(pb._state["torques"]) == 200
    taus = np.asarray(pb._state["torques"])
    assert taus.shape == (200, 12) and np.isfinite(taus).all()
    # standing controller pushes down on the world (positive knee torques
    # appear within the stand phase, i.e. not all zero)
    assert np.abs(taus[-1]).max() > 0.0

    bridge.set_gait(9)
    bridge.set_vel(0.4, 0.0, 0.0)
    tau = bridge.step()
    assert tau.shape == (12,) and np.isfinite(tau).all()
    assert len(bridge.base_position()) == 3


def test_bridge_sensor_packing(bridge_mod):
    """imu[10] = [accel(3), quat xyzw(4), gyro(3)], leg[24] = [q, qd] —
    walking_simulation.py:536-565 layout, with the 9.8 z-bias."""
    m, pb = bridge_mod
    bridge = m.PyBulletBridge(terrain="stairs")
    pb._state["base_orn"] = (0.0, 0.0, 0.0, 1.0)
    pb._state["ang_vel"] = (0.1, -0.2, 0.3)
    pb._state["lin_vel"] = (0.5, 0.0, 0.0)
    bridge.last_vel = [0.0, 0.0, 0.0]
    for j, jid in enumerate(m.MOTOR_IDS):
        pb._state["joints"][jid] = (0.01 * j, -0.02 * j)
    imu, leg = bridge._sensors()
    np.testing.assert_allclose(imu[3:7], [0, 0, 0, 1])
    np.testing.assert_allclose(imu[7:10], [0.1, -0.2, 0.3])
    # accel: finite-difference of lin_vel at freq + 9.8 bias on z
    np.testing.assert_allclose(imu[0], 0.5 * bridge.freq)
    np.testing.assert_allclose(imu[2], 9.8)
    np.testing.assert_allclose(leg[0:12], [0.01 * j for j in range(12)])
    np.testing.assert_allclose(leg[12:24], [-0.02 * j for j in range(12)])


def test_bridge_clear_import_error_without_pybullet():
    import quadruped_ctrl_tpu.sim.pybullet_bridge as m
    if m.HAVE_PYBULLET:  # pragma: no cover - container has no pybullet
        pytest.skip("real pybullet present")
    with pytest.raises(ImportError):
        m.PyBulletBridge()
