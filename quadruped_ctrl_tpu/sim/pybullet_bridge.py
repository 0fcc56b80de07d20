"""PyBullet bridge for single-robot parity runs against the reference.

Mirrors the reference's simulator host (scripts/walking_simulation.py): the
same URDF, the same reset/stand-up sequence (:170-198), the same per-tick
sensor synthesis (:521-573) and torque application (:239-244) — but the
torques come from this controller (directly or through the native FFI
runtime). PyBullet is an optional dependency; without it this module
degrades to a clear ImportError and is exercised wherever pybullet exists.

Usage:
    bridge = PyBulletBridge(cfg, terrain="plane", gui=False)
    bridge.reset()
    for _ in range(5000):
        bridge.step()                       # 500 Hz closed loop
    print(bridge.base_position())
"""

from __future__ import annotations

import numpy as np

try:
    import pybullet as pb
    import pybullet_data
    HAVE_PYBULLET = True
except ImportError:  # pragma: no cover - optional dependency
    pb = None
    HAVE_PYBULLET = False

MOTOR_IDS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14]
INIT_POS = [0.0, -0.8, 1.6] * 4


class PyBulletBridge:
    def __init__(self, cfg=None, terrain: str = "plane", gui: bool = False,
                 lateral_friction: float = 1.0, spinning_friction: float = 0.0065):
        if not HAVE_PYBULLET:
            raise ImportError(
                "pybullet is not installed; the bridge runs only on hosts "
                "with pybullet (use sim.engine / sim.articulated here)"
            )
        from quadruped_ctrl_tpu.config import default_config
        from quadruped_ctrl_tpu.runtime.native import NativeController

        self.cfg = cfg or default_config()
        self.freq = self.cfg.sim.freq
        self.last_vel = [0.0, 0.0, 0.0]

        pb.connect(pb.GUI if gui else pb.DIRECT)
        pb.setAdditionalSearchPath(pybullet_data.getDataPath())
        pb.resetSimulation()
        pb.setTimeStep(1.0 / self.freq)
        pb.setGravity(0, 0, -9.81)

        if terrain == "plane":
            plane = pb.createCollisionShape(shapeType=pb.GEOM_PLANE)
            ground = pb.createMultiBody(0, plane)
            pb.changeDynamics(ground, -1, lateralFriction=lateral_friction)
        elif terrain == "random":
            rows = cols = 256
            data = np.repeat(
                np.repeat(np.random.uniform(0, 0.06, (rows // 2, cols // 2)), 2, 0),
                2, 1,
            ).reshape(-1)
            shape = pb.createCollisionShape(
                shapeType=pb.GEOM_HEIGHTFIELD, meshScale=[0.05, 0.05, 1],
                heightfieldData=data, numHeightfieldRows=rows,
                numHeightfieldColumns=cols,
            )
            ground = pb.createMultiBody(0, shape)
            pb.changeDynamics(ground, -1, lateralFriction=lateral_friction)
        elif terrain == "stairs":
            plane = pb.createCollisionShape(shapeType=pb.GEOM_PLANE)
            pb.createMultiBody(0, plane)
            for i, hz in enumerate([0.01, 0.02, 0.03, 0.04]):
                box = pb.createCollisionShape(
                    pb.GEOM_BOX, halfExtents=[0.1, 0.4, hz]
                )
                pb.createMultiBody(100, box, basePosition=[1.0 + 0.2 * i, 1.0, 0.0])
        else:
            raise ValueError(terrain)

        self.robot = pb.loadURDF(
            "mini_cheetah/mini_cheetah.urdf", [0, 0, 0.42], useFixedBase=False
        )
        for link in (3, 7, 11, 15):
            pb.changeDynamics(self.robot, link, spinningFriction=spinning_friction)

        self.controller = NativeController(self.cfg)

    # ------------------------------------------------------------- session
    def reset(self):
        """The reference reset sequence (walking_simulation.py:170-198)."""
        pb.resetBasePositionAndOrientation(self.robot, [0, 0, 0.30], [0, 0, 0, 1])
        pb.resetBaseVelocity(self.robot, [0, 0, 0], [0, 0, 0])
        for j in range(12):
            pb.resetJointState(self.robot, MOTOR_IDS[j], INIT_POS[j], 0.0)
        c = self.cfg.control
        self.controller.init_controller(
            self.freq, [c.stand_kp, c.stand_kd, c.joint_kp, c.joint_kd]
        )
        for _ in range(10):
            pb.stepSimulation()
            imu, leg = self._sensors()
            self.controller.pre_work(imu, leg)
        for j in range(16):
            pb.setJointMotorControl2(self.robot, j, pb.VELOCITY_CONTROL, force=0)
        self.controller.set_robot_mode(1)
        for _ in range(200):
            self.step()
        self.controller.set_robot_mode(0)

    def step(self):
        imu, leg = self._sensors()
        tau = self.controller.torque_calculator(imu, leg)
        pb.setJointMotorControlArray(
            bodyUniqueId=self.robot, jointIndices=MOTOR_IDS,
            controlMode=pb.TORQUE_CONTROL, forces=tau.tolist(),
        )
        pb.stepSimulation()
        return tau

    # commands (the gait_type / robot_mode / cmd_vel surface)
    def set_gait(self, gait: int):
        self.controller.set_gait_type(gait)

    def set_mode(self, mode: int):
        self.controller.set_robot_mode(mode)

    def set_vel(self, vx: float, vy: float, wz: float):
        self.controller.set_robot_vel([vx, vy, wz])

    def base_position(self):
        return pb.getBasePositionAndOrientation(self.robot)[0]

    # ------------------------------------------------------------ sensors
    def _sensors(self):
        """imu_data[10] + leg_data[24] exactly as walking_simulation.py:521-573."""
        pos, orn = pb.getBasePositionAndOrientation(self.robot)
        lin_vel, ang_vel = pb.getBaseVelocity(self.robot)
        inv_pos, inv_orn = pb.invertTransform(pos, orn)
        m = pb.getMatrixFromQuaternion(inv_orn)

        imu = np.zeros(10)
        imu[3:7] = orn
        imu[7] = m[0] * ang_vel[0] + m[1] * ang_vel[1] + m[2] * ang_vel[2]
        imu[8] = m[3] * ang_vel[0] + m[4] * ang_vel[1] + m[5] * ang_vel[2]
        imu[9] = m[6] * ang_vel[0] + m[7] * ang_vel[1] + m[8] * ang_vel[2]
        ax = (lin_vel[0] - self.last_vel[0]) * self.freq
        ay = (lin_vel[1] - self.last_vel[1]) * self.freq
        az = 9.8 + (lin_vel[2] - self.last_vel[2]) * self.freq
        imu[0] = m[0] * ax + m[1] * ay + m[2] * az
        imu[1] = m[3] * ax + m[4] * ay + m[5] * az
        imu[2] = m[6] * ax + m[7] * ay + m[8] * az
        self.last_vel = list(lin_vel)

        leg = np.zeros(24)
        states = pb.getJointStates(self.robot, MOTOR_IDS)
        leg[0:12] = [s[0] for s in states]
        leg[12:24] = [s[1] for s in states]
        return imu, leg
