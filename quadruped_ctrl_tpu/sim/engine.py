"""Batched single-rigid-body + point-foot scenario simulator.

The batched replacement for the reference's PyBullet front-end
(scripts/walking_simulation.py): a pure-function physics step over a pytree
state, so thousands of (terrain x gait x velocity) scenarios run as one
vmapped/jitted program. Physics model:

* the body is the SRB the MPC assumes (mass 9, I = diag(0.07,0.26,0.242));
* stance feet are pinned where they touched down and transmit the
  controller's commanded ground-reaction forces when in contact with the
  terrain ("perfect force tracking" — the torque path is still computed and
  validated separately);
* swing feet kinematically track the controller's swing trajectory;
* joint positions/velocities are synthesized from foot targets via leg IK
  (knee-forward branch, the robot's crouch configuration);
* the IMU is synthesized exactly like the reference sim does from ground
  truth (body-frame gyro, finite-difference accelerometer + 9.8 bias,
  walking_simulation.py:536-558).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.core import rotations as rot
from quadruped_ctrl_tpu.core.types import ControllerOutput, Sensors
from quadruped_ctrl_tpu.models import leg_kinematics as lk
from quadruped_ctrl_tpu.sim.terrain import Terrain, height_at
from quadruped_ctrl_tpu.core.precision import exact_matmuls

CROUCH_Q = jnp.array([0.0, -0.8, 1.6], jnp.float32)  # walking_simulation.py:35


@struct.dataclass
class SimState:
    p: jnp.ndarray           # (3,) base position, world
    quat: jnp.ndarray        # (4,) (w,x,y,z), body->world
    v: jnp.ndarray           # (3,) base velocity, world
    omega_body: jnp.ndarray  # (3,)
    foot_pos: jnp.ndarray    # (4,3) actual foot positions, world
    foot_vel: jnp.ndarray    # (4,3) actual foot velocities, world
    in_contact: jnp.ndarray  # (4,) bool
    prev_v: jnp.ndarray      # (3,) for accelerometer synthesis


def sim_init(cfg: FrameworkConfig, terrain: Terrain) -> SimState:
    """Crouch pose with feet on the terrain (the reference drops from 0.30 m;
    we start settled to avoid the impact transient the SRB model can't
    represent)."""
    q = jnp.tile(CROUCH_Q, (4, 1))
    foot_hip = lk.leg_fk(cfg.robot, q)                      # (4,3) hip frame
    hips = jnp.asarray(cfg.robot.hip_locations())
    foot_body = hips + foot_hip
    base_z = -jnp.min(foot_body[:, 2])
    p = jnp.array([0.0, 0.0, base_z], jnp.float32)
    foot_w = p[None, :] + foot_body
    ground = height_at(terrain, foot_w[:, 0], foot_w[:, 1])
    foot_w = foot_w.at[:, 2].set(ground)
    return SimState(
        p=p,
        quat=jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32),
        v=jnp.zeros(3, jnp.float32),
        omega_body=jnp.zeros(3, jnp.float32),
        foot_pos=foot_w,
        foot_vel=jnp.zeros((4, 3), jnp.float32),
        in_contact=jnp.ones(4, dtype=bool),
        prev_v=jnp.zeros(3, jnp.float32),
    )


@exact_matmuls
def sensors_from_sim(cfg: FrameworkConfig, sim: SimState) -> Sensors:
    """Synthesize the reference's imu_data[10] + leg_data[24]
    (walking_simulation.py:521-573)."""
    r = rot.quat_to_rot(sim.quat)        # body->world
    r_inv = r.T
    dt = cfg.dt
    accel_world = (sim.v - sim.prev_v) / dt + jnp.array([0.0, 0.0, 9.8], jnp.float32)
    accel_body = r_inv @ accel_world

    hips = jnp.asarray(cfg.robot.hip_locations())
    p_leg = jnp.einsum("ij,fj->fi", r_inv, sim.foot_pos - sim.p[None, :]) - hips
    q = lk.leg_ik(cfg.robot, p_leg)
    jac = lk.leg_jacobian(cfg.robot, q)
    v_leg = (
        jnp.einsum("ij,fj->fi", r_inv, sim.foot_vel - sim.v[None, :])
        - jnp.cross(jnp.broadcast_to(sim.omega_body, (4, 3)), hips + p_leg)
    )
    # damped least-squares J qd = v: the plain solve is singular at knee
    # full extension (the reference's analytic IK clamps its asin/D inputs
    # for the same reason, LegController.cpp:255-287). lambda=1e-3 is
    # invisible at nominal configurations (relative error ~lambda^2/sigma^2)
    # and bounds qd near the singularity instead of emitting inf/NaN.
    lam2 = jnp.asarray(1e-6, jnp.float32)
    jjt = jnp.einsum("fij,fkj->fik", jac, jac) + lam2 * jnp.eye(3)[None]
    qd = jnp.einsum(
        "fji,fj->fi", jac, jnp.linalg.solve(jjt, v_leg[..., None])[..., 0]
    )

    quat_xyzw = jnp.stack([sim.quat[1], sim.quat[2], sim.quat[3], sim.quat[0]])
    return Sensors(
        quat=quat_xyzw,
        gyro=sim.omega_body,
        accelerometer=accel_body,
        q=q.reshape(12),
        qd=qd.reshape(12),
    )


@exact_matmuls
def sim_step(
    cfg: FrameworkConfig, sim: SimState, out: ControllerOutput, terrain: Terrain
) -> SimState:
    """One physics tick driven by the controller output."""
    dt = cfg.dt
    m = cfg.mpc.mass
    i_body = jnp.asarray(cfg.mpc.inertia_arr())
    r = rot.quat_to_rot(sim.quat)        # body->world
    g = jnp.array([0.0, 0.0, -cfg.sim.gravity], jnp.float32)

    in_stance = out.contact_state > 0.0

    # feet: swing feet track the commanded trajectory; stance feet stay put
    ground_sw = height_at(terrain, out.p_foot_des[:, 0], out.p_foot_des[:, 1])
    p_sw = out.p_foot_des.at[:, 2].max(ground_sw)
    foot_pos = jnp.where(in_stance[:, None], sim.foot_pos, p_sw)
    foot_vel = jnp.where(in_stance[:, None], 0.0, out.v_foot_des)

    # contact requires the foot to actually reach the terrain
    ground = height_at(terrain, foot_pos[:, 0], foot_pos[:, 1])
    touching = foot_pos[:, 2] <= ground + 5e-3
    active = in_stance & touching

    forces = jnp.where(active[:, None], out.fr_des, 0.0)   # (4,3) world GRFs
    f_total = jnp.sum(forces, axis=0) + m * g
    torque_world = jnp.sum(
        jnp.cross(sim.foot_pos - sim.p[None, :], forces), axis=0
    )
    torque_body = r.T @ torque_world

    v_new = sim.v + dt * f_total / m
    p_new = sim.p + dt * v_new
    i_diag = jnp.diagonal(i_body)
    omega_dot = (
        torque_body - jnp.cross(sim.omega_body, i_diag * sim.omega_body)
    ) / i_diag
    omega_new = sim.omega_body + dt * omega_dot
    quat_new = rot.quat_integrate(sim.quat, omega_new, dt)

    return SimState(
        p=p_new,
        quat=quat_new,
        v=v_new,
        omega_body=omega_new,
        foot_pos=foot_pos,
        foot_vel=foot_vel,
        in_contact=active,
        prev_v=sim.v,
    )
