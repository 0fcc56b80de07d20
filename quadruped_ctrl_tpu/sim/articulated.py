"""Articulated whole-robot simulation (18-DoF Featherstone + penalty contact).

The full-fidelity counterpart of the SRB scenario engine: joint torques from
the controller drive the actual rigid-body dynamics (CRBA/RNEA forward
dynamics + actuator saturation), feet make ground contact through a
spring-damper penalty with a Coulomb friction cap — the role PyBullet plays
for the reference (walking_simulation.py:224-244), as a pure jittable step.

Semi-implicit Euler with substeps keeps the stiff contact stable at the
500 Hz control rate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.core import rotations as rot
from quadruped_ctrl_tpu.core.types import Sensors
from quadruped_ctrl_tpu.models import actuator
from quadruped_ctrl_tpu.models import leg_kinematics as lk
from quadruped_ctrl_tpu.models.floating_base import MiniCheetahModel
from quadruped_ctrl_tpu.sim.engine import CROUCH_Q
from quadruped_ctrl_tpu.sim.terrain import Terrain, height_at
from quadruped_ctrl_tpu.core.precision import exact_matmuls


@struct.dataclass
class ArticulatedState:
    p: jnp.ndarray           # (3,) base position, world
    quat: jnp.ndarray        # (4,) (w,x,y,z) body->world
    base_vel: jnp.ndarray    # (6,) spatial [omega; v] in base coords
    q: jnp.ndarray           # (12,)
    qd: jnp.ndarray          # (12,)
    prev_v_world: jnp.ndarray  # (3,) for accelerometer synthesis


def articulated_init(cfg: FrameworkConfig, model: MiniCheetahModel,
                     terrain: Terrain) -> ArticulatedState:
    q = jnp.tile(CROUCH_Q, (4,))
    feet = model.foot_positions_base(q)
    base_z = -jnp.min(feet[:, 2]) + 0.002
    return ArticulatedState(
        p=jnp.array([0.0, 0.0, base_z], jnp.float32),
        quat=jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32),
        base_vel=jnp.zeros(6, jnp.float32),
        q=q,
        qd=jnp.zeros(12, jnp.float32),
        prev_v_world=jnp.zeros(3, jnp.float32),
    )


@exact_matmuls
def sensors_from_articulated(cfg: FrameworkConfig, st: ArticulatedState) -> Sensors:
    r = rot.quat_to_rot(st.quat)          # body->world
    v_world = r @ st.base_vel[3:6]
    accel_world = (v_world - st.prev_v_world) / cfg.dt + jnp.array(
        [0.0, 0.0, 9.8], jnp.float32
    )
    accel_body = r.T @ accel_world
    quat_xyzw = jnp.stack([st.quat[1], st.quat[2], st.quat[3], st.quat[0]])
    return Sensors(
        quat=quat_xyzw,
        gyro=st.base_vel[0:3],
        accelerometer=accel_body,
        q=st.q,
        qd=st.qd,
    )


def _contact_forces(cfg: FrameworkConfig, model, st: ArticulatedState,
                    terrain: Terrain, r):
    """World-frame penalty contact forces at the 4 feet. Returns (f_world
    (4,3), feet_world (4,3))."""
    feet_base = model.foot_positions_base(st.q)
    feet_world = st.p[None, :] + jnp.einsum("ij,fj->fi", r, feet_base)
    jac = model.contact_jacobians(st.q)                      # (4,3,18), base
    gen_vel = jnp.concatenate([st.base_vel, st.qd])
    v_feet_base = jnp.einsum("fij,j->fi", jac, gen_vel)
    v_feet_world = jnp.einsum("ij,fj->fi", r, v_feet_base)

    ground = height_at(terrain, feet_world[:, 0], feet_world[:, 1])
    depth = ground - feet_world[:, 2]                        # >0 => penetrating
    in_contact = depth > 0.0

    kp, kd = cfg.sim.ground_kp, cfg.sim.ground_kd
    fz = jnp.where(
        in_contact,
        jnp.maximum(kp * depth - kd * v_feet_world[:, 2], 0.0),
        0.0,
    )
    kt = 800.0
    ft = -kt * v_feet_world[:, 0:2]
    cap = cfg.sim.mu * fz
    ft_norm = jnp.linalg.norm(ft, axis=1)
    scale = jnp.where(ft_norm > cap, cap / jnp.maximum(ft_norm, 1e-9), 1.0)
    ft = ft * (scale * in_contact)[:, None]
    f_world = jnp.concatenate([ft, fz[:, None]], axis=1)
    return f_world, feet_world


@exact_matmuls
def articulated_step(cfg: FrameworkConfig, model: MiniCheetahModel,
                     st: ArticulatedState, tau_cmd, terrain: Terrain,
                     substeps: int = 4) -> ArticulatedState:
    """One control tick (cfg.dt) of full dynamics under commanded torques."""
    h = cfg.dt / substeps
    tau = actuator.achievable_torque(cfg.robot, tau_cmd, st.qd)
    prev_v_world = rot.quat_to_rot(st.quat) @ st.base_vel[3:6]

    def sub(st, _):
        r = rot.quat_to_rot(st.quat)
        r_body = r.T
        f_world, _ = _contact_forces(cfg, model, st, terrain, r)
        f_base = jnp.einsum("ij,fj->fi", r_body, f_world)
        qdd = model.forward_dynamics(
            st.q, st.qd, st.base_vel, tau, r_body=r_body, f_ext_feet=f_base,
            gravity=cfg.sim.gravity,
        )
        base_vel = st.base_vel + h * qdd[0:6]
        qd = st.qd + h * qdd[6:18]
        q = st.q + h * qd
        quat = rot.quat_integrate(st.quat, base_vel[0:3], h)
        p = st.p + h * (rot.quat_to_rot(quat) @ base_vel[3:6])
        return st.replace(p=p, quat=quat, base_vel=base_vel, q=q, qd=qd), None

    st, _ = jax.lax.scan(sub, st, None, length=substeps)
    return st.replace(prev_v_world=prev_v_world)


@exact_matmuls
def run_articulated_session(cfg: FrameworkConfig, terrain: Terrain,
                            cmd, n_ticks: int, stand_ticks: int = 400,
                            model: MiniCheetahModel | None = None,
                            mpc_iterations: int | None = None):
    """Closed-loop session on full dynamics (stand phase, then `cmd`).

    Returns (controller_state, sim_state, traj dict) like sim.rollout but
    driven through joint torques + actuator saturation + penalty contact.
    """
    from quadruped_ctrl_tpu.control import controller as ctrl
    from quadruped_ctrl_tpu.core.types import Command

    model = model or MiniCheetahModel()
    sim0 = articulated_init(cfg, model, terrain)
    state0 = ctrl.init_state(cfg)

    def warm(carry, _):
        state, sim = carry
        s = sensors_from_articulated(cfg, sim)
        return (ctrl.pre_work(cfg, state, s), sim), None

    (state0, sim0), _ = jax.lax.scan(warm, (state0, sim0), None, length=10)

    stand = Command.create(0.0, 0.0, 0.0, gait_type=9, robot_mode=1)

    def cmd_at(i):
        use_stand = i < stand_ticks
        return Command(
            vel=jnp.where(use_stand, stand.vel, cmd.vel),
            gait_type=jnp.where(use_stand, stand.gait_type, cmd.gait_type),
            robot_mode=jnp.where(use_stand, stand.robot_mode, cmd.robot_mode),
        )

    cmds = jax.vmap(cmd_at)(jnp.arange(n_ticks))

    def tick(carry, c):
        state, sim = carry
        sens = sensors_from_articulated(cfg, sim)
        state, out = ctrl.controller_step(cfg, state, sens, c,
                                          mpc_iterations=mpc_iterations)
        sim = articulated_step(cfg, model, sim, out.tau, terrain)
        r = rot.quat_to_rot(sim.quat)
        rec = dict(
            p=sim.p,
            v=r @ sim.base_vel[3:6],
            rpy=rot.quat_to_rpy(sim.quat),
            tau=out.tau,
            safety=state.core.safety_ok,
        )
        return (state, sim), rec

    (state, sim), traj = jax.lax.scan(tick, (state0, sim0), cmds)
    return state, sim, traj
