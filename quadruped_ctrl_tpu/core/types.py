"""Pytree state/IO structs for the controller.

The reference keeps this state scattered across C++ member variables
(ConvexMPCLocomotion.h:120-175, GaitCtrller.h:40-60, estimator members).
Here the complete controller state is one explicit pytree so the step is a
pure function and batching/sharding/checkpointing are trivial.
"""

from __future__ import annotations

import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct


@struct.dataclass
class Sensors:
    """Per-tick sensor input (the reference's imu_data[10] + leg_data[24];
    GaitCtrller.cpp:34-56)."""

    quat: jnp.ndarray          # (4,) (x,y,z,w) as produced by the sim/PyBullet
    gyro: jnp.ndarray          # (3,) body-frame angular velocity
    accelerometer: jnp.ndarray  # (3,) body-frame linear acceleration (with +g bias)
    q: jnp.ndarray             # (12,) joint angles [abad,hip,knee] x 4 legs
    qd: jnp.ndarray            # (12,) joint velocities


@struct.dataclass
class Command:
    """Asynchronous operator command (set_robot_vel / set_gait_type /
    set_robot_mode; GaitCtrller.h:82-92)."""

    vel: jnp.ndarray           # (3,) [vx, vy, wz] raw command
    gait_type: jnp.ndarray     # () int32, 0..11 (+20 => omni mode)
    robot_mode: jnp.ndarray    # () int32, 0 = fixed gait, 1 = adaptive "aio"

    @staticmethod
    def create(vx=0.0, vy=0.0, wz=0.0, gait_type=9, robot_mode=0):
        return Command(
            vel=jnp.array([vx, vy, wz], dtype=jnp.float32),
            gait_type=jnp.asarray(gait_type, dtype=jnp.int32),
            robot_mode=jnp.asarray(robot_mode, dtype=jnp.int32),
        )


@struct.dataclass
class StateEstimate:
    """Output block of the estimator container (StateEstimatorContainer.h:22-60)."""

    position: jnp.ndarray      # (3,) world
    v_world: jnp.ndarray       # (3,)
    v_body: jnp.ndarray        # (3,)
    orientation: jnp.ndarray   # (4,) (w,x,y,z)
    r_body: jnp.ndarray        # (3,3) vBody = r_body @ vWorld
    rpy: jnp.ndarray           # (3,)
    omega_body: jnp.ndarray    # (3,)
    omega_world: jnp.ndarray   # (3,)
    a_body: jnp.ndarray        # (3,)
    a_world: jnp.ndarray       # (3,)
    contact_estimate: jnp.ndarray  # (4,)


@struct.dataclass
class EstimatorState:
    """Persistent estimator state (OrientationEstimator.cpp:56-63,
    PositionVelocityEstimator.cpp:18-57)."""

    kf_xhat: jnp.ndarray       # (18,) [p, v, p_foot x4]
    kf_P: jnp.ndarray          # (18,18)
    ori_ini_inv: jnp.ndarray   # (4,) initial-yaw-removal quaternion
    first_visit: jnp.ndarray   # () bool
    contact_phase: jnp.ndarray  # (4,) commanded contact phase fed back from gait

    @staticmethod
    def create(initial_p: float = 100.0):
        return EstimatorState(
            kf_xhat=jnp.zeros(18, dtype=jnp.float32),
            kf_P=jnp.eye(18, dtype=jnp.float32) * initial_p,
            ori_ini_inv=jnp.array([1.0, 0.0, 0.0, 0.0], dtype=jnp.float32),
            first_visit=jnp.asarray(True),
            contact_phase=jnp.full((4,), 0.5, dtype=jnp.float32),
        )


@struct.dataclass
class LegData:
    """Per-leg measured data (LegController.h data struct)."""

    q: jnp.ndarray             # (4,3)
    qd: jnp.ndarray            # (4,3)
    p: jnp.ndarray             # (4,3) foot position in hip frame
    v: jnp.ndarray             # (4,3) foot velocity in hip frame
    jac: jnp.ndarray           # (4,3,3)


@struct.dataclass
class GaitParams:
    """Runtime-mutable gait definition (Gait.cpp:23-41 setGaitParam)."""

    offsets: jnp.ndarray       # (4,) int32 segment offsets
    durations: jnp.ndarray     # (4,) int32 stance durations in segments
    h: jnp.ndarray             # () int32 horizon segments (10..16)


@struct.dataclass
class LocomotionState:
    """ConvexMPCLocomotion persistent state (ConvexMPCLocomotion.h:120-175)."""

    iteration_counter: jnp.ndarray     # () int32
    x_vel_des: jnp.ndarray             # () filtered forward velocity command
    y_vel_des: jnp.ndarray
    yaw_turn_rate: jnp.ndarray
    yaw_des: jnp.ndarray
    yaw_des_true: jnp.ndarray
    world_position_desired: jnp.ndarray  # (3,)
    stand_traj: jnp.ndarray            # (6,) [x, y, z, r, p, yaw]
    rpy_int: jnp.ndarray               # (3,) terrain-compensation integrals
    rpy_comp: jnp.ndarray              # (3,)
    current_gait: jnp.ndarray          # () int32
    first_run: jnp.ndarray             # () bool
    first_swing: jnp.ndarray           # (4,) bool
    swing_time_remaining: jnp.ndarray  # (4,)
    swing_p0: jnp.ndarray              # (4,3) swing liftoff positions (world)
    swing_pf: jnp.ndarray              # (4,3) swing touchdown targets (world)
    x_comp_integral: jnp.ndarray       # () height-drag integral
    f_ff: jnp.ndarray                  # (4,3) body-frame feedforward forces
    fr_des: jnp.ndarray                # (4,3) world-frame reaction forces (MPC out)
    aio: GaitParams                    # adaptive gait's current parameters
    mpc_h: jnp.ndarray                 # () int32 — the MPC horizon actually
    # solved. The reference's `horizonLength` is STICKY: only mode 1 writes
    # it (ConvexMPCLocomotion.cpp:233), and because the mode-1 local `h`
    # starts at 10 and is only rebanded at gait-cycle boundaries — which are
    # never MPC-solve ticks — every mode-1 solve uses h=10, and mode 0 then
    # keeps the last mode-1 value (10 after the standard stand-up) while the
    # gait object still phases over its own 14 segments. So the stock demo
    # trots with a 10-step MPC over a 14-segment gait. Reproduced deliberately.
    mpc_fail_count: jnp.ndarray        # () int32 — solver-failure events
    # (non-finite or friction-infeasible solves whose stale solution was
    # held; the reference's "failed to solve!" path, SolverMPC.cpp:539-541)
    # Temporal warm start (role of qpOASES's setToMPC hot-start options,
    # SolverMPC.cpp:530-532): the pre-polish ADMM iterate of the last solve,
    # advanced by one gait segment, in the solver's force-normalized units.
    # Zeros = cold start; reset to zeros when a solve fails.
    mpc_warm_x: jnp.ndarray            # (h_max,4,3)
    mpc_warm_z: jnp.ndarray            # (h_max,4,5)
    mpc_warm_y: jnp.ndarray            # (h_max,4,5)
    aio_prev_phase: jnp.ndarray        # () f32 — the aio gait's _phase as of
    # the LAST mode-1 tick: the reference's boundary check reads the phase
    # stored by the previous setIterations call (ConvexMPCLocomotion.cpp:178
    # runs before :240). On the very first tick it reads the uninitialized
    # member, which in practice is 0.0 (fresh zeroed heap — confirmed against
    # the compiled golden library: the MPC cadence lands on t % 13 == 12,
    # which requires the t=0 boundary to fire). Init 0 reproduces it.

    @staticmethod
    def create(h_max: int = 16):
        return LocomotionState(
            iteration_counter=jnp.asarray(0, dtype=jnp.int32),
            x_vel_des=jnp.asarray(0.0, dtype=jnp.float32),
            y_vel_des=jnp.asarray(0.0, dtype=jnp.float32),
            yaw_turn_rate=jnp.asarray(0.0, dtype=jnp.float32),
            yaw_des=jnp.asarray(0.0, dtype=jnp.float32),
            yaw_des_true=jnp.asarray(0.0, dtype=jnp.float32),
            world_position_desired=jnp.zeros(3, dtype=jnp.float32),
            stand_traj=jnp.zeros(6, dtype=jnp.float32),
            rpy_int=jnp.zeros(3, dtype=jnp.float32),
            rpy_comp=jnp.zeros(3, dtype=jnp.float32),
            current_gait=jnp.asarray(9, dtype=jnp.int32),
            first_run=jnp.asarray(True),
            first_swing=jnp.ones(4, dtype=bool),
            swing_time_remaining=jnp.zeros(4, dtype=jnp.float32),
            swing_p0=jnp.zeros((4, 3), dtype=jnp.float32),
            swing_pf=jnp.zeros((4, 3), dtype=jnp.float32),
            x_comp_integral=jnp.asarray(0.0, dtype=jnp.float32),
            f_ff=jnp.zeros((4, 3), dtype=jnp.float32),
            fr_des=jnp.zeros((4, 3), dtype=jnp.float32),
            aio=GaitParams(
                offsets=jnp.zeros(4, dtype=jnp.int32),
                durations=jnp.full((4,), 14, dtype=jnp.int32),
                h=jnp.asarray(14, dtype=jnp.int32),
            ),
            mpc_h=jnp.asarray(14, dtype=jnp.int32),
            mpc_fail_count=jnp.asarray(0, dtype=jnp.int32),
            mpc_warm_x=jnp.zeros((h_max, 4, 3), dtype=jnp.float32),
            mpc_warm_z=jnp.zeros((h_max, 4, 5), dtype=jnp.float32),
            mpc_warm_y=jnp.zeros((h_max, 4, 5), dtype=jnp.float32),
            aio_prev_phase=jnp.asarray(0.0, dtype=jnp.float32),
        )


@struct.dataclass
class ControllerState:
    """Complete persistent controller state (the reference's GaitCtrller +
    members; GaitCtrller.h:40-60)."""

    estimator: EstimatorState
    locomotion: LocomotionState
    safety_ok: jnp.ndarray     # () bool, latches false (GaitCtrller.cpp:108-123)
    gamepad: jnp.ndarray       # (3,) deadbanded velocity command

    @staticmethod
    def create(initial_p: float = 100.0, h_max: int = 16):
        return ControllerState(
            estimator=EstimatorState.create(initial_p),
            locomotion=LocomotionState.create(h_max),
            safety_ok=jnp.asarray(True),
            gamepad=jnp.zeros(3, dtype=jnp.float32),
        )


@struct.dataclass
class ControllerOutput:
    """Per-tick controller output: torques plus the WBC-style debug block
    (ConvexMPCLocomotion.h:93-110)."""

    tau: jnp.ndarray           # (12,) joint torques
    p_foot_des: jnp.ndarray    # (4,3) desired world foot positions
    v_foot_des: jnp.ndarray    # (4,3)
    fr_des: jnp.ndarray        # (4,3) desired reaction forces (world)
    contact_state: jnp.ndarray  # (4,)
    swing_state: jnp.ndarray   # (4,)
    p_body_des: jnp.ndarray    # (3,)
    v_body_des: jnp.ndarray    # (3,)
    estimate: StateEstimate
