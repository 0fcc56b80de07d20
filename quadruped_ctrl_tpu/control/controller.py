"""The full controller step: estimation -> gait -> placement -> MPC -> torques.

This is the batched-JAX re-derivation of the reference's per-tick pipeline
(GaitCtrller::TorqueCalculator, GaitCtrller.cpp:95-145, and
ConvexMPCLocomotion::run, ConvexMPCLocomotion.cpp:116-496) as a single pure
function over an explicit state pytree. Semantics preserved on purpose:

* estimator order: contact -> orientation -> linear KF, with the KF consuming
  the *previous* tick's leg kinematics (PreWork runs estimators before
  LegController::updateData, GaitCtrller.cpp:58-63);
* the MPC fires when (iteration_counter + 1) % iterations_between_mpc == 0
  (counter is incremented between foot placement and updateMPCIfNeeded,
  ConvexMPCLocomotion.cpp:375, 502) and the last solution is held between
  solves;
* safety failures latch and zero the torques forever (GaitCtrller.cpp:108-142).
  All four reference checks are wired (GaitCtrller.cpp:108-123): orientation
  and joint limits in `control_tick`; pDes and force-feedforward in
  `leg_commands`, on the *actually commanded* values with the reference's
  clamp side-effects. (In the reference those two run on commands zeroed at
  the top of the tick — zeroCommand at GaitCtrller.cpp:100 precedes them —
  so they can never fire there; here they see the real commands. On nominal
  trajectories they pass, so golden parity is unaffected.);
* solver failures hold the previous MPC solution (SolverMPC.cpp:539-541,
  convexMPC_interface.cpp:175-180): a non-finite or friction-infeasible
  solve keeps the last f_ff/Fr_des and bumps `mpc_fail_count`;
* stance feet are damped toward the last computed swing-trajectory velocity
  (which is zero at touchdown), with force feedforward from the MPC.

For batched scenario engines, `control_tick` (cheap, every tick) and
`mpc_update` (expensive, every 13th tick) are exposed separately so the 13x
MPC cadence becomes a static loop structure instead of a per-lane cond.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from quadruped_ctrl_tpu.core import struct

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.control import desired_state, leg_controller, safety
from quadruped_ctrl_tpu.control import swing as swing_mod
from quadruped_ctrl_tpu.core import rotations as rot
from quadruped_ctrl_tpu.core.types import (
    Command,
    ControllerOutput,
    ControllerState,
    EstimatorState,
    GaitParams,
    LegData,
    LocomotionState,
    Sensors,
    StateEstimate,
)
from quadruped_ctrl_tpu.estimation import linear_kf, orientation
from quadruped_ctrl_tpu.gait import gait as gait_mod
from quadruped_ctrl_tpu.mpc import formation
from quadruped_ctrl_tpu.mpc.reference import build_reference
from quadruped_ctrl_tpu.solver import admm
from quadruped_ctrl_tpu.core.precision import exact_matmuls


@struct.dataclass
class FullControllerState:
    """ControllerState plus the carried leg data / swing-trajectory values."""

    core: ControllerState
    prev_leg: LegData          # previous tick's kinematics (estimator lag)
    swing_p_cur: jnp.ndarray   # (4,3) last computed swing position (world)
    swing_v_cur: jnp.ndarray   # (4,3) last computed swing velocity (world)
    dsc: desired_state.DesiredStateCommandState

    @staticmethod
    def create(cfg: FrameworkConfig):
        zero_leg = LegData(
            q=jnp.zeros((4, 3), jnp.float32),
            qd=jnp.zeros((4, 3), jnp.float32),
            p=jnp.zeros((4, 3), jnp.float32),
            v=jnp.zeros((4, 3), jnp.float32),
            jac=jnp.zeros((4, 3, 3), jnp.float32),
        )
        return FullControllerState(
            core=ControllerState.create(cfg.estimator.initial_p,
                                        cfg.mpc.h_max),
            prev_leg=zero_leg,
            swing_p_cur=jnp.zeros((4, 3), jnp.float32),
            swing_v_cur=jnp.zeros((4, 3), jnp.float32),
            dsc=desired_state.DesiredStateCommandState.create(),
        )


def run_estimators(cfg: FrameworkConfig, est: EstimatorState, sensors: Sensors,
                   prev_leg: LegData):
    """Contact + orientation + linear-KF estimators (GaitCtrller.cpp:20-27, 58-63)."""
    est, ori = orientation.run(est, sensors)
    hips = jnp.asarray(cfg.robot.hip_locations())
    xhat, p_cov, position, v_world, v_body = linear_kf.run(
        cfg.estimator,
        est.kf_xhat,
        est.kf_P,
        ori["a_world"],
        ori["r_body"],
        ori["omega_body"],
        hips,
        prev_leg.p,
        prev_leg.v,
        est.contact_phase,
    )
    est = est.replace(kf_xhat=xhat, kf_P=p_cov)
    se = StateEstimate(
        position=position,
        v_world=v_world,
        v_body=v_body,
        orientation=ori["orientation"],
        r_body=ori["r_body"],
        rpy=ori["rpy"],
        omega_body=ori["omega_body"],
        omega_world=ori["omega_world"],
        a_body=ori["a_body"],
        a_world=ori["a_world"],
        contact_estimate=est.contact_phase,
    )
    return est, se


def run_estimators_batched(cfg: FrameworkConfig, est: EstimatorState,
                           sensors: Sensors, prev_leg: LegData):
    """Batch-explicit `run_estimators`: the orientation/contact parts vmap
    per scenario (cheap vector algebra); the KF runs batch-last through
    `linear_kf.run_batched` (see its docstring for the batch-last layout)."""
    est, ori = jax.vmap(orientation.run)(est, sensors)
    hips = jnp.asarray(cfg.robot.hip_locations())
    xhat, p_cov, position, v_world, v_body = linear_kf.run_batched(
        cfg.estimator,
        est.kf_xhat,
        est.kf_P,
        ori["a_world"],
        ori["r_body"],
        ori["omega_body"],
        hips,
        prev_leg.p,
        prev_leg.v,
        est.contact_phase,
    )
    est = est.replace(kf_xhat=xhat, kf_P=p_cov)
    se = StateEstimate(
        position=position,
        v_world=v_world,
        v_body=v_body,
        orientation=ori["orientation"],
        r_body=ori["r_body"],
        rpy=ori["rpy"],
        omega_body=ori["omega_body"],
        omega_world=ori["omega_world"],
        a_body=ori["a_body"],
        a_world=ori["a_world"],
        contact_estimate=est.contact_phase,
    )
    return est, se


def apply_vel_deadband(cfg: FrameworkConfig, vel):
    """SetRobotVel's +-0.03 deadband (GaitCtrller.cpp:75-93)."""
    return jnp.where(jnp.abs(vel) < cfg.control.vel_deadband, 0.0, vel)


def _setup_command(cfg: FrameworkConfig, loco: LocomotionState, gamepad, rpy):
    """Velocity low-pass + clamps + yaw targets (ConvexMPCLocomotion.cpp:76-114)."""
    c = cfg.control
    dt = cfg.dt
    x = loco.x_vel_des * (1 - c.x_filter) + gamepad[0] * c.x_filter
    y = loco.y_vel_des * (1 - c.y_filter) + gamepad[1] * c.y_filter
    w = loco.yaw_turn_rate * (1 - c.yaw_filter) + gamepad[2] * c.yaw_filter
    x = jnp.clip(x, c.vx_min, c.vx_max)
    y = jnp.clip(y, -c.vy_max, c.vy_max)
    yaw_des = rpy[2] + dt * w
    yaw_des_true = jnp.where(
        jnp.abs(rpy[2] - loco.yaw_des_true) > 5.0, rpy[2], loco.yaw_des_true
    )
    yaw_des_true = yaw_des_true + dt * w
    return loco.replace(
        x_vel_des=x,
        y_vel_des=y,
        yaw_turn_rate=w,
        yaw_des=yaw_des,
        yaw_des_true=yaw_des_true,
    )


def _select_gait(cfg: FrameworkConfig, loco: LocomotionState, cmd: Command):
    """Gait selection / aio reshape (ConvexMPCLocomotion.cpp:127-239).

    Returns (loco, params, gait_number, omni).
    """
    gait_number = cmd.gait_type
    omni = gait_number >= 20
    gait_number = jnp.where(omni, gait_number - 20, gait_number)

    fixed = gait_mod.params_for_gait(gait_number)

    # aio (mode 1): reshape at gait-phase boundaries by commanded speed
    # (reference's vBody = sqrt(vx^2) + vy^2, line 175). The boundary check
    # reads the phase the PREVIOUS mode-1 tick stored (the reference tests
    # gait->getCurrentGaitPhase() before this tick's setIterations runs;
    # see LocomotionState.aio_prev_phase) — this one-tick lag is what puts
    # the reference's MPC cadence on t % 13 == 0.
    v_body = jnp.sqrt(loco.x_vel_des**2) + loco.y_vel_des**2
    aio_new, aio_gait_number, counter_reset = gait_mod.aio_params(
        v_body, loco.yaw_turn_rate, loco.aio, loco.aio_prev_phase,
        cfg.mpc.h_max,
    )
    at_boundary = loco.aio_prev_phase == 0.0

    mode1 = cmd.robot_mode == 1
    params = GaitParams(
        offsets=jnp.where(mode1, aio_new.offsets, fixed.offsets),
        durations=jnp.where(mode1, aio_new.durations, fixed.durations),
        h=jnp.where(mode1, aio_new.h, fixed.h),
    )
    gait_number = jnp.where(mode1, aio_gait_number, gait_number)
    counter = jnp.where(
        mode1 & counter_reset, jnp.zeros_like(loco.iteration_counter),
        loco.iteration_counter,
    )
    # horizonLength: every mode-1 tick writes `h` (line 233), which is the
    # local init 10 unless this tick was a boundary that rebanded it; mode 0
    # never writes it, so the MPC keeps solving the last mode-1 horizon
    mpc_h = jnp.where(
        mode1, jnp.where(at_boundary, aio_new.h, jnp.asarray(10, jnp.int32)),
        loco.mpc_h,
    )
    # store this tick's aio phase (post-reset counter, new params) for the
    # next tick's boundary check; frozen while in mode 0 (setIterations only
    # runs on the active gait object)
    _, cur_aio_phase = gait_mod.phase_of(
        counter, cfg.mpc.iterations_between_mpc, aio_new
    )
    aio_prev_phase = jnp.where(mode1, cur_aio_phase, loco.aio_prev_phase)
    # the aio object itself is only touched while it is the active gait
    aio_kept = jax.tree.map(
        lambda new, old: jnp.where(mode1, new, old), aio_new, loco.aio
    )
    loco = loco.replace(aio=aio_kept, iteration_counter=counter, mpc_h=mpc_h,
                        aio_prev_phase=aio_prev_phase)
    return loco, params, gait_number, omni


@exact_matmuls
def control_tick(cfg: FrameworkConfig, state: FullControllerState,
                 sensors: Sensors, cmd: Command):
    """Everything except the MPC solve. Returns (state, tick_ctx, output).

    tick_ctx carries what `mpc_update` needs (gait table, estimate, feet).
    """
    # --- estimation (with one-tick leg-data lag, as in the reference) ---
    est, se = run_estimators(cfg, state.core.estimator, sensors,
                             state.prev_leg)
    return _tick_after_estimation(cfg, state, sensors, cmd, est, se)


@exact_matmuls
def control_tick_batched(cfg: FrameworkConfig, state, sensors, cmd):
    """Batch-explicit `control_tick`: the KF covariance recursion runs
    through `run_estimators_batched` (batch-last sequential-update filter —
    the closed-loop bottleneck per SWEEP_r03), everything else vmaps per
    scenario. Semantically jax.vmap(control_tick)."""
    est, se = run_estimators_batched(cfg, state.core.estimator, sensors,
                                     state.prev_leg)
    return jax.vmap(
        lambda st, sn, c, e, s: _tick_after_estimation(cfg, st, sn, c, e, s)
    )(state, sensors, cmd, est, se)


def _tick_after_estimation(cfg: FrameworkConfig, state: FullControllerState,
                           sensors: Sensors, cmd: Command, est, se):
    core = state.core
    dt = cfg.dt
    leg = leg_controller.update_data(cfg.robot, sensors.q, sensors.qd)

    # --- safety: orientation check + joint-limit clamp (GaitCtrller.cpp:108-123)
    ok_ori = safety.check_orientation(cfg.safety, se.rpy)
    q_clamped, ok_joint = safety.check_joint_limits(cfg.safety, leg.q)
    leg = leg.replace(q=q_clamped)
    safety_ok = core.safety_ok & ok_ori & ok_joint

    # --- command pipeline ---
    gamepad = apply_vel_deadband(cfg, cmd.vel)
    # DesiredStateCommand runs every tick in the reference but ConvexMPC
    # consumes the raw gamepad command (GaitCtrller.cpp:105,125); kept for
    # API parity and external consumers of the filtered 12-dim state
    dsc, _state_des = desired_state.convert_to_state_commands(
        state.dsc, jnp.concatenate([gamepad, jnp.zeros(1, jnp.float32)]), cfg.dt
    )
    loco = _setup_command(cfg, core.locomotion, gamepad, se.rpy)
    prev_mpc_h = loco.mpc_h
    loco, params, gait_number, omni = _select_gait(cfg, loco, cmd)

    # warm-start hygiene: a gait or horizon switch invalidates the stored
    # temporal warm triple (the shifted iterate no longer matches the new
    # table's active-set structure) — reset it so the next MPC solve takes
    # the full cold iteration budget; `solution_ok` remains the backstop
    switched = (gait_number != loco.current_gait) | (loco.mpc_h != prev_mpc_h)
    zero_on_switch = lambda a: jnp.where(switched, jnp.zeros_like(a), a)
    loco = loco.replace(
        mpc_warm_x=zero_on_switch(loco.mpc_warm_x),
        mpc_warm_z=zero_on_switch(loco.mpc_warm_z),
        mpc_warm_y=zero_on_switch(loco.mpc_warm_y),
    )

    # standing transition capture (ConvexMPCLocomotion.cpp:137-146)
    entering_stand = ((gait_number == 4) & (loco.current_gait != 4)) | loco.first_run
    stand_traj = jnp.where(
        entering_stand,
        jnp.stack(
            [
                se.position[0],
                se.position[1],
                jnp.asarray(cfg.control.stand_height, se.position.dtype),
                jnp.zeros((), se.position.dtype),
                jnp.zeros((), se.position.dtype),
                se.rpy[2],
            ]
        ),
        loco.stand_traj,
    )
    wpd = jnp.where(
        entering_stand,
        loco.world_position_desired.at[0].set(stand_traj[0]).at[1].set(stand_traj[1]),
        loco.world_position_desired,
    )
    loco = loco.replace(current_gait=gait_number, stand_traj=stand_traj,
                        world_position_desired=wpd)

    segment, phase = gait_mod.phase_of(
        loco.iteration_counter, cfg.mpc.iterations_between_mpc, params
    )

    # velocities / terrain compensation (lines 242-265)
    v_des_robot = jnp.stack(
        [loco.x_vel_des, loco.y_vel_des, jnp.zeros((), jnp.float32)]
    )
    r_body_t = se.r_body.T
    v_des_world = jnp.where(omni, v_des_robot, r_body_t @ v_des_robot)
    v_robot = se.v_world

    rpy_int = loco.rpy_int
    rpy_int = rpy_int.at[1].add(
        jnp.where(jnp.abs(v_robot[0]) > 0.2, dt * (0.0 - se.rpy[1]) / v_robot[0], 0.0)
    )
    rpy_int = rpy_int.at[0].add(
        jnp.where(jnp.abs(v_robot[1]) > 0.1, dt * (0.0 - se.rpy[0]) / v_robot[1], 0.0)
    )
    rpy_int = jnp.clip(rpy_int, -cfg.control.rpy_int_max, cfg.control.rpy_int_max)
    rpy_comp = jnp.stack(
        [v_robot[1] * rpy_int[0], v_robot[0] * rpy_int[1], jnp.zeros((), jnp.float32)]
    )
    loco = loco.replace(rpy_int=rpy_int, rpy_comp=rpy_comp)

    # world-frame foot positions (lines 269-274)
    hips = jnp.asarray(cfg.robot.hip_locations())
    p_foot = se.position[None, :] + jnp.einsum("ij,fj->fi", r_body_t, hips + leg.p)

    # desired world position integration (non-standing; lines 276-280)
    standing = gait_number == 4
    wpd = loco.world_position_desired
    wpd = jnp.where(
        standing, wpd, wpd + dt * jnp.stack([v_des_world[0], v_des_world[1],
                                             jnp.zeros((), jnp.float32)])
    )

    # firstRun init (lines 283-295); wpd[2] holds yaw in the reference — kept
    first = loco.first_run
    wpd = jnp.where(
        first,
        jnp.stack([se.position[0], se.position[1], se.rpy[2]]),
        wpd,
    )
    swing_p0 = jnp.where(first, p_foot, loco.swing_p0)
    swing_pf = jnp.where(first, p_foot, loco.swing_pf)
    loco = loco.replace(world_position_desired=wpd, swing_p0=swing_p0,
                        swing_pf=swing_pf, first_run=jnp.asarray(False))

    # swing timing (lines 297-314)
    dt_mpc = cfg.dt_mpc
    swing_times = gait_mod.swing_time(dt_mpc, params)
    stance_times = gait_mod.stance_time(dt_mpc, params)
    swing_time_remaining = jnp.where(
        loco.first_swing, swing_times, loco.swing_time_remaining - dt
    )

    # foot placement (lines 304-371)
    pf_target = swing_mod.foot_placement(
        cfg, hips, se.position, r_body_t, se.v_world, v_des_robot, v_des_world,
        loco.yaw_turn_rate, stance_times, swing_time_remaining,
    )
    loco = loco.replace(swing_pf=pf_target,
                        swing_time_remaining=swing_time_remaining)

    # counter increment (line 375)
    loco = loco.replace(iteration_counter=loco.iteration_counter + 1)

    contact_states = gait_mod.contact_state(phase, params)
    swing_states = gait_mod.swing_state(phase, params)
    mpc_table = gait_mod.mpc_table(segment, params, cfg.mpc.h_max)
    mpc_due = (loco.iteration_counter % cfg.mpc.iterations_between_mpc) == 0

    core = core.replace(estimator=est, locomotion=loco, safety_ok=safety_ok,
                        gamepad=gamepad)
    state = state.replace(core=core, prev_leg=leg, dsc=dsc)

    ctx = dict(
        se=se,
        leg=leg,
        p_foot=p_foot,
        v_des_world=v_des_world,
        mpc_table=mpc_table,
        mpc_due=mpc_due,
        standing=standing,
        contact_states=contact_states,
        swing_states=swing_states,
        swing_times=swing_times,
        params=params,
    )
    return state, ctx


def _mpc_problem_inputs(cfg: FrameworkConfig, state: FullControllerState, ctx,
                        h_sol: int):
    """Pre-dynamics formation inputs: reference trajectory, x-drag, x0, step
    mask and contact table over the first `h_sol` table rows — everything of
    solveDenseMPC's pre-cost half (ConvexMPCLocomotion.cpp:592-665) except
    the SRB linearization itself, so batched callers can run the dynamics
    through the batch-explicit closed form (formation.srb_discrete)."""
    loco = state.core.locomotion
    se: StateEstimate = ctx["se"]

    traj, wpd = build_reference(
        cfg,
        ctx["standing"],
        loco.stand_traj,
        loco.world_position_desired,
        se.position,
        loco.rpy_comp,
        loco.yaw_des_true,
        loco.yaw_turn_rate,
        ctx["v_des_world"],
        h_sol,
    )

    # x-drag integral: solve uses the PRE-update value (solveDenseMPC:632-640)
    x_drag = loco.x_comp_integral
    pz_err = se.position[2] - cfg.control.body_height
    vx = se.v_world[0]
    x_comp = jnp.where(
        jnp.abs(vx) > 0.3,
        loco.x_comp_integral + cfg.mpc.x_comp_drag * pz_err * cfg.dt_mpc / vx,
        loco.x_comp_integral,
    )

    r_feet = ctx["p_foot"] - se.position[None, :]
    x0 = formation.build_x0(
        se.rpy, se.position, se.omega_world, se.v_world, cfg.mpc.gravity
    )
    # the solved horizon is loco.mpc_h (sticky horizonLength), NOT the gait's
    # own segment count: the QP covers the table's first mpc_h rows
    # (setup_problem(dtMPC, horizonLength) at ConvexMPCLocomotion.cpp:630
    # with the table from Gait::getMpcTable over the gait's _nIterations)
    step_mask = (jnp.arange(h_sol) < loco.mpc_h).astype(jnp.float32)
    table = ctx["mpc_table"][:h_sol] * step_mask[:, None]
    return (r_feet, se.rpy[2], x_drag, x0, traj, step_mask, table, wpd,
            x_comp)


def _mpc_problem_parts(cfg: FrameworkConfig, state: FullControllerState, ctx,
                       h_sol: int):
    """`_mpc_problem_inputs` + the SRB discretized dynamics (per-scenario
    closed form)."""
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = \
        _mpc_problem_inputs(cfg, state, ctx, h_sol)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag,
                                      cfg.dt_mpc)
    return adt, bdt, x0, traj, step_mask, table, wpd, x_comp


def _mpc_problem(cfg: FrameworkConfig, state: FullControllerState, ctx,
                 h_sol: int):
    """Per-scenario condensed-QP build (the formation half of solveDenseMPC,
    ConvexMPCLocomotion.cpp:592-665). Returns (hess, grad, table, wpd,
    x_comp)."""
    adt, bdt, x0, traj, step_mask, table, wpd, x_comp = _mpc_problem_parts(
        cfg, state, ctx, h_sol
    )
    hess, grad = formation.qp_cost_nil(cfg.mpc, adt, bdt, x0, traj, step_mask)
    return hess, grad, table, wpd, x_comp


def _mpc_problem_compressed(cfg: FrameworkConfig, state: FullControllerState,
                            ctx, h_sol: int, max_stance: int):
    """Stance-compressed QP build: the reference's swing-variable elimination
    (SolverMPC.cpp:441-525) as a static-shape gather (formation.
    compress_stance), producing (3*max_stance*h_sol)-variable systems.
    Correct whenever every step of the gait table has <= max_stance stance
    feet (see gait.max_simultaneous_stance). Returns
    (hess, grad, foot_idx, gait_red, table, wpd, x_comp)."""
    adt, bdt, x0, traj, step_mask, table, wpd, x_comp = _mpc_problem_parts(
        cfg, state, ctx, h_sol
    )
    foot_idx, gait_red = formation.compress_stance(table, max_stance)
    hess, grad = formation.qp_cost_compressed_nil(
        cfg.mpc, adt, bdt, x0, traj, step_mask, foot_idx
    )
    return hess, grad, foot_idx, gait_red, table, wpd, x_comp


@exact_matmuls
def mpc_update(cfg: FrameworkConfig, state: FullControllerState, ctx,
               iterations: int | None = None):
    """Reference trajectory + formation + ADMM solve; updates f_ff/Fr_des.

    Reference: updateMPCIfNeeded + solveDenseMPC (ConvexMPCLocomotion.cpp:
    498-687). Only applied when ctx['mpc_due'] (callers either cond on it or
    run every 13th tick by construction).

    With `iterations=None` the budget is picked at runtime: the reduced
    `cfg.solver.warm_iterations` whenever the stored temporal warm-start
    triple is live (every steady-state tick — consecutive solves are one
    gait segment apart), the full cold `cfg.solver.iterations` on session
    start and after a solver failure (where `_store_warm` resets the triple
    to zeros). This is the qpOASES setToMPC hot-start economics
    (SolverMPC.cpp:530-532) on the single-robot real-time path.
    """
    h_max = cfg.mpc.h_max
    hess, grad, table, wpd, x_comp = _mpc_problem(cfg, state, ctx, h_max)
    loco0 = state.core.locomotion
    warm_in = _warm_slices(loco0, h_max)
    if iterations is None:
        live = jnp.zeros((), jnp.bool_)
        for w in warm_in:
            live = live | jnp.any(w != 0)

        def solve(n_it):
            return lambda: admm.admm_mpc(
                cfg.solver, cfg.mpc, hess, grad, table, iterations=n_it,
                warm=warm_in, return_warm=True,
            )

        forces, warm = lax.cond(
            live, solve(cfg.solver.warm_iterations),
            solve(cfg.solver.iterations),
        )
    else:
        forces, warm = admm.admm_mpc(
            cfg.solver, cfg.mpc, hess, grad, table, iterations=iterations,
            warm=warm_in, return_warm=True,
        )
    forces = forces.reshape(h_max, 4, 3)
    ok = solution_ok(cfg, forces, table)
    loco = _accept_solution(cfg, loco0, ctx["se"], forces, table, ok=ok)
    loco = _store_warm(loco, warm, h_max, h_max, ok)
    loco = loco.replace(world_position_desired=wpd, x_comp_integral=x_comp)
    return state.replace(core=state.core.replace(locomotion=loco))


@exact_matmuls
def mpc_update_batched(cfg: FrameworkConfig, state: FullControllerState, ctx,
                       h_sol: int | None = None,
                       iterations: int | None = None,
                       polish_rounds: int | None = None,
                       max_stance: int | None = None,
                       pack: int = 2):
    """Batch-axis-explicit `mpc_update` — the closed-loop fast path.

    Semantically `jax.vmap(mpc_update)` (identical formation and splitting),
    but the solves run through `admm.admm_mpc_batched` (solver/admm.py) —
    the same solver path the flagship throughput bench uses, now driving
    the scenario engines.

    `h_sol` is the static solved horizon; it should be >= every scenario's
    runtime `loco.mpc_h` (cfg.mpc.h_max is always safe; pass 10 for pure
    mode-0 sweeps after a mode-1 stand-up, where the reference's sticky
    horizonLength is always 10 — see LocomotionState.mpc_h). A scenario
    whose mpc_h exceeds h_sol degrades gracefully to an h_sol-step MPC (the
    step mask truncates; shapes never change).

    `max_stance` (static) enables the bench pipeline's stance compression +
    block-diagonal packing (pipeline.solve_packed_batch): the reference's
    swing-variable elimination, SolverMPC.cpp:441-525. It is CORRECT ONLY
    when every scenario's gait table has <= max_stance stance feet per step
    (gait.max_simultaneous_stance gives the bound for a static gait list);
    a dropped stance foot would command zero force. None (default) solves
    the full 12*h_sol-variable systems. `pack` scenarios (a divisor of the
    batch) share one block-diagonal KKT system in the compressed path.
    """
    h_sol = cfg.mpc.h_max if h_sol is None else h_sol
    h_max = cfg.mpc.h_max
    if max_stance is not None and max_stance < 4:
        return _mpc_update_batched_packed(
            cfg, state, ctx, h_sol, iterations, polish_rounds, max_stance,
            pack,
        )
    # batch-explicit formation: cheap per-scenario prologue under vmap, then
    # the closed-form dynamics + sqrt-S-folded cost over the whole batch
    # (identity selection = the uncompressed 12*h_sol layout)
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = jax.vmap(
        lambda s, c: _mpc_problem_inputs(cfg, s, c, h_sol)
    )(state, ctx)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag,
                                      cfg.dt_mpc)
    bsz = r_feet.shape[0]
    sel4 = jnp.broadcast_to(
        jnp.eye(4, dtype=jnp.float32)[None, None], (bsz, h_sol, 4, 4)
    )
    # pack=1: per-scenario (12*h_sol)-var systems
    hess, grad = formation.qp_cost_packed(
        cfg.mpc, adt, bdt, x0, traj, step_mask, sel4, pack=1
    )
    warm = jax.vmap(lambda s: _warm_slices(s.core.locomotion, h_sol))(state)
    x, warm_out = admm.admm_mpc_batched(
        cfg.solver, cfg.mpc, hess, grad, table,
        iterations=iterations, polish_rounds=polish_rounds,
        warm=warm, return_warm=True,
    )
    forces = x.reshape(-1, h_sol, 4, 3)

    def accept(s, se, f, t, w, wpd_i, xc):
        ok = solution_ok(cfg, f, t)
        loco = _accept_solution(cfg, s.core.locomotion, se, f, t, ok=ok)
        loco = _store_warm(loco, w, h_sol, h_max, ok)
        loco = loco.replace(world_position_desired=wpd_i, x_comp_integral=xc)
        return s.replace(core=s.core.replace(locomotion=loco))

    return jax.vmap(accept)(state, ctx["se"], forces, table, warm_out, wpd,
                            x_comp)


def _mpc_update_batched_packed(cfg: FrameworkConfig, state, ctx, h_sol: int,
                               iterations, polish_rounds, max_stance: int,
                               pack: int):
    """The stance-compressed + pair-packed closed-loop solve: identical
    formation inputs and ADMM splitting to the full path, with the solves
    running on (pack * 3*max_stance*h_sol)-variable block-diagonal KKT
    systems — exactly `pipeline.solve_packed_batch`'s shape (the flagship
    bench), now fed by the live controller state. Warm-start triples are
    stored in the full (h_max, 4, d) layout and gathered/scattered through
    each tick's stance index map, so the temporal warm start survives the
    table rolling one segment between solves."""
    h_max = cfg.mpc.h_max
    ms = max_stance
    # batch-explicit formation (see mpc_update_batched): vmapped prologue,
    # then closed-form dynamics + sortless stance selection + sqrt-S-folded
    # compressed cost over the whole batch
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = jax.vmap(
        lambda s, c: _mpc_problem_inputs(cfg, s, c, h_sol)
    )(state, ctx)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag,
                                      cfg.dt_mpc)
    foot_idx, gait_red, sel = formation.stance_selectors(table, ms)
    b = r_feet.shape[0]
    if b % pack != 0:
        pack = 1        # odd batches still compress; they just don't pack
    n_c = 3 * ms * h_sol
    m_c = 5 * ms * h_sol
    # packed block-diagonal QP cost
    kp, gp = formation.qp_cost_packed(
        cfg.mpc, adt, bdt, x0, traj, step_mask, sel, pack
    )

    # gather the stored full-layout warm triples through this tick's stance
    # map (swing-foot entries drop out; their forces/duals are ~0 anyway)
    def gather_warm(loco, fi):
        def g(wfull):
            red = jnp.take_along_axis(wfull[:h_sol], fi[:, :, None], axis=1)
            return red.reshape(-1)
        return g(loco.mpc_warm_x), g(loco.mpc_warm_z), g(loco.mpc_warm_y)

    wx, wz, wy = jax.vmap(
        lambda s, fi: gather_warm(s.core.locomotion, fi)
    )(state, foot_idx)

    gaitp = gait_red.reshape(b // pack, pack * h_sol, ms)
    warm_p = (wx.reshape(b // pack, pack * n_c),
              wz.reshape(b // pack, pack * m_c),
              wy.reshape(b // pack, pack * m_c))

    xp, warm_out = admm.admm_mpc_batched(
        cfg.solver, cfg.mpc, kp, gp, gaitp,
        iterations=iterations, polish_rounds=polish_rounds,
        warm=warm_p, return_warm=True, pack=pack,
    )
    x_red = xp.reshape(b, n_c)
    forces = jax.vmap(lambda xr, fi: formation.scatter_forces(xr, fi, h_sol))(
        x_red, foot_idx
    )

    # scatter the solver's warm triple back to the full layout
    wxo, wzo, wyo = warm_out
    def scatter_warm(red, fi, d):
        r = red.reshape(h_sol, ms, d)
        full = jnp.zeros((h_sol, 4, d), jnp.float32)
        return full.at[jnp.arange(h_sol)[:, None], fi].set(r).reshape(-1)

    warm_full = jax.vmap(
        lambda x_, z_, y_, fi: (scatter_warm(x_, fi, 3),
                                scatter_warm(z_, fi, 5),
                                scatter_warm(y_, fi, 5))
    )(wxo.reshape(b, n_c), wzo.reshape(b, m_c), wyo.reshape(b, m_c), foot_idx)

    def accept(s, se, f, t, w, wpd_i, xc):
        ok = solution_ok(cfg, f, t)
        loco = _accept_solution(cfg, s.core.locomotion, se, f, t, ok=ok)
        loco = _store_warm(loco, w, h_sol, h_max, ok)
        loco = loco.replace(world_position_desired=wpd_i, x_comp_integral=xc)
        return s.replace(core=s.core.replace(locomotion=loco))

    return jax.vmap(accept)(state, ctx["se"], forces, table, warm_full, wpd,
                            x_comp)


def solution_ok(cfg: FrameworkConfig, forces, table):
    """Solver-failure detector: finite solution + friction-pyramid primal
    feasibility within cfg.solver.fail_primal_tol (in Newtons).

    The ADMM solve cannot 'fail' loudly like qpOASES (SolverMPC.cpp:539-541)
    — a diverged or infeasible solve would flow straight into torques — so
    the acceptance test is the structural primal residual, which costs two
    elementwise passes over the (h,4,5) pyramid rows."""
    ax = formation.pyramid_apply(cfg.mpc, forces)              # (h,4,5)
    l3, u3 = formation.pyramid_bounds(cfg.mpc, table.astype(forces.dtype))
    up_viol = jnp.where(u3 < cfg.solver.infty, ax - u3, 0.0)
    viol = jnp.max(jnp.maximum(l3 - ax, up_viol))
    return jnp.all(jnp.isfinite(forces)) & (viol < cfg.solver.fail_primal_tol)


def _accept_solution(cfg: FrameworkConfig, loco, se: StateEstimate, forces,
                     table, ok=None):
    """Accept the MPC forces, or hold the previous solution on solver failure
    (the reference keeps the stale qpOASES solution and prints
    'failed to solve!', SolverMPC.cpp:539-541 / convexMPC_interface.cpp:
    175-180; here the event is counted in loco.mpc_fail_count)."""
    ok = solution_ok(cfg, forces, table) if ok is None else ok
    fr_des = jnp.where(ok, forces[0], loco.fr_des)      # first-step forces
    f_ff = -jnp.einsum("ij,fj->fi", se.r_body, fr_des)  # body frame, reaction
    return loco.replace(
        f_ff=f_ff, fr_des=fr_des,
        mpc_fail_count=loco.mpc_fail_count + (1 - ok.astype(jnp.int32)),
    )


def _warm_slices(loco, h_sol: int):
    """The stored warm-start triple, flattened to the solver's layout for an
    h_sol-step problem (zeros = cold start)."""
    return (
        loco.mpc_warm_x[:h_sol].reshape(-1),
        loco.mpc_warm_z[:h_sol].reshape(-1),
        loco.mpc_warm_y[:h_sol].reshape(-1),
    )


def _store_warm(loco, warm, h_sol: int, h_max: int, ok):
    """Advance the solver's returned warm triple by one gait segment
    (consecutive solves are dtMPC apart — exactly one row of the rolled MPC
    table, so the shifted iterate aligns with the next problem's active-set
    structure) and store it at h_max size. Failed or non-finite solves reset
    the store to zeros (cold restart)."""

    def shift(w, d):
        w = w.reshape(h_sol, 4, d)
        w = jnp.concatenate([w[1:], w[-1:]], axis=0)
        return jnp.zeros((h_max, 4, d), jnp.float32).at[:h_sol].set(w)

    wx, wz, wy = warm
    good = ok
    for w in warm:
        good = good & jnp.all(jnp.isfinite(w))
    sx, sz, sy = shift(wx, 3), shift(wz, 5), shift(wy, 5)
    keep = lambda a: jnp.where(good, a, jnp.zeros_like(a))
    return loco.replace(
        mpc_warm_x=keep(sx), mpc_warm_z=keep(sz), mpc_warm_y=keep(sy)
    )


@exact_matmuls
def leg_commands(cfg: FrameworkConfig, state: FullControllerState, ctx):
    """Swing/stance command writing + torque mapping + safety gate.

    Reference: ConvexMPCLocomotion.cpp:394-472, LegController.cpp:113-188,
    GaitCtrller.cpp:128-142. Returns (state, ControllerOutput).
    """
    core = state.core
    loco = core.locomotion
    se: StateEstimate = ctx["se"]
    leg: LegData = ctx["leg"]
    swing_states = ctx["swing_states"]
    contact_states = ctx["contact_states"]
    in_swing = swing_states > 0

    # swing start: reset p0 to the current foot position
    start_swing = in_swing & loco.first_swing
    swing_p0 = jnp.where(start_swing[:, None], ctx["p_foot"], loco.swing_p0)
    first_swing = jnp.where(in_swing, False, True)

    p_sw, v_sw, _ = swing_mod.swing_trajectory(
        swing_p0, loco.swing_pf, cfg.swing.height, swing_states, ctx["swing_times"]
    )
    # stance feet keep the last computed trajectory point (zero velocity at
    # touchdown) — ConvexMPCLocomotion.cpp:439-444 semantics
    p_traj = jnp.where(in_swing[:, None], p_sw, state.swing_p_cur)
    v_traj = jnp.where(in_swing[:, None], v_sw, state.swing_v_cur)

    hips = jnp.asarray(cfg.robot.hip_locations())
    p_des_leg = (
        jnp.einsum("ij,fj->fi", se.r_body, p_traj - se.position[None, :]) - hips
    )
    v_des_leg = jnp.einsum("ij,fj->fi", se.r_body, v_traj - se.v_world[None, :])

    kp_sw = jnp.asarray(cfg.control.kp_cartesian, jnp.float32)
    kd_sw = jnp.asarray(cfg.control.kd_cartesian, jnp.float32)
    kp = jnp.where(in_swing[:, None], kp_sw[None, :], 0.0)
    kd = jnp.where(
        in_swing[:, None], kd_sw[None, :], cfg.control.kd_stance_scale * kd_sw[None, :]
    )
    force_ff = jnp.where(in_swing[:, None], 0.0, loco.f_ff)

    # safety cascade, second half (GaitCtrller.cpp:113-118): pDes and
    # force-feedforward checks on the actually-commanded values, with the
    # reference's clamp side-effects; failures latch like the first half
    p_des_leg, ok_pdes = safety.check_p_des_foot(cfg.safety, cfg.robot,
                                                 p_des_leg)
    force_ff, ok_force = safety.check_force_feedforward(cfg.safety, force_ff)
    safety_ok = core.safety_ok & ok_pdes & ok_force

    tau = leg_controller.update_command(
        cfg.control, leg, p_des_leg, v_des_leg, kp, kd, force_ff
    )
    tau = jnp.where(safety_ok, tau, jnp.zeros_like(tau))

    # contact phase feedback to the estimator (line 472)
    se_contact = jnp.where(in_swing, 0.0, contact_states)
    est = core.estimator.replace(contact_phase=se_contact)

    loco = loco.replace(first_swing=first_swing, swing_p0=swing_p0)
    core = core.replace(estimator=est, locomotion=loco, safety_ok=safety_ok)
    state = state.replace(core=core, swing_p_cur=p_traj, swing_v_cur=v_traj)

    out = ControllerOutput(
        tau=tau,
        p_foot_des=p_traj,
        v_foot_des=v_traj,
        fr_des=loco.fr_des,
        contact_state=contact_states,
        swing_state=swing_states,
        p_body_des=jnp.stack(
            [
                loco.world_position_desired[0],
                loco.world_position_desired[1],
                jnp.asarray(cfg.control.body_height, jnp.float32),
            ]
        ),
        v_body_des=ctx["v_des_world"].at[2].set(0.0),
        estimate=se,
    )
    return state, out


@exact_matmuls
def controller_step(cfg: FrameworkConfig, state: FullControllerState,
                    sensors: Sensors, cmd: Command,
                    mpc_iterations: int | None = None):
    """Single-robot full tick with the MPC under `lax.cond` (fires every
    iterations_between_mpc ticks, holding the last solution otherwise)."""
    state, ctx = control_tick(cfg, state, sensors, cmd)
    state = lax.cond(
        ctx["mpc_due"],
        lambda s: mpc_update(cfg, s, ctx, iterations=mpc_iterations),
        lambda s: s,
        state,
    )
    return leg_commands(cfg, state, ctx)


@exact_matmuls
def pre_work(cfg: FrameworkConfig, state: FullControllerState, sensors: Sensors):
    """Estimator warm-up tick: run estimators + leg-data update, no control
    (the reference's pre_work FFI call, GaitCtrller.cpp:58-63, used 10x at
    reset, walking_simulation.py:185-189)."""
    est, _ = run_estimators(cfg, state.core.estimator, sensors, state.prev_leg)
    leg = leg_controller.update_data(cfg.robot, sensors.q, sensors.qd)
    return state.replace(core=state.core.replace(estimator=est), prev_leg=leg)


def init_state(cfg: FrameworkConfig) -> FullControllerState:
    return FullControllerState.create(cfg)
