"""Typed configuration tree.

The reference scatters its constants across hardcoded use sites (see
/root/reference: ConvexMPCLocomotion.cpp:598-649, RobotState.cpp:37-40,
MiniCheetah.h:19-112, PositionVelocityEstimator.cpp:67-72, SafetyChecker.cpp,
config/quadruped_ctrl_config.yaml). Here every constant lives in one frozen
dataclass tree. Configs are hashable so they can be passed as static args to
`jax.jit`; array-valued fields are stored as tuples and converted with the
`*_arr` helpers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RobotConfig:
    """Mini-Cheetah kinematic/actuation parameters (reference MiniCheetah.h:19-112)."""

    body_mass: float = 3.3
    body_length: float = 0.38
    body_width: float = 0.098
    body_height: float = 0.10
    abad_link_length: float = 0.062
    hip_link_length: float = 0.209
    knee_link_length: float = 0.195
    knee_link_y_offset: float = 0.004
    max_leg_length: float = 0.409
    abad_gear_ratio: float = 6.0
    hip_gear_ratio: float = 6.0
    knee_gear_ratio: float = 9.33
    motor_tau_max: float = 3.0
    battery_v: float = 24.0
    motor_kt: float = 0.05
    motor_r: float = 0.173
    joint_damping: float = 0.01
    joint_dry_friction: float = 0.2
    # abad (hip mount) x/y offsets: legs 0..3 = FR, FL, HR, HL
    # (reference Quadruped.h:95-101, MiniCheetah.h:104-105)
    abad_location_x: float = 0.19
    abad_location_y: float = 0.049
    # getSideSign: right legs -1, left legs +1 (reference Quadruped.h:85-89)
    side_signs: tuple = (-1.0, 1.0, -1.0, 1.0)

    def hip_locations(self) -> np.ndarray:
        """(4,3) hip locations in body frame (reference Quadruped.h:95-101)."""
        x, y = self.abad_location_x, self.abad_location_y
        return np.array(
            [[x, -y, 0.0], [x, y, 0.0], [-x, -y, 0.0], [-x, y, 0.0]], dtype=np.float32
        )


@dataclass(frozen=True)
class MPCConfig:
    """Condensed convex MPC parameters.

    References: ConvexMPCLocomotion.cpp:598-652 (weights, alpha, mu, f_max),
    RobotState.cpp:37-40 / RobotState.h:27 (SRB inertia & mass),
    GaitCtrller.cpp:6 (iterations_between_mpc), convexMPC_interface.h:3 (cap).
    """

    horizon: int = 14            # default gait horizon (ConvexMPCLocomotion.cpp:25)
    h_max: int = 16              # static padded horizon for jit (aio range is 10..16)
    iterations_between_mpc: int = 13
    weights: tuple = (2.5, 2.5, 10.0, 50.0, 50.0, 100.0, 0.0, 0.0, 0.5, 0.2, 0.2, 0.1)
    alpha: float = 4e-5          # control regularizer
    mu: float = 0.4              # friction-pyramid coefficient
    f_max: float = 120.0         # per-foot max normal force [N]
    mass: float = 9.0            # SRB mass (heavier than CAD body mass; RobotState.h:27)
    inertia: tuple = (0.07, 0.26, 0.242)  # SRB body-frame diagonal inertia
    big_number: float = 5e10
    x_comp_drag: float = 3.0     # cmpc_x_drag (ConvexMPCLocomotion.cpp:634)
    gravity: float = 9.8         # value used in the 13th MPC state (SolverMPC.cpp:318)

    def weights_arr(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float32)

    def inertia_arr(self) -> np.ndarray:
        return np.diag(np.asarray(self.inertia, dtype=np.float32))


@dataclass(frozen=True)
class SolverConfig:
    """Batched ADMM QP solver (OSQP/JCQP-style splitting; spec: JCQP QpProblem.h:15-27,
    QpProblem.cpp:276-368). Defaults follow JCQP's defaults, not the (unused)
    overrides the reference passes when use_jcqp is off."""

    sigma: float = 1e-6
    rho: float = 30.0             # on the force-normalized problem; ~the
                                  # geometric mean of the normalized MPC
                                  # Hessian's diagonal spread (1..220), chosen
                                  # on a 72-case hard battery (cone-binding
                                  # pushes x {trot,stand,bound} x seeds):
                                  # rho=1 left 48/72 cases >2 N off (worst
                                  # 1968 N); rho=30 with 250 iters + 4 polish
                                  # rounds solves all 72 to <1.4 N
    rho_equality_scale: float = 1e3
    rho_infty: float = 1e-6
    over_relax_alpha: float = 1.6
    iterations: int = 120         # fixed iteration count for batched solves.
                                  # With rho_adapt=1 + 4 polish rounds the
                                  # hard battery (see rho note) passes from
                                  # 100 iterations up, and QP-parity vs the
                                  # reference qpOASES is flat in the count
                                  # (the polish recovers the exact active
                                  # set); 120 keeps margin at ~2x the speed
                                  # of the pre-adaptive 250
    warm_iterations: int = 40     # iterate budget for temporally warm-started
                                  # closed-loop solves (batch_rollout): with
                                  # the previous tick's shifted (x,z,y) as
                                  # init, consecutive solves (dtMPC apart)
                                  # converge in a third of the cold budget;
                                  # zeros-init degenerates to a cold start,
                                  # and the acceptance gate + polish cover
                                  # the first (cold) solve of a session
    polish_rounds: int = 3        # active-set polish solves after ADMM.
                                  # Each round is a cold KKT factorization
                                  # (half the cold-pipeline cost at 4 rounds).
                                  # Measured: on the 18-case hard battery vs
                                  # the f64 oracle rounds 3 and 4 are
                                  # identical (0.044 N worst); at 2 rounds a
                                  # random-scenario pipeline case misses the
                                  # oracle by 2.4 N (wrong active set), so 3
                                  # is the floor (was 4; all oracle/golden
                                  # gates pass at 3)
    rho_adapt: int = 1            # OSQP-style adaptive-rho events inside the
                                  # iterate phase: the iterations are split
                                  # into rho_adapt+1 equal segments, and at
                                  # each boundary rho is rescaled per problem
                                  # by the clipped sqrt of the scaled
                                  # primal/dual residual ratio and the KKT
                                  # system refactorized (per-scenario paths
                                  # warm start from the previous inverse)
    rho_adapt_clip_lo: float = 0.1
    rho_adapt_clip_hi: float = 10.0
    ns_iters: int = 25            # Newton-Schulz iterations per KKT
                                  # factorization (HIGHEST precision)
    # Dual-informed polish seeding: rows whose ADMM multiplier magnitude
    # exceeds this (force-normalized units) join the initial active-set
    # estimate alongside the z-proximity rows — a better round-0 active set
    # lets a smaller polish_rounds reach the oracle. 0 disables (z-only).
    # STATUS: measured NOT to buy back a round (polish-rounds study vs
    # the f64 oracle, recorded in PERF.md): at polish_rounds=2 one
    # pipeline scenario of 126 misses the f64 oracle by 1.40 N, bitwise-unchanged at tol 0.01/0.03/0.1 — the miss is not
    # a round-0 active-set identification failure (the seeded rows are
    # already in the z-proximity set); it needs the extra refinement
    # round's drop/add pass. polish_rounds=3 stays the floor.
    polish_dual_seed_tol: float = 0.0
    # Woodbury polish refinement (batched path): rounds 1..k apply the
    # active-set weight flips as a rank-r Woodbury correction of the
    # previous round's inverse (capacitance via a batched pivoted
    # Gauss-Jordan), warm-starting a ns_wb_quad+ns_wb_hi Newton-Schulz
    # refactorization — 2 iterations instead of the ns_iters cold
    # schedule per round.
    # STATUS: OFF — measured numerically unsound in f32 at the polish
    # conditioning. The correction amplifies the stored inverse's error by
    # ~w_act: constraint ADDITIONS stay refinable (warm-NS residual ~0.2),
    # but REMOVING a dominant +1e4 penalty row lands at residual ~300
    # (divergent; exact in f64 — verified), and the polish's hard scenarios
    # need removals: the 72-case battery fails by ~14 N with every variant
    # tried (round-0-anchored and chained updates, rank 8-32, clamped
    # working-set churn, additions-only). Kept as the candidate for
    # hardware with f64 or extended-precision accumulation; the cold
    # per-round factorization (the JCQP/qpOASES refactorization role,
    # SolverMPC.cpp:530-532) remains the production path.
    # A later re-examination was still negative: slower than the cold
    # path, and step-0 force divergence vs the cold path q99 ~1.0 N /
    # max 13 N (the f32 soundness issue, unchanged). The Woodbury-built
    # INIT is what exceeds the NS convergence region on removal-heavy
    # rounds.
    polish_woodbury: bool = False
    polish_woodbury_rank: int = 8
    # Newton-Schulz iterations of the Woodbury-seeded refactorization
    # (their sum is the count; two fields for the former quadratic/tail
    # split, both HIGHEST now).
    ns_wb_quad: int = 1
    ns_wb_hi: int = 1
    # Active-set penalty weight of the polish solves (force-normalized
    # units). 1e4 pins active rows to ~|dual|/w_act before the AL dual
    # correction; it also sets the polish K's conditioning (~1e5), and
    # thereby how far the polish factorizations' NS iteration must go.
    polish_w_act: float = 1e4
    infty: float = 1e10
    eql_tol: float = 1e-9
    # solver-failure acceptance gate (control path only): max friction-
    # pyramid primal violation, in Newtons, before the previous tick's
    # solution is held (the reference's stale-solution-on-failure semantics,
    # SolverMPC.cpp:539-541). Nominal polished solves sit below 0.05 N.
    fail_primal_tol: float = 2.0


@dataclass(frozen=True)
class SwingConfig:
    """Swing trajectory + Raibert foot placement (ConvexMPCLocomotion.cpp:290-371)."""

    height: float = 0.06
    p_rel_max: float = 0.3
    side_offset_y: float = 0.065
    interleave_y: tuple = (-0.08, 0.08, 0.02, -0.02)
    interleave_gain: float = -0.2
    bonus_swing: float = 0.0
    vel_err_gain: float = 0.03
    capture_point_factor: float = 0.5


@dataclass(frozen=True)
class ControlConfig:
    """Command filtering, gains, torque mapping.

    References: ConvexMPCLocomotion.cpp:76-114 (filters/clamps), :378-381
    (cartesian gains), :457 (kd_joint, written but unused by updateCommand),
    LegController.cpp:113-155 (joint PD from ctrlParam), GaitCtrller.cpp:75-93
    (velocity deadband), config/quadruped_ctrl_config.yaml (PD params).
    """

    body_height: float = 0.25
    stand_height: float = 0.21   # stand_traj[2] (ConvexMPCLocomotion.cpp:141)
    x_filter: float = 0.01
    y_filter: float = 0.006
    yaw_filter: float = 0.03
    vx_max: float = 2.0
    vx_min: float = -1.0
    vy_max: float = 0.6
    vel_deadband: float = 0.03
    kp_cartesian: tuple = (700.0, 700.0, 200.0)
    kd_cartesian: tuple = (10.0, 10.0, 10.0)
    kd_stance_scale: float = 1.0
    # ctrlParam = [stand_kp, stand_kd, joint_kp, joint_kd]; only 2,3 are used
    # (quadruped_ctrl_config.yaml 'simulation' block; GaitCtrller.cpp:14-16)
    stand_kp: float = 100.0
    stand_kd: float = 1.0
    joint_kp: float = 0.0
    joint_kd: float = 0.05
    rpy_int_max: float = 0.25    # terrain-compensation integral clamp


@dataclass(frozen=True)
class EstimatorConfig:
    """Orientation + 18-state linear KF (PositionVelocityEstimator.cpp:18-72,140-169)."""

    dt: float = 0.002
    process_noise_pimu: float = 0.02
    process_noise_vimu: float = 0.02
    process_noise_pfoot: float = 0.002
    sensor_noise_pimu_rel_foot: float = 0.001
    sensor_noise_vimu_rel_foot: float = 0.1
    sensor_noise_zfoot: float = 0.001
    trust_window: float = 0.2
    high_suspect_number: float = 100.0
    initial_p: float = 100.0
    gravity: float = 9.81


@dataclass(frozen=True)
class SafetyConfig:
    """SafetyChecker limits (SafetyChecker.cpp:19-278)."""

    rpy_limit: float = 0.5
    max_foot_angle: float = 1.0472       # 60 deg
    max_abad_angle: float = 1.0472
    max_hip_angle: float = 0.174533      # 10 deg
    min_hip_angle: float = -1.8
    max_knee_angle: float = 2.79253      # 160 deg
    min_knee_angle: float = -0.174533
    max_lateral_force: float = 350.0
    max_vertical_force: float = 350.0


@dataclass(frozen=True)
class SimConfig:
    """Batched SRB scenario simulator."""

    freq: float = 500.0
    gravity: float = 9.81
    start_height: float = 0.30
    ground_kp: float = 8000.0
    ground_kd: float = 300.0
    mu: float = 0.6


@dataclass(frozen=True)
class FrameworkConfig:
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    swing: SwingConfig = dataclasses.field(default_factory=SwingConfig)
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    safety: SafetyConfig = dataclasses.field(default_factory=SafetyConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)

    @property
    def dt(self) -> float:
        return 1.0 / self.sim.freq

    @property
    def dt_mpc(self) -> float:
        return self.dt * self.mpc.iterations_between_mpc


def default_config(**overrides) -> FrameworkConfig:
    """Build the default config, with dotted-field overrides.

    Example: default_config(**{"mpc.horizon": 10, "sim.freq": 1000.0})
    """
    cfg = FrameworkConfig()
    grouped: dict = {}
    for key, val in overrides.items():
        if "." in key:
            section, field = key.split(".", 1)
            grouped.setdefault(section, {})[field] = val
        else:
            grouped[key] = val
    replacements = {}
    for section, val in grouped.items():
        if isinstance(val, dict):
            replacements[section] = dataclasses.replace(getattr(cfg, section), **val)
        else:
            replacements[section] = val
    return dataclasses.replace(cfg, **replacements) if replacements else cfg
