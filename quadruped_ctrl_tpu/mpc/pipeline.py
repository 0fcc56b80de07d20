"""The complete MPC pipeline (linearize -> discretize -> condense -> cost ->
ADMM solve) as one pure function, plus its batched form.

This is the throughput unit for the solves/s benchmarks: everything the
reference does between `update_problem_data_floats` and `get_solution`
(convexMPC_interface.cpp:121-180) for one scenario, vmappable over thousands.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.mpc import formation
from quadruped_ctrl_tpu.solver import admm


@struct.dataclass
class MPCInputs:
    """Per-scenario solver inputs (the reference's update_data_t,
    convexMPC_interface.h:10-38)."""

    rpy: jnp.ndarray          # (3,)
    position: jnp.ndarray     # (3,)
    omega_world: jnp.ndarray  # (3,)
    v_world: jnp.ndarray      # (3,)
    r_feet: jnp.ndarray       # (4,3) foot positions relative to CoM, world
    traj: jnp.ndarray         # (h,13) reference (13th column zero)
    gait_table: jnp.ndarray   # (h,4)
    x_drag: jnp.ndarray       # ()


def solve(cfg: FrameworkConfig, inp: MPCInputs, h: int | None = None,
          iterations: int | None = None, polish_rounds: int | None = None):
    """One full MPC solve. Returns forces (h,4,3), world frame."""
    h = inp.gait_table.shape[0] if h is None else h
    a_ct, b_ct = formation.srb_ct_dynamics(
        cfg.mpc, inp.r_feet, inp.rpy[2], inp.x_drag
    )
    adt, bdt = formation.discretize(a_ct, b_ct, cfg.dt_mpc)
    x0 = formation.build_x0(
        inp.rpy, inp.position, inp.omega_world, inp.v_world, cfg.mpc.gravity
    )
    step_mask = jnp.ones((h,), jnp.float32)
    hess, grad = formation.qp_cost_nil(cfg.mpc, adt, bdt, x0, inp.traj, step_mask)
    forces = admm.admm_mpc(
        cfg.solver, cfg.mpc, hess, grad, inp.gait_table,
        iterations=iterations, polish_rounds=polish_rounds,
    )
    return forces.reshape(h, 4, 3)


def solve_batch(cfg: FrameworkConfig, inputs: MPCInputs, **kw):
    """vmapped solve over a leading batch axis."""
    return jax.vmap(lambda i: solve(cfg, i, **kw))(inputs)


def random_inputs(key, batch: int, h: int, trot: bool = True) -> MPCInputs:
    """Random-but-realistic scenario batch (the JCQP ProblemGenerator pattern,
    reference src/JCQP/ProblemGenerator.cpp:9-40)."""
    ks = jax.random.split(key, 8)
    rpy = jax.random.uniform(ks[0], (batch, 3), jnp.float32, -0.1, 0.1)
    position = jnp.concatenate(
        [
            jax.random.uniform(ks[1], (batch, 2), jnp.float32, -1.0, 1.0),
            jax.random.uniform(ks[2], (batch, 1), jnp.float32, 0.25, 0.3),
        ],
        axis=1,
    )
    omega = jax.random.uniform(ks[3], (batch, 3), jnp.float32, -0.3, 0.3)
    v = jax.random.uniform(ks[4], (batch, 3), jnp.float32, -0.5, 0.5)
    r_feet = jax.random.uniform(ks[5], (batch, 4, 3), jnp.float32, -0.25, 0.25)
    r_feet = r_feet.at[:, :, 2].set(
        jax.random.uniform(ks[6], (batch, 4), jnp.float32, -0.30, -0.25)
    )
    traj = jnp.zeros((batch, h, 13), jnp.float32)
    traj = traj.at[:, :, 5].set(0.25)
    traj = traj.at[:, :, 9].set(v[:, None, 0])
    if trot:
        half = h // 2
        tbl = jnp.zeros((h, 4), jnp.float32)
        tbl = tbl.at[:half, 0].set(1).at[:half, 3].set(1)
        tbl = tbl.at[half:, 1].set(1).at[half:, 2].set(1)
        gait = jnp.tile(tbl, (batch, 1, 1))
    else:
        gait = jnp.ones((batch, h, 4), jnp.float32)
    return MPCInputs(
        rpy=rpy,
        position=position,
        omega_world=omega,
        v_world=v,
        r_feet=r_feet,
        traj=traj,
        gait_table=gait,
        x_drag=jnp.zeros((batch,), jnp.float32),
    )


def walking_band_gait(h: int, v_band: float = 0.3):
    """(h,4) contact table of the aio walking->trot morph band
    (0.2 < v <= 0.4, ConvexMPCLocomotion.cpp:174-233): a 3-stance gait, so
    `max_stance=3` compresses it exactly (every step has 1..3 stance feet)."""
    import numpy as np

    o2 = int(np.floor(h * 1.25 * v_band))
    o3 = int(np.floor(h * (1.25 * v_band + 0.5)))
    dwt = int(np.floor(h * (-1.25 * v_band + 1.0)))
    offs = np.array([0, h // 2, o2, o3])
    steps = np.arange(h)[:, None]
    tbl = (((steps - offs[None, :]) % h) < dwt).astype(np.float32)
    assert tbl.sum(axis=1).max() <= 3 and (tbl.sum(1) >= 1).all()
    return tbl


def solve_compressed(cfg: FrameworkConfig, inp: MPCInputs, max_stance: int,
                     h: int | None = None, iterations: int | None = None,
                     polish_rounds: int | None = None):
    """Full MPC solve over stance-foot variables only (the reference's
    swing-variable elimination, SolverMPC.cpp:441-525, as a static-shape
    gather). For a trot (max_stance=2) the KKT factorizations shrink 8x.
    Returns forces (h,4,3) with zeros on swing feet."""
    h = inp.gait_table.shape[0] if h is None else h
    a_ct, b_ct = formation.srb_ct_dynamics(
        cfg.mpc, inp.r_feet, inp.rpy[2], inp.x_drag
    )
    adt, bdt = formation.discretize(a_ct, b_ct, cfg.dt_mpc)
    x0 = formation.build_x0(
        inp.rpy, inp.position, inp.omega_world, inp.v_world, cfg.mpc.gravity
    )
    foot_idx, gait_red = formation.compress_stance(inp.gait_table, max_stance)
    step_mask = jnp.ones((h,), jnp.float32)
    hess, grad = formation.qp_cost_compressed_nil(
        cfg.mpc, adt, bdt, x0, inp.traj, step_mask, foot_idx
    )
    x_red = admm.admm_mpc(
        cfg.solver, cfg.mpc, hess, grad, gait_red,
        iterations=iterations, polish_rounds=polish_rounds,
    )
    return formation.scatter_forces(x_red, foot_idx, h)


def solve_compressed_batch(cfg: FrameworkConfig, inputs: MPCInputs,
                           max_stance: int, **kw):
    return jax.vmap(lambda i: solve_compressed(cfg, i, max_stance, **kw))(inputs)


def solve_packed_batch(cfg: FrameworkConfig, inputs: MPCInputs,
                       max_stance: int = 2, pack: int = 2,
                       h: int | None = None, iterations: int | None = None,
                       polish_rounds: int | None = None,
                       form_only: bool = False):
    """Stance-compressed + pair-packed batched solve.

    Two (or `pack`) compressed scenarios are packed into one block-diagonal
    KKT system: for a trot, 2 scenarios x 60 vars = one 120x120 system — the
    same matmul shape as the uncompressed problem at HALF the system
    count, and exactly equivalent (block-diagonal inverses don't mix; the
    packed problem is literally the two QPs side by side, steps relabeled).
    Returns forces (B, h, 4, 3) with zeros on swing feet.
    """
    b = inputs.rpy.shape[0]
    assert b % pack == 0
    h = inputs.gait_table.shape[1] if h is None else h

    # batch-explicit formation: closed-form sparse dynamics, sortless stance
    # selection, sqrt-S-folded transpose-free cost (formation.srb_discrete /
    # stance_selectors / qp_cost_compressed_nil_sel) in place of the
    # vmapped per-scenario formation and its many tiny scatter ops
    adt, bdt = formation.srb_discrete(
        cfg.mpc, inputs.r_feet, inputs.rpy[:, 2], inputs.x_drag, cfg.dt_mpc
    )
    x0 = formation.build_x0(
        inputs.rpy, inputs.position, inputs.omega_world, inputs.v_world,
        cfg.mpc.gravity,
    )
    foot_idx, gait_red, sel = formation.stance_selectors(
        inputs.gait_table, max_stance
    )
    step_mask = jnp.ones((b, h), jnp.float32)
    n_c = 3 * max_stance * h

    # packed block-diagonal QP cost
    kp, gp = formation.qp_cost_packed(
        cfg.mpc, adt, bdt, x0, inputs.traj, step_mask, sel, pack
    )
    if form_only:
        # benchmark support: formation-phase timing without the solve (the
        # returned "forces" depend on every formed quantity so nothing is
        # elided, but no KKT factorization/iteration runs)
        probe = (jnp.sum(kp, axis=(1, 2)) + jnp.sum(gp, axis=1)) * 1e-12
        probe = jnp.broadcast_to(probe[:, None], (b // pack, pack))
        return jnp.broadcast_to(
            probe.reshape(b, 1, 1, 1), (b, h, 4, 3))
    gaitp = gait_red.reshape(b // pack, pack * h, max_stance)

    xp = admm.admm_mpc_batched(
        cfg.solver, cfg.mpc, kp, gp, gaitp,
        iterations=iterations, polish_rounds=polish_rounds, pack=pack,
    )                                                 # (B/pack, pack*n_c)
    x_red = xp.reshape(b, n_c)
    return jax.vmap(lambda xr, fi: formation.scatter_forces(xr, fi, h))(
        x_red, foot_idx
    )
