"""Stage-wise ("sparse") MPC formulation — the SparseCMPC-equivalent path.

The reference carries a second MPC formulation (src/MPC_Ctrl/SparseCMPC.cpp,
SparseCMPC_Math.cpp, OsqpTriples.cpp; switched off by cmpc_use_sparse=0 at
ConvexMPCLocomotion.cpp:581-587): 12 states per step (gravity moved to the
affine term), states AND forces as decision variables, dynamics as equality
constraints, solved by OSQP/JCQP from sparse triples. Its niche is long
horizons where the condensed form's O(h^2) workspace explodes
(SURVEY.md §5 "long-context").

Batched re-design: the same stage-wise QP with variables
z = [x_1..x_h (12h), u_0..u_{h-1} (12h)] (force part normalized by f_max),
dynamics equalities enforced through the generic ADMM's equality-row
handling (rho * rho_equality_scale), friction pyramid on the forces. The
per-step (A, B, affine) come from the SAME exact nilpotent discretization as
the dense path, with the gravity column folded into the affine term —
the two paths are differential tests of each other.

Default weights/friction follow the reference's initSparseMPC
(ConvexMPCLocomotion.cpp:732-753): weights [0.25,0.25,10, 2,2,20, 0,0,0.3,
0.2,0.2,0.2], mu=1.0, alpha=4e-5.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from quadruped_ctrl_tpu.config import FrameworkConfig, MPCConfig
from quadruped_ctrl_tpu.mpc import formation
from quadruped_ctrl_tpu.solver import admm

_HI = lax.Precision.HIGHEST

SPARSE_WEIGHTS = (0.25, 0.25, 10.0, 2.0, 2.0, 20.0, 0.0, 0.0, 0.3, 0.2, 0.2, 0.2)
SPARSE_MU = 1.0


def build_sparse_qp(cfg: FrameworkConfig, inp, h: int,
                    weights=None, mu: float | None = None):
    """Assemble (hess, grad, a_mat, l, u) for the stage-wise QP.

    inp: pipeline.MPCInputs. Variables: [X (12h); U_hat (12h)] with
    u = f_max * u_hat. Returns dense constraint data for admm_dense.
    """
    mpc = cfg.mpc
    w12 = jnp.asarray(weights if weights is not None else SPARSE_WEIGHTS,
                      jnp.float32)
    mu = SPARSE_MU if mu is None else mu
    f = mpc.f_max

    a_ct, b_ct = formation.srb_ct_dynamics(mpc, inp.r_feet, inp.rpy[2],
                                           inp.x_drag)
    adt13, bdt13 = formation.discretize(a_ct, b_ct, cfg.dt_mpc)
    a12 = adt13[0:12, 0:12]
    b12 = bdt13[0:12, :] * f                 # normalized forces
    g12 = adt13[0:12, 12] * (-mpc.gravity)   # gravity affine term

    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world,
                            inp.v_world, mpc.gravity)[0:12]

    n = 24 * h
    nx = 12 * h

    # cost: states tracked to the reference; forces regularized
    hess = jnp.zeros((n, n), jnp.float32)
    w_rep = jnp.tile(w12, h)
    hess = hess.at[jnp.arange(nx), jnp.arange(nx)].set(2.0 * w_rep)
    hess = hess.at[jnp.arange(nx, n), jnp.arange(nx, n)].set(
        2.0 * mpc.alpha * f * f
    )
    x_ref = inp.traj[:h, 0:12].reshape(-1)
    grad = jnp.concatenate(
        [-2.0 * w_rep * x_ref, jnp.zeros(nx, jnp.float32)]
    )

    # dynamics equalities: x_{k+1} - A x_k - B u_k = g  (x_0 given)
    m_eq = 12 * h
    a_mat = jnp.zeros((m_eq + 20 * h, n), jnp.float32)
    eye12 = jnp.eye(12, dtype=jnp.float32)
    for k in range(h):
        r0 = 12 * k
        a_mat = a_mat.at[r0 : r0 + 12, 12 * k : 12 * k + 12].set(eye12)
        if k > 0:
            a_mat = a_mat.at[r0 : r0 + 12, 12 * (k - 1) : 12 * k].set(-a12)
        a_mat = a_mat.at[r0 : r0 + 12, nx + 12 * k : nx + 12 * (k + 1)].set(-b12)
    d = jnp.tile(g12, h)
    d = d.at[0:12].add(a12 @ x0)

    # row-equilibrate the dynamics equalities: the omega rows of B*f_max have
    # entries ~12, which multiplied by the equality rho (1e3) would push the
    # ADMM KKT conditioning past the f32 Newton-Schulz budget
    eq_rows = a_mat[0:m_eq, :]
    row_scale = 1.0 / jnp.maximum(jnp.max(jnp.abs(eq_rows), axis=1), 1.0)
    a_mat = a_mat.at[0:m_eq, :].set(eq_rows * row_scale[:, None])
    d = d * row_scale

    # friction pyramid rows on the normalized forces
    mu_inv = 1.0 / mu
    f_block = jnp.asarray(
        [[mu_inv, 0, 1], [-mu_inv, 0, 1], [0, mu_inv, 1], [0, -mu_inv, 1],
         [0, 0, 1]], jnp.float32,
    )
    for i in range(h * 4):
        a_mat = a_mat.at[
            m_eq + 5 * i : m_eq + 5 * i + 5, nx + 3 * i : nx + 3 * i + 3
        ].set(f_block)

    big = jnp.asarray(mpc.big_number, jnp.float32)
    u_pyr = jnp.full((h, 4, 5), big, jnp.float32)
    u_pyr = u_pyr.at[:, :, 4].set(inp.gait_table[:h])   # u_hat in [0, gait]
    l = jnp.concatenate([d, jnp.zeros(20 * h, jnp.float32)])
    u = jnp.concatenate([d, u_pyr.reshape(-1)])
    return hess, grad, a_mat, l, u


def solve_sparse(cfg: FrameworkConfig, inp, h: int | None = None,
                 weights=None, mu: float | None = None,
                 iterations: int = 150, polish_rounds: int = 6):
    """Solve the stage-wise MPC; returns forces (h,4,3), world frame."""
    h = inp.gait_table.shape[0] if h is None else h
    hess, grad, a_mat, l, u = build_sparse_qp(cfg, inp, h, weights, mu)
    x, _, _ = admm.admm_dense(cfg.solver, hess, grad, a_mat, l, u,
                              iterations=iterations,
                              polish_rounds=polish_rounds)
    u_hat = x[12 * h :]
    return (u_hat * cfg.mpc.f_max).reshape(h, 4, 3)
