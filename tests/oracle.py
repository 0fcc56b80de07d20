"""NumPy/SciPy float64 oracles for differential testing.

These transliterate the *math* of the reference formation
(/root/reference/src/MPC_Ctrl/SolverMPC.cpp:87-125, 235-254, 296-399) into
independent NumPy so the JAX implementation can be validated against a
trusted, higher-precision implementation — the JCQP differential-test
pattern (reference src/JCQP/main.cpp). Solver ground truth comes from
scipy.optimize (independent algorithm family from ADMM).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.optimize


def quat_to_rpy(q):
    w, x, y, z = q
    as_ = min(-2.0 * (x * z - w * y), 0.99999)
    yaw = np.arctan2(2 * (x * y + w * z), w * w + x * x - y * y - z * z)
    pitch = np.arcsin(as_)
    roll = np.arctan2(2 * (y * z + w * x), w * w - x * x - y * y + z * z)
    return np.array([roll, pitch, yaw])


def ct_ss_mats(i_body_diag, mass, r_feet, yaw, x_drag):
    """r_feet: (4,3). Returns A (13,13), B (13,12)."""
    c, s = np.cos(yaw), np.sin(yaw)
    r_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    i_world = r_yaw @ np.diag(i_body_diag) @ r_yaw.T
    i_inv = np.linalg.inv(i_world)
    a = np.zeros((13, 13))
    a[3, 9] = 1.0
    a[4, 10] = 1.0
    a[5, 11] = 1.0
    a[11, 9] = x_drag
    a[11, 12] = 1.0
    a[0:3, 6:9] = r_yaw.T
    b = np.zeros((13, 12))
    for f in range(4):
        r = r_feet[f]
        cm = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
        b[6:9, 3 * f : 3 * f + 3] = i_inv @ cm
        b[9:12, 3 * f : 3 * f + 3] = np.eye(3) / mass
    return a, b


def c2qp(a_ct, b_ct, dt, horizon):
    abc = np.zeros((25, 25))
    abc[0:13, 0:13] = a_ct
    abc[0:13, 13:25] = b_ct
    em = scipy.linalg.expm(abc * dt)
    adt = em[0:13, 0:13]
    bdt = em[0:13, 13:25]
    powers = [np.eye(13)]
    for _ in range(horizon):
        powers.append(adt @ powers[-1])
    a_qp = np.zeros((13 * horizon, 13))
    b_qp = np.zeros((13 * horizon, 12 * horizon))
    for r in range(horizon):
        a_qp[13 * r : 13 * r + 13, :] = powers[r + 1]
        for c in range(r + 1):
            b_qp[13 * r : 13 * r + 13, 12 * c : 12 * c + 12] = powers[r - c] @ bdt
    return adt, bdt, a_qp, b_qp


def qp_cost(a_qp, b_qp, weights12, alpha, x0, traj12, horizon):
    """H, g per SolverMPC.cpp:335-399. traj12: (horizon, 12)."""
    full_w = np.concatenate([weights12, [0.0]])
    s = np.diag(np.tile(full_w, horizon))
    x_d = np.zeros(13 * horizon)
    for i in range(horizon):
        x_d[13 * i : 13 * i + 12] = traj12[i]
    hess = 2.0 * (b_qp.T @ s @ b_qp + alpha * np.eye(12 * horizon))
    grad = 2.0 * b_qp.T @ s @ (a_qp @ x0 - x_d)
    return hess, grad


def pyramid_matrix(mu, horizon):
    """Dense fmat (20h, 12h) (SolverMPC.cpp:366-377)."""
    mu_inv = 1.0 / mu
    f_block = np.array(
        [
            [mu_inv, 0, 1.0],
            [-mu_inv, 0, 1.0],
            [0, mu_inv, 1.0],
            [0, -mu_inv, 1.0],
            [0, 0, 1.0],
        ]
    )
    fmat = np.zeros((20 * horizon, 12 * horizon))
    for i in range(horizon * 4):
        fmat[i * 5 : i * 5 + 5, i * 3 : i * 3 + 3] = f_block
    return fmat


def pyramid_bounds(gait, f_max, big, horizon):
    u = np.full(20 * horizon, big)
    for i in range(horizon):
        for j in range(4):
            u[(i * 4 + j) * 5 + 4] = gait[i, j] * f_max
    l = np.zeros(20 * horizon)
    return l, u


def solve_qp_trusted(hess, grad, a_mat, l, u, tol=1e-10):
    """Reference-quality convex QP solve via scipy trust-constr."""
    n = hess.shape[0]
    constraint = scipy.optimize.LinearConstraint(a_mat, l, u)
    res = scipy.optimize.minimize(
        lambda x: 0.5 * x @ hess @ x + grad @ x,
        np.zeros(n),
        jac=lambda x: hess @ x + grad,
        hess=lambda x: hess,
        method="trust-constr",
        constraints=[constraint],
        options={"gtol": tol, "xtol": tol, "maxiter": 3000},
    )
    return res.x


def mpc_table(offsets, durations, n_iterations, iteration, horizon):
    """Gait.cpp:142-166."""
    table = np.zeros((horizon, 4), dtype=int)
    for i in range(horizon):
        it = (i + iteration + 1) % n_iterations
        for j in range(4):
            progress = it - offsets[j]
            if progress < 0:
                progress += n_iterations
            table[i, j] = 1 if progress < durations[j] else 0
    return table


from quadruped_ctrl_tpu.solver.ipm import solve_qp_exact  # noqa: E402,F401


def solve_mpc_qp_exact(hess, grad, gait, mu, f_max, big=5e10):
    """Exact MPC-QP solve: eliminate swing-foot variables (the reference's
    SolverMPC.cpp:441-525 reduction — removing them and their rows leaves the
    same minimizer with zeros scattered back), then IPM on the reduced
    problem which has a strict interior. gait: (h,4) in {0,1}."""
    h = gait.shape[0]
    n = 12 * h
    keep_vars = np.ones(n, dtype=bool)
    keep_rows = np.ones(20 * h, dtype=bool)
    for i in range(h):
        for j in range(4):
            if gait[i, j] == 0:
                keep_vars[12 * i + 3 * j : 12 * i + 3 * j + 3] = False
                r0 = (i * 4 + j) * 5
                keep_rows[r0 : r0 + 5] = False
    fmat = pyramid_matrix(mu, h)
    l, u = pyramid_bounds(gait, f_max, big, h)
    h_red = hess[np.ix_(keep_vars, keep_vars)]
    g_red = grad[keep_vars]
    a_red = fmat[np.ix_(keep_rows, keep_vars)]
    l_red = l[keep_rows]
    u_red = u[keep_rows]
    x_red = solve_qp_exact(h_red, g_red, a_red, l_red, u_red)
    x = np.zeros(n)
    x[keep_vars] = x_red
    return x


def mpc_step_forces(cfg, inp):
    """Float64 optimum of one scenario's MPC QP, (h,4,3) forces: the
    reference formation (ct_ss_mats -> c2qp -> qp_cost) and the exact
    solve, for one scenario of `mpc/pipeline.random_inputs` (arrays
    without the batch axis; traj is (h,13))."""
    h = np.asarray(inp.gait_table).shape[0]
    a_ct, b_ct = ct_ss_mats(
        np.array(cfg.mpc.inertia), cfg.mpc.mass, np.asarray(inp.r_feet),
        float(inp.rpy[2]), float(inp.x_drag),
    )
    _, _, a_qp, b_qp = c2qp(a_ct, b_ct, cfg.dt_mpc, h)
    x0 = np.concatenate([
        np.asarray(inp.rpy), np.asarray(inp.position),
        np.asarray(inp.omega_world), np.asarray(inp.v_world),
        [-cfg.mpc.gravity],
    ])
    hess, grad = qp_cost(
        a_qp, b_qp, np.array(cfg.mpc.weights), cfg.mpc.alpha, x0,
        np.asarray(inp.traj)[:, :12], h,
    )
    x = solve_mpc_qp_exact(hess, grad, np.asarray(inp.gait_table),
                           cfg.mpc.mu, cfg.mpc.f_max)
    return x.reshape(h, 4, 3)
