"""High-accuracy float64 reference QP solver (primal-dual interior point).

The role qpOASES plays in the reference stack (the trusted high-accuracy
solver the fast solver is differential-tested against — SURVEY.md §2.7):
a Mehrotra predictor-corrector IPM in NumPy float64 with a KKT certificate.
Used by the test suite as ground truth for the batched ADMM, and
available to users for offline verification.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def solve_qp_exact(hess, grad, a_mat, l, u, iters=100, tol=1e-10,
                   res_tol=1e-8):
    """High-accuracy convex QP solve via a primal-dual interior-point method
    (float64), with a KKT certificate. Independent algorithm family from the
    framework's ADMM; much more accurate than scipy trust-constr on flat MPC
    problems. Raises if the certificate fails.

    Solves min 0.5 x'Px + q'x  s.t.  Gx <= h  with
    G = [-A; A_finite_upper], h = [-l; u_finite].

    Stops once the duality measure is below `tol` and both residuals below
    `res_tol` (the residuals floor at f64 rounding of O(100 N) forces, so
    they cannot be held to `tol`), or when the Newton system stops being
    numerically positive definite; the certificate then decides.
    """
    finite_u = u < 1e9
    g_mat = np.vstack([-a_mat, a_mat[finite_u]])
    h_vec = np.concatenate([-l, u[finite_u]])
    n = hess.shape[0]
    m = g_mat.shape[0]

    x = np.zeros(n)
    s = np.maximum(h_vec - g_mat @ x, 1.0)
    z = np.ones(m)
    for _ in range(iters):
        gx = g_mat @ x
        r_dual = hess @ x + grad + g_mat.T @ z
        r_pri = gx + s - h_vec
        mu = (s @ z) / m
        if mu < tol and max(np.abs(r_dual).max(),
                            np.abs(r_pri).max()) < res_tol:
            break
        # predictor-corrector
        w = z / s
        k = hess + g_mat.T @ (w[:, None] * g_mat)
        try:
            k_chol = scipy.linalg.cho_factor(k)
        except np.linalg.LinAlgError:
            break     # w spans beyond f64 near the optimum

        def newton(sigma_mu, corr):
            # r_c = S Z e - sigma*mu*e + corr;  dz = (-r_c - Z ds)/S
            rc_over_s = z - sigma_mu / s + corr / s
            rhs = -r_dual + g_mat.T @ (rc_over_s - w * r_pri)
            dx = scipy.linalg.cho_solve(k_chol, rhs)
            ds = -r_pri - g_mat @ dx
            dz = -rc_over_s - w * ds
            return dx, ds, dz

        # affine step for centering parameter
        dx_a, ds_a, dz_a = newton(0.0, np.zeros(m))
        a_p = min(1.0, min((-s / ds_a)[ds_a < 0], default=1.0))
        a_d = min(1.0, min((-z / dz_a)[dz_a < 0], default=1.0))
        mu_aff = ((s + a_p * ds_a) @ (z + a_d * dz_a)) / m
        sigma = (mu_aff / mu) ** 3
        dx, ds, dz = newton(sigma * mu, ds_a * dz_a)
        a_p = min(1.0, 0.99 * min((-s / ds)[ds < 0], default=1.0))
        a_d = min(1.0, 0.99 * min((-z / dz)[dz < 0], default=1.0))
        x = x + a_p * dx
        s = s + a_p * ds
        z = z + a_d * dz

    # KKT certificate
    r_dual = np.abs(hess @ x + grad + g_mat.T @ z).max()
    r_pri = max(0.0, (g_mat @ x - h_vec).max())
    comp = np.abs((h_vec - g_mat @ x) * z).max()
    assert r_dual < 1e-6, f"KKT stationarity failed: {r_dual}"
    assert r_pri < 1e-6, f"KKT feasibility failed: {r_pri}"
    assert comp < 1e-5, f"KKT complementarity failed: {comp}"
    return x
