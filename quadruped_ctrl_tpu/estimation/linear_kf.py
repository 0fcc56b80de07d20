"""18-state linear Kalman filter for body position/velocity.

Re-derivation of LinearKFPositionVelocityEstimator (reference
Controllers/PositionVelocityEstimator.cpp:18-221): state
x = [p(3), v(3), p_foot0..3(12)], 28 measurements (4x relative foot position,
4x foot velocity, 4x foot height), with per-foot contact-"trust" scaling of
the process/measurement noise.

The innovation solve inverts the (SPD) 28x28 innovation covariance with a
Jacobi-prescaled scaled-Newton-Schulz iteration (pure matmuls, no
data-dependent control flow) plus two iterative-refinement passes, instead
of the reference's two LU solves. The refinement drives the solve to the
f32 floor, so estimator parity vs the reference's LU is unchanged
(tests/test_estimation.py, golden torque traces).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from quadruped_ctrl_tpu.config import EstimatorConfig


def mu_schedule(a0: float, n_scaled: int):
    """Scaling factors of the scaled Newton-Schulz interval phase.

    With the spectrum of K X in [a, 1], the step X <- mu X (2I - mu K X),
    mu = 2/(1+a), maps it to [~4a/(1+a)^2, 1]: the lower bound quadruples
    per iteration instead of doubling. Starting from a worst-case a0
    (underestimating it is safe, merely slower), n_scaled fixed factors
    bring the spectrum to where plain quadratic iterations take over."""
    mus = []
    a = a0
    for _ in range(n_scaled):
        mu = 2.0 / (1.0 + a)
        mus.append(mu)
        a = min(mu * a * (2.0 - mu * a), mu * (2.0 - mu))
    return mus


def _static_mats(cfg: EstimatorConfig):
    """A, B, C, Q0 diag, R0 = I as numpy constants (setup(), lines 18-57)."""
    dt = cfg.dt
    a = np.eye(18, dtype=np.float32)
    a[0:3, 3:6] = dt * np.eye(3, dtype=np.float32)
    b = np.zeros((18, 3), dtype=np.float32)
    b[3:6, :] = dt * np.eye(3, dtype=np.float32)
    c = np.zeros((28, 18), dtype=np.float32)
    c1 = np.hstack([np.eye(3), np.zeros((3, 3))]).astype(np.float32)
    c2 = np.hstack([np.zeros((3, 3)), np.eye(3)]).astype(np.float32)
    for i in range(4):
        c[3 * i : 3 * i + 3, 0:6] = c1
        c[12 + 3 * i : 15 + 3 * i, 0:6] = c2
    c[0:12, 6:18] = -np.eye(12, dtype=np.float32)
    c[24, 8] = 1.0
    c[25, 11] = 1.0
    c[26, 14] = 1.0
    c[27, 17] = 1.0
    q0 = np.ones(18, dtype=np.float32)
    q0[0:3] = (dt / 20.0) * cfg.process_noise_pimu
    q0[3:6] = (dt * 9.8 / 20.0) * cfg.process_noise_vimu
    q0[6:18] = dt * cfg.process_noise_pfoot
    r0 = np.ones(28, dtype=np.float32)
    r0[0:12] = cfg.sensor_noise_pimu_rel_foot
    r0[12:24] = cfg.sensor_noise_vimu_rel_foot
    r0[24:28] = cfg.sensor_noise_zfoot
    return a, b, c, q0, r0


def run(
    cfg: EstimatorConfig,
    xhat,                # (18,)
    p_cov,               # (18,18)
    a_world,             # (3,) world-frame acceleration (with +g bias still in)
    r_body,              # (3,3)
    omega_body,          # (3,)
    hip_locations,       # (4,3)
    leg_p,               # (4,3) foot pos in hip frame
    leg_v,               # (4,3) foot vel in hip frame
    contact_phase,       # (4,)
):
    """One KF step. Returns (xhat, P, position, v_world, v_body)."""
    A, B, C, q0_diag, r0_diag = (jnp.asarray(m) for m in _static_mats(cfg))

    g = jnp.array([0.0, 0.0, -cfg.gravity], dtype=xhat.dtype)
    rbod = r_body.T
    a = a_world + g

    p0, v0 = xhat[0:3], xhat[3:6]

    p_rel = hip_locations + leg_p                       # (4,3) body frame
    dp_rel = leg_v
    p_f = jnp.einsum("ij,fj->fi", rbod, p_rel)          # world frame
    dp_f = jnp.einsum(
        "ij,fj->fi", rbod, jnp.cross(jnp.broadcast_to(omega_body, (4, 3)), p_rel) + dp_rel
    )

    phase = jnp.minimum(contact_phase, 1.0)
    tw = cfg.trust_window
    trust = jnp.where(
        phase < tw, phase / tw, jnp.where(phase > 1.0 - tw, (1.0 - phase) / tw, 1.0)
    )
    suspect = 1.0 + (1.0 - trust) * cfg.high_suspect_number  # (4,)

    # noise assembly (run(), lines 74-169)
    q_diag = q0_diag
    q_diag = q_diag.at[6:18].set(
        (q0_diag[6:18].reshape(4, 3) * suspect[:, None]).reshape(12)
    )
    r_diag = r0_diag
    r_diag = r_diag.at[12:24].set(
        (r0_diag[12:24].reshape(4, 3) * suspect[:, None]).reshape(12)
    )
    r_diag = r_diag.at[24:28].set(r0_diag[24:28] * suspect)

    ps = (-p_f).reshape(12)
    vs = ((1.0 - trust)[:, None] * v0[None, :] + trust[:, None] * (-dp_f)).reshape(12)
    pzs = (1.0 - trust) * (p0[2] + p_f[:, 2])
    y = jnp.concatenate([ps, vs, pzs])

    # predict
    xhat = A @ xhat + B @ a
    pm = A @ p_cov @ A.T + jnp.diag(q_diag)

    # update (reference uses two LU solves, lines 171-186; here a scaled
    # Newton-Schulz inverse of the Jacobi-prescaled SPD innovation
    # covariance — matmuls instead of a data-dependent factorization)
    ey = y - C @ xhat
    s = C @ pm @ C.T + jnp.diag(r_diag)
    d = lax.rsqrt(jnp.maximum(jnp.diagonal(s), 1e-30))
    ss = s * d[:, None] * d[None, :]
    eye28 = jnp.eye(28, dtype=s.dtype)
    x = (1.0 / jnp.max(jnp.sum(jnp.abs(ss), axis=-1))) * eye28
    for mu in mu_schedule(1e-8, 14):     # interval phase: handles cond 1e8
        x = mu * (x @ (2.0 * eye28 - mu * (ss @ x)))
    for _ in range(4):                   # quadratic phase to the f32 floor
        x = x @ (2.0 * eye28 - ss @ x)
    inv_s = x * d[:, None] * d[None, :]

    def s_solve(b):
        sol = inv_s @ b
        for _ in range(2):               # refinement: error ~r^3
            sol = sol + inv_s @ (b - s @ sol)
        return sol

    s_ey = s_solve(ey)
    pct = pm @ C.T
    xhat = xhat + pct @ s_ey
    s_c = s_solve(C)
    p_cov = (jnp.eye(18, dtype=xhat.dtype) - pct @ s_c) @ pm
    p_cov = 0.5 * (p_cov + p_cov.T)

    # xy-covariance conditioning hack (lines 191-195)
    det2 = p_cov[0, 0] * p_cov[1, 1] - p_cov[0, 1] * p_cov[1, 0]
    cond = det2 > 1e-6
    mask_row = jnp.ones((18, 18), dtype=bool).at[0:2, 2:18].set(False).at[2:18, 0:2].set(False)
    p_fixed = jnp.where(mask_row, p_cov, 0.0)
    p_fixed = p_fixed.at[0:2, 0:2].set(p_fixed[0:2, 0:2] / 10.0)
    p_cov = jnp.where(cond, p_fixed, p_cov)

    position = xhat[0:3]
    v_world = xhat[3:6]
    v_body = r_body @ v_world
    return xhat, p_cov, position, v_world, v_body


def _meas_rows():
    """The 28 measurement rows of C as (j1, j2) index pairs: each row is
    e_j1 - e_j2 (j2 = None for single-entry rows). Mirrors _static_mats."""
    rows = []
    for f in range(4):                      # p - p_foot (world-relative)
        for ax in range(3):
            rows.append((ax, 6 + 3 * f + ax))
    for f in range(4):                      # body velocity
        for ax in range(3):
            rows.append((3 + ax, None))
    for f in range(4):                      # foot height
        rows.append((6 + 3 * f + 2, None))
    return rows


def run_batched(
    cfg: EstimatorConfig,
    xhat,                # (B,18)
    p_cov,               # (B,18,18)
    a_world,             # (B,3)
    r_body,              # (B,3,3)
    omega_body,          # (B,3)
    hip_locations,       # (4,3) static
    leg_p,               # (B,4,3)
    leg_v,               # (B,4,3)
    contact_phase,       # (B,4)
):
    """Batch-explicit KF step, identical estimate to `run` per scenario.

    Redesign of the hot closed-loop path: per scenario, the (18,18) /
    (28,28) covariance matmul chains have tiny minor dims, and the 28x28
    innovation inverse costs 36 batched matmuls per tick. Two structural
    changes, both exact:

    * the covariance lives BATCH-LAST, (18,18,B): the batch is the minor
      (contiguous) dimension, so every covariance op is a full-width
      elementwise vector op;
    * the joint 28-measurement update is processed as 28 SEQUENTIAL scalar
      updates — textbook-exact for the diagonal R this filter has (the
      reference's R0 + trust scaling is diagonal,
      PositionVelocityEstimator.cpp:45-57) — so the 28x28 innovation solve
      (two LU solves in the reference, a Newton-Schulz inverse in `run`)
      disappears entirely: each row's gain is a slice difference of P
      columns over a scalar innovation variance.

    Per-scenario `run` remains the differential reference; parity is tested
    in tests/test_estimation.py.
    """
    dt = cfg.dt
    dtype = xhat.dtype
    _, _, _, q0_diag, r0_diag = _static_mats(cfg)
    q0_diag = jnp.asarray(q0_diag)
    r0_diag = jnp.asarray(r0_diag)

    g = jnp.array([0.0, 0.0, -cfg.gravity], dtype=dtype)
    rbod = jnp.swapaxes(r_body, -1, -2)
    a = a_world + g

    p0, v0 = xhat[:, 0:3], xhat[:, 3:6]
    p_rel = hip_locations[None] + leg_p                  # (B,4,3) body frame
    p_f = jnp.einsum("bij,bfj->bfi", rbod, p_rel)        # world frame
    dp_f = jnp.einsum(
        "bij,bfj->bfi", rbod,
        jnp.cross(jnp.broadcast_to(omega_body[:, None, :], p_rel.shape),
                  p_rel) + leg_v,
    )

    phase = jnp.minimum(contact_phase, 1.0)
    tw = cfg.trust_window
    trust = jnp.where(
        phase < tw, phase / tw,
        jnp.where(phase > 1.0 - tw, (1.0 - phase) / tw, 1.0),
    )
    suspect = 1.0 + (1.0 - trust) * cfg.high_suspect_number  # (B,4)

    q_diag = jnp.concatenate([
        jnp.broadcast_to(q0_diag[0:6], (xhat.shape[0], 6)),
        (q0_diag[6:18].reshape(4, 3)[None] * suspect[:, :, None]
         ).reshape(-1, 12),
    ], axis=1)                                            # (B,18)
    r_diag = jnp.concatenate([
        jnp.broadcast_to(r0_diag[0:12], (xhat.shape[0], 12)),
        (r0_diag[12:24].reshape(4, 3)[None] * suspect[:, :, None]
         ).reshape(-1, 12),
        r0_diag[None, 24:28] * suspect,
    ], axis=1)                                            # (B,28)

    ps = (-p_f).reshape(-1, 12)
    vs = ((1.0 - trust)[:, :, None] * v0[:, None, :]
          + trust[:, :, None] * (-dp_f)).reshape(-1, 12)
    pzs = (1.0 - trust) * (p0[:, 2:3] + p_f[:, :, 2])
    y = jnp.concatenate([ps, vs, pzs], axis=1)            # (B,28)

    # predict: A = I + dt E (E: p<-v), B a = dt a on v — slice algebra
    x = jnp.concatenate([p0 + dt * v0, v0 + dt * a, xhat[:, 6:18]],
                        axis=1).T                         # (18,B)
    pm = jnp.transpose(p_cov, (1, 2, 0))                  # (18,18,B)
    pm = jnp.concatenate([pm[0:3] + dt * pm[3:6], pm[3:18]], axis=0)
    pm = jnp.concatenate([pm[:, 0:3] + dt * pm[:, 3:6], pm[:, 3:18]],
                         axis=1)
    eye18 = jnp.eye(18, dtype=dtype)
    pm = pm + eye18[:, :, None] * q_diag.T[:, None, :]

    # sequential scalar updates (exact: R is diagonal), in JOSEPH form:
    # P <- (I - k c')P(I - k c') + r k k', evaluated as two rank-1 passes.
    # The plain P - k(Pc)' update is algebraically identical but f32-fragile
    # during the initial_p=100 transient (prior/measurement variance ratio
    # ~1e5: the surviving 1e-3 variance is the cancellation residue of two
    # ~1e2 terms); the Joseph form keeps the filter symmetric-PSD through
    # the same transient at the cost of a second pass over P per row.
    y_t = y.T                                             # (28,B)
    r_t = r_diag.T

    def p_col(p, j1, j2):
        if j2 is None:
            return p[:, j1, :]                            # (18,B) = P c
        return p[:, j1, :] - p[:, j2, :]

    for i, (j1, j2) in enumerate(_meas_rows()):
        pmc = p_col(pm, j1, j2)
        cx = x[j1] - (x[j2] if j2 is not None else 0.0)
        s = (pmc[j1] - (pmc[j2] if j2 is not None else 0.0)) + r_t[i]
        gain = pmc / s[None, :]
        x = x + gain * (y_t[i] - cx)[None, :]
        pm = pm - gain[:, None, :] * pmc[None, :, :]      # (I - kc')P
        p1c = p_col(pm, j1, j2)                           # ((I-kc')P) c
        pm = (pm - p1c[:, None, :] * gain[None, :, :]
              + (r_t[i][None, :] * gain)[:, None, :] * gain[None, :, :])

    pm = 0.5 * (pm + jnp.transpose(pm, (1, 0, 2)))

    # xy-covariance conditioning hack (reference lines 191-195)
    det2 = pm[0, 0] * pm[1, 1] - pm[0, 1] * pm[1, 0]      # (B,)
    cond = det2 > 1e-6
    mask = jnp.ones((18, 18), dtype=bool)
    mask = mask.at[0:2, 2:18].set(False).at[2:18, 0:2].set(False)
    p_fixed = jnp.where(mask[:, :, None], pm, 0.0)
    scale2 = jnp.ones((18, 18), dtype)
    scale2 = scale2.at[0:2, 0:2].set(0.1)
    p_fixed = p_fixed * scale2[:, :, None]
    pm = jnp.where(cond[None, None, :], p_fixed, pm)

    xhat_out = x.T
    p_cov_out = jnp.transpose(pm, (2, 0, 1))
    position = xhat_out[:, 0:3]
    v_world = xhat_out[:, 3:6]
    v_body = jnp.einsum("bij,bj->bi", r_body, v_world)
    return xhat_out, p_cov_out, position, v_world, v_body
