"""The batched KKT factorization (`admm._batched_solver`: Jacobi prescale +
`ns_iters` HIGHEST Newton-Schulz iterations + iterative refinement) against
numpy float64, at the system sizes the pipeline builds (60: one h=10 trot
scenario, 120: a pair-packed h=10 pair, 144: the h=16 walking band, 192:
h=16 uncompressed / fast-trot pair) and at the two conditioning regimes
the solver sees: ADMM-phase K (Jacobi-scaled cond <= 213) and polish K
(w_act = 1e4 penalties, cond ~1e5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.solver import admm

CFG = default_config().solver
SIZES = (60, 120, 144, 192)
CONDS = (213.0, 1e5)
# f32 floors: the NS residual and the solve error grow like cond * eps32.
# Measured worst over these sizes (CPU, f32): inverse residual 6.6e-5 /
# 1.8e-2 and refined-solve relative error 1.3e-6 / 3.7e-4 at cond 213 / 1e5.
RESID_GATE = {213.0: 1e-3, 1e5: 5e-2}
SOLVE_GATE = {213.0: 1e-5, 1e5: 2e-3}


def _spd(seed, b, n, cond):
    """SPD matrices with the given Jacobi-scaled condition number and a
    badly scaled diagonal (1e-3..1e2) that the prescale must undo."""
    rng = np.random.default_rng(seed)
    ks = []
    for _ in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.logspace(0.0, -np.log10(cond), n)
        k = (q * ev[None, :]) @ q.T
        s = rng.uniform(1e-3, 1e2, n)
        ks.append(k * s[:, None] * s[None, :])
    return np.stack(ks)


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("n", SIZES)
def test_batched_solver_inverse_residual(n, cond):
    k = _spd(n, 3, n, cond)
    solve = admm._batched_solver(jnp.asarray(k, jnp.float32), CFG)
    ks = np.asarray(solve.ks, np.float64)
    inv = np.asarray(solve.inv, np.float64)
    assert np.isfinite(inv).all()
    resid = np.abs(np.eye(n) - ks @ inv).sum(-1).max()
    assert resid < RESID_GATE[cond], resid
    # the prescale really is Jacobi: unit diagonal
    np.testing.assert_allclose(np.diagonal(ks, axis1=1, axis2=2), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("n", SIZES)
def test_batched_solver_refined_solve(n, cond):
    k = _spd(n + 1, 3, n, cond)
    b = np.random.default_rng(n).standard_normal((3, n))
    solve = admm._batched_solver(jnp.asarray(k, jnp.float32), CFG)
    x = np.asarray(solve(jnp.asarray(b, jnp.float32)), np.float64)
    want = np.linalg.solve(k, b[..., None])[..., 0]
    rel = np.abs(x - want).max() / np.abs(want).max()
    assert rel < SOLVE_GATE[cond], rel
    # the bf16 matvec of the bulk ADMM iterations is a coarse solve of the
    # same system: bf16 rounding (~4e-3), far from the f32 path's floor
    if cond == 213.0:
        x16 = np.asarray(solve(jnp.asarray(b, jnp.float32), lowp=True),
                         np.float64)
        rel16 = np.abs(x16 - want).max() / np.abs(want).max()
        assert rel16 < 5e-2, rel16


def _scaled(k):
    d = 1.0 / np.sqrt(np.diagonal(k))
    return k * d[:, None] * d[None, :]


def test_ns_inverse_warm_start_converges_fast():
    """A nearby inverse seeds the NS iteration: 3 warm iterations reach a
    residual that 3 cold ones cannot."""
    ks = _scaled(_spd(5, 1, 120, 1e3)[0])
    exact = np.linalg.inv(ks)
    rng = np.random.default_rng(2)
    e = rng.standard_normal(ks.shape)
    e *= 0.05 / np.linalg.norm(e, 2)
    init = exact @ (np.eye(120) + e)          # NS residual ~0.05
    warm = np.asarray(admm._ns_inverse(jnp.asarray(ks, jnp.float32), 3,
                                       init=jnp.asarray(init, jnp.float32)),
                      np.float64)
    cold = np.asarray(admm._ns_inverse(jnp.asarray(ks, jnp.float32), 3),
                      np.float64)
    r_warm = np.abs(np.eye(120) - ks @ warm).sum(-1).max()
    r_cold = np.abs(np.eye(120) - ks @ cold).sum(-1).max()
    assert r_warm < 1e-3 < r_cold, (r_warm, r_cold)


def test_ns_inverse_warm_start_guard_falls_back_to_cold():
    """An init outside the convergence region (||I - K init|| >= 0.9) is
    ignored: the result is exactly the cold start's."""
    ks = jnp.asarray(_scaled(_spd(6, 1, 60, 213.0)[0]), jnp.float32)
    garbage = jnp.full(ks.shape, 17.0, jnp.float32)
    guarded = np.asarray(admm._ns_inverse(ks, CFG.ns_iters, init=garbage))
    cold = np.asarray(admm._ns_inverse(ks, CFG.ns_iters))
    np.testing.assert_array_equal(guarded, cold)
    resid = np.abs(np.eye(60) - np.asarray(ks, np.float64) @ cold).max()
    assert resid < 1e-4, resid
