"""Batched ADMM QP solver (OSQP/JCQP-style operator splitting) with
active-set polish.

Solves  min 0.5 x'Hx + g'x  s.t.  l <= Ax <= u.

The splitting, relaxation, and per-constraint-type rho selection follow the
JCQP spec (reference src/JCQP/QpProblem.cpp:276-368, QpProblem.h:15-27):
equality rows (|u-l|<tol) get rho*rho_equality_scale, effectively-unbounded
rows get rho_infty, others rho. The KKT system is solved via the Schur
complement normal equations K = H + sigma*I + A' diag(rho) A with one
factorization per problem, reused across iterations: a Newton-Schulz
inverse (`_ns_inverse`), so every solve is a batched matvec with static
shapes. All factorizations are Jacobi-prescaled (D K D with
D = diag(K)^-1/2) so the badly-scaled MPC Hessian (diag ~1e-4) plus large
penalty terms stay within the f32 conditioning budget.

After the fixed ADMM iterations, an OSQP-style *polish* enforces the
identified active set with a large penalty and re-solves, refining by
dropping wrong-sign multipliers and adding violated rows — a fixed number of
rounds, each one prescaled factorization, keeping shapes static. This recovers
near-exact solutions (~1e-3 N force error vs a float64 interior-point
oracle) from a modest iteration count.

Three interfaces:
* `admm_dense` — generic dense-A solver (the JCQP-equivalent component and
  differential-test subject);
* `admm_mpc`  — MPC-specialized: A is the friction pyramid, applied
  structurally (never materialized), K assembled from 3x3 Gram blocks;
* `admm_mpc_batched` — the same with an explicit batch axis (the batched
  pipeline and the closed-loop engines).

A fixed iteration count keeps batches divergence-free; `kkt_residuals`
gives an optimality certificate for tests/telemetry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from quadruped_ctrl_tpu.config import MPCConfig, SolverConfig
from quadruped_ctrl_tpu.mpc import formation

_HI = lax.Precision.HIGHEST


def constraint_rho(cfg: SolverConfig, l, u):
    """Per-row penalty: equality / infinite / inequality (QpProblem.cpp:276-291).

    A row is "infinite" (negligible rho) only when BOTH sides are unbounded —
    a one-sided row like a friction-pyramid row (l=0, u=BIG) can bind at its
    finite side and needs the regular penalty, else the dual for a binding
    cone builds up at 1e-6 per iteration and ADMM stalls ~infeasible."""
    infinite = (l < -cfg.infty) & (u > cfg.infty)
    equality = jnp.abs(u - l) < cfg.eql_tol
    return jnp.where(
        infinite,
        cfg.rho_infty,
        jnp.where(equality, cfg.rho * cfg.rho_equality_scale, cfg.rho),
    )


def _ns_inverse(ks, iters: int, init=None):
    """Newton-Schulz inverse of an SPD, Jacobi-scaled matrix.

    X_{k+1} = X_k (2I - K X_k): quadratic convergence, pure batched
    matmuls (HIGHEST, i.e. true f32) in place of a Cholesky factorization
    and triangular solves. ~20 iterations reach the f32 floor at condition
    1e4; a warm start (init = inverse of a nearby matrix) needs far fewer.
    """
    n = ks.shape[-1]
    eye = jnp.eye(n, dtype=ks.dtype)
    alpha = 1.0 / jnp.max(jnp.sum(jnp.abs(ks), axis=-1))
    cold = alpha * eye + 0.0 * ks
    if init is None:
        x = cold
    else:
        # guard: NS diverges if ||I - K init|| >= 1; fall back to cold start
        resid = jnp.max(
            jnp.sum(jnp.abs(eye - jnp.matmul(ks, init, precision=_HI)), axis=-1)
        )
        x = jnp.where(resid < 0.9, init, cold)

    def body(x, _):
        kx = jnp.matmul(ks, x, precision=_HI)
        x = jnp.matmul(x, 2.0 * eye - kx, precision=_HI)
        return x, None

    x, _ = lax.scan(body, x, None, length=iters)
    return x


def _make_solver(k, ns_iters: int = 25, prev_inv=None, prev_scale=None):
    """Jacobi-prescaled Newton-Schulz solver for SPD k.

    Returns solve(b)->x where solve is a single batched matvec against the
    precomputed inverse. `solve.scaled_inv` / `solve.scale` expose the
    factorization; passing them back as (prev_inv, prev_scale) warm-starts
    the NS iteration for a nearby system (rescaled across the two Jacobi
    scalings, with a divergence guard falling back to a cold start).
    """
    d = lax.rsqrt(jnp.maximum(jnp.diagonal(k), 1e-30))
    ks = k * d[:, None] * d[None, :]
    init = None
    if prev_inv is not None:
        r = prev_scale / d
        init = r[:, None] * prev_inv * r[None, :]
    inv = _ns_inverse(ks, ns_iters, init=init)

    def solve(b, refine: int = 2):
        """Solve with iterative refinement: the NS inverse is only accurate
        to ~eps*cond, but two residual-correction passes square away the
        error at the cost of two extra matvecs."""
        bs = d * b
        x = jnp.matmul(inv, bs, precision=_HI)
        for _ in range(refine):
            r = bs - jnp.matmul(ks, x, precision=_HI)
            x = x + jnp.matmul(inv, r, precision=_HI)
        return d * x

    solve.scaled_inv = inv
    solve.scale = d
    return solve


def _iterate(cfg: SolverConfig, solve, apply_a, apply_at, g, l, u, rho, n_iter,
             init=None):
    """Shared ADMM loop. apply_a: x->Ax, apply_at: y->A'y (flat vectors)."""
    alpha = cfg.over_relax_alpha
    sigma = cfg.sigma
    inv_rho = 1.0 / rho

    if init is None:
        # 0*g / 0*rho keep the shard_map varying-axes tags of the problem data
        x0 = 0.0 * g
        z0 = (0.0 * rho).astype(g.dtype)
        init = (x0, z0, z0)

    def body(carry, _):
        x, z, y = carry
        rhs = sigma * x - g + apply_at(rho * z - y)
        x_t = solve(rhs)
        z_t = apply_a(x_t)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_relax = alpha * z_t + (1.0 - alpha) * z
        z_new = jnp.clip(z_relax + inv_rho * y, l, u)
        y_new = y + rho * (z_relax - z_new)
        return (x_new, z_new, y_new), None

    (x, z, y), _ = lax.scan(body, init, None, length=n_iter)
    return x, z, y


def _adapt_rho_factor(cfg: SolverConfig, ax, z, hx, grad_n, aty):
    """OSQP adaptive-rho rule: sqrt of the scaled primal/dual residual
    ratio, clipped. Works batched ((B,m)/(B,n)) or flat ((m,)/(n,))."""
    eps = jnp.asarray(1e-12, ax.dtype)
    r_pri = jnp.max(jnp.abs(ax - z), axis=-1)
    s_pri = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(ax), axis=-1),
                    jnp.max(jnp.abs(z), axis=-1)), eps)
    r_du = jnp.max(jnp.abs(hx + grad_n + aty), axis=-1)
    s_du = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(hx), axis=-1),
                    jnp.max(jnp.abs(aty), axis=-1)),
        jnp.maximum(jnp.max(jnp.abs(grad_n), axis=-1), eps))
    ratio = (r_pri / s_pri) / jnp.maximum(r_du / s_du, eps)
    return jnp.clip(jnp.sqrt(ratio), cfg.rho_adapt_clip_lo,
                    cfg.rho_adapt_clip_hi)


def _polish(cfg: SolverConfig, build_solver, apply_a, apply_at, grad, l, u,
            finite_u, x, z, y, rounds: int, w_act: float = 1e4,
            act_tol: float = 1e-4, warm=None):
    """Active-set polish (OSQP 'polish' made static-shape).

    Enforces the ADMM-identified active constraints with a large penalty and
    re-solves; refines by dropping wrong-sign multipliers and adding violated
    rows, keeping the least-infeasible iterate across the fixed number of
    rounds. build_solver(w) returns a solve() for H + sigma I + A'diag(w)A.
    Assumes the problem is normalized to O(1) data (see admm_mpc's force
    normalization) so w_act stays within f32 Cholesky conditioning.
    """
    lo_act = (z - l) < act_tol
    hi_act = finite_u & ((u - z) < act_tol)

    def viol(v):
        av = apply_a(v)
        return jnp.max(jnp.maximum(l - av, jnp.where(finite_u, av - u, -1.0)))

    def one_round(best_x, best_v, lo, hi, y_al, prev_inv, prev_scale):
        act = lo | hi
        bound = jnp.where(lo, l, jnp.where(hi & finite_u, u, 0.0))
        w = jnp.where(act, w_act, 0.0)
        solve = build_solver(w, prev_inv=prev_inv, prev_scale=prev_scale)
        # augmented-Lagrangian dual correction: a pure penalty solve misses
        # the bound by |dual|/w (up to ~10% when duals are O(1e3) at the
        # f_max cap); carrying multiplier estimates makes the active
        # constraints exact as rounds progress
        y_act = jnp.where(act, y_al, 0.0)
        x_p = solve(-grad + apply_at(w * bound - y_act))
        ax = apply_a(x_p)
        y_new = y_act + w * (ax - bound)
        v_p = jnp.where(jnp.all(jnp.isfinite(x_p)), viol(x_p), jnp.inf)
        take = v_p < best_v
        best_x = jnp.where(take, x_p, best_x)
        best_v = jnp.where(take, v_p, best_v)
        lo = (lo & (y_new <= 1e-9)) | (ax < l - 1e-6)
        hi = (hi & (y_new >= -1e-9)) | (finite_u & (ax > u + 1e-6))
        y_al = jnp.where(lo | hi, y_new, 0.0)
        return best_x, best_v, lo, hi, y_al, solve.scaled_inv, solve.scale

    # round 0: cold factorization (full NS budget), duals seeded from ADMM;
    # later rounds warm-start the factorization and refine the duals
    y_seed = jnp.where(lo_act | hi_act, y, 0.0)
    carry = one_round(x, jnp.maximum(viol(x), 0.0), lo_act, hi_act, y_seed,
                      None, None)

    def round_body(carry, _):
        return one_round(*carry), None

    (x_p, _, _, _, _, _, _), _ = lax.scan(round_body, carry, None,
                                          length=max(rounds - 1, 0))
    return x_p


def kkt_residuals(hess, grad, a_mat, l, u, x, y):
    """(primal, dual) infinity-norm residuals (QpProblem.cpp residual check)."""
    ax = a_mat @ x
    primal = jnp.max(jnp.maximum(ax - u, 0.0) + jnp.maximum(l - ax, 0.0))
    dual = jnp.max(jnp.abs(hess @ x + grad + a_mat.T @ y))
    return primal, dual


def admm_dense(
    cfg: SolverConfig, hess, grad, a_mat, l, u, iterations: int | None = None,
    polish_rounds: int = 0,
):
    """Generic dense-constraint ADMM solve. Returns (x, z, y)."""
    n_iter = cfg.iterations if iterations is None else iterations
    rho = constraint_rho(cfg, l, u)
    eye = jnp.eye(hess.shape[0], dtype=hess.dtype)

    def build_solver(w, prev_inv=None, prev_scale=None):
        k = hess + cfg.sigma * eye
        k = k + jnp.matmul(a_mat.T * w[None, :], a_mat, precision=_HI)
        return _make_solver(k, cfg.ns_iters, prev_inv, prev_scale)

    apply_a = lambda v: a_mat @ v
    apply_at = lambda w: a_mat.T @ w
    x, z, y = _iterate(
        cfg, build_solver(rho), apply_a, apply_at, grad, l, u, rho, n_iter
    )
    if polish_rounds > 0:
        finite_u = u < cfg.infty
        x = _polish(cfg, build_solver, apply_a, apply_at, grad, l, u, finite_u,
                    x, z, y, polish_rounds)
    return x, z, y


def admm_mpc(
    cfg: SolverConfig,
    cfg_mpc: MPCConfig,
    hess,            # (12h,12h)
    grad,            # (12h,)
    gait_table,      # (h,4) contact flags in {0,1}
    iterations: int | None = None,
    polish_rounds: int | None = None,
    warm=None,
    return_warm: bool = False,
):
    """MPC-specialized solve with the structural friction pyramid.

    Swing feet (gait=0) have fz bounds [0,0]: an equality row whose
    rho*rho_equality_scale penalty pins fz (and via the pyramid rows fx, fy)
    to zero — the bound-masking equivalent of the reference's swing-variable
    elimination (SolverMPC.cpp:441-525). Accepts an optionally
    stance-compressed gait table (h, nf<=4) paired with a matching
    compressed Hessian (see formation.compress_stance / qp_cost_compressed).
    Returns forces x (3*nf*h,).

    `warm` is an optional (x_hat, z_hat, y_hat) triple in the solver's
    force-NORMALIZED units (what a previous call returned via
    `return_warm=True` — the role of qpOASES's MPC hot-start options,
    SolverMPC.cpp:530-532); zeros are exactly the cold start. With
    `return_warm`, returns (forces, (x_hat, z_hat, y_hat)) where the triple
    is the pre-polish ADMM fixed-point iterate.
    """
    n_iter = cfg.iterations if iterations is None else iterations
    polish_rounds = cfg.polish_rounds if polish_rounds is None else polish_rounds
    h, nf = gait_table.shape
    n = 3 * nf * h
    dtype = hess.dtype

    # Normalize forces by f_max: x = F*x_hat. The natural SI problem has a
    # tiny Hessian (diag ~1e-4) against O(100 N) forces — hopeless for f32
    # ADMM/Cholesky. In normalized units everything is O(1).
    f_scale = jnp.asarray(cfg_mpc.f_max, dtype)
    hess_n = hess * (f_scale * f_scale)
    grad_n = grad * f_scale

    l3, u3 = formation.pyramid_bounds(cfg_mpc, gait_table.astype(dtype))
    l = l3.reshape(-1) / f_scale
    u_raw = u3.reshape(-1)
    u = jnp.where(u_raw > cfg.infty, u_raw, u_raw / f_scale)
    rho = constraint_rho(cfg, l, u)

    eye = jnp.eye(n, dtype=dtype)
    idx = jnp.arange(h * nf)

    def build_solver(w, prev_inv=None, prev_scale=None):
        gram = formation.pyramid_gram(cfg_mpc, w.reshape(h, nf, 5))  # (h,nf,3,3)
        k = hess_n + cfg.sigma * eye
        k4 = k.reshape(h * nf, 3, h * nf, 3)
        k4 = k4.at[idx, :, idx, :].add(gram.reshape(h * nf, 3, 3))
        return _make_solver(k4.reshape(n, n), cfg.ns_iters, prev_inv,
                            prev_scale)

    def apply_a(v):
        return formation.pyramid_apply(cfg_mpc, v.reshape(h, nf, 3)).reshape(-1)

    def apply_at(w):
        return formation.pyramid_apply_t(cfg_mpc, w.reshape(h, nf, 5)).reshape(-1)

    adapt = max(int(cfg.rho_adapt), 0)
    segs = adapt + 1
    seg_n = n_iter // segs
    rho_c = rho
    solver_c = build_solver(rho)
    carry = warm
    for s_i in range(segs):
        last = s_i == segs - 1
        n_seg = n_iter - seg_n * (segs - 1) if last else seg_n
        x, z, y = _iterate(cfg, solver_c, apply_a, apply_at, grad_n, l, u,
                           rho_c, n_seg, init=carry)
        carry = (x, z, y)
        if not last:
            fac = _adapt_rho_factor(
                cfg, apply_a(x), z,
                jnp.matmul(hess_n, x, precision=_HI), grad_n, apply_at(y))
            rho_c = rho * fac
            solver_c = build_solver(rho_c, prev_inv=solver_c.scaled_inv,
                                    prev_scale=solver_c.scale)
    if polish_rounds > 0:
        finite_u = u < cfg.infty
        x = _polish(cfg, build_solver, apply_a, apply_at, grad_n, l, u,
                    finite_u, x, z, y, polish_rounds)
    if return_warm:
        return x * f_scale, carry
    return x * f_scale


# ---------------------------------------------------------------------------
# Explicitly-batched MPC solve (the bench/production hot path).
#
# The per-scenario admm_mpc under vmap lets XLA batch everything, but the
# solver code then cannot tell the batch axis from the problem axes. This
# variant carries the batch axis explicitly, so the data-dependent
# reductions (adaptive rho, polish best-iterate) can be taken per packed
# scenario and the factorizations are plain batched matmuls.

def _batched_solver(k, cfg: SolverConfig):
    """k: (B,n,n) SPD -> solve(b_vec (B,n)) -> (B,n): Jacobi-prescaled
    Newton-Schulz inverse (cfg.ns_iters HIGHEST iterations), with
    iterative refinement at the solve."""
    d = lax.rsqrt(jnp.maximum(jnp.diagonal(k, axis1=-2, axis2=-1), 1e-30))
    ks = k * d[:, :, None] * d[:, None, :]
    inv = jax.vmap(lambda m: _ns_inverse(m, cfg.ns_iters))(ks)
    inv16 = inv.astype(jnp.bfloat16)

    def solve(b_vec, refine: int = 2, lowp: bool = False):
        bs = d * b_vec
        if lowp:
            # bf16 inverse matvec: half the memory stream; only used for the
            # bulk ADMM iterations, never where the result is read out
            x = jnp.einsum("bij,bj->bi", inv16, bs.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
            return d * x
        x = jnp.einsum("bij,bj->bi", inv, bs, precision=_HI)
        for _ in range(refine):
            r = bs - jnp.einsum("bij,bj->bi", ks, x, precision=_HI)
            x = x + jnp.einsum("bij,bj->bi", inv, r, precision=_HI)
        return d * x

    solve.scale = d                   # (B,n)
    solve.inv = inv                   # (B,n,n) Jacobi-scaled inverse
    solve.ks = ks                     # (B,n,n) Jacobi-scaled K
    return solve


def _gj_inverse(c, pivot: bool = True):
    """Batched (B,r,r) general-matrix inverse via Gauss-Jordan: r
    fully-batched elimination steps over the (B,r,2r) augmented system. Used
    for the small Woodbury capacitance matrices: every step is a batched
    elementwise rank-1 update, with no per-matrix control flow.

    With `pivot`, partial pivoting runs as a select + one-hot reduce (no
    gather; the reduce is pinned to HIGHEST so it copies the pivot row
    exactly even where an f32 dot would default to a reduced-precision
    mode). The Woodbury caller orders constraint ADDITIONS (+1
    capacitance diagonal, diagonally dominant-ish) ahead of removals and
    passes pivot=False — halving the per-step op count; its downstream
    solves carry refinement against the true K, and the polish best-iterate
    selection guards any residual misstep."""
    b, r = c.shape[0], c.shape[-1]
    eye = jnp.eye(r, dtype=c.dtype)
    aug = jnp.concatenate([c, jnp.broadcast_to(eye, c.shape)], axis=-1)
    rows = jnp.arange(r)
    for k in range(r):
        if pivot:
            col = jnp.where(rows[None, :] >= k, jnp.abs(aug[:, :, k]), -1.0)
            p = jnp.argmax(col, axis=1)                          # (B,)
            is_p = rows[None, :] == p[:, None]                   # (B,r)
            rowp = jnp.einsum('br,brc->bc', is_p.astype(c.dtype), aug,
                              precision=_HI)
            rowk = aug[:, k, :]
            aug = jnp.where(is_p[:, :, None], rowk[:, None, :], aug)
            aug = aug.at[:, k, :].set(rowp)
        pivrow = aug[:, k, :] / aug[:, k, k][:, None]
        fac = aug[:, :, k]
        aug = aug - fac[:, :, None] * pivrow[:, None, :]
        aug = aug.at[:, k, :].set(pivrow)
    return aug[:, :, r:]


def _pyramid_dense(mu: float, h: int, nf: int):
    """Dense (5*h*nf, 3*h*nf) friction-pyramid matrix (SolverMPC.cpp:352-364),
    as a numpy constant (shapes are static under jit)."""
    import numpy as np

    mu_inv = 1.0 / mu
    block = np.array(
        [[mu_inv, 0, 1], [-mu_inv, 0, 1], [0, mu_inv, 1], [0, -mu_inv, 1],
         [0, 0, 1]], dtype=np.float32
    )
    n_blk = h * nf
    a = np.zeros((5 * n_blk, 3 * n_blk), dtype=np.float32)
    for i in range(n_blk):
        a[5 * i : 5 * i + 5, 3 * i : 3 * i + 3] = block
    return a


def admm_mpc_batched(
    cfg: SolverConfig,
    cfg_mpc: MPCConfig,
    hess,            # (B, n, n) with n = 3*nf*h
    grad,            # (B, n)
    gait_table,      # (B, h, nf)
    iterations: int | None = None,
    polish_rounds: int | None = None,
    warm=None,
    return_warm: bool = False,
    pack: int = 1,
):
    """Batch-axis-explicit admm_mpc. Returns forces (B, n).

    `warm`/`return_warm` as in `admm_mpc`, batched: an (x_hat (B,n),
    z_hat (B,m), y_hat (B,m)) triple in force-normalized units; zeros are
    exactly the cold start. The returned triple is the pre-polish ADMM
    iterate, for temporal warm starting across MPC ticks.

    `pack` declares that each system is `pack` independent scenarios stacked
    block-diagonally (scenario-major steps/variables — pipeline.
    solve_packed_batch's layout). The KKT factorization and iterate phases
    are pack-agnostic (block-diagonal inverses don't mix), but the two
    DATA-DEPENDENT reductions are taken PER SCENARIO when pack > 1: the
    adaptive-rho residual ratio and the polish best-iterate selection.
    Without this, a hard scenario packed with an easy one would set its
    partner's rho and polish choice."""
    n_iter = cfg.iterations if iterations is None else iterations
    polish_rounds = cfg.polish_rounds if polish_rounds is None else polish_rounds
    bsz, h, nf = gait_table.shape
    n = 3 * nf * h
    dtype = hess.dtype

    f_scale = jnp.asarray(cfg_mpc.f_max, dtype)
    hess_n = hess * (f_scale * f_scale)
    grad_n = grad * f_scale

    big = jnp.asarray(cfg_mpc.big_number, dtype)
    u3 = jnp.broadcast_to(big, (bsz, h, nf, 5)).copy()
    u3 = u3.at[..., 4].set(gait_table * (cfg_mpc.f_max / f_scale))
    l = jnp.zeros((bsz, h * nf * 5), dtype)
    u = u3.reshape(bsz, -1)
    rho = constraint_rho(cfg, l, u)

    eye = jnp.eye(n, dtype=dtype)
    sel = jnp.eye(h * nf, dtype=dtype)
    m_full = h * nf * 5

    def per_scn(v):
        """(B, pack*d) -> (B*pack, d): per-scenario view of packed rows."""
        return v.reshape(bsz * pack, v.shape[-1] // pack)

    def scn_fac_rows(fac, d):
        """(B*pack,) scenario factors -> (B, pack*d) row-aligned."""
        return jnp.broadcast_to(
            fac.reshape(bsz, pack, 1), (bsz, pack, d)
        ).reshape(bsz, pack * d)

    def build_solver(w):
        gram = formation.pyramid_gram(cfg_mpc, w.reshape(bsz, h, nf, 5))
        gram = gram.reshape(bsz, h * nf, 3, 3)
        delta = (
            gram[:, :, :, None, :] * sel[None, :, None, :, None]
        ).reshape(bsz, n, n)
        k = hess_n + cfg.sigma * eye[None] + delta
        return _batched_solver(k, cfg)

    def apply_a(v):
        return formation.pyramid_apply(
            cfg_mpc, v.reshape(bsz, h, nf, 3)
        ).reshape(bsz, -1)

    def apply_at(wv):
        return formation.pyramid_apply_t(
            cfg_mpc, wv.reshape(bsz, h, nf, 5)
        ).reshape(bsz, -1)

    # ---- ADMM iterations (batched) ----
    alpha = cfg.over_relax_alpha
    sigma = cfg.sigma
    solve0 = build_solver(rho)

    def mk_body(lowp, solve_c, rho_c):
        inv_rho_c = 1.0 / rho_c

        def body(carry, _):
            x, z, y = carry
            rhs = sigma * x - grad_n + apply_at(rho_c * z - y)
            # inexact solves are fine inside ADMM (a fixed-point
            # iteration); refinement is reserved for the polish solves.
            # The segments before the last adaptive-rho event use the bf16
            # inverse (a memory-bound phase); the last segment runs in f32
            # and re-contracts to the exact fixed point.
            x_t = solve_c(rhs, refine=0, lowp=lowp)
            z_t = apply_a(x_t)
            x_new = alpha * x_t + (1.0 - alpha) * x
            z_relax = alpha * z_t + (1.0 - alpha) * z
            z_new = jnp.clip(z_relax + inv_rho_c * y, l, u)
            y_new = y + rho_c * (z_relax - z_new)
            return (x_new, z_new, y_new), None
        return body

    if warm is None:
        init = (0.0 * grad_n, (0.0 * rho).astype(dtype),
                (0.0 * rho).astype(dtype))
    else:
        init = tuple(w.astype(dtype) for w in warm)
    adapt = max(int(cfg.rho_adapt), 0)
    segs = adapt + 1
    seg = n_iter // segs
    carry = init
    rho_c = rho
    solve_c = solve0
    for s_i in range(segs):
        last = s_i == segs - 1
        n_seg = n_iter - seg * (segs - 1) if last else seg
        carry, _ = lax.scan(mk_body(not last, solve_c, rho_c), carry, None,
                            length=n_seg)
        if not last:
            # OSQP adaptive-rho, per scenario, + one cold refactorization:
            # lets hard cone-binding active sets converge in far fewer
            # iterations than any fixed rho
            xs, zs, ys = carry
            hx = jnp.einsum("bij,bj->bi", hess_n, xs, precision=_HI)
            fac = _adapt_rho_factor(
                cfg, per_scn(apply_a(xs)), per_scn(zs), per_scn(hx),
                per_scn(grad_n), per_scn(apply_at(ys)))
            rho_c = rho * scn_fac_rows(fac, m_full // pack)
            solve_c = build_solver(rho_c)
    x, z, y = carry

    warm_out = (x, z, y)          # pre-polish fixed-point iterate, normalized

    # ---- polish (batched, AL dual correction) ----
    finite_u = u < cfg.infty
    w_act = cfg.polish_w_act
    lo_act = (z - l) < 1e-4
    hi_act = finite_u & ((u - z) < 1e-4)
    if cfg.polish_dual_seed_tol > 0.0:
        # dual-informed seeding: binding rows carry y < 0 (lower) / y > 0
        # (upper) at the ADMM fixed point; large multipliers identify active
        # rows z-proximity alone can miss after a finite iterate budget
        dt_ = cfg.polish_dual_seed_tol
        lo_act = lo_act | (y < -dt_)
        hi_act = hi_act | (finite_u & (y > dt_))

    def viol(v):
        av = apply_a(v)
        per_row = jnp.maximum(l - av, jnp.where(finite_u, av - u, -1.0))
        return jnp.max(per_scn(per_row), axis=-1)             # (B*pack,)

    def rhs_parts(lo, hi, y_al):
        act = lo | hi
        bound = jnp.where(lo, l, jnp.where(hi & finite_u, u, 0.0))
        w = jnp.where(act, w_act, 0.0)
        y_act = jnp.where(act, y_al, 0.0)
        return w, bound, y_act

    def apply_round(solve_fn, w, bound, y_act, best_x, best_v, lo, hi):
        """One polish solve at the CURRENT working set, plus the refinement
        proposal (drop wrong-sign multipliers, add violated rows). A
        non-finite scenario keeps its incoming working set and duals, so one
        bad solve cannot poison subsequent rounds' proposals."""
        x_p = solve_fn(-grad_n + apply_at(w * bound - y_act))
        ax = apply_a(x_p)
        y_new = y_act + w * (ax - bound)
        finite_p = jnp.all(
            jnp.isfinite(per_scn(x_p)), axis=-1)              # (B*pack,)
        v_p = jnp.where(finite_p, viol(x_p), jnp.inf)
        take = (v_p < best_v)[:, None]                        # per scenario
        nsc = n // pack
        best_x = jnp.where(
            take, per_scn(x_p), best_x.reshape(bsz * pack, nsc)
        ).reshape(bsz, n)
        best_v = jnp.minimum(v_p, best_v)
        lo_d = (lo & (y_new <= 1e-9)) | (ax < l - 1e-6)
        hi_d = (hi & (y_new >= -1e-9)) | (finite_u & (ax > u + 1e-6))
        fin_rows = scn_fac_rows(
            finite_p.astype(dtype), m_full // pack) > 0.5
        lo_d = jnp.where(fin_rows, lo_d, lo)
        hi_d = jnp.where(fin_rows, hi_d, hi)
        y_al = jnp.where(
            fin_rows, jnp.where(lo_d | hi_d, y_new, 0.0), y_act)
        return best_x, best_v, lo_d, hi_d, y_al

    if polish_rounds > 0:
        # round 0: ONE cold full-polish-grade factorization at the
        # ADMM-identified active set, duals seeded from the ADMM iterate
        y_seed = jnp.where(lo_act | hi_act, y, 0.0)
        w0p, bound0, y_act0 = rhs_parts(lo_act, hi_act, y_seed)
        solve_p0 = build_solver(w0p)
        carry = apply_round(solve_p0, w0p, bound0, y_act0,
                            x, jnp.maximum(viol(x), 0.0), lo_act, hi_act)

        if polish_rounds > 1 and cfg.polish_woodbury:
            # STATUS: OFF by default (config.polish_woodbury) — measured
            # numerically unsound in f32; see the config note for the full
            # negative result. Kept as the incremental-factorization
            # candidate for extended-precision hardware. Per round:
            # (1) the working-set update is CLAMPED to at most `rank`
            #     constraint ADDITIONS (removals defer: downdating a
            #     dominant +w_act penalty row amplifies the stored
            #     inverse's f32 error by ~w_act — measured warm-NS residual
            #     ~300 vs ~0.2 for additions); overflow flips wait for
            #     later rounds, guarded by the best-iterate selection;
            # (2) a rank-r Woodbury correction of the PREVIOUS round's
            #     refined inverse gives an approximate inverse M in O(r n^2)
            #     work — algebraically exact (verified in f64) but f32
            #     cancellation-limited;
            # (3) M warm-starts a ns_wb_quad+ns_wb_hi Newton-Schulz
            #     refactorization (each iteration squares the residual) —
            #     2 iterations instead of the ns_iters cold schedule, with
            #     no divergence guard.
            rank = min(cfg.polish_woodbury_rank * pack, 5 * h * nf)
            sqrt_w = jnp.sqrt(jnp.asarray(w_act, dtype))
            a_dense = jnp.asarray(_pyramid_dense(cfg_mpc.mu, h, nf), dtype)

            def wb_round(carry, _):
                (best_x, best_v, lo_d, hi_d, y_al,
                 lo_p, hi_p, inv_p, ks_p, dd_p) = carry
                # ---- clamp the proposed update to `rank` weight flips
                # (lo<->hi swaps keep w and need no factorization update)
                act_d = lo_d | hi_d
                act_p = lo_p | hi_p
                flip_w = act_d != act_p
                # apply only ADDITIONS through the factorization update:
                # adding +w_act rows is numerically benign (measured warm-NS
                # residual ~0.2), while REMOVING a dominant penalty row
                # amplifies the stored inverse's f32 error by ~w_act
                # (measured residual ~300 — divergent), so removals are
                # deferred: the row keeps its penalty at the PREVIOUS bound
                # and the best-iterate selection guards the difference.
                add_w = act_d & ~act_p
                _, idx = lax.top_k(add_w.astype(dtype), rank)
                # row selection as one-hot contractions (0/1 data: exact
                # at any matmul precision)
                onehot = jax.nn.one_hot(idx, flip_w.shape[-1], dtype=dtype)
                msel = jnp.einsum('brm,bm->br', onehot,
                                  add_w.astype(dtype))        # (B,rank)
                applied = jnp.einsum('brm,br->bm', onehot, msel) > 0.5
                keep = flip_w & ~applied
                lo_n = jnp.where(keep, lo_p, lo_d)
                hi_n = jnp.where(keep, hi_p, hi_d)
                act_n = lo_n | hi_n
                # ---- rank-limited Woodbury vs the previous inverse
                actn_sel = jnp.einsum('brm,bm->br', onehot,
                                      act_n.astype(dtype))
                s_sel = jnp.where(actn_sel > 0.5, 1.0, -1.0).astype(dtype)
                a_sel = jnp.einsum('brm,mn->brn', onehot, a_dense,
                                   precision=_HI)
                u_rows = (sqrt_w * msel)[:, :, None] * a_sel \
                    * dd_p[:, None, :]            # (B,rank,n), prev scaling
                v_rows = jnp.einsum('brn,bnm->brm', u_rows, inv_p,
                                    precision=_HI)
                gmat = jnp.einsum('brm,bsm->brs', v_rows, u_rows,
                                  precision=_HI)
                cs = gmat + s_sel[:, :, None] * jnp.eye(rank, dtype=dtype)
                cinv = _gj_inverse(cs)
                cv_rows = jnp.einsum('brs,bsn->brn', cinv, v_rows,
                                     precision=_HI)
                m_wb = inv_p - jnp.einsum('brn,brm->bnm', v_rows, cv_rows,
                                          precision=_HI)
                sus = u_rows * s_sel[:, :, None]
                ks1 = ks_p + jnp.einsum('brn,brm->bnm', sus, u_rows,
                                        precision=_HI)
                # re-equilibrate by the new Jacobi scale (the update moves
                # changed-row diagonals far from the previous unit diagonal)
                d1 = lax.rsqrt(jnp.maximum(
                    jnp.diagonal(ks1, axis1=-2, axis2=-1), 1e-30))
                ks1s = ks1 * d1[:, :, None] * d1[:, None, :]
                init = m_wb / (d1[:, :, None] * d1[:, None, :])
                eye_n = jnp.eye(n, dtype=dtype)
                x_ = init
                for _ in range(cfg.ns_wb_quad + cfg.ns_wb_hi):
                    kx = jnp.einsum('bij,bjk->bik', ks1s, x_, precision=_HI)
                    x_ = jnp.einsum('bij,bjk->bik', x_, 2.0 * eye_n - kx,
                                    precision=_HI)
                inv1 = x_
                dd_n = dd_p * d1

                def wsolve(b_vec, refine: int = 2):
                    bs = dd_n * b_vec
                    x_s = jnp.einsum('bnm,bm->bn', inv1, bs, precision=_HI)
                    for _ in range(refine):
                        r = bs - jnp.einsum('bnm,bm->bn', ks1s, x_s,
                                            precision=_HI)
                        x_s = x_s + jnp.einsum('bnm,bm->bn', inv1, r,
                                               precision=_HI)
                    return dd_n * x_s

                w_n, bound_n, y_act_n = rhs_parts(lo_n, hi_n, y_al)
                out = apply_round(wsolve, w_n, bound_n, y_act_n,
                                  best_x, best_v, lo_n, hi_n)
                return out + (lo_n, hi_n, inv1, ks1s, dd_n), None

            carry0 = carry + (lo_act, hi_act, solve_p0.inv, solve_p0.ks,
                              solve_p0.scale)
            carry, _ = lax.scan(wb_round, carry0, None,
                                length=polish_rounds - 1)
        else:
            def round_body(carry, _):
                best_x, best_v, lo, hi, y_al = carry
                w, bound, y_act = rhs_parts(lo, hi, y_al)
                return apply_round(build_solver(w), w, bound, y_act,
                                   best_x, best_v, lo, hi), None

            carry, _ = lax.scan(round_body, carry, None,
                                length=max(polish_rounds - 1, 0))
        x = carry[0]
    if return_warm:
        return x * f_scale, warm_out
    return x * f_scale
