"""Condensed convex MPC formation: SRB linearization, exact discretization,
prediction stacking, and QP cost/constraint assembly.

Re-derivation of the reference's dense path (SolverMPC.cpp:87-125 c2qp,
:235-254 ct_ss_mats, :296-399 solve_mpc cost assembly, :352-377 friction
pyramid). Differences by design, for batched static-shape execution:

* the 25x25 matrix exponential is a fixed scaling-and-squaring Taylor series
  (static shapes, no data-dependent control flow, vmap/batch friendly);
* the horizon is padded to a static `h_max`; steps >= h get zero cost weight
  and zero contact (force bounds 0), which decouples them from the QP exactly;
* the friction-pyramid constraint matrix is never materialized — it is
  block-structured (5x3 per foot-step), applied/transposed/grammed
  structurally so the ADMM solver never touches a (20h x 12h) dense matrix;
* swing feet are handled by bound masking (fz in [0,0] forces fx=fy=0 via the
  pyramid rows), equivalent to the reference's variable elimination
  (SolverMPC.cpp:441-525) — same minimizer, static shapes.

State (13): [roll, pitch, yaw, p(3), omega_world(3), v_world(3), g_aug],
with g_aug = -9.8 held by the dynamics' 13th column.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from quadruped_ctrl_tpu.config import MPCConfig

_HI = lax.Precision.HIGHEST


def srb_ct_dynamics(cfg_mpc: MPCConfig, r_feet, yaw, x_drag):
    """Continuous-time A(13,13), B(13,12) (SolverMPC.cpp:235-254).

    r_feet: (4,3) foot positions relative to the CoM, world frame.
    """
    dtype = r_feet.dtype
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    r_yaw = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)

    i_body = jnp.asarray(cfg_mpc.inertia_arr(), dtype=dtype)
    i_world = jnp.matmul(jnp.matmul(r_yaw, i_body, precision=_HI), r_yaw.T,
                         precision=_HI)
    i_inv = jnp.linalg.inv(i_world)

    a = jnp.zeros((13, 13), dtype=dtype)
    a = a.at[3, 9].set(1.0).at[4, 10].set(1.0).at[5, 11].set(1.0)
    a = a.at[11, 9].set(x_drag)
    a = a.at[11, 12].set(1.0)
    a = a.at[0:3, 6:9].set(r_yaw.T)

    rx = jnp.zeros((4, 3, 3), dtype=dtype)
    rx = rx.at[:, 0, 1].set(-r_feet[:, 2]).at[:, 0, 2].set(r_feet[:, 1])
    rx = rx.at[:, 1, 0].set(r_feet[:, 2]).at[:, 1, 2].set(-r_feet[:, 0])
    rx = rx.at[:, 2, 0].set(-r_feet[:, 1]).at[:, 2, 1].set(r_feet[:, 0])
    torque_blocks = jnp.einsum("ij,fjk->fik", i_inv, rx, precision=_HI)  # (4,3,3)

    b = jnp.zeros((13, 12), dtype=dtype)
    for f in range(4):
        b = b.at[6:9, 3 * f : 3 * f + 3].set(torque_blocks[f])
        b = b.at[9:12, 3 * f : 3 * f + 3].set(
            jnp.eye(3, dtype=dtype) / cfg_mpc.mass
        )
    return a, b


def expm_fixed(m, scaling: int = 4, order: int = 10):
    """Matrix exponential via fixed scaling-and-squaring + Taylor series.

    Static control flow (unlike jax.scipy.linalg.expm's norm-dependent
    scaling), accurate to ~1e-7 in f32 for the small-norm matrices produced
    by dt * [[A,B],[0,0]] (SolverMPC.cpp:87-93). Batched over leading dims.
    """
    ms = m / (2.0**scaling)
    n = m.shape[-1]
    eye = jnp.eye(n, dtype=m.dtype)
    eye = jnp.broadcast_to(eye, m.shape)
    result = eye
    term = eye
    for k in range(1, order + 1):
        term = jnp.matmul(term, ms, precision=_HI) / k
        result = result + term
    for _ in range(scaling):
        result = jnp.matmul(result, result, precision=_HI)
    return result


def discretize(a_ct, b_ct, dt):
    """Exact zero-order-hold discretization. Returns (Adt 13x13, Bdt 13x12).

    The reference computes exp(dt*[[A,B],[0,0]]) with a dense 25x25 matrix
    exponential (SolverMPC.cpp:87-95). But the SRB A matrix is nilpotent of
    index 3 (A^3 = 0 exactly: rpy<-omega, p<-v, vz<-drag*vx+g chains never
    cycle), so the exponential IS the degree-2 polynomial — the same result
    to machine precision at ~1/30th the FLOPs, with no sequential
    Taylor/squaring chain:

        Adt = I + dt A + dt^2/2 A^2
        Bdt = (dt I + dt^2/2 A + dt^3/6 A^2) B
    """
    dtype = a_ct.dtype
    eye = jnp.eye(13, dtype=dtype)
    a2 = jnp.matmul(a_ct, a_ct, precision=_HI)
    adt = eye + dt * a_ct + (dt * dt / 2.0) * a2
    bdt = jnp.matmul(
        dt * eye + (dt * dt / 2.0) * a_ct + (dt**3 / 6.0) * a2,
        b_ct,
        precision=_HI,
    )
    return adt, bdt


def discretize_expm(a_ct, b_ct, dt):
    """Generic augmented-exponential discretization (for non-nilpotent
    dynamics and as the differential-test reference for `discretize`)."""
    dtype = a_ct.dtype
    abc = jnp.zeros((25, 25), dtype=dtype)
    abc = abc.at[0:13, 0:13].set(a_ct).at[0:13, 13:25].set(b_ct)
    em = expm_fixed(abc * dt)
    return em[0:13, 0:13], em[0:13, 13:25]


def condense(adt, bdt, h_max: int):
    """Prediction-stacking: A_qp (h,13,13) = Adt^(r+1); B_qp (h,h,13,12)
    lower-block-Toeplitz of Adt^(r-c) Bdt (SolverMPC.cpp:103-120).

    The power chain is a `lax.scan` (h_max steps of a 13x13 matmul).
    """

    def step(carry, _):
        nxt = jnp.matmul(adt, carry, precision=_HI)
        return nxt, nxt

    # 0*adt makes the carry inherit adt's sharding/varying axes (shard_map)
    eye = jnp.eye(13, dtype=adt.dtype) + 0.0 * adt
    _, powers_tail = lax.scan(step, eye, None, length=h_max)
    powers = jnp.concatenate([eye[None], powers_tail], axis=0)  # (h_max+1,13,13)

    a_qp = powers[1 : h_max + 1]                                # (h,13,13)
    pow_b = jnp.einsum("hij,jk->hik", powers[:h_max], bdt, precision=_HI)

    r = jnp.arange(h_max)[:, None]
    c = jnp.arange(h_max)[None, :]
    idx = jnp.clip(r - c, 0, h_max - 1)
    mask = (r >= c).astype(adt.dtype)[:, :, None, None]
    b_qp = pow_b[idx] * mask                                    # (h,h,13,12)
    return a_qp, b_qp


def qp_cost(
    cfg_mpc: MPCConfig,
    a_qp,            # (h,13,13)
    b_qp,            # (h,h,13,12)
    x0,              # (13,)
    x_d,             # (h,13) reference trajectory (13th entry 0)
    step_mask,       # (h,) 1.0 for steps < horizon
):
    """Hessian (12h,12h) and gradient (12h,) of the condensed QP
    (SolverMPC.cpp:335-399): H = 2(B' S B + alpha I), g = 2 B' S (A x0 - X_d)."""
    h = a_qp.shape[0]
    dtype = a_qp.dtype
    w = jnp.concatenate(
        [jnp.asarray(cfg_mpc.weights_arr(), dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    s_diag = (w[None, :] * step_mask[:, None])                   # (h,13)

    bq = b_qp.transpose(0, 2, 1, 3).reshape(h * 13, h * 12)
    sb = (s_diag.reshape(-1, 1)) * bq
    hess = 2.0 * (
        jnp.matmul(bq.T, sb, precision=_HI)
        + cfg_mpc.alpha * jnp.eye(h * 12, dtype=dtype)
    )
    resid = (
        jnp.einsum("hij,j->hi", a_qp, x0, precision=_HI) - x_d
    ) * s_diag
    grad = 2.0 * jnp.matmul(bq.T, resid.reshape(-1), precision=_HI)
    return hess, grad


def pyramid_bounds(cfg_mpc: MPCConfig, gait_table):
    """Lower/upper bounds of the 5 constraint rows per foot-step
    (SolverMPC.cpp:352-364). gait_table: (h,nf) in {0,1}. Returns l,u (h,nf,5)."""
    h, nf = gait_table.shape
    dtype = gait_table.dtype
    big = jnp.asarray(cfg_mpc.big_number, dtype=dtype)
    u = jnp.broadcast_to(big, (h, nf, 5)).copy()
    u = u.at[:, :, 4].set(gait_table * cfg_mpc.f_max)
    l = jnp.zeros((h, nf, 5), dtype=dtype)
    return l, u


def pyramid_apply(cfg_mpc: MPCConfig, x):
    """A @ x for the friction pyramid, structurally. x: (...,h,4,3) forces;
    returns (...,h,4,5) [mu^-1 fx+fz, -mu^-1 fx+fz, mu^-1 fy+fz, -mu^-1 fy+fz, fz]."""
    mu_inv = 1.0 / cfg_mpc.mu
    fx, fy, fz = x[..., 0], x[..., 1], x[..., 2]
    return jnp.stack(
        [mu_inv * fx + fz, -mu_inv * fx + fz, mu_inv * fy + fz, -mu_inv * fy + fz, fz],
        axis=-1,
    )


def pyramid_apply_t(cfg_mpc: MPCConfig, y):
    """A.T @ y, structurally. y: (...,h,4,5) -> (...,h,4,3)."""
    mu_inv = 1.0 / cfg_mpc.mu
    fx = mu_inv * (y[..., 0] - y[..., 1])
    fy = mu_inv * (y[..., 2] - y[..., 3])
    fz = y[..., 0] + y[..., 1] + y[..., 2] + y[..., 3] + y[..., 4]
    return jnp.stack([fx, fy, fz], axis=-1)


def pyramid_gram(cfg_mpc: MPCConfig, rho):
    """A.T diag(rho) A per foot-step block, structurally.

    rho: (h,4,5) per-row ADMM penalties -> (h,4,3,3) SPD blocks used to build
    the ADMM normal-equation matrix without materializing A.
    """
    mu_inv = 1.0 / cfg_mpc.mu
    r0, r1, r2, r3, r4 = (rho[..., i] for i in range(5))
    gxx = mu_inv * mu_inv * (r0 + r1)
    gyy = mu_inv * mu_inv * (r2 + r3)
    gzz = r0 + r1 + r2 + r3 + r4
    gxz = mu_inv * (r0 - r1)
    gyz = mu_inv * (r2 - r3)
    zeros = jnp.zeros_like(gxx)
    g = jnp.stack(
        [gxx, zeros, gxz, zeros, gyy, gyz, gxz, gyz, gzz], axis=-1
    )
    return g.reshape(rho.shape[:-1] + (3, 3))


def build_x0(rpy, position, omega_world, v_world, gravity):
    """Initial condensed-MPC state (SolverMPC.cpp:314-318). Accepts leading
    batch dims."""
    g = jnp.broadcast_to(
        jnp.asarray([-gravity], rpy.dtype), rpy.shape[:-1] + (1,)
    )
    return jnp.concatenate([rpy, position, omega_world, v_world, g], axis=-1)


def srb_discrete(cfg_mpc: MPCConfig, r_feet, yaw, x_drag, dt):
    """Closed-form (Adt, Bdt): `srb_ct_dynamics` + `discretize` fused,
    evaluated SPARSELY. Batched over arbitrary leading dims.

    The generic path assembles a dense 13x13 A with ~15 scatter updates, a
    batched 3x3 linalg.inv, and three 13x13 matmul chains — thousands of
    tiny XLA ops per scenario batch that dominated the measured formation
    phase. But the SRB A has only four nonzero blocks (rpy<-omega, p<-v,
    vz<-drag*vx, vz<-g) and A^2 exactly TWO nonzero entries
    (A2[5,9]=x_drag, A2[5,12]=1), and I_world^-1 = R_yaw I_body^-1 R_yaw'
    in closed form (I_body diagonal) — so Adt = I + dt A + dt^2/2 A^2 and
    Bdt = (dt I + dt^2/2 A + dt^3/6 A^2) B reduce to a handful of batched
    3x12 block products. Identical values to the generic path (differential-
    tested); reference: SolverMPC.cpp:87-95 + :235-254.
    """
    dtype = r_feet.dtype
    lead = r_feet.shape[:-2]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    # R_yaw^T rows (world->yaw frame)
    ryaw_t = jnp.stack([
        jnp.stack([c, s, zero], axis=-1),
        jnp.stack([-s, c, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ], axis=-2)                                               # (...,3,3)

    ix, iy, iz = (float(v) for v in cfg_mpc.inertia)
    a_, b_ = 1.0 / ix, 1.0 / iy
    iinv = jnp.stack([
        jnp.stack([a_ * c * c + b_ * s * s, (a_ - b_) * c * s, zero], axis=-1),
        jnp.stack([(a_ - b_) * c * s, a_ * s * s + b_ * c * c, zero], axis=-1),
        jnp.stack([zero, zero, one / iz], axis=-1),
    ], axis=-2)                                               # (...,3,3)

    rx_, ry_, rz_ = r_feet[..., 0], r_feet[..., 1], r_feet[..., 2]
    zf = jnp.zeros_like(rx_)
    rx = jnp.stack([
        jnp.stack([zf, -rz_, ry_], axis=-1),
        jnp.stack([rz_, zf, -rx_], axis=-1),
        jnp.stack([-ry_, rx_, zf], axis=-1),
    ], axis=-2)                                               # (...,4,3,3)
    tb = jnp.einsum("...ij,...fjk->...fik", iinv, rx, precision=_HI)
    tb_flat = jnp.swapaxes(tb, -3, -2).reshape(lead + (3, 12))

    import numpy as np
    m = cfg_mpc.mass
    base = np.eye(13, dtype=np.float32)
    base[3, 9] = base[4, 10] = base[5, 11] = dt
    base[11, 12] = dt
    base[5, 12] = 0.5 * dt * dt
    # scatter-free assembly: .at[...].set on a (B,13,13) lowers to one
    # batched dynamic-update-slice per entry; a pad + a static-mask
    # multiply fuse into one elementwise pass instead
    xd_mask = np.zeros((13, 13), dtype=np.float32)
    xd_mask[11, 9] = dt
    xd_mask[5, 9] = 0.5 * dt * dt
    pad_widths = [(0, 0)] * len(lead) + [(0, 10), (6, 4)]
    adt = (jnp.asarray(base, dtype)
           + jnp.pad(dt * ryaw_t, pad_widths)
           + x_drag[..., None, None] * jnp.asarray(xd_mask, dtype))

    eye3x4 = np.tile(np.eye(3, dtype=np.float32), (1, 4))     # (3,12)
    xsel = jnp.asarray(eye3x4[0], dtype)                      # fx columns
    r03 = (0.5 * dt * dt) * jnp.einsum(
        "...ij,...jk->...ik", ryaw_t, tb_flat, precision=_HI)
    s35 = (0.5 * dt * dt / m) * jnp.asarray(eye3x4, dtype)
    row5 = jnp.broadcast_to(s35[2], lead + (12,)) \
        + (dt**3 / 6.0 / m) * x_drag[..., None] * xsel
    r35 = jnp.stack([
        jnp.broadcast_to(s35[0], lead + (12,)),
        jnp.broadcast_to(s35[1], lead + (12,)),
        row5,
    ], axis=-2)
    r69 = dt * tb_flat
    s912 = (dt / m) * jnp.asarray(eye3x4, dtype)
    row11 = jnp.broadcast_to(s912[2], lead + (12,)) \
        + (0.5 * dt * dt / m) * x_drag[..., None] * xsel
    r912 = jnp.stack([
        jnp.broadcast_to(s912[0], lead + (12,)),
        jnp.broadcast_to(s912[1], lead + (12,)),
        row11,
    ], axis=-2)
    r12 = jnp.zeros(lead + (1, 12), dtype)
    bdt = jnp.concatenate([r03, r35, r69, r912, r12], axis=-2)
    return adt, bdt


def stance_selectors(gait_table, max_stance: int):
    """Sortless `compress_stance`, batched over leading dims.

    argsort over the foot axis lowers to a per-scenario sort network; the
    same stance-first stable order falls out of a rank-by-comparison over
    the 4 distinct keys (1-gait)*4 + foot. Returns (foot_idx int32
    (...,h,ms), gait_red (...,h,ms), sel (...,h,ms,4)) where sel is the
    one-hot selection tensor `qp_cost_compressed_nil_sel` consumes
    directly."""
    g = gait_table
    dtype = g.dtype
    f = jnp.arange(4, dtype=dtype)
    key = (1.0 - g) * 4.0 + f                                 # (...,h,4)
    rank = jnp.sum(
        (key[..., :, None] > key[..., None, :]).astype(jnp.int32), axis=-1
    )                                                         # (...,h,4)
    oh = jax.nn.one_hot(rank, 4, dtype=dtype)                 # (...,h,4,slot)
    sel = jnp.swapaxes(oh, -1, -2)[..., :max_stance, :]       # (...,h,ms,4)
    foot_idx = jnp.einsum("...sf,f->...s", sel, f,
                          precision=_HI).astype(jnp.int32)
    gait_red = jnp.einsum("...sf,...f->...s", sel, g, precision=_HI)
    return foot_idx, gait_red, sel


def qp_cost_compressed_nil_sel(
    cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, sel
):
    """`qp_cost_compressed_nil` with the selection tensor passed directly,
    batched over arbitrary leading dims, and two structural speedups:

    * sqrt-S folding: S = diag(mask_x * w_p) is separable, so sqrt(w_p) is
      folded into the B-family and sqrt(mask_x) into the stacked rows —
      H = bq_s' bq_s with ONE scaled operand (a full (13h x n_c) stream
      fewer than bq' (S bq)), g = 2 bq_s' (sqrt(S) resid);
    * the Toeplitz combine emits rows directly in (x,p) output order, so no
      (h,h,13,ms,3) transpose materializes.

    With sel = identity (ms=4) this IS the uncompressed qp_cost_nil.
    """
    dtype = adt.dtype
    lead = x_d.shape[:-2]
    h = x_d.shape[-2]
    ms = sel.shape[-2]
    n_c = h * ms * 3
    eye13 = jnp.eye(13, dtype=dtype)
    n1 = adt - eye13
    n2 = jnp.einsum("...ij,...jk->...ik", n1, n1, precision=_HI)
    bfam = jnp.stack(
        [bdt,
         jnp.einsum("...ij,...jk->...ik", n1, bdt, precision=_HI),
         jnp.einsum("...ij,...jk->...ik", n2, bdt, precision=_HI)],
        axis=-3,
    )                                                         # (...,3,13,12)
    w = jnp.concatenate(
        [jnp.asarray(cfg_mpc.weights_arr(), dtype=dtype),
         jnp.zeros(1, dtype=dtype)]
    )
    sqrt_w = jnp.sqrt(w)
    sqrt_mask = jnp.sqrt(step_mask)                           # (...,h)
    bfam_s = bfam * sqrt_w[:, None]                           # scale p rows
    # layout-conscious Toeplitz combine: keep the (c,j,z)=n_c axis
    # TRAILING everywhere — intermediates with a 3- or 6-wide minor dim
    # waste most of each vector load, and every einsum batch-dim lowering
    # inserts a full relayout copy. u lands as (...,3,13,n_c); the phi combine is a
    # broadcast multiply-reduce over m=3 (static phi expanded over (j,z)),
    # which XLA fuses into one pass — no dot_general batch-dim transposes.
    u = jnp.einsum(
        "...mpfz,...cjf->...mpcjz",
        bfam_s.reshape(lead + (3, 13, 4, 3)), sel, precision=_HI,
    ).reshape(lead + (3, 13, n_c))
    phi = _phi_polys(h, dtype)                                # (3,h,h)
    phiexp = jnp.repeat(phi, ms * 3, axis=-1)                 # (3,h,n_c)
    bq = jnp.sum(
        phiexp[:, :, None, :] * u[..., :, None, :, :], axis=-4
    )                                                         # (...,h,13,n_c)
    bq = (bq * sqrt_mask[..., :, None, None]).reshape(
        lead + (h * 13, n_c))
    hess = 2.0 * (
        jnp.einsum("...kc,...kd->...cd", bq, bq, precision=_HI)
        + cfg_mpc.alpha * jnp.eye(n_c, dtype=dtype)
    )
    nx0 = jnp.einsum("...ij,...j->...i", n1, x0, precision=_HI)
    n2x0 = jnp.einsum("...ij,...j->...i", n2, x0, precision=_HI)
    k = jnp.arange(1, h + 1, dtype=dtype)[:, None]
    ax0 = (x0[..., None, :] + k * nx0[..., None, :]
           + (0.5 * k * (k - 1.0)) * n2x0[..., None, :])      # (...,h,13)
    resid = (ax0 - x_d) * (sqrt_mask[..., :, None] * sqrt_w)
    grad = 2.0 * jnp.einsum(
        "...kc,...k->...c", bq, resid.reshape(lead + (h * 13,)),
        precision=_HI,
    )
    return hess, grad


def qp_cost_packed(
    cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, sel, pack: int,
):
    """Block-diagonally PACKED QP cost: `pack` scenarios per system.

    Returns (hess (B/pack, pack*n_c, pack*n_c), grad (B/pack, pack*n_c)) —
    the layout `admm.admm_mpc_batched(..., pack=pack)` consumes:
    `qp_cost_compressed_nil_sel` per scenario, embedded block-diagonally."""
    b = x_d.shape[0]
    h = x_d.shape[-2]
    ms = sel.shape[-2]
    n_c = h * ms * 3
    assert b % pack == 0
    hess, grad = qp_cost_compressed_nil_sel(
        cfg_mpc, adt, bdt, x0, x_d, step_mask, sel
    )
    hp = hess.reshape(b // pack, pack, n_c, n_c)
    kp = jnp.zeros((b // pack, pack * n_c, pack * n_c), hess.dtype)
    for j in range(pack):
        kp = kp.at[:, j * n_c: (j + 1) * n_c, j * n_c: (j + 1) * n_c].set(
            hp[:, j]
        )
    gp = grad.reshape(b // pack, pack * n_c)
    return kp, gp


def compress_stance(gait_table, max_stance: int):
    """Per-step stance-foot index map for swing-variable elimination.

    The reference removes swing-foot variables and their constraint rows from
    the QP (SolverMPC.cpp:441-525) with dynamic sizes; here the compression
    is a static-shape gather: each step keeps `max_stance` foot slots, stance
    feet first (argsort), any padding slots being swing feet whose force is
    pinned to zero by their own bounds — the same minimizer either way.

    gait_table: (h,4) -> (foot_idx (h,max_stance) int32,
                          gait_red (h,max_stance)).
    """
    order = jnp.argsort(-gait_table, axis=1, stable=True)      # stance first
    foot_idx = order[:, :max_stance].astype(jnp.int32)
    gait_red = jnp.take_along_axis(gait_table, foot_idx, axis=1)
    return foot_idx, gait_red


def qp_cost_compressed(
    cfg_mpc: MPCConfig,
    a_qp,            # (h,13,13)
    b_qp,            # (h,h,13,12)
    x0,              # (13,)
    x_d,             # (h,13)
    step_mask,       # (h,)
    foot_idx,        # (h,max_stance) from compress_stance
):
    """Hessian/gradient over stance-foot variables only.

    Forming the reduced H directly costs (13h)(3*ms*h)^2 instead of
    (13h)(12h)^2 — for a trot (ms=2) an 8x reduction in the factorization
    work downstream and 4x here.
    """
    h = a_qp.shape[0]
    ms = foot_idx.shape[1]
    dtype = a_qp.dtype
    w = jnp.concatenate(
        [jnp.asarray(cfg_mpc.weights_arr(), dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    s_diag = w[None, :] * step_mask[:, None]                    # (h,13)

    # select stance-foot columns as a one-hot contraction (no gather):
    # (h,h,13,4,3) -> (h,h,13,ms,3)
    b5 = b_qp.reshape(h, h, 13, 4, 3)
    sel = jax.nn.one_hot(foot_idx, 4, dtype=dtype)              # (h,ms,4)
    b_red = jnp.einsum("xsifz,sjf->xsijz", b5, sel, precision=_HI)

    n_c = h * ms * 3
    bq = b_red.transpose(0, 2, 1, 3, 4).reshape(h * 13, n_c)
    sb = s_diag.reshape(-1, 1) * bq
    hess = 2.0 * (
        jnp.matmul(bq.T, sb, precision=_HI)
        + cfg_mpc.alpha * jnp.eye(n_c, dtype=dtype)
    )
    resid = (jnp.einsum("hij,j->hi", a_qp, x0, precision=_HI) - x_d) * s_diag
    grad = 2.0 * jnp.matmul(bq.T, resid.reshape(-1), precision=_HI)
    return hess, grad


def _phi_polys(h: int, dtype):
    """Toeplitz polynomial weights Phi_m[x,c] = phi_m(x-c) * (x>=c) for the
    closed-form power family Adt^k = I + k N + C(k,2) N^2 (N = Adt - I,
    nilpotent of index 3 because A_ct is — see `discretize`)."""
    x = jnp.arange(h, dtype=dtype)[:, None]
    c = jnp.arange(h, dtype=dtype)[None, :]
    k = x - c
    tri = (k >= 0).astype(dtype)
    return jnp.stack([tri, k * tri, 0.5 * k * (k - 1.0) * tri])   # (3,h,h)


def _nil_family(adt, bdt):
    """(N, N^2, [Bdt, N Bdt, N^2 Bdt]) for the closed-form condensation."""
    dtype = adt.dtype
    n1 = adt - jnp.eye(13, dtype=dtype)
    n2 = jnp.matmul(n1, n1, precision=_HI)
    bfam = jnp.stack(
        [bdt, jnp.matmul(n1, bdt, precision=_HI),
         jnp.matmul(n2, bdt, precision=_HI)]
    )                                                             # (3,13,12)
    return n1, n2, bfam


def _ax0_closed(n1, n2, x0, h: int):
    """a_qp @ x0 without forming a_qp: Adt^(x+1) x0 = x0 + (x+1) N x0 +
    C(x+1,2) N^2 x0 — two matvecs and a polynomial combination."""
    dtype = x0.dtype
    nx0 = jnp.matmul(n1, x0, precision=_HI)
    n2x0 = jnp.matmul(n2, x0, precision=_HI)
    k = jnp.arange(1, h + 1, dtype=dtype)[:, None]
    return x0[None, :] + k * nx0[None, :] + (0.5 * k * (k - 1.0)) * n2x0[None, :]


def qp_cost_nil(cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask):
    """`condense` + `qp_cost` fused via the closed-form nilpotent powers.

    Mathematically identical to qp_cost(condense(adt, bdt, h), ...) but with
    no sequential power scan and no (h,h,13,12) B_qp materialization: the
    Toeplitz blocks are Bdt + k (N Bdt) + C(k,2) (N^2 Bdt), assembled by one
    tiny (3,h,h) x (3,13,12) contraction. The throughput path for the
    condensed-MPC formation (SolverMPC.cpp:87-125 + :296-399 in one step).
    """
    h = x_d.shape[0]
    dtype = adt.dtype
    n1, n2, bfam = _nil_family(adt, bdt)
    phi = _phi_polys(h, dtype)
    b_qp = jnp.einsum("mxc,mpj->xcpj", phi, bfam, precision=_HI)  # (h,h,13,12)

    w = jnp.concatenate(
        [jnp.asarray(cfg_mpc.weights_arr(), dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    s_diag = w[None, :] * step_mask[:, None]
    bq = b_qp.transpose(0, 2, 1, 3).reshape(h * 13, h * 12)
    sb = s_diag.reshape(-1, 1) * bq
    hess = 2.0 * (
        jnp.matmul(bq.T, sb, precision=_HI)
        + cfg_mpc.alpha * jnp.eye(h * 12, dtype=dtype)
    )
    resid = (_ax0_closed(n1, n2, x0, h) - x_d) * s_diag
    grad = 2.0 * jnp.matmul(bq.T, resid.reshape(-1), precision=_HI)
    return hess, grad


def qp_cost_compressed_nil(
    cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, foot_idx
):
    """`condense` + `qp_cost_compressed` fused via closed-form powers: the
    stance-column selection is applied to the THREE 13x12 family matrices
    (not to the (h,h,13,12) stack), then Toeplitz-combined — removing both
    the power scan and the dominant one-hot contraction over B_qp."""
    h = x_d.shape[0]
    ms = foot_idx.shape[1]
    dtype = adt.dtype
    n1, n2, bfam = _nil_family(adt, bdt)
    sel = jax.nn.one_hot(foot_idx, 4, dtype=dtype)                # (h,ms,4)
    u = jnp.einsum(
        "mpfz,cjf->mcpjz", bfam.reshape(3, 13, 4, 3), sel, precision=_HI
    )                                                             # (3,h,13,ms,3)
    phi = _phi_polys(h, dtype)
    b_red = jnp.einsum("mxc,mcpjz->xcpjz", phi, u, precision=_HI)

    w = jnp.concatenate(
        [jnp.asarray(cfg_mpc.weights_arr(), dtype=dtype), jnp.zeros(1, dtype=dtype)]
    )
    s_diag = w[None, :] * step_mask[:, None]
    n_c = h * ms * 3
    bq = b_red.transpose(0, 2, 1, 3, 4).reshape(h * 13, n_c)
    sb = s_diag.reshape(-1, 1) * bq
    hess = 2.0 * (
        jnp.matmul(bq.T, sb, precision=_HI)
        + cfg_mpc.alpha * jnp.eye(n_c, dtype=dtype)
    )
    resid = (_ax0_closed(n1, n2, x0, h) - x_d) * s_diag
    grad = 2.0 * jnp.matmul(bq.T, resid.reshape(-1), precision=_HI)
    return hess, grad


def scatter_forces(x_red, foot_idx, h: int):
    """Reduced solution (h*ms*3,) -> full (h,4,3) with zeros on swing feet."""
    ms = foot_idx.shape[1]
    forces = jnp.zeros((h, 4, 3), x_red.dtype)
    return forces.at[
        jnp.arange(h)[:, None], foot_idx, :
    ].set(x_red.reshape(h, ms, 3))
