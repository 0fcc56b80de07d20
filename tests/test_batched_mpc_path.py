"""The closed-loop batched MPC fast path (`mpc_update_batched`) must agree
with the per-lane reference path (`vmap(mpc_update)`): same formation, same
ADMM splitting, different execution schedule (batch-explicit solver vs
per-scenario solver under vmap). The polish drives both to the same active
set, so forces agree tightly."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.control import controller as ctrl
from quadruped_ctrl_tpu.core.types import Command, Sensors

CFG = default_config()
BATCH = 4


def _batched_states_ctx():
    key = jax.random.PRNGKey(0)

    def one(k):
        ks = jax.random.split(k, 4)
        q = jnp.tile(jnp.array([0.0, -0.8, 1.6], jnp.float32), (4,))
        q = q + jax.random.uniform(ks[0], (12,), jnp.float32, -0.05, 0.05)
        sensors = Sensors(
            quat=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
            gyro=jax.random.uniform(ks[1], (3,), jnp.float32, -0.1, 0.1),
            accelerometer=jnp.array([0.0, 0.0, 9.8], jnp.float32),
            q=q,
            qd=jax.random.uniform(ks[2], (12,), jnp.float32, -0.2, 0.2),
        )
        vx = jax.random.uniform(ks[3], (), jnp.float32, 0.0, 0.8)
        cmd = Command(
            vel=jnp.stack([vx, 0.0 * vx, 0.0 * vx]),
            gait_type=jnp.asarray(9, jnp.int32),
            robot_mode=jnp.asarray(0, jnp.int32),
        )
        state = ctrl.init_state(CFG)
        # a few ticks to land in a realistic mid-gait state
        for _ in range(3):
            state, ctx = ctrl.control_tick(CFG, state, sensors, cmd)
        return state, ctx

    return jax.vmap(one)(jax.random.split(key, BATCH))


def test_batched_matches_per_lane():
    states, ctx = _batched_states_ctx()
    per_lane = jax.vmap(
        lambda s, c: ctrl.mpc_update(CFG, s, c, iterations=120)
    )(states, ctx)
    batched = ctrl.mpc_update_batched(CFG, states, ctx, iterations=120)

    fr_a = np.asarray(per_lane.core.locomotion.fr_des)
    fr_b = np.asarray(batched.core.locomotion.fr_des)
    assert np.all(np.isfinite(fr_b))
    np.testing.assert_allclose(fr_b, fr_a, atol=0.15)

    np.testing.assert_allclose(
        np.asarray(batched.core.locomotion.f_ff),
        np.asarray(per_lane.core.locomotion.f_ff), atol=0.15,
    )
    # bookkeeping fields update identically
    np.testing.assert_allclose(
        np.asarray(batched.core.locomotion.world_position_desired),
        np.asarray(per_lane.core.locomotion.world_position_desired),
        atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(batched.core.locomotion.mpc_fail_count),
        np.asarray(per_lane.core.locomotion.mpc_fail_count),
    )


def test_packed_compressed_matches_full():
    """The stance-compressed + pair-packed closed-loop path (max_stance=2,
    the bench pipeline's solve shape) must agree with the uncompressed
    batched path on 2-stance (trot) tables — the same-minimizer guarantee of
    the reference's swing-variable elimination (SolverMPC.cpp:441-525)."""
    states, ctx = _batched_states_ctx()
    full = ctrl.mpc_update_batched(CFG, states, ctx, h_sol=10, iterations=120)
    packed = ctrl.mpc_update_batched(
        CFG, states, ctx, h_sol=10, iterations=120, max_stance=2
    )
    fr_a = np.asarray(full.core.locomotion.fr_des)
    fr_b = np.asarray(packed.core.locomotion.fr_des)
    assert np.all(np.isfinite(fr_b))
    np.testing.assert_allclose(fr_b, fr_a, atol=0.15)
    np.testing.assert_allclose(
        np.asarray(packed.core.locomotion.f_ff),
        np.asarray(full.core.locomotion.f_ff), atol=0.15,
    )
    np.testing.assert_allclose(
        np.asarray(packed.core.locomotion.world_position_desired),
        np.asarray(full.core.locomotion.world_position_desired), atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(packed.core.locomotion.mpc_fail_count),
        np.asarray(full.core.locomotion.mpc_fail_count),
    )
    # the packed path stores its warm triple in the full layout: stance-foot
    # x entries match the solved forces (normalized), swing entries are zero
    wx = np.asarray(packed.core.locomotion.mpc_warm_x)
    assert np.all(np.isfinite(wx))


def test_packed_rollout_tracks_full_rollout():
    """Closed-loop: a short trot rollout through the packed solver stays on
    the uncompressed rollout's trajectory."""
    import jax.numpy as jnp
    from quadruped_ctrl_tpu.sim import batch_rollout as br

    batch = 2
    key = jax.random.PRNGKey(3)
    terr = br.batch_terrains(batch, key, kinds=("plane",))
    states, sims = br.batch_init(CFG, terr, batch)
    cmds = Command(
        vel=jnp.tile(jnp.array([[0.4, 0.0, 0.0]], jnp.float32), (batch, 1)),
        gait_type=jnp.full((batch,), 9, jnp.int32),
        robot_mode=jnp.zeros((batch,), jnp.int32),
    )
    outs = {}
    for ms in (None, 2):
        s, m, recs = br.batch_rollout(
            CFG, states, sims, cmds, terr, 3, h_sol=10, max_stance=ms
        )
        outs[ms] = (np.asarray(m.p), np.asarray(recs["safety"]))
    p_full, safe_full = outs[None]
    p_packed, safe_packed = outs[2]
    assert np.all(safe_packed[-1]) and np.all(safe_full[-1])
    np.testing.assert_allclose(p_packed, p_full, atol=0.02)


def test_batched_h_sol_10_matches_full_when_mpc_h_10():
    states, ctx = _batched_states_ctx()
    # force the sticky horizon to 10 (the reference demo's steady state)
    loco = states.core.locomotion.replace(
        mpc_h=jnp.full((BATCH,), 10, jnp.int32)
    )
    states = states.replace(core=states.core.replace(locomotion=loco))
    full = ctrl.mpc_update_batched(CFG, states, ctx, iterations=120)
    h10 = ctrl.mpc_update_batched(CFG, states, ctx, h_sol=10, iterations=120)
    np.testing.assert_allclose(
        np.asarray(h10.core.locomotion.fr_des),
        np.asarray(full.core.locomotion.fr_des), atol=0.15,
    )
