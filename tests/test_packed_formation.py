"""`formation.qp_cost_packed` (batched sqrt-S-folded cost + block-diagonal
embedding, what `pipeline.solve_packed_batch` feeds the solver) against the
per-scenario compressed formation `qp_cost_compressed_nil`, at the bench
shapes, with a non-trivial step mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.mpc import formation, pipeline

CFG = default_config()


@pytest.mark.parametrize("h,ms,pack,b", [
    (10, 2, 2, 8),      # the flagship bench shape (120-var pairs)
    (16, 2, 2, 4),      # h=16 fast-trot band (192-var pairs)
    (16, 3, 1, 3),      # h=16 walking band (144-var)
    (16, 4, 1, 2),      # h=16 uncompressed (192-var)
    (10, 2, 2, 6),      # odd number of packed systems
])
def test_packed_cost_matches_per_scenario_formation(h, ms, pack, b):
    inputs = pipeline.random_inputs(jax.random.PRNGKey(h * ms + pack), b, h)
    if ms == 3:
        inputs = inputs.replace(gait_table=jnp.broadcast_to(
            jnp.asarray(pipeline.walking_band_gait(h)), (b, h, 4)))
    adt, bdt = formation.srb_discrete(
        CFG.mpc, inputs.r_feet, inputs.rpy[:, 2], inputs.x_drag, CFG.dt_mpc)
    x0 = formation.build_x0(inputs.rpy, inputs.position, inputs.omega_world,
                            inputs.v_world, CFG.mpc.gravity)
    foot_idx, _, sel = formation.stance_selectors(inputs.gait_table, ms)
    mask = np.ones((b, h), np.float32)
    mask[:, -2:] = 0.0                       # exercise the step mask rows
    mask = jnp.asarray(mask)

    kp, gp = formation.qp_cost_packed(
        CFG.mpc, adt, bdt, x0, inputs.traj, mask, sel, pack)
    n_c = 3 * ms * h
    assert kp.shape == (b // pack, pack * n_c, pack * n_c)
    assert gp.shape == (b // pack, pack * n_c)

    hs, gs = jax.vmap(
        lambda a, bb, x, xd, m, fi: formation.qp_cost_compressed_nil(
            CFG.mpc, a, bb, x, xd, m, fi)
    )(adt, bdt, x0, inputs.traj, mask, foot_idx)
    kp, gp = np.asarray(kp), np.asarray(gp)
    hs, gs = np.asarray(hs), np.asarray(gs)
    scale_h = np.abs(hs).max()
    for s in range(b):
        blk = slice((s % pack) * n_c, (s % pack + 1) * n_c)
        np.testing.assert_allclose(kp[s // pack][blk, blk], hs[s],
                                   atol=1e-5 * scale_h)
        np.testing.assert_allclose(gp[s // pack][blk], gs[s],
                                   atol=1e-5 * np.abs(gs).max())
    # scenarios never couple: every off-diagonal block is exactly zero
    for j in range(pack):
        for k in range(pack):
            if j != k:
                assert not kp[:, j * n_c:(j + 1) * n_c,
                              k * n_c:(k + 1) * n_c].any()
    assert np.abs(kp - np.swapaxes(kp, -1, -2)).max() < 1e-6 * scale_h
