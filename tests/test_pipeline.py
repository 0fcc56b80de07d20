"""MPC pipeline tests: full / stance-compressed / pair-packed paths must all
match the float64 IPM oracle on the same formation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.mpc import pipeline
from tests import oracle

CFG = default_config()
H = 6


def _oracle_forces(inp):
    return oracle.mpc_step_forces(CFG, inp)


def test_full_compressed_packed_match_oracle():
    inputs = pipeline.random_inputs(jax.random.PRNGKey(2), 4, H)
    f_full = np.asarray(jax.jit(lambda i: pipeline.solve_batch(CFG, i))(inputs))
    f_red = np.asarray(
        jax.jit(lambda i: pipeline.solve_compressed_batch(CFG, i, 2))(inputs)
    )
    f_pack = np.asarray(jax.jit(lambda i: pipeline.solve_packed_batch(CFG, i))(inputs))
    for b in range(4):
        inp = jax.tree.map(lambda x: x[b], inputs)
        want = _oracle_forces(inp)
        # step-0 forces are what the controller consumes
        np.testing.assert_allclose(f_full[b, 0], want[0], atol=0.7)
        np.testing.assert_allclose(f_red[b, 0], want[0], atol=0.7)
        np.testing.assert_allclose(f_pack[b, 0], want[0], atol=0.7)


def test_compressed_swing_forces_zero():
    inputs = pipeline.random_inputs(jax.random.PRNGKey(3), 2, H)
    f = np.asarray(jax.jit(lambda i: pipeline.solve_packed_batch(CFG, i))(inputs))
    gait = np.asarray(inputs.gait_table)
    assert np.abs(f[gait == 0]).max() < 1e-6  # structurally zero by scatter


@pytest.mark.parametrize("h,max_stance,pack,gait", [
    (10, 2, 2, "trot"),       # the flagship bench shape
    (16, 4, 1, "trot"),       # h=16 uncompressed (192-var)
    (16, 3, 1, "walking"),    # h=16 walking band (144-var)
    (16, 2, 2, "trot"),       # h=16 fast-trot band (pair-packed 192-var)
])
def test_packed_bench_shapes_match_oracle(h, max_stance, pack, gait):
    """solve_packed_batch at each bench shape, small batch, vs the f64
    oracle at the repo's 0.7 N step-0 gate, on the bench's input seeds
    (PRNGKey(0) at h=10, PRNGKey(1) at h=16).

    These are fixed regression inputs, not a sample: at h=16 the production
    budget (120 iterations, 3 polish rounds) misses this gate on a tail of
    ~1-2% of random scenarios (PERF.md, open questions)."""
    b = 4
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0 if h == 10 else 1),
                                    b, h)
    if gait == "walking":
        inputs = inputs.replace(gait_table=jnp.broadcast_to(
            jnp.asarray(pipeline.walking_band_gait(h)), (b, h, 4)))
    f = np.asarray(jax.jit(lambda i: pipeline.solve_packed_batch(
        CFG, i, max_stance=max_stance, pack=pack))(inputs))
    assert f.shape == (b, h, 4, 3) and np.isfinite(f).all()
    for s in range(b):
        want = oracle.mpc_step_forces(CFG, jax.tree.map(lambda x: x[s],
                                                        inputs))
        np.testing.assert_allclose(f[s, 0], want[0], atol=0.7)


def test_walking_band_gait_is_three_stance():
    tbl = pipeline.walking_band_gait(16)
    assert tbl.shape == (16, 4)
    assert set(np.unique(tbl)) <= {0.0, 1.0}
    per_step = tbl.sum(axis=1)
    assert per_step.max() == 3 and per_step.min() >= 1
    # every foot both swings and stands within the horizon
    assert (tbl.sum(axis=0) > 0).all() and (tbl.sum(axis=0) < 16).all()
