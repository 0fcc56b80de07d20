"""Device mesh + sharding helpers: scenario data-parallelism across devices.

The reference has no distributed anything (SURVEY.md §2.8); these are the
new scale-out components: a ("dp", "mp") mesh, batch sharding of the
MPC/scenario pipelines via shard_map, and psum'd metric reductions (XLA
collectives; on GPUs they lower to NCCL).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.mpc import pipeline


def make_mesh(n_devices: int | None = None, mp: int = 1) -> Mesh:
    """A ("dp","mp") mesh over the first n devices. mp=1 keeps all devices on
    the data axis; mp>1 reserves an axis for model-style sharding."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    assert n % mp == 0
    grid = np.array(devs[:n]).reshape(n // mp, mp)
    return Mesh(grid, ("dp", "mp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Scenario batch sharded across BOTH mesh axes (pure data parallel)."""
    return NamedSharding(mesh, P(("dp", "mp")))


def shard_batch(tree, mesh: Mesh):
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def sharded_mpc_solve(cfg: FrameworkConfig, mesh: Mesh, h: int,
                      iterations: int | None = None, packed: bool = True,
                      max_stance: int = 2):
    """Returns a jitted function: sharded MPCInputs batch -> (forces, stats).

    Forces stay sharded; stats (mean |f|, count) are psum'd over the mesh —
    the cross-shard reduction exercising the collectives. With `packed`
    (default) each shard solves through the stance-compressed pair-packed
    fast path (pipeline.solve_packed_batch -> admm_mpc_batched); gait
    tables must then have <= max_stance stance feet per step
    (raise it for non-trot gaits), and odd per-shard batches fall back to
    the per-scenario vmap path (the differential reference, any gait).
    """
    spec = P(("dp", "mp"))

    def local(inp: pipeline.MPCInputs):
        if packed and inp.rpy.shape[0] % 2 == 0:
            forces = pipeline.solve_packed_batch(
                cfg, inp, max_stance=max_stance, iterations=iterations
            )
        else:
            forces = pipeline.solve_batch(cfg, inp, iterations=iterations)
        local_sum = jnp.sum(jnp.abs(forces))
        local_n = jnp.asarray(forces.size, jnp.float32)
        total = jax.lax.psum(local_sum, ("dp", "mp"))
        count = jax.lax.psum(local_n, ("dp", "mp"))
        return forces, total / count

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: spec, pipeline.MPCInputs(
            rpy=0, position=0, omega_world=0, v_world=0, r_feet=0, traj=0,
            gait_table=0, x_drag=0)),),
        out_specs=(spec, P()),
    )
    return jax.jit(fn)
