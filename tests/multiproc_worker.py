"""Worker for the multi-process `jax.distributed` CPU smoke test.

Each of N processes owns `devs_per_proc` virtual CPU devices; together they
form one global mesh (cross-process collectives ride Gloo — the CPU stand-in
for cross-host collectives, SURVEY.md §4 item 5). The worker solves its shard of a global
MPC batch through the sharded fast path, checks it against a local
single-process solve of the same lanes, checks the psum'd statistic against
the global value, and writes a JSON report.

Usage: multiproc_worker.py <pid> <nproc> <port> <devs_per_proc> <out.json>
"""

import json
import os
import sys


def main():
    pid, nproc, port, devs_per_proc = (int(a) for a in sys.argv[1:5])
    out_path = sys.argv[5]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs_per_proc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )

    import numpy as np
    import jax.numpy as jnp

    from quadruped_ctrl_tpu.config import default_config
    from quadruped_ctrl_tpu.mpc import pipeline
    from quadruped_ctrl_tpu.parallel import mesh as mesh_mod

    assert len(jax.devices()) == nproc * devs_per_proc
    assert len(jax.local_devices()) == devs_per_proc

    cfg = default_config()
    h, per_dev = 10, 2
    n_glob = nproc * devs_per_proc
    batch = n_glob * per_dev
    mesh = mesh_mod.make_mesh(n_glob)

    # deterministic inputs: every process builds the same global batch, then
    # assembles the global sharded array from its local slice
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)
    sh = mesh_mod.batch_sharding(mesh)
    per_proc = batch // nproc
    lo = pid * per_proc

    def to_global(x):
        local = np.asarray(x)[lo : lo + per_proc]
        return jax.make_array_from_process_local_data(sh, local, x.shape)

    ginputs = jax.tree.map(to_global, inputs)
    fn = mesh_mod.sharded_mpc_solve(cfg, mesh, h, iterations=60)
    forces, mean_abs = fn(ginputs)
    jax.block_until_ready(forces)

    # local shards vs a single-process solve of the same lanes
    shards = sorted(forces.addressable_shards, key=lambda s: s.index[0].start)
    got = np.concatenate([np.asarray(s.data) for s in shards])
    ref_in = jax.tree.map(lambda x: x[lo : lo + per_proc], inputs)
    ref = np.asarray(
        pipeline.solve_packed_batch(cfg, ref_in, iterations=60)
    )
    max_err = float(np.abs(got - ref).max())

    # psum correctness: the replicated statistic must equal the global mean
    full_ref = np.asarray(
        pipeline.solve_packed_batch(cfg, inputs, iterations=60)
    )
    psum_rel_err = float(
        abs(float(mean_abs) - np.abs(full_ref).mean())
        / max(np.abs(full_ref).mean(), 1e-9)
    )

    with open(out_path, "w") as f:
        json.dump(
            {
                "pid": pid,
                "global_devices": len(jax.devices()),
                "max_err": max_err,
                "psum_rel_err": psum_rel_err,
            },
            f,
        )


if __name__ == "__main__":
    main()
