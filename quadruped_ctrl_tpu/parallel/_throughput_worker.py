"""Multi-process throughput worker (launched by multihost.multiprocess_scaling).

Each process owns `devs_per_proc` virtual CPU devices; all processes run the
same sharded fast-path MPC program over the global mesh (cross-process
collectives via Gloo — the CPU harness for the multi-host axis).
Process 0 writes {"solves_per_s": ...} to the output path.

Usage: python -m quadruped_ctrl_tpu.parallel._throughput_worker \
           <pid> <nproc> <port> <devs_per_proc> <per_device_batch> <reps> <out>
"""

import json
import os
import sys
import time


def main():
    pid, nproc, port, devs, pdb, reps = (int(a) for a in sys.argv[1:7])
    out_path = sys.argv[7]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            f"localhost:{port}", num_processes=nproc, process_id=pid
        )

    import numpy as np

    from quadruped_ctrl_tpu.config import default_config
    from quadruped_ctrl_tpu.mpc import pipeline
    from quadruped_ctrl_tpu.parallel import mesh as mesh_mod

    cfg = default_config()
    h = 10
    n_glob = nproc * devs
    batch = n_glob * pdb
    mesh = mesh_mod.make_mesh(n_glob)
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)
    sh = mesh_mod.batch_sharding(mesh)
    per_proc = batch // nproc
    lo = pid * per_proc

    def to_global(x):
        return jax.make_array_from_process_local_data(
            sh, np.asarray(x)[lo : lo + per_proc], x.shape
        )

    ginputs = jax.tree.map(to_global, inputs)
    fn = mesh_mod.sharded_mpc_solve(cfg, mesh, h)
    out = fn(ginputs)
    jax.block_until_ready(out)               # compile + implicit barrier
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(ginputs))
        samples.append(batch / (time.perf_counter() - t0))
    if pid == 0:
        med = float(np.median(samples))
        iqr = float(np.percentile(samples, 75) - np.percentile(samples, 25))
        with open(out_path, "w") as f:
            json.dump({"solves_per_s": med,
                       "rel_iqr": iqr / max(med, 1e-12),
                       "samples": samples}, f)


if __name__ == "__main__":
    main()
