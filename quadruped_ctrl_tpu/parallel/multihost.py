"""Multi-host runtime + scaling-efficiency reporting.

The reference has no distributed execution at all (SURVEY.md §2.8); these
are the multi-host components: `jax.distributed` bring-up for same-program
SPMD across hosts, and a scaling report measuring batched-MPC throughput at
increasing device counts. Collectives ride XLA (psum within a host and
across hosts).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.mpc import pipeline
from quadruped_ctrl_tpu.parallel import mesh as mesh_mod


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Bring up multi-host JAX (no-op for single-process runs).

    Pass all three arguments explicitly (e.g. coordinator
    "localhost:<port>"); nothing here auto-detects a cluster.
    """
    if num_processes is None and coordinator_address is None:
        return False  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def _throughput(cfg: FrameworkConfig, n_devices: int, per_device_batch: int,
                h: int, reps: int):
    """Per-rep solves/s samples for a batch sharded over the first
    n_devices. Returns a list of `reps` independent measurements so callers
    can report medians and spread (shared-core virtual devices are noisy;
    a single min/mean hides that)."""
    m = mesh_mod.make_mesh(n_devices)
    batch = n_devices * per_device_batch
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)
    inputs = mesh_mod.shard_batch(inputs, m)
    fn = mesh_mod.sharded_mpc_solve(cfg, m, h)
    np.asarray(fn(inputs)[1])               # compile + warm up (host fetch)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn(inputs)[1])
        samples.append(batch / (time.perf_counter() - t0))
    return samples


def _median_spread(samples):
    med = float(np.median(samples))
    return med, float((np.percentile(samples, 75)
                       - np.percentile(samples, 25)) / max(med, 1e-12))


def multiprocess_scaling(num_processes: int = 2, devs_per_proc: int = 2,
                         per_device_batch: int = 64, reps: int = 3,
                         timeout_s: float = 540.0) -> dict:
    """N-process weak-scaling efficiency via real `jax.distributed` CPU
    processes (Gloo collectives — the cluster-free multi-host harness,
    SURVEY.md §4 item 5). Launches 1-process and N-process runs of the same
    sharded fast-path program and reports throughput + efficiency. CPU
    only: every worker pins the CPU backend, so the report's `backend` is
    always "cpu"."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def run_group(nproc: int, devs: int) -> float:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "rate.json")
            procs = []
            for pid in range(nproc):
                env = dict(os.environ)
                env.pop("XLA_FLAGS", None)
                env.pop("JAX_PLATFORMS", None)
                env["PYTHONPATH"] = repo + os.pathsep + env.get(
                    "PYTHONPATH", "")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "quadruped_ctrl_tpu.parallel._throughput_worker",
                     str(pid), str(nproc), str(port), str(devs),
                     str(per_device_batch), str(reps), out],
                    cwd=repo, env=env,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                ))
            for p in procs:
                p.wait(timeout=timeout_s)
                if p.returncode != 0:
                    raise RuntimeError(
                        f"worker exited {p.returncode} (nproc={nproc})")
            with open(out) as f:
                d = json.load(f)
                return d["solves_per_s"], d.get("rel_iqr", 0.0)

    # Same GLOBAL mesh (num_processes * devs_per_proc devices) and same
    # global batch both times; only the process split differs. On this
    # shared-core CPU harness that isolates the cross-process collective
    # overhead (the cross-host cost), which is the axis virtual devices CAN
    # measure — raw weak scaling cannot be (all virtual devices share the
    # same physical cores).
    t1, s1 = run_group(1, num_processes * devs_per_proc)
    tn, sn = run_group(num_processes, devs_per_proc)
    eff = tn / t1
    rep = {
        "backend": "cpu",
        "processes": num_processes,
        "devices_per_process": devs_per_proc,
        "global_devices": num_processes * devs_per_proc,
        "solves_per_s_single_process": round(t1, 1),
        "solves_per_s_multi_process": round(tn, 1),
        "rel_iqr": round(max(s1, sn), 4),
        "statistic": "median of per-rep timings (workers report samples)",
        "cross_process_efficiency": round(eff, 4),
    }
    if eff > 1.05:
        # splitting the same work over more processes cannot genuinely beat
        # the single process on shared cores: flag as measurement noise
        rep["noise"] = True
    return rep


def scaling_report(cfg: FrameworkConfig, device_counts=None,
                   per_device_batch: int = 256, h: int = 10,
                   reps: int = 10) -> dict:
    """Scaling report across device counts.

    Two efficiencies per row:
    * `sharding_efficiency` — throughput of the batch sharded over n devices
      vs the SAME total batch on one device. This isolates the partitioning
      + collective overhead, and is meaningful on ANY backend (on the
      virtual-CPU test mesh all devices share the same physical cores, so
      compute capacity does not grow with n and this is the measurable
      axis).
    * `weak_efficiency` — throughput(n) / (n * throughput(1)) at fixed
      per-device batch. Only meaningful when devices are real cards;
      reported for completeness and labeled by `backend`.

    Statistics: every throughput is the MEDIAN of `reps` independent
    timings, each row carries the relative interquartile spread of its
    samples, and any efficiency > 1.05 is flagged `noise: true` (a sharded
    run cannot genuinely beat the same batch unsharded — on shared-core
    virtual devices such rows measure scheduler noise, not speedup).
    """
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    base = None
    rows = []
    for n in device_counts:
        rate, spread = _median_spread(
            _throughput(cfg, n, per_device_batch, h, reps))
        if n == 1:
            rate_1dev, spread_1 = rate, spread
        else:
            rate_1dev, spread_1 = _median_spread(
                _throughput(cfg, 1, n * per_device_batch, h, reps))
        if base is None:
            base = rate
        sh_eff = rate / rate_1dev
        row = {
            "devices": n,
            "solves_per_s": round(rate, 1),
            "rel_iqr": round(max(spread, spread_1), 4),
            "sharding_efficiency": round(sh_eff, 4),
            "weak_efficiency": round(rate / (base * n), 4),
        }
        if sh_eff > 1.05:
            row["noise"] = True
        rows.append(row)
    return {
        "metric": "mpc_scaling",
        "backend": jax.default_backend(),
        "shared_core_virtual_devices": jax.default_backend() == "cpu",
        "per_device_batch": per_device_batch,
        "reps": reps,
        "statistic": "median of reps; rel_iqr = IQR/median",
        "horizon": h,
        "rows": rows,
    }
