#!/usr/bin/env python
"""Single-robot control-cycle latency benchmark (BASELINE.md row 2: p99
within the 2 ms tick / ~26 ms MPC budget).

Measures, on the device JAX uses:

* host round-trip latency per tick: one dispatch of the jitted
  controller_step + sim_step (`sim/rollout.make_tick`) and one fetch of the
  torques, 200 times;
* device-side per-tick rate, from 40 asynchronously dispatched 13-tick MPC
  macro-cycles (one jitted scan each) with a single final fetch — the
  dispatch queue keeps the device busy, so wall/ticks ~= device time.

The closed-loop MPC solves use the temporally warm-started budget
(cfg.solver.warm_iterations), as in deployment. Prints one JSON line.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.control import controller as ctrl
from quadruped_ctrl_tpu.core.types import Command
from quadruped_ctrl_tpu.sim import engine
from quadruped_ctrl_tpu.sim.rollout import make_tick
from quadruped_ctrl_tpu.sim.terrain import Terrain
from quadruped_ctrl_tpu.utils import device
from quadruped_ctrl_tpu.utils.timer import LatencyRecorder


def main():
    device.enable_compile_cache()
    cfg = default_config(**{"mpc.h_max": 10})
    terrain = Terrain.plane()
    sim = engine.sim_init(cfg, terrain)
    state = ctrl.init_state(cfg)
    cmd = Command.create(0.5, 0.0, 0.0, gait_type=9, robot_mode=0)
    step = make_tick(cfg, terrain, cmd)

    t0 = time.perf_counter()
    state, sim, tau = step(state, sim)   # compile + warm up
    np.asarray(tau)
    compile_s = time.perf_counter() - t0

    rec = LatencyRecorder()
    for _ in range(200):
        t0 = time.perf_counter()
        state, sim, tau = step(state, sim)
        np.asarray(tau)              # force completion (host round trip)
        rec.record((time.perf_counter() - t0) * 1e3)
    host = rec.summary()

    @jax.jit
    def macro13(state, sim):
        def tick(carry, _):
            st, sm = carry
            sensors = engine.sensors_from_sim(cfg, sm)
            st, out = ctrl.controller_step(cfg, st, sensors, cmd)
            sm = engine.sim_step(cfg, sm, out, terrain)
            return (st, sm), jnp.sum(out.tau)
        (st, sm), taus = lax.scan(tick, (state, sim), None, length=13)
        return st, sm, jnp.sum(taus)

    n_macros = 40
    state, sim, acc = macro13(state, sim)
    np.asarray(acc)                  # compile + drain
    t0 = time.perf_counter()
    for _ in range(n_macros):
        state, sim, acc = macro13(state, sim)
    np.asarray(acc)
    per_tick_ms = (time.perf_counter() - t0) / (n_macros * 13) * 1e3

    report = {
        "metric": "control_cycle_latency",
        "host_roundtrip_p50_ms": host["p50_ms"],
        "host_roundtrip_p99_ms": host["p99_ms"],
        "device_per_tick_ms": per_tick_ms,
        "device_method": "13-tick scanned MPC macro-cycle x40, single fetch",
        "tick_budget_ms": 2.0,
        "mpc_budget_ms": 26.0,
        "compile_s": compile_s,
        "device": device.device_summary(),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
