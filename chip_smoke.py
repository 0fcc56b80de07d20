#!/usr/bin/env python
"""Smoke test of the system's user paths on an NVIDIA GPU.

    python chip_smoke.py           # phases 0-5 on one card
    python chip_smoke.py --multi   # phase 0 + the sharded solve on 4 cards

Phases, in order, each printing one JSON line:

0. device   — refuses anything but a GPU; JAX version, XLA_FLAGS, and the
              card's name and power limit from nvidia-smi.
1. flagship — `pipeline.solve_packed_batch` at h=10, batch 4096 (the bench
              shape): compile time, steady call times, memory, finite
              forces, and 32 scenarios against the float64 oracle.
2. h16      — the three h=16 bench shapes at batch 2048, same checks on
              16 scenarios each.
3. loop     — `rollout.run_session` (what `cli sim` runs), trot at
              0.5 m/s on a plane for 2000 ticks, held to the healthy-run
              criteria; then 200 host round trips of one jitted tick.
4. sweep    — `cli sweep` at batch 4096 (16 stand macros + 25 sweep
              macros): survival, robot ticks/s, compile time.
5. native   — the reference C ABI (`runtime.native.NativeController`):
              torques tick by tick against a direct `controller_step`.

--multi runs only phase 0 and the 4-card `parallel.mesh.sharded_mpc_solve`
against one card solving the same batch.

Any failed check raises, so the script exits non-zero and never prints the
last line, which is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Every phase is a plain function of its sizes; the CPU tests call them at
tiny sizes. Times are labelled with the card's nvidia-smi line.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.mpc import pipeline
from quadruped_ctrl_tpu.utils import device

ORACLE_ATOL_N = 0.7      # step-0 force gate vs the f64 oracle (test_pipeline)
# Native ABI vs direct controller_step, per tick from the same state and
# sensors: both run the same f32 program; they are two separately compiled
# XLA programs (the native one builds Sensors inside its jit), so fusion
# may reorder f32 sums (~1e-6 relative). 1e-3 N*m is ~1e-4 of the joint
# torque scale and far above that rounding.
NATIVE_ATOL_NM = 1e-3
# 4-card sharded solve vs one card on the same batch: the same f32
# algorithm at another batch width, so only reduction order differs; the
# per-scenario gate is the oracle gate, the psum'd mean |f| is held to 1e-4.
MULTI_ATOL_N = ORACLE_ATOL_N
MULTI_MEAN_RTOL = 1e-4


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(record):
    print(json.dumps(record, default=float), flush=True)


_COMPILE_EVENTS = {
    "/jax/core/compile/jaxpr_trace_duration": "trace_s",
    "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower_s",
    "/jax/core/compile/backend_compile_duration": "backend_compile_s",
}


@contextlib.contextmanager
def compile_clock():
    """Sums JAX's tracing, lowering and backend-compile durations inside the
    block, per kind, into the yielded dict. (Tracing of a jit nested in
    another is counted in both, so "trace_s" can exceed the host time it
    took; lowering and backend compiles are not nested.)"""
    acc = dict.fromkeys(_COMPILE_EVENTS.values(), 0.0)

    def listen(name, secs, **_):
        if name in _COMPILE_EVENTS:
            acc[_COMPILE_EVENTS[name]] += secs

    jax.monitoring.register_event_duration_secs_listener(listen)
    try:
        yield acc
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)


def _memory(compiled):
    stats = compiled.memory_analysis()
    if stats is None:
        return None
    return {k: getattr(stats, k) for k in dir(stats)
            if k.endswith("_in_bytes")}


def _peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def compile_and_time(fn, args, n_steady):
    """AOT-compile `fn` for `args`, run it once, then `n_steady` timed
    calls each ending in block_until_ready. Returns (last output, record)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(n_steady):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, {
        "compile_s": compile_s,
        "steady_s": times,
        "steady_median_s": float(np.median(times)) if times else None,
        "memory_analysis": _memory(compiled),
        "peak_bytes_in_use": _peak_bytes(),
    }


def _load_oracle():
    """tests/oracle.py, loaded by path: a `tests` package elsewhere on
    sys.path must not shadow it."""
    import importlib.util

    path = device.REPO_ROOT / "tests" / "oracle.py"
    spec = importlib.util.spec_from_file_location("qct_f64_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_gate(cfg, inputs, forces, n, atol=ORACLE_ATOL_N):
    """Step-0 forces of the first n scenarios vs the float64 optimum
    (tests/oracle.py, the construction of tests/test_pipeline.py)."""
    oracle = _load_oracle()
    f = np.asarray(forces)
    check(np.isfinite(f).all(), "non-finite forces")
    host = jax.tree.map(np.asarray, inputs)
    errs = [
        float(np.abs(f[b, 0] - oracle.mpc_step_forces(
            cfg, jax.tree.map(lambda x: x[b], host))[0]).max())
        for b in range(n)
    ]
    worst = max(errs)
    check(worst <= atol, f"oracle: worst step-0 force error {worst} N "
                         f"> {atol} N (per scenario: {errs})")
    return {"oracle_scenarios": n, "oracle_worst_err_N": worst,
            "oracle_atol_N": atol}


def phase_device(multi=False):
    """Phase 0. Raises SystemExit (non-zero) unless JAX's devices are GPUs,
    four of them with `multi`."""
    dev = device.device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX's default "
                         f"device is {dev['platform']!r} ({dev['kind']})")
    need = 4 if multi else 1
    if dev["count"] < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, JAX sees "
                         f"{dev['count']}")
    return {"phase": "device", **dev, "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "card": device.card_info()}


def _solve_fn(cfg, max_stance, pack):
    return lambda i: pipeline.solve_packed_batch(
        cfg, i, max_stance=max_stance, pack=pack)


def phase_flagship(batch=4096, h=10, n_oracle=32, n_steady=5, card=None):
    """Phase 1: the bench's flagship solve."""
    cfg = default_config()
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)
    forces, rec = compile_and_time(_solve_fn(cfg, 2, 2), (inputs,), n_steady)
    rec.update(oracle_gate(cfg, inputs, forces, n_oracle))
    return {"phase": "flagship", "batch": batch, "h": h, "max_stance": 2,
            "pack": 2, **rec, "card": card}


def phase_h16(batch=2048, n_oracle=16, n_steady=3, card=None):
    """Phase 2: the three h=16 bench shapes."""
    cfg = default_config()
    h = 16
    inputs = pipeline.random_inputs(jax.random.PRNGKey(1), batch, h)
    walking = inputs.replace(gait_table=jnp.broadcast_to(
        jnp.asarray(pipeline.walking_band_gait(h)), (batch, h, 4)))
    shapes = []
    for name, ms, pack, inp in (("full", 4, 1, inputs),
                                ("walking_band", 3, 1, walking),
                                ("fast_trot", 2, 2, inputs)):
        forces, rec = compile_and_time(_solve_fn(cfg, ms, pack), (inp,),
                                       n_steady)
        rec.update(oracle_gate(cfg, inp, forces, n_oracle))
        shapes.append({"shape": name, "max_stance": ms, "pack": pack, **rec})
    return {"phase": "h16", "batch": batch, "h": h, "shapes": shapes,
            "card": card}


def check_loop_metrics(m):
    """The healthy-run criteria of a 0.5 m/s trot session."""
    check(m["vx_err"] < 0.05, f"vx_err {m['vx_err']} >= 0.05")
    check(m["height_err"] < 0.03, f"height {m['height_mean']} not ~0.25")
    check(m["safety_ok"] and not m["fell"], "safety tripped or fell")


def phase_loop(ticks=2000, n_roundtrips=200, gate=True, card=None):
    """Phase 3: the single-robot closed loop, then host round trips of one
    jitted tick (bench_latency's shape)."""
    from quadruped_ctrl_tpu.control import controller as ctrl
    from quadruped_ctrl_tpu.core.types import Command
    from quadruped_ctrl_tpu.sim import engine, rollout
    from quadruped_ctrl_tpu.sim.terrain import Terrain
    from quadruped_ctrl_tpu.utils.metrics import tracking_metrics
    from quadruped_ctrl_tpu.utils.timer import LatencyRecorder

    cfg = default_config()
    terrain = Terrain.plane()
    cmd = Command.create(0.5, 0.0, 0.0, gait_type=9, robot_mode=0)
    t0 = time.perf_counter()
    with compile_clock() as cc:
        _, _, traj = jax.block_until_ready(
            rollout.run_session(cfg, terrain, cmd, n_ticks=ticks))
    wall = time.perf_counter() - t0
    m = tracking_metrics(traj, (0.5, 0.0), cfg.control.body_height)
    check(all(np.isfinite(np.asarray(v)).all() for v in traj.values()),
          "non-finite trajectory")
    if gate:
        check_loop_metrics(m)

    cfg10 = default_config(**{"mpc.h_max": 10})
    step = rollout.make_tick(cfg10, terrain, cmd)
    state, sim = ctrl.init_state(cfg10), engine.sim_init(cfg10, terrain)
    with compile_clock() as cc_tick:
        state, sim, tau = step(state, sim)
        np.asarray(tau)
    rec = LatencyRecorder()
    for _ in range(n_roundtrips):
        t0 = time.perf_counter()
        state, sim, tau = step(state, sim)
        tau = np.asarray(tau)
        rec.record((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(tau).all(), "non-finite torques")
    lat = rec.summary()
    return {"phase": "loop", "ticks": ticks, **m,
            "session_wall_s": wall, "session_compile": cc,
            "tick_compile": cc_tick,
            "roundtrips": n_roundtrips, "roundtrip_p50_ms": lat["p50_ms"],
            "roundtrip_p99_ms": lat["p99_ms"], "card": card}


def phase_sweep(batch=4096, macros=25, min_survival=0.99, card=None):
    """Phase 4: the `cli sweep` program (trot, plane, 16 stand macros,
    then `macros` sweep macros)."""
    from quadruped_ctrl_tpu import cli

    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "sweep.jsonl")
        with compile_clock() as cc:
            rc = cli.main(["sweep", "--batch", str(batch), "--macros",
                           str(macros), "--log", log])
        with open(log) as f:
            m = json.loads(f.readline())
    check(rc == 0, f"cli sweep exited {rc}")
    check(m["survival_rate"] >= min_survival,
          f"survival {m['survival_rate']} < {min_survival}")
    # cli's own wall clock and rate include compilation, which dominates a
    # short sweep; `compile` says how much of the phase it took
    return {"phase": "sweep", "batch": batch, "stand_macros": 16,
            "macros": macros, "survival_rate": m["survival_rate"],
            "safety_rate": m["safety_rate"],
            "cli_wall_s": m["wall_seconds"],
            "robot_ticks_per_s_incl_compile": m["robot_ticks_per_s"],
            "compile": cc, "card": card}


def phase_native(n_pre=10, n_ticks=50, atol=NATIVE_ATOL_NM, card=None):
    """Phase 5: init_controller, pre_work x n_pre, torque_calculator x
    n_ticks through the C ABI; each tick's torques against a direct
    controller_step from the same state on the same sensors."""
    from quadruped_ctrl_tpu.control import controller as ctrl
    from quadruped_ctrl_tpu.core.types import Command, Sensors
    from quadruped_ctrl_tpu.runtime.native import NativeController
    from quadruped_ctrl_tpu.sim import engine
    from quadruped_ctrl_tpu.sim.terrain import Terrain

    cfg = default_config()
    s = engine.sensors_from_sim(cfg, engine.sim_init(cfg, Terrain.plane()))
    imu = np.concatenate([np.asarray(s.accelerometer), np.asarray(s.quat),
                          np.asarray(s.gyro)]).astype(np.float64)
    leg = np.concatenate([np.asarray(s.q), np.asarray(s.qd)]).astype(
        np.float64)
    sensors = Sensors(quat=jnp.asarray(imu[3:7]), gyro=jnp.asarray(imu[7:10]),
                      accelerometer=jnp.asarray(imu[0:3]),
                      q=jnp.asarray(leg[0:12]), qd=jnp.asarray(leg[12:24]))
    # the runtime's default command: gait 9 (trot), mode 0, zero velocity
    cmd = Command(vel=jnp.zeros(3, jnp.float32),
                  gait_type=jnp.asarray(9, jnp.int32),
                  robot_mode=jnp.asarray(0, jnp.int32))
    direct = jax.jit(partial(ctrl.controller_step, cfg))

    nc = NativeController(cfg)
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    for _ in range(n_pre):
        nc.pre_work(imu, leg)
    errs = []
    for _ in range(n_ticks):
        before = nc._state
        tau = nc.torque_calculator(imu, leg)
        check(np.isfinite(tau).all(), "non-finite native torques")
        _, out = direct(before, sensors, cmd)
        errs.append(float(np.abs(tau - np.asarray(out.tau)).max()))
    worst = max(errs)
    check(worst <= atol, f"native vs direct: {worst} N*m > {atol} N*m")
    return {"phase": "native", "pre_work": n_pre, "ticks": n_ticks,
            "worst_err_Nm": worst, "atol_Nm": atol,
            "latency_us": nc.latency_summary(), "card": card}


def phase_multi(per_device=4096, n_devices=4, h=10, n_steady=3, card=None):
    """4-card phase: the sharded scenario solve against one card solving
    the same batch."""
    from quadruped_ctrl_tpu.parallel import mesh

    check(len(jax.devices()) >= n_devices,
          f"needs {n_devices} devices, have {len(jax.devices())}")
    cfg = default_config()
    batch = n_devices * per_device
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)
    m = mesh.make_mesh(n_devices)
    sharded = mesh.sharded_mpc_solve(cfg, m, h)
    sh_inputs = mesh.shard_batch(inputs, m)
    t0 = time.perf_counter()
    compiled = sharded.lower(sh_inputs).compile()
    compile_s = time.perf_counter() - t0
    f_sh, mean_sh = jax.block_until_ready(compiled(sh_inputs))
    times = []
    for _ in range(n_steady):
        t0 = time.perf_counter()
        f_sh, mean_sh = jax.block_until_ready(compiled(sh_inputs))
        times.append(time.perf_counter() - t0)

    one = jax.device_put(inputs, jax.devices()[0])
    f_one, rec_one = compile_and_time(_solve_fn(cfg, 2, 2), (one,), n_steady)
    f_sh, f_one = np.asarray(f_sh), np.asarray(f_one)
    check(np.isfinite(f_sh).all(), "non-finite sharded forces")
    err = np.abs(f_sh - f_one).max(axis=(1, 2, 3))
    mean_one = float(np.mean(np.abs(f_one)))
    mean_rel = abs(float(mean_sh) - mean_one) / mean_one
    check(err.max() <= MULTI_ATOL_N,
          f"sharded vs one card: {err.max()} N > {MULTI_ATOL_N} N")
    check(mean_rel <= MULTI_MEAN_RTOL,
          f"psum'd mean |f| off by {mean_rel} > {MULTI_MEAN_RTOL}")
    return {"phase": "multi", "devices": n_devices, "batch": batch, "h": h,
            "compile_s": compile_s, "steady_s": times,
            "one_card_steady_s": rec_one["steady_s"],
            "worst_err_N": float(err.max()),
            "scenarios_over_1e-3N": int((err > 1e-3).sum()),
            "atol_N": MULTI_ATOL_N, "mean_abs_f": float(mean_sh),
            "mean_rel_err": mean_rel, "mean_rtol": MULTI_MEAN_RTOL,
            "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded solve (needs 4 GPUs)")
    args = ap.parse_args(argv)
    device.enable_compile_cache()
    dev = phase_device(multi=args.multi)
    card = dev["card"]
    print(card, flush=True)
    emit(dev)
    if args.multi:
        emit(phase_multi(card=card))
    else:
        for phase in (phase_flagship, phase_h16, phase_loop, phase_sweep,
                      phase_native):
            emit(phase(card=card))
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
