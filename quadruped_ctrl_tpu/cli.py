"""Command-line entry points — the replacement for the reference's ROS
launch/param/topic surface (launch/quadruped_ctrl.launch,
config/quadruped_ctrl_config.yaml, gait_type/robot_mode services, cmd_vel):

    python -m quadruped_ctrl_tpu.cli sim   --gait trot --vx 0.5 --terrain plane
    python -m quadruped_ctrl_tpu.cli sweep --batch 256 --terrains plane,random
    python -m quadruped_ctrl_tpu.cli bench

Gait names follow the reference numbering (ConvexMPCLocomotion.cpp:149-172).
A YAML config file (--config) overrides any FrameworkConfig field with
dotted keys, e.g. `mpc.horizon: 10`.
"""

from __future__ import annotations

import argparse
import json
import sys

GAITS = {
    "bounding": 1,
    "pronking": 2,
    "standing": 4,
    "trot_running": 5,
    "galloping": 7,
    "pacing": 8,
    "trot": 9,
    "walking": 10,
    "walking2": 11,
}


def load_config(path: str | None, overrides: dict | None = None):
    from quadruped_ctrl_tpu.config import default_config

    kv = {}
    if path:
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}

        def flatten(prefix, node):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    flatten(key, v)
                else:
                    kv[key] = v

        flatten("", doc)
    if overrides:
        kv.update(overrides)
    return default_config(**kv)


def _trace_ctx(profile_dir: str | None):
    """jax.profiler trace context (SURVEY.md §5 tracing: the replacement
    for the reference's ad-hoc Timer.h instrumentation). View with
    TensorBoard or xprof on the written directory."""
    import contextlib

    if not profile_dir:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(profile_dir)


def cmd_sim(args):
    import numpy as np
    import jax

    from quadruped_ctrl_tpu.core.types import Command
    from quadruped_ctrl_tpu.sim import rollout as R
    from quadruped_ctrl_tpu.sim.terrain import Terrain
    from quadruped_ctrl_tpu.utils.metrics import MetricsLogger, tracking_metrics
    from quadruped_ctrl_tpu.utils.timer import Timer

    cfg = load_config(args.config)
    if args.terrain.startswith("file:"):
        terrain = Terrain.from_file(args.terrain[5:])
    else:
        terrain = {
            "plane": Terrain.plane,
            "random": lambda: Terrain.random(jax.random.PRNGKey(args.seed)),
            "stairs": Terrain.stairs,
            "slope": Terrain.slope,
        }[args.terrain]()
    if args.box:
        vals = [[float(v) for v in b.split(",")] for b in args.box]
        assert all(len(v) in (6, 7) for v in vals), \
            "--box cx,cy,cz,hx,hy,hz[,yaw]"
        terrain = terrain.with_boxes(
            centers=[v[:3] for v in vals],
            halves=[v[3:6] for v in vals],
            yaws=[v[6] if len(v) == 7 else 0.0 for v in vals],
        )
    gait = GAITS[args.gait]
    cmd = Command.create(args.vx, args.vy, args.wz, gait_type=gait,
                         robot_mode=args.mode)
    timer = Timer()
    with _trace_ctx(args.profile):
        _, sim, traj = R.run_session(cfg, terrain, cmd, n_ticks=args.ticks)
    wall = timer.get_seconds()
    m = tracking_metrics(traj, (args.vx, args.vy), cfg.control.body_height)
    m.update(
        ticks=args.ticks,
        sim_seconds=args.ticks * cfg.dt,
        wall_seconds=wall,
        realtime_factor=args.ticks * cfg.dt / wall,
        gait=args.gait,
        terrain=args.terrain,
    )
    MetricsLogger(args.log, echo=True).log(m)
    return 0 if m["safety_ok"] and not m["fell"] else 1


def cmd_sweep(args):
    import os

    import numpy as np
    import jax
    import jax.numpy as jnp

    from quadruped_ctrl_tpu.core.types import Command
    from quadruped_ctrl_tpu.sim import batch_rollout as br
    from quadruped_ctrl_tpu.utils import checkpoint
    from quadruped_ctrl_tpu.utils.metrics import MetricsLogger
    from quadruped_ctrl_tpu.utils.timer import Timer

    from quadruped_ctrl_tpu.gait import gait as gait_mod

    cfg = load_config(args.config)
    key = jax.random.PRNGKey(args.seed)
    kinds = tuple(args.terrains.split(","))
    terr = br.batch_terrains(args.batch, key, kinds=kinds)
    states, sims = br.batch_init(cfg, terr, args.batch)

    stand = Command(
        vel=jnp.zeros((args.batch, 3), jnp.float32),
        gait_type=jnp.full((args.batch,), 9, jnp.int32),
        robot_mode=jnp.ones((args.batch,), jnp.int32),
    )
    gait_list = [GAITS[g] for g in args.gaits.split(",")]
    cmds = br.sweep_commands(
        cfg, (0.0, args.vx_max), (-0.3, 0.3), (-0.5, 0.5),
        gait_list, args.batch, key,
    )
    # stance compression + pair packing (the bench pipeline's solve shape,
    # controller._mpc_update_batched_packed) whenever the static gait list
    # guarantees the bound; 2-stance gaits (trot family) get the full 8x
    # factorization shrink. The mode-1 stand phase is 4-stance (aio standing
    # band) and always solves uncompressed.
    max_stance = gait_mod.max_simultaneous_stance(gait_list)
    max_stance = None if (args.no_compress or max_stance >= 4) else max_stance
    ckpt = args.checkpoint
    if ckpt and not ckpt.endswith(".npz"):
        ckpt += ".npz"
    every = args.checkpoint_every or args.macros
    example = {"states": states, "sims": sims,
               "done": jnp.zeros((), jnp.int32),
               "wall": jnp.zeros((), jnp.float32)}
    # resume guard: a checkpoint written under different sweep parameters
    # (seed/terrains/gaits/config) would silently continue the wrong run
    fingerprint = {
        "seed": args.seed, "terrains": args.terrains, "gaits": args.gaits,
        "batch": args.batch, "vx_max": args.vx_max, "h_sol": args.h_sol,
        "max_stance": max_stance, "config": repr(cfg),
    }

    # h_sol=10: the mode-1 stand phase runs the aio standing band (h=10) and
    # the mode-0 sweep keeps the sticky horizonLength 10 (see
    # LocomotionState.mpc_h) — so the packed KKT systems stay 120-var.
    # Raise via --h-sol for custom mode-1 sweeps.
    timer = Timer()
    done = 0
    prev_wall = 0.0
    if ckpt and os.path.exists(ckpt):
        payload = checkpoint.load(ckpt, example, fingerprint=fingerprint)
        states, sims = payload["states"], payload["sims"]
        done = int(payload["done"])
        prev_wall = float(payload["wall"])
        print(f"# resumed {ckpt} at macro {done}/{args.macros}")
    else:
        states, sims, _ = br.batch_rollout(
            cfg, states, sims, stand, terr, 16, h_sol=args.h_sol
        )
    recs = None
    while done < args.macros:
        n = min(every, args.macros - done)
        states, sims, recs = br.batch_rollout(
            cfg, states, sims, cmds, terr, n, h_sol=args.h_sol,
            cont=done > 0, max_stance=max_stance,
        )
        done += n
        if ckpt:
            checkpoint.save(
                ckpt, {"states": states, "sims": sims,
                       "done": jnp.asarray(done, jnp.int32),
                       "wall": jnp.asarray(
                           prev_wall + timer.get_seconds(), jnp.float32)},
                fingerprint=fingerprint,
            )
    if recs is not None:
        # device-slice BEFORE the host fetch: np.asarray(recs["p"])[-1]
        # would copy the whole (macros, batch, 3) record tensor to the host
        # to use one row
        p_final = np.asarray(recs["p"][-1])
        safety = np.asarray(recs["safety"][-1])
    else:  # resumed at done == macros: read the checkpointed final state
        p_final = np.asarray(sims.p)
        safety = np.asarray(states.core.safety_ok)
    upright = p_final[:, 2] > 0.12
    # wall/ticks cover the whole sweep including any previous (checkpointed)
    # invocations, so robot_ticks_per_s stays honest across resumes
    wall = prev_wall + timer.get_seconds()
    ticks = (16 + args.macros) * cfg.mpc.iterations_between_mpc
    m = {
        "batch": args.batch,
        "macros": args.macros,
        "survival_rate": float(upright.mean()),
        "safety_rate": float(safety.mean()),
        "wall_seconds": wall,
        "robot_ticks_per_s": args.batch * ticks / wall,
        "terrains": args.terrains,
        "max_stance": max_stance,
    }
    MetricsLogger(args.log, echo=True).log(m)
    return 0


def cmd_bench(args):
    import bench

    with _trace_ctx(args.profile):
        return bench.main()


def cmd_latency(args):
    import bench_latency

    return bench_latency.main()


def cmd_scaling(args):
    import json

    from quadruped_ctrl_tpu.parallel import multihost

    cfg = load_config(args.config)
    rep = multihost.scaling_report(
        cfg, per_device_batch=args.per_device_batch, reps=args.reps
    )
    if args.multiprocess:
        rep["multiprocess"] = multihost.multiprocess_scaling(
            num_processes=args.multiprocess,
            per_device_batch=args.per_device_batch, reps=args.reps,
        )
    out = json.dumps(rep)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return 0


def main(argv=None):
    from quadruped_ctrl_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="quadruped_ctrl_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    s = sub.add_parser("sim", help="single-robot closed-loop session")
    s.add_argument("--gait", default="trot", choices=sorted(GAITS))
    s.add_argument("--terrain", default="plane",
                   help="plane | random | stairs | slope | file:<heightmap>"
                        " (.txt/.npy/image; the reference random2)")
    s.add_argument("--box", action="append", default=[],
                   metavar="CX,CY,CZ,HX,HY,HZ[,YAW]",
                   help="add a solid box prop (repeatable; racetrack-style "
                        "collision obstacle)")
    s.add_argument("--vx", type=float, default=0.5)
    s.add_argument("--vy", type=float, default=0.0)
    s.add_argument("--wz", type=float, default=0.0)
    s.add_argument("--mode", type=int, default=0, choices=[0, 1])
    s.add_argument("--ticks", type=int, default=2500)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--config", default=None)
    s.add_argument("--log", default=None)
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    s.set_defaults(fn=cmd_sim)

    s = sub.add_parser("sweep", help="batched scenario sweep")
    s.add_argument("--batch", type=int, default=64)
    s.add_argument("--macros", type=int, default=150)
    s.add_argument("--terrains", default="plane")
    s.add_argument("--gaits", default="trot")
    s.add_argument("--vx-max", type=float, default=1.0)
    s.add_argument("--h-sol", type=int, default=10,
                   help="static solved MPC horizon (mode-0 sweeps keep the "
                        "sticky horizonLength 10; raise for mode-1 sweeps)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--config", default=None)
    s.add_argument("--log", default=None)
    s.add_argument("--checkpoint", default=None,
                   help="save/resume the (controller, sim) pytree here after "
                        "every --checkpoint-every macros; if the file exists "
                        "the sweep resumes from it (100k-scenario stretch "
                        "sweeps survive preemption)")
    s.add_argument("--checkpoint-every", type=int, default=0,
                   help="macro-steps between checkpoints (0 = only at end)")
    s.add_argument("--no-compress", action="store_true",
                   help="disable stance compression + packing even when the "
                        "gait list permits it (debug/ablation)")
    s.set_defaults(fn=cmd_sweep)

    s = sub.add_parser("bench", help="MPC solves/s benchmark")
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("latency", help="control-cycle latency benchmark")
    s.set_defaults(fn=cmd_latency)

    s = sub.add_parser("scaling", help="multi-device scaling-efficiency report")
    s.add_argument("--per-device-batch", type=int, default=256)
    s.add_argument("--reps", type=int, default=3)
    s.add_argument("--multiprocess", type=int, default=0,
                   help="also measure N-process jax.distributed weak scaling "
                        "(CPU harness for the multi-host axis)")
    s.add_argument("--out", default=None, help="also write the JSON here")
    s.add_argument("--config", default=None)
    s.set_defaults(fn=cmd_scaling)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
