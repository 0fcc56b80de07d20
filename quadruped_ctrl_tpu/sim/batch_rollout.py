"""Batched scenario engine with macro-stepped MPC cadence.

A single-robot step hides the every-13th-tick MPC behind `lax.cond`; under
vmap that would evaluate the MPC every tick for every lane (13x waste).
This engine exploits an invariant of the reference's counter semantics: aio
resets happen only when iteration_counter % 13 == 0 pre-increment
(phase boundaries are multiples of iterations_between_mpc), so *every*
scenario's MPC fires at the same global ticks (t+1) % 13 == 0. The rollout
is therefore a scan over macro-steps: one MPC tick followed by 12 plain
ticks, with no per-lane divergence — the structural replacement for the
reference's `if(iterationCounter % iterationsBetweenMPC) == 0`
(ConvexMPCLocomotion.cpp:502).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.control import controller as ctrl
from quadruped_ctrl_tpu.core.types import Command
from quadruped_ctrl_tpu.sim import engine
from quadruped_ctrl_tpu.sim.terrain import Terrain

WARMUP_TICKS = 10


def _mpc_tick_batched(cfg, states, sims, cmds, terrains, h_sol,
                      mpc_iterations, max_stance=None):
    """The every-13th tick with the MPC solve batch-explicit: control_tick
    and leg_commands vmap per lane, while the solve itself runs through
    `controller.mpc_update_batched` -> `admm.admm_mpc_batched` — the same
    solver path as the throughput bench, instead of per-lane `admm_mpc`
    under vmap. With `max_stance` (a valid bound for every scenario's gait
    — see gait.max_simultaneous_stance) the solves additionally run
    stance-compressed + pair-packed, the bench pipeline's exact shape."""
    sensors = jax.vmap(lambda s: engine.sensors_from_sim(cfg, s))(sims)
    states, ctx = ctrl.control_tick_batched(cfg, states, sensors, cmds)
    # closed-loop solves are temporally warm-started (controller state
    # carries the previous tick's shifted iterate), so the reduced
    # warm_iterations budget applies unless the caller overrides
    iters = (cfg.solver.warm_iterations if mpc_iterations is None
             else mpc_iterations)
    states = ctrl.mpc_update_batched(
        cfg, states, ctx, h_sol=h_sol, iterations=iters,
        max_stance=max_stance,
    )
    states, outs = jax.vmap(
        lambda st, c: ctrl.leg_commands(cfg, st, c)
    )(states, ctx)
    sims = jax.vmap(
        lambda sm, o, t: engine.sim_step(cfg, sm, o, t)
    )(sims, outs, terrains)
    return states, sims


def batch_init(cfg: FrameworkConfig, terrains: Terrain, batch: int):
    """vmapped controller+sim initial states for a batch of terrains."""
    def one(i):
        t = jax.tree.map(lambda x: x[i], terrains)
        return ctrl.init_state(cfg), engine.sim_init(cfg, t)

    return jax.vmap(one)(jnp.arange(batch))


@partial(jax.jit,
         static_argnames=("cfg", "n_macro", "mpc_iterations", "h_sol", "cont",
                          "max_stance"))
def batch_rollout(
    cfg: FrameworkConfig,
    states,                 # batched FullControllerState
    sims,                   # batched SimState
    commands: Command,      # batched (leading axis = scenarios)
    terrains: Terrain,      # batched
    n_macro: int,
    mpc_iterations: int | None = None,
    h_sol: int | None = None,
    cont: bool = False,
    max_stance: int | None = None,
):
    """Run n_macro macro-steps (13 ticks each). Returns
    (states, sims, per-macro records). `h_sol` is the static solved MPC
    horizon (see mpc_update_batched; default cfg.mpc.h_max is always safe).
    `max_stance` enables stance-compressed + packed solves — valid only when
    it bounds every scenario gait's simultaneous stance feet
    (gait.max_simultaneous_stance).

    `cont=True` continues a rollout previously advanced by this function:
    the KF warmup and the pre-first-MPC prologue are skipped so the 13-tick
    MPC cadence is preserved across chunk boundaries — the basis for
    checkpointed long sweeps (resume-identical, see test_sweep_checkpoint)."""
    ib = cfg.mpc.iterations_between_mpc

    def warm(carry, _):
        states, sims = carry

        def one(state, sim):
            sens = engine.sensors_from_sim(cfg, sim)
            return ctrl.pre_work(cfg, state, sens)

        states = jax.vmap(one)(states, sims)
        return (states, sims), None

    def plain_tick(carry, _):
        states, sims = carry
        sensors = jax.vmap(lambda s: engine.sensors_from_sim(cfg, s))(sims)
        states, ctx = ctrl.control_tick_batched(cfg, states, sensors,
                                                commands)
        states, outs = jax.vmap(
            lambda st, c: ctrl.leg_commands(cfg, st, c)
        )(states, ctx)
        sims = jax.vmap(
            lambda sm, o, t: engine.sim_step(cfg, sm, o, t)
        )(sims, outs, terrains)
        return (states, sims), None

    if not cont:
        (states, sims), _ = lax.scan(warm, (states, sims), None,
                                     length=WARMUP_TICKS)
        # prologue: ticks 0..ib-2 run without MPC (first solve at tick ib-1)
        (states, sims), _ = lax.scan(plain_tick, (states, sims), None,
                                     length=ib - 1)

    def macro(carry, _):
        states, sims = carry
        states, sims = _mpc_tick_batched(
            cfg, states, sims, commands, terrains, h_sol, mpc_iterations,
            max_stance=max_stance,
        )
        (states, sims), _ = lax.scan(
            plain_tick, (states, sims), None, length=ib - 1
        )
        rec = dict(
            p=sims.p,
            v=sims.v,
            safety=states.core.safety_ok,
            quat=sims.quat,
        )
        return (states, sims), rec

    (states, sims), recs = lax.scan(macro, (states, sims), None, length=n_macro)
    return states, sims, recs


def sweep_commands(cfg: FrameworkConfig, vx_range, vy_range, wz_range,
                   gaits, batch: int, key):
    """Scenario grid: random (vx, vy, wz, gait) draws — the terrain x gait x
    velocity sweep replacing the reference's single WalkingSimulation."""
    ks = jax.random.split(key, 4)
    vx = jax.random.uniform(ks[0], (batch,), jnp.float32, *vx_range)
    vy = jax.random.uniform(ks[1], (batch,), jnp.float32, *vy_range)
    wz = jax.random.uniform(ks[2], (batch,), jnp.float32, *wz_range)
    g = jax.random.choice(ks[3], jnp.asarray(gaits, jnp.int32), (batch,))
    return Command(
        vel=jnp.stack([vx, vy, wz], axis=1),
        gait_type=g,
        robot_mode=jnp.zeros((batch,), jnp.int32),
    )


def batch_terrains(batch: int, key, kinds=("plane",), grid=(64, 64)):
    """Batched terrain pytree cycling through the requested kinds.

    A kind of "file:<path>" loads a heightmap file (the reference random2,
    walking_simulation.py:120-130), resampled to the shared `grid` so it
    batches with the other kinds."""
    ts = []
    keys = jax.random.split(key, batch)
    loaded = {}
    for i in range(batch):
        kind = kinds[i % len(kinds)]
        if kind == "plane":
            ts.append(Terrain.plane(grid))
        elif kind == "random":
            ts.append(Terrain.random(keys[i], grid=grid))
        elif kind == "stairs":
            ts.append(Terrain.stairs(grid=grid))
        elif kind == "slope":
            ts.append(Terrain.slope(grid=grid))
        elif kind == "boxes":
            # racetrack-style prop scenario: a low platform straddling the
            # +x path (steppable) and a tall crate offset to the side (the
            # robot walks past it) — cf. the reference racetrack world's
            # collision props (worlds/racetrack_day.world:32-45)
            ts.append(Terrain.plane(grid).with_boxes(
                centers=[[0.9, 0.0, 0.01], [1.0, 0.6, 0.25]],
                halves=[[0.35, 0.6, 0.01], [0.2, 0.2, 0.25]],
            ))
        elif kind.startswith("file:"):
            path = kind[5:]
            if path not in loaded:
                loaded[path] = Terrain.from_file(path, grid=grid)
            ts.append(loaded[path])
        else:
            raise ValueError(kind)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *ts)
