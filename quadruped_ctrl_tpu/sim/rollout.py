"""Closed-loop rollout drivers: controller + SRB sim over a scan.

Replicates the reference's session structure (walking_simulation.py:170-198):
10 estimator warm-up ticks, a 200-tick stand phase in adaptive mode
(set_robot_mode(1)), then the commanded phase. Everything is one jitted scan,
vmappable over scenario batches.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from quadruped_ctrl_tpu.config import FrameworkConfig
from quadruped_ctrl_tpu.control import controller as ctrl
from quadruped_ctrl_tpu.core.types import Command, Sensors
from quadruped_ctrl_tpu.sim import engine
from quadruped_ctrl_tpu.sim.terrain import Terrain

WARMUP_TICKS = 10
STAND_TICKS = 200


def make_command_sequence(cfg: FrameworkConfig, n_ticks: int, cmd: Command,
                          stand_ticks: int = STAND_TICKS):
    """(stand phase in mode 1 with zero velocity) + (commanded phase)."""
    stand = Command.create(0.0, 0.0, 0.0, gait_type=9, robot_mode=1)

    def at(i):
        use_stand = i < stand_ticks
        return Command(
            vel=jnp.where(use_stand, stand.vel, cmd.vel),
            gait_type=jnp.where(use_stand, stand.gait_type, cmd.gait_type),
            robot_mode=jnp.where(use_stand, stand.robot_mode, cmd.robot_mode),
        )

    return jax.vmap(at)(jnp.arange(n_ticks))


def rollout(
    cfg: FrameworkConfig,
    terrain: Terrain,
    commands: Command,            # leading axis = ticks
    mpc_iterations: int | None = None,
    record_every: int = 1,
):
    """Run a full closed-loop session. Returns (final_ctrl, final_sim, traj).

    traj carries per-tick base position/rpy/velocity, torques and GRFs.
    """
    sim0 = engine.sim_init(cfg, terrain)
    state0 = ctrl.init_state(cfg)

    def warm(carry, _):
        state, sim = carry
        sens = engine.sensors_from_sim(cfg, sim)
        state = ctrl.pre_work(cfg, state, sens)
        return (state, sim), None

    (state0, sim0), _ = lax.scan(warm, (state0, sim0), None, length=WARMUP_TICKS)

    def tick(carry, cmd):
        state, sim = carry
        sens = engine.sensors_from_sim(cfg, sim)
        state, out = ctrl.controller_step(cfg, state, sens, cmd,
                                          mpc_iterations=mpc_iterations)
        sim = engine.sim_step(cfg, sim, out, terrain)
        rec = dict(
            p=sim.p,
            rpy=out.estimate.rpy,
            v=sim.v,
            est_p=out.estimate.position,
            est_v=out.estimate.v_world,
            tau=out.tau,
            fr=out.fr_des,
            contact=out.contact_state,
            safety=state.core.safety_ok,
        )
        return (state, sim), rec

    (state, sim), traj = lax.scan(tick, (state0, sim0), commands)
    return state, sim, traj


@partial(jax.jit, static_argnames=("cfg", "n_ticks", "mpc_iterations"))
def run_session(cfg: FrameworkConfig, terrain: Terrain, cmd: Command,
                n_ticks: int, mpc_iterations: int | None = None):
    cmds = make_command_sequence(cfg, n_ticks, cmd)
    return rollout(cfg, terrain, cmds, mpc_iterations=mpc_iterations)


def make_tick(cfg: FrameworkConfig, terrain: Terrain, cmd: Command):
    """One jitted closed-loop tick, controller_step + sim_step: the unit a
    host loop dispatches once per 2 ms tick. Returns
    step(state, sim) -> (state, sim, tau)."""

    @jax.jit
    def step(state, sim):
        sensors = engine.sensors_from_sim(cfg, sim)
        # mpc_iterations=None -> runtime warm/cold budget selection
        # (controller.mpc_update), exactly as in deployment
        state, out = ctrl.controller_step(cfg, state, sensors, cmd)
        sim = engine.sim_step(cfg, sim, out, terrain)
        return state, sim, out.tau

    return step
