"""Desired-state command filter.

Re-derivation of DesiredStateCommand (reference
Controllers/DesiredStateCommand.cpp:24-149, DesiredStateCommand.h:77-122):
low-pass filters the analog sticks (filter = 0.1), applies a 0.075 deadband
with range scaling, and assembles the 12-dim desired state. Like the
reference, this runs every tick but ConvexMPC reads the raw gamepad command
directly — it is kept for API parity and external consumers.
"""

from __future__ import annotations

import jax.numpy as jnp
from quadruped_ctrl_tpu.core import struct


@struct.dataclass
class DesiredStateCommandState:
    left_stick: jnp.ndarray    # (2,)
    right_stick: jnp.ndarray   # (2,)

    @staticmethod
    def create():
        return DesiredStateCommandState(
            left_stick=jnp.zeros(2, jnp.float32),
            right_stick=jnp.zeros(2, jnp.float32),
        )


_FILTER = 0.1
_DEADBAND = 0.075
_MIN_VEL_X, _MAX_VEL_X = -3.0, 3.0
_MIN_VEL_Y, _MAX_VEL_Y = -2.0, 2.0
_MIN_TURN, _MAX_TURN = -2.5, 2.5
_MIN_PITCH, _MAX_PITCH = -0.4, 0.4


def _deadband(command, lo, hi):
    return jnp.where(jnp.abs(command) < _DEADBAND, 0.0, command * 0.5 * (hi - lo))


def convert_to_state_commands(state: DesiredStateCommandState, gamepad, dt):
    """gamepad: (4,) [vx, vy, wz, pitch]. Returns (state, state_des (12,))."""
    left = jnp.stack([-gamepad[0], gamepad[1]])
    right = jnp.stack([-gamepad[2], gamepad[3]])
    left_f = state.left_stick * (1.0 - _FILTER) + left * _FILTER
    right_f = state.right_stick * (1.0 - _FILTER) + right * _FILTER

    des = jnp.zeros(12, dtype=jnp.float32)
    vx = _deadband(left_f[1], _MIN_VEL_X, _MAX_VEL_X)
    vy = _deadband(left_f[0], _MIN_VEL_Y, _MAX_VEL_Y)
    wz = _deadband(right_f[0], _MIN_TURN, _MAX_TURN)
    des = des.at[6].set(vx).at[7].set(vy)
    des = des.at[0].set(dt * vx).at[1].set(dt * vy).at[2].set(0.26)
    des = des.at[11].set(wz).at[5].set(dt * wz)
    des = des.at[4].set(_deadband(right_f[1], _MIN_PITCH, _MAX_PITCH))
    return (
        DesiredStateCommandState(left_stick=left_f, right_stick=right_f),
        des,
    )


def desired_state_trajectory(state_des, dt_vec):
    """Linear desired-state extrapolation over N future steps.

    Re-derivation of DesiredStateCommand::desiredStateTrajectory
    (DesiredStateCommand.cpp:106-160; defined but never called from the
    reference's run path). state_des: (12,), dt_vec: (N,) per-step dts.
    Returns (N, 12) with positions/angles integrated by their rates.
    """
    def step(s, dt):
        a = jnp.eye(12, dtype=s.dtype)
        a = a.at[0, 6].set(dt).at[1, 7].set(dt).at[2, 8].set(dt)
        a = a.at[3, 9].set(dt).at[4, 10].set(dt).at[5, 11].set(dt)
        s2 = a @ s
        return s2, s2

    import jax

    _, traj = jax.lax.scan(step, state_des, dt_vec)
    return traj
