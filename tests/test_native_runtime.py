"""Native C++ runtime tests: build, ABI round trip, command queue, latency
stats, and a short closed-loop run through the reference-style FFI surface."""

import numpy as np
import pytest

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.runtime import native
from quadruped_ctrl_tpu.sim import engine
from quadruped_ctrl_tpu.sim.terrain import Terrain

CFG = default_config()


@pytest.fixture(scope="module")
def controller():
    nc = native.NativeController(CFG, mpc_iterations=20)
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    return nc


def _sensor_arrays(cfg, sim):
    s = engine.sensors_from_sim(cfg, sim)
    imu = np.concatenate(
        [np.asarray(s.accelerometer), np.asarray(s.quat), np.asarray(s.gyro)]
    )
    leg = np.concatenate([np.asarray(s.q), np.asarray(s.qd)])
    return imu, leg


def test_build_and_abi(controller):
    sim = engine.sim_init(CFG, Terrain.plane())
    imu, leg = _sensor_arrays(CFG, sim)
    for _ in range(3):
        controller.pre_work(imu, leg)
    tau = controller.torque_calculator(imu, leg)
    assert tau.shape == (12,)
    assert np.isfinite(tau).all()


def test_command_queue_drains(controller):
    sim = engine.sim_init(CFG, Terrain.plane())
    imu, leg = _sensor_arrays(CFG, sim)
    controller.set_gait_type(4)
    controller.set_robot_mode(0)
    controller.set_robot_vel([0.0, 0.0, 0.0])
    tau = controller.torque_calculator(imu, leg)
    assert np.isfinite(tau).all()


def test_closed_loop_through_ffi(controller):
    """Drive the SRB sim through the native ABI for 300 ticks (standing)."""
    import jax

    terrain = Terrain.plane()
    sim = engine.sim_init(CFG, terrain)
    controller.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    controller.set_gait_type(4)

    imu, leg = _sensor_arrays(CFG, sim)
    for _ in range(10):
        controller.pre_work(imu, leg)

    from quadruped_ctrl_tpu.control import controller as ctrl
    from quadruped_ctrl_tpu.core.types import ControllerOutput

    # reuse the python-side state the callback carries to build sim inputs:
    # feed the torque-free SRB with the controller's desired outputs by
    # running engine.sim_step against the internal ControllerOutput — here we
    # simply step the sim with the controller's fr_des from its state.
    for i in range(300):
        imu, leg = _sensor_arrays(CFG, sim)
        tau = controller.torque_calculator(imu, leg)
        assert np.isfinite(tau).all()
        st = controller._state
        loco = st.core.locomotion
        out = ControllerOutput(
            tau=tau.astype(np.float32),
            p_foot_des=st.swing_p_cur,
            v_foot_des=st.swing_v_cur,
            fr_des=loco.fr_des,
            contact_state=np.ones(4, np.float32),
            swing_state=np.zeros(4, np.float32),
            p_body_des=np.zeros(3, np.float32),
            v_body_des=np.zeros(3, np.float32),
            estimate=None,
        )
        sim = engine.sim_step(CFG, sim, out, terrain)

    z = float(sim.p[2])
    assert 0.2 < z < 0.32
    stats = controller.latency_summary()
    assert stats["count"] >= 300
    assert stats["p50_us"] > 0


def test_rate_limiter(controller):
    lib = controller.lib
    t0 = lib.quadruped_rt_now_ns()
    anchor = t0
    for _ in range(5):
        anchor = lib.quadruped_rt_sleep_until_next(anchor)
    elapsed = lib.quadruped_rt_now_ns() - t0
    assert elapsed >= 4 * 2_000_000  # ~5 periods at 500 Hz, allow slack


def test_callback_failure_is_raised_not_swallowed(controller, monkeypatch):
    """An exception inside the C callback cannot cross the C frames; the
    Python wrapper re-raises it instead of returning stale torques."""
    sim = engine.sim_init(CFG, Terrain.plane())
    imu, leg = _sensor_arrays(CFG, sim)

    def boom(*a, **k):
        raise ValueError("step failed")

    monkeypatch.setattr(controller, "_step_fn", boom)
    with pytest.raises(RuntimeError, match="callback failed") as e:
        controller.torque_calculator(imu, leg)
    assert isinstance(e.value.__cause__, ValueError)
    monkeypatch.undo()
    assert np.isfinite(controller.torque_calculator(imu, leg)).all()
