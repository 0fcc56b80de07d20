"""Python binding for the native host runtime (native/quadruped_rt.cpp).

Gives reference users the exact ctypes surface they already drive
(init_controller / pre_work / set_gait_type / set_robot_mode /
set_robot_vel / torque_calculator returning a StructPointer with eff[12] —
reference scripts/walking_simulation.py:26-28, 70-79, 358-381), backed by
the jitted controller through a registered C callback. Async commands
flow through the library's lock-free SPSC queue instead of the reference's
unguarded cross-thread mutation.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "libquadruped_rt.so"

COMPUTE_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_double),  # imu[10]
    ctypes.POINTER(ctypes.c_double),  # leg[24]
    ctypes.c_int,                     # gait (-1 => pre_work)
    ctypes.c_int,                     # mode
    ctypes.POINTER(ctypes.c_double),  # vel[3]
    ctypes.POINTER(ctypes.c_double),  # tau_out[12]
)


class JointEff(ctypes.Structure):
    _fields_ = [("eff", ctypes.c_double * 12)]


def build(force: bool = False) -> Path:
    """Compile the native library with g++ (no external deps)."""
    src = _NATIVE_DIR / "quadruped_rt.cpp"
    if _SO_PATH.exists() and not force:
        if _SO_PATH.stat().st_mtime >= src.stat().st_mtime:
            return _SO_PATH
    subprocess.run(
        [
            "g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall", "-Wextra",
            "-o", str(_SO_PATH), str(src), "-lpthread",
        ],
        check=True,
    )
    return _SO_PATH


def load() -> ctypes.CDLL:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    lib.torque_calculator.restype = ctypes.POINTER(JointEff)
    lib.quadruped_rt_latency_us.restype = ctypes.c_double
    lib.quadruped_rt_latency_us.argtypes = [ctypes.c_double]
    lib.quadruped_rt_latency_mean_us.restype = ctypes.c_double
    lib.quadruped_rt_latency_max_us.restype = ctypes.c_double
    lib.quadruped_rt_tick_count.restype = ctypes.c_longlong
    lib.quadruped_rt_overruns.restype = ctypes.c_longlong
    lib.quadruped_rt_sleep_until_next.restype = ctypes.c_longlong
    lib.quadruped_rt_sleep_until_next.argtypes = [ctypes.c_longlong]
    lib.quadruped_rt_now_ns.restype = ctypes.c_longlong
    return lib


class NativeController:
    """The reference FFI surface, computed by the jitted controller.

    Usage (mirrors walking_simulation.py's loop):
        nc = NativeController(cfg)
        nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
        for _ in range(10): nc.pre_work(imu, leg)
        tau = nc.torque_calculator(imu, leg)     # (12,) np.ndarray
    """

    def __init__(self, cfg=None, mpc_iterations: int | None = None):
        import jax
        import jax.numpy as jnp

        from quadruped_ctrl_tpu.config import default_config
        from quadruped_ctrl_tpu.control import controller as ctrl
        from quadruped_ctrl_tpu.core.types import Command, Sensors

        self.cfg = cfg or default_config()
        self.lib = load()
        self._state = ctrl.init_state(self.cfg)

        cfg_ = self.cfg

        @jax.jit
        def _step(state, imu, leg, gait, mode, vel):
            sensors = Sensors(
                quat=imu[3:7], gyro=imu[7:10], accelerometer=imu[0:3],
                q=leg[0:12], qd=leg[12:24],
            )
            cmd = Command(vel=vel, gait_type=gait, robot_mode=mode)
            state, out = ctrl.controller_step(
                cfg_, state, sensors, cmd, mpc_iterations=mpc_iterations
            )
            return state, out.tau

        @jax.jit
        def _pre(state, imu, leg):
            sensors = Sensors(
                quat=imu[3:7], gyro=imu[7:10], accelerometer=imu[0:3],
                q=leg[0:12], qd=leg[12:24],
            )
            return ctrl.pre_work(cfg_, state, sensors)

        self._step_fn = _step
        self._pre_fn = _pre
        self._jnp = jnp
        # an exception inside the C callback cannot cross the C frames;
        # it is kept here and re-raised by the Python-side ABI wrappers
        self.callback_error = None

        def compute(imu_p, leg_p, gait, mode, vel_p, tau_p):
            try:
                imu = jnp.asarray(np.ctypeslib.as_array(imu_p, (10,)))
                leg = jnp.asarray(np.ctypeslib.as_array(leg_p, (24,)))
                vel = jnp.asarray(np.ctypeslib.as_array(vel_p, (3,)))
                if gait < 0:
                    self._state = self._pre_fn(self._state, imu, leg)
                    return 0
                self._state, tau = self._step_fn(
                    self._state, imu, leg,
                    jnp.asarray(gait, jnp.int32), jnp.asarray(mode, jnp.int32),
                    vel,
                )
                out = np.asarray(tau, dtype=np.float64)
                ctypes.memmove(
                    tau_p, out.ctypes.data, 12 * ctypes.sizeof(ctypes.c_double)
                )
                return 0
            except Exception as e:  # noqa: BLE001 — surfaced by _check
                self.callback_error = e
                return 1

        self._compute_cb = COMPUTE_FN(compute)  # keep a reference alive

    # ------------------------------------------------- reference ABI ----
    def init_controller(self, freq: float, ctrl_param):
        arr = (ctypes.c_double * 4)(*ctrl_param)
        self.lib.init_controller(ctypes.c_double(freq), arr)
        self.lib.quadruped_rt_register_compute(self._compute_cb)
        from quadruped_ctrl_tpu.control import controller as ctrl

        self._state = ctrl.init_state(self.cfg)

    def _check(self):
        err, self.callback_error = self.callback_error, None
        if err is not None:
            raise RuntimeError("controller callback failed") from err

    def pre_work(self, imu, leg):
        self.lib.pre_work(_darr(imu, 10), _darr(leg, 24))
        self._check()

    def set_gait_type(self, gait: int):
        self.lib.set_gait_type(ctypes.c_int(gait))

    def set_robot_mode(self, mode: int):
        self.lib.set_robot_mode(ctypes.c_int(mode))

    def set_robot_vel(self, vel):
        self.lib.set_robot_vel(_darr(vel, 3))

    def torque_calculator(self, imu, leg) -> np.ndarray:
        res = self.lib.torque_calculator(_darr(imu, 10), _darr(leg, 24))
        self._check()
        return np.array(res.contents.eff[:], dtype=np.float64)

    # ------------------------------------------------- observability ----
    def latency_summary(self) -> dict:
        return {
            "count": int(self.lib.quadruped_rt_tick_count()),
            "mean_us": float(self.lib.quadruped_rt_latency_mean_us()),
            "p50_us": float(self.lib.quadruped_rt_latency_us(50.0)),
            "p99_us": float(self.lib.quadruped_rt_latency_us(99.0)),
            "max_us": float(self.lib.quadruped_rt_latency_max_us()),
            "overruns": int(self.lib.quadruped_rt_overruns()),
        }


def _darr(values, n):
    arr = (ctypes.c_double * n)()
    for i, v in enumerate(np.asarray(values, dtype=np.float64).reshape(n)):
        arr[i] = v
    return arr
