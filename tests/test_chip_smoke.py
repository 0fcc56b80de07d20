"""chip_smoke.py's phases at tiny sizes on the CPU (the checks, the
plumbing and the output records), its refusal of a non-GPU backend, and
one `gpu`-marked case that runs the phases on a card in a child process."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu_backend(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(e.value.code)
    assert '"ok": true' not in capsys.readouterr().out


def _finite_numbers(rec):
    for v in rec.values():
        if isinstance(v, float):
            assert math.isfinite(v)


def test_flagship_phase_tiny():
    rec = chip_smoke.phase_flagship(batch=8, n_oracle=3, n_steady=2)
    assert rec["phase"] == "flagship" and rec["batch"] == 8
    assert len(rec["steady_s"]) == 2 and rec["compile_s"] > 0
    assert rec["oracle_scenarios"] == 3
    assert rec["oracle_worst_err_N"] <= chip_smoke.ORACLE_ATOL_N
    assert isinstance(rec["memory_analysis"], dict)
    _finite_numbers(rec)
    json.dumps(rec, default=float)


def test_h16_phase_tiny():
    rec = chip_smoke.phase_h16(batch=4, n_oracle=2, n_steady=1)
    assert [s["shape"] for s in rec["shapes"]] == [
        "full", "walking_band", "fast_trot"]
    for s in rec["shapes"]:
        assert s["oracle_worst_err_N"] <= chip_smoke.ORACLE_ATOL_N


def test_oracle_gate_rejects_wrong_and_nonfinite_forces():
    import jax

    from quadruped_ctrl_tpu.config import default_config
    from quadruped_ctrl_tpu.mpc import pipeline

    cfg = default_config()
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), 2, 6)
    oracle = chip_smoke._load_oracle()
    want = np.stack([oracle.mpc_step_forces(
        cfg, jax.tree.map(lambda x: np.asarray(x)[b], inputs))
        for b in range(2)])
    assert chip_smoke.oracle_gate(cfg, inputs, want, 2)[
        "oracle_worst_err_N"] < 1e-9
    with pytest.raises(chip_smoke.SmokeFailure, match="oracle"):
        chip_smoke.oracle_gate(cfg, inputs, want + 1.0, 2)
    bad = want.copy()
    bad[1, 3, 0, 0] = np.nan
    with pytest.raises(chip_smoke.SmokeFailure, match="non-finite"):
        chip_smoke.oracle_gate(cfg, inputs, bad, 1)


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"vx_err": 0.2}, False),
    ({"height_err": 0.05, "height_mean": 0.20}, False),
    ({"safety_ok": False}, False),
    ({"fell": True}, False),
])
def test_check_loop_metrics(change, ok):
    m = {"vx_err": 0.01, "height_err": 0.005, "height_mean": 0.255,
         "safety_ok": True, "fell": False, **change}
    if ok:
        chip_smoke.check_loop_metrics(m)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_loop_metrics(m)


def test_loop_phase_tiny():
    rec = chip_smoke.phase_loop(ticks=30, n_roundtrips=3, gate=False)
    assert rec["ticks"] == 30 and rec["roundtrips"] == 3
    assert rec["safety_ok"] and not rec["fell"]
    assert rec["roundtrip_p99_ms"] >= rec["roundtrip_p50_ms"] > 0
    assert rec["session_compile"]["backend_compile_s"] > 0


def test_sweep_phase_tiny():
    rec = chip_smoke.phase_sweep(batch=4, macros=1)
    assert rec["survival_rate"] >= 0.99
    assert rec["robot_ticks_per_s_incl_compile"] > 0
    assert rec["compile"]["backend_compile_s"] > 0


def test_native_phase_tiny():
    rec = chip_smoke.phase_native(n_pre=2, n_ticks=3)
    assert rec["worst_err_Nm"] <= chip_smoke.NATIVE_ATOL_NM
    assert rec["latency_us"]["count"] == 3


def test_multi_phase_on_virtual_devices():
    """The 4-device path on 4 of the suite's virtual CPU devices."""
    rec = chip_smoke.phase_multi(per_device=2, n_devices=4, n_steady=1)
    assert rec["devices"] == 4 and rec["batch"] == 8
    assert rec["worst_err_N"] <= chip_smoke.MULTI_ATOL_N
    assert rec["mean_rel_err"] <= chip_smoke.MULTI_MEAN_RTOL


def test_compile_clock_counts_a_compile():
    import jax
    import jax.numpy as jnp

    with chip_smoke.compile_clock() as cc:
        jax.jit(lambda x: jnp.tanh(x) * 3.0 + 1.0)(jnp.ones(7))
    assert cc["backend_compile_s"] > 0 and cc["lower_s"] > 0
    before = dict(cc)
    jax.jit(lambda x: x - 2.0)(jnp.ones(5))      # outside: not counted
    assert cc == before


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    """Phases 1, 4 and 5 at reduced size on the card, in a child process
    (this process stays on the CPU)."""
    code = (
        "import chip_smoke as c, json\n"
        "c.phase_device()\n"
        "print(json.dumps([c.phase_flagship(batch=256, n_oracle=4)['oracle_worst_err_N'],"
        " c.phase_sweep(batch=64, macros=2)['survival_rate'],"
        " c.phase_native(n_pre=2, n_ticks=5)['worst_err_Nm']]))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    err_f, survival, err_tau = json.loads(out.stdout.strip().splitlines()[-1])
    assert err_f <= chip_smoke.ORACLE_ATOL_N
    assert survival >= 0.99
    assert err_tau <= chip_smoke.NATIVE_ATOL_NM
