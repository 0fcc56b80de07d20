#!/usr/bin/env python
"""Benchmark: batched MPC solves/s on one card (10-step horizon), with
per-phase accounting.

Prints the device line (platform, device_kind, count, and the card's name
and power limit from nvidia-smi) to stderr, then one JSON line on stdout:
{"metric", "value", "unit", "device", "card", "phases", ...}. Exits
non-zero when any lane fails, and raises on a device_kind with no entry in
the peak table.

Each "solve" is the full reference-equivalent MPC pipeline for one scenario:
SRB linearization, exact nilpotent discretization, condensed A_qp/B_qp
stacking, stance-compressed H/g assembly (the reference's swing-variable
elimination as a static one-hot contraction), pair-packed block-diagonal
KKT systems, ADMM iterations + active-set polish rounds, i.e. everything
between update_problem_data_floats and get_solution in the reference
(convexMPC_interface.cpp:121-180).

Phase accounting (SURVEY.md §5 tracing / §7 step 9): the pipeline is timed
at four nested configurations and differenced into formation / factorize /
iterate / polish phases. For each phase an analytic FLOP/byte model of the
path that runs (unpadded systems, `ns_iters` HIGHEST Newton-Schulz
iterations per factorization) gives the bound it should be limited by, and
the % of that bound attained against the card's published peak (`PEAKS`).

Timing methodology: the repetitions are chained *inside* one jit (each rep's
inputs depend on the previous rep's forces, defeating any elision), and the
final scalar is fetched to the host, so each timing ends when the device
has finished.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.mpc import pipeline
from quadruped_ctrl_tpu.utils import device

# Published dense peaks (no sparsity) per jax device_kind. Source: NVIDIA
# H100 Tensor Core GPU data sheet (SXM5 and PCIe parts; f32 = non-tensor-
# core FP32, tf32/bf16 = tensor-core rates). They assume the card's full
# power limit; `card` in the output says what the limit was.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_tflops": 67.0, "tf32_tflops": 494.7,
                              "bf16_tflops": 989.4, "hbm_gbs": 3350.0},
    "NVIDIA H100 PCIe": {"f32_tflops": 51.0, "tf32_tflops": 378.0,
                         "bf16_tflops": 756.0, "hbm_gbs": 2000.0},
}


def peaks(kind: str) -> dict:
    """Peak rates of a device_kind; an unknown kind is an error."""
    if kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {kind!r}; add it to "
            f"bench.PEAKS with its source (known: {sorted(PEAKS)})")
    return PEAKS[kind]


def timed(fn, inputs, n_reps):
    def body(inp, _):
        forces = fn(inp)
        inp = inp.replace(
            v_world=inp.v_world + 1e-9 * jnp.mean(forces, axis=(1, 2))
        )
        return inp, None

    def chained(inp):
        inp, _ = lax.scan(body, inp, None, length=n_reps)
        return jnp.sum(inp.v_world)

    jf = jax.jit(chained)
    np.asarray(jf(inputs))  # compile + warm up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(jf(inputs))
        times.append(time.perf_counter() - t0)
    return min(times) / n_reps


def phase_models(cfg, h: int, batch: int, ms: int = 2, pack: int = 2):
    """Analytic FLOP/byte counts per full batch solve of the packed
    pipeline, for the unpadded XLA path (n = pack*3*ms*h variables per
    system): {phase: (flops, bytes, bound)}."""
    s = cfg.solver
    n_c = 3 * ms * h                    # compressed vars / scenario
    n = pack * n_c                      # vars / packed system
    sys_n = batch // pack               # packed systems
    ns = s.ns_iters
    seg = s.iterations // (s.rho_adapt + 1)
    n_lo = seg * s.rho_adapt            # bf16 segments, before the last
    n_hi = s.iterations - n_lo
    # formation: dominated by the Gram bq' bq — (13h x n_c)^T (13h x n_c)
    flops_form = batch * 2 * (13 * h) * n_c * n_c * 2
    bytes_form = batch * (13 * h * n_c * 2 + n_c * n_c) * 4
    # one factorization: ns NS iterations of two n x n products; each
    # product reads two f32 matrices and writes one
    fact_flops = sys_n * ns * 2 * 2 * n**3
    fact_bytes = sys_n * ns * 2 * 3 * n * n * 4
    # iterate: one inverse matvec per iteration, streaming the bf16
    # inverse before the adaptive-rho event and the f32 one after it
    flops_iter = s.iterations * sys_n * 2 * n * n
    bytes_iter = sys_n * n * n * (2 * n_lo + 4 * n_hi)
    # polish: per round one factorization + a 2-refinement solve (5 matvecs)
    pol = s.polish_rounds
    flops_pol = pol * (fact_flops + sys_n * 5 * 2 * n * n)
    bytes_pol = pol * (fact_bytes + sys_n * 5 * n * n * 4)
    return {
        "formation": (flops_form, bytes_form, "f32"),
        # the factorize bucket holds the cold + adaptive-rho factorizations
        "factorize(NS)": ((s.rho_adapt + 1) * fact_flops,
                          (s.rho_adapt + 1) * fact_bytes, "f32"),
        "iterate(ADMM)": (flops_iter, bytes_iter, "hbm"),
        "polish+fact": (flops_pol, bytes_pol, "f32"),
    }


def main():
    device.enable_compile_cache()
    dev = device.device_summary()
    peak = peaks(dev["kind"])
    card = device.card_info()
    print(f"# device {json.dumps(dev)} card: {card}", file=sys.stderr,
          flush=True)

    # Every lane runs; a failed lane is recorded, reported in the JSON
    # line, and makes the exit code non-zero.
    lane_errors = {}

    def lane(name, fn):
        try:
            out = fn()
            print(f"# lane {name}: ok", file=sys.stderr, flush=True)
            return out
        except Exception as e:  # noqa: BLE001 — recorded, fails the run
            lane_errors[name] = f"{type(e).__name__}: {str(e)[:400]}"
            print(f"# lane {name}: FAIL {lane_errors[name]}",
                  file=sys.stderr, flush=True)
            return None

    cfg = default_config()
    h = 10
    batch = 4096
    n_reps = 48
    inputs = pipeline.random_inputs(jax.random.PRNGKey(0), batch, h)

    t_full = lane("h10_full", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i), inputs, n_reps))
    t_nopol = lane("h10_nopolish", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, polish_rounds=0),
        inputs, n_reps))
    iter_min = 2 * (cfg.solver.rho_adapt + 1)
    t_form_fact = lane("h10_form_fact", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, iterations=iter_min,
                                              polish_rounds=0),
        inputs, n_reps))
    t_form_meas = lane("h10_form_only", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, form_only=True),
        inputs, n_reps))

    def phase(name, t, model):
        flops, bts, bound = model
        attained = (flops / 1e12 / t / peak["f32_tflops"] if bound == "f32"
                    else bts / 1e9 / t / peak["hbm_gbs"])
        return {
            "name": name,
            "ms": t * 1e3,
            "gflops": flops / 1e9,
            "gbytes": bts / 1e9,
            "bound": bound,
            "attained_pct": 100 * attained,
        }

    phases = None
    if None not in (t_full, t_nopol, t_form_fact, t_form_meas):
        models = phase_models(cfg, h, batch)
        t_iter = max(t_nopol - t_form_fact, 1e-9)
        # formation is measured directly (form_only); factorize is the
        # remainder of the measured formation+factorize bucket
        t_form = t_form_meas
        t_fact = max(t_form_fact - t_form, 1e-9)
        t_pol = max(t_full - t_nopol, 1e-9)
        phases = [
            phase("formation", t_form, models["formation"]),
            phase("factorize(NS)", t_fact, models["factorize(NS)"]),
            phase("iterate(ADMM)", t_iter, models["iterate(ADMM)"]),
            phase("polish+fact", t_pol, models["polish+fact"]),
        ]

    # h=16 lane: the aio mode-1 horizon cap (ConvexMPCLocomotion.cpp:174-233).
    # Three shapes: the worst case (mid-speed bands, 3-4 stance feet -> no
    # swing elimination, 192-var systems), the walking band (3-stance ->
    # 144-var), and the fast-trot band (>1.4 m/s reshaped trot is 2-stance
    # -> compressed 96-var, pair-packed to 192)
    h16, b16 = 16, 2048
    inputs16 = pipeline.random_inputs(jax.random.PRNGKey(1), b16, h16)
    t16 = lane("h16_full", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=4, pack=1),
        inputs16, 16))
    t16t = lane("h16_trot", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=2, pack=2),
        inputs16, 16))
    inputs16m = inputs16.replace(gait_table=jnp.broadcast_to(
        jnp.asarray(pipeline.walking_band_gait(h16)), (b16, h16, 4)))
    t16m = lane("h16_midband", lambda: timed(
        lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=3, pack=1),
        inputs16m, 16))

    def rate(total, t):
        return total / t if t else None

    print(
        json.dumps(
            {
                "metric": "mpc_solves_per_s",
                "value": rate(batch, t_full),
                "unit": "solves/s (h=10, batch=4096, full pipeline)",
                "device": dev,
                "card": card,
                "h16_solves_per_s": rate(b16, t16),
                "h16_unit": "solves/s (h=16, batch=2048, 192-var)",
                "h16_trot_solves_per_s": rate(b16, t16t),
                "h16_trot_unit": "solves/s (h=16 fast-trot band, 2-stance "
                                 "compressed + pair-packed)",
                "h16_midband_solves_per_s": rate(b16, t16m),
                "h16_midband_unit": "solves/s (h=16 aio walking band, "
                                    "3-stance compressed, 144-var)",
                "phases": phases,
                "lane_errors": lane_errors or None,
            }
        )
    )
    return 1 if lane_errors else 0


if __name__ == "__main__":
    sys.exit(main())
