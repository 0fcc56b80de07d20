"""Matmul-precision control for the small-matrix control path.

On an NVIDIA GPU (Ampere and later) an f32 matmul with no `precision=`
may run in TF32 on the tensor cores: inputs rounded to a 10-bit mantissa
(~5e-4 relative), f32 accumulation. The MPC solver's batched hot ops
choose their precision explicitly, op by op (mpc/formation.py,
solver/admm.py: HIGHEST wherever the result feeds the KKT solve, bf16
only for the memory-bound bulk of the ADMM iterations), so they do not
depend on that default. The per-robot control path is different:
estimator, kinematics and SRB-simulation matrices are 3x3..28x28, where
TF32 rounding is semantically significant (the KF's innovation
covariance spans ~1e5 in scale and loses definiteness) and true f32
costs nothing at these sizes.

`exact_matmuls` pins jax.default_matmul_precision("highest") while the
decorated function traces, so every matmul/einsum under it that does not
pass an explicit `precision=` runs true f32 on any backend — matching the
CPU backend the tests validate against (tests/conftest.py).
"""

from __future__ import annotations

import functools

import jax


def exact_matmuls(fn):
    """Trace `fn` (and everything it calls) under HIGHEST matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
