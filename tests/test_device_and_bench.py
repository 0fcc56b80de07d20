"""The entry points' shared helpers (compile-cache location, device and
card description), bench.py's peak table and FLOP model, and the pytree
dataclass the state structs use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.core import struct
from quadruped_ctrl_tpu.utils import device


def test_peaks_known_kind():
    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p["f32_tflops"] == 67.0 and p["hbm_gbs"] == 3350.0
    assert p["bf16_tflops"] > p["tf32_tflops"] > p["f32_tflops"]


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"])
def test_peaks_unknown_kind_is_an_error(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks(kind)


def test_phase_models_flagship_factorization():
    """The h=10 flagship: 2048 packed 120-var systems, 25 NS iterations of
    two 120^3 products, cold + adaptive-rho = ~1.77 TFLOP."""
    cfg = default_config()
    m = bench.phase_models(cfg, h=10, batch=4096)
    flops, _, bound = m["factorize(NS)"]
    assert flops == 2 * 2048 * 25 * 2 * 2 * 120**3
    assert bound == "f32"
    _, bytes_iter, bound_iter = m["iterate(ADMM)"]
    # 60 bf16 + 60 f32 inverse streams of 2048 x 120^2
    assert bytes_iter == 2048 * 120 * 120 * (2 * 60 + 4 * 60)
    assert bound_iter == "hbm"


def test_compile_cache_env_var_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert device.compile_cache_dir(env) == "/some/where"
    assert device.enable_compile_cache(env) == "/some/where"
    assert calls == []            # JAX reads the variable itself


def test_compile_cache_default_is_repo_path(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = str(device.REPO_ROOT / ".jax_cache")
    assert device.compile_cache_dir({}) == want
    assert device.enable_compile_cache({}) == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert (device.REPO_ROOT / "quadruped_ctrl_tpu").is_dir()


def test_device_summary_names_the_backend():
    d = device.device_summary()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_card_info_raises_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(device, "CARD_QUERY",
                        ["no-such-binary-for-card-query"])
    with pytest.raises(OSError):
        device.card_info()


def test_struct_dataclass_is_a_frozen_pytree():
    @struct.dataclass
    class Pair:
        a: jnp.ndarray
        b: jnp.ndarray

    p = Pair(a=jnp.ones(3), b=jnp.zeros(()))
    leaves, tree = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(tree, [x + 1 for x in leaves])
    np.testing.assert_array_equal(np.asarray(q.a), 2.0)
    r = jax.jit(lambda s: s.replace(b=s.b + 5.0))(p)
    assert float(r.b) == 5.0 and isinstance(r, Pair)
    with pytest.raises(Exception):
        p.a = jnp.zeros(3)        # frozen
