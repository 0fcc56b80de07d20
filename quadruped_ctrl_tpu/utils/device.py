"""What the entry points need to know about where they run: the persistent
compile cache's location, the devices JAX sees, and the card's name and
power limit."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def compile_cache_dir(environ=None) -> str:
    """The persistent compile cache directory: JAX_COMPILATION_CACHE_DIR
    when it is set (JAX reads that variable itself), else the fixed
    <repo>/.jax_cache (a fixed path, because the path is part of the
    cache key)."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO_ROOT / ".jax_cache")


def enable_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir`. Sets
    nothing when JAX_COMPILATION_CACHE_DIR is set. Returns the directory."""
    import jax

    environ = os.environ if environ is None else environ
    path = compile_cache_dir(environ)
    if not environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_summary() -> dict:
    """platform, device_kind and count of the devices JAX uses."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """The card's name and power limit as `nvidia-smi` reports them, one
    line per card. Runs in a child process that never imports JAX; raises
    when there is no nvidia-smi or it fails."""
    out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()
