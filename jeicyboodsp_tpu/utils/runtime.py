"""Process set-up shared by the CLI, the benchmarks and the chip smoke test.

- :func:`setup_compile_cache` places JAX's persistent compilation cache.
  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
  nothing is set in code.  Otherwise the cache lives at one fixed path
  inside the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``), so
  a second process finds what the first compiled.
- :func:`device_record` and :func:`card_info` name the device a result was
  measured on.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives for this process."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir`; returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_record() -> dict:
    """The first device as JAX reports it, plus the device count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def card_info() -> list[str]:
    """``name, power.limit`` per card, read by ``nvidia-smi`` in a child
    process that never touches JAX.  Raises if the tool is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
