"""What every script of the repository does before it measures anything.

* `enable_compile_cache` -- one rule for the persistent XLA compile cache:
  the environment's `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
  that variable itself), otherwise `.jax_cache` at the root of the
  checkout.  The directory is part of the cache's key, so it has to be the
  same path on every run to hit.
* `describe_device` -- the device as JAX reports it, and the card's name
  and power limit from `nvidia-smi` (a child process that stays off JAX),
  for the line every measurement prints beside its numbers.
* `require_gpu` -- scripts that report a device time refuse to run
  anywhere else rather than time the CPU.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def describe_device() -> str:
    """Platform, device kind and count, plus the card line on a GPU."""
    devices = jax.devices()
    d = devices[0]
    line = f"device {d.platform} {d.device_kind} x{len(devices)}"
    if d.platform == "gpu":
        line += f"; nvidia-smi: {card_line()}"
    return line


def require_gpu(name: str) -> None:
    """Exit non-zero unless JAX's default backend is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"{name}: needs a GPU; JAX found {platform}")
