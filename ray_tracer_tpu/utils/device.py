"""The device a measurement ran on, and the refusal to measure without one.

A time or a rate is only a device number when it names its device:
JAX's platform, device kind and device count, and the card's name and
power limit as nvidia-smi reports them (a card set below its maximum
power runs slower under load).
"""

from __future__ import annotations

import subprocess
from typing import Dict

import jax


def require_gpu() -> Dict[str, object]:
    """-> {"platform", "kind", "count"} of JAX's devices.

    Raises SystemExit when JAX's first device is not a GPU: a
    measurement never falls back to the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); refusing to measure"
        )
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """The line `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints (one per card).  A child process that
    stays off JAX reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
