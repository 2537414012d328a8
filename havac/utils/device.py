"""The accelerator a measurement runs on.

Every number a measurement prints names its device: JAX's platform, device
kind and count, and the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
A measurement that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict


class NoGpuError(RuntimeError):
    """JAX found no GPU where a GPU run was asked for."""


def require_gpu() -> Dict:
    """{"platform", "kind", "count"} of JAX's devices; raises NoGpuError
    unless the first device is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """``name, power.limit`` of the cards, one line each, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
