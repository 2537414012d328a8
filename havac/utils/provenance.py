"""Measurement-artifact provenance stamp.

Round 3 shipped an invalid end-to-end table because the native library had
silently fallen back to the pure-numpy host paths during the capture
(VERDICT r3 weak #1/#3). Every benchmark artifact now embeds this stamp so
a capture taken in a degraded or non-default configuration is visible in
the JSON itself: whether the native core was actually loaded, the
environment settings that change what runs, and the device the numbers came
from.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict


_KNOBS = ("HAVAC_NATIVE_BUILD", "JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")


def provenance(require_native: bool = False) -> Dict:
    """The stamp dict. ``require_native=True`` raises RuntimeError when the
    native library is unavailable — benchmark tools pass it so a
    numpy-fallback capture hard-fails instead of shipping silently."""
    from havac import native

    native_active = native.available()
    if require_native and not native_active:
        raise RuntimeError(
            "native library unavailable (numpy fallback active) — refusing "
            "to record a benchmark artifact in a degraded configuration; "
            "build with `make -C havac/native` or pass the tool's "
            "--allow-fallback flag to record anyway (the artifact is then "
            "tagged native_active=false)")
    stamp = {
        "native_active": bool(native_active),
        "knobs": {k: os.environ[k] for k in _KNOBS if k in os.environ},
        "git_rev": _git_rev(),
    }
    try:
        import jax

        dev = jax.devices()[0]
        stamp["device"] = f"{dev.platform}:{getattr(dev, 'device_kind', '?')}"
    except Exception:  # jax not initialized / no backend: still stamp
        stamp["device"] = "uninitialized"
    return stamp


def _git_rev() -> str:
    try:
        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
             "rev-parse", "--short", "HEAD"],
            capture_output=True, timeout=10)
        return out.stdout.decode().strip() if out.returncode == 0 else "?"
    except Exception:
        return "?"
