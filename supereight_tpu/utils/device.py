"""The accelerator a measurement runs on.

Every speed number this repo prints names its device. A measurement
that finds no GPU stops: it never falls back to timing the CPU under a
device metric's name.
"""

import subprocess


def require_gpu() -> dict:
    """The device as JAX reports it; exits non-zero unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU: JAX found platform "
                         f"{dev.platform!r} ({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_lines() -> list:
    """``name, power.limit`` per card, from nvidia-smi (a child process
    that does not touch JAX). A card set below its maximum power runs
    slower under load, so every timing is reported beside these."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]
