"""What a measurement ran on: the JAX device and the card's power limit.

Every number a benchmark prints carries ``device_info()``, so a result
from the CPU can never pass for a device metric, and a card set below its
full power limit (which lowers its clocks under load) is visible beside
the time it produced.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s "name, power.limit" line for each card (joined by
    "; "), or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit."""
    import jax

    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
        "nvidia_smi": gpu_name_and_power_limit(),
    }
