"""What the measurement scripts print about the card they ran on."""

from __future__ import annotations

import subprocess

__all__ = ["card_name_and_power_limit", "require_gpu"]


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them (a card
    set below its maximum power runs slower under load, so every number
    is kept beside this line)."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement never falls
    back to the CPU. Exits with a message (status 1) otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX platform is {dev.platform!r}; this measures on "
            "the GPU only"
        )
    return dev
