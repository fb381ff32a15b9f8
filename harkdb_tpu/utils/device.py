"""The measuring scripts' device checks: a GPU or nothing, and the card's
name and power limit beside every number they print."""

from __future__ import annotations

import subprocess


def require_gpu(devices) -> None:
    """Exit (non-zero, no result) unless JAX's first device is a GPU. There
    is no CPU fallback: a CPU number is never a device number."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise SystemExit(f"needs a GPU; JAX found {found}")


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them. Runs
    in a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return " | ".join(out.splitlines())
