"""Which device a number was measured on: JAX's view and the card's own."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one entry per card), from a
    child process that stays off JAX. A card may run below its maximum power
    limit, and slower with it, so every number carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return " | ".join(line.strip() for line in out.stdout.splitlines())
