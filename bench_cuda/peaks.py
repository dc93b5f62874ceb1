"""The card's published peaks and its name and power limit.

The peaks are NVIDIA's data sheet figures for the H100 SXM part at its
full 700 W; a card set below that runs slower under load, so every
result carries the power limit nvidia-smi reports beside it.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak rate


def card_line() -> str:
    """'<name>, <power limit>' of the first card, as nvidia-smi gives it;
    'unknown' where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    if out.returncode != 0 or not out.stdout.strip():
        return "unknown"
    return out.stdout.strip().splitlines()[0]


def hbm_ms(nbytes: float) -> float:
    """The least time, in ms, that moving `nbytes` through HBM takes."""
    return nbytes / HBM_BYTES_PER_S * 1e3
