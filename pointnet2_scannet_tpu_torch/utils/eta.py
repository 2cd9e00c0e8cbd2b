"""ETA formatting for the Solver's iteration reports."""

from __future__ import annotations


def decode_eta(seconds: float) -> dict:
    """Seconds -> {"h", "m", "s"} whole hours, minutes and seconds."""
    seconds = int(seconds)
    return {"h": seconds // 3600, "m": (seconds % 3600) // 60, "s": seconds % 60}
