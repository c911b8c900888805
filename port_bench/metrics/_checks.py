"""What the per-layer readers share: the window's checks that ran without
the profiler (all of them if none did)."""
from __future__ import annotations


def measured(rec: dict) -> list:
    plain = [c for c in rec["checks"] if not c["profiled"]]
    return plain or rec["checks"]


def layer_seconds(rec: dict, step: str):
    """The mean over the checks of ``TTraceResult.seconds[step]``."""
    vals = [c["seconds"][step] for c in measured(rec) if step in c["seconds"]]
    return sum(vals) / len(vals) if vals else None
