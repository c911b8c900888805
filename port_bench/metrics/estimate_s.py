"""``estimate_s``: seconds of a check's estimate step (``TTraceResult.seconds["estimate"]``,
synchronized), the mean over the window's checks."""
from port_bench.metrics._checks import layer_seconds


def read(rec):
    return layer_seconds(rec, "estimate")
