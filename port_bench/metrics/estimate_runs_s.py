"""``estimate_runs_s``: seconds of the threshold estimate's reference runs
(``TTraceResult.seconds["estimate.run"]``, the base and the perturbed run
added, on the device's clock), the mean over the window's checks."""
from port_bench.metrics._checks import layer_seconds


def read(rec):
    return layer_seconds(rec, "estimate.run")
