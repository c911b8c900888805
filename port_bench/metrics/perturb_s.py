"""``perturb_s``: seconds of the threshold estimate's perturbation
(``TTraceResult.seconds["estimate.perturb"]``: the embedding tap's copy to
the host, the draw on the host and the copy back, on the device's clock),
the mean over the window's checks."""
from port_bench.metrics._checks import layer_seconds


def read(rec):
    return layer_seconds(rec, "estimate.perturb")
