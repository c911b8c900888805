"""``pack_s``: seconds of the rel-err engine's ``pack_device`` in a check
(``TTraceResult.seconds["estimate.pack"]`` and ``["compare.pack"]``
added: five sections in the estimate, every pair in the compare, on the
device's clock), the mean over the window's checks."""
from port_bench.metrics._checks import layer_seconds

KEYS = ("estimate.pack", "compare.pack")


def read(rec):
    parts = [v for v in (layer_seconds(rec, k) for k in KEYS)
             if v is not None]
    return sum(parts) if parts else None
