"""``mla_s``: seconds of the latent attentions in a check, the span
``mla`` of every MLA attention's forward and backward in each step added
(``TTraceResult.seconds["<step>.mla"]``, on the device's clock, idle
included), the mean over the window's checks; read as ``moe_s`` is."""
from port_bench.metrics.moe_s import step_sum

SPAN = "mla"


def read(rec):
    return step_sum(rec, SPAN)
