"""``moe_s``: seconds of the MoE layers in a check, the span ``moe`` of
every MoE layer's forward and backward in each step (the estimate's two
reference runs and the candidate, ``TTraceResult.seconds["<step>.moe"]``,
on the device's clock, idle included) added, the mean over the window's
checks.  The backward part runs from the gradient's arrival at the
layer's output to its leaving through the layer's input."""
from port_bench.metrics._checks import measured

SPAN = "moe"


def step_sum(rec: dict, span: str):
    """The mean over the checks of the sum over steps of
    ``seconds["<step>.<span>"]``; None where no check has it."""
    vals = [sum(v for k, v in c["seconds"].items()
                if k.split(".", 1)[-1] == span and "." in k)
            for c in measured(rec)
            if any(k.split(".", 1)[-1] == span for k in c["seconds"])]
    return sum(vals) / len(vals) if vals else None


def read(rec):
    return step_sum(rec, SPAN)
