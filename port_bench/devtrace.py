"""Reduce a ``torch.profiler`` run to what the per-layer readers and the
result's ``breakdown`` read.

The profiled window is the span of the benchmark's ``WINDOW`` annotation.
A device operation is any event on the card (kernel, copy, fill) other
than an annotation's mirror there; busy time is the union of their
intervals inside the window, and an idle gap is a stretch of the window
with none, labelled by the benchmark's spans and the innermost host
operation running where the gap starts.
"""
from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.profiled"
SPAN_PREFIX = "bench."
TOP = 10


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def summarize(events) -> dict | None:
    """``{"window_s", "busy_s", "device_ops", "idle_gaps", "kernel_s",
    "launches"}`` of a profiler's ``events()``; None where the window or
    every device operation is missing."""
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.name.startswith((SPAN_PREFIX, "ProfilerStep")):
            if not _is_device(e):
                host.append(e)
            continue
        (dev if _is_device(e) else host).append(e)
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
           for e in dev if e.time_range.end > w0 and e.time_range.start < w1]
    if not dev:
        return None
    kernel_us, launches = defaultdict(float), defaultdict(int)
    for s, t, name in dev:
        kernel_us[name] += t - s
        launches[name] += 1
    merged = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges), 2)]
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:TOP]
    ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[_label(host, at), us * 1e-6] for us, at in gaps],
            "kernel_s": {n: us * 1e-6 for n, us in kernel_us.items()},
            "launches": dict(launches)}


def _label(host, at) -> str:
    """The benchmark's spans open at ``at``, outermost first, and the
    innermost other host operation there."""
    spans, inner = [], None
    for e in host:
        if e.name != WINDOW and e.time_range.start <= at < e.time_range.end:
            if e.name.startswith(SPAN_PREFIX):
                spans.append(e)
            elif inner is None or (e.time_range.end - e.time_range.start
                                   < inner.time_range.end
                                   - inner.time_range.start):
                inner = e
    spans.sort(key=lambda e: e.time_range.start)
    names = [e.name for e in spans] + ([inner.name] if inner else [])
    return " > ".join(names) or "host idle"
