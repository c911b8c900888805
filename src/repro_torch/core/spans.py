"""Spans and counters of one TTrace check.

``span(name)`` marks a piece of the check's work.  It always opens a
profiler range ``ttrace.<key>``, so under ``torch.profiler`` every span
lies on the same timeline as the device trace's kernels and copies.  The
range is a function-scope ``RecordFunction``, not a user annotation
(``torch.profiler.record_function``): the profiler mirrors a user
annotation on the device's timeline as an event of its own, which trace
readers would take for device work.

Time is recorded only while a check's log is active: ``ttrace_check``
opens one per call with ``check()`` (the root range ``ttrace.check``) and
keeps it in a context variable.  Outside a check (the supervisor's
``sq_norms_async``, a bare ``estimate_thresholds``) a span only marks the
profiler's timeline.

A key is ``<step>.<name>``, where ``<step>`` is the open one of the four
steps ``STEPS``, or the step's own name.  Clocks:

* a step (a span of a name in ``STEPS`` opened at the top of the check)
  is timed on the host clock; the check synchronizes before a step ends;
* every span inside a step is timed on the device's clock when CUDA is
  initialized: a pair of timing events on the current stream, read when
  the check ends, after its last wait for the device.  Its seconds are the
  stretch of the device's timeline from the point the stream reaches the
  span's start to the point it reaches its end, idle time included.  With
  CUDA not initialized the host clock times it.

A span around a layer's forward can cover its backward too: ``x =
sp.grad_end(x)`` on the work's input and ``y = sp.grad_start(y)`` on its
output put identity autograd nodes there, which time the stretch from the
gradient reaching ``y`` to its leaving through ``x`` under the same key,
on the same clock (on CUDA from autograd's device thread, which sees no
context variable: the nodes hold the log).

The log writes out once, at the end of the check: ``seconds[key]`` (the
durations of a repeated span add up) and ``counts``: ``<key>.calls`` for
every span, what ``count`` adds under the innermost open span's key
(``d2h_bytes``, ``h2d_bytes``), what ``count_device`` adds there as
device tensors (summed on the device, read once after the check's last
wait), and for a span opened with ``alloc=True`` on CUDA the deltas of
the caching allocator's ``alloc_retries``, ``device_allocs`` and
``device_frees``.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch
from torch._C._profiler import _RecordFunctionFast

STEPS = ("estimate", "candidate", "compare", "localize")
PREFIX = "ttrace."
# counts key -> the caching allocator's top-level statistic
ALLOCATOR = (("alloc_retries", "num_alloc_retries"),
             ("device_allocs", "num_device_alloc"),
             ("device_frees", "num_device_free"))

_LOG: contextvars.ContextVar = contextvars.ContextVar("ttrace_span_log",
                                                      default=None)


class SpanLog:
    """The spans and counts of one check, in memory until it ends."""

    def __init__(self):
        self.open: list[str] = []   # keys of the open spans, outermost first
        self.step: str | None = None            # the open step
        self.seconds: dict[str, float] = {}     # in the order spans open
        self.counts: dict[str, int] = {}
        self.timed: list = []       # (key, start event, end event)
        self.device_counts: dict = {}   # key -> device tensor, summed
        # the current streams seen, by (card, raw stream): looking one up
        # costs twice what recording an event on it does
        self.streams: dict = {}

    def add(self, key: str, n) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def event(self, dev: int):
        """A timing event recorded now on card ``dev``'s current stream."""
        raw = torch._C._cuda_getCurrentRawStream(dev)
        stream = self.streams.get((dev, raw))
        if stream is None:
            stream = self.streams[dev, raw] = torch.cuda.current_stream(dev)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def resolve(self) -> None:
        """Adds the device-timed spans' seconds.  No span's end event lies
        behind work the check did not already wait for, so waiting on the
        last one waits only for the stream to reach it.  Then adds the
        device counts, read in one copy."""
        if self.timed:
            self.timed[-1][2].synchronize()
            for key, start, end in self.timed:
                self.seconds[key] += start.elapsed_time(end) * 1e-3
            self.timed = []
        if self.device_counts:
            keys = list(self.device_counts)
            vals = torch.stack([self.device_counts[k].reshape(()).long()
                                for k in keys]).tolist()
            for k, n in zip(keys, vals):
                self.add(k, n)
            self.device_counts = {}


class _Edge(torch.autograd.Function):
    """Identity whose backward calls ``mark`` when the gradient passes."""

    @staticmethod
    def forward(ctx, x, mark):
        ctx.mark = mark
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mark()
        return g, None


class _Backward:
    """The backward of one span's work, timed under its key: opened when
    the gradient reaches the work's output, closed when it has left
    through its input."""
    __slots__ = ("log", "key", "dev", "start", "t0")

    def __init__(self, log: SpanLog, key: str):
        self.log, self.key, self.start, self.t0 = log, key, None, None

    def open(self):
        if torch.cuda.is_initialized():
            self.dev = torch.cuda.current_device()
            self.start = self.log.event(self.dev)
        else:
            self.t0 = time.perf_counter()

    def close(self):
        log = self.log
        if self.start is not None:
            log.timed.append((self.key, self.start, log.event(self.dev)))
        elif self.t0 is not None:
            log.seconds[self.key] += time.perf_counter() - self.t0
        self.start = self.t0 = None


def active() -> SpanLog | None:
    """The log of the check in progress, if any."""
    return _LOG.get()


def _allocator() -> dict:
    # the top level of torch.cuda.memory_stats_as_nested_dict(), read
    # without its argument handling: a fifth of the read's 25 us
    stats = torch._C._cuda_memoryStats(torch.cuda.current_device())
    return {k: stats.get(s, 0) for k, s in ALLOCATOR}


class _Span:
    __slots__ = ("name", "alloc", "log", "key", "is_step", "rf", "t0",
                 "dev", "start", "mem", "bwd")

    def __init__(self, name: str, alloc: bool):
        self.name, self.alloc = name, alloc

    def __enter__(self):
        log = self.log = _LOG.get()
        self.bwd = None
        if log is None:
            self.rf = _RecordFunctionFast(PREFIX + self.name)
            self.rf.__enter__()
            return self
        self.is_step = not log.open and self.name in STEPS
        key = self.key = (self.name if log.step is None
                          else f"{log.step}.{self.name}")
        if self.is_step:
            log.step = self.name
        log.open.append(key)
        log.seconds.setdefault(key, 0.0)
        log.add(key + ".calls", 1)
        self.rf = _RecordFunctionFast(PREFIX + key)
        self.rf.__enter__()
        cuda = torch.cuda.is_initialized()
        self.mem = _allocator() if self.alloc and cuda else None
        self.start = None
        if cuda and not self.is_step:
            self.dev = torch.cuda.current_device()
            self.start = log.event(self.dev)
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log = self.log
        if log is not None:
            key = self.key
            if self.start is None:
                log.seconds[key] += time.perf_counter() - self.t0
            else:
                log.timed.append((key, self.start, log.event(self.dev)))
            if self.mem is not None:
                for k, n in _allocator().items():
                    log.add(f"{key}.{k}", n - self.mem[k])
            log.open.pop()
            if self.is_step:
                log.step = None
        self.rf.__exit__(*exc)
        return False

    def grad_end(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, the work's input, marked: the span's backward ends when
        ``x``'s gradient is complete (nothing outside a check or without
        a gradient)."""
        if (self.log is None or not torch.is_grad_enabled()
                or not x.requires_grad):
            return x
        self.bwd = _Backward(self.log, self.key)
        return _Edge.apply(x, self.bwd.close)

    def grad_start(self, y: torch.Tensor) -> torch.Tensor:
        """``y``, the work's output, marked: the span's backward starts
        when ``y``'s gradient arrives (after ``grad_end``)."""
        if self.bwd is None or not y.requires_grad:
            return y
        return _Edge.apply(y, self.bwd.open)


def span(name: str, alloc: bool = False) -> _Span:
    """A span of the check's work named ``name`` (see the module's
    docstring); ``alloc`` adds the caching allocator's counts."""
    return _Span(name, alloc)


def count(name: str, n: int) -> None:
    """Adds ``n`` to ``<key>.<name>`` of the innermost open span of the
    check in progress (none outside a span of a check)."""
    log = _LOG.get()
    if log is not None and n and log.open:
        log.add(f"{log.open[-1]}.{name}", n)


def count_device(name: str, x: torch.Tensor) -> None:
    """Adds the device scalar ``x`` to ``<key>.<name>`` of the innermost
    open span of the check in progress, on the device: read once, when
    the check ends."""
    log = _LOG.get()
    if log is not None and log.open:
        key = f"{log.open[-1]}.{name}"
        prev = log.device_counts.get(key)
        log.device_counts[key] = x if prev is None else prev + x


def nbytes(x: torch.Tensor) -> int:
    """Bytes of a tensor's elements."""
    return x.numel() * x.element_size()


@contextlib.contextmanager
def check():
    """The log of one check, active for the block under the root range
    ``ttrace.check``; resolved when the block ends without an error."""
    log = SpanLog()
    token = _LOG.set(log)
    try:
        with _RecordFunctionFast(PREFIX + "check"):
            yield log
    finally:
        _LOG.reset(token)
    log.resolve()
