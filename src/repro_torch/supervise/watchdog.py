"""Watchdog + graceful degradation for the supervised hot loop: the port of
``repro/supervise/watchdog.py`` (pure Python, copied as it is).

TTrace hunts *silent* bugs, but the fleets supervision must live in fail
*loudly* and often (FLARE, Mycroft — PAPERS.md): device futures hang,
collectives stall, disks corrupt.  A supervisor that stalls or dies with
its subject is useless, so every host-blocking wait in the loop goes
through a ``Watchdog`` with a retry-then-fallback escalation ladder:

1. **wait** for the result with a timeout (the transfer runs on a watchdog
   worker thread so the supervisor's own thread can give up on it);
2. on timeout, **retry** once (transient scheduler stalls resolve
   themselves; the abandoned worker thread is left to the hung transfer
   and a fresh one takes over);
3. still stuck: **escalate** — the async check falls back to a synchronous
   recompute from the trace ring (``CheckTimeout``), a stage-boundary
   transfer raises ``BoundaryTimeout`` and the step is reported as a LOUD
   failure instead of freezing the run.

``DegradationController`` is the backpressure policy above the ladder:
when the pipeline saturates (in-flight window full with an unresolvable
oldest entry) for ``degrade_after`` consecutive checked steps, checking
degrades to *sampling* — the effective ``check_every`` doubles — so
training keeps progressing while checks are sick, instead of paying a
timeout per step.  Sustained health recovers one rung at a time.  Every
transition is an event (journaled by the supervisor and surfaced in the
result summary): degraded coverage is visible, never silent.

Loud failures themselves (NaN/Inf in the candidate) are classified by the
checker (``report_from_errs`` marks non-finite rel-errs ``LOUD``) — before
that fix a NaN rel-err compared ``False`` against every threshold and
*passed*; the classic way a loud failure drowns in rel-err machinery.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class LoudFault(RuntimeError):
    """A non-silent failure: hang, corruption, NaN — reported, not hidden."""


class CheckTimeout(LoudFault):
    """An async check's device future never resolved within the ladder."""


class BoundaryTimeout(LoudFault):
    """A stage-boundary transfer future never became ready."""


@dataclass
class WatchdogEvent:
    step: int
    kind: str        # timeout | retry | sync_fallback | check_lost |
    #                # degrade | recover | loud
    detail: str = ""

    def __str__(self) -> str:
        return f"step {self.step}: {self.kind}" + (
            f" ({self.detail})" if self.detail else "")


class Watchdog:
    """Timeout/retry/escalate wrapper around host-blocking waits.

    ``wait(fn, what, step)`` runs ``fn`` on a single persistent worker
    thread and joins it with ``timeout_s``; on timeout it retries
    ``retries`` times (same call, fresh timeout) and then raises
    ``CheckTimeout``.  A worker stuck on a hung wait is abandoned (daemon
    thread) and replaced, so one poisoned future cannot wedge every later
    wait.  ``on_event`` (set by the supervisor) journals every escalation.
    """

    def __init__(self, timeout_s: float = 60.0, retries: int = 1,
                 on_event: Optional[Callable[[WatchdogEvent], None]] = None):
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.on_event = on_event
        self.events: list[WatchdogEvent] = []
        self.timeouts = 0

    def event(self, kind: str, step: int, detail: str = "") -> WatchdogEvent:
        ev = WatchdogEvent(step, kind, detail)
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def events_since(self, n: int) -> list[WatchdogEvent]:
        return self.events[n:]

    def _attempt(self, fn: Callable, timeout_s: float):
        box: dict = {}

        def target():
            try:
                box["value"] = fn()
            except BaseException as e:     # noqa: BLE001 — re-raised below
                box["error"] = e

        t = threading.Thread(target=target, daemon=True,
                             name="watchdog-wait")
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            return False, None             # abandoned: daemon thread leaks
        if "error" in box:
            raise box["error"]
        return True, box.get("value")

    def wait(self, fn: Callable, what: str, step: int):
        """Run ``fn`` under the timeout ladder; raises ``CheckTimeout``
        after the final retry expires."""
        for attempt in range(self.retries + 1):
            ok, value = self._attempt(fn, self.timeout_s)
            if ok:
                return value
            self.timeouts += 1
            kind = "retry" if attempt < self.retries else "timeout"
            self.event(kind, step,
                       f"{what} exceeded {self.timeout_s:g}s "
                       f"(attempt {attempt + 1})")
        raise CheckTimeout(f"{what} at step {step} still unresolved after "
                           f"{self.retries + 1} x {self.timeout_s:g}s")


def wait_ready(value, deadline_s: Optional[float], what: str,
               poll_s: float = 0.001):
    """Block until a device future reports ready, with a deadline.

    Used by ``BoundaryTransport`` on recv: a transfer whose producer died
    turns into a ``BoundaryTimeout`` (a loud, localized failure) instead of
    an infinite stall inside the schedule.  Values without an ``is_ready``
    probe (numpy, plain tensors) pass straight through — the subsequent use
    blocks natively, exactly as before."""
    if deadline_s is None:
        return value
    probe = getattr(value, "is_ready", None)
    if probe is None:
        return value
    t0 = time.monotonic()
    wait = poll_s
    while not probe():
        if time.monotonic() - t0 > deadline_s:
            raise BoundaryTimeout(f"{what} not ready after {deadline_s:g}s")
        time.sleep(wait)
        wait = min(wait * 2, 0.05)
    return value


@dataclass
class DegradationController:
    """Sampling-degradation policy: trade check *coverage* for progress.

    ``note(step, stalled)`` is called once per would-be-checked step.
    ``degrade_after`` consecutive stalled steps double the effective
    ``check_every`` (up to ``max_mult`` x the base); the same count of
    consecutive healthy checked steps recovers one halving.  Transitions
    emit events through ``on_event``.
    """
    check_every: int
    degrade_after: int = 3
    max_mult: int = 8
    on_event: Optional[Callable[[WatchdogEvent], None]] = None
    mult: int = 1
    _stalled: int = 0
    _healthy: int = 0
    events: list = field(default_factory=list)

    @property
    def effective_check_every(self) -> int:
        return self.check_every * self.mult

    @property
    def degraded(self) -> bool:
        return self.mult > 1

    def _emit(self, kind: str, step: int) -> None:
        ev = WatchdogEvent(step, kind,
                           f"effective check_every -> "
                           f"{self.effective_check_every}")
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def note(self, step: int, stalled: bool) -> None:
        if stalled:
            self._stalled += 1
            self._healthy = 0
            if (self._stalled >= self.degrade_after
                    and self.mult < self.max_mult):
                self.mult *= 2
                self._stalled = 0
                self._emit("degrade", step)
        else:
            self._healthy += 1
            self._stalled = 0
            if self._healthy >= self.degrade_after and self.mult > 1:
                self.mult //= 2
                self._healthy = 0
                self._emit("recover", step)
