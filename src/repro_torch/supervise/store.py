"""Trace ring buffer with spill-to-disk eviction for supervised runs: the
port of ``repro/supervise/store.py``.

A supervised run produces TWO full traces per step; keeping them all alive
would grow device memory linearly with run length.  ``TraceRing`` keeps the
last ``window`` steps live (device-resident, instantly available for
diagnosis when an async check resolves against them) and evicts older steps:

* with a ``spill_dir``, evicted steps are written to disk in the SAME
  sharded + JSON-manifest format as ``checkpoint.store`` (one
  directory per step, one manifest per side, CRC32 per piece so a rotted
  payload is rejected at load instead of silently feeding garbage into
  diagnosis), and the on-disk set is itself a ring of ``spill_keep`` steps;
* without one, evicted steps are dropped.

``pin(step)`` marks a step as evidence (the supervisor pins every flagged
step): pinned steps are never dropped — they are spilled on eviction even
when unpinned spill is bounded, and never pruned from disk — so the full
trace of every suspicious step survives an arbitrarily long run while
memory and disk stay flat.

With ``background=True`` the spill write itself (device->host transfer +
serialization — the ONLY blocking work in the supervised hot loop) moves
to a ``BackgroundWriter``: a worker thread behind a bounded queue shared
in design with the checkpoint keeper's writer.  Eviction takes the host
copies on the loop's thread without waiting for the device (pinned
buffers behind a CUDA event, ``checkpoint.store.host_snapshot``) and
enqueues; the writer waits for the event and serializes host arrays
only, while training dispatches ahead.  A trace's leaves are never
updated in place after its step (the steps are functional), so the
copies are of the step's own values.  The queue
bound is the backpressure (at most ``queue_max`` evicted pairs buffered
beyond the ring), pins win every race with eviction (a step is pinnable
while in memory, queued, or on disk — never silently lost in between).
A writer failure — including the worker thread itself dying — surfaces on
the NEXT ``put()``/``get()`` (and at ``flush()``), after which the worker
is restarted: a sick disk degrades spill coverage loudly, it does not
silently rot until end-of-run.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
from collections import OrderedDict
from typing import Callable, Optional

from repro_torch.checkpoint.store import (ChecksumError, host_snapshot,
                                          load_checkpoint_named,
                                          save_checkpoint)
from repro_torch.core.collector import SECTION_FIELDS, Trace


def save_trace(path: str, tr: Trace, *, step: int = 0) -> None:
    """Spill one trace as a manifest checkpoint (raw binary shards: same
    manifest/loader as the npz checkpoints, ~3x less serialization CPU —
    the spill writer shares cores with training)."""
    tree = {f: dict(getattr(tr, f).raw_items()) for f in SECTION_FIELDS}
    extra = {"loss": float(tr.loss), "grad_norm": float(tr.grad_norm),
             "fwd_order": list(tr.meta.get("fwd_order", []))}
    save_checkpoint(path, tree, step=step, extra=extra, container="raw")


def load_trace(path: str) -> Trace:
    """Reload a spilled trace (sections come back as CPU tensors).

    Raises ``ChecksumError`` when the payload fails CRC verification."""
    named, _, extra = load_checkpoint_named(path)
    tr = Trace()
    sections: dict[str, dict] = {f: {} for f in SECTION_FIELDS}
    for key, arr in named.items():
        field, _, name = key.partition(".")
        sections[field][name] = arr
    for f in SECTION_FIELDS:
        setattr(tr, f, sections[f])
    tr.loss = extra.get("loss", float("nan"))
    tr.grad_norm = extra.get("grad_norm", float("nan"))
    if extra.get("fwd_order"):
        tr.meta["fwd_order"] = list(extra["fwd_order"])
    return tr


def snapshot_pair(ref: Trace, cand: Trace):
    """``(ref_host, cand_host, wait)``: host copies of a trace pair taken
    without waiting for the device; ``wait()`` blocks until they landed."""
    tree = {side: {"sections": {f: dict(getattr(tr, f).raw_items())
                                for f in SECTION_FIELDS},
                   "loss": tr.loss, "grad_norm": tr.grad_norm}
            for side, tr in (("ref", ref), ("cand", cand))}
    host, wait = host_snapshot(tree)

    def trace_of(side: str, tr: Trace) -> Trace:
        h = host[side]
        out = Trace(loss=h["loss"], grad_norm=h["grad_norm"],
                    meta=dict(tr.meta))
        for f in SECTION_FIELDS:
            setattr(out, f, h["sections"][f])
        return out

    return trace_of("ref", ref), trace_of("cand", cand), wait


class WriterDeath(RuntimeError):
    """Raised inside a background write to kill the worker thread itself
    (the ``dead_spill_writer`` fault) — distinct from a failing write,
    which the worker survives."""


class BackgroundWriter:
    """Bounded-queue single-thread background writer with loud failure.

    ``submit(fn)`` enqueues a write closure (blocking when ``queue_max``
    writes are already pending — the backpressure bound).  The FIRST
    error any write raises is stored and re-raised by ``take_error()`` /
    ``flush()``; a ``WriterDeath`` additionally terminates the worker
    thread, which ``ensure()`` transparently restarts after the error has
    been surfaced.  Used by the trace ring's spill path and the
    checkpoint keeper's save path.
    """

    _STOP = object()

    def __init__(self, name: str, queue_max: int = 4):
        self.name = name
        self.queue_max = max(1, int(queue_max))
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.failed_writes = 0

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def ensure(self) -> None:
        if self._queue is None:
            self._queue = queue.Queue(maxsize=self.queue_max)
        if not self.alive:
            self._thread = threading.Thread(target=self._loop,
                                            name=self.name, daemon=True)
            self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self.ensure()
        self._queue.put(fn)

    def take_error(self) -> Optional[BaseException]:
        """Pop the stored writer error (None when healthy).  The caller
        re-raises it; the next ``submit`` restarts a dead worker."""
        err, self._error = self._error, None
        return err

    def flush(self) -> None:
        """Block until every queued write ran; re-raise a writer error.

        A DEAD worker cannot drain its queue — join would deadlock — so
        death is surfaced immediately instead, the queue is discarded
        (those writes are lost, which is exactly what the stored error
        reports), and the next submit starts fresh."""
        if self._queue is not None:
            if self.alive:
                self._queue.join()
            elif self._thread is not None:
                # dead worker: abandon undone writes so flush cannot hang
                try:
                    while True:
                        self._queue.get_nowait()
                        self._queue.task_done()
                except queue.Empty:
                    pass
        err = self.take_error()
        if err is not None:
            raise err

    def stop(self) -> None:
        """Drain queued writes and end the worker thread.  Restartable:
        the next ``submit``'s ``ensure()`` spawns a fresh worker, so
        post-run diagnosis (replay, rescan) keeps working — ``stop`` just
        keeps finished runs from leaking an idle thread apiece."""
        if self._queue is not None and self.alive:
            self._queue.put(BackgroundWriter._STOP)
            self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        q = self._queue
        while True:
            fn = q.get()
            if fn is BackgroundWriter._STOP:
                q.task_done()
                return
            try:
                fn()
            except WriterDeath as e:
                if self._error is None:
                    self._error = e
                self.failed_writes += 1
                q.task_done()
                return                      # the worker thread dies
            except BaseException as e:      # noqa: BLE001 — surfaced later
                if self._error is None:
                    self._error = e
                self.failed_writes += 1
                q.task_done()
            else:
                q.task_done()


class TraceRing:
    """Bounded ring of per-step (reference, candidate) trace pairs.

    ``background=True`` moves spill writes onto a ``BackgroundWriter``;
    ``flush()`` blocks until the queue drains.  All bookkeeping is
    lock-protected, so pins race safely against eviction and the writer.
    A failed or dead writer surfaces its error on the next ``put()`` /
    ``get()`` / ``flush()`` and is restarted afterwards.

    ``fault_hook(step)`` (set by the fault-injection harness) may return
    an exception to raise inside the spill write of that step;
    ``on_spill(step, root)`` fires after a spill lands (the supervisor
    journals spill manifests and the harness corrupts payloads there).
    """

    def __init__(self, window: int = 4, spill_dir: str | None = None,
                 spill_keep: int = 8, background: bool = False,
                 queue_max: int = 4):
        self.window = max(1, int(window))
        self.spill_dir = spill_dir
        self.spill_keep = max(0, int(spill_keep))
        self._mem: OrderedDict[int, tuple[Trace, Trace]] = OrderedDict()
        self._queued: OrderedDict[int, tuple] = OrderedDict()
        self._spilled: OrderedDict[int, str] = OrderedDict()
        self._pinned: set[int] = set()
        self._lock = threading.Lock()
        self.background = bool(background) and spill_dir is not None
        self._writer = (BackgroundWriter("trace-spill-writer",
                                         queue_max=queue_max)
                        if self.background else None)
        self.queue_max = max(1, int(queue_max))
        self.spill_count = 0
        self.drop_count = 0
        self.corrupt_count = 0
        self.fault_hook: Optional[Callable[[int],
                                           Optional[BaseException]]] = None
        self.on_spill: Optional[Callable[[int, str], None]] = None

    # ---- introspection -----------------------------------------------------
    @property
    def in_memory(self) -> list[int]:
        with self._lock:
            return list(self._mem)

    @property
    def on_disk(self) -> list[int]:
        with self._lock:
            return list(self._spilled)

    @property
    def pinned(self) -> set[int]:
        with self._lock:
            return set(self._pinned)

    def __contains__(self, step: int) -> bool:
        with self._lock:
            return (step in self._mem or step in self._queued
                    or step in self._spilled)

    # ---- ring --------------------------------------------------------------
    def _surface_writer_error(self) -> None:
        """Re-raise a stored writer error (the dead-writer contract: the
        error lands on the NEXT ring operation, not only at flush).  The
        worker restarts on the next enqueue."""
        if self._writer is not None:
            err = self._writer.take_error()
            if err is not None:
                raise err

    def put(self, step: int, ref: Trace, cand: Trace) -> None:
        self._mem[step] = (ref, cand)
        self._evict()
        self._surface_writer_error()

    def pin(self, step: int) -> bool:
        """Mark a step as evidence (never dropped).  False if the step was
        already evicted without spill — nothing left to preserve.  The pin
        wins races with eviction: a step still in memory, in the writer
        queue, or on disk is preserved wherever it currently lives."""
        with self._lock:
            if (step not in self._mem and step not in self._queued
                    and step not in self._spilled):
                return False
            self._pinned.add(step)
            return True

    def get(self, step: int) -> tuple[Trace, Trace]:
        self._surface_writer_error()
        with self._lock:
            if step in self._mem:
                return self._mem[step]
            queued = self._queued.get(step)  # evicted, write still pending
            root = self._spilled.get(step)
        if queued is not None:
            ref, cand, wait = queued
            wait()
            return ref, cand
        if root is not None:
            try:
                return (load_trace(os.path.join(root, "ref")),
                        load_trace(os.path.join(root, "cand")))
            except FileNotFoundError:
                # lost the race with the writer's disk pruning of an
                # unpinned step — same verdict as never having kept it
                pass
            except ChecksumError as e:
                # detected at load, reported as lost evidence — never
                # silently fed into diagnosis
                self.corrupt_count += 1
                raise KeyError(f"step {step} spill payload corrupt: {e}")
        raise KeyError(f"step {step} not retained (window={self.window}, "
                       f"spill={'on' if self.spill_dir else 'off'})")

    def flush(self) -> None:
        """Block until every queued spill write has landed on disk (no-op
        without a background writer); re-raises a failed writer's error."""
        if self._writer is not None:
            self._writer.flush()

    def stop(self) -> None:
        """End the spill worker thread (drains first; restarts on the
        next ``put``) — end-of-run teardown, not a terminal state."""
        if self._writer is not None:
            self._writer.stop()

    def rescan(self) -> list[int]:
        """Rebuild the on-disk index from ``spill_dir`` (resume path: a
        previous incarnation's spills become addressable again).  Only
        steps with both side manifests present are indexed."""
        if self.spill_dir is None or not os.path.isdir(self.spill_dir):
            return []
        found = []
        for d in sorted(os.listdir(self.spill_dir)):
            if not d.startswith("step_"):
                continue
            root = os.path.join(self.spill_dir, d)
            if all(os.path.exists(os.path.join(root, side, "manifest.json"))
                   for side in ("ref", "cand")):
                found.append((int(d[len("step_"):]), root))
        with self._lock:
            for step, root in found:
                self._spilled.setdefault(step, root)
            self._spilled = OrderedDict(sorted(self._spilled.items()))
        return [s for s, _ in found]

    def _evict(self) -> None:
        if self.spill_dir is not None:
            # memory stays flat: everything past the window spills, pinned
            # included (the disk copy is the durable one)
            while len(self._mem) > self.window:
                step, (ref, cand) = self._mem.popitem(last=False)
                if self.background:
                    self._enqueue(step, ref, cand)
                else:
                    self._spill(step, ref, cand)
                    self._prune_disk()
        else:
            # no spill backing: pinned evidence stays live and does not
            # count against the window; oldest unpinned steps drop
            with self._lock:
                unpinned = [s for s in self._mem if s not in self._pinned]
                while len(unpinned) > self.window:
                    del self._mem[unpinned.pop(0)]
                    self.drop_count += 1

    # ---- background writer -------------------------------------------------
    def _enqueue(self, step: int, ref: Trace, cand: Trace) -> None:
        snap = snapshot_pair(ref, cand)
        with self._lock:
            self._queued[step] = snap
        # bounded queue: when the writer falls behind, this blocks — the
        # explicit backpressure that keeps evicted-but-unwritten traces
        # O(queue_max) instead of unbounded
        self._writer.submit(lambda: self._write_queued(step))

    def _write_queued(self, step: int) -> None:
        try:
            with self._lock:
                queued = self._queued.get(step)
            if queued is not None:
                ref, cand, wait = queued
                wait()
                self._spill(step, ref, cand)
                with self._lock:
                    self._queued.pop(step, None)
                self._prune_disk()
        except BaseException:
            # drop the unwritable pair (memory must stay flat even when
            # the disk is sick); the writer stores the error for the next
            # ring operation to surface
            with self._lock:
                self._queued.pop(step, None)
                self.drop_count += 1
            raise

    def _spill(self, step: int, ref: Trace, cand: Trace) -> None:
        if self.fault_hook is not None:
            err = self.fault_hook(step)
            if err is not None:
                raise err
        root = os.path.join(self.spill_dir, f"step_{step:06d}")
        save_trace(os.path.join(root, "ref"), ref, step=step)
        save_trace(os.path.join(root, "cand"), cand, step=step)
        with self._lock:
            self._spilled[step] = root
            self.spill_count += 1
        if self.on_spill is not None:
            self.on_spill(step, root)

    def _prune_disk(self) -> None:
        if self.spill_dir is None:
            return
        with self._lock:
            unpinned = [s for s in self._spilled if s not in self._pinned]
            doomed = []
            while len(unpinned) > self.spill_keep:
                s = unpinned.pop(0)
                doomed.append(self._spilled.pop(s))
        for root in doomed:
            shutil.rmtree(root, ignore_errors=True)
