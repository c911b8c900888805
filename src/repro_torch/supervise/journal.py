"""Supervision journal: the durable record a killed run resumes from; the
port of ``repro/supervise/journal.py``, byte-compatible with it (each
package reads the other's journal, and identical records give identical
lines).

A supervised run's state is scattered across a process (async pipeline
entries, threshold epochs, the result-in-progress) and a work dir
(checkpoints, spilled traces).  The process half dies with a SIGKILL; the
journal makes it reconstructible: an append-only, per-record-checksummed,
fsync'd JSONL file in the work dir recording every durable fact the loop
establishes —

* ``step``    — step k trained on both sides (and whether a check was
  submitted for it, so resume knows which verdicts to expect);
* ``verdict`` — the resolved online check of step k, full ``Report``
  payload (records, merge problems, localization);
* ``epoch``   — a threshold epoch settled into the pipeline (the merged
  per-tensor estimates + kind multipliers, keyed by its from-step);
* ``ckpt`` / ``spill`` — a checkpoint / trace-spill landed on disk;
* ``degrade`` / ``recover`` / ``watchdog`` / ``loud`` — watchdog
  escalations, sampling-degradation transitions and loud-failure events;
* ``start`` / ``resume`` / ``end`` — run lifecycle (the ``start`` record
  pins the determinism-relevant config so a mismatched resume is refused).

Each line is ``<json>\\t<crc32 of the json text>``: a torn tail write (the
usual SIGKILL artifact) fails its checksum and reading stops there — every
record BEFORE the tear was fsync'd and is trusted.  ``Supervisor.resume``
replays the journal to rebuild ``SuperviseResult`` verdicts and the
pipeline's threshold-epoch schedule, picks the newest durable checkpoint
consistent with the journaled history, and re-enters the lockstep loop
from it; determinism of the loop (stateless batch generator, bit-exact
checkpoint restore, once-compiled steps) makes the resumed run converge to
the same verdicts and first-bad-step as an uninterrupted one.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import zlib
from typing import Any, Optional

from repro_torch.core.checker import CheckRecord, Report
from repro_torch.core.thresholds import Thresholds

JOURNAL_NAME = "journal.jsonl"


def journal_path(work_dir: str) -> str:
    return os.path.join(work_dir, JOURNAL_NAME)


class Journal:
    """Append-only fsync'd event log with per-record checksums.

    ``append`` only enqueues the record — serialization, the page-cache
    write, and the ``os.fsync`` all happen on a dedicated writer thread
    that group-commits: one fsync covers every record drained since the
    last one.  The hot loop therefore never blocks on a syscall or a
    thread wake (on a saturated 2-core host even a 2 KB write costs
    milliseconds of scheduling latency, and fsync tail latency on shared
    disks is bimodal).  A SIGKILL loses at most the records still queued
    or since the last commit, which the resume machinery already
    tolerates: the reader stops at the torn tail and ``resume_step``
    simply picks an earlier durable checkpoint — late durability costs
    resume *distance*, never verdict correctness.  ``close`` drains the
    queue, so any in-process read-after-close sees every record."""

    _CLOSE = object()

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._lock = threading.Lock()   # background writers journal too
        self.appended = 0
        self.syncs = 0
        self._writer = threading.Thread(target=self._write_loop,
                                        name="journal-writer", daemon=True)
        self._writer.start()

    def append(self, etype: str, **fields: Any) -> None:
        with self._lock:
            if self._closed:
                # end-of-run teardown: a background writer landing after
                # close() (or a post-run diagnosis call) has nothing
                # durable left to record — the run already ended
                return
            self._q.put({"t": etype, **fields})
            self.appended += 1

    @staticmethod
    def _encode(rec: dict) -> str:
        text = json.dumps(rec, separators=(",", ":"))
        return f"{text}\t{zlib.crc32(text.encode()):08x}\n"

    def _write_loop(self) -> None:
        while True:
            rec = self._q.get()
            if rec is Journal._CLOSE:
                break
            batch = [rec]
            while True:            # group-commit everything already queued
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is Journal._CLOSE:
                    batch.append(None)
                    break
                batch.append(nxt)
            closing = batch and batch[-1] is None
            if closing:
                batch.pop()
            try:
                self._f.writelines(self._encode(r) for r in batch)
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())
                    self.syncs += 1
            except (OSError, ValueError):
                return             # file gone under us: teardown race
            if closing:
                break

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(Journal._CLOSE)
        self._writer.join(timeout=10.0)
        if not self._f.closed:
            self._f.close()

    # ---- reading -----------------------------------------------------------
    @staticmethod
    def read(path: str) -> list[dict]:
        """Replay the journal; stops at the first torn/corrupt record (a
        SIGKILL mid-append) — everything before it was fsync'd and valid."""
        events: list[dict] = []
        if not os.path.exists(path):
            return events
        with open(path, encoding="utf-8") as f:
            for line in f:
                text, _, crc = line.rstrip("\n").rpartition("\t")
                if not text:
                    break
                try:
                    if int(crc, 16) != zlib.crc32(text.encode()):
                        break
                    events.append(json.loads(text))
                except (ValueError, json.JSONDecodeError):
                    break
        return events


# ---------------------------------------------------------------------------
# payload (de)serialization
# ---------------------------------------------------------------------------

def report_to_payload(rep: Optional[Report]) -> Optional[dict]:
    if rep is None:
        return None
    return {
        "records": [[r.kind, r.name, r.rel_err, r.threshold,
                     bool(r.flagged), r.note] for r in rep.records],
        "merge_problems": list(rep.merge_problems),
        "missing": list(rep.missing),
        "localized": rep.localized,
        "mode": rep.localization_mode,
    }


def report_from_payload(p: Optional[dict]) -> Optional[Report]:
    if p is None:
        return None
    rep = Report(records=[CheckRecord(k, n, float(e), float(t), bool(fl),
                                      note)
                          for k, n, e, t, fl, note in p["records"]],
                 merge_problems=list(p["merge_problems"]),
                 missing=list(p["missing"]))
    rep.localized = p["localized"]
    rep.localization_mode = p["mode"]
    return rep


def thresholds_to_payload(thr: Thresholds) -> dict:
    return {"eps": thr.eps, "margin": thr.margin,
            "floor_mult": thr.floor_mult,
            "per_tensor": {k: dict(v) for k, v in thr.per_tensor.items()}}


def thresholds_from_payload(p: dict) -> Thresholds:
    return Thresholds(eps=float(p["eps"]), margin=float(p["margin"]),
                      floor_mult=float(p["floor_mult"]),
                      per_tensor={k: {n: float(e) for n, e in v.items()}
                                  for k, v in p["per_tensor"].items()})


# ---------------------------------------------------------------------------
# resume-state reconstruction
# ---------------------------------------------------------------------------

class JournalState:
    """Everything ``Supervisor.resume`` needs, replayed from the journal."""

    #: ``start``-record fields that must match the resuming supervisor's
    #: config — a drifted value would silently change verdicts
    CONFIG_KEYS = ("steps", "check_every", "async_window", "ckpt_every",
                   "reestimate_every", "seed", "drift_alpha")

    def __init__(self, events: list[dict]):
        self.events = events
        self.start: Optional[dict] = None
        self.verdicts: dict[int, Optional[Report]] = {}
        self.checked_steps: set[int] = set()
        self.trained_steps: set[int] = set()
        self.epochs: list[tuple[int, Thresholds, dict]] = []
        self.reestimations = 0
        self.resumes = 0
        self.degradations: list[dict] = []
        self.loud: list[dict] = []
        for ev in events:
            t = ev["t"]
            if t == "start" and self.start is None:
                self.start = ev
            elif t == "step":
                self.trained_steps.add(int(ev["step"]))
                if ev.get("checked"):
                    self.checked_steps.add(int(ev["step"]))
            elif t == "verdict":
                self.verdicts[int(ev["step"])] = report_from_payload(
                    ev["report"])
            elif t == "epoch":
                self.epochs.append((int(ev["from_step"]),
                                    thresholds_from_payload(ev["thresholds"]),
                                    dict(ev["kind_mult"])))
                if ev.get("reestimated"):
                    self.reestimations += 1
            elif t == "resume":
                self.resumes += 1
            elif t in ("degrade", "recover"):
                self.degradations.append(ev)
            elif t == "loud":
                self.loud.append(ev)

    @property
    def last_trained(self) -> int:
        return max(self.trained_steps, default=-1)

    def config_mismatches(self, config: dict) -> list[str]:
        if self.start is None:
            return []
        return [f"{k}: journal={self.start.get(k)!r} run={config.get(k)!r}"
                for k in self.CONFIG_KEYS
                if self.start.get(k) != config.get(k)]

    def resume_step(self, durable_ckpts: list[int]) -> int:
        """The newest checkpoint the run can restart from and still converge
        to the uninterrupted run's verdicts: every check submitted for a
        step BELOW it must have a journaled verdict (unresolved in-flight
        checks died with the process and must be recomputed), and every
        re-estimation step below it must have a journaled (settled) epoch —
        an estimate still pending at the kill died in flight, and only
        re-running its step can reproduce it."""
        R = (int(self.start.get("reestimate_every") or 0)
             if self.start else 0)
        settled = {s for s, _, _ in self.epochs}
        best = 0
        for c in sorted(durable_ckpts):
            if c > self.last_trained + 1:
                break
            if any(s not in self.verdicts
                   for s in self.checked_steps if s < c):
                break
            if R and any(e not in settled for e in range(R, c, R)):
                break
            best = c
        return best

    def epochs_below(self, step: int) -> list[tuple[int, Thresholds, dict]]:
        return [(s, thr, km) for s, thr, km in self.epochs if 0 < s < step]

    def flagged_below(self, step: int) -> list[int]:
        return sorted(s for s, rep in self.verdicts.items()
                      if s < step and rep is not None and not rep.passed)
