"""First-bad-step bisection over supervisor checkpoints: the port of
``repro/supervise/bisect.py``.

Online detection can lag the actual divergence: checks may be subsampled
(``check_every > 1``), resolve late (async window), or a slow update-path
drift may cross the threshold only steps after the buggy update started
(stale ZeRO gathers, drifting tied embeddings).  When a flag lands, the
supervisor wants the FIRST step at which the candidate left the reference
beyond FP explanation — that is where the buggy code ran.

Two-phase search, O(log C) cheap probes + one bounded replay:

1. **Checkpoint binary search.**  The supervisor saves both sides' full
   (params, opt_state) every ``ckpt_every`` steps (bit-exact sharded-npz
   round trip).  Comparing the two sides' *parameters* at a checkpoint is a
   cheap divergence probe — no training, one batched reduction — so binary
   search over checkpoints brackets the divergence to one checkpoint
   interval and, crucially, finds the latest provably-good restore point.
2. **Sync replay.**  Restore both sides at that checkpoint and re-run the
   lockstep loop with synchronous per-step checking until a step flags.
   Replay is deterministic (stateless data generator + bit-exact restore +
   the same compiled steps), so the first flagged replay step IS the first
   bad step of the original run.  Both the divergence probe and the replay
   checks evaluate each step against the pipeline's threshold schedule for
   THAT step (``AsyncCheckPipeline.thresholds_for`` — with periodic
   re-estimation, the epoch the step originally trained under), so the
   replay verdicts reproduce the online ones.

The probe and replay are recipe-agnostic: they only assume the candidate's
persistent state is a ``(params, opt_state)`` tree with reference-named
param leaves — true for the distributed and FP8 ``CandidateStep``
implementations alike.

The resulting step report is then handed to the existing localization
machinery (propagation/backward/optimizer modes, and rewrite-mode
isolation when the divergence is in the forward pass).
"""
from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint.store import (MANIFEST, ChecksumError,
                                          host_snapshot, load_checkpoint,
                                          load_checkpoint_named,
                                          save_checkpoint)
from repro_torch.supervise.pipeline import StepCheck
from repro_torch.supervise.store import BackgroundWriter


class CheckpointKeeper:
    """Periodic dual-side (reference, candidate) training-state checkpoints.

    ``step`` indexes the state BEFORE that step runs: the step-0 checkpoint
    is the initial state, the step-k checkpoint is after steps 0..k-1.

    Disk use is bounded like the trace ring: when more than ``keep``
    checkpoints accumulate, retention thins to log-spaced steps (doubling
    stride, always keeping step 0 and the newest), which preserves the
    binary-search probe's O(log) bracketing at coarser granularity instead
    of growing linearly with run length.

    ``background=True`` routes the serialization through a bounded-queue
    ``BackgroundWriter`` (same machinery as the trace ring's spill path):
    ``save`` takes host copies without waiting for the device
    (``host_snapshot``), enqueues them and returns; the writer waits for
    the copies and serializes while training dispatches ahead.  Every read path —
    ``load``, ``load_params_named``, ``verify`` — flushes the queue first,
    so bisection never restores a checkpoint that is still in flight.
    A writer failure surfaces on the next ``save()`` (and at ``flush()``),
    after which the worker restarts.
    """

    def __init__(self, root: str, keep: int = 16, background: bool = False,
                 queue_max: int = 2):
        self.root = root
        self.keep = keep
        self._stride = 1
        os.makedirs(root, exist_ok=True)
        self.steps: list[int] = []
        self._lock = threading.Lock()
        self._writer = (BackgroundWriter("ckpt-writer", queue_max=queue_max)
                        if background else None)
        #: fires after a checkpoint write lands (supervisor journals it;
        #: the fault harness corrupts payloads here)
        self.on_save: Optional[Callable[[int, str], None]] = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:06d}")

    def save(self, step: int, ref_state, cand_state) -> None:
        """``*_state`` are ``(params, opt_state)`` trees.  The background
        path hands the writer host copies taken here, on the loop's
        thread: the writer never reads device tensors."""
        tree = {"ref": {"params": ref_state[0], "opt": ref_state[1]},
                "cand": {"params": cand_state[0], "opt": cand_state[1]}}
        if self._writer is not None:
            err = self._writer.take_error()
            if err is not None:
                raise err
            host, wait = host_snapshot(tree)
            self._writer.submit(lambda: self._write(step, host, wait))
        else:
            self._write(step, tree)

    def _write(self, step: int, tree, wait=None) -> None:
        if wait is not None:
            wait()
        save_checkpoint(self._dir(step), tree, step=step)
        with self._lock:
            if step not in self.steps:
                self.steps.append(step)
                self.steps.sort()
        self._prune()
        if self.on_save is not None:
            self.on_save(step, self._dir(step))

    def flush(self) -> None:
        """Block until every queued save landed; re-raise a writer error.
        Called before every restore and before any bisection."""
        if self._writer is not None:
            self._writer.flush()

    def stop(self) -> None:
        """End the save worker thread (drains first; restarts on the next
        ``save``) — end-of-run teardown, not a terminal state."""
        if self._writer is not None:
            self._writer.stop()

    def verify(self, step: int) -> bool:
        """Full CRC verification of a checkpoint (host read of every
        piece).  The resume path uses this to trust only checkpoints that
        survived the crash intact."""
        self.flush()
        try:
            load_checkpoint_named(self._dir(step))
            return True
        except (ChecksumError, FileNotFoundError):
            return False

    def rescan(self) -> list[int]:
        """Rebuild the step index from disk (the resume path: a previous
        incarnation's checkpoints become addressable again)."""
        found = []
        if os.path.isdir(self.root):
            for d in sorted(os.listdir(self.root)):
                if d.startswith("step_") and os.path.exists(
                        os.path.join(self.root, d, MANIFEST)):
                    found.append(int(d[len("step_"):]))
        with self._lock:
            self.steps = sorted(set(self.steps) | set(found))
        return found

    def discard(self, step: int) -> None:
        """Drop a checkpoint that failed verification (corrupt payload) so
        bisection and resume stop considering it."""
        with self._lock:
            if step in self.steps:
                self.steps.remove(step)
        shutil.rmtree(self._dir(step), ignore_errors=True)

    def _prune(self) -> None:
        if not self.keep:
            return
        doomed = []
        with self._lock:
            while len(self.steps) > self.keep:
                self._stride *= 2
                newest = self.steps[-1]
                removed = False
                for s in list(self.steps):
                    if s in (0, newest) or s % self._stride == 0:
                        continue
                    doomed.append(self._dir(s))
                    self.steps.remove(s)
                    removed = True
                if not removed:
                    break          # only {0, newest} left (keep < 2)
        for d in doomed:
            shutil.rmtree(d, ignore_errors=True)

    def load_params_named(self, step: int):
        """Host-only restore of just the two PARAM trees as flat
        ``{name: CPU tensor}`` dicts — the cheap divergence probe's payload
        (no optimizer state, no device placement)."""
        self.flush()
        named, _, _ = load_checkpoint_named(self._dir(step))
        ref = {k[len("ref.params."):]: v for k, v in named.items()
               if k.startswith("ref.params.")}
        cand = {k[len("cand.params."):]: v for k, v in named.items()
                if k.startswith("cand.params.")}
        return ref, cand

    def load(self, step: int, ref_template, cand_template):
        """Returns ``((ref_params, ref_opt), (cand_params, cand_opt))``,
        placed like the template trees (bit-exact values)."""
        self.flush()
        template = {"ref": {"params": ref_template[0],
                            "opt": ref_template[1]},
                    "cand": {"params": cand_template[0],
                             "opt": cand_template[1]}}
        tree, _, _ = load_checkpoint(self._dir(step), template)
        return ((tree["ref"]["params"], tree["ref"]["opt"]),
                (tree["cand"]["params"], tree["cand"]["opt"]))


@dataclass
class BisectResult:
    first_bad_step: int
    check: StepCheck              # the sync replay report at that step
    replay_from: int              # latest provably-good checkpoint
    probes: list = field(default_factory=list)   # [(ckpt_step, diverged)]
    replayed_steps: int = 0

    def summary(self) -> str:
        probes = ", ".join(f"{s}:{'BAD' if d else 'ok'}"
                           for s, d in self.probes) or "none"
        return (f"bisection: first bad step {self.first_bad_step} "
                f"(replayed {self.replayed_steps} steps from checkpoint "
                f"{self.replay_from}; checkpoint probes: {probes})")


def bisect_first_bad(ckpt_steps, flagged_step: int,
                     diverged: Callable[[int], bool],
                     replay: Callable[[int, int], Optional[StepCheck]]
                     ) -> BisectResult:
    """Find the first bad step given a flag at ``flagged_step``.

    ``diverged(ckpt_step)`` — cheap parameter-divergence probe at a
    checkpoint.  ``replay(start, end)`` — restore at ``start`` and re-run
    with sync checks, returning the first flagged StepCheck (or None if
    nothing flags up to ``end`` — the caller's online flag then stands).
    """
    cands = sorted(s for s in ckpt_steps if 0 < s <= flagged_step)
    good, probes = 0, []
    lo, hi = 0, len(cands) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        d = bool(diverged(cands[mid]))
        probes.append((cands[mid], d))
        if d:
            hi = mid - 1
        else:
            good = cands[mid]
            lo = mid + 1
    check = replay(good, flagged_step)
    if check is None:
        # replay found nothing below threshold-schedule — keep the online
        # flag as the answer (conservative; should not happen with a
        # deterministic replay)
        return BisectResult(flagged_step, StepCheck(flagged_step, None),
                            good, probes, flagged_step - good + 1)
    return BisectResult(check.step, check, good, probes,
                        check.step - good + 1)
