"""Loud-fault injection registry — the evaluation surface for fault
tolerance (sibling of ``bugs/registry.py``, which injects *silent* bugs):
the port of ``repro/supervise/faults.py``.

Where the bug registry proves the checker catches wrong *numerics*, this
registry proves the supervisor survives wrong *machinery*: the process
dying, a device future hanging, NaN poisoning a step, disk payloads
rotting.  Each fault names a hook site inside the supervised loop; the
``FaultInjector`` is threaded through the supervisor (``--fault NAME
--fault-step K`` on the CLI) and fires at its site when the step matches.

Faults and their expected recovery:

* ``crash``             — SIGKILL at the top of step K; recovery is
  ``Supervisor.resume`` from the journal + last durable checkpoint.
* ``hang_check``        — every check future from step K on never becomes
  ready; the watchdog ladder rescues each (sync recompute from the trace
  ring) and sustained saturation degrades checking to sampling.
* ``nan_step``          — NaN/Inf poisons the candidate trace (loss +
  first activation) at step K; classified as a LOUD failure by the
  checker, localized, reported separately from threshold flags.
* ``corrupt_spill``     — bytes of step K's spilled candidate payload are
  flipped after the write; the checksum rejects the payload at load.
* ``truncate_ckpt``     — the step-K checkpoint loses the tail of a shard;
  detected at load, bisection falls back to an earlier checkpoint.
* ``dead_spill_writer`` — the background spill-writer thread dies at step
  K; the ring re-raises the stored error on the next ``put``/``get`` and
  restarts the worker.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class FaultSpec:
    fault_id: str
    description: str
    site: str            # hook site inside the supervised loop
    sticky: bool = False  # fire at every step >= K (else exactly at K)
    recovery: str = ""    # what tolerating this fault looks like


FAULTS: dict[str, FaultSpec] = {f.fault_id: f for f in [
    FaultSpec("crash",
              "SIGKILL the supervisor process at the top of step K",
              site="step_start",
              recovery="journaled resume from the last durable checkpoint"),
    FaultSpec("hang_check",
              "check futures from step K on never become ready",
              site="check_future", sticky=True,
              recovery="watchdog sync-fallback per check; sustained "
                       "saturation degrades checking to sampling"),
    FaultSpec("nan_step",
              "NaN poisons the candidate loss + first activation at step K",
              site="cand_trace",
              recovery="classified LOUD by the checker, localized, "
                       "reported separately from threshold flags"),
    FaultSpec("corrupt_spill",
              "flip bytes of step K's spilled candidate payload",
              site="post_spill",
              recovery="checksum rejects the payload at load"),
    FaultSpec("truncate_ckpt",
              "truncate a shard of the step-K checkpoint",
              site="post_ckpt",
              recovery="checksum rejects the restore; bisection falls "
                       "back to an earlier checkpoint"),
    FaultSpec("dead_spill_writer",
              "kill the background spill-writer thread at step K",
              site="spill_writer",
              recovery="ring re-raises the writer error on next put/get "
                       "and restarts the worker"),
]}


class _HungFuture:
    """A device-future stand-in that never resolves: ``is_ready`` stays
    False and any materialization attempt blocks past every watchdog
    timeout (the watchdog abandons the worker thread stuck here)."""

    def __init__(self, inner):
        self._inner = inner

    def is_ready(self) -> bool:
        return False

    def __array__(self, dtype=None):
        time.sleep(3600.0)
        raise RuntimeError("hung future materialized past the watchdog")


def make_injector(fault: Optional[str], fault_step: Optional[int],
                  crash_handler: Optional[Callable[[], None]] = None
                  ) -> Optional["FaultInjector"]:
    """Validate and build an injector (the CLI's refusal path lives here).

    Raises ``ValueError`` for an unknown fault name, a missing step, or a
    negative step — never silently ignores a malformed spec."""
    if fault is None:
        if fault_step is not None:
            raise ValueError("--fault-step given without --fault")
        return None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} — registered faults: "
                         f"{', '.join(sorted(FAULTS))}")
    if fault_step is None:
        raise ValueError(f"--fault {fault} needs --fault-step K "
                         f"(the step the fault fires at)")
    if fault_step < 0:
        raise ValueError(f"--fault-step must be >= 0, got {fault_step}")
    return FaultInjector(fault, fault_step, crash_handler=crash_handler)


class FaultInjector:
    """One armed fault, fired by the supervisor's hook sites.

    ``crash_handler`` defaults to a true SIGKILL (the CLI path); tests
    inject a raising handler to simulate the kill in-process — the journal
    fsyncs every record, so an abrupt abort at the same point is
    indistinguishable from the signal."""

    def __init__(self, fault_id: str, step: int,
                 crash_handler: Optional[Callable[[], None]] = None):
        self.spec = FAULTS[fault_id]
        self.step = int(step)
        self.fired = 0
        self.crash_handler = crash_handler or self._sigkill

    @staticmethod
    def _sigkill() -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    def fires(self, site: str, step: int) -> bool:
        if site != self.spec.site:
            return False
        hit = step >= self.step if self.spec.sticky else step == self.step
        return hit

    # ---- sites -------------------------------------------------------------
    def step_start(self, step: int) -> None:
        if self.fires("step_start", step):
            self.fired += 1
            self.crash_handler()

    def check_future(self, step: int, dev):
        if self.fires("check_future", step):
            self.fired += 1
            return _HungFuture(dev)
        return dev

    def cand_trace(self, step: int, trace):
        if self.fires("cand_trace", step):
            self.fired += 1
            trace.loss = float("nan")
            acts = trace.section("activation")
            for name in acts:
                acts[name] = torch.full(acts.shape_of(name), float("nan"),
                                        device=acts.raw(name).device)
                break
        return trace

    def post_spill(self, step: int, root: str) -> None:
        """Flip bytes in the middle of the candidate payload's first
        shard — a checksum-detectable corruption, not a missing file."""
        if not self.fires("post_spill", step):
            return
        self.fired += 1
        _corrupt_first_shard(os.path.join(root, "cand"))

    def post_ckpt(self, step: int, root: str) -> None:
        if not self.fires("post_ckpt", step):
            return
        self.fired += 1
        shard = _first_shard(root)
        if shard is not None:
            size = os.path.getsize(shard)
            with open(shard, "r+b") as f:
                f.truncate(max(size // 2, 1))

    def spill_writer(self, step: int) -> Optional[BaseException]:
        if self.fires("spill_writer", step):
            self.fired += 1
            from repro_torch.supervise.store import WriterDeath
            return WriterDeath(
                f"injected spill-writer death at step {step}")
        return None


def _first_shard(root: str) -> Optional[str]:
    try:
        shards = sorted(f for f in os.listdir(root)
                        if f.startswith("shard_"))
    except FileNotFoundError:
        return None
    return os.path.join(root, shards[0]) if shards else None


def _corrupt_first_shard(root: str) -> None:
    shard = _first_shard(root)
    if shard is None:
        return
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk) or b"\xff")
