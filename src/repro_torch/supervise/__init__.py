"""Streaming training supervisor: online TTrace over multi-step runs; the
port of ``repro/supervise``.

The paper's workflow (§3) checks ONE training step; the silent bugs it
targets — stale ZeRO updates, drifting tied embeddings, stale FP8 scales —
express across *many* optimizer steps.  This subsystem runs reference and
candidate training loops in lockstep over N steps and checks every step
online:

* ``runner``   — the lockstep driver (``Supervisor``): one compiled step per
  side, params/opt_state threaded through, periodic checkpoints;
* ``pipeline`` — double-buffered async checking: step-k reductions enqueue on
  device while step k+1 trains, bounded in-flight window with backpressure;
* ``store``    — spill-to-disk trace ring buffer (sharded manifests);
  flagged steps are pinned, memory stays flat over long runs;
* ``bisect``   — checkpoint bisection + sync replay to the FIRST bad step,
  handing that step to the existing rewrite-mode localizer;
* ``journal``  — append-only fsync'd per-step record; a SIGKILLed run
  resumes from it (``Supervisor.resume``) and converges to the same
  verdicts and first-bad-step as an uninterrupted run;
* ``watchdog`` — timeout/retry/sync-fallback ladder around host-blocking
  waits, plus graceful degradation of checking to sampling when the
  pipeline saturates;
* ``faults``   — the loud-fault injection registry (crash, hung check,
  NaN step, corrupt spill/checkpoint, dead writer) the above is
  evaluated against.
"""
from repro_torch.supervise.bisect import (  # noqa: F401
    BisectResult, CheckpointKeeper, bisect_first_bad)
from repro_torch.supervise.faults import (  # noqa: F401
    FAULTS, FaultInjector, FaultSpec, make_injector)
from repro_torch.supervise.journal import (  # noqa: F401
    Journal, JournalState, journal_path)
from repro_torch.supervise.pipeline import (  # noqa: F401
    REESTIMATED_KIND_MULT, SUPERVISED_KIND_MULT, AsyncCheckPipeline,
    StepCheck)
from repro_torch.supervise.runner import (  # noqa: F401
    CandidateStep, SuperviseConfig, SuperviseResult, Supervisor)
from repro_torch.supervise.store import (  # noqa: F401
    BackgroundWriter, TraceRing, WriterDeath, load_trace, save_trace)
from repro_torch.supervise.watchdog import (  # noqa: F401
    BoundaryTimeout, CheckTimeout, DegradationController, LoudFault,
    Watchdog, WatchdogEvent, wait_ready)
