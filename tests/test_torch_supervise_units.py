"""Unit properties of the supervised loop's parts — async pipeline, trace
ring, checkpoint keeper, background writer, watchdog, degradation
controller, fault injector — held to the JAX package's own properties
(``tests/test_supervisor.py``, ``tests/test_fault_tolerance.py``): each
property is written once and run against both packages (``pkg``).  Plus
the port's own: the check future honours ``is_ready`` / ``__array__``, a
hung future reaches the watchdog's ladder, and a ring entry keeps its
step's values after the next step."""
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.supervise as JS  # noqa: E402
import repro.supervise.pipeline as JP  # noqa: E402
import repro_torch.supervise as TS  # noqa: E402
import repro_torch.supervise.pipeline as TP  # noqa: E402
from repro.core import canonical as C  # noqa: E402
from repro.core.checker import report_from_errs as j_report  # noqa: E402
from repro.core.collector import Trace as JTrace  # noqa: E402
from repro.core.thresholds import Thresholds as JThr  # noqa: E402
from repro_torch.core.checker import report_from_errs as t_report  # noqa: E402
from repro_torch.core.collector import Trace as TTrace  # noqa: E402
from repro_torch.core.relerr_engine import NormsFuture  # noqa: E402
from repro_torch.core.thresholds import Thresholds as TThr  # noqa: E402

EPS = 2.0 ** -24


def _pkg(name):
    if name == "jax":
        return SimpleNamespace(S=JS, P=JP, Trace=JTrace, Thr=JThr,
                               report=j_report, arr=lambda a: a,
                               state=lambda a: a)
    return SimpleNamespace(S=TS, P=TP, Trace=TTrace, Thr=TThr,
                           report=t_report, arr=torch.from_numpy,
                           state=torch.from_numpy)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return _pkg(request.param)


def _mk_trace(pkg, val: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    a = pkg.arr
    tr = pkg.Trace()
    tr.activations = {"m1/input": a(base + val), "m1/output": a(2 * base + val)}
    tr.act_grads = {"m1/input": a(base - val)}
    tr.param_grads = {"m1.w": a(base * 3 + val)}
    tr.main_grads = {"m1.w": a(base * 3 + val)}
    tr.params_post = {"m1.w": a(base * 5 + val)}
    tr.loss = float(val)
    tr.grad_norm = 1.0
    tr.meta["fwd_order"] = ["m1/input", "m1/output"]
    return tr


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def test_pipeline_backpressure_bounds_in_flight(pkg):
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=2)
    resolved = []
    for k in range(7):
        ref = _mk_trace(pkg, 0.0, seed=k)
        cand = _mk_trace(pkg, 0.0 if k != 4 else 1.0, seed=k)
        resolved += pipe.submit(k, ref, cand)
        assert pipe.in_flight <= 2
    resolved += pipe.drain()
    assert pipe.in_flight == 0 and pipe.max_in_flight <= 2
    assert [c.step for c in resolved] == list(range(7))
    assert [c.step for c in resolved if c.flagged] == [4]


def test_pipeline_sync_mode_matches_async(pkg):
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=3)
    ref, cand = _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.5)
    a = (pipe.submit(1, ref, cand) + pipe.drain())[0].report
    s = pipe.check_sync(1, ref, cand).report
    assert [r.flagged for r in a.records] == [r.flagged for r in s.records]
    assert [r.rel_err for r in a.records] == [r.rel_err for r in s.records]
    assert a.localized == s.localized


def test_pipeline_scales(pkg):
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=1,
                                    drift_alpha=0.25)
    assert pipe.scales(0) == {k: 1.0 for k in pipe.kinds}
    s5 = pipe.scales(5)
    assert s5[C.KIND_ACT] == pipe.kind_mult[C.KIND_ACT] * (1 + 0.25 * 5)
    assert s5[C.KIND_PARAM_POST] == 1.0 * (1 + 0.25 * 5)


def test_pipeline_poll_drains_without_is_ready(pkg, monkeypatch):
    def plain_sq_norms(la, lb):
        out = np.zeros((len(la), 2), np.float64)
        for i, (a, b) in enumerate(zip(la, lb)):
            d = _host(a).astype(np.float64) - _host(b).astype(np.float64)
            out[i] = [(d * d).sum(), (_host(a).astype(np.float64) ** 2).sum()]
        return out                       # a plain array: no is_ready

    monkeypatch.setattr(pkg.P, "sq_norms_async", plain_sq_norms)
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=2)
    assert pipe.submit(0, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0)) == []
    done = []
    for _ in range(4):
        done += pipe.poll()
    assert [c.step for c in done] == [0] and pipe.in_flight == 0


def test_pipeline_swap_thresholds_is_epoch_scoped(pkg):
    thr0 = pkg.Thr(eps=EPS)
    pipe = pkg.S.AsyncCheckPipeline(thr0, window=2, drift_alpha=0.0,
                                    kind_mult=pkg.S.REESTIMATED_KIND_MULT)
    thr1 = pkg.Thr(eps=EPS, per_tensor={C.KIND_ACT: {"m1/input": 0.5}})
    pipe.swap_thresholds(thr1, step=4)
    assert pipe.thresholds_for(3) is thr0 and pipe.thresholds_for(9) is thr1
    for k, m in pkg.S.SUPERVISED_KIND_MULT.items():
        assert pkg.S.REESTIMATED_KIND_MULT[k] <= m
    old = pipe.check_sync(3, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))
    new = pipe.check_sync(5, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))

    def thr_of(chk):
        return [r.threshold for r in chk.report.records
                if r.name == "m1/input" and r.kind == C.KIND_ACT][0]
    assert thr_of(new) > thr_of(old)


def test_pending_epoch_settles_before_dependent_check(pkg):
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=2)
    fresh = pkg.Thr(eps=EPS, per_tensor={C.KIND_ACT: {"m/x": 0.125}})
    resolved = []

    def resolve():
        resolved.append(True)
        return fresh

    pipe.schedule_epoch(3, resolve)
    assert pipe.thresholds_for(2).per_tensor == {} and not resolved
    assert pipe.thresholds_for(3).per_tensor[C.KIND_ACT]["m/x"] == 0.125
    assert resolved and pipe.epochs_settled == 1


def test_thresholds_union_only_widens(pkg):
    a = pkg.Thr(eps=EPS, per_tensor={C.KIND_ACT: {"x": 1e-6, "y": 3e-6}})
    b = pkg.Thr(eps=EPS, per_tensor={C.KIND_ACT: {"x": 2e-6},
                                     C.KIND_PARAM_GRAD: {"w": 1e-7}})
    u = a.union(b)
    assert u.per_tensor[C.KIND_ACT] == {"x": 2e-6, "y": 3e-6}
    assert u.per_tensor[C.KIND_PARAM_GRAD] == {"w": 1e-7}
    assert a.per_tensor[C.KIND_ACT]["x"] == 1e-6


@pytest.mark.parametrize("errs,loud", [([1e-9, float("nan")], ["m1/output"]),
                                       ([1e-9, float("inf")], ["m1/output"]),
                                       ([1e-9, 1e-9], [])])
def test_non_finite_rel_err_is_loud(pkg, errs, loud):
    entries = [(C.KIND_ACT, "m1/input", None), (C.KIND_ACT, "m1/output", None)]
    rep = pkg.report(entries, errs, pkg.Thr(eps=EPS))
    assert [r.name for r in rep.loud] == loud
    assert rep.passed == (not loud)


# ---------------------------------------------------------------------------
# the port's check future
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self):
        self.done = False
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_norms_future_honours_is_ready_and_array():
    host = torch.tensor([[1.0, 4.0], [0.0, 0.0]])
    ready = NormsFuture(host)
    assert ready.is_ready()
    np.testing.assert_array_equal(np.asarray(ready, np.float64),
                                  [[1.0, 4.0], [0.0, 0.0]])
    ev = _Event()
    pending = NormsFuture(host, ev)
    assert not pending.is_ready() and ev.waited == 0
    arr = np.asarray(pending, np.float64)      # waits on the event
    assert ev.waited == 1 and pending.is_ready()
    assert arr.dtype == np.float64 and arr[0, 1] == 4.0


def test_sq_norms_async_on_cpu_is_resolved():
    from repro_torch.core.relerr_engine import (section_sq_norms,
                                                sq_norms_async)
    gen = torch.Generator().manual_seed(0)
    la = [torch.randn(3000, generator=gen), torch.randn(7, 5, generator=gen)]
    lb = [x + 1e-3 for x in la]
    fut = sq_norms_async(la, lb)
    assert fut.is_ready()
    np.testing.assert_allclose(np.asarray(fut, np.float64),
                               section_sq_norms(la, lb, mode="loop"),
                               rtol=1e-5)


def test_hung_check_reaches_the_watchdog_ladder(pkg):
    """A future that never resolves: the pipeline's watchdog retries, times
    out and escalates to the sync fallback; without evidence the check is
    LOST, loudly."""
    wd = pkg.S.Watchdog(timeout_s=0.05, retries=1)
    pipe = pkg.S.AsyncCheckPipeline(pkg.Thr(eps=EPS), window=1)
    pipe.watchdog = wd
    inj = pkg.S.make_injector("hang_check", 1)
    pipe.tap_future = inj.check_future
    kept = {}
    pipe.fallback = lambda step: pipe.check_sync(step, *kept[step])
    for k in range(3):
        kept[k] = (_mk_trace(pkg, 0.0, k), _mk_trace(pkg, 0.0, k))
    done = pipe.submit(0, *kept[0]) + pipe.submit(1, *kept[1])
    assert pipe.saturated
    done += pipe.submit(2, *kept[2]) + pipe.drain()
    assert [c.step for c in done] == [0, 1, 2]
    assert pipe.rescued == 2 and not any(c.flagged for c in done)
    assert [e.kind for e in wd.events] == ["retry", "timeout",
                                           "sync_fallback"] * 2
    pipe.fallback = lambda step: (_ for _ in ()).throw(KeyError("gone"))
    pipe.submit(3, *kept[2])
    lost = pipe.drain()[0]
    assert pipe.lost == 1 and "check lost" in lost.report.missing[0]


# ---------------------------------------------------------------------------
# trace ring
# ---------------------------------------------------------------------------

def test_ring_eviction_spills_and_prunes(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=2, spill_dir=str(tmp_path), spill_keep=3)
    for k in range(8):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, k + 0.5))
    assert ring.in_memory == [6, 7] and ring.on_disk == [3, 4, 5]
    ref, _ = ring.get(4)
    np.testing.assert_array_equal(_host(ref.activations.raw("m1/input")),
                                  _host(_mk_trace(pkg, 4.0).activations.raw(
                                      "m1/input")))
    assert ref.meta["fwd_order"] == ["m1/input", "m1/output"]
    with pytest.raises(KeyError):
        ring.get(0)


def test_ring_pinned_steps_survive(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=2, spill_dir=str(tmp_path), spill_keep=1)
    for k in range(4):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
    assert ring.pin(1)
    for k in range(4, 9):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
    assert 1 in ring.on_disk
    assert len([s for s in ring.on_disk if s != 1]) == 1
    assert ring.get(1)[0].loss == 1.0


def test_ring_without_spill_drops_unpinned_keeps_pinned(pkg):
    ring = pkg.S.TraceRing(window=2, spill_dir=None)
    for k in range(3):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
    ring.pin(1)
    for k in range(3, 6):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
    assert set(ring.in_memory) == {1, 4, 5} and ring.pin(0) is False
    with pytest.raises(KeyError):
        ring.get(2)


@pytest.mark.parametrize("background", [False, True])
def test_ring_pins_win_eviction_races(pkg, tmp_path, background):
    ring = pkg.S.TraceRing(window=2, spill_dir=str(tmp_path), spill_keep=2,
                           background=background)
    for k in range(10):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
        if k == 4:
            assert ring.pin(2)
    ring.flush()
    assert 2 in ring.on_disk
    assert len([s for s in ring.on_disk if s != 2]) <= 2
    assert ring.get(2)[0].loss == 2.0 and ring.in_memory == [8, 9]


def test_background_ring_get_serves_queued_steps(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path), background=True)
    ring.put(0, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))
    ring.put(1, _mk_trace(pkg, 1.0), _mk_trace(pkg, 1.0))
    assert ring.get(0)[0].loss == 0.0
    ring.flush()
    assert ring.get(0)[0].loss == 0.0


def test_save_load_trace_roundtrip(pkg, tmp_path):
    tr = _mk_trace(pkg, 0.25)
    pkg.S.save_trace(str(tmp_path / "t"), tr, step=3)
    back = pkg.S.load_trace(str(tmp_path / "t"))
    for f in ("activations", "act_grads", "param_grads", "main_grads",
              "params_post"):
        a, b = getattr(tr, f), getattr(back, f)
        assert list(a) == list(b)
        for n in a:
            np.testing.assert_array_equal(_host(a.raw(n)), _host(b.raw(n)))
    assert back.loss == tr.loss


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_spilled_traces_cross_between_packages(tmp_path, writer, reader):
    w, r = _pkg(writer), _pkg(reader)
    tr = _mk_trace(w, 0.5)
    w.S.save_trace(str(tmp_path / "t"), tr, step=1)
    back = r.S.load_trace(str(tmp_path / "t"))
    assert back.loss == 0.5 and back.meta["fwd_order"] == tr.meta["fwd_order"]
    np.testing.assert_array_equal(_host(back.params_post.raw("m1.w")),
                                  _host(tr.params_post.raw("m1.w")))


def _wait_for(pred, timeout_s=5.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("condition not reached in time")
        time.sleep(0.01)


def test_ring_reraises_writer_death_on_next_put_and_restarts(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path), background=True)
    ring.fault_hook = lambda step: (pkg.S.WriterDeath(f"died at {step}")
                                    if step == 0 else None)
    ring.put(0, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))
    ring.put(1, _mk_trace(pkg, 1.0), _mk_trace(pkg, 1.0))
    _wait_for(lambda: ring._writer._error is not None)
    with pytest.raises(pkg.S.WriterDeath):
        ring.put(2, _mk_trace(pkg, 2.0), _mk_trace(pkg, 2.0))
    ring.put(3, _mk_trace(pkg, 3.0), _mk_trace(pkg, 3.0))
    ring.flush()
    assert 0 not in ring.on_disk and ring.drop_count >= 1
    assert set(ring.on_disk) >= {1, 2}


def test_ring_reraises_writer_death_on_get(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path), background=True)
    ring.fault_hook = lambda step: pkg.S.WriterDeath("sick disk")
    ring.put(0, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))
    ring.put(1, _mk_trace(pkg, 1.0), _mk_trace(pkg, 1.0))
    _wait_for(lambda: ring._writer._error is not None)
    with pytest.raises(pkg.S.WriterDeath, match="sick disk"):
        ring.get(1)


def test_ring_corrupt_spill_detected_at_get(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path))
    ring.put(0, _mk_trace(pkg, 0.0), _mk_trace(pkg, 0.0))
    ring.put(1, _mk_trace(pkg, 1.0), _mk_trace(pkg, 1.0))
    root = os.path.join(str(tmp_path), "step_000000", "cand")
    shard = os.path.join(root, sorted(f for f in os.listdir(root)
                                      if f.startswith("shard_"))[0])
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(KeyError, match="corrupt"):
        ring.get(0)
    assert ring.corrupt_count == 1


def test_ring_rescan_rebuilds_spill_index(pkg, tmp_path):
    ring = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path))
    for k in range(3):
        ring.put(k, _mk_trace(pkg, float(k)), _mk_trace(pkg, float(k)))
    spilled = ring.on_disk
    fresh = pkg.S.TraceRing(window=1, spill_dir=str(tmp_path))
    assert spilled and fresh.rescan() == spilled
    assert fresh.get(spilled[0])[0].loss == float(spilled[0])


def test_ring_entry_keeps_its_step_after_the_next(tmp_path):
    """Two real steps of the port's reference step builder: step 0's ring
    entry, in memory and spilled through the background writer, still
    holds step 0's values after step 1 ran."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import make_trace_step, named_params
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("gpt-paper").reduced(), n_layers=1,
                              vocab=64)
    model = Model(cfg, device="cpu")
    params = named_params(model)
    step = make_trace_step(lambda b, ctx: model.loss(b, ctx=ctx)[0],
                           AdamW(lr=1e-2), params)
    p = {k: v.detach().clone() for k, v in params.items()}
    s = AdamW(lr=1e-2).init(p)
    for background in (False, True):
        ring = TS.TraceRing(window=1, spill_dir=str(tmp_path / str(background)),
                            background=background)
        tr0, p1, s1 = step(p, s, make_batch(cfg, 2, 8, step=0, device="cpu"))
        kept = {(f, n): getattr(tr0, f).raw(n).clone()
                for f in ("activations", "act_grads", "param_grads",
                          "main_grads", "params_post")
                for n in getattr(tr0, f)}
        ring.put(0, tr0, tr0)
        tr1, _, _ = step(p1, s1, make_batch(cfg, 2, 8, step=1, device="cpu"))
        for k in (0, 1):            # in memory, then spilled (evicted by 1)
            if k:
                ring.put(1, tr1, tr1)
                ring.flush()
                assert 0 in ring.on_disk
            ref, _ = ring.get(0)
            for (f, n), v in kept.items():
                assert torch.equal(getattr(ref, f).raw(n), v), (f, n)


# ---------------------------------------------------------------------------
# checkpoint keeper and background writer
# ---------------------------------------------------------------------------

def test_checkpoint_keeper_thins_log_spaced(pkg, tmp_path):
    keeper = pkg.S.CheckpointKeeper(str(tmp_path), keep=4)
    state = ({"w": pkg.state(np.ones(2, np.float32))},
             {"m": pkg.state(np.zeros(2, np.float32))})
    for s in range(0, 36, 4):
        keeper.save(s, state, state)
    assert len(keeper.steps) <= 5 and {0, 32} <= set(keeper.steps)
    on_disk = [d for d in os.listdir(str(tmp_path)) if d.startswith("step_")]
    assert len(on_disk) == len(keeper.steps)


def test_checkpoint_keeper_background_verify_discard(pkg, tmp_path):
    keeper = pkg.S.CheckpointKeeper(str(tmp_path), background=True)
    state = ({"w": pkg.state(np.ones(8, np.float32))},
             {"m": pkg.state(np.zeros(8, np.float32))})
    for k in (0, 2, 4):
        keeper.save(k, state, state)
    keeper.flush()
    assert keeper.steps == [0, 2, 4] and all(map(keeper.verify, [0, 2, 4]))
    root = keeper._dir(2)
    shard = os.path.join(root, sorted(f for f in os.listdir(root)
                                      if f.startswith("shard_"))[0])
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    assert not keeper.verify(2)
    keeper.discard(2)
    assert keeper.steps == [0, 4]
    assert pkg.S.CheckpointKeeper(str(tmp_path)).rescan() == [0, 4]
    (rp, _), _ = keeper.load(4, state, state)
    np.testing.assert_array_equal(_host(rp["w"]), np.ones(8, np.float32))


def test_background_writer_surfaces_error_and_survives(pkg):
    w = pkg.S.BackgroundWriter("test-writer")
    w.submit(lambda: (_ for _ in ()).throw(ValueError("disk full")))
    with pytest.raises(ValueError, match="disk full"):
        w.flush()
    assert w.alive
    ran = []
    w.submit(lambda: ran.append(1))
    w.flush()
    assert ran == [1] and w.failed_writes == 1


def test_background_writer_death_flush_does_not_hang(pkg):
    w = pkg.S.BackgroundWriter("test-writer", queue_max=4)
    w.submit(lambda: (_ for _ in ()).throw(pkg.S.WriterDeath("killed")))
    _wait_for(lambda: not w.alive)
    w._queue.put(lambda: None)
    with pytest.raises(pkg.S.WriterDeath, match="killed"):
        w.flush()
    ran = []
    w.submit(lambda: ran.append(1))
    w.flush()
    assert w.alive and ran == [1]


# ---------------------------------------------------------------------------
# watchdog, degradation, injector
# ---------------------------------------------------------------------------

def test_watchdog_returns_value_and_propagates_errors(pkg):
    wd = pkg.S.Watchdog(timeout_s=5.0, retries=0)
    assert wd.wait(lambda: 42, "quick", 0) == 42
    with pytest.raises(ValueError, match="inner"):
        wd.wait(lambda: (_ for _ in ()).throw(ValueError("inner")), "e", 1)
    assert wd.timeouts == 0


@pytest.mark.parametrize("retries", [0, 1, 2])
def test_watchdog_retries_then_times_out(pkg, retries):
    seen = []
    wd = pkg.S.Watchdog(timeout_s=0.05, retries=retries, on_event=seen.append)
    with pytest.raises(pkg.S.CheckTimeout, match="step 7"):
        wd.wait(lambda: time.sleep(30), "check transfer", 7)
    assert wd.timeouts == retries + 1
    assert [e.kind for e in seen] == ["retry"] * retries + ["timeout"]


def test_wait_ready_passthrough_and_boundary_timeout(pkg):
    plain = object()
    assert pkg.S.wait_ready(plain, 0.01, "x") is plain
    assert pkg.S.wait_ready(None, None, "x") is None

    class NeverReady:
        def is_ready(self):
            return False

    with pytest.raises(pkg.S.BoundaryTimeout, match="act 0->1"):
        pkg.S.wait_ready(NeverReady(), 0.05, "boundary act 0->1")
    fut = NormsFuture(torch.zeros(1, 2))
    assert pkg.S.wait_ready(fut, 1.0, "x") is fut


def test_degradation_controller_doubles_caps_and_recovers(pkg):
    events = []
    dc = pkg.S.DegradationController(check_every=2, degrade_after=2,
                                     max_mult=4, on_event=events.append)
    for k, stalled, want in ((0, True, 2), (2, True, 4), (4, True, 4),
                             (6, True, 8), (8, True, 8), (10, True, 8),
                             (12, False, 8), (14, False, 4),
                             (16, False, 4), (18, False, 2)):
        dc.note(k, stalled)
        assert dc.effective_check_every == want, k
    assert not dc.degraded
    assert [e.kind for e in events] == ["degrade", "degrade", "recover",
                                       "recover"]


@pytest.mark.parametrize("fault,step,match", [
    ("segfault_everything", 3, "unknown fault"), ("crash", None,
                                                  "needs --fault-step"),
    ("crash", -1, ">= 0"), (None, 3, "without --fault")])
def test_make_injector_refusals(pkg, fault, step, match):
    with pytest.raises(ValueError, match=match):
        pkg.S.make_injector(fault, step)


def test_every_fault_names_a_known_site_and_matches_the_reference():
    assert {k: (f.site, f.sticky) for k, f in TS.FAULTS.items()} == \
        {k: (f.site, f.sticky) for k, f in JS.FAULTS.items()}
    for spec in TS.FAULTS.values():
        assert spec.recovery


def test_injector_fires_exactly_at_step_unless_sticky(pkg):
    class Boom(Exception):
        pass

    def boom():
        raise Boom()

    inj = pkg.S.make_injector("crash", 3, crash_handler=boom)
    inj.step_start(2)
    assert inj.fired == 0
    with pytest.raises(Boom):
        inj.step_start(3)
    sticky = pkg.S.make_injector("hang_check", 2)
    assert sticky.check_future(1, "dev") == "dev"
    assert not sticky.check_future(4, "dev").is_ready()


def test_nan_fault_poisons_the_first_activation(pkg):
    tr = _mk_trace(pkg, 0.0)
    pkg.S.make_injector("nan_step", 2).cand_trace(2, tr)
    assert np.isnan(tr.loss)
    assert np.isnan(_host(tr.activations.raw("m1/input"))).all()
    assert not np.isnan(_host(tr.activations.raw("m1/output"))).any()


@pytest.mark.parametrize("argv", [
    ["--fault", "segfault_everything", "--fault-step", "1"],
    ["--fault", "crash"],
    ["--fault", "crash", "--fault-step", "-1"],
    ["--fault-step", "3"],
    ["--resume"],
    ["--recipe", "moe", "--arch", "gpt-paper"],
    ["--recipe", "pp", "--pp", "1"],
    ["--recipe", "pp-1f1b", "--microbatches", "1"],
    ["--recipe", "pp", "--tp", "2"],
])
def test_cli_refuses(argv):
    from repro_torch.launch import supervise as cli
    with pytest.raises(SystemExit) as ei:
        cli.main(argv + ["--device", "cpu"])
    assert ei.value.code not in (0, None)
    if "moe" in argv:
        # the reference CLI's refusal of a non-MoE arch
        assert "needs an MoE arch" in str(ei.value.code)
    if "pp" in argv or "pp-1f1b" in argv:
        # the reference CLI's own pipeline refusals
        assert any(w in str(ei.value.code) for w in (
            "needs --pp >= 2", "needs --microbatches >= 2",
            "cannot combine with shard_map flags"))
