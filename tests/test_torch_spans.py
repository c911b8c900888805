"""The check's spans and counters (``repro_torch.core.spans``) on the CPU.

* A token model's check against its tp2·sp candidate reports every span of
  its path in ``TTraceResult.seconds`` and ``counts`` (two reference runs
  in the estimate, one pack in the compare), a failing one the
  localization's spans too; the float-input model's estimate runs its pair
  once.
* On the host clock the children of a step lie inside it; under
  ``torch.profiler`` the spans nest on the profiler's timeline.
* Outside a check a span records nothing; replaced by a null context, the
  spans change no record, threshold or verdict.
* The perturbed embedding rewrite is the host perturbation of the tap,
  bit for bit, on the tap's device.
* The estimate gives the same thresholds and rewrite whether the runner
  gives the tap's shape (the direction is drawn during the base run:
  ``estimate.perturb.prefetched``), gives a wrong one or gives none
  (``redrawn``); with none, the runner's next estimate draws ahead from
  the shape it saw.  Estimates in a row with other seeds each get their
  own seed's perturbation, so the reused buffers carry nothing over.
* On the card (``cuda`` marker) the nested spans and the allocator counts
  are read from the device, the perturbation's copies are counted under
  ``estimate.perturb``, and the rewrite is the host perturbation bit for
  bit, drawn ahead or not.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core import thresholds as T  # noqa: E402
from repro_torch.core.collector import to_numpy  # noqa: E402
from repro_torch.core.generator import perturb  # noqa: E402
from repro_torch.core.harness import (make_model_runner,  # noqa: E402
                                      ttrace_check)
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import (ParallelConfig,  # noqa: E402
                                      make_candidate_runner)

ESTIMATE = ("estimate.run", "estimate.perturb", "estimate.sections")
# the runner gives the tap's shape, so the direction is drawn during the
# base run and the perturbation waits on it
TOKEN_KEYS = ("estimate", *ESTIMATE, "estimate.perturb.wait",
              "estimate.pack", "estimate.reduce",
              "candidate", "compare", "compare.pack", "compare.reduce")
LOCALIZE_KEYS = ("localize", "localize.moves", "localize.rewrites",
                 "localize.run", "localize.pack", "localize.reduce")
BUG = "tp_wrong_embedding_mask"
EMB = "embedding/output"
EPS = T.MACHINE_EPS["bfloat16"]


def setup_module():
    torch.set_num_threads(1)     # the suite runs under several workers


def _qwen(device="cpu"):
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b").reduced(),
                              n_layers=2)
    model = Model(cfg, seed=0, device=device)
    return cfg, model, make_batch(cfg, 2, 32, device=device)


def _check(cfg, model, batch, bugs=(), device="cpu"):
    opt = AdamW(lr=1e-3)
    cand = make_candidate_runner(cfg, ParallelConfig(
        tp=2, sp=True, bugs=frozenset(bugs)), model, opt, device=device)
    return ttrace_check(make_model_runner(model, opt, device=device), cand,
                        batch, seed=7)


@pytest.fixture(scope="module")
def qwen():
    return _qwen()


@pytest.fixture(scope="module")
def clean(qwen):
    return _check(*qwen)


@pytest.fixture(scope="module")
def failing(qwen):
    return _check(*qwen, bugs=(BUG,))


def test_token_model_check_reports_every_span(clean):
    assert clean.passed
    assert set(clean.seconds) == set(TOKEN_KEYS)
    assert set(clean.counts) == {k + ".calls" for k in TOKEN_KEYS} | {
        "estimate.perturb.prefetched"}
    assert clean.counts["estimate.perturb.prefetched"] == 1
    assert clean.counts["estimate.run.calls"] == 2
    assert clean.counts["estimate.perturb.calls"] == 1
    assert clean.counts["compare.pack.calls"] == 1
    assert all(v > 0 for v in clean.seconds.values())
    # the steps come first in the order they ran, as before the spans
    assert [k for k in clean.seconds if "." not in k] == \
        ["estimate", "candidate", "compare"]


def test_failing_check_reports_the_localization_spans(failing):
    assert not failing.passed and failing.localized_module == "embedding"
    assert set(failing.seconds) == set(TOKEN_KEYS + LOCALIZE_KEYS)
    assert failing.counts["localize.run.calls"] == 2
    assert failing.counts["localize.moves.calls"] == 2      # out and back
    assert failing.counts["localize.rewrites.calls"] == 1


def test_steps_hold_their_children_on_the_host_clock(clean, failing):
    for res in (clean, failing):
        s = res.seconds
        assert sum(s[k] for k in ESTIMATE) <= s["estimate"]
        assert s["estimate.pack"] + s["estimate.reduce"] <= \
            s["estimate.sections"]
        assert s["compare.pack"] + s["compare.reduce"] <= s["compare"]
    s = failing.seconds
    assert s["localize.moves"] + s["localize.rewrites"] + s["localize.run"] \
        + s["localize.pack"] + s["localize.reduce"] <= s["localize"]


def test_float_input_model_runs_its_pair_once():
    cfg = get_config("hubert-xlarge").reduced()
    model = Model(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    run = make_model_runner(model, opt, device="cpu")
    res = ttrace_check(run, run, make_batch(cfg, 2, 16, device="cpu"))
    assert res.passed
    assert res.counts["estimate.run.calls"] == 1
    assert res.counts["estimate.perturb.calls"] == 1
    assert sum(res.seconds[k] for k in ESTIMATE) <= res.seconds["estimate"]


def test_spans_nest_on_the_profiler_timeline(qwen):
    cfg, model, _ = qwen
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        _check(cfg, model, make_batch(cfg, 1, 8, device="cpu"))
    ev = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            ev.setdefault(e.name, []).append(e.time_range)
    for name in TOKEN_KEYS:
        assert spans.PREFIX + name in ev, name

    def inside(inner, outer):
        return all(any(o.start <= i.start and i.end <= o.end for o in
                       ev[spans.PREFIX + outer])
                   for i in ev[spans.PREFIX + inner])

    assert len(ev["ttrace.check"]) == 1
    assert inside("estimate.perturb", "estimate")
    assert inside("estimate", "check")
    assert inside("compare.pack", "compare")
    # each span once a call: no device mirror, no duplicate
    assert len(ev["ttrace.estimate.run"]) == 2


def test_no_check_no_record(qwen):
    cfg, model, batch = qwen
    seen = []
    run = make_model_runner(model, AdamW(lr=1e-3), device="cpu")

    def watched(b, rewrites=None):
        seen.append(spans.active())
        return run(b, rewrites)

    thr, _ = T.estimate_thresholds(watched, batch, T.MACHINE_EPS["float32"])
    assert thr.per_tensor and seen == [None, None]
    with spans.span("pack"):
        spans.count("d2h_bytes", 8)          # no log: nowhere to add
    assert spans.active() is None


def test_counts_land_under_the_innermost_span():
    with spans.check() as log:
        with spans.span("estimate"):
            with spans.span("perturb"):
                spans.count("h2d_bytes", 8)
                with spans.span("compare"):         # not a step in a step
                    pass
            spans.count("d2h_bytes", 4)
            spans.count("d2h_bytes", 0)
    assert log.counts == {"estimate.calls": 1, "estimate.perturb.calls": 1,
                          "estimate.perturb.h2d_bytes": 8,
                          "estimate.compare.calls": 1,
                          "estimate.d2h_bytes": 4}
    assert list(log.seconds) == ["estimate", "estimate.perturb",
                                 "estimate.compare"]


def _outcome(res):
    reps = [res.report] + ([res.localization] if res.localization else [])
    return ([[(r.kind, r.name, r.rel_err, r.threshold, r.flagged)
              for r in rep.records] for rep in reps],
            res.thresholds.per_tensor, res.passed, res.localized_module)


def test_spans_change_no_result(qwen, failing, monkeypatch):
    monkeypatch.setattr(spans, "span",
                        lambda *a, **k: contextlib.nullcontext())
    bare = _check(*qwen, bugs=(BUG,))
    assert not bare.counts
    assert _outcome(bare) == _outcome(failing)


def test_rewrite_is_the_host_perturbation_on_the_tap_device(qwen):
    cfg, model, batch = qwen
    run = make_model_runner(model, AdamW(lr=1e-3), device="cpu")
    base = run(batch)
    tap = base.activations.raw("embedding/output")
    eps = T.MACHINE_EPS["bfloat16"]
    b2, rew = T.perturbed_batch_or_rewrites(batch, base, eps, seed=3)
    x = rew["embedding/output"]
    assert b2 is batch and isinstance(x, torch.Tensor)
    assert x.device == tap.device and x.dtype == torch.float32
    want = perturb(to_numpy(tap), eps, seed=3)
    np.testing.assert_array_equal(x.numpy(), want)


def _recording(run, hint):
    """A runner over ``run`` that keeps the rewrites each run was given and
    gives the tap's shape as ``hint`` says."""
    rewrites = []

    def rec(batch, rw=None):
        rewrites.append(rw)
        return run(batch, rw)

    if hint == "runner's":
        rec.tap_shape = run.tap_shape
    elif hint == "wrong":
        rec.tap_shape = lambda batch: (1, 2, 3)
    return rec, rewrites


def _estimate(run, batch, seed):
    with spans.check() as log, spans.span("estimate"):
        thr, base = T.estimate_thresholds(run, batch, EPS, seed=seed)
    return thr, base, log.counts


@pytest.fixture(scope="module")
def runner(qwen):
    cfg, model, batch = qwen
    return make_model_runner(model, AdamW(lr=1e-3), device="cpu"), batch


@pytest.fixture(scope="module")
def plain(runner):
    run, batch = runner
    return _estimate(run, batch, 5)


@pytest.mark.parametrize("hint", ["runner's", "wrong", "none"])
def test_estimate_is_the_same_with_or_without_the_tap_shape(runner, plain,
                                                            hint):
    run, batch = runner
    rec, rewrites = _recording(run, hint)
    thr, base, counts = _estimate(rec, batch, 5)
    assert thr.per_tensor == plain[0].per_tensor
    tap = base.activations.raw(EMB)
    np.testing.assert_array_equal(rewrites[1][EMB].numpy(),
                                  perturb(to_numpy(tap), EPS, seed=5))
    ahead = hint == "runner's"
    assert counts.get("estimate.perturb.prefetched", 0) == ahead
    assert counts.get("estimate.perturb.redrawn", 0) == (not ahead)
    assert ("estimate.perturb.wait.calls" in counts) == ahead
    # the next estimate of the same runner draws ahead from what it saw
    thr2, _, counts2 = _estimate(rec, batch, 5)
    assert counts2["estimate.perturb.prefetched"] == 1
    assert thr2.per_tensor == plain[0].per_tensor
    np.testing.assert_array_equal(rewrites[3][EMB].numpy(),
                                  rewrites[1][EMB].numpy())


def test_estimates_in_a_row_get_their_own_seeds(runner, plain):
    run, batch = runner
    rec, rewrites = _recording(run, "runner's")
    tap = plain[1].activations.raw(EMB)
    for seed in (6, 7, 5):
        thr, _, counts = _estimate(rec, batch, seed)
        assert counts["estimate.perturb.prefetched"] == 1
        np.testing.assert_array_equal(rewrites[-1][EMB].numpy(),
                                      perturb(to_numpy(tap), EPS, seed))
    assert not np.array_equal(rewrites[1][EMB].numpy(),
                              rewrites[3][EMB].numpy())
    assert thr.per_tensor == plain[0].per_tensor


@pytest.mark.cuda
def test_card_reads_the_device_clock_and_the_allocator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' events and the "
                    "allocator's counts are the card's")
    cfg, model, batch = _qwen("cuda")
    res = _check(cfg, model, batch, device="cuda")
    assert res.passed and set(res.seconds) == set(TOKEN_KEYS)
    for key in ("estimate", "candidate", "compare", "estimate.pack",
                "compare.pack"):
        for what in ("alloc_retries", "device_allocs", "device_frees"):
            assert res.counts[f"{key}.{what}"] >= 0
    tap = 2 * 32 * cfg.d_model * 4          # the f32 embedding output
    assert res.counts["estimate.perturb.d2h_bytes"] == tap
    assert res.counts["estimate.perturb.h2d_bytes"] == tap
    # the perturbed run copies no rewrite: its batch leaves were moved
    # already
    assert "estimate.run.h2d_bytes" not in res.counts
    s = res.seconds
    assert sum(s[k] for k in ESTIMATE) <= s["estimate"] * 1.01


@pytest.mark.cuda
def test_card_rewrite_is_the_host_perturbation():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned copies and the "
                    "rewrite's float32 operations run there")
    cfg, model, batch = _qwen("cuda")
    run = make_model_runner(model, AdamW(lr=1e-3), device="cuda")
    # the buffers of one estimate serve the next, each with its own seed's;
    # a runner without the tap's shape draws ahead from its second estimate
    hinted, bare = _recording(run, "runner's"), _recording(run, "none")
    for (rec, rewrites), seed, key in ((hinted, 5, "prefetched"),
                                       (bare, 6, "redrawn"),
                                       (bare, 7, "prefetched")):
        _, base, counts = _estimate(rec, batch, seed)
        tap = base.activations.raw(EMB)
        rew = rewrites[-1][EMB]
        assert rew.device == tap.device and rew.dtype == torch.float32
        np.testing.assert_array_equal(rew.cpu().numpy(),
                                      perturb(to_numpy(tap), EPS, seed))
        nbytes = tap.numel() * 4
        assert counts["estimate.perturb.d2h_bytes"] == nbytes
        assert counts["estimate.perturb.h2d_bytes"] == nbytes
        assert counts[f"estimate.perturb.{key}"] == 1
