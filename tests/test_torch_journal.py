"""Journals cross between the packages: identical records give identical
bytes; each package reads the other's journal and stops at a torn tail or
a CRC mismatch; ``JournalState`` gives the same resume step, epochs and
flagged steps on the same record sequence."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import canonical as JC  # noqa: E402
from repro.core.checker import report_from_errs as j_report  # noqa: E402
from repro.core.thresholds import Thresholds as JThr  # noqa: E402
from repro.supervise import journal as jj  # noqa: E402
from repro_torch.core.checker import report_from_errs as t_report  # noqa: E402
from repro_torch.core.thresholds import Thresholds as TThr  # noqa: E402
from repro_torch.supervise import journal as tj  # noqa: E402

PACKAGES = {"jax": (jj, j_report, JThr), "port": (tj, t_report, TThr)}
CONFIG = {"steps": 8, "check_every": 1, "async_window": 2, "ckpt_every": 2,
          "reestimate_every": 2, "seed": 0, "drift_alpha": 0.125}
ENTRIES = [(JC.KIND_ACT, "layers.0.mlp/input", None),
           (JC.KIND_ACT, "layers.0.mlp/output", None),
           (JC.KIND_PARAM_POST, "layers.0.mlp.up.w", None)]


def _records(pkg):
    """A run's record sequence, built from each package's own reports and
    thresholds (so the payload builders are crossed too)."""
    mod, report, Thr = PACKAGES[pkg]
    thr = Thr(eps=2.0 ** -24, per_tensor={
        JC.KIND_ACT: {"layers.0.mlp/input": 3.5e-7}})
    recs = [("start", dict(CONFIG))]
    for k in range(6):
        recs.append(("step", {"step": k, "checked": True}))
        if k == 2:
            recs.append(("epoch", {"from_step": 2,
                                   "thresholds": mod.thresholds_to_payload(thr),
                                   "kind_mult": {JC.KIND_ACT: 4.0},
                                   "reestimated": True}))
        if k % 2 == 0:
            recs.append(("ckpt", {"step": k}))
        errs = [1e-8 * (k + 1), float("nan") if k == 4 else 2e-9,
                0.5 if k == 3 else 1e-9]
        rep = report(ENTRIES, errs, thr, thr_scale={JC.KIND_ACT: 8.0})
        if k < 5:
            recs.append(("verdict", {"step": k,
                                     "report": mod.report_to_payload(rep)}))
    recs.append(("watchdog", {"step": 5, "kind": "retry", "detail": "x"}))
    return recs


def _write(pkg, path, recs):
    j = PACKAGES[pkg][0].Journal(path, fsync=False)
    for etype, fields in recs:
        j.append(etype, **fields)
    j.close()


@pytest.fixture
def journals(tmp_path):
    paths = {}
    for pkg in PACKAGES:
        paths[pkg] = str(tmp_path / pkg / "journal.jsonl")
        _write(pkg, paths[pkg], _records(pkg))
    return paths


def test_identical_records_give_identical_bytes(journals):
    with open(journals["jax"], "rb") as f:
        a = f.read()
    with open(journals["port"], "rb") as f:
        b = f.read()
    assert a == b and a.count(b"\n") == len(_records("jax"))


def _same_events(a, b):
    """Event lists equal, NaN == NaN."""
    def norm(x):
        if isinstance(x, float) and math.isnan(x):
            return "nan"
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x
    return norm(a) == norm(b)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_journal(journals, writer, reader):
    events = PACKAGES[reader][0].Journal.read(journals[writer])
    own = PACKAGES[writer][0].Journal.read(journals[writer])
    assert len(events) == len(_records(writer))
    assert _same_events(events, own)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
@pytest.mark.parametrize("damage", ["torn_tail", "crc_mismatch"])
def test_reader_stops_at_the_damage(journals, writer, reader, damage):
    path = journals[writer]
    lines = open(path).read().splitlines(keepends=True)
    if damage == "torn_tail":
        with open(path, "a") as f:
            f.write('{"t":"step","step"')            # SIGKILL mid-append
        want = len(lines)
    else:
        lines[3] = lines[3].replace('"step":', '"step":9', 1)   # payload rot
        with open(path, "w") as f:
            f.writelines(lines)
        want = 3
    events = PACKAGES[reader][0].Journal.read(path)
    assert len(events) == want


RESUME_CASES = {
    # (events, durable checkpoints)
    "all_verdicts": ([{"t": "start", **CONFIG, "reestimate_every": 0}]
                     + [{"t": "step", "step": k, "checked": True}
                        for k in range(6)]
                     + [{"t": "verdict", "step": k, "report": None}
                        for k in range(4)], [0, 2, 4, 6]),
    "missing_verdict": ([{"t": "start", **CONFIG, "reestimate_every": 0}]
                        + [{"t": "step", "step": k, "checked": True}
                           for k in range(6)]
                        + [{"t": "verdict", "step": k, "report": None}
                           for k in (0, 1, 2)], [0, 2, 4, 6]),
    "pending_epoch": ([{"t": "start", **CONFIG}]
                      + [{"t": "step", "step": k, "checked": False}
                         for k in range(6)], [0, 2, 4, 6]),
    "untrained": ([{"t": "start", **CONFIG, "reestimate_every": 0},
                   {"t": "step", "step": 0, "checked": False}], [0, 2, 4]),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_journal_state_agrees(case):
    events, ckpts = RESUME_CASES[case]
    if case == "pending_epoch":
        thr = jj.thresholds_to_payload(JThr(eps=2.0 ** -24))
        events = events + [{"t": "epoch", "from_step": 2, "thresholds": thr,
                            "kind_mult": {}, "reestimated": True}]
    js, ts = jj.JournalState(events), tj.JournalState(events)
    assert ts.resume_step(ckpts) == js.resume_step(ckpts)
    assert ts.last_trained == js.last_trained
    assert ts.reestimations == js.reestimations
    assert [s for s, _, _ in ts.epochs_below(9)] == \
        [s for s, _, _ in js.epochs_below(9)]
    assert ts.config_mismatches(CONFIG) == js.config_mismatches(CONFIG)


def test_journal_state_of_a_written_run_agrees(journals):
    """The full record sequence, each package reading the other's file:
    the same verdicts (flags, loud records), epochs and resume step."""
    js = jj.JournalState(tj.Journal.read(journals["port"]))
    ts = tj.JournalState(jj.Journal.read(journals["jax"]))
    assert ts.resume_step([0, 2, 4, 6]) == js.resume_step([0, 2, 4, 6]) == 4
    assert ts.flagged_below(9) == js.flagged_below(9) == [3, 4]
    assert sorted(ts.verdicts) == sorted(js.verdicts) == list(range(5))
    for k in ts.verdicts:
        a, b = ts.verdicts[k], js.verdicts[k]
        assert [(r.kind, r.name, r.flagged, r.note) for r in a.records] == \
            [(r.kind, r.name, r.flagged, r.note) for r in b.records]
        np.testing.assert_array_equal([r.rel_err for r in a.records],
                                      [r.rel_err for r in b.records])
        assert a.localized == b.localized
    (s1, t1, m1), = ts.epochs_below(9)
    (s2, t2, m2), = js.epochs_below(9)
    assert (s1, m1) == (s2, m2) and t1.per_tensor == t2.per_tensor
