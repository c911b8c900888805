"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* A reduced train step (remat on, two microbatches), prefill and decode
  step count the same flops, bytes accessed and peak live bytes under
  ``CostMode`` on the meta device as on the CPU.
* Two sampled microbatches scaled to ``n_micro`` 4 give the full run's
  flops, bytes accessed and temp bytes exactly.
* The reference's cost-model globals (``UNROLL_BLOCKWISE``,
  ``FORCE_NAIVE``, ``UNROLL_SCAN``, ``COST_MODE``) exist because XLA
  counts a loop body once; eager PyTorch dispatches every iteration, so
  counted on meta ``attention_blockwise`` at S 4096 has the naive path's
  forward flops, and ``chunked_cross_entropy`` the plain cross entropy's.
* ``qwen1.5-110b`` (111 B parameters) builds on meta, every leaf there.
  The CLI on one full-width pair gives a record with the reference's
  keys; it skips what ``supports_shape`` refuses, cuts depth, batch and
  length where asked, and exits 1 on a failure.
* The reduced ``gpt-paper`` candidate step at dp2·cp2·tp2·sp gives the
  same collective report (``parallel/mesh.collective_log``) and flops on
  the CPU and on meta.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.core.collector import named_params  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.hlo import collective_report  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel import mesh as pmesh  # noqa: E402
from repro_torch.parallel.api import (ParallelConfig,  # noqa: E402
                                      make_candidate_train_step)

# the reference dry run's record keys (``repro/launch/dryrun.py``)
REF_KEYS = {"arch", "shape", "status", "n_micro", "multi_pod", "mesh",
            "compile_s", "flops", "bytes_accessed", "per_device",
            "collectives"}
PER_DEVICE = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def setup_module():
    one_thread()


def _cfg(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), n_layers=2,
                               vocab=256, scan_layers=True, remat=True, **kw)


def _counts(cfg, kind, device):
    """CostMode's (flops, bytes, peak) of one step on ``device``, after a
    first step outside the mode (the rope table is made once a device)."""
    model = Model(cfg, device=device)
    batch = make_batch(cfg, 4, 32, device="cpu")
    if device == "meta":
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    if kind == "train":
        params = {k: p.detach() for k, p in named_params(model).items()}
        opt = AdamW(lr=1e-3)
        step = TS.make_train_step(model, opt, n_micro=2)
        st = opt.init(params)
        run = lambda: step(params, st, batch)   # noqa: E731
    elif kind == "prefill":
        step = TS.make_prefill_step(model)
        run = lambda: step(batch)   # noqa: E731
    else:
        step = TS.make_serve_step(model)
        cache = model.init_cache(4, 32)
        tokens = batch["tokens"][:, :1]
        run = lambda: step(cache, {"tokens": tokens, "pos": 31})  # noqa
    run()
    mode = D.CostMode()
    with mode:
        out = run()
    del out
    return mode.flops, mode.bytes, mode.peak


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_meta_counts_match_the_cpu(name, kind):
    cfg = _cfg(name)
    cpu, meta = _counts(cfg, kind, "cpu"), _counts(cfg, kind, "meta")
    assert cpu == meta
    assert meta[0] > 0 and meta[1] > 0 and meta[2] > 0


def test_two_sampled_microbatches_scale_to_the_full_run():
    cfg = _cfg("tinyllama-1.1b")
    shape = InputShape("t", 32, 8, "train")
    mesh = make_host_mesh()
    sampled = D.dryrun_config(cfg, shape, mesh, n_micro=4)
    full = D.dryrun_config(cfg, shape, mesh, n_micro=4, sample_micro=None)
    assert sampled["microbatches_run"] == 2 and "microbatches_run" not in full
    assert sampled["n_micro"] == full["n_micro"] == 4
    for k in ("flops", "bytes_accessed"):
        assert sampled[k] == full[k], k
    assert sampled["per_device"] == full["per_device"]
    # the same tokens in two microbatches: the same matmuls
    assert D.dryrun_config(cfg, shape, mesh, n_micro=2)["flops"] == \
        full["flops"]


def _flops(fn, *args):
    mode = D.CostMode()
    with mode:
        fn(*args)
    return mode.flops


def test_cost_globals_need_no_counterpart():
    """The blockwise attention and the chunked cross entropy count their
    every block: the naive and plain paths' forward flops."""
    meta = dict(device="meta")
    q = torch.empty(1, 4096, 2, 16, **meta)
    k = torch.empty(1, 4096, 1, 16, **meta)
    v = torch.empty(1, 4096, 1, 16, **meta)
    naive = _flops(A.attention_ref, q, k, v)
    assert naive == 2 * 2 * (2 * 4096 * 4096 * 16)
    assert _flops(A.attention_blockwise, q, k, v) == naive
    assert _flops(A.attention, q, k, v) == naive          # S > 2048
    h = torch.empty(2, 2048, 64, **meta)
    e = torch.empty(512, 64, **meta)
    labels = torch.empty(2, 2048, dtype=torch.int64, **meta)
    plain = _flops(lambda: L.cross_entropy(L._logits(h, e), labels))
    assert plain == 2 * 2 * 2048 * 512 * 64
    assert _flops(lambda: L.chunked_cross_entropy(h, e, labels,
                                                  chunk=512)) == plain


def test_largest_config_builds_on_meta():
    model = Model(get_config("qwen1.5-110b"), device="meta")
    leaves = named_params(model)
    assert all(p.is_meta for p in leaves.values())
    assert sum(p.numel() for p in leaves.values()) == 111209914368


def test_cli_record_has_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert D.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                   "--host", "--out", str(out)]) == 0
    rec, = json.loads(out.read_text())
    assert REF_KEYS <= set(rec) and set(rec["per_device"]) == PER_DEVICE
    assert rec["status"] == "ok" and rec["device"] == "meta"
    assert rec["mesh"] == {"data": 1, "model": 1} and rec["bound"] is None
    pd = rec["per_device"]
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"]
    parts = rec["argument_parts"]
    assert parts["params"] == 1100048384 * 2                 # bf16
    assert parts["cache"] == 22 * 2 * 128 * 32768 * 4 * 64 * 2
    assert rec["collectives"]["total"]["count"] == 0
    assert "1x1] OK" in capsys.readouterr().out
    assert D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                   "--host", "--out", str(out)]) == 0
    assert json.loads(out.read_text())[0]["status"] == "skip"
    assert D.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                   "--host", "--layers", "2", "--batch", "4", "--seq", "64",
                   "--out", str(out)]) == 0
    cut, = json.loads(out.read_text())
    assert cut["cut"] == {"n_layers": 2, "global_batch": 4, "seq_len": 64}
    assert cut["argument_parts"]["cache"] == 2 * 2 * 4 * 64 * 4 * 64 * 2


def test_cli_exits_1_on_a_failure(monkeypatch, tmp_path):
    def broken(*a, **kw):
        raise RuntimeError("boom")
    monkeypatch.setattr(D, "dryrun_pair", broken)
    out = tmp_path / "r.json"
    assert D.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                   "--out", str(out)]) == 1
    rec, = json.loads(out.read_text())
    assert rec["status"] == "fail" and "boom" in rec["error"]


def test_candidate_collectives_match_on_the_cpu_and_meta():
    cfg = dataclasses.replace(get_config("gpt-paper").reduced(), vocab=256)
    pcfg = ParallelConfig(dp=2, cp=2, tp=2, sp=True)
    shape = InputShape("t", 32, 4, "train")
    meta = D.dryrun_candidate(cfg, shape, pcfg, verbose=False)
    model = Model(cfg, device="cpu")
    step, p0, o0 = make_candidate_train_step(cfg, pcfg, named_params(model),
                                             AdamW(lr=1e-4), device="cpu")
    batch = {k: v for k, v in make_batch(cfg, 4, 32, device="cpu").items()
             if k in ("tokens", "labels")}
    mode = D.CostMode()
    with pmesh.collective_log() as log, mode:
        step(p0, o0, batch)
    rep = collective_report(log)
    assert rep == meta["collectives"]
    assert rep["all-reduce"]["count"] > 0 and rep["all-gather"]["count"] > 0
    assert rep["reduce-scatter"]["count"] > 0
    assert mode.flops == meta["flops"]
    assert meta["n_ranks"] == 8
    assert meta["per_device"]["peak_bytes"] == \
        meta["rank_stacked_peak_bytes"] // 8
    # off by default: nothing is recorded outside the context
    step(p0, o0, batch)
    assert len(log) == rep["total"]["count"]
