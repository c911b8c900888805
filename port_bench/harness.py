"""One run of one cell: set-up, the measured window of TTrace checks, and
the comparison that decides ``correct``.

Everything a cell needs is found by name (``load_cell``): its
configuration file (``BENCHMARK.json``'s ``configs[].file``), which names
its reference family (``reference/<family>.py``); its traffic mix
(``traffic/<mix>.json``: batch, sequence, the candidate's
``ParallelConfig``, injected bugs, localization, thresholds' epsilon, the
optimizer); the limits of its comparison (``limits/<cell>.json``); and a
reader for each per-layer metric (``metrics/<metric>.py``).  Each is
looked up under ``<root>/port_bench`` first, then beside this file.

A run (``run_cell``):

1. draws the weights on the device from the seed (``weights.make``) and
   loads them into the program's ``Model``; builds the reference runner
   (``make_model_runner``) and the candidate (``make_candidate_runner``);
2. runs check 0, the warm-up, through the window's own call, and keeps
   what the comparison reads of it (``judge.program_readings``);
3. runs ``ttrace_check`` on batch 1, 2, ... (drawn from the seed and the
   check's index) until ``seconds`` have passed, starting none after; with
   ``trace``, ``PROFILED`` more checks follow the window under
   ``torch.profiler`` (the window itself runs as without it).
4. frees the program, then runs the plain reference over check 0 and
   holds the two against the cell's limits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from port_bench import devtrace, judge, weights
from port_bench.reference import common

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
PROFILED = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path


def find(root: Path, sub: str, name: str, suffix: str) -> Path:
    for base in (Path(root) / "port_bench", PKG):
        path = base / sub / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {root} or {PKG}")


def load_module(path: Path):
    name = "port_bench_file_" + "".join(c if c.isalnum() else "_"
                                        for c in str(path))
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _for(entries, workload):
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=workload, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads(find(root, "traffic", w["traffic"],
                                        ".json").read_text()),
                limits=json.loads(find(root, "limits", workload,
                                       ".json").read_text())["limits"],
                end_to_end=_for(bench["end_to_end"], workload),
                per_layer=_for(bench["per_layer"], workload), root=root)


def family(cell: Cell):
    return load_module(find(cell.root, "reference", cell.config["family"],
                            ".py"))


def reader(cell: Cell, metric: str):
    return load_module(find(cell.root, "metrics", metric, ".py")).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def port_config(fam, cfg: dict):
    from repro_torch.configs.base import MoEConfig, get_config
    base = get_config(cfg["port_config"])
    fields = fam.port_fields(cfg)
    if "moe" in fields:
        fields["moe"] = dataclasses.replace(base.moe or MoEConfig(),
                                            **fields["moe"])
    return dataclasses.replace(base, **fields)


def build_model(pcfg, values: dict, dev):
    from repro_torch.core.collector import load_params, named_params
    from repro_torch.models.model import Model
    model = Model(pcfg, device="meta")
    model.to_empty(device=dev)
    params = named_params(model)
    want = {k: (tuple(p.shape), p.dtype) for k, p in params.items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in values.items()}
    if want != got:
        raise ValueError("the configuration's leaves are not the program's: "
                         f"{sorted(map(str, set(want.items()) ^ set(got.items())))[:4]}")
    load_params(params, values)
    return model


def _spanned(fn, name):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def layer_spans():
    """The benchmark's spans around the harness's calls into the
    thresholds and checker layers (the runners get theirs in
    ``run_cell``)."""
    from repro_torch.core import harness
    saved = {}
    for attr, name in (("estimate_thresholds", "bench.estimate"),
                       ("compare_traces", "bench.compare")):
        if hasattr(harness, attr):
            saved[attr] = getattr(harness, attr)
            setattr(harness, attr, _spanned(saved[attr], name))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(harness, attr, fn)


def host_state() -> dict:
    """For the run's log: the host's load (1-minute average of runnable
    tasks), its cores' mean clock (MHz, ``/proc/cpuinfo``) and the seconds
    of all its cores so far that the hypervisor gave to other machines
    (``steal`` in ``/proc/stat``)."""
    out = {"load1": round(os.getloadavg()[0], 2),
           "threads": torch.get_num_threads()}
    with contextlib.suppress(OSError, ValueError, IndexError):
        mhz = [float(line.split(":")[1]) for line in
               Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
        if mhz:
            out["mhz"] = round(sum(mhz) / len(mhz), 1)
    with contextlib.suppress(OSError, ValueError, IndexError):
        cpu = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    return out


class _Card:
    """Synchronization and peak memory of the run's device (none on the
    CPU, where only tests run)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.dev = dev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def allocator(self) -> dict:
        """The caching allocator's counts so far: retries (each frees the
        cache) and the device allocations and frees it made."""
        stats = torch.cuda.memory_stats(self.dev) if self.cuda else {}
        return {k: stats.get("num_" + k, 0)
                for k in ("alloc_retries", "device_alloc", "device_free")}

    def reset(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.dev),
               "count": 1}
        with contextlib.suppress(Exception):
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", f"--id={self.dev.index or 0}"],
                capture_output=True, text=True, timeout=20).stdout.strip()
        return out


class Program:
    """The program under test, set up for ``cell`` from ``seed`` on
    ``dev``: its ``Model`` holding the benchmark's weights (kept, for the
    comparison, as ``values`` until ``drop_values``), the reference and
    candidate runners, and ``check(i)``, the ``ttrace_check`` of batch
    ``i``."""

    def __init__(self, cell: Cell, seed: int, dev):
        from repro_torch.core.harness import make_model_runner, ttrace_check
        from repro_torch.optim.adamw import AdamW
        from repro_torch.parallel.api import (ParallelConfig,
                                              make_candidate_runner)
        cfg, tr = cell.config, cell.traffic
        fam = family(cell)
        self.values = weights.make(fam.param_specs(cfg), seed, dev)
        self.model = build_model(port_config(fam, cfg), self.values, dev)
        opt = AdamW(**tr["optimizer"])
        ref = _spanned(make_model_runner(self.model, opt, device=dev),
                       "bench.reference_run")
        pcfg = ParallelConfig(bugs=frozenset(tr["bugs"]), **tr["parallel"])
        cand = _spanned(make_candidate_runner(self.model.cfg, pcfg,
                                              self.model, opt, device=dev),
                        "bench.candidate_run")
        B, S, V = tr["batch"], tr["seq"], cfg["vocab_size"]

        def check(i):
            batch = weights.batch(V, B, S, seed, i, dev)
            return ttrace_check(ref, cand, batch, eps=tr["threshold_eps"],
                                localize=tr["localize"], seed=i)

        self.check = check

    def readings(self, res) -> dict:
        return judge.program_readings(res, self.values)

    def drop_values(self):
        self.values = None

    def close(self):
        self.values = self.model = self.check = None


def reference(cell: Cell, seed: int, dev, mm=common.FP32) -> dict:
    """``common.readings`` of the plain reference over check 0, from the
    weights and batch drawn again from ``seed`` (``mm``: ``common.FP8``
    for the control)."""
    cfg, tr = cell.config, cell.traffic
    fam = family(cell)
    values = weights.make(fam.param_specs(cfg), seed, dev)
    batch0 = weights.batch(cfg["vocab_size"], tr["batch"], tr["seq"], seed,
                           0, dev)
    return common.readings(fam, cfg, values, batch0, mm, tr["optimizer"],
                           tr["threshold_eps"], seed)


def device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t_start: float | None = None,
             log=None):
    """One run; returns ``(result, lines)``: the result line's object and
    the lines that give each number compared beside its limit."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(workload, root)
    dev = device_of(device)
    card = _Card(dev)
    common.no_tf32()
    t_init = time.perf_counter()
    prog = Program(cell, seed, dev)
    card.sync()
    t_built = time.perf_counter()

    with layer_spans():
        res = prog.check(0)
        card.sync()
        setup_s = time.perf_counter() - t_start
        readings = prog.readings(res)
        prog.drop_values()
        del res
        gc.collect()
        setup_peak = card.peak()
        log(f"{workload} seed {seed}: set-up {setup_s:.3f} s (start and "
            f"imports {t_init - t_start:.3f}, weights, model and runners "
            f"{t_built - t_init:.3f}, warm check {setup_s - t_built + t_start:.3f}"
            f"), peak {setup_peak / 2**30:.3f} GiB")

        def one(i, profiled):
            c0, p0 = time.perf_counter(), time.process_time()
            with torch.profiler.record_function("bench.check"):
                res = prog.check(i)
                card.sync()
                steps, passed = dict(res.seconds), res.passed
                del res
            return {"seconds": steps, "passed": passed,
                    "wall_s": time.perf_counter() - c0, "profiled": profiled,
                    "cpu_s": time.process_time() - p0,
                    "allocator": card.allocator()}

        checks = []
        card.reset()
        card.sync()
        host0 = host_state()
        t0 = time.perf_counter()
        while not checks or time.perf_counter() - t0 < seconds:
            checks.append(one(len(checks) + 1, False))
        window_s = time.perf_counter() - t0
        window_peak = card.peak()
        log(f"host at the window's start {json.dumps(host0)}, at its end "
            f"{json.dumps(host_state())}; process CPU s a check "
            + " ".join(f"{c['cpu_s']:.3f}" for c in checks))
        events, traced = None, []
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with prof, torch.profiler.record_function(devtrace.WINDOW):
                traced = [one(len(checks) + 1 + j, True)
                          for j in range(PROFILED)]
            events = prof.events()
        run_peak = max(setup_peak, card.peak())
    false_alarms = sum(not c["passed"] for c in checks + traced)
    prog.close()
    card.free()
    log(f"{workload}: {len(checks)} checks in {window_s:.3f} s, window peak "
        f"{window_peak / 2**30:.3f} GiB, {false_alarms} not passed; wall s "
        + " ".join(f"{c['wall_s']:.3f}" for c in checks))
    for c in checks:
        log("  check " + json.dumps({k: c[k] for k in ("seconds", "wall_s",
                                                      "cpu_s", "allocator")}))

    cfg, tr = cell.config, cell.traffic
    device_info = card.describe()
    device_info["memory_peak_bytes"] = run_peak
    rec = {"checks": checks + traced,
           "window_s": window_s, "config": cfg,
           "traffic": tr, "sizes": readings["sizes"], "device": device_info,
           "profile": devtrace.summarize(events) if events else None}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell, m["name"])(rec)
            if v is None:
                log(f"{m['name']}: its reader found nothing to read")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec["profile"]:
            device_info["busy_s"] = rec["profile"]["busy_s"]
            device_info["window_s"] = rec["profile"]["window_s"]
    else:
        e2e = {"check_s": window_s / len(checks),
               "check_peak_gib": window_peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    nums = judge.numbers(readings, reference(cell, seed, dev), false_alarms)
    card.free()
    ok, lines = judge.judge(nums, cell.limits)
    result = {"correct": ok, "attempted": len(checks),
              "failed": sum(not c["passed"] for c in checks),
              "metrics": metrics, "device": device_info}
    if trace and rec["profile"]:
        result["breakdown"] = {k: rec["profile"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["compared"] = {k: {"value": nums.get(k), "limit": v}
                          for k, v in cell.limits.items()}
    return result, lines
