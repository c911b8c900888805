#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (every one must pass; the script exits non-zero otherwise and then
prints no result line):

1. device  — the card's name and power limit (nvidia-smi), capability 9.0;
2. build   — ``nvcc`` builds every kernel from ``src/repro_torch/kernels/csrc``;
3. kernel  — ``packed_sq_norms`` on the card against its plain PyTorch
             version and a float64 reference (ragged sizes, f32 and bf16
             leaves, NaN in the pad, NaN in real data, ||a|| = 0, two
             launches bit-identical); tolerance: relative 1e-5 on each sum;
4. main    — ``ttrace_check`` over one training step of full-width
             ``gpt-paper`` (12 layers, d 512, vocab 50304) at B 8 x S 1024
             with bf16 thresholds must PASS, launching the kernel on the
             estimate and on the compare; then the same step of a reduced
             fp32 ``gpt-paper`` on the card must PASS against the port on
             the CPU under f32 thresholds;
5. control — a candidate whose ``layers.5.mlp.down.w`` is doubled must FAIL
             and be localized to ``layers.5.mlp``;
6. timing  — the compare section's reduction: the kernel, its plain
             version and a library yardstick, beside the bound.

The line before the last is a ``{"kernels": [...]}`` JSON object; the last
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

# cuBLAS needs this before its first use for deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM float32 outside tensor cores
REL_TOL = 1e-5                     # on each sum, against float64
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/relerr.cu"
KERNEL_REPLACES = "src/repro/kernels/relerr.py:101"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version and float64
# ---------------------------------------------------------------------------

def _within(got, ref, what):
    """Relative REL_TOL on each finite sum; exact zero where ref is 0."""
    got = got.double()
    err = (got - ref).abs()
    bad = err > REL_TOL * ref.abs()
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise AssertionError(f"{what}: row {i} got {got[i].tolist()} "
                             f"vs float64 {ref[i].tolist()}")
    return float(err.max())


def check_kernel(device, sizes, seed=0):
    """Returns the largest |kernel - plain| seen."""
    import torch
    from repro_torch.core.relerr_engine import pack_device, section_sq_norms
    from repro_torch.kernels.relerr import packed_sq_norms, packed_sq_norms_ref

    gen = torch.Generator(device="cpu").manual_seed(seed)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        la, lb = [], []
        for n in sizes:
            a = torch.randn(n, generator=gen) * (0.01 + 10 * torch.rand(1, generator=gen))
            b = a + 1e-3 * torch.randn(n, generator=gen)
            la.append(a.to(device=device, dtype=dtype))
            lb.append(b.to(device=device, dtype=dtype))
        la[2] = torch.zeros_like(la[2])               # ||a|| = 0
        ref = torch.from_numpy(section_sq_norms(la, lb, mode="loop")).to(device)
        args = pack_device(la, lb)
        n_seg = len(sizes)
        k1 = packed_sq_norms(*args, n_segments=n_seg)
        k2 = packed_sq_norms(*args, n_segments=n_seg)
        p = packed_sq_norms_ref(*args, n_segments=n_seg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if not torch.equal(k1, k2):
            raise AssertionError(f"{dtype}: two launches differ")
        _within(k1, ref, f"kernel {dtype}")
        _within(p, ref, f"plain {dtype}")
        if float(k1[2, 1]) != 0.0:
            raise AssertionError("||a|| = 0 pair has a non-zero ||a||^2")
        max_err = max(max_err, float((k1 - p).abs().max()))

        # NaN garbage in the pad must not leak
        a_flat, b_flat, seg_ids, counts = args
        block = a_flat.shape[0] // seg_ids.shape[0]
        lane = torch.arange(block, device=device)[None, :]
        pad = (lane >= counts[:, None]).reshape(-1)
        if bool(pad.any()):
            ga = a_flat.masked_fill(pad, float("nan"))
            gb = b_flat.masked_fill(pad, float("inf"))
            g = packed_sq_norms(ga, gb, seg_ids, counts, n_segments=n_seg)
            if not torch.equal(g, k1):
                raise AssertionError(f"{dtype}: NaN in the pad leaked")
        # a NaN in a real element must propagate to its own pair only
        bad_a = [x.clone() for x in la]
        bad_a[1].view(-1)[0] = float("nan")
        nanned = packed_sq_norms(*pack_device(bad_a, lb), n_segments=n_seg)
        if not bool(torch.isnan(nanned[1]).all()):
            raise AssertionError(f"{dtype}: a NaN in real data did not propagate")
        others = torch.cat([nanned[:1], nanned[2:]])
        if not bool(torch.isfinite(others).all()):
            raise AssertionError(f"{dtype}: a NaN leaked into other pairs")
        log(f"kernel {str(dtype):14s} {n_seg} pairs, "
            f"{a_flat.numel()} packed elements: ok")
    return max_err


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def timed_runner(run, calls):
    import torch

    def wrapped(batch, rewrites=None):
        t0 = time.perf_counter()
        tr = run(batch, rewrites)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        return tr
    return wrapped


def packed_elems(leaves, block):
    return sum(max(1, -(-int(x.numel()) // block)) * block for x in leaves)


def main_path(device, cfg, batch_size, seq, eps):
    """``ttrace_check`` of a clean candidate; returns (result, stats)."""
    from repro_torch.core.checker import collect_section_pairs
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.relerr import DEFAULT_BLOCK, packed_sq_norms
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    model = Model(cfg, seed=0, device=device)
    batch = make_batch(cfg, batch_size, seq, seed=0, device=device)
    opt = AdamW(lr=1e-3)
    ref_calls, cand_calls, marks = [], [], {}
    ref = timed_runner(make_model_runner(model, opt, device=device), ref_calls)
    cand_run = timed_runner(make_model_runner(model, opt, device=device),
                            cand_calls)

    def cand(batch, rewrites=None):
        marks.setdefault("after_estimate", packed_sq_norms.launches)
        return cand_run(batch, rewrites)

    packed_sq_norms.launches = 0
    res = ttrace_check(ref, cand, batch, eps=eps)
    launches = packed_sq_norms.launches
    _, la, _, _ = collect_section_pairs(res.reference, res.candidate)
    stats = dict(
        launches=launches,
        estimate_launches=marks["after_estimate"],
        compare_launches=launches - marks["after_estimate"],
        tensors=len(res.report.records),
        packed_elems=packed_elems(la, DEFAULT_BLOCK),
        seconds={"1_reference": ref_calls[0],
                 "2_thresholds": res.seconds["estimate"] - ref_calls[0],
                 "3_candidate": res.seconds["candidate"],
                 "4_compare": res.seconds["compare"]},
        loss=res.reference.loss)
    return res, stats, model, batch


def check_trace_shapes(res, cfg, batch_size, seq):
    L, d = cfg.n_layers, cfg.d_model
    n_params = 2 + 7 * L + (0 if cfg.tie_embeddings else 1)
    want = {"activations": 5 * L + 2, "act_grads": 5 * L + 2,
            "param_grads": n_params, "main_grads": n_params,
            "params_post": n_params}
    for tr in (res.reference, res.candidate):
        for sec, n in want.items():
            got = len(getattr(tr, sec))
            if got != n:
                raise AssertionError(f"{sec}: {got} tensors, expected {n}")
        h = tr.activations.raw("final_norm_out")
        if tuple(h.shape) != (batch_size, seq, d):
            raise AssertionError(f"final_norm_out shape {tuple(h.shape)}")
        for sec in want:
            for name, x in getattr(tr, sec).raw_items():
                if not bool(x.isfinite().all()):
                    raise AssertionError(f"{sec}:{name} is not finite")
        if not math.isfinite(tr.loss) or not math.isfinite(tr.grad_norm):
            raise AssertionError("loss or grad norm is not finite")


def cross_device_check(cfg):
    """One step of a small fp32 model on the card, checked by TTrace against
    the same model on the CPU under f32 thresholds."""
    from repro_torch.core.collector import SECTION_FIELDS, Section
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    small = dataclasses.replace(cfg.reduced(), n_layers=2, vocab=256)
    opt = AdamW(lr=1e-3)
    cpu = make_model_runner(Model(small, seed=0, device="cpu"), opt, device="cpu")
    gpu = make_model_runner(Model(small, seed=0, device="cuda"), opt)

    def gpu_on_cpu(batch, rewrites=None):
        tr = gpu(batch, rewrites)
        for f in SECTION_FIELDS:
            setattr(tr, f, Section({k: v.cpu() for k, v in
                                    getattr(tr, f).raw_items()}))
        return tr

    batch = make_batch(small, 2, 16, seed=0, device="cpu")
    return ttrace_check(cpu, gpu_on_cpu, batch, eps=MACHINE_EPS["float32"],
                        localize=False)


def negative_control(cfg, model, batch, eps):
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    import torch

    bad = Model(cfg, seed=0, device=model.device)
    with torch.no_grad():
        bad.layers[5].mlp.down.w.mul_(2.0)
    opt = AdamW(lr=1e-3)
    res = ttrace_check(make_model_runner(model, opt, device=model.device),
                       make_model_runner(bad, opt, device=model.device),
                       batch, eps=eps)
    return res


# ---------------------------------------------------------------------------
# phase 6: timing the compare section's reduction
# ---------------------------------------------------------------------------

def time_reduction(res):
    import torch
    from repro_torch.core.checker import collect_section_pairs
    from repro_torch.core.relerr_engine import pack_device
    from repro_torch.kernels.relerr import packed_sq_norms, packed_sq_norms_ref

    _, la, lb, _ = collect_section_pairs(res.reference, res.candidate)
    args = pack_device(la, lb)
    n = len(la)
    launches = packed_sq_norms.launches
    k = packed_sq_norms(*args, n_segments=n)
    p = packed_sq_norms_ref(*args, n_segments=n)
    torch.cuda.synchronize()
    rel = ((k.double() - p.double()).abs()
           > REL_TOL * p.double().abs()).any()
    if bool(rel):
        raise AssertionError("kernel and plain version disagree on the "
                             "main path's section")
    max_abs = float((k - p).abs().max())
    max_rel = float(((k.double() - p.double()).abs()
                     / p.double().abs().clamp_min(1e-30)).max())

    def library():
        diffs = torch._foreach_sub(la, lb)
        torch._foreach_norm(diffs)
        torch._foreach_norm(la)

    ms = cuda_time_ms(lambda: packed_sq_norms(*args, n_segments=n))
    pack_ms = cuda_time_ms(lambda: pack_device(la, lb), reps=5, warmup=1)
    plain_ms = cuda_time_ms(lambda: packed_sq_norms_ref(*args, n_segments=n),
                            reps=5, warmup=1)
    library_ms = cuda_time_ms(library, reps=5, warmup=1)
    packed_sq_norms.launches = launches      # timing launches are not counted
    a_flat, _, seg_ids, _ = args
    nbytes = 8 * a_flat.numel() + 8 * seg_ids.numel() + 8 * n
    flops = 4 * a_flat.numel()
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                else "operations",
                max_abs_err=max_abs, max_rel_err=max_rel, pack_ms=pack_ms,
                packed_elems=a_flat.numel(), pairs=n)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.kernels import build
    from repro_torch.kernels.relerr import packed_sq_norms

    failures = []
    ok = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:                  # reported, and the run exits 1
            failures.append(name)
            log(f"PHASE {name} FAILED after {time.perf_counter() - t0:.2f} s")
            traceback.print_exc(file=sys.stdout)
            return None
        ok[name] = True
        log(f"PHASE {name} ok ({time.perf_counter() - t0:.2f} s)")
        return out

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    log(f"capability: {cap}")
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)

    def do_build():
        secs = build.build_all()
        for name, s in secs.items():
            log(f"built {name} in {s:.2f} s")
            log(build.lib_path(name).with_suffix(".log").read_text().strip())
        return secs
    phase("build", do_build)
    if failures:
        return 1

    block = 1024
    kernel_err = phase("kernel", lambda: check_kernel(
        dev, [1, block - 1, block, block + 1, 3_000_017, 4_194_311]))

    cfg = get_config("gpt-paper")
    eps = MACHINE_EPS["bfloat16"]
    B, S = 8, 1024
    main = phase("main", lambda: main_path(dev, cfg, B, S, eps))
    stats = None
    if main is not None:
        res, stats, model, batch = main
        log(res.summary())
        log(f"main path: {stats['tensors']} tensors compared, packed section "
            f"{stats['packed_elems']} elements, loss {stats['loss']:.6f}, "
            f"kernel launches: estimate {stats['estimate_launches']}, "
            f"compare {stats['compare_launches']}")
        log("step seconds: " + json.dumps(stats["seconds"]))

        def verdict():
            if not res.passed:
                raise AssertionError("clean gpt-paper check did not PASS")
            if stats["estimate_launches"] < 1 or stats["compare_launches"] < 1:
                raise AssertionError("packed_sq_norms did not run on both the "
                                     "estimate and the compare")
            check_trace_shapes(res, cfg, B, S)
        phase("main_verdict", verdict)

        def cross():
            r = cross_device_check(cfg)
            log(r.summary())
            if not r.passed:
                raise AssertionError("card vs CPU check did not PASS")
        phase("cross_device", cross)

        def control():
            r = negative_control(cfg, model, batch, eps)
            log(r.summary())
            log("control step seconds: " + json.dumps(r.seconds))
            if r.passed or r.localized_module != "layers.5.mlp":
                raise AssertionError(f"doubled layers.5.mlp.down.w: passed="
                                     f"{r.passed}, localized "
                                     f"{r.localized_module!r}")
        phase("control", control)

        timing = phase("timing", lambda: time_reduction(res))
        if timing is not None:
            log(f"compare-section reduction on {card}: {timing['pairs']} "
                f"pairs, {timing['packed_elems']} packed elements: kernel "
                f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
                f"library (_foreach_sub + 2 _foreach_norm) "
                f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} "
                f"ms ({timing['bound_by']}); pack_device {timing['pack_ms']:.4f} "
                f"ms; kernel vs plain: max abs {timing['max_abs_err']:.3g}, "
                f"max rel {timing['max_rel_err']:.3g}")
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    line = {"kernels": [{
        "name": "packed_sq_norms", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": stats["launches"],
        "max_abs_err": max(kernel_err, timing["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}
    log(json.dumps(line))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
