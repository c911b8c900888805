"""``mfu.check``: the model FLOPs of a check's three training steps (the
reference's base and perturbed runs and the candidate's, ``arith``) over
the checks' time, as a share (%) of the card's dense peak in the
configuration's compute dtype (bf16)."""
from port_bench import arith
from port_bench.metrics._checks import measured

PEAK_OF = {"bfloat16": "bf16_flops_per_s", "float32": "f32_flops_per_s"}


def read(rec):
    checks = measured(rec)
    wall = sum(c["wall_s"] for c in checks)
    if rec["device"]["platform"] != "gpu" or wall <= 0:
        return None
    cfg, tr = rec["config"], rec["traffic"]
    flops = 3 * arith.step_flops(cfg, tr["batch"], tr["seq"])
    peak = arith.peak(rec["device"]["kind"], PEAK_OF[cfg["torch_dtype"]])
    return 100.0 * flops * len(checks) / wall / peak
