"""``mfu.check.mla``: the model FLOPs of a check's three training steps of
a DeepSeek-V3 configuration (the reference's base and perturbed runs and
the candidate's, ``arith_mla``) over the checks' time, as a share (%) of
the card's dense peak in the configuration's compute dtype (bf16), as
``mfu.check`` reads its cells."""
from port_bench import arith, arith_mla
from port_bench.metrics._checks import measured

PEAK_OF = {"bfloat16": "bf16_flops_per_s", "float32": "f32_flops_per_s"}


def read(rec):
    checks = measured(rec)
    wall = sum(c["wall_s"] for c in checks)
    cfg, tr = rec["config"], rec["traffic"]
    if (rec["device"]["platform"] != "gpu" or wall <= 0
            or cfg.get("family") != "deepseek_v3"):
        return None
    flops = 3 * arith_mla.step_flops(cfg, tr["batch"], tr["seq"])
    peak = arith.peak(rec["device"]["kind"], PEAK_OF[cfg["torch_dtype"]])
    return 100.0 * flops * len(checks) / wall / peak
