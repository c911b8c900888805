"""``relerr_roofline``: the share (%) of its roofline that
``packed_sq_norms`` reaches in the profiled checks: the least time its
launches could take (bytes at the card's memory bandwidth, or operations
at its f32 rate, ``arith.packed_sq_norms_cost``) over their time on the
card (the kernel's two device functions, ``block_partials`` and
``segment_sums``, in the profiler's events).  A check launches it once a
section in the threshold estimate and once over every pair in the
compare (``core/thresholds._diff_sections``, ``core/checker``); the bytes
are counted for those launches, so where the trace holds another number
of ``block_partials`` launches the reader returns nothing."""
from port_bench import arith

KERNELS = ("block_partials", "segment_sums")
MIN_PACKED = 1 << 12    # smaller sections take the engine's float64 loop


def read(rec):
    prof = rec["profile"]
    if not prof or rec["device"]["platform"] != "gpu":
        return None
    t = sum(s for n, s in prof["kernel_s"].items()
            if any(k in n for k in KERNELS))
    n = sum(c["profiled"] for c in rec["checks"])
    if t <= 0 or n == 0:
        return None
    sections = [s for s in rec["sizes"].values() if sum(s) >= MIN_PACKED]
    launches = sections + [[x for s in rec["sizes"].values() for x in s]]
    seen = sum(c for name, c in prof["launches"].items()
               if KERNELS[0] in name)
    if seen != len(launches) * n:
        return None
    nbytes = ops = 0
    for sizes in launches:
        b, o = arith.packed_sq_norms_cost(sizes)
        nbytes, ops = nbytes + b, ops + o
    kind = rec["device"]["kind"]
    bound = max(nbytes / arith.peak(kind, "hbm_bytes_per_s"),
                ops / arith.peak(kind, "f32_flops_per_s"))
    return 100.0 * bound * n / t
