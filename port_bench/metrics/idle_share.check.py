"""``idle_share.check``: the share (%) of the profiled checks' window in
which nothing ran on the card (``torch.profiler``'s device events)."""


def read(rec):
    prof = rec["profile"]
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
