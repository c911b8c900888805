"""ZeRO-1 distributed optimizer (sharded fp32 masters) + its silent bugs: the
port of ``repro/parallel/zero.py``.

Adam is elementwise, so partitioning the master/m/v state across DP ranks and
all-gathering updated params is mathematically identical to the full update —
which is exactly why its bugs are *silent*.  We model the partitioning
explicitly on the flattened parameter and inject:

* ``zero_skipped_update`` (paper bug 9): the all-gather after the step
  returns the PRE-update values for the last rank's partition — those
  elements simply never train.
* ``zero_untied_embedding`` (paper bug 5): with tied embeddings, the
  embedding and LM-head references are owned by different ZeRO partitions;
  the tied gradient contribution of the LM-head side is lost for the
  embedding's owner.  Emulated by halving the embedding's applied gradient —
  the same "tied weights silently drift from the reference" signature.
"""
from __future__ import annotations

import torch


def _stale_last_partition(newp, oldp, dp: int):
    """``newp`` with the last of ``dp`` flat partitions left at ``oldp``."""
    if newp.ndim == 0:
        # cut = 0 for a single element: the whole leaf is in the last
        # (stale) partition, matching the flat-concat semantics
        return oldp.to(newp.dtype)
    n = newp.numel()
    cut = (n // dp) * (dp - 1)
    # a mask over each element's flat index, as the reference builds it
    flat_idx = torch.arange(n, device=newp.device).view(newp.shape)
    return torch.where(flat_idx < cut, newp, oldp.to(newp.dtype))


def zero1_update(opt, params: dict, grads: dict, state: dict, dp: int,
                 bugs=frozenset()):
    """Semantics-equivalent ZeRO-1 step (bugs aside) over ``{name: tensor}``."""
    if "zero_untied_embedding" in bugs:
        grads = {k: g * 0.5 if "word_embeddings" in k else g
                 for k, g in grads.items()}

    new_params, new_state, info = opt.update(params, grads, state)

    if "zero_skipped_update" in bugs:
        new_params = {k: _stale_last_partition(v, params[k], dp)
                      for k, v in new_params.items()}
        # masters stay consistent with the (buggy) gathered params
        new_state = dict(new_state)
        new_state["master"] = {k: p.float() for k, p in new_params.items()}
    return new_params, new_state, info
