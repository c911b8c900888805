"""The yardstick's arithmetic, from shapes alone: the model FLOPs of a
training step, the bytes and operations of ``packed_sq_norms``, and the
table of the chip's peaks (``peaks.json``).

Model FLOPs count each matrix product of the forward once (``2 m n k``)
and the backward as twice the forward; the attention's two products are
counted over all ``S x S`` query-key pairs, the optimizer's update and
every elementwise op as nothing, and no recomputation.  An MoE layer's
experts count the rows they are given: ``T * k`` routed tokens for the
model FLOPs, or the rows of their capacity buffer, which is what the
program multiplies.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
BLOCK = 1024            # the packed layout's block (kernels/relerr.py)


def forward_flops(cfg: dict, B: int, S: int, expert_rows=None) -> int:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = d // H
    f = cfg["intermediate_size"]
    T = B * S
    per_layer = 2 * T * d * (H + 2 * Hkv) * D + 2 * T * H * D * d
    per_layer += 2 * (2 * B * H * S * S * D)
    E = cfg.get("num_local_experts")
    if E:
        rows = T * cfg["num_experts_per_tok"] if expert_rows is None \
            else expert_rows
        per_layer += 2 * T * d * E + 3 * 2 * rows * d * f
    else:
        per_layer += 3 * 2 * T * d * f
    return cfg["num_hidden_layers"] * per_layer + 2 * T * d * V


def step_flops(cfg: dict, B: int, S: int, expert_rows=None) -> int:
    """Forward and backward of one training step."""
    return 3 * forward_flops(cfg, B, S, expert_rows)


def packed_elems(sizes) -> int:
    return sum(max(1, -(-n // BLOCK)) * BLOCK for n in sizes)


def packed_sq_norms_cost(sizes) -> tuple[int, int]:
    """``(bytes, operations)`` of one ``packed_sq_norms`` launch over pairs
    of the given element counts: both packed f32 operands read once, the
    block's segment id and count (int32 each) read once, the (N, 2) f32
    output written once; a subtraction and two multiply-adds an
    element."""
    n = packed_elems(sizes)
    return 8 * n + 8 * (n // BLOCK) + 8 * len(sizes), 4 * n


def peak(kind: str, what: str) -> float:
    """The table's ``what`` of the card named ``kind`` (by the first
    entry whose key the name contains)."""
    for key, row in PEAKS.items():
        if key in kind:
            return float(row[what])
    raise KeyError(f"no peaks for {kind!r}")
