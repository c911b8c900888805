"""Plain float32 building blocks of the benchmark's references.

Plain PyTorch only: nothing here imports the program under test.  Every
matrix product goes through ``mm(a, b)`` (both 2-D, or of one batch
shape): ``FP32`` is the reference itself (TF32 off, see ``no_tf32``),
``FP8`` the control, the same arithmetic with both operands of every
product (and the incoming gradient of its backward) rounded to float8
e4m3 under one scale a tensor.

``readings`` runs one training step of a family's model from the
benchmark's weights and batch, the way the configuration states it
(float32 master weights, AdamW, parameters kept in their stated dtype),
and a second step with its embedding output perturbed by ``eps`` of its
norm, and returns what the comparison reads: the loss, per-leaf norms of
the gradients, the clipped main gradients and the parameter change, the
norms of the tapped activations and of their gradients, and the
rel-err thresholds its own perturbation gives.
"""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0
NEG_INF = -1e30


def no_tf32():
    """Float32 products in float32: TF32 would round operands to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale (its absolute max over
    448), back in float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` of e4m3-rounded operands; the backward rounds the incoming
    gradient too, so all three products of a step are in fp8."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


FP32 = torch.matmul
FP8 = _Fp8Product.apply


def linear(mm, x, w, b=None):
    """``x @ w`` (+ ``b``) for ``x`` (..., d_in) and ``w`` (d_in, d_out)."""
    y = mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])
    return y if b is None else y + b


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta):
    """Rotary embedding of ``x`` (B, S, H, D) at positions 0..S-1, rotating
    the pairs (2i, 2i+1) of each head by ``pos * theta^(-2i/D)``."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(mm, q, k, v, window=0):
    """Causal softmax attention, (B, S, H, D) queries over (B, S, Hkv, D)
    keys and values, query head h reading key head h // (H / Hkv); with
    ``window``, a query sees the ``window`` positions up to its own."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr = k.repeat_interleave(G, dim=2).transpose(1, 2)      # (B, H, S, D)
    vr = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = mm(q.transpose(1, 2), kr.transpose(-1, -2)) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    return mm(p, vr).transpose(1, 2).reshape(B, S, H * D)


def swiglu(mm, x, gate, up, down):
    return linear(mm, torch.nn.functional.silu(linear(mm, x, gate))
                  * linear(mm, x, up), down)


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# the optimizer step, and what a step gives the comparison
# ---------------------------------------------------------------------------

def norm64(x: torch.Tensor) -> float:
    """The float64 Frobenius norm of ``x``, in blocks of 2^24 elements."""
    flat = x.detach().reshape(-1)
    tot = torch.zeros((), dtype=torch.float64, device=flat.device)
    for i in range(0, flat.numel(), 1 << 24):
        c = flat[i:i + (1 << 24)].double()
        tot += torch.dot(c, c)
    return math.sqrt(float(tot))


def rel_err64(a: torch.Tensor, b: torch.Tensor, sa: float = 1.0,
              sb: float = 1.0) -> float:
    """||A - B|| / ||A|| for ``A = sa * a``, ``B = sb * b`` in float64
    (||A - B|| where ||A|| = 0), in blocks of 2^24 elements."""
    fa, fb = a.detach().reshape(-1), b.detach().reshape(-1)
    d2 = torch.zeros((), dtype=torch.float64, device=fa.device)
    a2 = torch.zeros((), dtype=torch.float64, device=fa.device)
    for i in range(0, fa.numel(), 1 << 24):
        ca = fa[i:i + (1 << 24)].double() * sa
        cd = ca - fb[i:i + (1 << 24)].to(device=fa.device).double() * sb
        d2 += torch.dot(cd, cd)
        a2 += torch.dot(ca, ca)
    d, na = math.sqrt(float(d2)), math.sqrt(float(a2))
    return d / na if na > 0 else d


def decays(name: str) -> bool:
    """AdamW's weight decay reaches matrices and embeddings, not norms or
    biases."""
    last = name.rsplit(".", 1)[-1]
    return not (last.endswith("norm") or last == "b")


def adamw_first_step(params: dict, grads: dict, dtypes: dict, opt: dict):
    """One AdamW step from zero moments over float32 master copies of the
    parameters, the global gradient norm clipped to ``opt["clip"]``.
    Returns ``(scale, post)``: the clip's factor (the main gradients are
    ``scale * grads``), and the new parameters rounded to the dtype each
    is kept in."""
    pre = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in
                        grads.values()))
    scale = min(1.0, opt["clip"] / max(pre, 1e-12))
    b1, b2 = opt["b1"], opt["b2"]
    post = {}
    for k, p in params.items():
        g = grads[k] * scale
        m = (1 - b1) * g / (1 - b1)
        v = (1 - b2) * g * g / (1 - b2)
        u = m / (torch.sqrt(v) + opt["eps"])
        if opt["weight_decay"] and decays(k):
            u = u + opt["weight_decay"] * p.detach()
        post[k] = (p.detach() - opt["lr"] * u).to(dtypes[k])
        del g, m, v, u
    return scale, post


# the program's names of a trace's sections
ACT, ACT_GRAD, PARAM_GRAD, MAIN_GRAD, PARAM_POST = (
    "activation", "act_grad", "param_grad", "main_grad", "param_post_step")
SECTIONS = (ACT, ACT_GRAD, PARAM_GRAD, MAIN_GRAD, PARAM_POST)
# a threshold is its kind's margin times the estimate, or times the floor
MARGIN = {PARAM_POST: 64.0}
FLOOR_MULT = 4.0


def threshold(kind, est, eps, margin=8.0):
    return MARGIN.get(kind, margin) * max(est, FLOOR_MULT * eps)


def _step(family, cfg, params, dtypes, batch, mm, opt, emb_delta=None):
    """Forward, backward and the optimizer step of one run over the
    float32 leaves ``params``: the loss, the tapped activations and their
    gradients, the gradients, the clip's factor and the post-step
    parameters."""
    for p in params.values():
        p.grad = None
    loss, taps = family.forward(params, batch, cfg, mm, emb_delta=emb_delta)
    for t in taps.values():
        t.retain_grad()
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    for p in params.values():
        p.grad = None
    out = {"loss": float(loss.detach()), ACT: {k: t.detach() for k, t in taps.items()},
           ACT_GRAD: {k: t.grad for k, t in taps.items()}, PARAM_GRAD: grads}
    del loss, taps
    out["scale"], out[PARAM_POST] = adamw_first_step(params, grads, dtypes,
                                                     opt)
    return out


def perturbation(x, eps, seed):
    """``x + eps * ||x|| * d / ||d||`` for ``d`` drawn from ``seed``."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    d = torch.randn(x.shape, generator=gen, device=x.device,
                    dtype=torch.float32)
    return x + (eps * x.detach().norm() / d.norm()) * d


def readings(family, cfg, values: dict, batch: dict, mm, opt: dict,
             eps: float, seed: int = 0) -> dict:
    """What the comparison reads of one reference step (see the module
    docstring): ``{"loss", "norms": {kind: {name: norm}}, "thresholds":
    {kind: {name: threshold}}}``; a parameter change's norm stands under
    ``PARAM_POST``.  ``values``: ``{name: tensor}`` in the dtype each leaf
    is kept in; the step runs on their float32 copies."""
    dtypes = {k: v.dtype for k, v in values.items()}
    params = {k: v.float().requires_grad_(True) for k, v in values.items()}
    base = _step(family, cfg, params, dtypes, batch, mm, opt)
    sb = base["scale"]
    norms = {ACT: {k: norm64(x) for k, x in base[ACT].items()},
             ACT_GRAD: {k: norm64(x) for k, x in base[ACT_GRAD].items()},
             PARAM_GRAD: {k: norm64(x) for k, x in base[PARAM_GRAD].items()},
             PARAM_POST: {k: norm64(x.float() - params[k].detach())
                          for k, x in base[PARAM_POST].items()}}
    norms[MAIN_GRAD] = {k: sb * n for k, n in norms[PARAM_GRAD].items()}
    pert = _step(family, cfg, params, dtypes, batch, mm, opt,
                 emb_delta=lambda x: perturbation(x, eps, seed))
    est = {kind: {k: rel_err64(base[kind][k], pert[kind][k])
                  for k in base[kind]}
           for kind in (ACT, ACT_GRAD, PARAM_GRAD, PARAM_POST)}
    est[MAIN_GRAD] = {k: rel_err64(base[PARAM_GRAD][k], pert[PARAM_GRAD][k],
                                   sb, pert["scale"])
                      for k in base[PARAM_GRAD]}
    return {"loss": base["loss"], "norms": norms,
            "thresholds": {kind: {k: threshold(kind, e, eps)
                                  for k, e in est[kind].items()}
                           for kind in SECTIONS}}


# ---------------------------------------------------------------------------
# the decoder both families share
# ---------------------------------------------------------------------------

def out_std(cfg) -> float:
    """The initial std of each residual branch's output projection."""
    return 0.02 / math.sqrt(2.0 * cfg["num_hidden_layers"])


def decoder_specs(cfg, bias: bool, mlp_specs) -> list:
    """``(name, shape, dtype, mean, std)`` of every leaf of a pre-norm
    decoder whose fused ``linear_qkv`` (columns q | k | v) is biased when
    ``bias``; ``mlp_specs(prefix)`` gives each layer's MLP leaves.  Linear
    weights are (d_in, d_out)."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = d // H
    bf = getattr(torch, cfg["torch_dtype"])
    specs = [("embedding.word_embeddings", (V, d), bf, 0.0, 0.02),
             ("final_norm", (d,), bf, 1.0, 0.02)]
    if not cfg["tie_word_embeddings"]:
        specs.append(("lm_head", (V, d), bf, 0.0, 0.02))
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        specs += [(p + "input_norm", (d,), bf, 1.0, 0.02),
                  (p + "post_attn_norm", (d,), bf, 1.0, 0.02),
                  (p + "self_attention.linear_qkv.w", (d, (H + 2 * Hkv) * D),
                   bf, 0.0, 0.02),
                  (p + "self_attention.linear_proj.w", (H * D, d), bf, 0.0,
                   out_std(cfg))]
        if bias:
            specs.append((p + "self_attention.linear_qkv.b",
                          ((H + 2 * Hkv) * D,), bf, 0.0, 0.02))
        specs += mlp_specs(p + "mlp.")
    return specs


def decoder_forward(params, batch, cfg, mm, mlp, emb_delta=None):
    """``(loss, taps)`` of a pre-norm decoder with rotary attention; ``mlp(
    h, prefix, taps) -> (out, aux loss or None)``.  ``taps`` holds the
    tensors the comparison reads, under the names the program gives them."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = d // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    window = cfg.get("sliding_window") or 0
    taps = {}
    x = params["embedding.word_embeddings"][tokens]
    if emb_delta is not None:
        x = emb_delta(x)
    taps["embedding/output"] = x
    aux_total = None
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rmsnorm(x, params[p + "input_norm"], eps)
        taps[p + "self_attention/input"] = h
        qkv = linear(mm, h, params[p + "self_attention.linear_qkv.w"],
                     params.get(p + "self_attention.linear_qkv.b"))
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q = rope(q.reshape(B, S, H, D), theta)
        k = rope(k.reshape(B, S, Hkv, D), theta)
        o = attention(mm, q, k, v.reshape(B, S, Hkv, D), window)
        taps[p + "self_attention/core_attn_out"] = o
        a = linear(mm, o, params[p + "self_attention.linear_proj.w"])
        taps[p + "self_attention/output"] = a
        x = x + a
        h = rmsnorm(x, params[p + "post_attn_norm"], eps)
        taps[p + "mlp/input"] = h
        m, aux = mlp(h, p, taps)
        taps[p + "mlp/output"] = m
        x = x + m
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    h = rmsnorm(x, params["final_norm"], eps)
    taps["final_norm_out"] = h
    head = params.get("lm_head", params["embedding.word_embeddings"])
    loss = cross_entropy(linear(mm, h, head.t()), labels)
    return (loss if aux_total is None else loss + aux_total), taps
